"""Benchmark wrapper for this framework itself (reference
wrappers/wrapremixt.py equivalent): seqdata → counts → fit → results.
"""

import os

import remixt_jax.workflow


class ReMixTTool(object):
    def __init__(self, config, ref_data_dir):
        self.config = config
        self.ref_data_dir = ref_data_dir

    def create_workflow(self, seqdata_filenames, breakpoints_filename,
                        results_filename, workdir, normal_id=None):
        os.makedirs(workdir, exist_ok=True)
        tumour_ids = [k for k in seqdata_filenames if k != normal_id]
        # the wrapper protocol hands us ONE results file; mapping several
        # tumours onto it would make the fits overwrite each other
        if len(tumour_ids) != 1:
            raise ValueError(
                'remixt wrapper supports exactly one tumour sample per '
                'results file; got {}'.format(sorted(tumour_ids)))
        results_filenames = {tumour_ids[0]: results_filename}
        return remixt_jax.workflow.create_remixt_seqdata_workflow(
            breakpoints_filename,
            seqdata_filenames,
            results_filenames,
            workdir,
            self.config,
            self.ref_data_dir,
            normal_id=normal_id,
        )
