"""External competitor tools (TITAN, THetA2, cloneHD) as benchmark wrappers.

Each tool class wires its real input-preparation and result-conversion
steps (wraptitan.py / wraptheta.py / wrapclonehd.py — self-contained,
tested without the tools) around a subprocess execution stage through the
scheduler, and lands results in the common store schema
(``/cn`` table + ``/mix`` series) consumed by the evaluation suite
(simulations/pipeline.evaluate_results_task).

The execution stage needs the external installations; tool locations come
from the config dict under the tool's name, e.g.::

    titan:
      run_script: /path/to/titan_run.R
    theta:
      bin: /path/to/RunTHetA
      octave_bin_directory: /path/to/theta/matlab
    clonehd:
      filterhd_bin: /path/to/filterHD
      clonehd_bin: /path/to/cloneHD

``check_available`` raises an informative error when binaries are missing
(the reference's wrappers are Python-2 stale and unrunnable — SURVEY §2.2;
these reimplement the same tool protocols).
"""

import os
import shutil

import pandas as pd

import remixt_jax.config
from remixt_jax.scheduler import Workflow
from remixt_jax.io.hdf5 import HDFStore


def _write_results_store(results_filename, cn_filename, mix_filename):
    """Pack a tool's cn/mix TSV outputs into the common results store."""
    cn_table = pd.read_csv(cn_filename, sep='\t',
                           converters={'chromosome': str})
    with open(mix_filename) as f:
        mix = [float(v) for v in f.read().split()]
    with HDFStore(results_filename, 'w') as store:
        store['/cn'] = cn_table
        store['/mix'] = pd.Series(mix, index=range(len(mix)))
        store['/brk_cn'] = pd.DataFrame(
            columns=['prediction_id', 'cn_1', 'cn_2'])


# ---------------------------------------------------------------------------
# Stage functions live at module level: the scheduler's spawn-based process
# pool pickles task functions, and local closures cannot be pickled, so a
# multi-job run (max_jobs > 1) would crash at submit time with closures.

def _titan_prepare(workdir, normal, tumour, chromosome_lengths):
    from remixt_jax.wrappers import wraptitan
    wraptitan.prepare_inputs(workdir, normal, tumour, chromosome_lengths)


def _titan_run_all(workdir, run_script, restarts, done_filename):
    from remixt_jax.wrappers import wraptitan
    for idx, (clusters, ploidy, frac_normal) in enumerate(restarts):
        wraptitan.run(workdir, run_script, clusters, ploidy, frac_normal,
                      'restart_{}'.format(idx))
    open(done_filename, 'w').close()


def _titan_report(workdir, restarts, results_filename):
    from remixt_jax.wrappers import wraptitan
    restart_dirs = {idx: os.path.join(workdir, 'restart_{}'.format(idx))
                    for idx in range(len(restarts))}
    clusters = {idx: r[0] for idx, r in enumerate(restarts)}
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wraptitan.report(restart_dirs, cn_tsv, mix_tsv, clusters)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


def _theta_prepare(workdir, normal, tumour, segments_filename,
                   chrom_names_filename):
    from remixt_jax.wrappers import wraptheta
    segments = pd.read_csv(segments_filename, sep='\t',
                           converters={'chromosome': str})
    paths = wraptheta.prepare_inputs(workdir, normal, tumour, segments)
    pd.Series(paths['chrom_idx']).rename('idx').rename_axis(
        'chromosome').reset_index().to_csv(
            chrom_names_filename, sep='\t', index=False)


def _theta_run(workdir, theta_bin, octave_bin_directory, done_filename):
    from remixt_jax.wrappers import wraptheta
    wraptheta.run(workdir, theta_bin, octave_bin_directory)
    open(done_filename, 'w').close()


def _theta_report(workdir, chrom_names_filename, results_filename):
    from remixt_jax.wrappers import wraptheta
    mapping = pd.read_csv(chrom_names_filename, sep='\t',
                          converters={'chromosome': str})
    chrom_names = dict(zip(mapping['idx'], mapping['chromosome']))
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wraptheta.report(workdir, cn_tsv, mix_tsv, chrom_names)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


def _clonehd_prepare(workdir, normal, tumour, chromosome_lengths):
    from remixt_jax.wrappers import wrapclonehd
    wrapclonehd.prepare_inputs(workdir, normal, tumour, chromosome_lengths)


def _clonehd_run(workdir, filterhd_bin, clonehd_bin, done_filename):
    from remixt_jax.wrappers import wrapclonehd
    wrapclonehd.run(workdir, filterhd_bin, clonehd_bin)
    open(done_filename, 'w').close()


def _clonehd_report(workdir, results_filename):
    from remixt_jax.wrappers import wrapclonehd
    cn_tsv = os.path.join(workdir, 'cn.tsv')
    mix_tsv = os.path.join(workdir, 'mix.tsv')
    wrapclonehd.report(workdir, cn_tsv, mix_tsv)
    _write_results_store(results_filename, cn_tsv, mix_tsv)


class ExternalTool(object):
    name = None
    required_binaries = ()

    def __init__(self, config, ref_data_dir):
        self.config = config
        self.ref_data_dir = ref_data_dir
        self.tool_config = config.get(self.name, {})

    def check_available(self):
        missing = [b for b in self.required_binaries
                   if shutil.which(b) is None]
        if missing:
            raise RuntimeError(
                '{} requires binaries not on PATH: {}. Install the tool '
                '(see benchmark/tool_defs.yaml) to include it in '
                'comparisons.'.format(self.name, ', '.join(missing)))

    def chromosome_lengths(self):
        return remixt_jax.config.get_chromosome_lengths(
            self.config, self.ref_data_dir)

    def create_workflow(self, seqdata_filenames, breakpoints_filename,
                        results_filename, workdir, normal_id=None):
        self.check_available()
        os.makedirs(workdir, exist_ok=True)
        normal = seqdata_filenames[normal_id]
        tumours = {k: v for k, v in seqdata_filenames.items()
                   if k != normal_id}
        if len(tumours) != 1:
            raise ValueError(
                '{} supports exactly one tumour sample'.format(self.name))
        (tumour,) = tumours.values()

        workflow = Workflow('{}_analysis'.format(self.name))
        self._add_stages(workflow, normal, tumour, results_filename, workdir)
        return workflow

    # subclasses add prepare/run/report transforms
    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        raise NotImplementedError


class TitanTool(ExternalTool):
    name = 'titan'
    required_binaries = ('Rscript',)

    #: (num_clusters, ploidy_init, normal_init) restart grid
    restarts = [(1, 2.0, 0.5), (2, 2.0, 0.5), (1, 4.0, 0.5), (2, 4.0, 0.5)]

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        alleles = os.path.join(workdir, 'alleles.tsv')
        normal_wig = os.path.join(workdir, 'normal.wig')
        tumour_wig = os.path.join(workdir, 'tumour.wig')
        done = os.path.join(workdir, 'run.done')
        workflow.transform(
            'prepare', _titan_prepare,
            args=(workdir, normal, tumour, self.chromosome_lengths()),
            outputs=[alleles, normal_wig, tumour_wig])
        workflow.transform(
            'run', _titan_run_all,
            args=(workdir, self.tool_config['run_script'],
                  self.restarts, done),
            inputs=[alleles, normal_wig, tumour_wig], outputs=[done])
        workflow.transform(
            'report', _titan_report,
            args=(workdir, self.restarts, results_filename),
            inputs=[done], outputs=[results_filename])


class ThetaTool(ExternalTool):
    name = 'theta'
    required_binaries = ('octave',)

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        segments_filename = self.tool_config.get('segments_filename')
        counts = os.path.join(workdir, 'counts.tsv')
        normal_alleles = os.path.join(workdir, 'normal_alleles.tsv')
        tumour_alleles = os.path.join(workdir, 'tumour_alleles.tsv')
        done = os.path.join(workdir, 'run.done')
        chrom_names_file = os.path.join(workdir, 'chrom_names.tsv')

        workflow.transform(
            'prepare', _theta_prepare,
            args=(workdir, normal, tumour, segments_filename,
                  chrom_names_file),
            outputs=[counts, normal_alleles, tumour_alleles,
                     chrom_names_file])
        workflow.transform(
            'run', _theta_run,
            args=(workdir, self.tool_config['bin'],
                  self.tool_config['octave_bin_directory'], done),
            inputs=[counts, normal_alleles, tumour_alleles], outputs=[done])
        workflow.transform(
            'report', _theta_report,
            args=(workdir, chrom_names_file, results_filename),
            inputs=[done, chrom_names_file], outputs=[results_filename])


class CloneHDTool(ExternalTool):
    name = 'clonehd'
    required_binaries = ('filterHD', 'cloneHD')

    def _add_stages(self, workflow, normal, tumour, results_filename,
                    workdir):
        normal_cna = os.path.join(workdir, 'normal.cna.txt')
        tumour_cna = os.path.join(workdir, 'tumour.cna.txt')
        baf = os.path.join(workdir, 'tumour.baf.txt')
        done = os.path.join(workdir, 'run.done')

        workflow.transform(
            'prepare', _clonehd_prepare,
            args=(workdir, normal, tumour, self.chromosome_lengths()),
            outputs=[normal_cna, tumour_cna, baf])
        workflow.transform(
            'run', _clonehd_run,
            args=(workdir,
                  self.tool_config.get('filterhd_bin', 'filterHD'),
                  self.tool_config.get('clonehd_bin', 'cloneHD'), done),
            inputs=[normal_cna, tumour_cna, baf], outputs=[done])
        workflow.transform(
            'report', _clonehd_report,
            args=(workdir, results_filename),
            inputs=[done], outputs=[results_filename])
