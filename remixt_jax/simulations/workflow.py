"""Simulation workflows: read simulation and real-read resampling pipelines.

Mirrors /root/reference/remixt/simulations/workflow.py:8-155 on the
make-style runner.
"""

import os

from remixt_jax.scheduler import Workflow
import remixt_jax.simulations.pipeline as sim_pipeline


def create_read_simulation_workflow(sim_defs, normal_filename, tumour_filename,
                                    mixture_filename, breakpoint_filename,
                                    config, ref_data_dir, tempdir):
    """Simulate genome mixture + germline alleles + normal/tumour read data
    (reference simulations/workflow.py:8-90)."""
    os.makedirs(tempdir, exist_ok=True)

    workflow = Workflow('read_simulation')

    germline_alleles_file = os.path.join(tempdir, 'germline_alleles.h5')
    workflow.transform(
        'simulate_germline_alleles',
        sim_pipeline.simulate_germline_alleles,
        args=(germline_alleles_file, sim_defs, config, ref_data_dir),
        outputs=[germline_alleles_file],
    )

    workflow.transform(
        'simulate_genome_mixture',
        sim_pipeline.simulate_genome_mixture,
        args=(mixture_filename, None, sim_defs),
        outputs=[mixture_filename],
    )

    workflow.transform(
        'simulate_normal_data',
        sim_pipeline.simulate_normal_data,
        args=(normal_filename, mixture_filename, germline_alleles_file, sim_defs),
        inputs=[mixture_filename, germline_alleles_file],
        outputs=[normal_filename],
    )

    workflow.transform(
        'simulate_tumour_data',
        sim_pipeline.simulate_tumour_data,
        args=(tumour_filename, mixture_filename, germline_alleles_file, sim_defs),
        inputs=[mixture_filename, germline_alleles_file],
        outputs=[tumour_filename],
    )

    workflow.transform(
        'write_breakpoints',
        sim_pipeline.write_breakpoints,
        args=(breakpoint_filename, mixture_filename),
        inputs=[mixture_filename],
        outputs=[breakpoint_filename],
    )

    return workflow


def create_resample_simulation_workflow(sim_defs, source_normal_filename,
                                        source_tumour_filename,
                                        normal_filename, tumour_filename,
                                        mixture_filename, breakpoint_filename,
                                        config, ref_data_dir, tempdir):
    """Resample real reads to a simulated mixture's depths (reference
    simulations/workflow.py:91-155)."""
    os.makedirs(tempdir, exist_ok=True)

    workflow = Workflow('resample_simulation')

    germline_alleles_file = os.path.join(tempdir, 'germline_alleles.h5')
    workflow.transform(
        'simulate_germline_alleles',
        sim_pipeline.simulate_germline_alleles,
        args=(germline_alleles_file, sim_defs, config, ref_data_dir),
        outputs=[germline_alleles_file],
    )

    workflow.transform(
        'simulate_genome_mixture',
        sim_pipeline.simulate_genome_mixture,
        args=(mixture_filename, None, sim_defs),
        outputs=[mixture_filename],
    )

    workflow.transform(
        'resample_normal_data',
        sim_pipeline.resample_normal_data,
        args=(normal_filename, source_normal_filename, mixture_filename,
              germline_alleles_file, sim_defs),
        inputs=[source_normal_filename, mixture_filename, germline_alleles_file],
        outputs=[normal_filename],
    )

    workflow.transform(
        'resample_tumour_data',
        sim_pipeline.resample_tumour_data,
        args=(tumour_filename, source_tumour_filename, mixture_filename,
              germline_alleles_file, sim_defs),
        inputs=[source_tumour_filename, mixture_filename, germline_alleles_file],
        outputs=[tumour_filename],
    )

    workflow.transform(
        'write_breakpoints',
        sim_pipeline.write_breakpoints,
        args=(breakpoint_filename, mixture_filename),
        inputs=[mixture_filename],
        outputs=[breakpoint_filename],
    )

    return workflow
