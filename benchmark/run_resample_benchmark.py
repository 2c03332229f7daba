"""Read-resampling accuracy benchmark.

Mirrors /root/reference/benchmark/run_resample_benchmark.py:31-160 —
simulate genome mixtures, resample real reads to the simulated copy-number
profile, run each catalogued tool on the resampled data, evaluate against
truth and merge.

Usage:
    python benchmark/run_resample_benchmark.py <ref_data_dir> <sim_defs.yaml>
        <normal_seqdata.h5> <tumour_seqdata.h5> <raw_data_dir> <table>
        [--tools remixt] [--config CONFIG]
"""

import argparse
import os
import sys

import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remixt_jax.simulations.pipeline
import remixt_jax.simulations.workflow
import remixt_jax.wrappers
from remixt_jax.scheduler import Workflow


def main():
    argparser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    argparser.add_argument('ref_data_dir', help='Reference dataset directory')
    argparser.add_argument('sim_defs', help='Simulation definition filename')
    argparser.add_argument('normal_seqdata', help='Source normal seqdata')
    argparser.add_argument('tumour_seqdata', help='Source tumour seqdata')
    argparser.add_argument('raw_data_dir', help='Raw data directory')
    argparser.add_argument('table', help='Output table filename')
    argparser.add_argument('--tools', nargs='+', default=['remixt'],
                           choices=list(remixt_jax.wrappers.catalog.keys()))
    argparser.add_argument('--config', required=False)
    argparser.add_argument('--maxjobs', type=int, default=1)

    args = vars(argparser.parse_args())

    config = {}
    if args['config'] is not None:
        config = yaml.safe_load(open(args['config']))

    sim_defs = remixt_jax.simulations.pipeline.create_simulations(
        args['sim_defs'], config, args['ref_data_dir'])

    os.makedirs(args['raw_data_dir'], exist_ok=True)

    workflow = Workflow('resample_benchmark')

    evaluation_files = {}
    for sim_id, params in sim_defs.items():
        sim_dir = os.path.join(args['raw_data_dir'], sim_id)
        os.makedirs(sim_dir, exist_ok=True)

        mixture_file = os.path.join(sim_dir, 'mixture.pickle')
        breakpoints_file = os.path.join(sim_dir, 'breakpoints.tsv')
        normal_file = os.path.join(sim_dir, 'normal_seqdata.h5')
        tumour_file = os.path.join(sim_dir, 'tumour_seqdata.h5')

        workflow.subworkflow(
            f'resample_{sim_id}',
            remixt_jax.simulations.workflow.create_resample_simulation_workflow(
                params, args['normal_seqdata'], args['tumour_seqdata'],
                normal_file, tumour_file, mixture_file, breakpoints_file,
                config, args['ref_data_dir'],
                os.path.join(sim_dir, 'sim_tmp')))

        for tool_name in args['tools']:
            tool = remixt_jax.wrappers.catalog[tool_name](
                config, args['ref_data_dir'])
            tool_dir = os.path.join(sim_dir, tool_name)
            results_file = os.path.join(tool_dir, 'results.h5')
            evaluation_file = os.path.join(tool_dir, 'evaluation.h5')
            evaluation_files[(sim_id, tool_name)] = evaluation_file

            workflow.subworkflow(
                f'run_{tool_name}_{sim_id}',
                tool.create_workflow(
                    {'normal': normal_file, 'tumour': tumour_file},
                    breakpoints_file, results_file, tool_dir,
                    normal_id='normal'))

            workflow.transform(
                f'evaluate_{tool_name}_{sim_id}',
                remixt_jax.simulations.pipeline.evaluate_results_task,
                args=(evaluation_file, results_file),
                kwargs={'mixture_filename': mixture_file},
                inputs=[results_file, mixture_file],
                outputs=[evaluation_file],
            )

    workflow.transform(
        'merge_evaluations',
        remixt_jax.simulations.pipeline.merge_evaluations,
        args=(args['table'], sim_defs, evaluation_files, ['sim_id', 'tool']),
        inputs=list(evaluation_files.values()),
        outputs=[args['table']],
    )

    workflow.run(os.path.join(args['raw_data_dir'], 'work'),
                 max_jobs=args['maxjobs'])


if __name__ == '__main__':
    main()
