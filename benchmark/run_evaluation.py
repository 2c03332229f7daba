"""Count-level accuracy benchmark: simulate experiments → fit → evaluate.

Mirrors /root/reference/benchmark/run_evaluation.py — simulates experiment
pickles from a simulation definition grid, fits each with the full restart
pipeline, evaluates against truth and merges the accuracy tables.

Usage:
    python benchmark/run_evaluation.py <sim_defs.yaml> <raw_data_dir> <table>
        [--ref_data_dir DIR] [--config CONFIG] [--simulate_only]

When --ref_data_dir is omitted, chromosome lengths must be given per
simulation in the sim defs (`chromosome_lengths`).
"""

import argparse
import os
import sys

import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import remixt_jax.simulations.pipeline
import remixt_jax.workflow
from remixt_jax.scheduler import Workflow


def main():
    argparser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    argparser.add_argument('sim_defs', help='Simulation definition filename')
    argparser.add_argument('raw_data_dir', help='Raw data directory')
    argparser.add_argument('table', help='Output table filename')
    argparser.add_argument('--ref_data_dir', default=None,
                           help='Reference dataset directory')
    argparser.add_argument('--config', required=False,
                           help='Configuration filename')
    argparser.add_argument('--simulate_only', action='store_true',
                           help='Simulate experiments then stop')
    argparser.add_argument('--maxjobs', type=int, default=1)

    args = vars(argparser.parse_args())

    config = {}
    if args['config'] is not None:
        config = yaml.safe_load(open(args['config']))

    sim_defs = remixt_jax.simulations.pipeline.create_simulations(
        args['sim_defs'], config, args['ref_data_dir'])

    os.makedirs(args['raw_data_dir'], exist_ok=True)

    workflow = Workflow('evaluation_benchmark')

    evaluation_files = {}
    for sim_id, params in sim_defs.items():
        sim_dir = os.path.join(args['raw_data_dir'], sim_id)
        os.makedirs(sim_dir, exist_ok=True)

        experiment_file = os.path.join(sim_dir, 'experiment.pickle')
        experiment_plot_file = os.path.join(sim_dir, 'experiment_plot.pdf')
        results_file = os.path.join(sim_dir, 'results.h5')
        evaluation_file = os.path.join(sim_dir, 'evaluation.h5')
        evaluation_files[sim_id] = evaluation_file

        workflow.transform(
            f'simulate_experiment_{sim_id}',
            remixt_jax.simulations.pipeline.simulate_experiment,
            args=(experiment_file, experiment_plot_file, params),
            outputs=[experiment_file, experiment_plot_file],
        )

        if args['simulate_only']:
            continue

        workflow.subworkflow(
            f'fit_{sim_id}',
            remixt_jax.workflow.create_fit_model_workflow(
                experiment_file, results_file, config, args['ref_data_dir'],
                os.path.join(sim_dir, 'fit')))

        workflow.transform(
            f'evaluate_{sim_id}',
            remixt_jax.simulations.pipeline.evaluate_results_task,
            args=(evaluation_file, results_file),
            kwargs={'experiment_filename': experiment_file},
            inputs=[results_file, experiment_file],
            outputs=[evaluation_file],
        )

    if not args['simulate_only']:
        workflow.transform(
            'merge_evaluations',
            remixt_jax.simulations.pipeline.merge_evaluations,
            args=(args['table'], sim_defs, evaluation_files, ['sim_id']),
            inputs=list(evaluation_files.values()),
            outputs=[args['table']],
        )

    workflow.run(os.path.join(args['raw_data_dir'], 'work'),
                 max_jobs=args['maxjobs'])


if __name__ == '__main__':
    main()
