"""``remixt-jax fit``: count table + breakpoints → results.

The minimum end-to-end slice (SURVEY.md §7 stage 4): no BAM preprocessing,
starts from a prepared count table (columns chromosome, start, end, length,
major_readcount, minor_readcount, readcount) and a breakpoint prediction
table, runs the full restart grid on device and writes the reference-schema
results store.
"""

import os

import yaml

import remixt_jax.analysis.experiment
import remixt_jax.workflow


def fit(**args):
    config = {}
    if args['config'] is not None:
        config = yaml.safe_load(open(args['config']))

    os.makedirs(args['work_dir'], exist_ok=True)
    experiment_filename = os.path.join(args['work_dir'], 'experiment.pickle')

    remixt_jax.analysis.experiment.create_experiment(
        args['count_file'], args['breakpoint_file'], experiment_filename,
        min_length=args['min_length'])

    workflow = remixt_jax.workflow.create_fit_model_workflow(
        experiment_filename,
        args['results_file'],
        config,
        None,
        os.path.join(args['work_dir'], 'fit'),
    )

    workflow.run(args['work_dir'])


def add_arguments(argparser):
    argparser.add_argument('count_file',
        help='Input segment count table filename (TSV)')

    argparser.add_argument('breakpoint_file',
        help='Input breakpoint prediction table filename (TSV)')

    argparser.add_argument('results_file',
        help='Output results filename (HDF5)')

    argparser.add_argument('work_dir',
        help='Working directory for intermediate files')

    argparser.add_argument('--config', required=False,
        help='Configuration filename')

    argparser.add_argument('--min_length', type=float, default=None,
        help='Minimum segment length filter')

    argparser.set_defaults(func=fit)
