"""``remixt-jax create_ref_data``: download and build the reference dataset.

Capability parity with the reference subcommand
(/root/reference/remixt/ui/create_ref_data.py:8-18); delegates to
:mod:`remixt_jax.ref_data`, which resumes idempotently from per-step
sentinel files under the dataset directory.
"""

import os

import yaml

import remixt_jax.ref_data


def run(**args):
    config = {}
    if args['config'] is not None:
        with open(args['config']) as config_file:
            config = yaml.safe_load(config_file)

    dataset_dir = args['ref_data_dir']
    remixt_jax.ref_data.create_ref_data(
        config, dataset_dir,
        os.path.join(dataset_dir, 'sentinal'),
        bwa_index_genome=args['bwa_index_genome'])


def add_arguments(argparser):
    argparser.set_defaults(func=run)

    argparser.add_argument(
        'ref_data_dir', help='Reference dataset directory')
    argparser.add_argument(
        '-c', '--config', help='Configuration filename')
    argparser.add_argument(
        '-b', '--bwa_index_genome', action='store_true',
        help='Index the genome for bwa, used for tests/benchmarking')
