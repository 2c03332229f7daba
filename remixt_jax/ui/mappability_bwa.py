"""``remixt-jax mappability_bwa``: build the bwa mappability store
(reference ui/mappability_bwa.py:10-27)."""

import os

import yaml

import remixt_jax.mappability.bwa.workflow


def run(**args):
    ref_data_dir = args['ref_data_dir']

    config = {}
    if args['config'] is not None:
        config = yaml.safe_load(open(args['config']))

    tmpdir = args.get('tmpdir') or os.path.join(ref_data_dir, 'mappability_bwa_tmp')

    workflow = remixt_jax.mappability.bwa.workflow.create_bwa_mappability_workflow(
        config, ref_data_dir, tmpdir)

    workflow.run(tmpdir, max_jobs=args['maxjobs'])


def add_arguments(argparser):
    argparser.add_argument('ref_data_dir',
        help='Reference dataset directory')

    argparser.add_argument('--config', required=False,
        help='Configuration Filename')

    argparser.add_argument('--tmpdir', required=False,
        help='Temporary directory')

    argparser.add_argument('--maxjobs', type=int, default=1,
        help='Maximum concurrent host jobs')

    argparser.set_defaults(func=run)
