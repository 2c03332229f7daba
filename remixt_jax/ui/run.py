"""``remixt-jax run``: the full BAM → results pipeline.

Capability parity with the reference's ``remixt run`` subcommand
(/root/reference/remixt/ui/run.py:10-86); orchestration runs on the
make-style scheduler instead of pypeliner, and the model-fit stage uses
every local accelerator automatically (analysis/pipeline._production_mesh).
"""

import yaml

import remixt_jax.workflow


def _paired(args, ids_key, files_key):
    """{sample id: filename} from two parallel argument lists."""
    if len(args[files_key]) != len(args[ids_key]):
        raise Exception('--{} must correspond one to one with --{}'.format(
            files_key, ids_key))
    return dict(zip(args[ids_key], args[files_key]))


def run(**args):
    bam_filenames = _paired(args, 'tumour_sample_ids', 'tumour_bam_files')
    results_filenames = _paired(args, 'tumour_sample_ids', 'results_files')

    normal_id = args['normal_sample_id']
    if (normal_id is None) != (args['normal_bam_file'] is None):
        raise Exception('--normal_sample_id and --normal_bam_file must be '
                        'both set or unset')
    if normal_id is not None:
        bam_filenames[normal_id] = args['normal_bam_file']

    config = {}
    if args['config'] is not None:
        with open(args['config']) as config_file:
            config = yaml.safe_load(config_file)

    workflow = remixt_jax.workflow.create_remixt_bam_workflow(
        args['breakpoint_file'], bam_filenames, results_filenames,
        args['raw_data_dir'], config, args['ref_data_dir'],
        normal_id=normal_id)
    workflow.run(args['raw_data_dir'], max_jobs=args['maxjobs'])


def add_arguments(argparser):
    for name, help_text in (
            ('ref_data_dir', 'Reference dataset directory'),
            ('raw_data_dir', 'Output raw data directory'),
            ('breakpoint_file', 'Input breakpoints filename')):
        argparser.add_argument(name, help=help_text)

    for name, help_text in (
            ('tumour_sample_ids', 'Identifiers for tumour samples'),
            ('tumour_bam_files', 'Input tumour bam filenames'),
            ('results_files', 'Output results filenames')):
        argparser.add_argument('--' + name, nargs='+', required=True,
                               help=help_text)

    argparser.add_argument('--normal_sample_id', default=None,
                           help='Normal sample id')
    argparser.add_argument('--normal_bam_file', default=None,
                           help='Input normal bam filename')
    argparser.add_argument('--config', default=None,
                           help='Configuration filename')
    argparser.add_argument('--maxjobs', type=int, default=1,
                           help='Maximum concurrent host jobs')
    argparser.set_defaults(func=run)
