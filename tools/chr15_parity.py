"""Chromosome-15 real-data parity harness (BASELINE north star #1).

One command, wherever network and the external phasing tools exist:

    python tools/chr15_parity.py WORK_DIR [--reference-results REF_H5]

Stages (each sentinel-gated and resumable):
  1. download  — HCC1395/HCC1395BL chr15 BAMs + breakpoints + precomputed
                 mappability from the reference's S3 bucket
                 (/root/reference/README.md:190-207), and build the chr15
                 reference dataset (ensembl FASTA, 1000G panel, maps).
  2. run       — the full remixt-jax pipeline: extract counts, phase
                 haplotypes (shapeit4), GC bias, fit, collate.
  3. compare   — when --reference-results points at a results HDF5
                 produced by the ORIGINAL ReMixT on the same inputs,
                 report posterior parity: per-segment copy-number
                 agreement of the optimal solutions, mixture recovery,
                 and max-abs-diff of raw major/minor posterior columns.
                 Without it, print this run's solution summary.

This environment has no network egress, so the harness refuses early with
a clear message; it is the checked-in recipe for running the north-star
comparison on a connected machine.
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

S3_BASE = 'http://remixttestdata.s3.amazonaws.com'
DATA_FILES = [
    'test_grch38_chrprefix/HCC1395_chr15_grch38.bam',
    'test_grch38_chrprefix/HCC1395_chr15_grch38.bam.bai',
    'test_grch38_chrprefix/HCC1395BL_chr15_grch38.bam',
    'test_grch38_chrprefix/HCC1395BL_chr15_grch38.bam.bai',
    'test_grch38_chrprefix/HCC1395_breakpoints.tsv',
]
EXAMPLE_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'examples', 'chromosome_15_config.yaml')


def check_network():
    probe = subprocess.run(
        ['wget', '-q', '--spider', '--timeout=10', S3_BASE],
        capture_output=True)
    if probe.returncode != 0:
        sys.exit('no network egress to {} — run this harness on a '
                 'connected machine'.format(S3_BASE))


def download(work_dir):
    import remixt_jax.utils

    for rel in DATA_FILES:
        target = os.path.join(work_dir, os.path.basename(rel))
        if not os.path.exists(target):
            remixt_jax.utils.wget('{}/{}'.format(S3_BASE, rel), target)

    ref_dir = os.path.join(work_dir, 'ref_data')
    os.makedirs(ref_dir, exist_ok=True)
    mappability = os.path.join(ref_dir, 'hg19.100.bwa.mappability.h5')
    if not os.path.exists(mappability):
        remixt_jax.utils.wget(
            '{}/hg19.100.bwa.mappability.h5'.format(S3_BASE), mappability)

    import yaml
    import remixt_jax.ref_data
    with open(EXAMPLE_CONFIG) as f:
        config = yaml.safe_load(f)
    remixt_jax.ref_data.create_ref_data(config, ref_dir)
    return ref_dir, config


def run_pipeline(work_dir, ref_dir, config):
    import remixt_jax.workflow

    results = os.path.join(work_dir, 'results.h5')
    if os.path.exists(results):
        return results
    workflow = remixt_jax.workflow.create_remixt_bam_workflow(
        os.path.join(work_dir, 'HCC1395_breakpoints.tsv'),
        {'HCC1395': os.path.join(work_dir, 'HCC1395_chr15_grch38.bam'),
         'HCC1395BL': os.path.join(work_dir, 'HCC1395BL_chr15_grch38.bam')},
        {'HCC1395': results},
        os.path.join(work_dir, 'raw_data'),
        config, ref_dir, normal_id='HCC1395BL')
    workflow.run(os.path.join(work_dir, 'raw_data'))
    return results


def _optimal_cn(results_filename):
    from remixt_jax.io.hdf5 import HDFStore
    with HDFStore(results_filename, 'r') as store:
        return store['/cn'], store['/mix']


def compare(results_filename, reference_results_filename):
    import numpy as np

    cn, mix = _optimal_cn(results_filename)
    print('segments: {}   mix: {}'.format(
        len(cn.index), np.round(mix.values, 4).tolist()))

    if reference_results_filename is None:
        print('(no --reference-results given; run the original ReMixT on '
              'the same inputs and pass its results HDF5 for the parity '
              'comparison)')
        return

    import pandas as pd
    with pd.HDFStore(reference_results_filename, 'r') as ref_store:
        ref_cn = ref_store['/cn']
        ref_mix = ref_store['/mix']

    keys = ['chromosome', 'start', 'end']
    merged = cn.merge(ref_cn, on=keys, suffixes=('', '_ref'))
    print('aligned segments: {} / {}'.format(len(merged.index), len(cn.index)))

    length = (merged['end'] - merged['start']).values.astype(float)
    for clone in (1, 2):
        agree = np.ones(len(merged.index), dtype=bool)
        for allele in ('major', 'minor'):
            col = '{}_{}'.format(allele, clone)
            agree &= merged[col].values == merged[col + '_ref'].values
        print('clone {} cn agreement (length-weighted): {:.4f}'.format(
            clone, (agree * length).sum() / length.sum()))

    for col in ('major_raw', 'minor_raw'):
        diff = np.abs(merged[col].values - merged[col + '_ref'].values)
        print('{} max-abs-diff {:.3e}  mean {:.3e}'.format(
            col, diff.max(), diff.mean()))
    print('mix: ours {} reference {}'.format(
        np.round(mix.values, 4).tolist(),
        np.round(ref_mix.values, 4).tolist()))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('work_dir')
    parser.add_argument('--reference-results', default=None,
                        help='results HDF5 from an original-ReMixT run on '
                             'the same inputs')
    parser.add_argument('--skip-download', action='store_true',
                        help='data already staged in work_dir')
    args = parser.parse_args()

    os.makedirs(args.work_dir, exist_ok=True)
    if not args.skip_download:
        check_network()
        ref_dir, config = download(args.work_dir)
    else:
        import yaml
        ref_dir = os.path.join(args.work_dir, 'ref_data')
        with open(EXAMPLE_CONFIG) as f:
            config = yaml.safe_load(f)

    results = run_pipeline(args.work_dir, ref_dir, config)
    compare(results, args.reference_results)


if __name__ == '__main__':
    main()
