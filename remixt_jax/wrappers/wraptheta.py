"""THetA2 wrapper: input preparation, execution, result conversion.

Capability parity with /root/reference/remixt/wrappers/wraptheta.py:20-303.
Input writers and the result parser are self-contained; :func:`run` shells
out to the THetA binary and the octave BAF model.

THetA input formats:
  * an interval-count table, headerless TSV:
    segment_id, chrom_idx, start, end, tumour_count, normal_count,
    upper_bound, lower_bound;
  * allele-count tables (chrom_idx, position, A, C, T, G, total,
    ref_count, alt_count — nucleotide columns zero-filled).
THetA output: a ``*.BAF.NLL.results`` TSV whose best row (minimum
NLL + BAF_NLL) carries the mixture ``mu`` (comma-separated) and per-clone
interval copy numbers ``C`` (colon-separated intervals of
comma-separated clones).
"""

import os
import subprocess

import numpy as np
import pandas as pd

from remixt_jax.wrappers import formats

INTERVAL_COLUMNS = ['segment_id', 'chrom_idx', 'start', 'end',
                    'count_tumour', 'count_normal',
                    'upper_bound', 'lower_bound']


def chromosome_index(chromosomes):
    """Stable chromosome -> integer index mapping used across all inputs."""
    return {c: i for i, c in enumerate(chromosomes)}


def write_interval_counts(filename, segments, normal_seqdata, tumour_seqdata,
                          max_copy_number=5):
    """The THetA interval-count file over an explicit segmentation.

    Returns the chromosome-index mapping for downstream files.
    """
    normal = formats.segment_read_counts(normal_seqdata, segments)
    tumour = formats.segment_read_counts(tumour_seqdata, segments)

    chrom_idx = chromosome_index(segments['chromosome'].unique())
    table = pd.DataFrame({
        'segment_id': np.arange(len(segments.index)),
        'chrom_idx': segments['chromosome'].map(chrom_idx),
        'start': segments['start'],
        'end': segments['end'],
        'count_tumour': tumour['count'].astype(int),
        'count_normal': normal['count'].astype(int),
        'upper_bound': max_copy_number,
        'lower_bound': 0,
    })
    table[INTERVAL_COLUMNS].to_csv(
        filename, sep='\t', index=False, header=False)
    return chrom_idx


def write_alleles(filename, het_counts, chrom_idx):
    """THetA2's runBAFGaussianModel indexes columns positionally and expects
    chrom_idx, position, per-nucleotide A/C/T/G counts (unused, written as
    zeros), total, ref_count, alt_count (reference wraptheta.py:69-86)."""
    ref = het_counts['ref_count'].astype(int)
    alt = het_counts['alt_count'].astype(int)
    table = pd.DataFrame({
        'chrom_idx': het_counts['chromosome'].map(chrom_idx),
        'position': het_counts['position'],
        'A': 0, 'C': 0, 'T': 0, 'G': 0,
        'total': ref + alt,
        'ref_count': ref,
        'alt_count': alt,
    })
    table.to_csv(filename, sep='\t', index=False, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata, segments,
                   max_copy_number=5):
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'counts': os.path.join(analysis_dir, 'counts.tsv'),
        'normal_alleles': os.path.join(analysis_dir, 'normal_alleles.tsv'),
        'tumour_alleles': os.path.join(analysis_dir, 'tumour_alleles.tsv'),
    }
    chrom_idx = write_interval_counts(
        paths['counts'], segments, normal_seqdata, tumour_seqdata,
        max_copy_number)
    het = formats.het_tumour_allele_counts(normal_seqdata, tumour_seqdata)
    write_alleles(paths['tumour_alleles'], het, chrom_idx)
    het_normal = formats.het_tumour_allele_counts(
        normal_seqdata, normal_seqdata)
    write_alleles(paths['normal_alleles'], het_normal, chrom_idx)
    paths['chrom_idx'] = chrom_idx
    return paths


def run(analysis_dir, theta_bin, octave_bin_directory, num_intervals=15):
    """Run THetA then the octave BAF model (requires installations)."""
    counts = os.path.join(analysis_dir, 'counts.tsv')
    prefix = os.path.join(analysis_dir, 'theta')
    subprocess.check_call([
        theta_bin, counts, '--FORCE',
        '--NUM_INTERVALS', str(num_intervals),
        '--OUTPUT_PREFIX', prefix,
    ])
    chrom_ids = sorted(set(pd.read_csv(
        counts, sep='\t', header=None,
        names=INTERVAL_COLUMNS)['chrom_idx']))
    args = ", ".join([
        "'{}'".format(os.path.join(analysis_dir, 'tumour_alleles.tsv')),
        "'{}'".format(os.path.join(analysis_dir, 'normal_alleles.tsv')),
        "'{}'".format(counts),
        "'{}'".format(prefix + '.n3.results'),
        '[' + ','.join(map(str, chrom_ids)) + ']',
        "'{}'".format(os.path.join(analysis_dir, 'theta2')),
        '[11,8]',
        "'none'",
    ])
    subprocess.check_call(
        'octave --eval "cd {}; runBAFGaussianModel({})"'.format(
            octave_bin_directory, args),
        shell=True)


def parse_results(results_filename, counts_filename, chrom_names):
    """Best THetA2 solution -> (standard cn table, mixture list).

    chrom_names: index -> chromosome name mapping (inverse of
    chromosome_index).
    """
    results = pd.read_csv(results_filename, sep='\t').rename(
        columns={'#NLL': 'NLL'})
    best = results.loc[(results['NLL'] + results['BAF_NLL']).idxmin()]

    mix = [float(v) for v in str(best['mu']).split(',')]

    per_interval = np.array(
        [entry.split(',') for entry in str(best['C']).split(':')],
        dtype=int)                                    # (intervals, clones)

    counts = pd.read_csv(counts_filename, sep='\t', header=None,
                         names=INTERVAL_COLUMNS)
    table = pd.DataFrame({
        'chromosome': counts['chrom_idx'].map(chrom_names),
        'start': counts['start'],
        'end': counts['end'],
        'total_1': per_interval[:, 0],
        'total_2': per_interval[:, 1] if per_interval.shape[1] > 1
        else per_interval[:, 0],
    })
    return table, mix


def report(analysis_dir, output_cn_filename, output_mix_filename,
           chrom_names):
    table, mix = parse_results(
        os.path.join(analysis_dir, 'theta2.BAF.NLL.results'),
        os.path.join(analysis_dir, 'counts.tsv'),
        chrom_names)
    with open(output_mix_filename, 'w') as f:
        f.write('\t'.join(str(a) for a in mix) + '\n')
    table.to_csv(output_cn_filename, sep='\t', index=False)
