"""Segmentation and segment read counting.

Capability parity with the reference segmentation layer
(/root/reference/remixt/analysis/segment.py:10-253): a regular-grid
segmentation augmented with assembly-gap boundaries and predicted
breakends, fragment counting by interval containment, and the merge of
haplotype-block allele counts into the final count table.

Changepoint assembly, pairing, and gap filtering here are vectorized —
stacked coded (chromosome, position) arrays, shift-based pairing, and a
cummax interval merge — rather than per-row loops.
"""

import numpy as np
import pandas as pd

import remixt_jax.config
import remixt_jax.seqdataio
import remixt_jax.segalg

GAP_TABLE_COLUMNS = [
    'bin', 'chromosome', 'start', 'end', 'ix', 'n', 'size', 'type', 'bridge',
]


def _check_chr_prefix(series, chr_name_prefix):
    if chr_name_prefix == 'chr':
        assert series.str.startswith('chr').all()
    elif chr_name_prefix == '':
        assert not series.str.startswith('chr').any()
    else:
        raise ValueError(
            'unrecognized chr_name_prefix {}'.format(chr_name_prefix))


def _merge_intervals(starts, ends):
    """Union of possibly-overlapping [start, end) intervals, as two sorted
    arrays (classic sort + running-max sweep)."""
    order = np.argsort(starts, kind='stable')
    starts, ends = starts[order], np.maximum.accumulate(ends[order])
    new_run = np.concatenate(([True], starts[1:] > ends[:-1]))
    merged_starts = starts[new_run]
    merged_ends = np.maximum.reduceat(ends, np.flatnonzero(new_run))
    return merged_starts, merged_ends


def assemble_changepoints(chromosomes, chromosome_lengths, segment_length,
                          gap_table, breakpoints=None):
    """All changepoint (chromosome, position) pairs: the regular grid plus
    chromosome ends, gap boundaries, and breakend positions."""
    parts = []
    for chromosome in chromosomes:
        length = int(chromosome_lengths[chromosome])
        grid = np.arange(0, length, segment_length, dtype=np.int64)
        parts.append(pd.DataFrame({
            'chromosome': chromosome,
            'position': np.concatenate([grid, [length]]),
        }))

    parts.append(pd.DataFrame({
        'chromosome': np.repeat(gap_table['chromosome'].values, 2),
        'position': gap_table[['start', 'end']].values.reshape(-1),
    }))

    if breakpoints is not None:
        parts.append(pd.DataFrame({
            'chromosome': np.concatenate([
                breakpoints['chromosome_1'].values,
                breakpoints['chromosome_2'].values]),
            'position': np.concatenate([
                breakpoints['position_1'].values,
                breakpoints['position_2'].values]),
        }))

    return pd.concat(parts, ignore_index=True)


def create_segments(segment_filename, config, ref_data_dir,
                    breakpoint_filename=None):
    """Write the segmentation TSV (regular grid + gaps + breakends)."""
    segment_length = remixt_jax.config.get_param(config, 'segment_length')
    chromosomes = remixt_jax.config.get_chromosomes(config, ref_data_dir)
    chromosome_lengths = remixt_jax.config.get_chromosome_lengths(
        config, ref_data_dir)
    gap_table_filename = remixt_jax.config.get_filename(
        config, ref_data_dir, 'gap_table')
    chr_name_prefix = remixt_jax.config.get_param(config, 'chr_name_prefix')

    gap_table = pd.read_csv(
        gap_table_filename, sep='\t', compression='gzip', header=None,
        names=GAP_TABLE_COLUMNS, converters={'chromosome': str})
    _check_chr_prefix(gap_table['chromosome'], chr_name_prefix)

    breakpoints = None
    if breakpoint_filename is not None:
        breakpoints = pd.read_csv(
            breakpoint_filename, sep='\t',
            converters={'chromosome_1': str, 'chromosome_2': str,
                        'position_1': int, 'position_2': int})
        _check_chr_prefix(breakpoints['chromosome_1'], chr_name_prefix)
        _check_chr_prefix(breakpoints['chromosome_2'], chr_name_prefix)

    changepoints = assemble_changepoints(
        chromosomes, chromosome_lengths, segment_length, gap_table,
        breakpoints)

    # pair successive changepoints within each chromosome (shift-based)
    changepoints = changepoints.sort_values(
        ['chromosome', 'position'], kind='stable')
    same_chrom = (changepoints['chromosome'].values[:-1]
                  == changepoints['chromosome'].values[1:])
    segments = pd.DataFrame({
        'chromosome': changepoints['chromosome'].values[:-1][same_chrom],
        'start': changepoints['position'].values[:-1][same_chrom],
        'end': changepoints['position'].values[1:][same_chrom],
    })
    segments = segments[segments['start'] < segments['end']]

    # drop segments starting inside an assembly gap
    in_gap = np.zeros(len(segments.index), dtype=bool)
    for chromosome, gaps in gap_table.groupby('chromosome'):
        on_chrom = (segments['chromosome'] == chromosome).values
        if not on_chrom.any():
            continue
        gap_starts, gap_ends = _merge_intervals(
            gaps['start'].values.astype(np.int64),
            gaps['end'].values.astype(np.int64))
        gap_spans = np.stack([gap_starts, gap_ends], axis=1)
        owner = remixt_jax.segalg.find_contained_positions(
            gap_spans, segments.loc[on_chrom, 'start'].values)
        in_gap[on_chrom] = owner >= 0
    segments = segments[~in_gap]

    # keep only configured chromosomes (gap tables and breakpoint files may
    # carry chrY/chrM/unplaced contigs — the reference's inner merge drops
    # them), ordered by the configured list then position
    chrom_rank = {c: i for i, c in enumerate(chromosomes)}
    segments = segments[segments['chromosome'].isin(chrom_rank)]
    segments = segments.assign(
        _rank=segments['chromosome'].map(chrom_rank)).sort_values(
            ['_rank', 'start'], kind='stable')

    segments.to_csv(segment_filename, sep='\t', index=False,
                    columns=['chromosome', 'start', 'end'])


def count_segment_reads(seqdata_filename, chromosome, segments,
                        filter_duplicates=False, map_qual_threshold=1):
    """Fragments fully contained in each segment of one chromosome."""
    reads = remixt_jax.seqdataio.read_fragment_data(
        seqdata_filename, chromosome,
        filter_duplicates=filter_duplicates,
        map_qual_threshold=map_qual_threshold)

    ordered = segments.sort_values('start')
    ordered['readcount'] = remixt_jax.segalg.contained_counts(
        ordered[['start', 'end']].values,
        reads.sort_values('start')[['start', 'end']].values)
    return ordered.sort_index()


def create_segment_counts(segments, seqdata_filename, filter_duplicates=False,
                          map_qual_threshold=1):
    """Fragment counting fanned over the segment table by chromosome."""
    counted = [
        count_segment_reads(
            seqdata_filename, chromosome, chrom_segments.copy(),
            filter_duplicates=filter_duplicates,
            map_qual_threshold=map_qual_threshold)
        for chromosome, chrom_segments in segments.groupby('chromosome')]
    return pd.concat(counted).sort_index()


def create_segment_allele_counts(segment_data, allele_data):
    """Merge haplotype-block phased allele counts into segment counts,
    deriving major/minor columns and the phase indicator."""
    keys = ['chromosome', 'start', 'end']

    per_segment = (
        allele_data
        .pivot_table(index=keys, columns='is_allele_a',
                     values='readcount', aggfunc='sum', fill_value=0)
        .reindex(columns=[0, 1], fill_value=0)
        .rename(columns={1: 'allele_a_readcount', 0: 'allele_b_readcount'})
    )
    per_segment = per_segment.reindex(
        segment_data.set_index(keys).index, fill_value=0).astype(int)

    a = per_segment['allele_a_readcount']
    b = per_segment['allele_b_readcount']
    per_segment['major_readcount'] = np.maximum(a, b)
    per_segment['minor_readcount'] = np.minimum(a, b)
    per_segment['major_is_allele_a'] = (a >= b).astype(int)

    return segment_data.merge(per_segment, left_on=keys, right_index=True)
