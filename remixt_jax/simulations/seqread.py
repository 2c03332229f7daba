"""Read-level simulation: fragments on rearranged genomes, SNP intersection.

Capability parity with /root/reference/remixt/simulations/seqread.py:9-390:
fragment interval sampling on the concatenated rearranged genome,
orientation-aware remapping back to reference coordinates, SNP overlap with
base-call errors, and resampling of real reads to simulated per-segment
depths. Organized as a coordinate-mapping core (`segment_remap`,
`_map_fragments_to_reference`) shared by the simulate and resample drivers,
with per-chromosome emission through one `_emit_chromosome` path.
"""

import collections

import numpy as np
import pandas as pd

import remixt_jax.segalg
import remixt_jax.seqdataio


def segment_remap(segments, positions):
    """Map positions on the concatenation of ``segments`` back into the
    segments' own coordinates.

    Returns (segment index, remapped position) per input position
    (parity: reference seqread.py:44-80).
    """
    lengths = segments[:, 1] - segments[:, 0]
    boundaries = np.cumsum(lengths)
    total = boundaries[-1] if len(boundaries) else 0
    if np.any(positions > total):
        raise ValueError('positions should be less than total segment length')

    which = np.searchsorted(boundaries, positions, side='right')
    offset = positions - (boundaries[which] - lengths[which])
    return which, segments[which, 0] + offset


def simulate_fragment_intervals(genome_length, num_fragments, read_length,
                                fragment_mean, fragment_stddev):
    """Fragment (start, length) draws: uniform starts, normal lengths,
    dropping fragments shorter than a read or running off the genome
    (parity: reference seqread.py:9-40)."""
    starts = np.sort(
        np.random.randint(0, high=genome_length, size=num_fragments))
    lengths = np.asarray(
        np.random.randn(num_fragments) * fragment_stddev + fragment_mean,
        dtype=int)
    keep = (lengths >= read_length) & (starts + lengths < genome_length)
    return starts[keep], lengths[keep]


def _signed_segment_table(genome):
    """Segment copies in rearranged order, with reverse-orientation copies
    encoded as negated, swapped coordinates so one remap handles both
    orientations (the unflip happens in `_map_fragments_to_reference`)."""
    table = genome.segment_copy_table()
    reverse = table['orientation'] != 1
    flipped = -table.loc[reverse, ['end', 'start']].values
    table.loc[reverse, ['start', 'end']] = flipped
    return table


def _map_fragments_to_reference(segment_table, starts, lengths):
    """Reference-coordinate fragments from concatenated-genome draws.

    Both fragment ends remap through the signed segment table; fragments
    whose ends land in different segment copies are discarded, and
    fragments on reversed copies are flipped back to forward reference
    coordinates. Returns a frame indexed by segment-copy index with
    start/end columns.
    """
    coords = segment_table[['start', 'end']].values
    seg_of_end, ref_end = segment_remap(coords, starts + lengths)
    seg_of_start, ref_start = segment_remap(coords, starts)

    within_one_segment = ref_end - ref_start == lengths
    seg_idx = seg_of_start[within_one_segment]
    ref_start = ref_start[within_one_segment]
    lengths = lengths[within_one_segment]

    # signed (reversed) copies produced negative coordinates
    flipped = ref_start < 0
    ref_start = np.where(flipped, -ref_start - lengths, ref_start)

    fragments = pd.DataFrame(
        {'start': ref_start, 'end': ref_start + lengths}, index=seg_idx)
    fragments['allele'] = segment_table['allele'].reindex(fragments.index)
    return fragments


def _overlap_snps(fragments, chrom_snps, read_length, base_call_error):
    """Allele observations: SNPs under either sequenced read end of each
    fragment, read from the fragment's germline allele with base-call
    errors flipped in (parity: reference seqread.py:210-240)."""
    frag_idx, snp_idx = remixt_jax.segalg.interval_position_overlap(
        fragments[['start', 'end']].values, chrom_snps['position'].values)

    observations = pd.concat([
        fragments.iloc[frag_idx].reset_index(drop=True),
        chrom_snps.iloc[snp_idx].reset_index(drop=True),
    ], axis=1)
    observations['fragment_idx'] = frag_idx
    observations['snp_idx'] = snp_idx

    under_read = (
        (observations['position'] < observations['start'] + read_length)
        | (observations['position'] >= observations['end'] - read_length))
    observations = observations[under_read]

    germline = np.where(observations['allele'] == 0,
                        observations['is_alt_0'], observations['is_alt_1'])
    miscalled = np.random.choice(
        [True, False], size=len(observations.index),
        p=[base_call_error, 1. - base_call_error])
    observations['is_alt'] = np.where(miscalled, 1 - germline, germline)
    return observations


class _FragmentIds(object):
    """Per-chromosome monotone fragment id allocation across write calls."""

    def __init__(self):
        self._next = collections.Counter()

    def assign(self, chromosome, fragments):
        n = len(fragments.index)
        fragments['fragment_id'] = np.arange(n) + self._next[chromosome]
        self._next[chromosome] += n
        return fragments


def _emit_chromosome(writer, ids, chromosome, fragments, snps, params):
    """Assign ids, intersect SNPs, and write one chromosome's fragments."""
    fragments = ids.assign(chromosome, fragments.reset_index(drop=True))
    observations = _overlap_snps(
        fragments, snps['/chromosome_{}'.format(chromosome)],
        params['read_length'], params['base_call_error'])
    writer.write(chromosome, fragments, observations)
    return len(fragments.index)


def simulate_mixture_read_data(read_data_filename, genomes, read_depths,
                               snps, params):
    """Simulated seqdata for a mixture of rearranged genomes
    (parity: reference seqread.py:120-246).

    Each genome contributes ``haploid depth × rearranged length``
    fragments, drawn on its concatenated rearranged sequence in chunks and
    remapped to reference coordinates.
    """
    writer = remixt_jax.seqdataio.Writer(read_data_filename)
    ids = _FragmentIds()
    chunk_cap = 40000000

    for genome, read_depth in zip(genomes, read_depths):
        segment_table = _signed_segment_table(genome)
        rearranged_length = segment_table['length'].sum()
        remaining = int(rearranged_length * read_depth)

        while remaining > 0:
            starts, lengths = simulate_fragment_intervals(
                rearranged_length, min(chunk_cap, remaining),
                params['read_length'], params['fragment_mean'],
                params['fragment_stddev'])
            fragments = _map_fragments_to_reference(
                segment_table, starts, lengths)

            for chromosome, chrom_fragments in fragments.groupby(
                    segment_table['chromosome']):
                remaining -= _emit_chromosome(
                    writer, ids, chromosome,
                    chrom_fragments[['start', 'end', 'allele']],
                    snps, params)

    writer.close()


def _mixture_depth_targets(genomes, read_depths):
    """Target read depth per (chromosome, segment, allele): copies in each
    genome times that genome's haploid depth, summed over genomes."""
    copy_rows = []
    for genome_idx, genome in enumerate(genomes):
        table = genome.segment_copy_table()
        table['depth'] = read_depths[genome_idx]
        copy_rows.append(table)
    copies = pd.concat(copy_rows, ignore_index=True)

    targets = (copies
               .groupby(['chromosome', 'start', 'end', 'allele'])['depth']
               .sum().rename('read_depth').reset_index())
    targets['length'] = targets['end'] - targets['start']
    return targets


def _source_fragments_with_targets(chrom_targets, source_filename,
                                   chromosome):
    """Source fragments joined to their containing segment's target depth;
    fragments contained in no segment drop, fragments in a segment with
    both alleles duplicate per allele (parity: reference seqread.py:249-269)."""
    segments = (chrom_targets[['start', 'end']].drop_duplicates()
                .sort_values('start').reset_index(drop=True))
    segments['segment_idx'] = segments.index

    fragments = remixt_jax.seqdataio.read_fragment_data(
        source_filename, chromosome)
    fragments['segment_idx'] = remixt_jax.segalg.find_contained_segments(
        segments[['start', 'end']].values,
        fragments[['start', 'end']].values)
    fragments = fragments[fragments['segment_idx'] >= 0]

    keyed_targets = chrom_targets.merge(segments)[
        ['segment_idx', 'allele', 'read_depth']]
    return fragments.merge(keyed_targets)


def resample_mixture_read_data(read_data_filename, source_filename, genomes,
                               read_depths, snps, params):
    """Resample real reads to simulated per-segment depths
    (parity: reference seqread.py:272-390).

    Every source fragment is drawn a Poisson number of times with rate
    proportional to its segment's target depth, normalized so the total
    expected read count matches the simulated mixture.
    """
    targets = _mixture_depth_targets(genomes, read_depths)
    wanted_reads = (targets['length'] * targets['read_depth']).sum()

    available_depth = sum(
        _source_fragments_with_targets(
            chrom_targets, source_filename, chromosome)['read_depth'].sum()
        for chromosome, chrom_targets in targets.groupby('chromosome'))

    writer = remixt_jax.seqdataio.Writer(read_data_filename)
    ids = _FragmentIds()

    for chromosome, chrom_targets in targets.groupby('chromosome'):
        pool = _source_fragments_with_targets(
            chrom_targets, source_filename, chromosome)

        rate = pool['read_depth'].values * wanted_reads / available_depth
        draws = np.random.poisson(rate)
        resampled = pd.DataFrame(
            np.repeat(pool[['start', 'end', 'allele']].values, draws, axis=0),
            columns=['start', 'end', 'allele']).astype(int)

        _emit_chromosome(writer, ids, chromosome, resampled, snps, params)

    writer.close()
