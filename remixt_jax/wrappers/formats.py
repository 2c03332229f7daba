"""Shared input-extraction helpers for competitor-tool wrappers.

Every external caller consumes the same two views of a seqdata store:
fixed-width binned read counts per chromosome, and tumour allele counts at
positions called heterozygous in the matched normal.  These are computed
once here; the per-tool modules only reformat them.

Capability parity with the input-preparation halves of the reference
wrappers (/root/reference/remixt/wrappers/{wraptitan,wraptheta,
wrapclonehd}.py); the extraction runs against this package's h5py seqdata
store and vectorized interval ops.
"""

import numpy as np
import pandas as pd

import remixt_jax.seqdataio
import remixt_jax.segalg
import remixt_jax.analysis.haplotype


def binned_read_counts(seqdata_filename, chromosome_lengths, bin_size=1000):
    """Fragment counts on a fixed bin grid.

    Yields (chromosome, counts ndarray) in seqdata chromosome order; bins
    span [i*bin_size, (i+1)*bin_size) up to the chromosome length.
    """
    for chromosome in remixt_jax.seqdataio.read_chromosomes(seqdata_filename):
        fragments = remixt_jax.seqdataio.read_fragment_data(
            seqdata_filename, chromosome)
        fragments = fragments.sort_values('start')

        num_bins = int(np.ceil(chromosome_lengths[chromosome] / bin_size))
        bounds = np.arange(num_bins + 1, dtype=np.int64) * bin_size
        bins = np.stack([bounds[:-1], bounds[1:]], axis=1)

        counts = remixt_jax.segalg.contained_counts(
            bins, fragments[['start', 'end']].values)
        yield chromosome, counts


def het_tumour_allele_counts(normal_seqdata, tumour_seqdata):
    """Tumour ref/alt counts at heterozygous SNPs called from the normal.

    Returns a DataFrame with chromosome, position, ref_count, alt_count,
    concatenated over all chromosomes of the normal store.
    """
    tables = []
    for chromosome in remixt_jax.seqdataio.read_chromosomes(normal_seqdata):
        normal_counts = remixt_jax.analysis.haplotype.read_snp_counts(
            normal_seqdata, chromosome)
        remixt_jax.analysis.haplotype.infer_snp_genotype(normal_counts)
        het = normal_counts.loc[normal_counts['AB'] == 1, ['position']]

        tumour_counts = remixt_jax.analysis.haplotype.read_snp_counts(
            tumour_seqdata, chromosome)
        tumour_counts = tumour_counts.merge(het, on='position')
        tumour_counts['chromosome'] = chromosome
        tumour_counts['ref_count'] = tumour_counts['ref_count'].astype(int)
        tumour_counts['alt_count'] = tumour_counts['alt_count'].astype(int)
        tables.append(tumour_counts[
            ['chromosome', 'position', 'ref_count', 'alt_count']])

    if not tables:
        return pd.DataFrame(
            columns=['chromosome', 'position', 'ref_count', 'alt_count'])
    return pd.concat(tables, ignore_index=True)


def segment_read_counts(seqdata_filename, segments):
    """Fragment counts for an explicit segment table
    (columns chromosome/start/end); returns the table with a 'count'
    column added."""
    out = segments.copy()
    out['count'] = 0
    for chromosome in remixt_jax.seqdataio.read_chromosomes(seqdata_filename):
        on_chrom = out['chromosome'] == chromosome
        if not on_chrom.any():
            continue
        fragments = remixt_jax.seqdataio.read_fragment_data(
            seqdata_filename, chromosome).sort_values('start')
        out.loc[on_chrom, 'count'] = remixt_jax.segalg.contained_counts(
            out.loc[on_chrom, ['start', 'end']].values,
            fragments[['start', 'end']].values)
    return out
