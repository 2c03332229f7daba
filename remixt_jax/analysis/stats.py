"""Streaming fragment-length statistics over a seqdata store.

Capability parity with the reference's fragment-stats task
(/root/reference/remixt/analysis/stats.py:14-42): the mean and standard
deviation of mapped fragment lengths feed the GC-bias model's
fragment-length integral.  Lengths are reduced chunk-by-chunk to
``(count, sum, sum-of-squares)`` moment triples so the whole store is
never resident; triples from every chromosome are combined at the end.
"""

import collections

import numpy as np

import remixt_jax.config
import remixt_jax.seqdataio


FragmentStats = collections.namedtuple('FragmentStats', [
    'fragment_mean',
    'fragment_stddev',
])


def _chunk_moments(seqdata_filename, config):
    """Yield one (n, Σx, Σx²) triple per fragment chunk in the store."""
    filters = dict(
        filter_duplicates=remixt_jax.config.get_param(
            config, 'filter_duplicates'),
        map_qual_threshold=remixt_jax.config.get_param(
            config, 'map_qual_threshold'),
    )

    for chromosome in remixt_jax.seqdataio.read_chromosomes(seqdata_filename):
        chunks = remixt_jax.seqdataio.read_fragment_data(
            seqdata_filename, chromosome, chunksize=1000000, **filters)
        for fragments in chunks:
            lengths = (fragments['end'] - fragments['start']).to_numpy(
                dtype=np.float64)
            yield np.array([lengths.size, lengths.sum(), lengths @ lengths])


def calculate_fragment_stats(seqdata_filename, config):
    """Mean/stddev of fragment length across all chromosomes of a store."""
    total = sum(_chunk_moments(seqdata_filename, config))

    count, first, second = total
    mean = first / count
    variance = second / count - mean ** 2

    return FragmentStats(mean, np.sqrt(variance))
