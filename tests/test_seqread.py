"""Read-level simulation round trip.

Simulates fragments over a small rearranged genome and checks the emitted
seqdata: fragment intervals stay inside their chromosomes, depth matches
the requested haploid depth, and with zero base-call error the allele
observations reproduce the germline SNP states of the sampled allele.
"""

import numpy as np
import pandas as pd
import pytest

import remixt_jax.seqdataio as seqdataio
import remixt_jax.simulations.genome as sim_genome
import remixt_jax.simulations.seqread as seqread


PARAMS = {
    'read_length': 50,
    'fragment_mean': 200.,
    'fragment_stddev': 20.,
    'base_call_error': 0.0,
}


class SnpsAccessor(dict):
    def __getitem__(self, key):
        chromosome = key.split('chromosome_')[-1]
        return dict.__getitem__(self, chromosome)


@pytest.fixture()
def small_genome():
    np.random.seed(17)
    genome = sim_genome.RearrangedGenome(30)
    genome.create(dict(sim_genome.RearrangedGenome.default_params,
                       genome_length=2e6, num_chromosomes=2,
                       seg_length_min=5000))
    for _ in range(5):
        genome.rearrange(dict(sim_genome.RearrangedGenome.default_params))
    return genome


def make_snps(genome):
    rng = np.random.RandomState(3)
    snps = SnpsAccessor()
    for chromosome in np.unique(genome.segment_chromosome_id):
        length = int(genome.segment_end[
            genome.segment_chromosome_id == chromosome].max())
        positions = np.arange(250, length, 500)
        snps[chromosome] = pd.DataFrame({
            'position': positions,
            'is_alt_0': rng.randint(2, size=len(positions)),
            'is_alt_1': rng.randint(2, size=len(positions)),
        })
    return snps


def test_simulate_mixture_read_data(small_genome, tmp_path):
    genome = small_genome
    snps = make_snps(genome)
    out = str(tmp_path / 'reads.h5')

    np.random.seed(5)
    haploid_depth = 0.02
    seqread.simulate_mixture_read_data(
        out, [genome], [haploid_depth], snps, PARAMS)

    total_fragments = 0
    for chromosome in seqdataio.read_chromosomes(out):
        fragments = seqdataio.read_fragment_data(out, chromosome)
        total_fragments += len(fragments.index)
        assert (fragments['end'] > fragments['start']).all()
        chrom_length = genome.segment_end[
            genome.segment_chromosome_id == chromosome].max()
        assert fragments['start'].min() >= 0
        assert fragments['end'].max() <= chrom_length

        # with zero base-call error every allele observation matches one of
        # the two germline states at its SNP
        alleles = seqdataio.read_allele_data(out, chromosome)
        merged = alleles.merge(snps[chromosome], on='position')
        assert len(merged.index) == len(alleles.index)
        consistent = (merged['is_alt'] == merged['is_alt_0']) | (
            merged['is_alt'] == merged['is_alt_1'])
        assert consistent.all()

    # requested read count ~ genome copies x haploid depth x genome length
    expected = genome.segment_copy_table()['length'].sum() * haploid_depth
    assert 0.5 * expected < total_fragments <= expected


def test_segment_remap_roundtrip():
    segments = np.array([[100, 200], [500, 650], [900, 1000]])
    positions = np.array([0, 50, 99, 100, 249, 250, 349])
    seg_idx, remapped = seqread.segment_remap(segments, positions)
    np.testing.assert_array_equal(seg_idx, [0, 0, 0, 1, 1, 2, 2])
    np.testing.assert_array_equal(
        remapped, [100, 150, 199, 500, 649, 900, 999])


def test_resample_mixture_read_data(small_genome, tmp_path):
    """Resampling real reads to simulated depths: output fragments are a
    subset-with-replacement of the source positions at roughly the
    requested total depth."""
    genome = small_genome
    snps = make_snps(genome)

    source = str(tmp_path / 'source.h5')
    np.random.seed(21)
    seqread.simulate_mixture_read_data(source, [genome], [0.05], snps, PARAMS)

    out = str(tmp_path / 'resampled.h5')
    np.random.seed(22)
    seqread.resample_mixture_read_data(
        out, source, [genome], [0.02], snps, PARAMS)

    total = 0
    for chromosome in seqdataio.read_chromosomes(out):
        fragments = seqdataio.read_fragment_data(out, chromosome)
        total += len(fragments.index)
        source_fragments = seqdataio.read_fragment_data(source, chromosome)
        # every resampled interval exists in the source
        src = set(map(tuple, source_fragments[['start', 'end']].values))
        got = set(map(tuple, fragments[['start', 'end']].values))
        assert got <= src

    expected = genome.segment_copy_table()['length'].sum() * 0.02
    assert 0.4 * expected < total < 2.0 * expected
