"""Simulated germline alleles from 1000 Genomes panels.

Mirrors /root/reference/remixt/simulations/haplotype.py:10-95 — two germline
haplotypes per chromosome assembled by recombining panel individuals at a
Poisson rate along the chromosome.
"""

import gzip

import numpy as np
import pandas as pd

import remixt_jax.config


def create_sim_alleles(chromosome, config, ref_data_dir, recomb_rate=20.0 / 1.e8):
    """Simulated het alleles for one chromosome.

    Returns dataframe with columns position, ref, alt, is_alt_0, is_alt_1,
    nt_0, nt_1.
    """
    hap_filename = remixt_jax.config.get_filename(
        config, ref_data_dir, 'haplotypes', chromosome=chromosome)
    legend_filename = remixt_jax.config.get_filename(
        config, ref_data_dir, 'legend', chromosome=chromosome)

    data = pd.read_csv(legend_filename, compression='gzip', sep=' ',
                       usecols=['position', 'a0', 'a1'])

    with gzip.open(hap_filename, 'rt') as hap_file:
        num_1kg_individuals = len(hap_file.readline().split()) // 2

    chromosome_length = data['position'].max() + 1000

    num_recombinations = int(np.ceil(recomb_rate * chromosome_length))

    # random recombination positions and per-region panel individuals
    recomb_positions = np.sort(
        np.random.randint(1, chromosome_length, num_recombinations))
    recomb_individuals = np.random.randint(
        0, num_1kg_individuals, num_recombinations + 1)

    recomb_start = np.array([0] + list(recomb_positions))
    recomb_end = np.array(list(recomb_positions) + [chromosome_length])

    data['individual'] = -1
    for start, end, individual in zip(recomb_start, recomb_end, recomb_individuals):
        data.loc[(data['position'] >= start) & (data['position'] < end),
                 'individual'] = individual
    assert np.all(data['individual'] >= 0)

    individual_cols = np.concatenate([
        data['individual'].unique() * 2,
        data['individual'].unique() * 2 + 1,
    ])
    individual_cols.sort()

    individual_idx = np.searchsorted(
        np.sort(data['individual'].unique()), data['individual'])
    individual_idx_0 = individual_idx * 2
    individual_idx_1 = individual_idx * 2 + 1

    hap_data = pd.read_csv(
        hap_filename, compression='gzip', sep=' ', dtype=np.uint8, header=None,
        names=range(num_1kg_individuals * 2), usecols=individual_cols).values
    data['is_alt_0'] = hap_data[data.index.values, individual_idx_0]
    data['is_alt_1'] = hap_data[data.index.values, individual_idx_1]

    data['nt_0'] = np.where(data['is_alt_0'] == 0, data['a0'], data['a1'])
    data['nt_1'] = np.where(data['is_alt_1'] == 0, data['a0'], data['a1'])

    # remove indels
    data = data[(data['a0'].str.len() == 1) & (data['a1'].str.len() == 1)]

    data = data.sort_values('position').reset_index(drop=True)

    data = data.rename(columns={'a0': 'ref', 'a1': 'alt'})
    return data[['position', 'ref', 'alt', 'is_alt_0', 'is_alt_1', 'nt_0', 'nt_1']]
