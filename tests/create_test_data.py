"""Fixture generator: simulated experiment pickle for integration tests
(parity with reference tests/create_test_data.py:15-50 — N=5000, M=3
mixture via the simulation stack; the pickle is regenerated, not checked
in).

Usage: python tests/create_test_data.py [output.pickle]
"""

import pickle
import sys

import numpy as np

import remixt_jax.simulations.genome as sim_genome


def create_test_experiment(filename, N=5000, M=3, seed=2014):
    np.random.seed(seed)

    params = dict(
        N=N, M=M,
        num_ancestral_events=50, num_descendent_events=20,
        ploidy=2.5, ploidy_max_error=0.7,
        proportion_loh=0.2, proportion_loh_max_error=0.25,
        proportion_subclonal=0.3, proportion_subclonal_max_error=0.25,
        proportion_subclonal_stddev=0.1,
        ploidy_stddev=0.3, proportion_loh_stddev=0.1,
        num_swarm=50,
        frac_normal=0.4, frac_clone_1=0.4,
        num_false_breakpoints=50,
        proportion_breakpoints_detected=0.9,
        h_total=0.1,
    )

    history_sampler = sim_genome.RearrangementHistorySampler(params)
    collection_sampler = sim_genome.GenomeCollectionSampler(history_sampler, params)
    mixture_sampler = sim_genome.GenomeMixtureSampler(params)
    experiment_sampler = sim_genome.ExperimentSampler(params)

    collection = collection_sampler.sample_genome_collection()
    mixture = mixture_sampler.sample_genome_mixture(collection)
    experiment = experiment_sampler.sample_experiment(mixture)

    with open(filename, 'wb') as f:
        pickle.dump(experiment, f)


if __name__ == '__main__':
    output = sys.argv[1] if len(sys.argv) > 1 else 'test_experiment.pickle'
    create_test_experiment(output)
    print('wrote', output)
