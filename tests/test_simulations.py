"""Simulation subsystem tests.

Patterns from the reference suite: seed-replay invariants
(test_remixt.py:388-434 test_recreate/test_rewind), sampler sanity, and the
evaluation metrics applied to a perfect prediction (must score 1.0).
"""

import numpy as np
import pandas as pd
import pytest

import remixt_jax.simulations.genome as sim_genome
import remixt_jax.simulations.pipeline as sim_pipeline


GENOME_PARAMS = dict(
    sim_genome.RearrangedGenome.default_params,
    genome_length=3e8, num_chromosomes=5, seg_length_min=10000,
)


def make_genome(N=100, num_events=10, seed=123):
    np.random.seed(seed)
    genome = sim_genome.RearrangedGenome(N)
    genome.create(dict(GENOME_PARAMS))
    for _ in range(num_events):
        genome.rearrange(dict(GENOME_PARAMS))
    return genome


def test_recreate():
    """Replaying stored seeds must reproduce the genome exactly."""
    genome = make_genome()
    chromosomes_before = list(genome.chromosomes)
    cn_before = genome.segment_copy_number.copy()

    genome.recreate()

    assert genome.chromosomes == chromosomes_before
    np.testing.assert_array_equal(genome.segment_copy_number, cn_before)


def test_rewind():
    """Rewinding to k events matches a genome built with only those events."""
    genome = make_genome(num_events=10)

    partial = genome.copy()
    partial.rewind(4)

    replay = sim_genome.RearrangedGenome(genome.N)
    replay.init_params = genome.init_params
    replay.init_seed = genome.init_seed
    replay.event_params = list(genome.event_params[:4])
    replay.event_seeds = list(genome.event_seeds[:4])
    replay.recreate()

    assert partial.chromosomes == replay.chromosomes


def test_copy_independence():
    genome = make_genome(num_events=2)
    clone = genome.copy()
    np.random.seed(99)
    clone.rearrange(dict(GENOME_PARAMS))
    # parent history unchanged
    assert len(genome.event_seeds) == 2
    assert len(clone.event_seeds) == 3


def test_segment_copy_number_wild_type():
    np.random.seed(5)
    genome = sim_genome.RearrangedGenome(50)
    genome.create(dict(GENOME_PARAMS))
    cn = genome.segment_copy_number
    np.testing.assert_array_equal(cn, np.ones((50, 2)))
    assert len(genome.breakpoints) == 0
    assert genome.ploidy() == pytest.approx(2.0)


def test_breakpoint_copy_number_consistency():
    """Every reported breakpoint has positive copies; wild-type adjacencies
    are never reported."""
    genome = make_genome(num_events=15, seed=7)
    brk_cn = genome.breakpoint_copy_number
    for bp, cn in brk_cn.items():
        assert cn > 0
        assert bp not in genome.wt_adj


def test_length_divergent_monoclonal():
    """A wild type + single descendant collection has no clone pair; the
    divergence metric must be 0, not an IndexError."""
    genome = make_genome(num_events=3, seed=21)
    collection = sim_genome.GenomeCollection([make_genome(num_events=0,
                                                          seed=21), genome])
    assert collection.length_divergent() == 0.0


def test_breakpoint_table_foldback_single_breakend():
    """A fold-back junction (size-1 breakend set) must still fill the _2
    columns — downstream readers parse position_2 as int."""
    genome = make_genome(num_events=0, seed=31)
    collection = sim_genome.GenomeCollection([genome])
    table = sim_genome._breakpoint_table(
        {7: frozenset([(3, 1)])}, collection)
    row = table.iloc[0]
    assert row['n_2'] == 3 and row['side_2'] == 1
    assert row['position_2'] == row['position_1']
    assert not table.isna().any().any()


def test_sim_id_is_stable_digest(tmp_path):
    """sim ids must be content-addressed with a stable digest (built-in
    hash() is salted per process and would re-key outputs every run)."""
    defs = tmp_path / 'defs.py'
    defs.write_text(
        "defaults = {'a': 1}\n"
        "base_settings = {'b': [1, 2]}\n")
    ids1 = sorted(sim_pipeline.read_sim_defs(str(defs)))
    ids2 = sorted(sim_pipeline.read_sim_defs(str(defs)))
    assert ids1 == ids2 and len(ids1) == 2
    import hashlib
    content = '\0'.join(sorted(['a=1', 'b=1', 'name=base']))
    expected = hashlib.sha1(content.encode()).hexdigest()[:16]
    assert 'base_{}'.format(expected) in ids1


def test_germline_alleles_string_roundtrip(tmp_path, monkeypatch):
    """String columns (ref/alt/nt_*) must survive the h5py store, which has
    no native object-dtype support."""
    import remixt_jax.simulations.haplotype as sim_hap

    table = pd.DataFrame({
        'position': [100, 200, 300],
        'allele1': [0, 1, 0],
        'allele2': [1, 0, 1],
        'ref': ['A', 'CT', 'G'],
        'alt': ['T', 'C', 'GA'],
    })
    monkeypatch.setattr(sim_hap, 'create_sim_alleles',
                        lambda chromosome, config, ref_data_dir: table)
    path = str(tmp_path / 'germline.h5')
    sim_pipeline.simulate_germline_alleles(
        path, {'random_seed': 1, 'chromosomes': ['1']}, {}, None)
    loaded = sim_pipeline.load_germline_alleles(path, '1')
    assert list(loaded['ref']) == ['A', 'CT', 'G']
    assert list(loaded['alt']) == ['T', 'C', 'GA']
    np.testing.assert_array_equal(loaded['position'].values,
                                  table['position'].values)


@pytest.fixture(scope='module')
def sampled_experiment():
    np.random.seed(11)
    params = dict(
        GENOME_PARAMS,
        N=100, M=3,
        num_ancestral_events=10, num_descendent_events=4,
        ploidy=2.0, ploidy_max_error=0.7,
        proportion_loh=0.1, proportion_loh_max_error=0.3,
        proportion_subclonal=0.1, proportion_subclonal_max_error=0.3,
        proportion_subclonal_stddev=0.1,
        ploidy_stddev=0.3, proportion_loh_stddev=0.1,
        num_swarm=20,
        frac_normal=0.4, num_false_breakpoints=5,
        h_total=0.08,
        random_seed=11,
    )
    history_sampler = sim_genome.RearrangementHistorySampler(params)
    collection_sampler = sim_genome.GenomeCollectionSampler(history_sampler, params)
    mixture_sampler = sim_genome.GenomeMixtureSampler(params)
    experiment_sampler = sim_genome.ExperimentSampler(params)

    collection = collection_sampler.sample_genome_collection()
    mixture = mixture_sampler.sample_genome_mixture(collection)
    experiment = experiment_sampler.sample_experiment(mixture)
    return experiment


def test_genome_collection(sampled_experiment):
    gc = sampled_experiment.genome_mixture.genome_collection
    assert gc.M == 3
    assert gc.cn.shape == (gc.N, 3, 2)
    # normal clone is diploid
    np.testing.assert_array_equal(gc.cn[:, 0, :], np.ones((gc.N, 2)))


def test_experiment_counts(sampled_experiment):
    exp = sampled_experiment
    assert exp.x.shape == (exp.N, 3)
    assert np.all(exp.x[:, 1] <= exp.x[:, 0])
    assert np.all(exp.x >= 0)
    # read counts roughly consistent with depth
    expected = (exp.l * (exp.cn.sum(axis=2) * exp.h).sum(axis=1))
    observed = exp.x[:, 2]
    ratio = observed.sum() / expected.sum()
    assert 0.8 < ratio < 1.2


def test_evaluate_perfect_prediction(sampled_experiment):
    """The evaluation metrics must give a perfect score to the truth."""
    exp = sampled_experiment
    mixture = exp.genome_mixture

    cn_table = pd.DataFrame({
        'chromosome': mixture.segment_chromosome_id,
        'start': mixture.segment_start,
        'end': mixture.segment_end,
        'major_1': mixture.cn[:, 1, :].max(axis=1),
        'minor_1': mixture.cn[:, 1, :].min(axis=1),
        'major_2': mixture.cn[:, 2, :].max(axis=1),
        'minor_2': mixture.cn[:, 2, :].min(axis=1),
    })

    # perfect breakpoint prediction from minimized truth
    min_true = mixture.genome_collection.collapsed_minimal_breakpoint_copy_number()
    rows = []
    for prediction_id, bp in mixture.detected_breakpoints.items():
        cn = min_true.get(bp, np.zeros(3))
        rows.append({'prediction_id': prediction_id,
                     'cn_1': cn[1], 'cn_2': cn[2]})
    brk_cn_table = pd.DataFrame(rows)

    results = sim_pipeline.evaluate_results(
        mixture, cn_table, brk_cn_table, mixture.frac.copy())

    cn_eval = results['cn_evaluation']
    assert cn_eval['proportion_cn_correct'] == pytest.approx(1.0)
    assert cn_eval['proportion_dom_cn_correct'] == pytest.approx(1.0)
    assert cn_eval['true_ploidy'] == pytest.approx(cn_eval['pred_ploidy'])

    brk_eval = results['brk_cn_evaluation']
    assert brk_eval['brk_cn_correct_proportion'] == pytest.approx(1.0)

    mix_results = results['mix_results']
    for idx in range(3):
        assert mix_results['mix_true_%d' % idx] == pytest.approx(
            mix_results['mix_pred_%d' % idx])


def test_minimize_breakpoint_copies(sampled_experiment):
    gc = sampled_experiment.genome_mixture.genome_collection
    full = gc.collapsed_breakpoint_copy_number()
    minimal = gc.collapsed_minimal_breakpoint_copy_number()
    assert set(minimal.keys()) == set(full.keys())
    for bp in full:
        assert np.all(minimal[bp] <= full[bp])
