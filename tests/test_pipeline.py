"""End-to-end pipeline test: count table + breakpoints → init → fits →
collated results store (the reference's minimum end-to-end slice,
SURVEY.md §7 stage 4)."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

from remixt_jax.analysis.experiment import Experiment
from remixt_jax.analysis import pipeline
from remixt_jax.io.hdf5 import HDFStore
from remixt_jax.simulations import simple as sim


def make_tables(data, segment_length=5e5):
    """Build count and breakpoint tables in the reference's TSV schema from a
    simulated experiment. Chains become chromosomes (positions restart per
    chromosome) so the Experiment path reproduces the simulated chain
    structure."""
    N = data['x'].shape[0]

    # chromosome per segment from chain boundaries (missing adjacencies)
    chrom_ids = np.zeros(N, dtype=int)
    for n in range(N - 1):
        chrom_ids[n + 1] = chrom_ids[n] + (
            0 if (n, n + 1) in data['adjacencies'] else 1)
    pos_in_chrom = np.zeros(N, dtype=int)
    for n in range(1, N):
        pos_in_chrom[n] = (pos_in_chrom[n - 1] + 1
                           if chrom_ids[n] == chrom_ids[n - 1] else 0)
    start = (pos_in_chrom * segment_length + 1).astype(int)
    end = ((pos_in_chrom + 1) * segment_length).astype(int)

    count_data = pd.DataFrame({
        'chromosome': [str(c + 1) for c in chrom_ids],
        'start': start,
        'end': end,
        'length': data['l'],
        'major_readcount': data['x'][:, 0].astype(int),
        'minor_readcount': data['x'][:, 1].astype(int),
        'readcount': data['x'][:, 2].astype(int),
        'major_is_allele_a': np.ones(N, dtype=int),
    })

    # breakpoint predictions at the segment extremities used by the truth
    rows = []
    for bp_id, bp in data['breakpoints'].items():
        (na, sa), (nb, sb) = sorted(bp)
        rows.append({
            'prediction_id': bp_id,
            'chromosome_1': str(chrom_ids[na] + 1),
            'strand_1': '+' if sa == 1 else '-',
            'position_1': int(end[na] if sa == 1 else start[na]),
            'chromosome_2': str(chrom_ids[nb] + 1),
            'strand_2': '+' if sb == 1 else '-',
            'position_2': int(end[nb] if sb == 1 else start[nb]),
        })
    breakpoint_data = pd.DataFrame(rows)
    return count_data, breakpoint_data


@pytest.fixture(scope='module')
def pipeline_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipeline')
    data = sim.simulate_experiment(
        N=50, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=5)
    count_data, breakpoint_data = make_tables(data)

    experiment = Experiment(count_data, breakpoint_data)
    experiment_filename = str(tmp / 'experiment.pickle')
    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)

    config = {
        'max_copy_number': 6,
        'num_em_iter': 1,
        'num_update_iter': 2,
        'likelihood_min_segment_length': 1.0,
        'likelihood_min_proportion_genotyped': 0.0,
        'divergence_weights': [1e-7],
        'tumour_mix_fractions': [0.4, 0.33],
        'engine_dtype': 'float64',
        'min_ploidy': 1.0,
        'max_ploidy': 8.0,
        # pin haploid depths (supported for poor samples — defaults.py:130-131);
        # mode detection needs more data than this tiny fixture provides
        'h_normal': 0.08,
        'h_tumour': 0.075,
    }

    init_filename = str(tmp / 'init.h5')
    init_params = pipeline.init(init_filename, experiment_filename, config)

    # limit restarts for test speed
    init_params = dict(list(init_params.items())[:2])

    fit_filenames = {}
    for init_id, params in init_params.items():
        results_filename = str(tmp / f'fit_{init_id}.pickle')
        pipeline.fit_task(results_filename, experiment_filename, params, config)
        fit_filenames[init_id] = results_filename

    collate_filename = str(tmp / 'results.h5')
    pipeline.collate(collate_filename, experiment_filename, init_filename,
                     fit_filenames, config)

    return dict(data=data, tmp=tmp, collate_filename=collate_filename,
                experiment=experiment, init_params=init_params)


def test_breakpoints_mapped(pipeline_run):
    experiment = pipeline_run['experiment']
    data = pipeline_run['data']
    # every simulated breakpoint should map to segment extremities
    assert len(experiment.breakpoints) == len(data['breakpoints'])


def test_init_enumerates_restarts(pipeline_run):
    init_params = pipeline_run['init_params']
    for params in init_params.values():
        assert params['h_normal'] > 0
        assert params['h_tumour'] > 0
        assert 'max_depth' in params


def test_results_schema(pipeline_run):
    """Results store must follow the reference schema
    (analysis/pipeline.py:231-293; README.md:131-143)."""
    with HDFStore(pipeline_run['collate_filename'], 'r') as store:
        keys = store.keys()
        assert '/stats' in keys
        assert '/cn' in keys
        assert '/mix' in keys
        assert '/brk_cn' in keys

        stats = store['stats']
        assert 'elbo' in stats.columns
        assert 'ploidy' in stats.columns
        assert 'proportion_divergent' in stats.columns
        assert 'init_id' in stats.columns

        cn = store['cn']
        for col in ['chromosome', 'start', 'end', 'length',
                    'major_1', 'minor_1', 'major_2', 'minor_2',
                    'major_raw', 'minor_raw',
                    'prob_is_outlier_total', 'total_likelihood_mask']:
            assert col in cn.columns, col

        mix = store['mix']
        np.testing.assert_allclose(mix.values.sum(), 1.0, rtol=1e-6)

        brk_cn = store['brk_cn']
        assert 'prediction_id' in brk_cn.columns
        if len(brk_cn.index):
            assert 'cn_1' in brk_cn.columns


def test_solution_quality(pipeline_run):
    """The selected solution should recover most of the dominant clone."""
    data = pipeline_run['data']
    with HDFStore(pipeline_run['collate_filename'], 'r') as store:
        cn = store['cn']
    dec = np.stack([
        np.stack([cn['major_1'].values, cn['minor_1'].values], axis=-1),
        np.stack([cn['major_2'].values, cn['minor_2'].values], axis=-1),
    ], axis=1)
    truth = data['cn'][:, 1:, :]
    exact = np.all(dec == truth, axis=(1, 2)) | np.all(dec == truth[:, :, ::-1], axis=(1, 2))
    # lenient: restart grid is trimmed to 2 and EM budget is tiny
    assert exact.mean() > 0.3, f'recovered {exact.mean()}'


def test_fit_many_batched_matches_sequential(tmp_path):
    """The chunked batched grid driver must reproduce the sequential
    one-restart-at-a-time driver: identical RNG streams per restart, so
    results agree to float64 numerics."""
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=9)
    count_data, breakpoint_data = make_tables(data)
    experiment = Experiment(count_data, breakpoint_data)
    experiment_filename = str(tmp_path / 'experiment.pickle')
    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)

    config = {
        'max_copy_number': 6,
        'num_em_iter': 2,
        'num_update_iter': 2,
        'engine_dtype': 'float64',
        'tumour_mix_fractions': [0.45, 0.2],
        'divergence_weights': [1e-6, 1e-8],
    }
    init_file = str(tmp_path / 'init.h5')
    init_params = pipeline.init(init_file, experiment_filename, config)
    assert len(init_params) >= 4

    seq = pipeline.fit_many(
        experiment, init_params, dict(config, batch_restarts=False))
    bat = pipeline.fit_many(
        experiment, init_params, dict(config, batch_restarts=True,
                                      restart_chunk_size=3))

    assert set(seq.keys()) == set(bat.keys())
    for init_id in seq:
        np.testing.assert_allclose(
            bat[init_id]['h'], seq[init_id]['h'], rtol=1e-7,
            err_msg='restart {}'.format(init_id))
        np.testing.assert_array_equal(
            bat[init_id]['cn'], seq[init_id]['cn'])
        np.testing.assert_allclose(
            bat[init_id]['stats']['elbo'], seq[init_id]['stats']['elbo'],
            rtol=1e-8)
        for bp_id, cn in seq[init_id]['brk_cn'].items():
            np.testing.assert_array_equal(bat[init_id]['brk_cn'][bp_id], cn)


def test_fit_many_device_mesh_matches_single_device(tmp_path):
    """The production fit path on the 8-device mesh (the default on any
    multi-device host) must reproduce the single-device batched driver:
    identical decoded copy number, posteriors/h to float64 reduction-order
    noise (shard_map compiles per-device extents, so bitwise equality is
    not expected)."""
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=11)
    count_data, breakpoint_data = make_tables(data)
    experiment = Experiment(count_data, breakpoint_data)

    config = {
        'max_copy_number': 6,
        'num_em_iter': 2,
        'num_update_iter': 2,
        'engine_dtype': 'float64',
        'tumour_mix_fractions': [0.45, 0.2],
        'divergence_weights': [1e-6, 1e-8],
    }
    init_file = str(tmp_path / 'init.h5')
    experiment_filename = str(tmp_path / 'experiment.pickle')
    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)
    init_params = pipeline.init(init_file, experiment_filename, config)

    single = pipeline.fit_many(
        experiment, init_params, dict(config, use_device_mesh=False))
    meshed = pipeline.fit_many(
        experiment, init_params, dict(config, use_device_mesh=True))

    import jax
    assert len(jax.devices()) == 8  # the mesh run really had devices to use

    # Each mesh device's program is compiled for its share of the wave, so
    # its float64 reductions run in another order than the single-device
    # wave's: after one EM iteration every restart's h agrees to 2.4e-12
    # relative. The second h search amplifies that at one restart, in a
    # minor clone's fraction where the likelihood is flat, to 9.9e-10
    # absolute (2.3e-7 relative on an h of 0.004), and its ELBO moves by
    # 1.1e-8 relative. h is held to 1e-8 absolute (1e-7 of the total
    # depth) and the ELBO to 1e-7 relative, ten times those readings.
    assert set(single.keys()) == set(meshed.keys())
    for init_id in single:
        np.testing.assert_array_equal(
            meshed[init_id]['cn'], single[init_id]['cn'],
            err_msg='restart {}'.format(init_id))
        np.testing.assert_allclose(
            meshed[init_id]['h'], single[init_id]['h'], rtol=0, atol=1e-8)
        np.testing.assert_allclose(
            meshed[init_id]['stats']['elbo'], single[init_id]['stats']['elbo'],
            rtol=1e-7)
        np.testing.assert_allclose(
            meshed[init_id]['p_outlier_total'],
            single[init_id]['p_outlier_total'], atol=1e-9)
        for bp_id, cn in single[init_id]['brk_cn'].items():
            np.testing.assert_array_equal(meshed[init_id]['brk_cn'][bp_id], cn)


def test_fit_many_cohort_matches_sequential(tmp_path):
    """Two samples fit concurrently on disjoint 4-device groups
    (fit_many_cohort, the production multi-tumour path) must reproduce sequential per-sample fit_many."""
    import jax

    assert len(jax.devices()) == 8

    config = {
        'max_copy_number': 6,
        'num_em_iter': 2,
        'num_update_iter': 2,
        'engine_dtype': 'float64',
        'tumour_mix_fractions': [0.45],
        'divergence_weights': [1e-6],
        'restart_chunk_size': 4,
    }

    experiments = {}
    init_params_dicts = {}
    for sid, seed in (('sampleA', 22), ('sampleB', 26)):
        data = sim.simulate_experiment(
            N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
            negbin_r=2000., betabin_M=2000., frac_genotyped=0.5,
            seed=seed)
        count_data, breakpoint_data = make_tables(data)
        experiments[sid] = Experiment(count_data, breakpoint_data)
        experiment_filename = str(tmp_path / f'experiment_{sid}.pickle')
        with open(experiment_filename, 'wb') as f:
            pickle.dump(experiments[sid], f)
        init_params_dicts[sid] = pipeline.init(
            str(tmp_path / f'init_{sid}.h5'), experiment_filename, config)

    cohort = pipeline.fit_many_cohort(experiments, init_params_dicts, config)

    assert set(cohort.keys()) == {'sampleA', 'sampleB'}
    for sid in experiments:
        seq = pipeline.fit_many(
            experiments[sid], init_params_dicts[sid],
            dict(config, use_device_mesh=False))
        assert set(cohort[sid].keys()) == set(seq.keys())
        for init_id in seq:
            np.testing.assert_array_equal(
                cohort[sid][init_id]['cn'], seq[init_id]['cn'],
                err_msg=f'{sid} restart {init_id}')
            # group meshes shard at different batch extents than the
            # single-device driver, so reductions reassociate (the same
            # ~1e-6 envelope the other mesh-equality tests allow)
            np.testing.assert_allclose(
                cohort[sid][init_id]['h'], seq[init_id]['h'], rtol=1e-5)
            np.testing.assert_allclose(
                cohort[sid][init_id]['stats']['elbo'],
                seq[init_id]['stats']['elbo'], rtol=1e-6)


def test_candidate_h_robust_normal_anchor():
    """A spurious low-mass depth cluster below the true normal mode must
    not poison every candidate: modes with negligible mass below them are
    also tried as normal anchors (measured on the low-tumour benchmark, where the reference's smallest-mode rule fails
    two of three replicates)."""
    import remixt_jax.analysis.readdepth as rd

    # true normal at 0.056, true tumour offset 0.024; spurious 1.3%-mass
    # cluster at 0.038 (the low_tumour_0_1 failure shape)
    modes = np.array([0.038, 0.056, 0.080, 0.104])
    masses = np.array([0.013, 0.35, 0.4, 0.237])

    cands = rd.calculate_candidate_h_monoclonal(
        modes, mode_masses=masses, normal_mass_tolerance=0.05)
    # both 0.038 (mass below 0) and 0.056 (mass below 0.013) anchor
    anchors = {round(float(h[0]), 3) for h in cands}
    assert anchors == {0.038, 0.056}
    # the true (h_normal, h_tumour) pair is among the candidates
    assert any(abs(h[0] - 0.056) < 1e-9 and abs(h[1] - 0.024) < 1e-9
               for h in cands)

    # tolerance 0 reproduces the reference's smallest-mode rule
    ref = rd.calculate_candidate_h_monoclonal(
        modes, mode_masses=masses, normal_mass_tolerance=0.0)
    assert {round(float(h[0]), 3) for h in ref} == {0.038}
    assert len(ref) == 6  # 3 higher modes x 2 scales, no dedup hits

    # near-duplicate candidates from different anchors merge
    dup_modes = np.array([0.056, 0.080])
    dup = rd.calculate_candidate_h_monoclonal(
        dup_modes, mode_masses=np.array([0.5, 0.5]),
        normal_mass_tolerance=0.05)
    assert len(dup) == 2  # (0.056, 0.024) and (0.056, 0.012) only


@pytest.mark.parametrize('elbo,prop,expected', [
    # highest ELBO among restarts under the divergence cut
    ([-5., -1., -3.], [0.1, 0.9, 0.2], 'c'),
    # none passes the cut: highest ELBO overall
    ([-5., -1., -3.], [0.9, 0.9, 0.9], 'b'),
    # ties go to the first restart; NaN ELBOs never win
    ([-2., -2., np.nan], [0.1, 0.1, 0.1], 'a'),
])
def test_optimal_init_id(elbo, prop, expected):
    assert pipeline.optimal_init_id(['a', 'b', 'c'], elbo, prop, 0.5) \
        == expected
