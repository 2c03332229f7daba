"""End-to-end fit tests on simulated ground-truth experiments.

Follows the reference integration-test pattern (test_remixt.py:297-339
test_learn_h_variational: fit on a simulated experiment, evaluate recovery)
with the ELBO-monotonicity guard enabled throughout.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from remixt_jax.models.fit import BreakpointModel, decode_breakpoints_naive
from remixt_jax.simulations import simple as sim


def cn_matches(cn, truth):
    exact = np.all(cn[:, 1:, :] == truth[:, 1:, :], axis=(1, 2))
    flipped = np.all(cn[:, 1:, :] == truth[:, 1:, ::-1], axis=(1, 2))
    return exact | flipped


def make_model(data, **kwargs):
    defaults = dict(
        max_copy_number=6,
        max_depth=1e9,
        min_segment_length=0.0,
        min_proportion_genotyped=0.0,
        divergence_weight=1e-7,
        dtype=jnp.float64,
        random_seed=1234,
    )
    defaults.update(kwargs)
    return BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        **defaults)


@pytest.fixture(scope='module')
def sim_data():
    return sim.simulate_experiment(N=60, M=3, h=(0.08, 0.05, 0.025),
                                   cn_max=6, negbin_r=2000., betabin_M=2000.,
                                   frac_genotyped=0.5, seed=11)


def test_fit_recovers_cn_and_h(sim_data):
    data = sim_data
    model = make_model(data)
    model.num_em_iter = 2
    model.num_update_iter = 3
    model.check_elbo = True  # raises if any update decreases the ELBO

    # modest perturbation: finding the right basin from far-off inits is the
    # restart layer's job (analysis/pipeline.py init machinery), not EM's
    h_init = data['h'] * np.array([1.05, 0.95, 1.02])
    model.fit(h_init)

    # h recovery
    np.testing.assert_allclose(model.h, data['h'], rtol=0.15)

    cn, brk_cn = model.optimal_cn()
    assert cn.shape == data['cn'].shape

    # copy number recovery (length-weighted proportion of correct tumour
    # states, allowing the global allele-flip the state space is deduplicated
    # under — the reference evaluation has the same tolerance,
    # simulations/pipeline.py:575-647). The weakest clone sits at ~1 sigma
    # per copy step in this noise regime, so exact-subclonal recovery is
    # bounded; the dominant clone must be essentially perfect.
    correct = cn_matches(cn, data['cn'])
    prop_correct = (correct * data['l']).sum() / data['l'].sum()
    assert prop_correct > 0.6, f'proportion correct {prop_correct}'

    dom = (np.all(cn[:, 1, :] == data['cn'][:, 1, :], axis=1)
           | np.all(cn[:, 1, :] == data['cn'][:, 1, ::-1], axis=1))
    prop_dom = (dom * data['l']).sum() / data['l'].sum()
    assert prop_dom > 0.9, f'proportion dominant correct {prop_dom}'

    # elbo improved over the fit
    assert model.prev_elbo_diff is not None


def test_fit_with_breakpoints_disabled(sim_data):
    data = sim_data
    model = make_model(data, disable_breakpoints=True)
    model.num_em_iter = 1
    model.num_update_iter = 2
    model.fit(np.asarray(data['h']))

    cn, brk_cn = model.optimal_cn()
    assert brk_cn == {}

    brk_cn = decode_breakpoints_naive(cn, data['adjacencies'], data['breakpoints'])
    assert set(brk_cn.keys()) == set(data['breakpoints'].keys())
    for cn_b in brk_cn.values():
        assert cn_b.shape == (3,)


def test_fit_no_breakpoints_at_all():
    data = sim.simulate_experiment(N=30, M=2, h=(0.08, 0.05), seed=3)
    model = make_model(dict(data, breakpoints={}))
    model.num_em_iter = 1
    model.num_update_iter = 2
    model.fit(np.asarray(data['h']))
    cn, brk_cn = model.optimal_cn()
    assert cn.shape[0] == 30


def test_breakpoint_copy_number_recovery(sim_data):
    """Breakpoints at real changepoints should get nonzero copy number."""
    data = sim_data
    model = make_model(data)
    model.num_em_iter = 1
    model.num_update_iter = 3
    model.fit(np.asarray(data['h']))

    cn, brk_cn = model.optimal_cn()

    # simulation records the true per-clone breakpoint copy number
    n_correct = 0
    n_total = 0
    for bp_id, truth in data['brk_cn'].items():
        pred = brk_cn[bp_id]
        n_total += 1
        if np.all(pred[1:] == truth[1:]):
            n_correct += 1
    assert n_correct / n_total > 0.5, f'{n_correct}/{n_total} breakpoints correct'


def test_snapshot_resume_identical(sim_data, tmp_path):
    """A fit killed after EM iteration 1 and resumed from its snapshot must
    reach results identical to an uninterrupted fit (the host RNG state
    rides the snapshot). Reference analog: cn_model.py:286-307
    _write_model/_read_model."""
    data = sim_data
    h_init = data['h'] * np.array([1.05, 0.95, 1.02])

    # uninterrupted reference run: 3 EM iterations
    model_ref = make_model(data)
    model_ref.num_em_iter = 3
    model_ref.num_update_iter = 2
    model_ref.fit(h_init)
    cn_ref, brk_ref = model_ref.optimal_cn()

    # "killed" run: only 1 EM iteration completes, snapshot written
    snapshot = str(tmp_path / 'fit.ckpt')
    model_a = make_model(data)
    model_a.num_em_iter = 1
    model_a.num_update_iter = 2
    model_a.fit(h_init, snapshot_filename=snapshot)
    assert (tmp_path / 'fit.ckpt').exists()

    # fresh process stand-in: a new model resumes from the snapshot and
    # finishes the remaining iterations
    model_b = make_model(data)
    model_b.num_em_iter = 3
    model_b.num_update_iter = 2
    model_b.fit(h_init, snapshot_filename=snapshot)

    np.testing.assert_allclose(model_b.h, model_ref.h, rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(model_b.state.posterior_marginals),
        np.asarray(model_ref.state.posterior_marginals))
    assert model_b.prev_elbo == model_ref.prev_elbo
    cn_b, brk_b = model_b.optimal_cn()
    np.testing.assert_array_equal(cn_b, cn_ref)
    assert set(brk_b.keys()) == set(brk_ref.keys())
    for k in brk_b:
        np.testing.assert_array_equal(brk_b[k], brk_ref[k])


def test_h_update_paths_agree(sim_data):
    """The fused in-graph backtracking h update and the scipy L-BFGS-B path
    must land on equivalent optima (same subsample objective; both guarded
    by the full-data accept/reject)."""
    from remixt_jax.models import em as em_mod

    data = sim_data
    model = make_model(data)
    model.num_em_iter = 1
    model.num_update_iter = 2
    h_init = data['h'] * np.array([1.1, 0.9, 1.05])
    model.fit(h_init)

    spec, params, state = model.spec, model.params, model.state
    full = np.ones(spec.N)

    params_lbfgs, _ = em_mod.update_h(
        spec, params, state, np.random.RandomState(7))
    params_fused, _ = em_mod.update_h_fused(
        spec, params, state, np.random.RandomState(7))

    ell = lambda p: float(spec.expected_log_likelihood(
        p, state, np.asarray(full, dtype=np.float64)))
    ell_before = ell(params)
    ell_lbfgs = ell(params_lbfgs)
    ell_fused = ell(params_fused)

    # both improve (or hold) the full-data objective...
    assert ell_lbfgs >= ell_before
    assert ell_fused >= ell_before
    # ...and agree on the achieved objective and the h location
    gap = abs(ell_lbfgs - ell_before) + abs(ell_fused - ell_before) + 1e-9
    assert abs(ell_fused - ell_lbfgs) < 0.2 * gap + 1e-6, (
        ell_before, ell_lbfgs, ell_fused)
    np.testing.assert_allclose(
        np.asarray(params_fused.h), np.asarray(params_lbfgs.h), rtol=0.05)


def test_param_sample_weights_all_matches_per_name(sim_data):
    """The one-call device weight stack must reproduce the per-name host
    computation (cn_model.py:309-352 semantics): the M-step subsample
    draws consume these through the host RNG, so any drift changes the
    fit trajectory."""
    from remixt_jax.models import em as em_mod

    data = sim_data
    model = make_model(data)
    model.num_em_iter = 1
    model.num_update_iter = 2
    model.fit(data['h'])

    spec, state = model.spec, model.state
    names = model.likelihood_params
    stacked = em_mod.param_sample_weights_all(spec, state, names)
    assert len(stacked) == len(names)
    for name, got in zip(names, stacked):
        want = em_mod.param_sample_weights(spec, state, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300,
                                       err_msg=name)

    # the restart-batched stack must be BIT-identical per row to the
    # per-slice calls: the host RNG consumes these weights, so any
    # reassociation would silently fork batched from sequential fits
    state_b = jax.tree.map(lambda x: jnp.stack([x, x]), state)
    batched = em_mod.param_sample_weights_all_batched(spec, state_b, names)
    assert len(batched) == 2
    for rows in batched:
        for name, got, want in zip(names, rows, stacked):
            if want is None:
                assert got is None, name
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_batched_chunks_padded_to_uniform_shape():
    """Every batched chunk (including the grid's tail) dispatches at the
    full chunk size with pad restarts repeating the last real one, and
    per-restart results are identical to an unpadded single-chunk fit.
    The uniform shape is what lets every chunk reuse chunk 1's compiled
    program and is the guard against the grouped kernel's shape-specific
    device faults (docs/DESIGN.md: R=10 bench / R=4 tail-chunk faults)."""
    from remixt_jax.models.fit_batched import fit_restarts_batched

    data = sim.simulate_experiment(
        N=36, M=3, h=(0.08, 0.05, 0.025), cn_max=2, num_events=4,
        num_chains=2, seed=5)

    def build():
        m = BreakpointModel(
            data['x'], data['l'], data['adjacencies'], data['breakpoints'],
            max_copy_number=2, max_depth=1e9, min_segment_length=1.0,
            min_proportion_genotyped=0.0, divergence_weight=1e-7,
            dtype=jnp.float64, random_seed=1234)
        m.num_em_iter = 2
        m.num_update_iter = 2
        return m

    R = 5
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    dws = [1e-7] * R

    # chunks of 3: [3 real, 3 with 1 pad]; vs one unpadded chunk of 5
    chunked = fit_restarts_batched(build(), h_inits, dws, chunk_size=3)
    whole = fit_restarts_batched(build(), h_inits, dws, chunk_size=5)
    assert len(chunked) == R and len(whole) == R
    for i in range(R):
        np.testing.assert_allclose(
            np.asarray(chunked[i]['params'].h),
            np.asarray(whole[i]['params'].h), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(chunked[i]['state'].posterior_marginals),
            np.asarray(whole[i]['state'].posterior_marginals), atol=1e-12)
        np.testing.assert_allclose(chunked[i]['elbo'], whole[i]['elbo'],
                                   rtol=1e-12)
