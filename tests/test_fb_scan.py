"""Chain-batched forward-backward (ops/fb_scan.py) vs a dense float64
numpy forward-backward.

``forward_backward_chains`` (one restart) and
``forward_backward_chains_restarts`` (a stacked restart axis with the
static gather shared and breakend matrices applied as scheduled per-lane
fix-ups) are the production chain update. The reference here walks each
chain alone with scipy's logsumexp over the pair's (S, S) bank matrix.

Cases cover a single chain without breakends, uneven chain lengths
including a singleton chain, breakend-heavy chains, several breakends on
the same step in different chains (more than one fix-up per step), and
many chains.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from remixt_jax.ops import fb_scan

from helpers import build_chain_problem, dense_chain_forward_backward


SCENARIOS = {
    'single_chain_no_breakends': dict(seed=0, chain_lengths=[12], be_frac=0.0),
    'multi_chain_uneven': dict(seed=1, chain_lengths=[9, 4, 13, 1]),
    'breakend_heavy': dict(seed=2, chain_lengths=[16, 10], be_frac=0.8),
    'same_step_breakends_across_lanes': dict(
        seed=3, chain_lengths=[8, 8, 8, 8], be_frac=0.9),
    'many_chains': dict(
        seed=4, chain_lengths=[5, 3, 7, 2, 6, 4, 8, 1, 5, 2], be_frac=0.3),
}


def _marginals(alphas, betas):
    g = np.asarray(alphas) + np.asarray(betas)
    g = g - g.max(axis=-1, keepdims=True)
    p = np.exp(g)
    return p / p.sum(axis=-1, keepdims=True)


def _assert_matches_dense(problem, alphas, betas, log_norm, full_bank):
    a_ref, b_ref, ln_ref = dense_chain_forward_backward(
        problem['framelogprob'], full_bank, problem['chain_bank_idx'],
        problem['chain_seg_map'], problem['chain_last'])
    alphas, betas = np.asarray(alphas), np.asarray(betas)
    np.testing.assert_allclose(alphas, a_ref, atol=1e-9, rtol=1e-12)
    np.testing.assert_allclose(float(log_norm), ln_ref, rtol=1e-12)
    # the scan runs a chain's pad steps through the zero cut matrix, which
    # shifts that chain's betas by one constant; every normalized consumer
    # cancels it
    shift = b_ref - betas
    np.testing.assert_allclose(shift, shift[:, :1] * np.ones_like(shift),
                               atol=1e-9)
    np.testing.assert_allclose(_marginals(alphas, betas),
                               _marginals(a_ref, b_ref), atol=1e-12)


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_chains_match_dense_reference(name):
    problem = build_chain_problem(**SCENARIOS[name])
    if name == 'single_chain_no_breakends':
        assert problem['num_breakends'] == 0
    if name == 'breakend_heavy':
        assert problem['num_breakends'] > 10
    alphas, betas, log_norm = fb_scan.forward_backward_chains(
        jnp.asarray(problem['framelogprob']),
        jnp.asarray(problem['full_bank']),
        jnp.asarray(problem['chain_bank_idx']),
        jnp.asarray(problem['chain_seg_map']),
        jnp.asarray(problem['chain_last']))
    _assert_matches_dense(problem, alphas, betas, log_norm,
                          problem['full_bank'])


@pytest.mark.parametrize('name', sorted(SCENARIOS))
def test_restarts_match_dense_reference(name):
    """R=3 restarts, each with its own frame and breakend matrices."""
    R = 3
    problem = build_chain_problem(**SCENARIOS[name])
    rng = np.random.RandomState(100 + problem['N'])
    N, S = problem['framelogprob'].shape
    J = problem['num_breakends']
    frame_b = -5.0 * rng.rand(R, N, S)
    be_bank_b = -3.0 * rng.rand(R, J, S, S)
    num_static = problem['static_bank'].shape[0]
    plan = fb_scan.build_restart_plan(problem['chain_bank_idx'], num_static)

    alphas, betas, log_norm = fb_scan.forward_backward_chains_restarts(
        jnp.asarray(frame_b), jnp.asarray(problem['static_bank']),
        jnp.asarray(be_bank_b), plan, problem['chain_seg_map'],
        jnp.asarray(problem['chain_last']))
    assert alphas.shape == (R, N, S) and log_norm.shape == (R,)
    for r in range(R):
        problem_r = dict(problem, framelogprob=frame_b[r])
        full_bank_r = np.concatenate(
            [problem['static_bank'], be_bank_b[r]], axis=0)
        _assert_matches_dense(problem_r, alphas[r], betas[r], log_norm[r],
                              full_bank_r)


def test_restart_plan_schedules_same_step_breakends():
    """Breakends on the same step in different chains each get a fix-up
    slot (kmax > 1); breakend pairs fall back to the cut class in the
    shared static plane."""
    problem = build_chain_problem(**SCENARIOS['same_step_breakends_across_lanes'])
    num_static = problem['static_bank'].shape[0]
    plan = fb_scan.build_restart_plan(problem['chain_bank_idx'], num_static)
    idx = problem['chain_bank_idx']
    is_be = idx >= num_static
    assert plan['kmax'] == is_be.sum(axis=0).max() > 1
    assert np.all(plan['static_idx'][is_be] == 0)
    np.testing.assert_array_equal(plan['static_idx'][~is_be], idx[~is_be])
    for t in range(idx.shape[1]):
        lanes = plan['sched_lane'][t]
        real = lanes >= 0
        np.testing.assert_array_equal(lanes[real], np.flatnonzero(is_be[:, t]))
        np.testing.assert_array_equal(
            plan['sched_slot'][t][real], idx[lanes[real], t] - num_static)
