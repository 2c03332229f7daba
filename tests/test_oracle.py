"""Validate the float64 numpy oracle against brute-force enumeration.

Mirrors the reference's naive-vs-optimized test pattern
(/root/reference/remixt/tests/test_model.py:58-93: naive_norm_const /
naive_posterior_marginal by full sequence enumeration) and its
ELBO-monotonicity-per-update invariant (test_model.py:392-399).
"""

import numpy as np
import pytest

from remixt_jax.models import oracle as oracle_mod
from helpers import make_oracle, make_problem, brute_force_chain


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('num_breakpoints', [0, 1])
def test_sum_product_matches_brute_force(seed, num_breakpoints):
    model = make_oracle(seed=seed, N=5, M=2, cn_max=2, num_breakpoints=num_breakpoints)
    model.update_p_cn()

    log_norm, marginals, joints, _ = brute_force_chain(
        np.asarray(model.framelogprob), np.asarray(model.log_transmat))

    assert np.isclose(model.hmm_log_norm_const, log_norm, rtol=1e-10)
    np.testing.assert_allclose(model.posterior_marginals, marginals, atol=1e-10)
    np.testing.assert_allclose(model.joint_posterior_marginals, joints, atol=1e-10)


@pytest.mark.parametrize('seed', [3, 4])
def test_max_product_matches_brute_force(seed):
    model = make_oracle(seed=seed, N=5, M=2, cn_max=2)
    model.update_p_cn()

    _, _, _, best_seq = brute_force_chain(
        np.asarray(model.framelogprob), np.asarray(model.log_transmat))
    seq, logprob = oracle_mod.max_product(model.framelogprob, model.log_transmat)

    # compare log probability of decoded sequences (ties may differ)
    def seq_lp(s):
        lp = model.framelogprob[0, s[0]]
        for n in range(1, len(s)):
            lp += model.log_transmat[n - 1, s[n - 1], s[n]] + model.framelogprob[n, s[n]]
        return lp

    assert np.isclose(seq_lp(seq), seq_lp(best_seq), rtol=1e-12)


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('kwargs', [
    dict(M=2, cn_max=2, num_breakpoints=1),
    dict(M=3, cn_max=2, num_breakpoints=2, N=8),
    dict(M=2, cn_max=2, num_breakpoints=1, normal_contamination=False),
])
def test_elbo_monotone_per_update(seed, kwargs):
    model = make_oracle(seed=seed, **kwargs)

    updates = [
        model.update_p_allele_swap,
        model.update_p_cn,
        model.update_p_breakpoint,
        model.update_p_outlier_total,
        model.update_p_outlier_allele,
    ]

    # first chain update must happen before the ELBO is meaningful
    model.update_p_cn()
    elbo = model.calculate_elbo()
    for sweep in range(3):
        for update in updates:
            update()
            new_elbo = model.calculate_elbo()
            assert new_elbo - elbo > -1e-6, \
                f'elbo decreased in {update.__name__} sweep {sweep}: {elbo} -> {new_elbo}'
            elbo = new_elbo


def test_partial_h_matches_numeric():
    model = make_oracle(seed=7, N=6, M=3, cn_max=2, num_breakpoints=1)
    model.update_p_cn()

    sample = np.ones(model.num_segments)
    analytic = model.calculate_expected_log_likelihood_partial_h(sample)

    eps = 1e-7
    numeric = np.zeros_like(analytic)
    for m in range(model.num_clones):
        h0 = model.h.copy()
        hp = h0.copy(); hp[m] += eps
        hm = h0.copy(); hm[m] -= eps
        model.h = hp
        f_plus = model.calculate_expected_log_likelihood(sample)
        model.h = hm
        f_minus = model.calculate_expected_log_likelihood(sample)
        model.h = h0
        numeric[m] = (f_plus - f_minus) / (2 * eps)

    np.testing.assert_allclose(analytic, numeric, rtol=1e-5, atol=1e-5)


def test_transition_model_step():
    kwargs = make_problem(seed=2, N=5, M=2, cn_max=2, num_breakpoints=1)
    model = oracle_mod.OracleModel(**kwargs)
    model.transition_model = 1
    model.cached_log_transmat = model.calculate_log_transmat()
    model.update_p_cn()

    log_norm, marginals, _, _ = brute_force_chain(
        np.asarray(model.framelogprob), np.asarray(model.log_transmat))
    assert np.isclose(model.hmm_log_norm_const, log_norm, rtol=1e-10)
    np.testing.assert_allclose(model.posterior_marginals, marginals, atol=1e-10)


def test_telomere_transitions_free():
    kwargs = make_problem(seed=5, N=6, M=2, cn_max=2, num_breakpoints=0)
    kwargs['is_telomere'] = np.array([0, 0, 1, 0, 0, 0])
    model = oracle_mod.OracleModel(**kwargs)
    log_transmat = model.calculate_log_transmat()
    np.testing.assert_array_equal(log_transmat[2], 0.0)
    assert np.any(log_transmat[0] != 0.0)
