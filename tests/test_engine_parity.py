"""JAX engine vs float64 numpy oracle: field-by-field numerical parity.

The engine must reproduce the oracle (and hence the reference semantics) to
near machine precision in float64. This is the core numerical gate for the
engine (posterior max-abs-diff).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from remixt_jax.models.oracle import OracleModel
from remixt_jax.models import engine as eng
from helpers import make_problem


def build_pair(seed=0, **kwargs):
    prob = make_problem(seed=seed, **kwargs)
    oracle = OracleModel(**prob)
    spec = eng.ModelSpec(
        cn_states=prob['cn_states'],
        brk_states=prob['brk_states'],
        l=prob['l'], x=prob['x'], y=prob['y'],
        is_telomere=prob['is_telomere'],
        breakpoint_idx=prob['breakpoint_idx'],
        breakpoint_orient=prob['breakpoint_orient'],
        transition_penalty=prob['transition_penalty'],
        normal_contamination=prob['normal_contamination'],
        dtype=jnp.float64,
    )
    params = spec.init_params(prob['h_init'], prob['divergence_weight'])
    state = spec.init_state()
    return oracle, spec, params, state


CASES = [
    dict(N=12, M=2, cn_max=2, num_breakpoints=2),
    dict(N=10, M=3, cn_max=2, num_breakpoints=1),
    dict(N=12, M=2, cn_max=3, num_breakpoints=0),
    dict(N=10, M=2, cn_max=2, num_breakpoints=2, normal_contamination=False),
    dict(N=14, M=2, cn_max=2, num_breakpoints=2, num_telomeres=3),
]


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('seed', [0, 1])
def test_initial_elbo_matches(case, seed):
    oracle, spec, params, state = build_pair(seed=seed, **case)
    np.testing.assert_allclose(
        float(spec.elbo(params, state)), oracle.calculate_elbo(), rtol=1e-10)


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('seed', [0, 1])
def test_sweeps_match(case, seed):
    oracle, spec, params, state = build_pair(seed=seed, **case)

    for sweep in range(3):
        oracle.update_p_allele_swap()
        oracle.update_p_cn()
        oracle.update_p_breakpoint()
        oracle.update_p_outlier_total()
        oracle.update_p_outlier_allele()
        state = spec.sweep(params, state)

        np.testing.assert_allclose(
            np.asarray(state.posterior_marginals), oracle.posterior_marginals,
            atol=1e-9, err_msg=f'marginals sweep {sweep}')
        np.testing.assert_allclose(
            np.asarray(state.p_allele_swap), oracle.p_allele_swap, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(state.p_outlier_total), oracle.p_outlier_total, atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(state.p_outlier_allele), oracle.p_outlier_allele, atol=1e-9)
        if spec.K > 0:
            np.testing.assert_allclose(
                np.asarray(state.p_breakpoint), oracle.p_breakpoint, atol=1e-9)
        np.testing.assert_allclose(
            float(state.hmm_log_norm_const), oracle.hmm_log_norm_const, rtol=1e-10)
        np.testing.assert_allclose(
            float(spec.elbo(params, state)), oracle.calculate_elbo(), rtol=1e-9,
            err_msg=f'elbo sweep {sweep}')


@pytest.mark.parametrize('case', CASES[:2])
def test_expected_log_likelihood_and_grad(case):
    oracle, spec, params, state = build_pair(seed=3, **case)
    oracle.update_p_allele_swap()
    oracle.update_p_cn()
    oracle.update_p_breakpoint()
    oracle.update_p_outlier_total()
    oracle.update_p_outlier_allele()
    state = spec.sweep(params, state)

    rng = np.random.RandomState(0)
    sample = (rng.rand(spec.N) < 0.7).astype(float)

    ell = float(spec.expected_log_likelihood(params, state, jnp.asarray(sample)))
    np.testing.assert_allclose(ell, oracle.calculate_expected_log_likelihood(sample),
                               rtol=1e-10)

    val, grad = spec.expected_log_likelihood_and_grad_h(params, state, jnp.asarray(sample))
    np.testing.assert_allclose(float(val), ell, rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(grad), oracle.calculate_expected_log_likelihood_partial_h(sample),
        rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize('case', CASES)
def test_viterbi_matches(case):
    oracle, spec, params, state = build_pair(seed=4, **case)
    for _ in range(2):
        oracle.update_p_allele_swap()
        oracle.update_p_cn()
        oracle.update_p_breakpoint()
        oracle.update_p_outlier_total()
        oracle.update_p_outlier_allele()
        state = spec.sweep(params, state)

    cn, seq_oracle = oracle.infer_cn()
    seq_engine, logprob = spec.decode(params, state)
    np.testing.assert_array_equal(np.asarray(seq_engine), seq_oracle)
