"""Distribution log-pmfs and analytic partials.

The reference pattern (test_likelihood.py: distribution checks plus
assert_grad_correct numeric differentiation) applied to the functional
likelihood library: log-pmfs validated against scipy.stats, partials
validated by central differences.
"""

import numpy as np
import pytest
import scipy.stats

from remixt_jax import likelihood as lik


RNG = np.random.RandomState(0)
X = RNG.poisson(50, size=20).astype(float)
N_TRIALS = X + RNG.poisson(30, size=20)
MU = 40.0 + 20.0 * RNG.rand(20)
P = np.clip(RNG.rand(20), 0.1, 0.9)


def central_diff(f, x, eps=None):
    # step scaled to the argument magnitude for stable differences
    eps = 1e-6 * max(1.0, float(np.max(np.abs(x)))) if eps is None else eps
    return (f(x + eps) - f(x - eps)) / (2 * eps)


def test_poisson_log_pmf_matches_scipy():
    np.testing.assert_allclose(
        lik.poisson_log_pmf(X, MU),
        scipy.stats.poisson.logpmf(X, MU), rtol=1e-10)


def test_negbin_log_pmf_matches_scipy():
    r = 100.0
    # scipy parameterization: n=r, p = r/(r+mu)
    np.testing.assert_allclose(
        lik.negbin_log_pmf(X, MU, r),
        scipy.stats.nbinom.logpmf(X, r, r / (r + MU)), rtol=1e-10)


def test_betabin_log_pmf_matches_scipy():
    M = 200.0
    np.testing.assert_allclose(
        lik.betabin_log_pmf(X, N_TRIALS, P, M),
        scipy.stats.betabinom.logpmf(X, N_TRIALS, M * P, M * (1 - P)),
        rtol=1e-9)


def test_binomial_log_pmf_matches_scipy():
    np.testing.assert_allclose(
        lik.binomial_log_pmf(X, N_TRIALS, P),
        scipy.stats.binom.logpmf(X, N_TRIALS, P), rtol=1e-9)


@pytest.mark.parametrize('partial,wrt', [
    (lik.poisson_partial_mu, 'mu'),
    (lik.negbin_partial_mu, 'mu'),
    (lik.negbin_partial_r, 'r'),
])
def test_total_count_partials(partial, wrt):
    r = 80.0
    if partial is lik.poisson_partial_mu:
        analytic = partial(X, MU)
        numeric = central_diff(lambda m: lik.poisson_log_pmf(X, m), MU)
    elif wrt == 'mu':
        analytic = partial(X, MU, r)
        numeric = central_diff(lambda m: lik.negbin_log_pmf(X, m, r), MU)
    else:
        analytic = partial(X, MU, r)
        numeric = central_diff(lambda rr: lik.negbin_log_pmf(X, MU, rr), r)
    np.testing.assert_allclose(analytic, numeric, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize('partial,wrt', [
    (lik.betabin_partial_p, 'p'),
    (lik.betabin_partial_M, 'M'),
    (lik.betabin_uniform_partial_p, 'p'),
    (lik.betabin_uniform_partial_M, 'M'),
])
def test_allele_partials(partial, wrt):
    M, z = 150.0, 0.02
    uniform = partial in (lik.betabin_uniform_partial_p,
                          lik.betabin_uniform_partial_M)

    def pmf(p=P, m=M):
        if uniform:
            return lik.betabin_uniform_log_pmf(X, N_TRIALS, p, m, z)
        return lik.betabin_log_pmf(X, N_TRIALS, p, m)

    args = (X, N_TRIALS, P, M, z) if uniform else (X, N_TRIALS, P, M)
    analytic = partial(*args)
    if wrt == 'p':
        numeric = central_diff(lambda p: pmf(p=p), P)
    else:
        numeric = central_diff(lambda m: pmf(m=m), M)
    np.testing.assert_allclose(analytic, numeric, rtol=1e-5, atol=1e-7)


def test_mixture_pmfs_normalize_against_components():
    """Mixture pmf must sit between its components and approach them at
    z -> 0 / z -> 1."""
    r0, r1 = 500.0, 10.0
    lo = lik.negbin_mixture_log_pmf(X, MU, r0, r1, 1e-12)
    np.testing.assert_allclose(lo, lik.negbin_log_pmf(X, MU, r0), rtol=1e-6)
    hi = lik.negbin_mixture_log_pmf(X, MU, r0, r1, 1.0 - 1e-12)
    np.testing.assert_allclose(hi, lik.negbin_log_pmf(X, MU, r1), rtol=1e-6)


def test_expected_read_count_shapes_and_guards():
    N, M = 10, 3
    cn = np.ones((N, M, 2))
    h = np.array([0.1, 0.05, 0.02])
    l = np.full(N, 1e6)
    phi = np.full(N, 0.1)
    mu = lik.expected_read_count(l, cn, h, phi)
    assert mu.shape == (N, 3)
    # total = sum over clones of h * total copies * l
    np.testing.assert_allclose(mu[:, 2], 2 * h.sum() * 1e6, rtol=1e-9)
    # allele measurements scaled by phi
    np.testing.assert_allclose(mu[:, 0], 0.1 * h.sum() * 1e6, rtol=1e-9)

    with pytest.raises(lik.ProbabilityError):
        lik.expected_read_count(l, cn, np.array([np.nan, 0.05, 0.02]), phi)


def test_lgamma_shift_f32_accuracy():
    """ops.special.lgamma_shift must evaluate lgamma(n+a) - lgamma(n+1) in
    float32 with absolute error orders of magnitude below the plain f32
    difference at large n (whose O(0.1) component-dependent rounding caused
    the round-3 outlier-posterior plateau — see ACCURACY.json / DESIGN.md)."""
    import jax.numpy as jnp
    from scipy.special import gammaln
    from remixt_jax.ops.special import lgamma_shift, LGAMMA_SHIFT_MIN_N

    n = np.concatenate([
        np.array([0.0, 1.0, 5.0, 100.0, 255.0, 256.0, 257.0]),
        np.logspace(2.5, 6.3, 40)])
    # a spans the likelihood-parameter bounds (r/M grids reach 2000)
    for a in (0.05, 0.9, 1.0, 7.3, 120.0, 900.0, 2000.0):
        exact = gammaln(n + a) - gammaln(n + 1.0)
        got = np.asarray(lgamma_shift(
            jnp.asarray(n, jnp.float32), jnp.float32(a)), dtype=float)
        assert got.dtype == np.float64 and np.all(np.isfinite(got))
        # bound: eps-level RELATIVE error of the result itself (the
        # point of the rewrite: error scales with |shift|, not with
        # |lgamma| ~ 2e6 as the plain difference's does) plus a small
        # absolute floor
        bound = 1e-3 + 4e-7 * np.abs(exact)
        err = np.abs(got - exact)
        assert np.all(err < bound), (a, float(err.max()))


@pytest.mark.parametrize('environ,expected', [
    ({}, 'HIGHEST'),
    ({'REMIXT_MM_PRECISION': 'high'}, 'HIGH'),
    ({'REMIXT_MM_PRECISION': 'Default'}, 'DEFAULT'),
    # a precision override under a former package prefix is refused, not
    # silently ignored
    ({'REMIXT_OLD_MM_PRECISION': 'default'}, None),
])
def test_mm_precision_override(environ, expected):
    import jax
    from remixt_jax.ops.special import _mm_precision

    if expected is None:
        with pytest.raises(RuntimeError, match='REMIXT_MM_PRECISION'):
            _mm_precision(environ)
    else:
        assert _mm_precision(environ) == getattr(jax.lax.Precision, expected)
