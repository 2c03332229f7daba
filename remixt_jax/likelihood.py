"""Read-count likelihood library: expected counts and distribution log-pmfs.

Functional capability parity with the reference likelihood module
(/root/reference/remixt/likelihood.py:31-1654): phi estimation, expected
read counts under a clone mixture, and the distribution family (Poisson,
negative binomial and its two-component mixture, binomial, beta-binomial
and its uniform-outlier mixture) with analytic partials.

Organized as pure functions rather than the reference's class hierarchy:
the production emission model lives in the fused engine kernels
(:func:`remixt_jax.models.engine.emission_tensors`) and its float64
reference in :mod:`remixt_jax.models.oracle`; this module serves the
host-side consumers — read-depth initialization, simulation count
emission, and plotting — plus anyone wanting the emission spec in plain
numpy.
"""

import numpy as np
from scipy.special import gammaln, digamma


class ProbabilityError(ValueError):
    def __init__(self, message, **variables):
        for name, value in variables.items():
            message += '\n{}={}'.format(name, value)
        super().__init__(message)


# ---------------------------------------------------------------------------
# expected read counts (reference likelihood.py:71-178)
# ---------------------------------------------------------------------------

#: rows = (allele a, allele b), columns = (a reads, b reads, total reads)
allele_measurement_matrix = np.array([[1, 0, 1], [0, 1, 1]])


def estimate_phi(x):
    """Proportion of genotypable reads per segment from the count matrix
    (major, minor, total)."""
    return x[:, 0:2].sum(axis=1).astype(float) / (x[:, 2].astype(float) + 1.0)


def proportion_measureable_matrix(phi):
    """(N, 3) per-measurement measurable proportions: phi for the allele
    measurements, 1 for the total."""
    return np.stack([phi, phi, np.ones_like(phi)], axis=1)


def expected_read_count(l, cn, h, phi):
    """mu[n, k] = l_n * phi-weighting * per-allele depth, for measurements
    k = (allele a, allele b, total)."""
    allele_depth = np.einsum('nma,m->na', cn, h)        # (N, 2)
    measurement_depth = allele_depth @ allele_measurement_matrix  # (N, 3)
    mu = measurement_depth * proportion_measureable_matrix(phi) * l[:, None]
    mu = mu + 1e-16

    bad = ~np.isfinite(mu) | (mu <= 0)
    if np.any(bad):
        n = int(np.where(bad.any(axis=1))[0][0])
        raise ProbabilityError('invalid mu', n=n, cn=cn[n], l=l[n], h=h,
                               phi=phi[n], mu=mu[n])
    return mu


def calculate_mean_cn(h, x, l):
    """Raw (depth-implied) per-allele copy number of each segment."""
    phi = estimate_phi(x)
    allele_depth = x[:, 0:2] / (phi * l)[:, None]
    return (allele_depth - h[0]) / h[1:].sum()


def calculate_mean_total_cn(h, x, l):
    """Raw (depth-implied) total copy number of each segment."""
    return (x[:, 2] / l - h[0]) / h[1:].sum()


# ---------------------------------------------------------------------------
# distribution log-pmfs (reference likelihood.py:452-1211)
# ---------------------------------------------------------------------------

def poisson_log_pmf(x, mu):
    mu = np.where(mu <= 0, 1.0, mu)
    return x * np.log(mu) - mu - gammaln(x + 1)


def poisson_partial_mu(x, mu):
    return x / mu - 1.0


def negbin_log_pmf(x, mu, r):
    """Negative binomial with mean mu and inverse-overdispersion r; the
    success probability clamps to 0.5 outside [0, 1] as the reference does."""
    p = mu / (r + mu)
    p = np.where((p < 0.0) | (p > 1.0), 0.5, p)
    return (gammaln(x + r) - gammaln(x + 1) - gammaln(r)
            + x * np.log(p) + r * np.log1p(-p))


def negbin_partial_mu(x, mu, r):
    return x / mu - (r + x) / (r + mu)


def negbin_partial_r(x, mu, r):
    return (digamma(x + r) - digamma(r) + np.log(r) + 1.0
            - np.log(r + mu) - r / (r + mu) - x / (r + mu))


def _mixture_log_pmf(ll_signal, ll_noise, z):
    return np.logaddexp(ll_signal + np.log1p(-z), ll_noise + np.log(z))


def _signal_weight(ll_signal, ll_noise, z):
    mixed = _mixture_log_pmf(ll_signal, ll_noise, z)
    return np.exp(ll_signal + np.log1p(-z) - mixed)


def negbin_mixture_log_pmf(x, mu, r, r_noise, z):
    """Negative binomial mixed with a high-variance noise negbin at
    weight z."""
    return _mixture_log_pmf(
        negbin_log_pmf(x, mu, r), negbin_log_pmf(x, mu, r_noise), z)


def negbin_mixture_partial_mu(x, mu, r, r_noise, z):
    w = _signal_weight(
        negbin_log_pmf(x, mu, r), negbin_log_pmf(x, mu, r_noise), z)
    return (w * negbin_partial_mu(x, mu, r)
            + (1.0 - w) * negbin_partial_mu(x, mu, r_noise))


def binomial_log_pmf(k, n, p):
    return (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
            + k * np.log(p) + (n - k) * np.log1p(-p))


def binomial_partial_p(k, n, p):
    return k / p - (n - k) / (1 - p)


def betabin_log_pmf(k, n, p, M):
    """Beta-binomial with mean fraction p and precision M."""
    a, b = M * p, M * (1 - p)
    return (gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
            + gammaln(k + a) + gammaln(n - k + b) - gammaln(n + M)
            + gammaln(M) - gammaln(a) - gammaln(b))


def betabin_partial_p(k, n, p, M):
    a, b = M * p, M * (1 - p)
    return M * (digamma(k + a) - digamma(n - k + b)
                - digamma(a) + digamma(b))


def betabin_partial_M(k, n, p, M):
    a, b = M * p, M * (1 - p)
    return (p * digamma(k + a) + (1 - p) * digamma(n - k + b)
            - digamma(n + M) + digamma(M)
            - p * digamma(a) - (1 - p) * digamma(b))


def betabin_uniform_log_pmf(k, n, p, M, z):
    """Beta-binomial mixed with a uniform outlier component at weight z."""
    return _mixture_log_pmf(betabin_log_pmf(k, n, p, M), -np.log(n + 1.0), z)


def betabin_uniform_partial_p(k, n, p, M, z):
    w = _signal_weight(betabin_log_pmf(k, n, p, M), -np.log(n + 1.0), z)
    return w * betabin_partial_p(k, n, p, M)


def betabin_uniform_partial_M(k, n, p, M, z):
    w = _signal_weight(betabin_log_pmf(k, n, p, M), -np.log(n + 1.0), z)
    return w * betabin_partial_M(k, n, p, M)
