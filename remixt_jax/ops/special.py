"""Special functions and log-space primitives for the engine.

Element-wise distribution log-likelihoods compile to fused lgamma/log
chains; all functions are shape-polymorphic, dtype-preserving and
safe under ``jax.grad`` (domain-violating lanes are double-``where``-guarded
so masked-out entries cannot poison gradients with NaNs).

Distribution formulas follow the reference (/root/reference/remixt/
bpmodel.pyx:238-394): negative binomial over total read counts, beta-binomial
over allelic read counts.
"""

import functools
import os

import jax
import jax.numpy as jnp


def _mm_precision(environ=os.environ):
    """Matmul precision for the semiring scans and bank contractions.

    ``HIGHEST`` (the default) runs float32 dots in full float32: on an
    NVIDIA Hopper card that is float32 FMA outside the tensor cores. Below
    it, XLA may run float32 dots on the tensor cores in TF32 (10-bit
    mantissa inputs), roughly 1e-3 relative error per product. Every
    checked-in accuracy number (ACCURACY.json,
    benchmark/ACCURACY_BENCH.json) was taken at ``HIGHEST``; a lower
    default needs the accuracy gates rerun on the card first. Override
    with ``REMIXT_MM_PRECISION={default,high,highest}``; the variable's
    name under the package's former name is refused rather than ignored.
    """
    stale = sorted(key for key in environ
                   if key.startswith('REMIXT_')
                   and key.endswith('_MM_PRECISION')
                   and key != 'REMIXT_MM_PRECISION')
    if stale:
        raise RuntimeError('{} is no longer read; set REMIXT_MM_PRECISION '
                           'instead'.format(stale[0]))
    name = environ.get('REMIXT_MM_PRECISION', 'highest').lower()
    return {
        'default': jax.lax.Precision.DEFAULT,
        'high': jax.lax.Precision.HIGH,
        'highest': jax.lax.Precision.HIGHEST,
    }[name]


MM_PRECISION = _mm_precision()

# Every contraction of the engine goes through these, so all of them run at
# MM_PRECISION: at XLA's default precision a float32 dot may run in TF32,
# which moved posteriors by up to 0.8 against the CPU after two sweeps of
# the whole-genome problem (H100, 400 W power limit).
einsum = functools.partial(jnp.einsum, precision=MM_PRECISION)
matmul = functools.partial(jnp.matmul, precision=MM_PRECISION)


def logsumexp(x, axis=-1, keepdims=False):
    """Max-shifted logsumexp; -inf-safe."""
    vmax = jnp.max(x, axis=axis, keepdims=True)
    vmax = jnp.where(jnp.isfinite(vmax), vmax, jnp.zeros_like(vmax))
    out = jnp.log(jnp.sum(jnp.exp(x - vmax), axis=axis, keepdims=True)) + vmax
    if not keepdims:
        out = jnp.squeeze(out, axis=axis)
    return out


def exp_normalize(x, axis=-1):
    """softmax with explicit renormalization (matches oracle exp_normalize)."""
    vmax = jnp.max(x, axis=axis, keepdims=True)
    y = jnp.exp(x - vmax)
    return y / jnp.sum(y, axis=axis, keepdims=True)


def plogp(p):
    """p*log(p) with 0 log 0 := 0."""
    safe = jnp.where(p > 0, p, 1.0)
    return jnp.where(p > 0, p * jnp.log(safe), 0.0)


def negbin_log_likelihood(x, mu, r):
    """Negative binomial log pmf, mean-overdispersion parameterization.

    nb_p outside [0, 1] clamps to 0.5 (reference bpmodel.pyx:261-264).
    """
    nb_p = mu / (r + mu)
    nb_p = jnp.where((nb_p < 0.0) | (nb_p > 1.0), 0.5, nb_p)
    return (jax.lax.lgamma(x + r) - jax.lax.lgamma(x + 1.0) - jax.lax.lgamma(r)
            + x * jnp.log(nb_p) + r * jnp.log1p(-nb_p))


def betabin_log_likelihood(k, n, p, M):
    """Beta-binomial log pmf; caller must supply p strictly inside (0, 1)."""
    Mp = M * p
    Mq = M * (1.0 - p)
    return (jax.lax.lgamma(n + 1.0) - jax.lax.lgamma(k + 1.0) - jax.lax.lgamma(n - k + 1.0)
            + jax.lax.lgamma(k + Mp) + jax.lax.lgamma(n - k + Mq)
            - jax.lax.lgamma(n + M)
            - jax.lax.lgamma(Mp) - jax.lax.lgamma(Mq)
            + jax.lax.lgamma(M))


# Stirling tail of log-gamma: lgamma(z) = (z - 1/2) log z - z
# + log(2 pi)/2 + _stirling_phi(z); three series terms leave a remainder
# < 1e-15 for z >= 256 (the lgamma_shift crossover).
def _stirling_phi(z):
    z2 = z * z
    return ((1.0 / 12.0) / z - (1.0 / 360.0) / (z * z2)
            + (1.0 / 1260.0) / (z * z2 * z2))


LGAMMA_SHIFT_MIN_N = 256.0


def lgamma_shift(n, a):
    """``lgamma(n + a) - lgamma(n + 1)``, cancellation-free for large n.

    Evaluating the two lgammas separately costs their ABSOLUTE float32
    rounding error: at n ~ 2e5 each value is ~2e6, so the difference —
    itself only O(a log n) — carries an O(0.1) error. That error is
    state-independent and cancels in the chain softmax, but it is
    component-dependent in the outlier updates (components differ in a),
    where it produced a persistent 5e-2 posterior error plateau
    (ACCURACY.json round 3). Rewriting via Stirling with the large terms
    combined ANALYTICALLY,

        (n + 1/2) log1p((a-1)/(n+1)) + (a-1) log(n+a) - (a-1)
            + phi(n+a) - phi(n+1),

    keeps every intermediate at O(a log n), for ~1e-4 absolute error.
    Below ``LGAMMA_SHIFT_MIN_N`` the plain difference is both accurate
    and exact-to-reference, so it is kept.
    """
    plain = jax.lax.lgamma(n + a) - jax.lax.lgamma(n + 1.0)
    n_safe = jnp.maximum(n, LGAMMA_SHIFT_MIN_N)  # keep the unused branch finite
    am1 = a - 1.0
    stable = ((n_safe + 0.5) * jnp.log1p(am1 / (n_safe + 1.0))
              + am1 * jnp.log(n_safe + a) - am1
              + _stirling_phi(n_safe + a) - _stirling_phi(n_safe + 1.0))
    return jnp.where(n >= LGAMMA_SHIFT_MIN_N, stable, plain)
