"""Blocked two-pass forward-backward vs the serial scan.

The blocked path (ops/fb_blocked.py) is the intra-chain sequence-parallel
story: a single chain's position axis splits into blocks whose only
coupling is the (B, S, S) transfer-matrix stack.  These tests require
numerical equality (float64, 1e-9) with the serial scan for arbitrary
block counts, including blocks that don't divide the chain length, and
validate the device-sharded variant on the virtual 8-device mesh — a
single chain spanning all devices.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from remixt_jax.ops import fb_blocked, fb_scan
from helpers import build_chain_problem


def random_single_chain(seed, N, S=6, num_bank=4):
    rng = np.random.RandomState(seed)
    frame = jnp.asarray(-4.0 * rng.rand(N, S))
    bank = -3.0 * rng.rand(num_bank, S, S)
    bank[0] = 0.0
    bank_idx = jnp.asarray(rng.randint(num_bank, size=N - 1))
    return frame, jnp.asarray(bank), bank_idx


@pytest.mark.parametrize('N,B', [(24, 4), (23, 4), (17, 3), (30, 1), (9, 8)])
def test_blocked_matches_serial(N, B):
    frame, bank, bank_idx = random_single_chain(0, N)
    a_ref, b_ref, ln_ref = fb_scan.forward_backward(frame, bank, bank_idx)
    a, b, ln = fb_blocked.forward_backward_blocked(frame, bank, bank_idx, B)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), atol=1e-9)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_ref), atol=1e-9)
    np.testing.assert_allclose(float(ln), float(ln_ref), rtol=1e-12)


@pytest.mark.parametrize('B', [2, 4])
def test_chains_blocked_matches_chain_batched(B):
    """Alphas and log-norm agree exactly; betas agree up to the documented
    per-chain constant shift (fb_scan's pad steps run cut matrices past the
    chain end, adding a per-chain scalar that cancels in every normalized
    consumer — see fb_scan.forward_backward_chains docstring), so the
    posterior marginals must agree exactly."""
    problem = build_chain_problem(7, [19, 8, 3, 26], S=6, be_frac=0.3)
    frame = jnp.asarray(problem['framelogprob'])
    bank = jnp.asarray(problem['full_bank'])

    a_ref, b_ref, ln_ref = fb_scan.forward_backward_chains(
        frame, bank, problem['chain_bank_idx'], problem['chain_seg_map'],
        problem['chain_last'])
    a, b, ln = fb_blocked.forward_backward_chains_blocked(
        frame, bank, problem['chain_bank_idx'], problem['chain_seg_map'],
        problem['chain_last'], B)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), atol=1e-9)
    np.testing.assert_allclose(float(ln), float(ln_ref), rtol=1e-12)

    def marginals(alpha, beta):
        g = np.asarray(alpha + beta)
        g = g - g.max(axis=1, keepdims=True)
        p = np.exp(g)
        return p / p.sum(axis=1, keepdims=True)

    np.testing.assert_allclose(
        marginals(a, b), marginals(a_ref, b_ref), atol=1e-9)

    # betas differ only by a per-position-constant (per-chain) shift
    shift = np.asarray(b_ref - b)
    np.testing.assert_allclose(
        shift, shift[:, :1] * np.ones_like(shift), atol=1e-9)


def test_blocked_sharded_single_chain_spans_devices():
    """One chain of 64 positions sharded over all 8 devices by block."""
    devices = jax.devices()
    assert len(devices) == 8, 'conftest must provide the virtual 8-cpu mesh'
    mesh = Mesh(np.asarray(devices), ('block',))

    frame, bank, bank_idx = random_single_chain(3, 64, S=5)
    a_ref, b_ref, ln_ref = fb_scan.forward_backward(frame, bank, bank_idx)

    def constraint(arr, b_axis):
        spec = [None] * arr.ndim
        spec[b_axis] = 'block'
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, P(*spec)))

    @jax.jit
    def run(frame, bank, bank_idx):
        return fb_blocked.forward_backward_blocked(
            frame, bank, bank_idx, num_blocks=8,
            block_constraint=constraint)

    with mesh:
        a, b, ln = run(frame, bank, bank_idx)
    np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), atol=1e-9)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_ref), atol=1e-9)
    np.testing.assert_allclose(float(ln), float(ln_ref), rtol=1e-12)


def test_posteriors_from_blocked_are_normalized():
    frame, bank, bank_idx = random_single_chain(5, 40, S=7)
    a, b, _ = fb_blocked.forward_backward_blocked(frame, bank, bank_idx, 5)
    g = np.asarray(a + b)
    g = g - g.max(axis=1, keepdims=True)
    p = np.exp(g)
    p /= p.sum(axis=1, keepdims=True)
    assert np.all(np.isfinite(p))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-12)
