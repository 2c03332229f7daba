"""Restart fan-out across a device mesh.

The restart axis (the reference's ``init_id`` pypeliner fan-out,
workflow.py:318-340: depth modes × mixture fractions × divergence weights)
is embarrassingly parallel and maps onto a ``Mesh`` axis: every restart's
params/state pytree is stacked on a leading axis and sharded with
``NamedSharding(P('restart'))``. The model spec (data, state space, chain
structure) is identical across restarts and replicated by XLA.

This replaces the reference's one-32GB-job-per-restart cluster scheduling
with a single SPMD program per sweep.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from remixt_jax.models import engine as eng


def stack_pytrees(items):
    """Stack a list of identical-structure pytrees on a new leading axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *items)


def restart_sharding(mesh, pytree, axis='restart'):
    """NamedSharding pytree: leading axis over the restart mesh axis."""
    def leaf_sharding(leaf):
        spec = P(axis) if np.ndim(leaf) >= 1 else P()
        return NamedSharding(mesh, spec)
    return jax.tree.map(leaf_sharding, pytree)


def shard_restarts(mesh, pytree, axis='restart'):
    """Device-put a stacked restart pytree with restart-sharded leading axis."""
    return jax.device_put(pytree, restart_sharding(mesh, pytree, axis))


def make_restart_mesh(devices=None, axis='restart'):
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_restart_fn(mesh, fn, n_batched, n_replicated=0, axis='restart'):
    """shard_map a restart-batched function over the restart mesh axis.

    The first ``n_batched`` arguments are restart-stacked pytrees (sharded
    on their leading axis); the remaining ``n_replicated`` arguments are
    replicated. Every output is restart-stacked. Restarts are fully
    independent fits, so the body needs no collectives; shard_map (rather
    than relying on the SPMD partitioner) runs the single-device program,
    compiled for each device's share of the restarts, unmodified on every
    device. The smaller batch extent rounds reductions in another order,
    so per-restart results match single-device execution to rounding, not
    bit for bit.
    """
    in_specs = tuple([P(axis)] * n_batched + [P()] * n_replicated)
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=P(axis), check_vma=False)


def pad_restarts(pytree, total, axis=0):
    """Pad a restart-stacked pytree to ``total`` entries by repeating the
    last restart (device-count divisibility for sharding; padded entries
    are discarded by the caller)."""
    def pad_leaf(x):
        r = x.shape[axis]
        if r >= total:
            return x
        last = jnp.take(x, jnp.asarray([r - 1] * (total - r)), axis=axis)
        return jnp.concatenate([x, last], axis=axis)
    return jax.tree.map(pad_leaf, pytree)


def make_sharded_sweep(spec, mesh, axis='restart'):
    """Jitted restart-sharded variational sweep: (params_b, state_b) -> state_b.

    Uses the dedicated restart-batched sweep whose static-transition gather
    is shared across the restart axis (eng.variational_sweep_restarts); the
    SPMD partitioner shards the leading axis over ``mesh[axis]``.
    """
    return jax.jit(functools.partial(eng.variational_sweep_restarts, spec))


def make_sharded_train_step(spec, mesh, axis='restart', h_step=0.0):
    """Jitted full training step over the restart mesh: one variational sweep
    plus the EM h-statistics (expected log likelihood value and gradient).

    When ``h_step`` > 0 a projected gradient-ascent update is applied to h
    in-graph (used by the multichip dry run; the production fit uses the
    host-driven L-BFGS-B loop of :mod:`remixt_jax.models.em`).
    """
    sweep_v = jax.vmap(functools.partial(eng.variational_sweep, spec))

    def one_ell(params, state):
        def obj(h):
            return eng.expected_log_likelihood(spec, params._replace(h=h), state)
        return jax.value_and_grad(obj)(params.h)

    def step(params_b, state_b):
        state_b = sweep_v(params_b, state_b)
        ell, grad_h = jax.vmap(one_ell)(params_b, state_b)
        if h_step > 0.0:
            new_h = jnp.clip(params_b.h + h_step * grad_h, 1e-8, 10.0)
            params_b = params_b._replace(h=new_h)
        return params_b, state_b, ell

    return jax.jit(step)
