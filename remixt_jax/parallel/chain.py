"""Chain-axis sharding: the sequence-parallel analogue.

The genome chain factorizes exactly at telomere junctions
(ops/fb_scan.forward_backward_chains), so the batched chain axis (Q
chromosomes/chains) shards across a mesh axis with no communication inside
the forward-backward scan; only the small cross-chain reductions (total log
normalizer, breakpoint-state updates coupling breakends on different
chains, EM sufficient statistics) become XLA collectives inserted by the
SPMD partitioner.

Combined with the restart axis (parallel/restarts.py, via
``jax.vmap(..., spmd_axis_name='restart')``) this gives the 2D
(restart × chain) mesh — the framework's dp × sp layout.
"""

import functools

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from remixt_jax.models import engine as eng


def enable_chain_sharding(spec, mesh, axis='chain'):
    """Install a chain-axis sharding constraint on a ModelSpec.

    Subsequent jitted engine calls lay out the batched chain scan over
    ``mesh[axis]``. Call with ``mesh=None`` to disable.
    """
    if mesh is None:
        spec.chain_constraint = None
        return spec

    def constrain(arr, q_axis):
        pspec = [None] * arr.ndim
        pspec[q_axis] = axis
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, P(*pspec)))

    spec.chain_constraint = constrain
    return spec


def enable_block_sharding(spec, mesh, num_blocks, axis='block'):
    """Install intra-chain blocked scanning on a ModelSpec.

    Every chain's position axis splits into ``num_blocks`` blocks
    (ops/fb_blocked.py) and, when a mesh is given, the block axis is
    sharded over ``mesh[axis]`` — a single chromosome then spans devices,
    with only the (Q, B, S, S) transfer-matrix stack crossing the mesh.
    Call with ``mesh=None`` to keep the blocking but drop the constraint,
    or ``num_blocks=1`` to restore the plain chain-batched scan.
    """
    spec.num_chain_blocks = num_blocks
    if mesh is None or num_blocks <= 1:
        spec.block_constraint = None
        return spec

    def constrain(arr, b_axis):
        pspec = [None] * arr.ndim
        pspec[b_axis] = axis
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(mesh, P(*pspec)))

    spec.block_constraint = constrain
    return spec


def make_2d_train_step(spec, mesh, restart_axis='restart',
                       chain_axis='chain', h_step=0.0):
    """Jitted training step over a 2D (restart × chain) mesh.

    Restarts vmap with ``spmd_axis_name`` so the leading batch axis shards
    over the restart mesh axis; chain constraints inside the scan shard the
    chain axis. Returns (params_b, state_b, ell) like
    parallel.restarts.make_sharded_train_step.
    """
    import jax.numpy as jnp

    enable_chain_sharding(spec, mesh, axis=chain_axis)

    sweep_v = jax.vmap(functools.partial(eng.variational_sweep, spec),
                       spmd_axis_name=restart_axis)

    def one_ell(params, state):
        def obj(h):
            return eng.expected_log_likelihood(
                spec, params._replace(h=h), state)
        return jax.value_and_grad(obj)(params.h)

    ell_v = jax.vmap(one_ell, spmd_axis_name=restart_axis)

    def step(params_b, state_b):
        state_b = sweep_v(params_b, state_b)
        ell, grad_h = ell_v(params_b, state_b)
        if h_step > 0.0:
            new_h = jnp.clip(params_b.h + h_step * grad_h, 1e-8, 10.0)
            params_b = params_b._replace(h=new_h)
        return params_b, state_b, ell

    return jax.jit(step)
