"""Batched restart-grid fitting: the whole grid as stacked pytrees.

The sequential driver (analysis/pipeline.fit_many) shares one compiled
engine but still runs restarts one at a time, each too small to fill the
device.  Here the grid fits in chunks of stacked restarts: every VI sweep
runs through the restart-batched scan (engine.variational_sweep_restarts)
and both EM updates through their vmapped fused forms.

Per-restart semantics match the sequential driver exactly: each restart
gets its own EM-subsample RNG stream seeded identically (the sequential
driver reseeds per fit), the divergence weight and h ride the traced
Params, and the full-data accept/reject guards apply per restart.
Reference analog: one 32 GB cluster job per restart
(/root/reference/remixt/workflow.py:318-340).
"""

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp

from remixt_jax.models import em as em_mod
from remixt_jax.models import engine as eng

logger = logging.getLogger('remixt_jax.fit_batched')


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _slice(tree, r):
    return jax.tree.map(lambda x: x[r], tree)


def _elbo_batched_fn(spec, mesh=None, use_shard_map=True):
    cache = spec._jit_cache
    key = ('elbo_b', mesh, use_shard_map)
    if key not in cache:
        # the dedicated restart-batched form: emission halves vmap, the
        # transition dots share one static-bank gather across restarts
        # (vmap(calculate_elbo) re-gathers per restart)
        f = functools.partial(eng.calculate_elbo_restarts, spec)
        if mesh is not None and use_shard_map:
            from remixt_jax.parallel import restarts as par
            f = par.shard_restart_fn(mesh, f, n_batched=2)
        cache[key] = jax.jit(f)
    return cache[key]


def _sweeps_batched_fn(spec, num_sweeps, mesh=None, use_shard_map=True):
    key = ('sweeps_b', num_sweeps, mesh, use_shard_map)
    cache = spec._jit_cache
    if key not in cache:
        f = functools.partial(
            eng.variational_sweeps_restarts, spec, num_sweeps=num_sweeps)
        if mesh is not None and use_shard_map:
            from remixt_jax.parallel import restarts as par
            f = par.shard_restart_fn(mesh, f, n_batched=2)
        cache[key] = jax.jit(f)
    return cache[key]


def fit_restarts_batched(model, h_inits, divergence_weights, chunk_size=8,
                         mesh=None):
    """Fit every restart of the grid in batched chunks on one model.

    Args:
        model: a BreakpointModel whose spec will be (re)used
        h_inits: list of (M,) h initializations, one per restart
        divergence_weights: matching list of divergence weights
        chunk_size: restarts fit simultaneously (memory-bound)
        mesh: optional device mesh with a ``restart`` axis; every sweep and
            EM update then shard_maps the restart batch over it, each
            device taking an even share of the wave, replacing the
            reference's one-cluster-job-per-restart fan-out
            (/root/reference/remixt/workflow.py:318-340) with SPMD over
            local devices. Restarts never interact, but each device's
            program is compiled for its share rather than the whole wave,
            so reductions run in another order: per-restart results agree
            with the single-device driver to rounding noise, which the EM
            iterations amplify (2.3e-7 relative in h in float64 on the
            CPU; on the GPU see chip_smoke.py's four-card bounds).

    Returns:
        list of per-restart dicts with params, state, elbo, elbo_diff.
    """
    num_restarts = len(h_inits)
    M = len(h_inits[0])
    if model.spec is None or getattr(model, '_spec_num_clones', None) != M:
        model.spec = model._build_spec(M)
        model._spec_num_clones = M
    spec = model.spec

    from remixt_jax.parallel import restarts as par

    mesh_extent = 1
    chain_extent = 1
    if mesh is not None:
        mesh_extent = mesh.shape.get('restart', 1)
        chain_extent = mesh.shape.get('chain', 1)
    if mesh_extent * chain_extent <= 1:
        mesh = None
        chain_extent = 1
    else:
        # chunks must split evenly over the restart devices; round the
        # chunk size up and pad the final partial chunk
        chunk_size = -(-max(chunk_size, mesh_extent) // mesh_extent) \
            * mesh_extent

    # With a grid smaller than the device count the mesh factors
    # restart × chain (analysis/pipeline._production_mesh): the chain
    # axis shards the batched chain scan via SPMD-partitioner
    # constraints rather than shard_map.
    use_shard_map = chain_extent == 1
    if not use_shard_map:
        from remixt_jax.parallel import chain as par_chain
        par_chain.enable_chain_sharding(spec, mesh)

    results = []
    for begin in range(0, num_restarts, chunk_size):
        chunk = list(range(begin, min(begin + chunk_size, num_restarts)))
        R = len(chunk)
        # EVERY chunk is padded to the full chunk size (repeating the last
        # restart; pads discarded below), so every dispatch runs the SAME
        # compiled program as chunk 1 and a partial tail chunk does not
        # recompile the whole EM stack.
        R_pad = chunk_size
        logger.info('fitting restarts %d-%d batched%s', chunk[0], chunk[-1],
                    ' on %d devices' % mesh.devices.size if mesh else '')

        params_b = _stack([
            spec.init_params(
                h_inits[r], divergence_weights[r],
                total_mask=model._total_likelihood_mask.astype(float),
                allele_mask=model._allele_likelihood_mask.astype(float))
            for r in chunk])
        state_b = _stack(
            [spec.init_state(model._init_p_breakpoint())] * R)

        # the sequential driver reseeds per restart, so every restart owns
        # an identical-seed independent stream (padded restarts repeat the
        # last real one so idx-array shapes match the padded batch)
        rngs = [np.random.RandomState(model.random_seed)
                for _ in range(R_pad)]

        if R_pad > R:
            params_b = par.pad_restarts(params_b, R_pad)
            state_b = par.pad_restarts(state_b, R_pad)
        if mesh is not None:
            params_b = par.shard_restarts(mesh, params_b)
            state_b = par.shard_restarts(mesh, state_b)

        sweeps_b = _sweeps_batched_fn(spec, model.num_update_iter, mesh,
                                      use_shard_map=use_shard_map)
        elbo_b = _elbo_batched_fn(spec, mesh, use_shard_map=use_shard_map)

        # elbo bookkeeping stays on device through the loop (each host
        # pull waits for the device); one conversion at the end
        prev_elbo = elbo_b(params_b, state_b)
        elbo_diff = None

        for _ in range(model.num_em_iter):
            state_b = sweeps_b(params_b, state_b)

            if model.do_h_update:
                params_b, _ = em_mod.update_h_fused_batched(
                    spec, params_b, state_b, rngs, mesh=mesh,
                    use_shard_map=use_shard_map)

            # weights computed on device for the whole chunk in ONE
            # dispatch and one (R, P, N) pull (bit-identical rows to the
            # sequential driver's per-restart calls, so the host RNG
            # draws match it exactly)
            weights_lists = em_mod.param_sample_weights_all_batched(
                spec, state_b, model.likelihood_params)
            params_b, _, elbo = em_mod.update_params_fused_batched(
                spec, params_b, state_b, tuple(model.likelihood_params),
                model.likelihood_param_bounds, rngs,
                weights_lists=weights_lists, mesh=mesh,
                use_shard_map=use_shard_map)

            elbo_diff = elbo - prev_elbo
            prev_elbo = elbo

        prev_elbo = np.asarray(prev_elbo, dtype=float)[:R]
        elbo_diff = (np.zeros(R) if elbo_diff is None
                     else np.asarray(elbo_diff, dtype=float)[:R])

        for i in range(R):
            results.append({
                'params': _slice(params_b, i),
                'state': _slice(state_b, i),
                'elbo': float(prev_elbo[i]),
                'elbo_diff': float(elbo_diff[i]),
            })
    return results
