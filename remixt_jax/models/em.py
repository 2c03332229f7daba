"""EM parameter updates (M-step drivers).

Re-designs the reference's optimizer layer (/root/reference/remixt/
cn_model.py:462-569) for a device that runs batched, jitted calls:

* The haploid-depth update keeps L-BFGS-B semantics (few iterations over an
  M-dimensional box) but the objective/gradient is a single jitted
  ``jax.value_and_grad`` call — the hand-derived partials of
  bpmodel.pyx:1159-1195 are replaced by exact autodiff of the same
  expectation.

* Scalar likelihood-parameter updates replace ``scipy.optimize.brute``'s
  serial grid + simplex polish with batched grid refinement: each zoom level
  evaluates all candidate values in ONE vmapped device call, so the whole
  grid search costs a few kernel launches.

Both keep the reference's stochastic-subsample objectives and its
reject-on-worse guard against noisy steps (cn_model.py:526-531, 563-569).
"""

import functools

import numpy as np
import scipy.optimize
import jax
import jax.numpy as jnp

from remixt_jax.models import engine as eng


# grid-search refinement schedule: (points per level, zoom levels)
GRID_POINTS = 20
GRID_LEVELS = 3


def sample_size_for(num_segments):
    return max(int(min(200, num_segments / 10)), 1)


def create_sample_indices(rng, num_segments, weights=None):
    """Random segment subsample as a fixed-size index array
    (cn_model.py:475-480); same RNG consumption as create_sample."""
    return rng.choice(num_segments, size=sample_size_for(num_segments),
                      replace=False, p=weights)


def create_sample(rng, num_segments, weights=None):
    """Random segment subsample indicator (cn_model.py:475-480)."""
    sample = np.zeros(num_segments)
    sample[create_sample_indices(rng, num_segments, weights)] = 1.0
    return sample


def update_h(spec, params, state, rng, h_bounds=(1e-8, 10.0)):
    """One EM update of haploid read depths (cn_model.py:482-531).

    Returns possibly-updated params.
    """
    M = int(np.asarray(params.h).shape[0])
    sample = jnp.asarray(create_sample(rng, spec.N), dtype=spec.dtype)
    full = jnp.ones(spec.N, dtype=spec.dtype)

    vg = spec.expected_log_likelihood_and_grad_h

    def objective(h):
        val, grad = vg(params._replace(h=jnp.asarray(h, dtype=spec.dtype)), state, sample)
        return -float(val), -np.asarray(grad, dtype=np.float64)

    h_before = np.asarray(params.h, dtype=np.float64)
    ell_before = float(spec.expected_log_likelihood(params, state, full))

    result = scipy.optimize.minimize(
        objective, h_before, method='L-BFGS-B', jac=True,
        bounds=[h_bounds] * M)

    if not result.success:
        # In float32 the objective is only precise to ~1e-7 relative, so the
        # line search often terminates abnormally near the optimum (the
        # reference tolerates exactly this failure mode and gradient-checks,
        # cn_model.py:510-521). The full-data accept/reject below guards
        # against a genuinely bad step either way.
        import logging
        logging.getLogger('remixt_jax.em').info(
            'h optimization inexact termination: %s', result.message)

    candidate = params._replace(h=jnp.asarray(result.x, dtype=spec.dtype))
    ell_after = float(spec.expected_log_likelihood(candidate, state, full))

    # reject steps that hurt the full-data objective (subsample noise guard)
    if ell_after < ell_before:
        return params, False
    return candidate, True


def _param_grid_fn(spec, name):
    """Jitted batched objective over a vector of candidate values for one
    scalar likelihood parameter."""
    cache = spec._jit_cache
    key = ('param_grid', name)
    if key not in cache:
        def f(params, state, sample, values):
            def one(v):
                return eng.expected_log_likelihood(
                    spec, params._replace(**{name: v}), state, sample)
            return jax.vmap(one)(values)
        import functools
        cache[key] = jax.jit(functools.partial(f))
    return cache[key]


def update_param(spec, params, state, name, bounds, rng, weights=None):
    """One EM update of a scalar likelihood parameter via batched grid zoom
    (replaces scipy.optimize.brute — cn_model.py:533-569).

    Returns possibly-updated params.
    """
    sample = jnp.asarray(create_sample(rng, spec.N, weights), dtype=spec.dtype)
    full = jnp.ones(spec.N, dtype=spec.dtype)
    grid_fn = _param_grid_fn(spec, name)

    lo, hi = float(bounds[0]), float(bounds[1])
    best = float(getattr(params, name))
    for _ in range(GRID_LEVELS):
        values = np.linspace(lo, hi, GRID_POINTS)
        objs = np.asarray(grid_fn(params, state,  sample,
                                  jnp.asarray(values, dtype=spec.dtype)))
        i = int(np.argmax(objs))
        best = float(values[i])
        step = (hi - lo) / (GRID_POINTS - 1)
        lo = max(float(bounds[0]), best - step)
        hi = min(float(bounds[1]), best + step)

    ell_before = float(spec.expected_log_likelihood(params, state, full))
    candidate = params._replace(**{name: jnp.asarray(best, dtype=spec.dtype)})
    ell_after = float(spec.expected_log_likelihood(candidate, state, full))

    if ell_after < ell_before:
        return params, False
    return candidate, True


def _make_h_update(spec):
    """The raw in-graph h update: backtracking gradient ascent on the
    subsample objective plus the full-data accept/reject.

    Replaces the host-driven L-BFGS-B loop (tens of blocking device
    round-trips per EM iteration) with one device call; the
    reject-on-worse guard (cn_model.py:526-531) is preserved.
    """
    import functools

    n_outer = 12
    n_scales = 8

    def f(params, state, idx, full):
        def obj(h):
            return eng.expected_log_likelihood_indexed(
                spec, params._replace(h=h), state, idx)

        def outer(carry, _):
            h, rel_step = carry
            val, g = jax.value_and_grad(obj)(h)
            gnorm = jnp.linalg.norm(g) + 1e-12
            hnorm = jnp.linalg.norm(h) + 1e-12
            scales = rel_step * (0.5 ** jnp.arange(n_scales, dtype=h.dtype))

            def try_scale(s):
                h_new = jnp.clip(h + s * (hnorm / gnorm) * g, 1e-8, 10.0)
                return h_new, obj(h_new)

            # all backtracking scales in ONE vmap: the objective runs on
            # the ~200-segment subsample, so the 8-way batch is ~27 MB of
            # transients — serializing it in scan groups (a leftover from
            # when candidate evaluations were full-genome passes) only
            # lengthened the in-graph critical path
            cands, vals = jax.vmap(try_scale)(scales)
            best = jnp.argmax(vals)
            improved = vals[best] > val
            h_next = jnp.where(improved, cands[best], h)
            step_next = jnp.where(improved,
                                  jnp.minimum(scales[best] * 2.0, 1.0),
                                  rel_step * (0.5 ** n_scales))
            return (h_next, step_next), None

        rel0 = jnp.asarray(0.25, dtype=params.h.dtype)
        # named scopes label the HLO for profiler attribution
        # (tools/fit_budget.py --trace)
        with jax.named_scope('em_h_search'):
            (h_fin, _), _ = jax.lax.scan(outer, (params.h, rel0), None,
                                         length=n_outer)

        def obj_full(h):
            return eng.expected_log_likelihood(
                spec, params._replace(h=h), state, full)

        with jax.named_scope('em_h_full_guard'):
            accept = obj_full(h_fin) >= obj_full(params.h)
            h_out = jnp.where(accept, h_fin, params.h)
        return params._replace(h=h_out), accept

    return f


def _h_update_fn(spec):
    """Jitted single-restart h update."""
    cache = spec._jit_cache
    if 'h_update' not in cache:
        cache['h_update'] = jax.jit(_make_h_update(spec))
    return cache['h_update']


def _h_update_batched_fn(spec, mesh=None, use_shard_map=True):
    """Jitted restart-batched h update: params/state/sample batched, the
    full-data indicator shared. With a mesh, the batch shard_maps over the
    restart axis (parallel/restarts.shard_restart_fn); on a
    restart × chain mesh the caller passes ``use_shard_map=False`` and
    the SPMD partitioner lays the batch out instead."""
    cache = spec._jit_cache
    key = ('h_update_b', mesh, use_shard_map)
    if key not in cache:
        f = jax.vmap(_make_h_update(spec), in_axes=(0, 0, 0, None))
        if mesh is not None and use_shard_map:
            from remixt_jax.parallel import restarts as par
            f = par.shard_restart_fn(mesh, f, n_batched=3, n_replicated=1)
        cache[key] = jax.jit(f)
    return cache[key]


def update_h_fused(spec, params, state, rng):
    """Single-dispatch EM h update.

    Returns the accept flag as a device scalar — converting it here
    would force a host round trip per EM iteration; callers that want
    to log it pay the sync themselves."""
    idx = jnp.asarray(create_sample_indices(rng, spec.N), dtype=jnp.int32)
    full = jnp.ones(spec.N, dtype=spec.dtype)
    params, accept = _h_update_fn(spec)(params, state, idx, full)
    return params, accept


# which emission components each scalar parameter touches: half 'total'
# components are the outlier planes u ∈ {0, 1}; half 'allele' components
# are k = v·2 + w ∈ {0..3}. Accept/reject recomputes ONLY these planes —
# the untouched components' contractions are unchanged by construction
# and cancel from the comparison (cn_model.py:563-569 semantics at a
# fraction of the lgamma cost).
PARAM_COMPONENTS = {
    'negbin_r_0': ('total', (0,)),
    'negbin_r_1': ('total', (1,)),
    'negbin_hdel_mu': ('total', (0, 1)),
    'negbin_hdel_r_0': ('total', (0,)),
    'negbin_hdel_r_1': ('total', (1,)),
    'betabin_M_0': ('allele', (0, 1)),
    'betabin_M_1': ('allele', (2, 3)),
    'betabin_loh_p': ('allele', (0, 1, 2, 3)),
    'betabin_loh_M_0': ('allele', (0, 1)),
    'betabin_loh_M_1': ('allele', (2, 3)),
}


def _make_params_update(spec, names, bounds):
    """The raw in-graph update of all scalar likelihood parameters:
    per-parameter 3-level batched grid zoom on its subsample plus full-data
    accept/reject, sequentially in-graph (brute-replacement,
    cn_model.py:533-569). The full-data guard tracks per-COMPONENT running
    contractions and re-evaluates only the emission planes the parameter
    touches (PARAM_COMPONENTS)."""
    levels = GRID_LEVELS
    points = GRID_POINTS
    grid01 = jnp.linspace(0.0, 1.0, points)

    def f(params, state, sample_idxs):
        running = {}
        # named scopes label the HLO for profiler attribution
        # (tools/fit_budget.py --trace)
        with jax.named_scope('em_running_components'):
            for half, n_comp in (('total', 2), ('allele', 4)):
                vals = eng.expected_log_likelihood_components(
                    spec, params, state, half, tuple(range(n_comp)))
                for c, v in zip(range(n_comp), vals):
                    running[(half, c)] = v
        accepts = []
        for i, name in enumerate(names):
            lo_c, hi_c = bounds[name]
            sub_idx = sample_idxs[i]
            half, comps = PARAM_COMPONENTS[name]

            def level(carry, _, name=name, lo_c=lo_c, hi_c=hi_c,
                      sub_idx=sub_idx, params=params):
                lo, hi, best = carry
                values = lo + (hi - lo) * grid01.astype(spec.dtype)

                def one(v):
                    return eng.expected_log_likelihood_indexed(
                        spec, params._replace(**{name: v}), state, sub_idx)

                # whole level in one vmap: the objective is the ~200-
                # segment SUBSAMPLE (indexed) evaluation, so all 20
                # candidates are ~35 MB of transients per restart — the
                # 4-way chunking predates the indexed objective, when a
                # level's candidates were full-genome (N, S) passes
                objs = jax.vmap(one)(values)
                winner = jnp.argmax(objs)
                best = values[winner]
                step = (hi - lo) / (points - 1)
                lo = jnp.maximum(jnp.asarray(lo_c, spec.dtype), best - step)
                hi = jnp.minimum(jnp.asarray(hi_c, spec.dtype), best + step)
                return (lo, hi, best), None

            init = (jnp.asarray(lo_c, spec.dtype),
                    jnp.asarray(hi_c, spec.dtype),
                    getattr(params, name))
            with jax.named_scope('em_grid_zoom'):
                (_, _, best), _ = jax.lax.scan(level, init, None,
                                               length=levels)

            with jax.named_scope('em_candidate_guard'):
                cand_vals = eng.expected_log_likelihood_components(
                    spec, params._replace(**{name: best}), state, half, comps)
                cand_sum = sum(cand_vals)
                run_sum = sum(running[(half, c)] for c in comps)
                accept = cand_sum >= run_sum
                new_val = jnp.where(accept, best, getattr(params, name))
                params = params._replace(**{name: new_val})
                for c, v in zip(comps, cand_vals):
                    running[(half, c)] = jnp.where(
                        accept, v, running[(half, c)])
            accepts.append(accept)
        # the running components sum to exactly the ELBO's two emission
        # contractions for the final params — returning the halves lets
        # the caller assemble the iteration's ELBO for just the cost of
        # the state-only terms, with no separate full-emission dispatch
        halves = (running[('total', 0)] + running[('total', 1)],
                  running[('allele', 0)] + running[('allele', 1)]
                  + running[('allele', 2)] + running[('allele', 3)])
        return params, jnp.stack(accepts), halves

    return f


def _params_update_fn(spec, names, bounds):
    """Jitted single-restart likelihood-parameter update."""
    cache = spec._jit_cache
    key = ('params_update', names)
    if key not in cache:
        core = _make_params_update(spec, names, bounds)

        def f(params, state, sample_idxs):
            params, accepts, (tot_half, alle_half) = core(
                params, state, sample_idxs)
            with jax.named_scope('em_elbo_assembly'):
                elbo = eng.calculate_elbo_from_halves(
                    spec, params, state, tot_half, alle_half)
            return params, accepts, elbo

        cache[key] = jax.jit(f)
    return cache[key]


def _params_update_batched_fn(spec, names, bounds, mesh=None,
                              use_shard_map=True):
    """Jitted restart-batched likelihood-parameter update:
    params/state/samples batched per restart. With a mesh, the batch
    shard_maps over the restart axis.

    The grid zoom and accept/reject vmap per restart; the ELBO assembly
    runs through the shared-gather batched form OUTSIDE the vmap —
    vmapping it re-gathers two (S, S) bank matrices per pair per restart."""
    cache = spec._jit_cache
    key = ('params_update_b', names, mesh, use_shard_map)
    if key not in cache:
        core_b = jax.vmap(_make_params_update(spec, names, bounds))

        def f(params_b, state_b, sample_idxs_b):
            params_b, accepts_b, (tot_b, alle_b) = core_b(
                params_b, state_b, sample_idxs_b)
            with jax.named_scope('em_elbo_assembly'):
                elbo_b = eng.calculate_elbo_from_halves_restarts(
                    spec, params_b, state_b, tot_b, alle_b)
            return params_b, accepts_b, elbo_b

        if mesh is not None and use_shard_map:
            from remixt_jax.parallel import restarts as par
            f = par.shard_restart_fn(mesh, f, n_batched=3)
        cache[key] = jax.jit(f)
    return cache[key]


def update_params_fused(spec, params, state, names, bounds, rng,
                        weights_list=None):
    """Single-dispatch EM update of all scalar likelihood parameters."""
    idxs = np.stack([
        create_sample_indices(
            rng, spec.N, None if weights_list is None else weights_list[i])
        for i in range(len(names))])
    params, accepts, elbo = _params_update_fn(spec, tuple(names), bounds)(
        params, state, jnp.asarray(idxs, dtype=jnp.int32))
    # accepts/elbo stay on device; pulling them costs a host round trip
    # per EM iteration, so callers that want them pay the sync
    return params, accepts, elbo


def update_h_fused_batched(spec, params_b, state_b, rngs, mesh=None,
                           use_shard_map=True):
    """Restart-batched EM h update; one independent subsample per restart
    (matching the sequential driver's per-restart RNG streams)."""
    idxs = jnp.asarray(
        np.stack([create_sample_indices(rng, spec.N) for rng in rngs]),
        dtype=jnp.int32)
    full = jnp.ones(spec.N, dtype=spec.dtype)
    params_b, accepts = _h_update_batched_fn(
        spec, mesh, use_shard_map=use_shard_map)(
        params_b, state_b, idxs, full)
    # accepts stays on device (see update_h_fused)
    return params_b, accepts


def update_params_fused_batched(spec, params_b, state_b, names, bounds, rngs,
                                weights_lists=None, mesh=None,
                                use_shard_map=True):
    """Restart-batched EM update of all scalar likelihood parameters.

    ``weights_lists[r][i]`` are restart r's posterior-responsibility
    sampling weights for parameter i (param_sample_weights on that
    restart's state).
    """
    k = sample_size_for(spec.N)
    idxs = np.empty((len(rngs), len(names), k), dtype=np.int32)
    for r, rng in enumerate(rngs):
        for i in range(len(names)):
            weights = (None if weights_lists is None
                       else weights_lists[r][i])
            idxs[r, i] = create_sample_indices(rng, spec.N, weights)
    params_b, accepts, elbo_b = _params_update_batched_fn(
        spec, tuple(names), bounds, mesh, use_shard_map=use_shard_map)(
        params_b, state_b, jnp.asarray(idxs))
    # accepts/elbo stay on device (see update_params_fused)
    return params_b, accepts, elbo_b


def _param_weights_all_fn(spec, names):
    """Jitted (P, N) stack of unnormalized sampling weights, one row per
    parameter name, computed on device from the posterior state."""
    cache = spec._jit_cache
    key = ('param_weights_all', names)
    if key not in cache:
        def f(spec, state):
            marg = state.posterior_marginals
            pot = state.p_outlier_total
            poa = state.p_outlier_allele
            hdel = jnp.sum(
                marg * jnp.asarray(spec.is_hdel_plane, marg.dtype), axis=-1)
            loh = jnp.sum(
                marg * jnp.asarray(spec.is_loh_plane, marg.dtype), axis=-1)
            table = {
                'negbin_r_0': pot[:, 0],
                'negbin_r_1': pot[:, 1],
                'betabin_M_0': poa[:, 0],
                'betabin_M_1': poa[:, 1],
                'negbin_hdel_mu': hdel,
                'negbin_hdel_r_0': hdel * pot[:, 0],
                'negbin_hdel_r_1': hdel * pot[:, 1],
                'betabin_loh_p': loh,
                'betabin_loh_M_0': loh * poa[:, 0],
                'betabin_loh_M_1': loh * poa[:, 1],
            }
            return jnp.stack([table[n] for n in names])
        cache[key] = jax.jit(functools.partial(f, spec))
    return cache[key]


def param_sample_weights_all(spec, state, names):
    """All parameters' posterior-responsibility sampling weights
    (param_sample_weights semantics) in one device call and one small
    host pull.

    The per-name host path re-pulled the (N, S) posterior marginals for
    every parameter. Both the
    sequential and the restart-batched drivers must use this same
    jitted computation: the subsample draws consume the weights through
    the host RNG, so bit-identical weights keep batched == sequential.
    """
    w = np.asarray(_param_weights_all_fn(spec, tuple(names))(state),
                   dtype=np.float64)
    return _normalize_weight_rows(w)


def _normalize_weight_rows(w):
    out = []
    for row in w:
        norm = row.sum()
        out.append(row / norm if norm > 0.0 else None)
    return out


def _param_weights_all_batched_fn(spec, names):
    cache = spec._jit_cache
    key = ('param_weights_all_b', names)
    if key not in cache:
        cache[key] = jax.jit(jax.vmap(_param_weights_all_fn(spec, names)))
    return cache[key]


def param_sample_weights_all_batched(spec, state_b, names):
    """Restart-batched param_sample_weights_all: one device dispatch and
    one (R, P, N) host pull for the whole chunk instead of R sequential
    dispatch+pull round trips.

    The per-restart math is elementwise with a last-axis reduction, so
    the vmapped rows are bit-identical to per-slice calls and the host
    RNG subsample draws stay bit-identical to the sequential driver.

    Returns a list of R weight lists (one per restart).
    """
    w_b = np.asarray(_param_weights_all_batched_fn(spec, tuple(names))(
        state_b), dtype=np.float64)
    return [_normalize_weight_rows(w) for w in w_b]


def param_sample_weights(spec, state, name):
    """Posterior-responsibility sampling weights per parameter
    (cn_model.py:309-352)."""
    marg = np.asarray(state.posterior_marginals)
    p_out_tot = np.asarray(state.p_outlier_total)
    p_out_alle = np.asarray(state.p_outlier_allele)

    def hdel_weights():
        mask = np.asarray(spec.is_hdel_plane)
        return (marg * mask).sum(axis=-1)

    def loh_weights():
        mask = np.asarray(spec.is_loh_plane)
        return (marg * mask).sum(axis=-1)

    if name == 'negbin_r_0':
        weights = p_out_tot[:, 0]
    elif name == 'negbin_r_1':
        weights = p_out_tot[:, 1]
    elif name == 'betabin_M_0':
        weights = p_out_alle[:, 0]
    elif name == 'betabin_M_1':
        weights = p_out_alle[:, 1]
    elif name == 'negbin_hdel_mu':
        weights = hdel_weights()
    elif name == 'negbin_hdel_r_0':
        weights = hdel_weights() * p_out_tot[:, 0]
    elif name == 'negbin_hdel_r_1':
        weights = hdel_weights() * p_out_tot[:, 1]
    elif name == 'betabin_loh_p':
        weights = loh_weights()
    elif name == 'betabin_loh_M_0':
        weights = loh_weights() * p_out_alle[:, 0]
    elif name == 'betabin_loh_M_1':
        weights = loh_weights() * p_out_alle[:, 1]
    else:
        raise ValueError('unknown parameter ' + name)

    norm = weights.sum()
    if norm > 0.0:
        return weights / norm
    return None
