"""Per-phase wall-clock budget of the warm full fit on the accelerator.

The bench's ``full_fit_warm_s`` (5 EM x 5 VI + fused h update + the
10-parameter grid zoom) is a different animal from the raw sweep
throughput: each EM iteration interleaves device dispatches with host
work (subsample RNG draws) and one forced host pull (the posterior
sampling weights feed numpy's RandomState). This tool times each phase
separately so M-step optimization is attributed before it starts —
the same measured-first discipline as tools/sweep_budget.py.

Usage (on the GPU):
    python tools/fit_budget.py [--n 6000] [--events 300] [--restarts 8]
    python tools/fit_budget.py --trace [...]

Writes FIT_BUDGET.json at the repo root. Default phase numbers are
standalone dispatch+sync costs (upper bounds on their share of the
pipelined fit loop; the loop overlaps host work with device execution
wherever the data flow allows). With ``--trace`` the tool instead
profiles one warm PRODUCTION batched EM iteration (the exact dispatch
sequence fit_restarts_batched issues: fused sweeps, fused h update,
weights pull, fused param grid zoom) and buckets HLO device time by the
engine's ``sweep_*`` and ``em_*`` named scopes, so components sum to the
fused cost by construction.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, 'tools'))

from remixt_jax import accelerator  # noqa: E402


def timeit(fn, iters=10, warmup=2):
    import jax
    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.time() - t0) / iters


EM_SCOPES = ('sweep_emissions', 'sweep_p_allele_swap', 'sweep_be_bank',
             'sweep_p_cn_chain', 'sweep_p_breakpoint',
             'sweep_p_outlier_total', 'sweep_p_outlier_allele',
             'em_h_search', 'em_h_full_guard', 'em_running_components',
             'em_grid_zoom', 'em_candidate_guard', 'em_elbo_assembly')


def trace_em_iteration(model, data, R, iters=3):
    """Device-time attribution of one warm production batched EM iteration
    (sweeps + h update + weights + param grid zoom) by named scope."""
    import tempfile
    import jax
    from remixt_jax.models import em as em_mod
    from remixt_jax.models.fit_batched import _sweeps_batched_fn
    from remixt_jax.parallel import restarts as par
    from sweep_budget import _load_hlo_rows

    model.fit(data['h'])  # warm + settled single state
    spec, state = model.spec, model.state
    names = tuple(model.likelihood_params)
    bounds = model.likelihood_param_bounds

    rngs_np = np.random.RandomState(1)
    h_inits = [data['h'] * (1.0 + 0.1 * rngs_np.rand(3)) for _ in range(R)]
    dws = [10.0 ** -rngs_np.randint(6, 9) for _ in range(R)]
    params_b = par.stack_pytrees(
        [spec.init_params(
            h, dw,
            total_mask=model._total_likelihood_mask.astype(float),
            allele_mask=model._allele_likelihood_mask.astype(float))
         for h, dw in zip(h_inits, dws)])
    state_b = par.stack_pytrees([state] * R)
    rngs = [np.random.RandomState(model.random_seed) for _ in range(R)]
    sweeps_b = _sweeps_batched_fn(spec, model.num_update_iter)

    def em_iter(params_b, state_b):
        state_b = sweeps_b(params_b, state_b)
        params_b, _ = em_mod.update_h_fused_batched(
            spec, params_b, state_b, rngs)
        weights_lists = em_mod.param_sample_weights_all_batched(
            spec, state_b, names)
        params_b, _, elbo = em_mod.update_params_fused_batched(
            spec, params_b, state_b, names, bounds, rngs,
            weights_lists=weights_lists)
        return params_b, state_b, elbo

    params_b, state_b, elbo = em_iter(params_b, state_b)  # warm all jits
    jax.block_until_ready(elbo)

    t0 = time.time()
    for _ in range(iters):
        out = em_iter(params_b, state_b)
    jax.block_until_ready(out[2])
    wall_ms = (time.time() - t0) / iters * 1e3

    trace_dir = tempfile.mkdtemp(prefix='fit_budget_trace_')
    with jax.profiler.trace(trace_dir):
        for _ in range(iters):
            out = em_iter(params_b, state_b)
        jax.block_until_ready(out[2])

    buckets = {s: 0.0 for s in EM_SCOPES}
    other = 0.0
    device_total = 0.0
    for op_name, us in _load_hlo_rows(trace_dir):
        device_total += us
        for s in EM_SCOPES:
            if s in op_name:
                buckets[s] += us
                break
        else:
            other += us

    scale = 1e-3 / iters
    out = {'N': model.spec.N, 'restarts': R, 'mode': 'trace',
           'em_iter_wall_ms': round(wall_ms, 3),
           'em_iter_device_ms': round(device_total * scale, 3)}
    for s, us in buckets.items():
        out[s + '_ms'] = round(us * scale, 3)
    out['unattributed_ms'] = round(other * scale, 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--restarts', type=int, default=8)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--trace', action='store_true',
                    help='named-scope attribution of one warm batched EM '
                         'iteration instead of standalone phase timings')
    ap.add_argument('--no-cache', action='store_true',
                    help='disable the persistent compilation cache (the '
                         'production default is on; a second process with '
                         'the cache warm measures deserialization-cold '
                         'rather than compile-cold start)')
    args = ap.parse_args()

    if not args.no_cache:
        from remixt_jax.compile_cache import enable_compilation_cache
        cache_dir = enable_compilation_cache()
    else:
        cache_dir = None

    if args.trace:
        import jax
        from bench import build_model
        model, data = build_model(args.n, args.events)
        out = trace_em_iteration(model, data, args.restarts,
                                 iters=max(2, args.iters // 3))
        out['device'] = accelerator.describe()
        print(json.dumps(out, indent=1))
        with open(os.path.join(REPO, 'FIT_BUDGET_TRACE.json'), 'w') as f:
            json.dump(out, f, indent=1)
            f.write('\n')
        return

    import jax
    from bench import build_model
    from remixt_jax.models import em as em_mod

    model, data = build_model(args.n, args.events)
    out = {
        'N': args.n, 'restarts': args.restarts,
        # b_* numbers scale with the restart batch; compare across
        # revisions only at matching N/restarts (round 4 moved the
        # default wave from R=12 to R=8, which alone shrank every b_*)
        'shape_note': 'b_* values are per-wave at this N/restarts; '
                      'not comparable across differing shapes',
        'device': accelerator.describe(),
        'compilation_cache': cache_dir,
    }

    # ---- single-restart fit: total, then phases at the settled state ----
    t0 = time.time()
    model.fit(data['h'])
    out['full_fit_cold_s'] = round(time.time() - t0, 3)
    t0 = time.time()
    model.fit(data['h'])
    out['full_fit_warm_s'] = round(time.time() - t0, 3)

    spec, params, state = model.spec, model.params, model.state
    names = tuple(model.likelihood_params)
    bounds = model.likelihood_param_bounds
    rng = np.random.RandomState(7)

    # host round-trip floor: pull one device scalar
    elbo_dev = spec.elbo(params, state)
    jax.block_until_ready(elbo_dev)
    out['host_pull_scalar_ms'] = round(
        timeit(lambda: float(elbo_dev), iters=20) * 1e3, 3)

    sweeps = spec.sweep_n(model.num_update_iter)
    out['sweep5_ms'] = round(
        timeit(lambda: sweeps(params, state), iters=args.iters) * 1e3, 3)
    out['h_update_ms'] = round(timeit(
        lambda: em_mod.update_h_fused(spec, params, state, rng),
        iters=args.iters) * 1e3, 3)
    out['param_weights_ms'] = round(timeit(
        lambda: em_mod.param_sample_weights_all(spec, state, names),
        iters=args.iters) * 1e3, 3)
    weights_list = em_mod.param_sample_weights_all(spec, state, names)
    out['params_update_ms'] = round(timeit(
        lambda: em_mod.update_params_fused(
            spec, params, state, names, bounds, rng, weights_list),
        iters=args.iters) * 1e3, 3)
    out['elbo_ms'] = round(
        timeit(lambda: spec.elbo(params, state), iters=args.iters) * 1e3, 3)
    out['decode_ms'] = round(
        timeit(lambda: spec.decode(params, state), iters=args.iters) * 1e3, 3)

    # ---- restart-batched grid fit ----
    R = args.restarts
    if R > 0:
        from remixt_jax.models.fit_batched import fit_restarts_batched
        rngs_np = np.random.RandomState(1)
        h_inits = [data['h'] * (1.0 + 0.1 * rngs_np.rand(3))
                   for _ in range(R)]
        dws = [10.0 ** -rngs_np.randint(6, 9) for _ in range(R)]
        t0 = time.time()
        fit_restarts_batched(model, h_inits, dws, chunk_size=R)
        out['batched_grid_fit_cold_s'] = round(time.time() - t0, 3)
        t0 = time.time()
        fit_restarts_batched(model, h_inits, dws, chunk_size=R)
        out['batched_grid_fit_warm_s'] = round(time.time() - t0, 3)

        from remixt_jax.parallel import restarts as par
        params_b = par.stack_pytrees(
            [spec.init_params(h, dw,
                              total_mask=model._total_likelihood_mask.astype(float),
                              allele_mask=model._allele_likelihood_mask.astype(float))
             for h, dw in zip(h_inits, dws)])
        state_b = par.stack_pytrees([state] * R)
        rngs = [np.random.RandomState(model.random_seed) for _ in range(R)]

        from remixt_jax.models.fit_batched import (
            _sweeps_batched_fn, _elbo_batched_fn)
        sweeps_b = _sweeps_batched_fn(spec, model.num_update_iter)
        state_b = sweeps_b(params_b, state_b)  # settled batched state
        jax.block_until_ready(state_b)

        out['b_sweep5_ms'] = round(
            timeit(lambda: sweeps_b(params_b, state_b),
                   iters=args.iters) * 1e3, 3)
        out['b_h_update_ms'] = round(timeit(
            lambda: em_mod.update_h_fused_batched(
                spec, params_b, state_b, rngs),
            iters=args.iters) * 1e3, 3)
        out['b_param_weights_ms'] = round(timeit(
            lambda: em_mod.param_sample_weights_all_batched(
                spec, state_b, names),
            iters=args.iters) * 1e3, 3)
        weights_lists = em_mod.param_sample_weights_all_batched(
            spec, state_b, names)
        out['b_params_update_ms'] = round(timeit(
            lambda: em_mod.update_params_fused_batched(
                spec, params_b, state_b, names, bounds, rngs,
                weights_lists=weights_lists),
            iters=args.iters) * 1e3, 3)
        out['b_elbo_ms'] = round(
            timeit(lambda: _elbo_batched_fn(spec)(params_b, state_b),
                   iters=args.iters) * 1e3, 3)

    print(json.dumps(out, indent=1))
    with open(os.path.join(REPO, 'FIT_BUDGET.json'), 'w') as f:
        json.dump(out, f, indent=1)
        f.write('\n')


if __name__ == '__main__':
    main()
