"""Per-component wall-clock budget of one VI sweep on the accelerator.

Two modes:

--trace (the default attribution): profiles the PRODUCTION fused
  5-sweep restart-batched block (the exact dispatch the fit runs) and
  buckets HLO device time by the engine's ``sweep_*`` named scopes —
  emissions, allele swap, breakend bank, chain update, q(brk), outlier
  updates. Components sum to the measured fused block cost by
  construction. Writes SWEEP_BUDGET.json.

--standalone: times each jitted piece as its own dispatch. Standalone
  dispatches pay forced output layouts and per-call overhead the fused
  blocks don't, so these are upper bounds useful only for RELATIVE
  comparison between runs of the same shape.

Usage (on the GPU):
    python tools/sweep_budget.py [--n 6000] [--events 300] [--restarts 8]
    python tools/sweep_budget.py --standalone [...]
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from remixt_jax import accelerator  # noqa: E402


def timeit(fn, *args, iters=10, warmup=2):
    import jax
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / iters


SCOPES = ('sweep_emissions', 'sweep_p_allele_swap', 'sweep_be_bank',
          'sweep_p_cn_chain', 'sweep_p_breakpoint', 'sweep_p_outlier_total',
          'sweep_p_outlier_allele')


def _load_hlo_rows(trace_dir):
    """(tf_op_name, self_time_us) rows from the newest xplane in a trace
    directory (same converter as tools/summarize_trace.py).

    Uses total_self_time, not total_time: wrapper ops (the fused block's
    outer `while` scan) report the whole nested body as their total_time,
    which would double-count every component and inflate the
    "unattributed" bucket by the full loop-body cost."""
    import glob
    paths = sorted(glob.glob(os.path.join(
        trace_dir, 'plugins', 'profile', '*', '*.xplane.pb')))
    if not paths:
        raise SystemExit('no xplane.pb under ' + trace_dir)
    from xprof.convert import raw_to_tool_data as rtd
    data, _ = rtd.xspace_to_tool_data([paths[-1]], 'hlo_stats', {})
    if isinstance(data, bytes):
        data = data.decode()
    d = json.loads(data)
    cols = {c['id']: k for k, c in enumerate(d['cols'])}
    return [(str(r['c'][cols['tf_op_name']]['v']),
             float(r['c'][cols['total_self_time']]['v']))
            for r in d['rows']]


def trace_attribution(spec, params, state, R, num_sweeps=5, iters=5):
    """Bucket the fused restart-batched block's device time by sweep
    component (the engine's named scopes)."""
    import tempfile
    import jax
    from remixt_jax.models import engine as eng
    from remixt_jax.parallel import restarts as par

    if R > 0:
        rng = np.random.RandomState(0)
        params = par.stack_pytrees([
            params._replace(h=params.h * (1.0 + 0.2 * rng.rand()))
            for _ in range(R)])
        state = par.stack_pytrees([state] * R)
        block = jax.jit(functools.partial(
            eng.variational_sweeps_restarts, spec, num_sweeps=num_sweeps))
    else:
        block = jax.jit(functools.partial(
            eng.variational_sweeps, spec, num_sweeps=num_sweeps))

    state0 = block(params, state)
    jax.block_until_ready(state0)

    t0 = time.time()
    s = state0
    for _ in range(iters):
        s = block(params, s)
    jax.block_until_ready(s)
    wall_block_ms = (time.time() - t0) / iters * 1e3

    trace_dir = tempfile.mkdtemp(prefix='sweep_budget_trace_')
    with jax.profiler.trace(trace_dir):
        s = state0
        for _ in range(iters):
            s = block(params, s)
        jax.block_until_ready(s)

    buckets = {scope: 0.0 for scope in SCOPES}
    other = 0.0
    device_total = 0.0
    for op_name, us in _load_hlo_rows(trace_dir):
        device_total += us
        for scope in SCOPES:
            if scope in op_name:
                buckets[scope] += us
                break
        else:
            other += us

    # per-sweep ms: the traced window ran iters blocks of num_sweeps
    # sweeps (emissions once per block)
    scale = 1e-3 / iters
    out = {'N': spec.N, 'S': spec.S, 'K': spec.K, 'J': spec.J,
           'Q': spec.Q, 'L': spec.L, 'restarts': R,
           'device': accelerator.describe(),
           'mode': 'trace',
           'num_sweeps_per_block': num_sweeps,
           'block_wall_ms': round(wall_block_ms, 3),
           'block_device_ms': round(device_total * scale, 3),
           'per_sweep_device_ms': round(
               device_total * scale / num_sweeps, 3)}
    for scope, us in buckets.items():
        name = scope.replace('sweep_', '')
        per_block = us * scale
        out[name + '_ms_per_block'] = round(per_block, 3)
        out[name + '_ms_per_sweep'] = round(per_block / num_sweeps, 3)
    out['unattributed_ms_per_block'] = round(other * scale, 3)
    # named-scope buckets only; unattributed stays a separate line so
    # attributed + unattributed == block_device_ms
    out['sum_components_ms_per_block'] = round(
        sum(us for us in buckets.values()) * scale, 3)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=6000)
    ap.add_argument('--events', type=int, default=300)
    ap.add_argument('--restarts', type=int, default=8)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--standalone', action='store_true',
                    help='per-component standalone dispatches (upper '
                         'bounds) instead of fused-block attribution')
    ap.add_argument('--sweeps', type=int, default=5)
    args = ap.parse_args()

    import jax
    from bench import build_problem
    from remixt_jax.models import engine as eng

    spec, params, state, _ = build_problem(args.n, args.events)
    R = args.restarts

    if not args.standalone:
        out = trace_attribution(spec, params, state, R,
                                num_sweeps=args.sweeps, iters=args.iters)
        print(json.dumps(out, indent=2))
        with open(os.path.join(REPO, 'SWEEP_BUDGET.json'), 'w') as f:
            json.dump(out, f, indent=2)
            f.write('\n')
        return

    if R > 0:
        from remixt_jax.parallel import restarts as par
        rng = np.random.RandomState(0)
        params = par.stack_pytrees([
            params._replace(h=params.h * (1.0 + 0.2 * rng.rand()))
            for _ in range(R)])
        state = par.stack_pytrees([state] * R)

        emis = jax.jit(lambda p: jax.vmap(
            functools.partial(eng.emission_tensors, spec))(p))
        ll_tot, ll_alle = emis(params)
        sweep1 = jax.jit(functools.partial(
            eng.variational_sweep_restarts, spec))
        state = sweep1(params, state)   # realistic (post-chain) state

        vm = lambda f: jax.vmap(functools.partial(f, spec))
        pieces = {
            'emissions': (emis, (params,)),
            'p_allele_swap': (jax.jit(vm(eng.update_p_allele_swap)),
                              (params, state, ll_alle)),
            'p_cn_chain': (jax.jit(functools.partial(
                eng.update_p_cn_restarts, spec)),
                (params, state, ll_tot, ll_alle)),
            'be_bank': (jax.jit(lambda s: jax.vmap(
                lambda pb: eng.breakend_tmats_exp(spec, pb))(
                s.p_breakpoint)), (state,)),
            'p_breakpoint': (jax.jit(vm(eng.update_p_breakpoint)),
                             (params, state)),
            'p_outlier_total': (jax.jit(vm(eng.update_p_outlier_total)),
                                (params, state, ll_tot)),
            'p_outlier_allele': (jax.jit(vm(eng.update_p_outlier_allele)),
                                 (params, state, ll_alle)),
            'full_sweep': (sweep1, (params, state)),
        }
    else:
        emis = jax.jit(functools.partial(eng.emission_tensors, spec))
        ll_tot, ll_alle = emis(params)
        state = spec.sweep(params, state)   # realistic (post-chain) state

        pieces = {
            'emissions': (emis, (params,)),
            'p_allele_swap': (jax.jit(functools.partial(
                eng.update_p_allele_swap, spec)),
                (params, state, ll_alle)),
            'p_cn_chain': (jax.jit(functools.partial(
                eng.update_p_cn, spec)),
                (params, state, ll_tot, ll_alle)),
            'be_bank': (jax.jit(lambda s: eng.breakend_tmats_exp(
                spec, s.p_breakpoint)), (state,)),
            'p_breakpoint': (jax.jit(functools.partial(
                eng.update_p_breakpoint, spec)), (params, state)),
            'p_outlier_total': (jax.jit(functools.partial(
                eng.update_p_outlier_total, spec)),
                (params, state, ll_tot)),
            'p_outlier_allele': (jax.jit(functools.partial(
                eng.update_p_outlier_allele, spec)),
                (params, state, ll_alle)),
            'full_sweep': (spec.sweep, (params, state)),
        }

    out = {'N': spec.N, 'S': spec.S, 'K': spec.K, 'J': spec.J,
           'Q': spec.Q, 'L': spec.L, 'restarts': R,
           'device': accelerator.describe(),
           'mode': 'standalone_upper_bounds'}
    for name, (fn, fargs) in pieces.items():
        print('timing', name, '...', file=sys.stderr, flush=True)
        out[name + '_ms'] = round(timeit(fn, *fargs, iters=args.iters) * 1e3, 3)

    # emissions amortize over the 5 fused sweeps of a block
    parts = sum(v for k, v in out.items()
                if k.endswith('_ms') and k not in (
                    'full_sweep_ms', 'emissions_ms'))
    out['sum_updates_ms'] = round(parts, 3)
    print(json.dumps(out, indent=2))
    with open(os.path.join(REPO, 'SWEEP_BUDGET.json'), 'w') as f:
        json.dump(out, f, indent=2)
        f.write('\n')


if __name__ == '__main__':
    main()
