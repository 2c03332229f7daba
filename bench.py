"""Benchmark driver: whole-genome throughput on one GPU.

Problem: hg38-scale segment chain (N=6000 segments at the default 500 kb
grid), M=3 clones, max_copy_number=12 -> S=355 HMM states, 300 breakpoints,
23 chains. Measures:

  1. E-step segments/s per device, in the PRODUCTION shape: the R=24
     restart grid (the reference's init_id fan-out) swept in sequential
     waves of defaults.restart_chunk_size=8, exactly as fit_batched runs
     it.
  2. Single-restart sweep segments/s.
  3. Whole-genome full-fit wall-clock (5 EM x 5 VI + fused h update + the
     10-parameter grid zoom + decode) and EM iterations/s, cold (with
     compiles) and warm (restart steady state).

Every result names the device it ran on (platform, kind, count, the
card's name and power limit); without a GPU the driver fails.

Baselines (both single CPU core, timed by subprocess with taskset):
  - engine-on-1-core: the same JAX engine, XLA-CPU, one core — conservative
    (XLA-CPU is at least as fast as the reference's Cython scalar loops).
  - oracle-on-1-core: the float64 numpy oracle (models/oracle.py), a
    faithful reimplementation of the reference bpmodel.pyx semantics — the
    closest available proxy for the reference implementation itself
    (Cython is not installed; the reference publishes no numbers).

Prints exactly ONE JSON line to stdout:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "device": ...}
All measurements are also written to BENCH_DETAIL.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CPU_BASELINE_N = 512
CPU_BASELINE_EVENTS = 26
ORACLE_BASELINE_N = 512
# overridable for smoke-testing the driver on small problems
BENCH_N = int(os.environ.get('BENCH_N', 6000))
BENCH_EVENTS = int(os.environ.get('BENCH_EVENTS', 300))
NUM_RESTARTS = int(os.environ.get('BENCH_RESTARTS', 24))
# the production grid driver chunks at this size
# (defaults.restart_chunk_size)
WAVE_RESTARTS = int(os.environ.get('BENCH_WAVE', 8))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_model(N, num_events, seed=0):
    import jax.numpy as jnp
    from remixt_jax.simulations import simple as sim
    from remixt_jax.models.fit import BreakpointModel

    data = sim.simulate_experiment(
        N=N, M=3, h=(0.08, 0.05, 0.025), cn_max=12,
        num_events=num_events, seed=seed,
        num_chains=max(1, int(round(N / 260))))  # hg38-like chromosome count
    model = BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=12, max_depth=1e9,
        min_segment_length=1.0, min_proportion_genotyped=0.0,
        divergence_weight=1e-7, dtype=jnp.float32, random_seed=1234)
    model.num_em_iter = 5
    model.num_update_iter = 5
    return model, data


def build_problem(N, num_events, seed=0):
    model, data = build_model(N, num_events, seed=seed)
    spec = model._build_spec(3)
    params = spec.init_params(
        data['h'], 1e-7,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    state = spec.init_state()
    return spec, params, state, data


def median_time(fn, iters, repeats=3):
    """Median over repeated timing loops."""
    times = []
    for _ in range(repeats):
        t0 = time.time()
        fn(iters)
        times.append((time.time() - t0) / iters)
    return sorted(times)[len(times) // 2]


def time_single_sweep(spec, params, state, iters=5, block=5):
    """Per-sweep throughput of the production 5-sweep fused block
    (emissions computed once per block, as the fit executes)."""
    import jax
    sweeps = spec.sweep_n(block)
    state0 = sweeps(params, state)  # compile
    jax.block_until_ready(state0)

    def run(n):
        s = state0
        for _ in range(n):
            s = sweeps(params, s)
        jax.block_until_ready(s)
        run.last = s

    dt = median_time(run, iters) / block
    assert np.isfinite(float(run.last.hmm_log_norm_const))
    return spec.N / dt


def time_restart_batched_sweep(spec, params, state, num_restarts, iters=5):
    """The production shape: the restart grid as one vmapped SPMD sweep."""
    import jax
    from remixt_jax.parallel import restarts as par

    # distinct h per restart, as the real grid has
    rng = np.random.RandomState(0)
    params_list = []
    for _ in range(num_restarts):
        scale = 1.0 + 0.2 * rng.rand()
        params_list.append(params._replace(h=params.h * scale))
    params_b = par.stack_pytrees(params_list)
    state_b = par.stack_pytrees([state] * num_restarts)

    # the dedicated restart-batched sweep (shared-gather scan)
    import functools
    from remixt_jax.models import engine as eng
    block = 5
    sweeps_b = jax.jit(functools.partial(
        eng.variational_sweeps_restarts, spec, num_sweeps=block))

    state_b0 = sweeps_b(params_b, state_b)
    jax.block_until_ready(state_b0)

    def run(n):
        s = state_b0
        for _ in range(n):
            s = sweeps_b(params_b, s)
        jax.block_until_ready(s)
        run.last = s

    dt = median_time(run, iters) / block
    assert np.all(np.isfinite(np.asarray(run.last.hmm_log_norm_const)))
    return num_restarts * spec.N / dt


def time_restart_waves_sweep(spec, params, state, num_restarts, wave,
                             iters=5):
    """Aggregate sweep throughput of a realistic restart grid run in
    sequential WAVES (the production chunking: ceil(R/wave) dispatches of
    the same compiled wave-sized block)."""
    import functools
    import jax
    from remixt_jax.parallel import restarts as par
    from remixt_jax.models import engine as eng

    rng = np.random.RandomState(0)
    waves = []
    r_total = 0
    while r_total < num_restarts:
        r_wave = min(wave, num_restarts - r_total)
        params_b = par.stack_pytrees([
            params._replace(h=params.h * (1.0 + 0.2 * rng.rand()))
            for _ in range(wave)])  # padded to the wave (production pads)
        waves.append(params_b)
        r_total += r_wave

    state_b = par.stack_pytrees([state] * wave)
    block = 5
    sweeps_b = jax.jit(functools.partial(
        eng.variational_sweeps_restarts, spec, num_sweeps=block))
    out0 = sweeps_b(waves[0], state_b)
    jax.block_until_ready(out0)

    def run(n):
        for _ in range(n):
            for params_b in waves:
                run.last = sweeps_b(params_b, state_b)
        jax.block_until_ready(run.last)

    dt = median_time(run, iters) / block
    assert np.all(np.isfinite(np.asarray(run.last.hmm_log_norm_const)))
    return num_restarts * spec.N / dt


def time_batched_grid_fit(model, data, num_restarts):
    """The production grid path: all restarts batched through the full EM
    fit (models/fit_batched.py). Assumes compiled kernels are warm."""
    from remixt_jax.models.fit_batched import fit_restarts_batched

    rng = np.random.RandomState(1)
    h_inits = [data['h'] * (1.0 + 0.1 * rng.rand(3))
               for _ in range(num_restarts)]
    weights = [10.0 ** -rng.randint(6, 9) for _ in range(num_restarts)]

    t0 = time.time()
    results = fit_restarts_batched(model, h_inits, weights,
                                   chunk_size=num_restarts)
    cold = time.time() - t0
    t0 = time.time()
    results = fit_restarts_batched(model, h_inits, weights,
                                   chunk_size=num_restarts)
    warm = time.time() - t0
    assert all(np.isfinite(r['elbo']) for r in results)
    return {
        'batched_grid_restarts': num_restarts,
        'batched_grid_fit_cold_s': round(cold, 2),
        'batched_grid_fit_warm_s': round(warm, 2),
        'batched_grid_restarts_per_min_warm': round(
            60.0 * num_restarts / warm, 2),
    }


def time_full_fit(model, data):
    """Whole-genome production fit: 5 EM x 5 VI + h + param grids + decode."""
    t0 = time.time()
    model.fit(data['h'])
    cold = time.time() - t0

    t0 = time.time()
    model.fit(data['h'])  # warm restart: compiled kernels reused
    warm = time.time() - t0

    cn, brk_cn = model.optimal_cn()
    assert np.isfinite(model.prev_elbo)
    return {
        'full_fit_cold_s': round(cold, 2),
        'full_fit_warm_s': round(warm, 2),
        'em_iterations_per_s_warm': round(model.num_em_iter / warm, 3),
        'vi_sweeps_per_s_warm': round(
            model.num_em_iter * model.num_update_iter / warm, 2),
        'elbo': float(model.prev_elbo),
    }


def run_subprocess_baseline(mode):
    """Run this script's baseline mode pinned to one CPU core."""
    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = '--xla_cpu_multi_thread_eigen=false'
    env['OMP_NUM_THREADS'] = '1'
    env['OPENBLAS_NUM_THREADS'] = '1'
    cmd = ['taskset', '-c', '0', sys.executable,
           os.path.abspath(__file__), mode]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=REPO)
    for line in out.stdout.splitlines():
        if line.startswith('BASELINE'):
            return float(line.split()[1])
    raise RuntimeError('baseline failed:\n' + out.stdout + out.stderr)


def oracle_baseline_segs_per_s():
    """One float64 numpy-oracle VI sweep on this (pinned) core."""
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    from accuracy_gate import make_problem as gate_problem, build_oracle_for

    model, data = gate_problem(N=ORACLE_BASELINE_N, num_events=26, seed=0)
    oracle = build_oracle_for(model, data['h'])
    oracle.total_likelihood_mask = model._total_likelihood_mask.astype(np.int64)
    oracle.allele_likelihood_mask = model._allele_likelihood_mask.astype(np.int64)

    t0 = time.time()
    oracle.update_p_allele_swap()
    oracle.update_p_cn()
    oracle.update_p_breakpoint()
    oracle.update_p_outlier_total()
    oracle.update_p_outlier_allele()
    dt = time.time() - t0
    return oracle.num_segments / dt


def main():
    if '--cpu-baseline' in sys.argv:
        spec, params, state, _ = build_problem(
            CPU_BASELINE_N, CPU_BASELINE_EVENTS)
        segs = time_single_sweep(spec, params, state, iters=2)
        print('BASELINE {:.3f}'.format(segs), flush=True)
        return 0

    if '--oracle-baseline' in sys.argv:
        segs = oracle_baseline_segs_per_s()
        print('BASELINE {:.3f}'.format(segs), flush=True)
        return 0

    from remixt_jax import accelerator

    device = dict(accelerator.require_gpu(),
                  nvidia_smi=accelerator.nvidia_smi())
    detail = {'device': device, 'N': BENCH_N, 'S': 355, 'M': 3,
              'K': BENCH_EVENTS, 'num_restarts': NUM_RESTARTS}

    log('building problem...')
    model, data = build_model(BENCH_N, BENCH_EVENTS)
    spec = model._build_spec(3)
    # share the compiled spec with model.fit below
    model.spec = spec
    model._spec_num_clones = 3
    params = spec.init_params(
        data['h'], 1e-7,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    state = spec.init_state()

    log('timing single-restart sweep...')
    detail['single_restart_segments_per_s'] = round(
        time_single_sweep(spec, params, state), 1)

    log('timing restart-batched sweep (R={})...'.format(WAVE_RESTARTS))
    detail['wave_restarts'] = WAVE_RESTARTS
    detail['restart_batched_segments_per_s'] = round(
        time_restart_batched_sweep(spec, params, state, WAVE_RESTARTS), 1)

    log('timing restart grid in waves (R={} in waves of {})...'.format(
        NUM_RESTARTS, WAVE_RESTARTS))
    detail['restart_grid_segments_per_s'] = round(
        time_restart_waves_sweep(spec, params, state, NUM_RESTARTS,
                                 WAVE_RESTARTS), 1)

    log('full fit (5 EM x 5 VI)...')
    detail.update(time_full_fit(model, data))

    if os.environ.get('BENCH_GRID'):
        # opt-in: compiles the whole batched EM stack
        log('batched grid fit (R={} full fits)...'.format(NUM_RESTARTS))
        detail.update(time_batched_grid_fit(model, data, NUM_RESTARTS))

    log('cpu 1-core engine baseline...')
    cpu_segs = run_subprocess_baseline('--cpu-baseline')
    detail['cpu_1core_engine_segments_per_s'] = round(cpu_segs, 1)

    log('cpu 1-core float64 oracle baseline...')
    try:
        oracle_segs = run_subprocess_baseline('--oracle-baseline')
        detail['cpu_1core_f64_oracle_segments_per_s'] = round(oracle_segs, 2)
    except RuntimeError as exc:
        log('oracle baseline failed: {}'.format(exc))
        oracle_segs = None

    with open(os.path.join(REPO, 'BENCH_DETAIL.json'), 'w') as f:
        json.dump(detail, f, indent=2)

    headline = max(detail['single_restart_segments_per_s'],
                   detail['restart_grid_segments_per_s'])
    result = {
        'metric': 'e_step_segments_per_s_per_device',
        'value': headline,
        'unit': ('segments/s (best of fused single-restart and the R={R} '
                 'restart grid swept in waves of {W}, N~{N} S=355 M=3 '
                 'K={K}, 23 chains, f32; baseline = same engine 1 CPU '
                 'core; see '
                 .format(R=NUM_RESTARTS, W=WAVE_RESTARTS, N=spec.N,
                         K=BENCH_EVENTS) +
                 'BENCH_DETAIL.json for per-path, full-fit and '
                 'f64-oracle-baseline numbers)'),
        'vs_baseline': round(headline / cpu_segs, 2),
        'device': device,
    }
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
