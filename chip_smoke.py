"""Smoke run of the production whole-genome fit on the GPU.

    python chip_smoke.py               one card
    python chip_smoke.py --four-cards  the multi-device paths on four cards

One card runs the restart-grid fit that ``remixt-jax fit``/``run`` runs
(analysis/pipeline.fit_many) at the flagship width: a simulated whole
genome at the 500 kb grid (N~6,000 segments in 23 chains, K=300
breakpoints), M=3 clones at max copy number 12 (S=355 states), float32,
5 EM x 5 VI iterations, over a grid of R=24 restarts (three waves of 8).
Phases:

  a. device check: JAX's platform, device kind and count, the card's name
     and power limit; fails unless the default device is a GPU
  b. compile the batched 5-sweep program and the batched EM step at full
     width and print each one's memory analysis
  c. the grid fit, cold and then warm: wall time, peak device memory, the
     chosen solution's ELBO and h, and how much of the genome its
     dominant clone decodes to the simulated copy number
  d. the same float32 engine on the CPU backend in this process: two VI
     sweeps of one wave on both, compared within the bounds below

``--four-cards`` runs, each against its one-card result: the R=24 grid on
a 4-device restart mesh, after one EM iteration (per restart) and after
the full fit (warm); a cohort of 4 samples, one per card
(fit_many_cohort), each the simulated whole genome fitted from its own
wave of restarts; and one chain blocked over the 4 devices.

Prints the card's name and power limit, and as its last line one JSON
object ``{"ok": true, "device": {...}}``. A failing phase raises, so the
script exits non-zero without that line.
"""

import argparse
import contextlib
import functools
import json
import time
import types

import numpy as np
import jax
import jax.numpy as jnp

import remixt_jax.config
from remixt_jax import accelerator, compile_cache
from remixt_jax.analysis import pipeline
from remixt_jax.models import em as em_mod
from remixt_jax.models import engine as eng
from remixt_jax.models import fit_batched
from remixt_jax.ops import special
from remixt_jax.parallel import chain as par_chain
from remixt_jax.parallel import distributed
from remixt_jax.parallel import restarts as par
from remixt_jax.simulations import simple as sim

# flagship width: one whole genome at the 500 kb grid
FLAGSHIP = dict(N=6000, num_events=300, num_chains=23, max_copy_number=12)
H_TRUE = (0.08, 0.05, 0.025)
NUM_CLONES = 3

# Card against CPU, two VI sweeps of one wave of the same float32 engine.
# The two backends round float32 differently (reduction order, their own
# exp/log/lgamma), so the bounds are float32 noise. On an H100 at a 400 W
# power limit, with every contraction at HIGHEST, the card read 1.3e-6,
# 1.3e-2 and 0 against these three bounds:
#  - log normaliser: a sum over ~6,000 segments of terms ~1e3; 1e-5
#    relative is ~100 float32 ulps of the total
LOG_NORM_REL_BOUND = 1e-5
#  - posteriors: a state nearly tied with another moves by ~1e-2 under
#    any change of float32 rounding, so the largest difference is bounded
#    by the repo's float32-vs-float64 gate (tools/accuracy_gate.py, 5e-2),
#    which TF32 contractions break (0.82 on the same card)
POSTERIOR_ABS_BOUND = 5e-2
#  - and across all segments and states the differences stay float32
#    noise on average
POSTERIOR_MEAN_ABS_BOUND = 1e-5
#  - argmax: only near-tied states may flip; 0.5% of segments
ARGMAX_DISAGREEMENT_BOUND = 5e-3
# The chosen solution's dominant clone decodes to the simulated copy
# number on nearly all of the genome: the simulation draws from the
# model's own family and the grid holds its true depth mode.
ACCURACY_BOUND = 0.95


def log(*args):
    print(*args, flush=True)


def require(ok, message):
    """Fail the phase: a check that ``python -O`` does not strip."""
    if not ok:
        raise RuntimeError(message)


# ---------------------------------------------------------------------------
# problem
# ---------------------------------------------------------------------------

def simulate_sample(seed, N, num_events, num_chains, max_copy_number):
    """A simulated whole genome as the fit path reads it (the fields of
    analysis/experiment.Experiment that pipeline.fit_many uses), plus its
    truth."""
    data = sim.simulate_experiment(
        N=N, M=NUM_CLONES, h=H_TRUE, cn_max=max_copy_number,
        num_events=num_events, seed=seed, num_chains=num_chains)
    chain_id = np.cumsum([0] + [
        0 if (n, n + 1) in data['adjacencies'] else 1 for n in range(N - 1)])
    sample = types.SimpleNamespace(
        x=data['x'], l=data['l'], adjacencies=data['adjacencies'],
        breakpoints=data['breakpoints'],
        segment_chromosome_id=np.asarray([str(c + 1) for c in chain_id]))
    return sample, data


def fit_config(max_copy_number, num_em_iter=5, num_update_iter=5):
    return {
        'max_copy_number': max_copy_number,
        'num_em_iter': num_em_iter,
        'num_update_iter': num_update_iter,
        'engine_dtype': 'float32',
    }


def restart_grid(data, config, depth_scale=1.0):
    """The restart grid of init parameters, as pipeline.init builds it
    (depth modes x tumour mix fractions x divergence weights, one shared
    max depth), with two depth modes: the simulated tumour depth (times
    ``depth_scale``) and its genome-doubled alternative. With the default
    4 mix fractions and 3 divergence weights that is R=24."""
    get = functools.partial(remixt_jax.config.get_param, config)
    h_normal = data['h'][0]
    h_tumour = data['h'][1:].sum() * depth_scale
    modes = [(h_normal, h_tumour), (h_normal, h_tumour / 2.)]
    max_depth = min(2. * hn + (get('max_copy_number') + 0.25) * ht
                    for hn, ht in modes)
    grid = {}
    for mode_idx, (hn, ht) in enumerate(modes):
        for mix_frac in get('tumour_mix_fractions'):
            for weight in get('divergence_weights'):
                grid[len(grid)] = dict(
                    mode_idx=mode_idx, h_normal=hn, h_tumour=ht,
                    mix_frac=mix_frac, divergence_weight=weight,
                    max_depth=max_depth)
    return grid


def dominant_cn_fraction(cn, h, data):
    """Length-weighted fraction of segments whose dominant tumour clone
    (the largest h) decodes to the simulated allele-specific copy number
    of the simulated dominant clone."""
    fit = np.sort(cn[:, 1 + np.argmax(h[1:]), :], axis=-1)
    truth = np.sort(data['cn'][:, 1 + np.argmax(data['h'][1:]), :], axis=-1)
    match = np.all(fit == truth, axis=-1)
    return float((match * data['l']).sum() / data['l'].sum())


def wave_inputs(sample, grid, config, wave):
    """Spec and stacked init params/state of the grid's first wave, built
    the way the batched driver builds them."""
    ids = list(grid)[:wave]
    model = pipeline.build_model(sample, grid[ids[0]], config)
    spec = model._build_spec(NUM_CLONES)
    params_b = par.stack_pytrees([
        spec.init_params(
            pipeline._restart_h_init(grid[i]), grid[i]['divergence_weight'],
            total_mask=model._total_likelihood_mask.astype(float),
            allele_mask=model._allele_likelihood_mask.astype(float))
        for i in ids])
    state_b = par.stack_pytrees([spec.init_state()] * len(ids))
    return model, spec, params_b, state_b


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(expect_count=None):
    """a. The device, the card, the cache; fails without a GPU."""
    device = accelerator.require_gpu()
    log('device: platform={platform} kind={kind} count={count}'.format(
        **device))
    if expect_count is not None and device['count'] < expect_count:
        raise RuntimeError('needs {} devices, found {}'.format(
            expect_count, device['count']))
    log('nvidia-smi name, power.limit:', accelerator.nvidia_smi())
    for name in ('pandas', 'h5py', 'sklearn', 'yaml'):
        try:
            __import__(name)
            found = 'importable'
        except ImportError:
            found = 'absent'
        log('host package {}: {}'.format(name, found))
    log('compilation cache:', compile_cache.enable_compilation_cache())
    return device


def phase_compile(sample, grid, config, wave):
    """b. Lower and compile the batched VI sweep block and the batched EM
    step of one wave; print each program's memory analysis."""
    model, spec, params_b, state_b = wave_inputs(sample, grid, config, wave)
    log('problem: N={} S={} K={} J={} chains={} L={} wave={}'.format(
        spec.N, spec.S, spec.K, spec.J, spec.Q, spec.L, wave))
    k = em_mod.sample_size_for(spec.N)
    names = tuple(model.likelihood_params)
    programs = {
        'sweeps_b ({} VI sweeps)'.format(model.num_update_iter): (
            fit_batched._sweeps_batched_fn(spec, model.num_update_iter),
            (params_b, state_b)),
        'em h update': (
            em_mod._h_update_batched_fn(spec),
            (params_b, state_b, jnp.zeros((wave, k), jnp.int32),
             jnp.ones(spec.N, spec.dtype))),
        'em params update + elbo': (
            em_mod._params_update_batched_fn(
                spec, names, model.likelihood_param_bounds),
            (params_b, state_b,
             jnp.zeros((wave, len(names), k), jnp.int32))),
    }
    for name, (fn, args) in programs.items():
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        check_precision(name, lowered.as_text())
        compiled = lowered.compile()
        seconds = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        log('compiled {}: {:.3f} s; memory_analysis: argument {} B, '
            'output {} B, temp {} B, alias {} B, generated code {} B'.format(
                name, seconds, mem.argument_size_in_bytes,
                mem.output_size_in_bytes, mem.temp_size_in_bytes,
                mem.alias_size_in_bytes, mem.generated_code_size_in_bytes))
    return model, spec, params_b, state_b


def check_precision(name, hlo_text):
    """Every dot of a lowered program runs at HIGHEST precision: float32
    FMA on the GPU, never TF32."""
    dots = [line for line in hlo_text.splitlines() if 'dot_general' in line]
    lower = [line for line in dots
             if 'precision = [HIGHEST, HIGHEST]' not in line]
    log('{}: {} dots, {} below HIGHEST precision'.format(
        name, len(dots), len(lower)))
    if lower:
        raise RuntimeError('dot below HIGHEST precision: ' + lower[0])


def time_sweep_block(spec, params_b, state_b, num_sweeps, repeats=3):
    """Warm wall time of one batched VI sweep block (median of repeats)."""
    sweeps = fit_batched._sweeps_batched_fn(spec, num_sweeps)
    jax.block_until_ready(sweeps(params_b, state_b))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(sweeps(params_b, state_b))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def chosen_solution(results, config):
    ids = list(results)
    best = pipeline.optimal_init_id(
        ids, [results[i]['stats']['elbo'] for i in ids],
        [results[i]['stats']['proportion_divergent'] for i in ids],
        remixt_jax.config.get_param(config, 'max_prop_diverge'))
    return best, results[best]


def check_fit(results, grid):
    require(set(results) == set(grid), 'missing restarts')
    for init_id, fit in results.items():
        require(np.isfinite(fit['stats']['elbo'])
                and np.all(np.isfinite(fit['h'])) and np.all(fit['h'] > 0)
                and fit['cn'].shape[1:] == (NUM_CLONES, 2),
                'restart {}: non-finite or malformed fit'.format(init_id))


def phase_grid_fit(sample, data, grid, config, wave_spec):
    """c. The production grid fit, cold then warm; the chosen solution."""
    spec, params_b, state_b = wave_spec
    timings = {}
    for label in ('cold', 'warm'):
        t0 = time.perf_counter()
        results = pipeline.fit_many(sample, grid, config)
        timings[label] = time.perf_counter() - t0
        check_fit(results, grid)
        log('grid fit {}: R={} in {:.3f} s'.format(
            label, len(grid), timings[label]))
    block = time_sweep_block(spec, params_b, state_b,
                             remixt_jax.config.get_param(
                                 config, 'num_update_iter'))
    log('warm batched {}-sweep block (wave of {}): {:.4f} s'.format(
        remixt_jax.config.get_param(config, 'num_update_iter'),
        params_b.h.shape[0], block))
    stats = jax.devices()[0].memory_stats() or {}
    log('peak_bytes_in_use:', stats.get('peak_bytes_in_use', 'not reported'))

    best, fit = chosen_solution(results, config)
    accuracy = dominant_cn_fraction(fit['cn'], fit['h'], data)
    log('chosen solution: restart {} elbo {:.6f} h {}'.format(
        best, fit['stats']['elbo'], np.array2string(fit['h'], precision=6)))
    log('dominant-clone copy number matching the simulation: {:.6f} of the '
        'genome (bound {})'.format(accuracy, ACCURACY_BOUND))
    return results, timings, accuracy


def sweep_states(spec, params_b, state_b, num_sweeps):
    out = fit_batched._sweeps_batched_fn(spec, num_sweeps)(params_b, state_b)
    return (np.asarray(out.hmm_log_norm_const, np.float64),
            np.asarray(out.posterior_marginals, np.float64))


def phase_reference(sample, grid, config, wave, device_spec, num_sweeps=2):
    """d. The same float32 engine pinned to the CPU backend: two VI sweeps
    of one wave on both backends, compared."""
    if special.MM_PRECISION != jax.lax.Precision.HIGHEST:
        raise RuntimeError('contractions must run at HIGHEST precision, '
                           'not {}'.format(special.MM_PRECISION))
    log('contraction precision: HIGHEST (float32 FMA, not TF32)')
    spec, params_b, state_b = device_spec
    norm_dev, marg_dev = sweep_states(spec, params_b, state_b, num_sweeps)

    cpu = jax.devices('cpu')[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        _, spec_c, params_c, state_c = wave_inputs(sample, grid, config, wave)
        norm_cpu, marg_cpu = sweep_states(spec_c, params_c, state_c,
                                          num_sweeps)
    log('cpu reference ({} sweeps, wave of {}): {:.3f} s'.format(
        num_sweeps, wave, time.perf_counter() - t0))

    require(np.all(np.isfinite(norm_dev)) and np.all(np.isfinite(marg_dev)),
            'non-finite sweep on the card')
    norm_rel = float(np.max(np.abs(norm_dev - norm_cpu) / np.abs(norm_cpu)))
    marg_abs = float(np.max(np.abs(marg_dev - marg_cpu)))
    marg_mean = float(np.mean(np.abs(marg_dev - marg_cpu)))
    argmax = float(np.mean(marg_dev.argmax(-1) != marg_cpu.argmax(-1)))
    log('card vs cpu: log normaliser max rel diff {:.3e} (bound {:.0e}); '
        'posterior max abs diff {:.3e} (bound {:.0e}), mean abs diff {:.3e} '
        '(bound {:.0e}); argmax disagreement {:.3e} (bound {:.0e})'.format(
            norm_rel, LOG_NORM_REL_BOUND, marg_abs, POSTERIOR_ABS_BOUND,
            marg_mean, POSTERIOR_MEAN_ABS_BOUND, argmax,
            ARGMAX_DISAGREEMENT_BOUND))
    require(norm_rel <= LOG_NORM_REL_BOUND
            and marg_abs <= POSTERIOR_ABS_BOUND
            and marg_mean <= POSTERIOR_MEAN_ABS_BOUND
            and argmax <= ARGMAX_DISAGREEMENT_BOUND,
            'card and cpu disagree beyond the bounds')
    return norm_rel, marg_abs, argmax


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

# Four cards against one. One H100 fitting the R=24 grid twice in one
# process gives its own noise floor:
#  - the first 5-sweep block is bit-identical run to run;
#  - the EM updates are not: XLA runs some of their reductions in no fixed
#    order (with --xla_gpu_deterministic_ops=true the whole fit repeats
#    bit for bit, at 2.6x the time), and the argmax over backtracking
#    scales and the accept/reject steps turn float32 noise into whole
#    steps: after one EM iteration h differed by up to 6.0e-2 relative,
#    after five by up to 0.17 (median 2.4e-2), with decoded copy number
#    equal on 88% of segments at the worst restart.
# The four-card programs are compiled for two restarts per card rather
# than a wave of eight, so they also round differently. Hence:
#  - per restart, the posteriors of the first sweep block, before any EM
#    update, agree within the card-vs-CPU bounds above (float32 rounding
#    of other programs; a restart fitted with another's inputs differs by
#    O(1));
FIRST_BLOCK_BOUNDS = (POSTERIOR_ABS_BOUND, POSTERIOR_MEAN_ABS_BOUND,
                      ARGMAX_DISAGREEMENT_BOUND)
#  - per restart after the full fit, h agrees within 0.5 relative, about
#    twice the largest reading (0.17 one card against itself, 0.26 four
#    cards against one with a wave per card); a backstop only;
RESTART_H_REL_BOUND = 0.5
#  - the chosen solution is the same restart, its decoded copy number
#    agrees on 99% of segments (100% in every reading: one card against
#    itself, four against one, each cohort sample), and its h within
#    1e-1 relative (read 3.6e-2 one card against itself).
MESH_H_REL_BOUND = 1e-1
MESH_CN_AGREEMENT_BOUND = 0.99
# blocked vs chain-batched sweep: the transfer-matrix fold reassociates a
# ~125-step product of float32 matrices; a broken boundary exchange moves
# posteriors by O(1)
BLOCKED_POSTERIOR_ABS_BOUND = 1e-2


@contextlib.contextmanager
def recording_fits():
    """While active, every restart the pipeline extracts is recorded as
    ``records[(id(experiment), id(init_params))] = (devices, posterior
    marginals)``."""
    records = {}
    extract = pipeline._extract_results

    def record(model, experiment, init_params, cfg):
        records[(id(experiment), id(init_params))] = (
            set(model.params.h.devices()),
            np.asarray(model.state.posterior_marginals, np.float32))
        return extract(model, experiment, init_params, cfg)

    pipeline._extract_results = record
    try:
        yield records
    finally:
        pipeline._extract_results = extract


def compare_chosen(label, fits, reference, config):
    """A fitted grid against its one-card reference: the chosen solution,
    and every restart's h; returns the failures."""
    best, fit = chosen_solution(fits, config)
    best_ref, fit_ref = chosen_solution(reference, config)
    h_rel = float(np.max(np.abs(fit['h'] - fit_ref['h']) / fit_ref['h']))
    agree = float(np.mean(np.all(fit['cn'] == fit_ref['cn'], axis=(1, 2))))
    per_restart = {i: float(np.max(np.abs(fits[i]['h'] - reference[i]['h'])
                                   / reference[i]['h'])) for i in reference}
    restart_agree = [float(np.mean(np.all(
        fits[i]['cn'] == reference[i]['cn'], axis=(1, 2))))
        for i in reference]
    log('{}: chosen restart {} / {}, h max rel diff {:.3e} (bound {:.0e}), '
        'segments with equal decoded cn {:.6f} (bound {}); all {} '
        'restarts: h rel diff median {:.3e} max {:.3e} (bound {}), '
        'segments with equal decoded cn min {:.6f}'.format(
            label, best, best_ref, h_rel, MESH_H_REL_BOUND, agree,
            MESH_CN_AGREEMENT_BOUND, len(per_restart),
            float(np.median(list(per_restart.values()))),
            max(per_restart.values()), RESTART_H_REL_BOUND,
            min(restart_agree)))
    failures = []
    if not (best == best_ref and h_rel <= MESH_H_REL_BOUND
            and agree >= MESH_CN_AGREEMENT_BOUND):
        failures.append('{}: chosen solution differs from one card'.format(
            label))
    far = [i for i, d in per_restart.items() if not d <= RESTART_H_REL_BOUND]
    if far:
        failures.append('{}: h of restarts {} differs from one card'.format(
            label, far))
    return failures


def compare_first_block(label, posteriors, reference):
    """Per restart, the posteriors of the first sweep block against the
    one-card ones; returns the failures."""
    max_bound, mean_bound, argmax_bound = FIRST_BLOCK_BOUNDS
    rows = {}
    for i, ref in reference.items():
        diff = np.abs(posteriors[i].astype(np.float64) - ref)
        rows[i] = (float(diff.max()), float(diff.mean()),
                   float(np.mean(posteriors[i].argmax(-1) != ref.argmax(-1))))
    worst = [max(row[k] for row in rows.values()) for k in range(3)]
    log('{}, first sweep block, worst of {} restarts: posterior max abs diff '
        '{:.3e} (bound {:.0e}), mean abs diff {:.3e} (bound {:.0e}), argmax '
        'disagreement {:.3e} (bound {:.0e})'.format(
            label, len(rows), worst[0], max_bound, worst[1], mean_bound,
            worst[2], argmax_bound))
    far = [i for i, (mx, mean, arg) in rows.items()
           if not (mx <= max_bound and mean <= mean_bound
                   and arg <= argmax_bound)]
    if far:
        return ['{}: first-block posteriors of restarts {} differ from one '
                'card'.format(label, far)]
    return []


def grid_fits(sample, grid, config, mesh):
    """The grid through the batched driver on one card (``mesh`` None) or
    on a restart mesh: fits, each restart's final posteriors, seconds."""
    t0 = time.perf_counter()
    with recording_fits() as records:
        fits = pipeline._fit_many_batched(sample, grid, config, mesh=mesh)
    seconds = time.perf_counter() - t0
    check_fit(fits, grid)
    posteriors = {i: records[(id(sample), id(grid[i]))][1] for i in grid}
    return fits, posteriors, seconds


def four_card_grid(sample, grid, config, devices):
    """The R=24 grid on a 4-device restart mesh vs one card: one EM
    iteration (the first sweep block's posteriors, per restart), then the
    full fit (the chosen solution, and every restart's h). The full fits
    reuse the programs the first compiled, so their times are warm."""
    mesh = distributed.make_training_mesh(devices=devices,
                                          num_restarts=len(grid))
    num_em_iter = remixt_jax.config.get_param(config, 'num_em_iter')
    runs = {}
    for em_iter in sorted({1, num_em_iter}):
        cfg = dict(config, num_em_iter=em_iter)
        for label, mesh_ in (('one card', None), ('four cards', mesh)):
            runs[em_iter, label] = grid_fits(sample, grid, cfg, mesh_)
            log('grid R={} with {} EM on {}: {:.3f} s{}'.format(
                len(grid), em_iter, label, runs[em_iter, label][2],
                '' if mesh_ is None else ' (mesh {})'.format(
                    dict(mesh_.shape))))
    failures = compare_first_block(
        'grid four cards vs one', runs[1, 'four cards'][1],
        runs[1, 'one card'][1])
    return failures + compare_chosen(
        'grid four cards vs one, {} EM'.format(num_em_iter),
        runs[num_em_iter, 'four cards'][0],
        runs[num_em_iter, 'one card'][0], config)


def cohort_samples(sample, data, config, wave, count):
    """A cohort of ``count`` samples of the one simulated genome, each
    fitted from its own wave of restarts (depths scaled per sample):
    distinct fits whose programs are the one-card run's, so nothing new
    compiles."""
    samples = {}
    for i in range(count):
        grid = restart_grid(data, config, depth_scale=1.0 + 0.05 * i)
        samples['sample{}'.format(i)] = (
            types.SimpleNamespace(**vars(sample)), data,
            dict(list(grid.items())[:wave]))
    return samples


def four_card_cohort(samples, config, devices):
    """fit_many_cohort over the samples, one device group each, vs
    sequential fit_many per sample on one card."""
    experiments = {sid: s for sid, (s, _, _) in samples.items()}
    grids = {sid: g for sid, (_, _, g) in samples.items()}
    t0 = time.perf_counter()
    with recording_fits() as records:
        cohort = pipeline.fit_many_cohort(experiments, grids, config)
    log('cohort of {} on {} cards: {:.3f} s'.format(
        len(samples), len(devices), time.perf_counter() - t0))
    placed = {sid: set().union(*(devices_ for (e, _), (devices_, _)
                                 in records.items() if e == id(s)))
              for sid, s in experiments.items()}
    for sid in samples:
        log('sample {} arrays on {}'.format(
            sid, sorted(str(d) for d in placed[sid])))
    require(len({frozenset(p) for p in placed.values()}) == len(samples),
            'two samples shared a device')

    t0 = time.perf_counter()
    with jax.default_device(devices[0]):
        sequential = {sid: pipeline.fit_many(
            experiments[sid], grids[sid], dict(config, use_device_mesh=False))
            for sid in samples}
    log('the same {} samples in turn on one card: {:.3f} s'.format(
        len(samples), time.perf_counter() - t0))
    failures = []
    for sid in samples:
        check_fit(cohort[sid], grids[sid])
        failures += compare_chosen('cohort vs one card, sample ' + sid,
                                   cohort[sid], sequential[sid], config)
    return failures


def four_card_blocked_chain(devices, seed, N=498, num_events=25,
                            max_copy_number=12):
    """One chain the length of chromosome 1 at the 500 kb grid, blocked
    over the devices, vs the plain chain-batched sweep."""
    sample, data = simulate_sample(seed, N, num_events, 1, max_copy_number)
    config = fit_config(max_copy_number)
    grid = restart_grid(data, config)
    _, spec, params_b, state_b = wave_inputs(sample, grid, config, 1)
    params, state = jax.tree.map(lambda a: a[0], (params_b, state_b))
    sweep = functools.partial(eng.variational_sweep, spec)
    ref = jax.jit(sweep)(params, state)

    num_blocks = len(devices)
    mesh = jax.sharding.Mesh(np.asarray(devices), ('block',))
    par_chain.enable_block_sharding(spec, mesh, num_blocks=num_blocks)
    spec._jit_cache = {}
    with mesh:
        blocked = jax.jit(functools.partial(eng.variational_sweep, spec))(
            params, state)
    diff = float(np.max(np.abs(
        np.asarray(blocked.posterior_marginals, np.float64)
        - np.asarray(ref.posterior_marginals, np.float64))))
    log('chain of {} segments blocked over {} cards vs chain-batched: '
        'posterior max abs diff {:.3e} (bound {:.0e})'.format(
            spec.N, num_blocks, diff, BLOCKED_POSTERIOR_ABS_BOUND))
    require(np.all(np.isfinite(np.asarray(blocked.posterior_marginals))),
            'non-finite blocked posteriors')
    return [] if diff <= BLOCKED_POSTERIOR_ABS_BOUND else [
        'blocked chain differs from the chain-batched sweep']


# ---------------------------------------------------------------------------

def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the multi-device paths on 4 cards')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    device = phase_device(expect_count=4 if args.four_cards else None)
    config = fit_config(FLAGSHIP['max_copy_number'])
    wave = remixt_jax.config.get_param(config, 'restart_chunk_size')
    sample, data = simulate_sample(args.seed, **FLAGSHIP)
    grid = restart_grid(data, config)

    if args.four_cards:
        devices = jax.devices()[:4]
        failures = four_card_grid(sample, grid, config, devices)
        failures += four_card_blocked_chain(devices, args.seed)
        failures += four_card_cohort(
            cohort_samples(sample, data, config, wave, len(devices)),
            dict(config, num_em_iter=2), devices)
        require(not failures, '; '.join(failures))
        device = dict(device, count=len(devices))
    else:
        _, spec, params_b, state_b = phase_compile(sample, grid, config, wave)
        _, _, accuracy = phase_grid_fit(sample, data, grid, config,
                                        (spec, params_b, state_b))
        require(accuracy >= ACCURACY_BOUND,
                'dominant-clone accuracy {} below {}'.format(
                    accuracy, ACCURACY_BOUND))
        phase_reference(sample, grid, config, wave,
                        (spec, params_b, state_b))

    log('nvidia-smi name, power.limit:', accelerator.nvidia_smi())
    print(json.dumps({'ok': True, 'device': device}), flush=True)


if __name__ == '__main__':
    main()
