"""Fit pipeline: restart enumeration, per-restart fits, solution collation.

Capability parity with the reference fit pipeline
(/root/reference/remixt/analysis/pipeline.py:12-293): the restart grid
(minor-depth modes x tumour mixture fractions, ploidy-filtered with a
common max depth, crossed with divergence weights), the per-restart fit
driver, and collation into the reference's results-HDF5 schema
(``stats``, ``solutions/solution_{i}/{cn,brk_cn,h,mix}``).

Restarts here are cheap traced parameters over one compiled engine
(``fit_many``) rather than the reference's one-32GB-cluster-job-per-
restart fan-out; the grid itself is assembled as a vectorized DataFrame
cross-product.

The device fit path (``fit_many``, ``fit_many_cohort``, ``build_model``,
``_extract_results``) needs only numpy and JAX; pandas, scikit-learn and
h5py are imported by the host-side steps that use them.
"""

import pickle

import numpy as np

import remixt_jax.config
from remixt_jax.models.fit import BreakpointModel, decode_breakpoints_naive


_UNSET = object()


def _load_pickle(filename):
    with open(filename, 'rb') as f:
        return pickle.load(f)


def enumerate_restarts(experiment, config):
    """Build the restart grid as a DataFrame.

    One row per (minor-depth mode, tumour mix fraction, divergence weight)
    surviving the ploidy window, all sharing the smallest per-mode maximum
    modellable depth so restart objectives stay comparable.

    Returns (grid, read_depth_table, minor_modes).
    Parity: reference analysis/pipeline.py:12-109.
    """
    import pandas as pd
    import remixt_jax.analysis.readdepth

    get = lambda name: remixt_jax.config.get_param(config, name)
    min_ploidy, max_ploidy = get('min_ploidy'), get('max_ploidy')
    max_copy_number = get('max_copy_number')

    read_depth = remixt_jax.analysis.readdepth.calculate_depth(experiment)
    minor_modes, mode_masses = remixt_jax.analysis.readdepth.calculate_minor_modes(
        read_depth, return_masses=True)
    h_candidates = remixt_jax.analysis.readdepth.calculate_candidate_h_monoclonal(
        minor_modes, h_normal=get('h_normal'), h_tumour=get('h_tumour'),
        mode_masses=mode_masses,
        normal_mass_tolerance=get('normal_mode_mass_tolerance'))

    modes = pd.DataFrame(
        [(idx, h[0], h[1]) for idx, h in enumerate(h_candidates)],
        columns=['mode_idx', 'h_normal', 'h_tumour'])
    modes['ploidy_estimate'] = [
        remixt_jax.analysis.readdepth.estimate_ploidy(h, experiment)
        for h in h_candidates]
    if not np.isfinite(modes['ploidy_estimate']).all():
        raise ValueError('non-finite ploidy estimate')
    modes['max_depth'] = (
        2. * modes['h_normal']
        + (max_copy_number + 0.25) * modes['h_tumour'])

    # distance to the allowed ploidy window; keep in-window modes, falling
    # back to the nearest modes when the window is empty
    distance = pd.Series(0., index=modes.index)
    if min_ploidy is not None:
        distance = np.maximum(
            distance, (min_ploidy - modes['ploidy_estimate']).clip(lower=0.))
    if max_ploidy is not None:
        distance = np.maximum(
            distance, (modes['ploidy_estimate'] - max_ploidy).clip(lower=0.))
    in_window = distance == 0.
    modes = modes[in_window if in_window.any() else distance == distance.min()]

    grid = (
        modes
        .merge(pd.DataFrame({'mix_frac': get('tumour_mix_fractions')}),
               how='cross')
        .merge(pd.DataFrame({'divergence_weight': get('divergence_weights')}),
               how='cross')
    )
    grid['max_depth'] = modes['max_depth'].min()

    return grid, read_depth, minor_modes


def _check_depth_coverage(experiment, max_depth, min_coverage=0.75):
    """Refuse configurations where too much of the genome exceeds the
    modellable depth (parity: reference analysis/pipeline.py:85-94)."""
    depth = experiment.x[:, 2] / experiment.l
    covered = (
        ((depth <= max_depth) * experiment.l).sum() / experiment.l.sum())
    if covered < min_coverage:
        raise ValueError(
            'Unable to model {} of the genome, consider reducing max ploidy '
            'or increasing max copy number'.format(1. - covered))


def init(init_results_filename, experiment_filename, config):
    """Enumerate restart initializations; persist depth diagnostics.

    Returns {init_id: params dict} with keys mode_idx, h_normal, h_tumour,
    mix_frac, divergence_weight, max_depth.
    """
    import pandas as pd
    from remixt_jax.io.hdf5 import HDFStore

    np.random.seed(config.get('random_seed', 1234))
    experiment = _load_pickle(experiment_filename)

    grid, read_depth, minor_modes = enumerate_restarts(experiment, config)
    _check_depth_coverage(experiment, grid['max_depth'].iloc[0])

    with HDFStore(init_results_filename, 'w') as store:
        store['read_depth'] = read_depth
        store['minor_modes'] = pd.Series(
            minor_modes, index=range(len(minor_modes)))

    columns = ['mode_idx', 'h_normal', 'h_tumour', 'mix_frac',
               'divergence_weight', 'max_depth']
    return {
        init_id: dict(zip(columns, values))
        for init_id, values in enumerate(grid[columns].itertuples(index=False))
    }


def fit_task(results_filename, experiment_filename, init_params, config):
    """Single-restart fit job (parity: reference analysis/pipeline.py:112-124).

    A model snapshot is written after every EM iteration next to the
    results file; a killed job resumes mid-fit from it (reference analog:
    cn_model.py:286-307 _write_model/_read_model). The snapshot is removed
    once results are safely on disk.
    """
    import os

    experiment = _load_pickle(experiment_filename)
    snapshot_filename = results_filename + '.ckpt'
    fit_results = fit(experiment, init_params, config,
                      snapshot_filename=snapshot_filename)
    with open(results_filename, 'wb') as f:
        pickle.dump(fit_results, f)
    if os.path.exists(snapshot_filename):
        os.remove(snapshot_filename)


def fit(experiment, init_params, config, snapshot_filename=None):
    """Fit one restart (parity: reference analysis/pipeline.py:127-228)."""
    from remixt_jax.compile_cache import enable_compilation_cache
    enable_compilation_cache(config)
    model = build_model(experiment, init_params, config)
    return fit_with_model(model, experiment, init_params, config,
                          snapshot_filename=snapshot_filename)


def fit_many(experiment, init_params_dict, config):
    """Fit every restart sharing one model (state space, compiled engine).

    The restart grid shares a common max_depth by construction, so only
    the divergence weight and h initialization vary — both traced
    parameters.  By default the grid fits in batched chunks (all restarts
    of a chunk advance through each VI sweep and EM update together —
    models/fit_batched.py); set ``batch_restarts: false`` for the
    one-restart-at-a-time driver.  Either way this replaces the
    reference's one-32GB-cluster-job-per-restart fan-out.

    Returns {init_id: fit_results}.
    """
    from remixt_jax.compile_cache import enable_compilation_cache
    enable_compilation_cache(config)

    batched = remixt_jax.config.get_param(config, 'batch_restarts') \
        and not config.get('optimal_initialization', False)
    if batched and len(init_params_dict) > 1:
        return _fit_many_batched(experiment, init_params_dict, config)

    results = {}
    model = None
    for init_id, init_params in init_params_dict.items():
        if model is None:
            model = build_model(experiment, init_params, config)
        else:
            model.reset_restart(
                max_depth=init_params['max_depth'],
                divergence_weight=init_params['divergence_weight'])
        results[init_id] = fit_with_model(model, experiment, init_params, config)
    return results


def _restart_h_init(init_params):
    return np.array([
        init_params['h_normal'],
        init_params['h_tumour'] * init_params['mix_frac'],
        init_params['h_tumour'] * (1. - init_params['mix_frac']),
    ])


def _production_mesh(config, num_restarts=None, devices=None):
    """The device mesh for the restart-sharded production fit.

    With more than one local device and
    ``use_device_mesh`` unset or true, devices go on the restart axis
    (restarts are the cheapest parallel axis — fully independent fits,
    SURVEY §2.4) up to the grid size; when the grid is smaller than the
    device count the remainder factors onto the chain axis
    (restart × chain, e.g. R=4 on 8 devices → 4×2) so no device idles on
    restart padding. Single-device hosts run the plain batched driver.
    Replaces the reference's per-restart cluster fan-out
    (/root/reference/remixt/workflow.py:318-340) with zero user action.
    """
    import jax

    if not remixt_jax.config.get_param(config, 'use_device_mesh'):
        return None
    if devices is None:
        devices = jax.devices()
    if len(devices) <= 1:
        return None
    from remixt_jax.parallel import distributed
    return distributed.make_training_mesh(
        devices=devices, num_restarts=num_restarts)


def _fit_many_batched(experiment, init_params_dict, config, mesh=_UNSET):
    """Chunked batched grid fit; same per-restart semantics as the
    sequential driver (see models/fit_batched.py). On multi-device hosts
    the restart batch is sharded over the device mesh (pass ``mesh``
    explicitly to pin a device group — the cohort driver does)."""
    from remixt_jax.models.fit_batched import fit_restarts_batched

    init_ids = list(init_params_dict.keys())
    first = init_params_dict[init_ids[0]]
    model = build_model(experiment, first, config)
    model.breakpoint_init = None

    if mesh is _UNSET:
        mesh = _production_mesh(config, num_restarts=len(init_ids))
    raw = fit_restarts_batched(
        model,
        [_restart_h_init(init_params_dict[i]) for i in init_ids],
        [init_params_dict[i]['divergence_weight'] for i in init_ids],
        chunk_size=remixt_jax.config.get_param(config, 'restart_chunk_size'),
        mesh=mesh)

    results = {}
    for init_id, restart in zip(init_ids, raw):
        model.params = restart['params']
        model.state = restart['state']
        model.prev_elbo = restart['elbo']
        model.prev_elbo_diff = restart['elbo_diff']
        model.divergence_weight = init_params_dict[init_id]['divergence_weight']
        results[init_id] = _extract_results(
            model, experiment, init_params_dict[init_id], config)
    return results


def fit_many_cohort(experiments, init_params_dicts, config):
    """Fit a cohort of samples, each restart grid on its own device group.

    The cohort axis is the outermost parallel dimension (SURVEY §2.4):
    samples are fully independent, so local devices split into
    ``min(samples, devices)`` disjoint groups. Each group has one host
    thread that fits its samples in turn, with every array pinned to the
    group's devices (its mesh, or its one device), so no two fits share a
    device. This replaces the reference's per-``tumour_id`` cluster
    fan-out (/root/reference/remixt/workflow.py:384-391). On multi-host
    runs each process takes its deterministic round-robin share of the
    cohort (parallel/distributed.cohort_partition) and returns results
    only for that share.

    Per-sample results are identical to sequential ``fit_many`` calls:
    groups share no devices and each sample's model/spec/RNG state is
    thread-local.

    Args:
        experiments: {sample_id: Experiment}
        init_params_dicts: {sample_id: {init_id: params dict}}
        config: standard config overlay

    Returns {sample_id: {init_id: fit_results}} for this host's share.
    """
    import jax
    from concurrent.futures import ThreadPoolExecutor

    from remixt_jax.compile_cache import enable_compilation_cache
    from remixt_jax.parallel import distributed

    enable_compilation_cache(config)

    sample_ids = distributed.cohort_partition(list(experiments.keys()))
    devices = jax.devices()
    n_groups = max(1, min(len(sample_ids), len(devices)))
    groups = [list(g) for g in np.array_split(np.asarray(devices), n_groups)]

    batched = remixt_jax.config.get_param(config, 'batch_restarts') \
        and not config.get('optimal_initialization', False)
    if len(sample_ids) <= 1 or len(devices) <= 1 or not batched or not \
            remixt_jax.config.get_param(config, 'use_cohort_sharding'):
        return {sid: fit_many(
            experiments[sid], init_params_dicts[sid],
            remixt_jax.config.get_sample_config(config, sid))
                for sid in sample_ids}

    def fit_group(group, group_sample_ids):
        out = {}
        # arrays created without an explicit device land on the group's
        # first device; a multi-device group also shards over its mesh
        with jax.default_device(group[0]):
            for sid in group_sample_ids:
                sample_config = remixt_jax.config.get_sample_config(
                    config, sid)
                init_params_dict = init_params_dicts[sid]
                mesh = _production_mesh(
                    sample_config, num_restarts=len(init_params_dict),
                    devices=group)
                out[sid] = _fit_many_batched(
                    experiments[sid], init_params_dict, sample_config,
                    mesh=mesh)
        return out

    with ThreadPoolExecutor(max_workers=n_groups) as pool:
        futures = [pool.submit(fit_group, group, sample_ids[i::n_groups])
                   for i, group in enumerate(groups)]
        fitted = {}
        for fut in futures:
            fitted.update(fut.result())
    return {sid: fitted[sid] for sid in sample_ids}


def build_model(experiment, init_params, config):
    """Construct the BreakpointModel for a restart's configuration."""
    import jax.numpy as jnp

    get = lambda name: remixt_jax.config.get_param(config, name)
    dtype = {'float32': jnp.float32, 'float64': jnp.float64}[get('engine_dtype')]

    normal_copies = np.ones((experiment.l.shape[0], 2), dtype=int)
    if not get('is_female'):
        on_x = experiment.segment_chromosome_id == 'X'
        normal_copies[on_x] = [1, 0]
        if np.any(experiment.x[on_x, 0:2] > 0):
            raise Exception('inconsistent allele read counts for chromosome X')

    model = BreakpointModel(
        experiment.x,
        experiment.l,
        experiment.adjacencies,
        experiment.breakpoints,
        max_copy_number=get('max_copy_number'),
        normal_contamination=get('normal_contamination'),
        divergence_weight=init_params['divergence_weight'],
        min_segment_length=get('likelihood_min_segment_length'),
        min_proportion_genotyped=get('likelihood_min_proportion_genotyped'),
        max_depth=init_params['max_depth'],
        normal_copies=normal_copies,
        disable_breakpoints=get('disable_breakpoints'),
        do_h_update=get('do_h_update'),
        random_seed=config.get('random_seed', 1234),
        dtype=dtype,
    )
    model.num_em_iter = get('num_em_iter')
    model.num_update_iter = get('num_update_iter')
    return model


def _truth_breakpoint_init(experiment, h_init):
    """Convergence-testing hook: breakpoint posteriors seeded from the
    simulated truth, clone-swapped to match the h initialization."""
    collection = experiment.genome_mixture.genome_collection
    truth = collection.collapsed_breakpoint_copy_number()
    for bp in experiment.genome_mixture.detected_breakpoints.values():
        truth.setdefault(bp, np.zeros((experiment.genome_mixture.M,)))
    if (experiment.h[1] < experiment.h[2]) != (h_init[1] < h_init[2]):
        truth = {bp: np.concatenate([cn[:1], cn[1:][::-1]])
                 for bp, cn in truth.items()}
    return truth


def fit_with_model(model, experiment, init_params, config,
                   snapshot_filename=None):
    """Run one restart on a (possibly shared) model and extract results."""
    h_init = _restart_h_init(init_params)

    model.breakpoint_init = (
        _truth_breakpoint_init(experiment, h_init)
        if config.get('optimal_initialization', False) else None)

    model.fit(h_init, snapshot_filename=snapshot_filename)

    return _extract_results(model, experiment, init_params, config)


def _extract_results(model, experiment, init_params, config):
    """Decode and package one fitted restart's results."""
    cn, brk_cn = model.optimal_cn()
    if remixt_jax.config.get_param(config, 'disable_breakpoints'):
        brk_cn = decode_breakpoints_naive(
            cn, experiment.adjacencies, experiment.breakpoints)

    # length-weighted composition stats over the tumour clones
    l = experiment.l
    tumour_cn = cn[:, 1:, :]
    ploidy = (tumour_cn.mean(axis=1).sum(axis=1) * l).sum() / l.sum()
    divergent = (tumour_cn.max(axis=1) != tumour_cn.min(axis=1)).sum(axis=1)
    proportion_divergent = (divergent * l).sum() / (2. * l.sum())

    stats = dict(model.get_likelihood_param_values())
    stats.update({
        'elbo': model.prev_elbo,
        'elbo_diff': model.prev_elbo_diff,
        'error_message': '',
        'num_clones': len(model.h),
        'num_segments': len(experiment.x),
        'ploidy': ploidy,
        'proportion_divergent': proportion_divergent,
        'mode_idx': init_params['mode_idx'],
        'divergence_weight': init_params['divergence_weight'],
    })

    return {
        'h': model.h,
        'cn': cn,
        'brk_cn': brk_cn,
        'p_outlier_total': model.p_outlier_total,
        'p_outlier_allele': model.p_outlier_allele,
        'total_likelihood_mask': model.total_likelihood_mask,
        'allele_likelihood_mask': model.allele_likelihood_mask,
        'stats': stats,
    }


def store_fit_results(store, experiment, fit_results, key_prefix):
    """Write one solution's tables (parity: reference
    analysis/pipeline.py:231-250)."""
    import pandas as pd
    import remixt_jax.analysis.experiment

    h = fit_results['h']

    cn_table = remixt_jax.analysis.experiment.create_cn_table(
        experiment, fit_results['cn'], h)
    cn_table['prob_is_outlier_total'] = fit_results['p_outlier_total'][:, 1]
    cn_table['prob_is_outlier_allele'] = fit_results['p_outlier_allele'][:, 1]
    cn_table['total_likelihood_mask'] = fit_results['total_likelihood_mask']
    cn_table['allele_likelihood_mask'] = fit_results['allele_likelihood_mask']

    store[key_prefix + '/cn'] = cn_table
    store[key_prefix + '/brk_cn'] = remixt_jax.analysis.experiment.create_brk_cn_table(
        fit_results['brk_cn'], experiment.breakpoint_segment_data)
    store[key_prefix + '/h'] = pd.Series(h, index=range(len(h)))
    store[key_prefix + '/mix'] = pd.Series(h / h.sum(), index=range(len(h)))


def optimal_init_id(init_ids, elbo, proportion_divergent, max_prop_diverge):
    """The chosen solution: highest ELBO among restarts whose divergent
    proportion is below ``max_prop_diverge``, or among all restarts when
    none is (parity: reference analysis/pipeline.py:253-264). Ties go to
    the first restart; NaN ELBOs never win."""
    elbo = np.asarray(elbo, dtype=float)
    candidates = np.asarray(proportion_divergent, dtype=float) \
        < max_prop_diverge
    if not candidates.any():
        candidates = np.ones_like(candidates)
    score = np.where(candidates & ~np.isnan(elbo), elbo, -np.inf)
    return list(init_ids)[int(np.argmax(score))]


def store_optimal_solution(stats, store, config):
    """Alias the best solution (:func:`optimal_init_id`)."""
    best = optimal_init_id(
        stats['init_id'], stats['elbo'], stats['proportion_divergent'],
        remixt_jax.config.get_param(config, 'max_prop_diverge'))

    for table in ('cn', 'mix', 'brk_cn'):
        store['/' + table] = store['/solutions/solution_{}/{}'.format(best, table)]


def collate(collate_filename, experiment_filename, init_results_filename,
            fit_results_filenames, config):
    """Merge per-restart results into the final results store
    (parity: reference analysis/pipeline.py:267-293)."""
    import pandas as pd
    from remixt_jax.io.hdf5 import HDFStore

    all_results = {
        init_id: _load_pickle(filename)
        for init_id, filename in fit_results_filenames.items()}

    stats_table = pd.DataFrame([
        dict(results['stats'], init_id=init_id)
        for init_id, results in all_results.items()])

    experiment = _load_pickle(experiment_filename)

    with HDFStore(collate_filename, 'w') as collated:
        collated['stats'] = stats_table

        with HDFStore(init_results_filename, 'r') as init_store:
            for key in init_store.keys():
                collated[key] = init_store[key]

        for init_id, results in all_results.items():
            store_fit_results(
                collated, experiment, results,
                'solutions/solution_{}'.format(init_id))

        store_optimal_solution(stats_table, collated, config)
