"""Simulation tasks and the accuracy-evaluation suite.

Capability parity with the reference simulation pipeline
(/root/reference/remixt/simulations/pipeline.py:16-840): simulation
definition parsing and expansion, genome-mixture / experiment / read
simulation and resampling tasks, and the benchmark metrics the project is
judged on — length-weighted segment copy-number accuracy
(``proportion_cn_correct`` and friends), breakpoint copy-number accuracy
against the cycle-minimized truth, mixture-fraction recovery, and
outlier-call accuracy — plus per-store evaluation and merge tasks.

Evaluation here is organized around small tidy comparison frames: truth
and prediction are aligned once on the segment overlap index
(`segalg.reindex_segments`) or on ``prediction_id``, and every metric is
a length-weighted reduction over that aligned frame.
"""

import collections
import hashlib
import itertools
import pickle

import numpy as np
import pandas as pd
import yaml

import remixt_jax.config
import remixt_jax.segalg
import remixt_jax.cn_plot
from remixt_jax.io.hdf5 import HDFStore
import remixt_jax.simulations.genome as sim_genome
import remixt_jax.simulations.haplotype
import remixt_jax.simulations.seqread


def _load_pickle(filename):
    with open(filename, 'rb') as f:
        return pickle.load(f)


def _dump_pickle(obj, filename):
    with open(filename, 'wb') as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------------------
# simulation definitions
# ---------------------------------------------------------------------------

def _expand_setting_grid(settings):
    """Cartesian product over per-key value lists; a tuple key ties several
    parameters to vary together."""
    keys = list(settings.keys())
    combos = itertools.product(*(settings[k] for k in keys))
    for combo in combos:
        expanded = {}
        for key, value in zip(keys, combo):
            if isinstance(key, tuple):
                if len(key) != len(value):
                    raise ValueError(
                        'tied setting {} needs {} values'.format(key, len(key)))
                expanded.update(zip(key, value))
            else:
                expanded[key] = value
        yield expanded


def read_sim_defs(sim_defs_filename):
    """Parse a python-syntax simulation definition file into a dict of
    per-instance settings (parity: reference simulations/pipeline.py:16-71).

    Each ``<name>_settings`` dict in the file is a grid of value lists; the
    grid expands to instances overlaid on ``defaults``, each given a
    content-hashed ``sim_id``.
    """
    namespace = {}
    with open(sim_defs_filename) as f:
        exec(f.read(), {}, namespace)
    defaults = namespace['defaults']

    instances = {}
    for name, settings in namespace.items():
        if not name.endswith('_settings'):
            continue
        base_name = name[:-len('_settings')]
        for expanded in _expand_setting_grid(settings):
            sim = dict(defaults)
            sim.update(expanded)
            sim['name'] = base_name
            # a stable digest: Python's built-in hash() is salted per
            # process, which would re-key every output directory on rerun
            content = '\0'.join(sorted(
                '{}={}'.format(k, v) for k, v in sim.items()))
            content_hash = hashlib.sha1(
                content.encode('utf-8')).hexdigest()[:16]
            sim['sim_hash'] = content_hash
            sim['sim_id'] = '{}_{}'.format(base_name, content_hash)
            if sim['sim_id'] in instances:
                raise ValueError('duplicate simulation {}'.format(sim['sim_id']))
            instances[sim['sim_id']] = sim
    return instances


def create_simulations(sim_defs_filename, config, ref_data_dir):
    """Expand a YAML simulation definition into per-instance parameter
    dicts (parity: reference simulations/pipeline.py:74-124).

    Each simulation block contributes ``num_simulations`` parameter sets
    (scalar values broadcast; list values must match) replicated
    ``num_replicates`` times with consecutive random seeds.
    """
    sim_defs = yaml.safe_load(open(sim_defs_filename))

    ref_chrom_lengths = None
    if ref_data_dir is not None:
        ref_chrom_lengths = remixt_jax.config.get_chromosome_lengths(
            config, ref_data_dir)

    instances = {}
    for sim_name, block in sim_defs['simulations'].items():
        num_sims = block['num_simulations']
        num_reps = block['num_replicates']

        # broadcast every setting to one value per simulation index
        per_sim = {}
        for key, value in block.items():
            if key == 'num_simulations':
                continue
            values = value if isinstance(value, (list, tuple)) else [value]
            if len(values) == 1:
                values = list(values) * num_sims
            if len(values) != num_sims:
                raise TypeError('sim config length mismatch for {}, {}'.format(
                    sim_name, key))
            per_sim[key] = values

        seed = block['random_seed_start']
        for sim_idx in range(num_sims):
            for rep_idx in range(num_reps):
                params = dict(sim_defs['defaults'])
                params.update(
                    {key: values[sim_idx] for key, values in per_sim.items()})
                params['random_seed'] = seed
                instances['{}_{}_{}'.format(sim_name, sim_idx, rep_idx)] = params
                seed += 1

    for params in instances.values():
        if 'chromosome_lengths' not in params:
            if ref_chrom_lengths is None:
                raise ValueError(
                    'chromosome_lengths required in sim defs when no '
                    'ref_data_dir is provided')
            chromosomes = params.get(
                'chromosomes', [str(a) for a in range(1, 23)])
            params['chromosome_lengths'] = {
                c: ref_chrom_lengths[c] for c in chromosomes}
        params.setdefault(
            'chromosomes', list(params['chromosome_lengths'].keys()))

    return instances


# ---------------------------------------------------------------------------
# simulation tasks
# ---------------------------------------------------------------------------

def _build_samplers(params):
    history = sim_genome.RearrangementHistorySampler(params)
    return (
        sim_genome.GenomeCollectionSampler(history, params),
        sim_genome.GenomeMixtureSampler(params),
        sim_genome.ExperimentSampler(params),
    )


def simulate_genome_mixture(mixture_filename, mixture_plot_filename, params):
    """Sample a genome collection + mixture and pickle it
    (parity: reference simulations/pipeline.py:127-141)."""
    collection_sampler, mixture_sampler, _ = _build_samplers(params)
    np.random.seed(params['random_seed'])
    mixture = mixture_sampler.sample_genome_mixture(
        collection_sampler.sample_genome_collection())
    _dump_pickle(mixture, mixture_filename)
    if mixture_plot_filename is not None:
        remixt_jax.cn_plot.plot_mixture(mixture_plot_filename, mixture_filename)


def simulate_experiment(experiment_filename, experiment_plot_filename, params):
    """Sample a full count-level experiment and pickle it
    (parity: reference simulations/pipeline.py:144-160)."""
    collection_sampler, mixture_sampler, experiment_sampler = (
        _build_samplers(params))
    np.random.seed(params['random_seed'])
    mixture = mixture_sampler.sample_genome_mixture(
        collection_sampler.sample_genome_collection())
    experiment = experiment_sampler.sample_experiment(mixture)
    _dump_pickle(experiment, experiment_filename)
    if experiment_plot_filename is not None:
        remixt_jax.cn_plot.plot_experiment(
            experiment_plot_filename, experiment_filename)


def simulate_germline_alleles(germline_alleles_filename, params, config,
                              ref_data_dir):
    """Sample germline haplotypes per chromosome into an HDF5 store
    (parity: reference simulations/pipeline.py:163-170)."""
    np.random.seed(params['random_seed'])
    import h5py
    with h5py.File(germline_alleles_filename, 'w') as store:
        for chromosome in params['chromosomes']:
            table = remixt_jax.simulations.haplotype.create_sim_alleles(
                chromosome, config, ref_data_dir)
            group = store.create_group('chromosome_{}'.format(chromosome))
            for col in table.columns:
                # pandas string columns (ArrowStringArray / object) have no
                # native HDF5 dtype; encode as fixed-width bytes (decoded
                # on load)
                values = np.asarray(table[col].values)
                if values.dtype.kind in ('O', 'U'):
                    values = values.astype('S')
                group.create_dataset(
                    col, data=values,
                    compression='gzip', compression_opts=4)


def load_germline_alleles(germline_alleles_filename, chromosome):
    """Read one chromosome's germline allele table."""
    import h5py
    with h5py.File(germline_alleles_filename, 'r') as store:
        group = store['chromosome_{}'.format(chromosome)]
        data = {}
        for col in group:
            values = group[col][()]
            if values.dtype.kind == 'S':
                values = values.astype(str)
            data[col] = values
        return pd.DataFrame(data)


class _GermlineAllelesAccessor(object):
    """Mapping-style access ('/chromosome_X') over the germline alleles h5."""

    def __init__(self, filename):
        self.filename = filename

    def __getitem__(self, key):
        chromosome = key.split('chromosome_')[-1]
        return load_germline_alleles(self.filename, chromosome)


def _read_sim_inputs(mixture_filename, germline_alleles_filename):
    mixture = _load_pickle(mixture_filename)
    alleles = _GermlineAllelesAccessor(germline_alleles_filename)
    return mixture, alleles


def simulate_normal_data(read_data_filename, mixture_filename,
                         germline_alleles_filename, params):
    """(parity: reference simulations/pipeline.py:173-187)"""
    mixture, alleles = _read_sim_inputs(
        mixture_filename, germline_alleles_filename)
    np.random.seed(params['random_seed'])
    remixt_jax.simulations.seqread.simulate_mixture_read_data(
        read_data_filename, [mixture.genome_collection.genomes[0]],
        [params['h_total']], alleles, params)


def resample_normal_data(read_data_filename, source_filename, mixture_filename,
                         germline_alleles_filename, params):
    """(parity: reference simulations/pipeline.py:190-206)"""
    mixture, alleles = _read_sim_inputs(
        mixture_filename, germline_alleles_filename)
    np.random.seed(params['random_seed'])
    remixt_jax.simulations.seqread.resample_mixture_read_data(
        read_data_filename, source_filename,
        [mixture.genome_collection.genomes[0]],
        [params['h_total']], alleles, params)


def simulate_tumour_data(read_data_filename, mixture_filename,
                         germline_alleles_filename, params):
    """(parity: reference simulations/pipeline.py:209-224)"""
    mixture, alleles = _read_sim_inputs(
        mixture_filename, germline_alleles_filename)
    np.random.seed(params['random_seed'])
    remixt_jax.simulations.seqread.simulate_mixture_read_data(
        read_data_filename, mixture.genome_collection.genomes,
        mixture.frac * params['h_total'], alleles, params)


def resample_tumour_data(read_data_filename, source_filename, mixture_filename,
                         germline_alleles_filename, params):
    """(parity: reference simulations/pipeline.py:227-242)"""
    mixture, alleles = _read_sim_inputs(
        mixture_filename, germline_alleles_filename)
    np.random.seed(params['random_seed'])
    remixt_jax.simulations.seqread.resample_mixture_read_data(
        read_data_filename, source_filename,
        mixture.genome_collection.genomes,
        mixture.frac * params['h_total'], alleles, params)


def tabulate_experiment(exp_table_filename, sim_id, experiment_filename):
    """One-row composition summary of a simulated experiment
    (parity: reference simulations/pipeline.py:246-270)."""
    experiment = _load_pickle(experiment_filename)
    collection = experiment.genome_mixture.genome_collection

    row = {
        'sim_id': sim_id,
        'proportion_divergent': (
            collection.length_divergent()
            / float(np.sum(experiment.genome_mixture.l))),
    }
    for idx, genome in enumerate(collection.genomes):
        row['proportion_loh_{}'.format(idx)] = genome.proportion_loh()
        row['proportion_hdel_{}'.format(idx)] = genome.proportion_hdel()
        row['proportion_hlamp_{}'.format(idx)] = genome.proportion_hlamp()

    pd.DataFrame([row]).to_csv(exp_table_filename, sep='\t', index=False)


def merge_tables(output_filename, input_filenames):
    """(parity: reference simulations/pipeline.py:273-283)"""
    merged = pd.concat(
        [pd.read_csv(f, sep='\t', dtype=str) for f in input_filenames.values()],
        ignore_index=True)
    merged.to_csv(output_filename, sep='\t', index=False)


def write_segments(segment_filename, genomes_filename):
    """(parity: reference simulations/pipeline.py:299-311)"""
    collection = _load_pickle(genomes_filename)
    pd.DataFrame({
        'chromosome': collection.segment_chromosome_id,
        'start': collection.segment_start,
        'end': collection.segment_end,
    }).to_csv(segment_filename, sep='\t', index=False, header=True)


def write_perfect_segments(segment_filename, genomes_filename):
    """Segments merged between true copy-number changepoints
    (parity: reference simulations/pipeline.py:314-337)."""
    collection = _load_pickle(genomes_filename)

    cn_changes = np.abs(np.diff(collection.cn, axis=0)).sum(axis=(1, 2)) > 0
    run_id = np.concatenate(([0], np.cumsum(cn_changes)))

    merged = pd.DataFrame({
        'chromosome': collection.segment_chromosome_id,
        'start': collection.segment_start,
        'end': collection.segment_end,
        'run_id': run_id,
    }).groupby(['chromosome', 'run_id'], as_index=False).agg(
        start=('start', 'min'), end=('end', 'max'))

    merged[['chromosome', 'start', 'end']].to_csv(
        segment_filename, sep='\t', index=False, header=True)


def write_breakpoints(breakpoint_filename, mixture_filename):
    """(parity: reference simulations/pipeline.py:340-345)"""
    mixture = _load_pickle(mixture_filename)
    mixture.breakpoint_segment_data.to_csv(
        breakpoint_filename, sep='\t', header=True, index=False)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _weighted_fraction(mask, weights):
    return float((mask * weights).sum()) / float(weights.sum())


def _aligned_cn_arrays(genome_mixture, cn_data_table, order_true, order_pred):
    """Align true and predicted per-clone copy-number arrays on the overlap
    of the true and predicted segmentations.

    Returns (cn_true, cn_pred, overlap_lengths) with clone axes ordered by
    decreasing mixture fraction and allele axes sorted so major >= minor.
    """
    # (N, clones, alleles) truth and prediction in matching layouts
    if 'major_1' in cn_data_table:
        cn_true = genome_mixture.cn[:, 1:, :]
        cn_pred = np.stack([
            np.stack([cn_data_table['major_1'].values,
                      cn_data_table['minor_1'].values], axis=1),
            np.stack([cn_data_table['major_2'].values,
                      cn_data_table['minor_2'].values], axis=1),
        ], axis=1)
    else:
        # total-only callers: compare clone totals with a singleton allele axis
        cn_true = genome_mixture.cn[:, 1:, :].sum(axis=2, keepdims=True)
        cn_pred = np.stack([
            cn_data_table['total_1'].values[:, None],
            cn_data_table['total_2'].values[:, None],
        ], axis=1)

    cn_true = np.sort(cn_true[:, order_true, :], axis=2)[:, :, ::-1]
    cn_pred = np.sort(cn_pred[:, order_pred, :], axis=2)[:, :, ::-1]

    sim_segments = pd.DataFrame({
        'chromosome': genome_mixture.segment_chromosome_id,
        'start': genome_mixture.segment_start,
        'end': genome_mixture.segment_end,
    })
    overlap = remixt_jax.segalg.reindex_segments(sim_segments, cn_data_table)

    return (
        cn_true[overlap['idx_1'].values],
        cn_pred[overlap['idx_2'].values],
        (overlap['end'] - overlap['start']).values,
    )


def evaluate_cn_results(genome_mixture, cn_data_table, order_true, order_pred,
                        allow_swap):
    """Length-weighted segment copy-number accuracy metrics
    (parity: reference simulations/pipeline.py:343-463)."""
    cn_true, cn_pred, lengths = _aligned_cn_arrays(
        genome_mixture, cn_data_table, order_true, order_pred)

    metrics = {}

    if cn_true.shape[1] != cn_pred.shape[1]:
        metrics['proportion_cn_correct'] = -1.
    else:
        exact = (cn_true == cn_pred).all(axis=(1, 2))
        if allow_swap:
            exact |= (cn_true == cn_pred[:, ::-1, :]).all(axis=(1, 2))
        metrics['proportion_cn_correct'] = _weighted_fraction(exact, lengths)

    metrics['proportion_dom_cn_correct'] = _weighted_fraction(
        (cn_true[:, 0, :] == cn_pred[:, 0, :]).all(axis=1), lengths)

    # clonality: does every clone share the dominant clone's copy number
    clonal_true = (cn_true == cn_true[:, :1, :]).all(axis=(1, 2))
    clonal_pred = (cn_pred == cn_pred[:, :1, :]).all(axis=(1, 2))
    metrics['proportion_clonal_correct'] = _weighted_fraction(
        clonal_true == clonal_pred, lengths)
    metrics['proportion_subclonal_correct'] = _weighted_fraction(
        ~clonal_true == ~clonal_pred, lengths)

    # length-weighted ploidies: clone-averaged and per-clone
    for label, cn in (('pred', cn_pred), ('true', cn_true)):
        metrics['{}_ploidy'.format(label)] = _weighted_fraction(
            cn.mean(axis=1).sum(axis=1), lengths)
        for clone in (0, 1):
            metrics['{}_ploidy_{}'.format(label, clone + 1)] = (
                _weighted_fraction(cn[:, clone, :].sum(axis=1), lengths))
        divergent = (cn.max(axis=1) != cn.min(axis=1)).sum(axis=1)
        metrics['{}_proportion_divergent'.format(label)] = (
            _weighted_fraction(divergent, lengths) / 2.)

    return {'cn_evaluation': pd.Series(metrics)}


def _true_breakpoint_table(genome_mixture):
    """Per-prediction truth columns: raw and minimized true copy numbers
    plus balancedness, aligned on prediction_id."""
    collection = genome_mixture.genome_collection
    true_cn = collection.collapsed_breakpoint_copy_number()
    min_cn = collection.collapsed_minimal_breakpoint_copy_number()
    balanced = collection.collapsed_balanced_breakpoints()

    M = genome_mixture.M
    zeros = np.zeros(M)
    rows = {}
    for prediction_id, bp in genome_mixture.detected_breakpoints.items():
        raw = true_cn.get(bp, zeros)
        minimal = min_cn.get(bp, zeros)
        row = {'is_balanced': bp in balanced}
        for m in range(1, M):
            row['true_cn_{}'.format(m)] = raw[m]
            row['min_true_cn_{}'.format(m)] = minimal[m]
        rows[prediction_id] = row
    table = pd.DataFrame.from_dict(rows, orient='index')
    table.index.name = 'prediction_id'
    return table.reset_index()


def evaluate_brk_cn_results(genome_mixture, brk_cn_table, order_true,
                            order_pred, allow_swap):
    """Breakpoint copy-number accuracy against the cycle-minimized truth,
    excluding balanced breakpoints (parity: reference
    simulations/pipeline.py:466-572)."""
    min_true_cols = ['min_true_cn_{}'.format(m)
                     for m in range(1, genome_mixture.M)]
    pred_cols = []
    for m in itertools.count(1):
        col = 'cn_{}'.format(m)
        if col not in brk_cn_table:
            break
        pred_cols.append(col)

    data = genome_mixture.breakpoint_segment_data.merge(
        _true_breakpoint_table(genome_mixture), on='prediction_id')
    data = data.merge(
        brk_cn_table[['prediction_id'] + pred_cols],
        on='prediction_id', how='left').fillna(0.0)
    data = data[~data['is_balanced']]

    cn_true = data[min_true_cols].values[:, order_true]
    cn_pred = data[pred_cols].values[:, order_pred]

    if cn_true.shape[1] != cn_pred.shape[1]:
        correct = -1.
    else:
        correct = (cn_true == cn_pred).all(axis=1)
        if allow_swap:
            correct |= (cn_true == cn_pred[:, ::-1]).all(axis=1)

    data['cn_correct'] = correct
    data['true_present'] = (data[min_true_cols] > 0).any(axis=1)
    data['pred_present'] = (data[pred_cols] > 0).any(axis=1)
    data['true_subclonal'] = (
        (data[min_true_cols] == 0).any(axis=1) & data['true_present'])
    data['pred_subclonal'] = (
        (data[pred_cols] == 0).any(axis=1) & data['pred_present'])

    metrics = {
        'brk_cn_correct_proportion': (
            float(data['cn_correct'].sum()) / float(len(data.index))),
        'brk_cn_present_num_true': float(data['true_present'].sum()),
        'brk_cn_present_num_pos': float(data['pred_present'].sum()),
        'brk_cn_present_num_true_pos': float(
            (data['pred_present'] & data['true_present']).sum()),
        'brk_cn_subclonal_num_true': float(data['true_subclonal'].sum()),
        'brk_cn_subclonal_num_pos': float(data['pred_subclonal'].sum()),
        'brk_cn_subclonal_num_true_pos': float(
            (data['pred_subclonal'] & data['true_subclonal']).sum()),
    }

    return {
        'brk_cn_table': data,
        'brk_cn_evaluation': pd.Series(metrics),
    }


def evaluate_results(genome_mixture, cn_table, brk_cn_table, mix_pred):
    """Full evaluation: order clones by mixture fraction, tolerate clone
    swaps for near-equal mixtures, pad single-clone callers to two clones
    (parity: reference simulations/pipeline.py:575-647)."""
    if len(cn_table.index) == 0 or np.shape(mix_pred)[0] == 0:
        return {
            'brk_cn_evaluation': pd.Series(dtype=float),
            'brk_cn_table': pd.DataFrame(),
            'cn_evaluation': pd.Series(dtype=float),
            'mix_results': pd.Series(dtype=float)}

    cn_table = cn_table.copy()
    brk_cn_table = brk_cn_table.copy()

    # single-tumour-clone callers evaluate as two identical clones
    for a, b in (('major_1', 'major_2'), ('minor_1', 'minor_2'),
                 ('total_1', 'total_2')):
        if a in cn_table and b not in cn_table:
            cn_table[b] = cn_table[a]
    if 'cn_2' not in brk_cn_table:
        brk_cn_table['cn_2'] = brk_cn_table.get(
            'cn_1', pd.Series(dtype=float))

    mix_true = np.asarray(genome_mixture.frac, dtype=float).copy()
    mix_pred = np.asarray(mix_pred, dtype=float).copy()
    if len(mix_pred) == 2:
        mix_pred = np.concatenate([mix_pred, [0.]])

    order_true = np.argsort(mix_true[1:])[::-1]
    order_pred = np.argsort(mix_pred[1:])[::-1]
    mix_true = np.concatenate([mix_true[:1], mix_true[1:][order_true]])
    mix_pred = np.concatenate([mix_pred[:1], mix_pred[1:][order_pred]])

    # near-equal tumour clones are inherently order-ambiguous
    allow_swap = mix_true[1:].min() / mix_true[1:].max() > 0.75

    results = evaluate_cn_results(
        genome_mixture, cn_table, order_true, order_pred, allow_swap)
    results.update(evaluate_brk_cn_results(
        genome_mixture, brk_cn_table, order_true, order_pred, allow_swap))

    results['mix_results'] = pd.Series(dict(
        [('mix_true_{}'.format(i), f) for i, f in enumerate(mix_true)]
        + [('mix_pred_{}'.format(i), f) for i, f in enumerate(mix_pred)]))

    return results


def evaluate_likelihood_results(experiment, cn_data_table):
    """Outlier-call accuracy against the simulated outlier indicators
    (parity: reference simulations/pipeline.py:650-693)."""
    sim_segments = pd.DataFrame({
        'chromosome': experiment.genome_mixture.segment_chromosome_id,
        'start': experiment.genome_mixture.segment_start,
        'end': experiment.genome_mixture.segment_end,
    })
    overlap = remixt_jax.segalg.reindex_segments(sim_segments, cn_data_table)
    lengths = (overlap['end'] - overlap['start']).values

    metrics = {}
    for kind in ('total', 'allele'):
        truth = getattr(experiment, 'is_outlier_' + kind)[
            overlap['idx_1'].values]
        called = (cn_data_table['prob_is_outlier_' + kind] > 0.5).values[
            overlap['idx_2'].values]
        metrics['correct_outlier_{}_proportion'.format(kind)] = (
            _weighted_fraction(truth == called, lengths))

    return {'outlier_evaluation': pd.Series(metrics)}


def evaluate_results_task(evaluation_filename, results_filename,
                          mixture_filename=None, experiment_filename=None,
                          key_prefix=''):
    """Evaluate one results store against simulation truth
    (parity: reference simulations/pipeline.py:694-737)."""
    with HDFStore(results_filename, 'r') as store:
        cn_table = store[key_prefix + '/cn']
        if (key_prefix + '/brk_cn') in store.keys():
            brk_cn_table = store[key_prefix + '/brk_cn']
        else:
            brk_cn_table = pd.DataFrame(
                columns=['prediction_id', 'cn_1', 'cn_2'])
        mix_pred = store[key_prefix + '/mix'].values

    experiment = None
    if mixture_filename is not None:
        mixture = _load_pickle(mixture_filename)
    elif experiment_filename is not None:
        experiment = _load_pickle(experiment_filename)
        mixture = experiment.genome_mixture
    else:
        raise ValueError(
            'either mixture_filename or experiment_filename must be set')

    evaluation = evaluate_results(mixture, cn_table, brk_cn_table, mix_pred)

    if experiment is not None and hasattr(experiment, 'is_outlier_total'):
        evaluation.update(evaluate_likelihood_results(experiment, cn_table))

    with HDFStore(evaluation_filename, 'w') as store:
        for key, data in evaluation.items():
            store['/' + key] = data


def merge_evaluations(merged_filename, sim_defs, evaluation_filenames,
                      key_names):
    """Merge per-simulation/tool evaluations into one store
    (parity: reference simulations/pipeline.py:740-777)."""
    with HDFStore(merged_filename, 'w') as merged:
        merged['/simulations'] = pd.DataFrame(
            list(sim_defs.values()),
            index=pd.Index(list(sim_defs.keys()), name='sim_id'),
        ).reset_index().astype(str)

        gathered = collections.defaultdict(list)
        for key, evaluation_filename in evaluation_filenames.items():
            key = key if isinstance(key, tuple) else (key,)
            with HDFStore(evaluation_filename, 'r') as store:
                for name in ('/cn_evaluation', '/brk_cn_evaluation',
                             '/mix_results', '/outlier_evaluation'):
                    if name not in store.keys():
                        continue
                    row = store[name]
                    for value, col in zip(key, key_names):
                        row[col] = value
                    gathered[name].append(row)
                if '/brk_cn_table' in store.keys():
                    merged['/brk_cn_table/' + '/'.join(map(str, key))] = (
                        store['/brk_cn_table'])

        for name, rows in gathered.items():
            merged[name] = pd.DataFrame(rows)
