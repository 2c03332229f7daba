"""Experiment assembly: count table + breakpoint predictions -> model inputs.

Capability parity with the reference experiment builder
(/root/reference/remixt/analysis/experiment.py:8-422): map each predicted
breakend to the closest segment extremity of matching chromosome and
strand (within ``max_brk_dist`` summed over both ends), derive wild-type
adjacencies (same-chromosome neighbours with gap at most ``max_seg_gap``),
drop events that mimic wild-type adjacencies or loop back onto a single
extremity, and expose the count matrix ``x``, lengths ``l``, adjacency
set, chains, and breakpoint dictionary the inference engine consumes,
plus the output cn/brk_cn table builders.

The matcher here is a single vectorized pass: segment extremities and
breakends are keyed by a composite integer ``(chromosome, strand) * 2^42
+ position`` so one ``searchsorted`` against the sorted extremity keys
resolves every breakend at once — bucket boundaries fall out of the key
comparison rather than a per-(chromosome, strand) loop.
"""

import pickle

import numpy as np
import pandas as pd

from remixt_jax.segalg import composite_keys as _composite_keys


def match_breakends_to_extremities(segment_data, breakpoint_data):
    """Vectorized nearest-extremity assignment for every predicted breakend.

    Each segment contributes two extremities: its start (strand '-',
    segment_side 0) and its end (strand '+', segment_side 1).  A breakend
    may only match an extremity on the same chromosome and strand.

    Returns a DataFrame with one row per breakend: ``prediction_id``,
    ``prediction_side`` (0/1), ``segment_idx``, ``segment_side``, and the
    absolute ``dist`` to the matched extremity; breakends with no
    same-bucket extremity are omitted.

    Parity: reference analysis/experiment.py:38-121
    (find_closest_segment_end).
    """
    n_seg = len(segment_data.index)
    n_bp = len(breakpoint_data.index)
    empty = pd.DataFrame(columns=[
        'prediction_id', 'prediction_side', 'segment_idx', 'segment_side',
        'dist'])
    if n_seg == 0 or n_bp == 0:
        return empty

    # shared chromosome coding across segments and both breakend columns
    all_chroms = pd.concat([
        segment_data['chromosome'].astype(str),
        breakpoint_data['chromosome_1'].astype(str),
        breakpoint_data['chromosome_2'].astype(str),
    ], ignore_index=True)
    chrom_codes, _ = pd.factorize(all_chroms)
    seg_chrom = chrom_codes[:n_seg]
    be_chrom = np.stack([
        chrom_codes[n_seg:n_seg + n_bp],
        chrom_codes[n_seg + n_bp:],
    ], axis=1)

    # extremity table: [all starts (side 0); all ends (side 1)]
    ext_pos = np.concatenate([
        segment_data['start'].values, segment_data['end'].values,
    ]).astype(np.int64)
    ext_side = np.repeat(np.array([0, 1]), n_seg)
    ext_seg = np.tile(np.arange(n_seg), 2)
    # bucket = chromosome * 2 + strand, where strand '+' <=> side 1
    ext_bucket = np.tile(seg_chrom, 2) * 2 + ext_side
    ext_keys = _composite_keys(ext_bucket, ext_pos)
    order = np.argsort(ext_keys, kind='stable')
    sorted_keys = ext_keys[order]

    # breakend long-format arrays, two rows per prediction
    be_pos = np.concatenate([
        breakpoint_data['position_1'].values,
        breakpoint_data['position_2'].values,
    ]).astype(np.int64)
    be_strand = np.concatenate([
        (breakpoint_data['strand_1'].values == '+'),
        (breakpoint_data['strand_2'].values == '+'),
    ]).astype(np.int64)
    be_bucket = np.concatenate([be_chrom[:, 0], be_chrom[:, 1]]) * 2 + be_strand
    be_keys = _composite_keys(be_bucket, be_pos)

    # nearest sorted extremity: candidates at the insertion point and one
    # before it; a candidate only counts if it shares the bucket
    insert = np.searchsorted(sorted_keys, be_keys)
    best_idx = np.full(len(be_keys), -1)
    best_dist = np.full(len(be_keys), np.iinfo(np.int64).max, dtype=np.int64)
    for cand in (np.clip(insert - 1, 0, len(order) - 1),
                 np.clip(insert, 0, len(order) - 1)):
        flat = order[cand]
        same_bucket = ext_bucket[flat] == be_bucket
        dist = np.abs(ext_pos[flat] - be_pos)
        better = same_bucket & (dist < best_dist)
        best_idx = np.where(better, flat, best_idx)
        best_dist = np.where(better, dist, best_dist)

    matched = best_idx >= 0
    prediction_ids = np.tile(breakpoint_data['prediction_id'].values, 2)
    prediction_side = np.repeat(np.array([0, 1]), n_bp)
    return pd.DataFrame({
        'prediction_id': prediction_ids[matched],
        'prediction_side': prediction_side[matched],
        'segment_idx': ext_seg[best_idx[matched]],
        'segment_side': ext_side[best_idx[matched]],
        'dist': best_dist[matched],
    })


def get_wild_type_adjacencies(segment_data, max_seg_gap):
    """Set of (idx, idx+1) pairs of same-chromosome neighbours whose gap is
    at most ``max_seg_gap`` (parity: reference analysis/experiment.py:124-143)."""
    chrom = segment_data['chromosome'].values
    gap = segment_data['start'].values[1:] - segment_data['end'].values[:-1]
    adjacent = (chrom[1:] == chrom[:-1]) & (gap <= max_seg_gap)
    return set((int(i), int(i) + 1) for i in np.flatnonzero(adjacent))


def _encode_pairs(a, b, base):
    return np.asarray(a, dtype=np.int64) * base + np.asarray(b, dtype=np.int64)


def create_breakpoint_segment_table(segment_data, breakpoint_data, adjacencies,
                                    max_brk_dist=2000):
    """Resolve breakpoint predictions to segment-extremity pairs.

    Keeps predictions whose two breakends both matched extremities with
    total distance at most ``max_brk_dist``; drops events that mimic a
    wild-type adjacency and loop-back inversions onto a single extremity.
    All filters run as vectorized masks.

    Parity: reference analysis/experiment.py:146-216.
    """
    columns = ['prediction_id', 'n_1', 'side_1', 'n_2', 'side_2']
    matched = match_breakends_to_extremities(segment_data, breakpoint_data)
    if len(matched.index) == 0:
        return pd.DataFrame(columns=columns)

    # wide layout: one row per prediction with both ends resolved
    wide = matched.pivot(
        index='prediction_id', columns='prediction_side',
        values=['segment_idx', 'segment_side', 'dist'])
    wide = wide.reindex(columns=pd.MultiIndex.from_product(
        [['segment_idx', 'segment_side', 'dist'], [0, 1]])).dropna()
    if len(wide.index) == 0:
        return pd.DataFrame(columns=columns)

    n = wide['segment_idx'].values.astype(np.int64)
    side = wide['segment_side'].values.astype(np.int64)
    dist = wide['dist'].values

    keep = dist.sum(axis=1) <= max_brk_dist

    # events indistinguishable from a wild-type junction
    n_base = np.int64(len(segment_data.index) + 1)
    adj_codes = np.sort(np.fromiter(
        (_encode_pairs(a, b, n_base) for a, b in adjacencies),
        dtype=np.int64, count=len(adjacencies)))
    fwd = _encode_pairs(n[:, 0], n[:, 1], n_base)
    rev = _encode_pairs(n[:, 1], n[:, 0], n_base)
    keep &= ~(np.isin(fwd, adj_codes) & (side[:, 0] == 1) & (side[:, 1] == 0))
    keep &= ~(np.isin(rev, adj_codes) & (side[:, 1] == 1) & (side[:, 0] == 0))

    # loop-back onto one extremity is unsupported
    keep &= ~((n[:, 0] == n[:, 1]) & (side[:, 0] == side[:, 1]))

    return pd.DataFrame({
        'prediction_id': wide.index.values[keep],
        'n_1': n[keep, 0],
        'side_1': side[keep, 0],
        'n_2': n[keep, 1],
        'side_2': side[keep, 1],
    })


def convert_breakpoints_to_dict(breakpoint_segment_data):
    """{prediction_id: frozenset((n, side), (n, side))} view of the table."""
    return {
        pid: frozenset([(n1, s1), (n2, s2)])
        for pid, n1, s1, n2, s2 in zip(
            breakpoint_segment_data['prediction_id'].values,
            breakpoint_segment_data['n_1'].values,
            breakpoint_segment_data['side_1'].values,
            breakpoint_segment_data['n_2'].values,
            breakpoint_segment_data['side_2'].values)
    }


class Experiment(object):
    """Binds a read-count table to resolved breakpoint predictions.

    Parity: reference analysis/experiment.py:244-320.
    """

    _BREAKPOINT_COLUMNS = [
        'prediction_id',
        'chromosome_1', 'strand_1', 'position_1',
        'chromosome_2', 'strand_2', 'position_2',
    ]

    def __init__(self, count_data, breakpoint_data=None, max_brk_dist=2000,
                 max_seg_gap=int(3e6)):
        if breakpoint_data is None:
            breakpoint_data = pd.DataFrame(columns=self._BREAKPOINT_COLUMNS)
        breakpoint_data = breakpoint_data[self._BREAKPOINT_COLUMNS]

        # only predictions joining modelled chromosomes are resolvable
        modelled = set(count_data['chromosome'].unique())
        on_modelled = (
            breakpoint_data['chromosome_1'].isin(modelled)
            & breakpoint_data['chromosome_2'].isin(modelled))
        self.breakpoint_data = breakpoint_data[on_modelled]

        self.count_data = count_data.reset_index(drop=True).reset_index()

        self.adjacencies = get_wild_type_adjacencies(self.count_data, max_seg_gap)

        self.breakpoint_segment_data = create_breakpoint_segment_table(
            self.count_data, self.breakpoint_data, self.adjacencies,
            max_brk_dist=max_brk_dist).merge(
                self.breakpoint_data, on='prediction_id')

    @property
    def segment_chromosome_id(self):
        return self.count_data['chromosome'].values

    @property
    def segment_start(self):
        return self.count_data['start'].values

    @property
    def segment_end(self):
        return self.count_data['end'].values

    @property
    def segment_major_is_allele_a(self):
        return self.count_data['major_is_allele_a'].values

    @property
    def x(self):
        return self.count_data[
            ['major_readcount', 'minor_readcount', 'readcount']].values

    @property
    def l(self):
        return self.count_data['length'].values

    @property
    def breakpoints(self):
        return convert_breakpoints_to_dict(self.breakpoint_segment_data)

    @property
    def chains(self):
        """(start, end) half-open runs of consecutively adjacent segments."""
        n = len(self.count_data.index)
        cut_after = [idx + 1 for idx in range(n - 1)
                     if (idx, idx + 1) not in self.adjacencies]
        bounds = [0] + cut_after + [n]
        return zip(bounds[:-1], bounds[1:])


def create_experiment(count_filename, breakpoint_filename, experiment_filename,
                      max_brk_dist=2000, min_length=None):
    """Read count/breakpoint TSVs, build an Experiment, pickle it
    (parity: reference analysis/experiment.py:228-241)."""
    count_data = pd.read_csv(
        count_filename, sep='\t', converters={'chromosome': str})
    if min_length is not None:
        count_data = count_data[count_data['length'] > min_length]

    breakpoint_data = pd.read_csv(
        breakpoint_filename, sep='\t',
        converters={'chromosome_1': str, 'chromosome_2': str})

    experiment = Experiment(
        count_data, breakpoint_data, max_brk_dist=max_brk_dist)

    with open(experiment_filename, 'wb') as f:
        pickle.dump(experiment, f)


# ---------------------------------------------------------------------------
# output tables
# ---------------------------------------------------------------------------

def create_segment_table(experiment):
    """Per-segment observation table with empirical depths
    (parity: reference analysis/experiment.py:323-351)."""
    x = experiment.x
    l = experiment.l
    with np.errstate(invalid='ignore', divide='ignore'):
        allele_ratio = np.nan_to_num(x[:, 1] / (x[:, 0] + x[:, 1]))

    table = pd.DataFrame({
        'chromosome': experiment.segment_chromosome_id,
        'start': experiment.segment_start,
        'end': experiment.segment_end,
        'length': l,
        'major_readcount': x[:, 0],
        'minor_readcount': x[:, 1],
        'readcount': x[:, 2],
        'allele_ratio': allele_ratio,
        'major_depth': x[:, 2] * (1. - allele_ratio) / l,
        'minor_depth': x[:, 2] * allele_ratio / l,
        'total_depth': x[:, 2] / l,
    })
    # both the analysis Experiment and the simulation Experiment flow
    # through here; only some carry the phasing indicator
    try:
        table['major_is_allele_a'] = experiment.segment_major_is_allele_a
    except (AttributeError, KeyError):
        pass
    return table


def create_cn_table(experiment, cn, h, phi=None):
    """Inferred copy-number results table: per-clone calls, raw (depth-
    implied) copy numbers, and expected depths/counts under the model
    (parity: reference analysis/experiment.py:354-394)."""
    table = create_segment_table(experiment)

    M = cn.shape[1]
    for m in range(M):
        table['major_{}'.format(m)] = cn[:, m, 0]
        table['minor_{}'.format(m)] = cn[:, m, 1]

    h_tumour = h[1:].sum()
    for allele, name in ((0, 'major'), (1, 'minor')):
        depth_e = cn[:, :, allele] @ h
        table[name + '_raw'] = (
            table[name + '_depth'] - cn[:, 0, allele] * h[0]) / h_tumour
        table[name + '_depth_e'] = depth_e
        table[name + '_e'] = depth_e * experiment.l
        table[name + '_raw_e'] = (depth_e - cn[:, 0, allele] * h[0]) / h_tumour

    table['total_depth_e'] = cn.sum(axis=-1) @ h
    table['total_e'] = table['total_depth_e'] * experiment.l

    if M > 2:
        table['major_diff'] = np.abs(table['major_1'] - table['major_2'])
        table['minor_diff'] = np.abs(table['minor_1'] - table['minor_2'])

    return table


def create_brk_cn_table(brk_cn, breakpoint_segment_data):
    """Breakpoint copy-number results joined back onto prediction info
    (parity: reference analysis/experiment.py:397-422)."""
    if len(brk_cn) == 0:
        return pd.DataFrame(columns=['prediction_id'])

    table = pd.DataFrame.from_dict(brk_cn, orient='index')
    table.columns = ['cn_{}'.format(m) for m in table.columns]
    table.index.name = 'prediction_id'
    return table.reset_index().merge(
        breakpoint_segment_data, on='prediction_id').fillna(0.)
