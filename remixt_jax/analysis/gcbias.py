"""GC and mappability bias model.

Mirrors /root/reference/remixt/analysis/gcbias.py:12-322 — random-position
read-start sampling, LOWESS GC curve (own robust local-linear implementation;
statsmodels is absent here), and the per-segment expected-bias integral over
the fragment-length distribution × GC curve × mappability, which rescales
segment length into the effective length used by the likelihood.
"""

import numpy as np
import pandas as pd
import scipy.stats
import h5py

import remixt_jax.config
import remixt_jax.seqdataio
import remixt_jax.utils


def _param(config, name):
    return remixt_jax.config.get_param(config, name)


def _ref_file(config, ref_data_dir, name):
    return remixt_jax.config.get_filename(config, ref_data_dir, name)


def lowess(y, x, frac=0.2, it=3):
    """Robust locally-weighted linear regression (LOWESS).

    Tricube distance weights over a bandwidth of ``frac`` of the data,
    ``it`` robustifying iterations with bisquare residual weights. Matches
    statsmodels' lowess output closely on smooth binned data (the only use
    here is the 101-bin GC curve).
    """
    x = np.asarray(x, dtype=float)
    y = np.asarray(y, dtype=float)
    n = len(x)
    r = max(int(np.ceil(frac * n)), 2)

    delta = np.ones(n)
    smoothed = np.zeros(n)
    for _ in range(it + 1):
        for i in range(n):
            dist = np.abs(x - x[i])
            idx = np.argsort(dist)[:r]
            dmax = dist[idx].max()
            if dmax == 0:
                smoothed[i] = np.average(y[idx], weights=delta[idx] + 1e-12)
                continue
            w = (1 - (dist[idx] / dmax) ** 3) ** 3
            w = np.clip(w, 0, None) * delta[idx]
            if w.sum() <= 0:
                smoothed[i] = y[i]
                continue
            xw = x[idx]
            # weighted linear fit evaluated at x[i]
            wsum = w.sum()
            xm = (w * xw).sum() / wsum
            ym = (w * y[idx]).sum() / wsum
            cov = (w * (xw - xm) * (y[idx] - ym)).sum()
            var = (w * (xw - xm) ** 2).sum()
            beta = cov / var if var > 0 else 0.0
            smoothed[i] = ym + beta * (x[i] - xm)

        resid = y - smoothed
        s = np.median(np.abs(resid))
        if s <= 0:
            break
        delta = np.clip(resid / (6.0 * s), -1, 1)
        delta = (1 - delta ** 2) ** 2

    return smoothed


class _GenomeCoords(object):
    """Concatenated-genome coordinate frame over an ordered chromosome set.

    Sampled positions live on the concatenation; helpers split a sorted
    position vector per chromosome and map back to (chromosome, offset).
    """

    def __init__(self, chromosome_lengths):
        self.names = list(chromosome_lengths.keys())
        lengths = np.array([chromosome_lengths[c] for c in self.names],
                           dtype=np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(lengths)])
        self.total = int(self.offsets[-1])

    def local_slice(self, sorted_positions, chromosome):
        """(global index slice, chromosome-local positions) of the sorted
        positions falling on one chromosome."""
        i = self.names.index(chromosome)
        lo, hi = np.searchsorted(sorted_positions,
                                 [self.offsets[i], self.offsets[i + 1]])
        return slice(lo, hi), sorted_positions[lo:hi] - self.offsets[i]

    def split(self, sorted_positions):
        """(chromosome name array, local position array)."""
        which = np.searchsorted(self.offsets[1:], sorted_positions,
                                side='right')
        names = np.asarray(self.names, dtype=object)[which]
        return names, sorted_positions - self.offsets[which]


def _window_gc_fractions(sequence, positions, fragment_length,
                         position_offset):
    """GC fraction of each sampled fragment's trimmed window.

    The window spans [pos + offset, pos + fragment_length - offset);
    fragments running past the chromosome end give NaN. Computed by two
    gathers on the chromosome GC cumulative sum rather than a full-genome
    sliding difference (reference gcbias.py:50-72).
    """
    base = np.frombuffer(sequence.upper().encode(), dtype='S1')
    cumsum = np.concatenate(
        [[0], np.cumsum((base == b'G') | (base == b'C'))]).astype(float)

    window = fragment_length - 2 * position_offset
    hi = positions + fragment_length - position_offset
    lo = hi - window
    in_range = hi <= len(base)
    counts = np.full(positions.shape, np.nan)
    counts[in_range] = (cumsum[hi[in_range]] - cumsum[lo[in_range]])
    return counts / float(window)


def _accumulate_matching_counts(accumulator, sorted_positions, starts):
    """Add, per sampled position, how many ``starts`` equal it."""
    unique_starts, start_counts = np.unique(starts, return_counts=True)
    hit = np.searchsorted(unique_starts, sorted_positions)
    matched = (hit < len(unique_starts)) \
        & (unique_starts[np.minimum(hit, len(unique_starts) - 1)]
           == sorted_positions)
    accumulator[matched] += start_counts[hit[matched]]


def sample_gc(gc_samples_filename, seqdata_filename, fragment_length, config,
              ref_data_dir):
    """Random-position GC/read-rate sampling table.

    Draws positions uniformly over the concatenated genome, annotates each
    with the GC fraction of a fragment-sized window and drops unmappable
    or chromosome-end positions, then counts observed read starts at the
    surviving positions (parity: reference gcbias.py:12-129).
    """
    chromosomes = remixt_jax.config.get_chromosomes(config, ref_data_dir)
    coords = _GenomeCoords(
        remixt_jax.config.get_chromosome_lengths(config, ref_data_dir))
    fragment_length = int(fragment_length)
    position_offset = _param(config, 'gc_position_offset')
    mappability_filename = _ref_file(config, ref_data_dir, 'mappability')
    map_qual_threshold = _param(config, 'map_qual_threshold')

    positions = np.sort(np.random.randint(
        0, coords.total, _param(config, 'sample_gc_num_positions')))

    gc_fraction = np.full(positions.shape, np.nan)
    mappable = np.ones(positions.shape)
    for chrom_id, sequence in remixt_jax.utils.read_sequences(
            _ref_file(config, ref_data_dir, 'genome_fasta')):
        if chrom_id not in chromosomes:
            continue
        window, local = coords.local_slice(positions, chrom_id)
        gc_fraction[window] = _window_gc_fractions(
            sequence, local, fragment_length, position_offset)
        indicator = read_mappability_indicator(
            mappability_filename, chrom_id, len(sequence),
            map_qual_threshold)
        mappable[window] *= indicator[local]

    keep = (mappable > 0) & ~np.isnan(gc_fraction)
    positions = positions[keep]
    gc_fraction = gc_fraction[keep]

    read_count = np.zeros(positions.shape, dtype=int)
    for chrom_id in remixt_jax.seqdataio.read_chromosomes(seqdata_filename):
        if chrom_id not in chromosomes:
            continue
        window, local = coords.local_slice(positions, chrom_id)
        for chunk in remixt_jax.seqdataio.read_fragment_data(
                seqdata_filename, chrom_id,
                filter_duplicates=_param(config, 'filter_duplicates'),
                map_qual_threshold=_param(config, 'map_qual_threshold'),
                chunksize=1000000):
            _accumulate_matching_counts(
                read_count[window], local, chunk['start'].values)

    names, local = coords.split(positions)
    pd.DataFrame({
        'chromosome': names,
        'position': local,
        'gc_percent': gc_fraction,
        'read_count': read_count,
    }).to_csv(gc_samples_filename, sep='\t', header=False, index=False)


def gc_lowess(gc_samples_filename, gc_dist_filename, gc_table_filename,
              gc_resolution=100):
    """LOWESS read-rate-vs-GC curve from the sampled-position table.

    Positions are histogrammed into ``gc_resolution + 1`` GC bins with
    np.bincount; the per-bin mean read count is LOWESS-smoothed and the
    whole curve rescaled to unit maximum
    (parity: reference gcbias.py:132-160).
    """
    samples = pd.read_csv(
        gc_samples_filename, sep='\t',
        names=['chromosome', 'position', 'gc', 'count'],
        converters={'chromosome': str})

    num_bins = gc_resolution + 1
    bin_of = np.round(samples['gc'].values * gc_resolution).astype(int)
    occupancy = np.bincount(bin_of, minlength=num_bins).astype(float)
    totals = np.bincount(bin_of, weights=samples['count'].values,
                         minlength=num_bins)
    with np.errstate(invalid='ignore'):
        means = np.where(occupancy > 0, totals / occupancy, 0.0)

    curve = pd.DataFrame({
        'gc_bin': np.arange(num_bins, dtype=float),
        'sum': totals,
        'len': occupancy,
        'mean': means,
    })
    curve['smoothed'] = lowess(means, curve['gc_bin'].values, frac=0.2)
    assert not curve['smoothed'].isnull().any()

    peak = curve['smoothed'].max()
    curve[['mean', 'smoothed']] /= peak

    curve.to_csv(gc_table_filename, sep='\t', index=False)
    curve[['smoothed']].to_csv(gc_dist_filename, sep='\t', index=False,
                               header=False)


def read_mappability_indicator(mappability_filename, chromosome,
                               max_chromosome_length, map_qual_threshold):
    """Per-position mappability indicator from the mappability store
    (gcbias.py:163-175). Store layout: group ``chromosome_X`` with start/end/
    quality datasets (see remixt_jax.mappability.tasks)."""
    with h5py.File(mappability_filename, 'r') as store:
        group = store['chromosome_' + chromosome]
        start = group['start'][()]
        end = group['end'][()]
        quality = group['quality'][()]

    keep = quality >= map_qual_threshold
    # difference-array interval fill: +1 at starts, -1 at ends, positive
    # running sum marks covered positions
    delta = np.zeros(max_chromosome_length + 1, dtype=np.int64)
    np.add.at(delta, np.minimum(start[keep], max_chromosome_length), 1)
    np.add.at(delta, np.minimum(end[keep], max_chromosome_length), -1)
    return (np.cumsum(delta[:-1]) > 0).astype(np.uint8)


def read_gc_cumsum(genome_fasta, chromosome):
    """GC cumulative sum over one chromosome sequence (gcbias.py:178-190)."""
    gc_cumsum = None
    for c, s in remixt_jax.utils.read_sequences(genome_fasta):
        if c == chromosome:
            seq = np.frombuffer(s.upper().encode(), dtype='S1')
            gc_indicator = ((seq == b'G') | (seq == b'C')) * 1
            gc_cumsum = gc_indicator.cumsum()
    return gc_cumsum


class GCCurve(object):
    """Normalized GC weight curve with vectorized window tables.

    ``table(l)`` returns curve weights for every GC count 0..l of an
    l-wide window, by one vectorized index computation (the reference
    evaluates a scalar ``predict`` per count, gcbias.py:193-215).
    """

    def read(self, gc_dist_filename):
        values = np.loadtxt(gc_dist_filename, dtype=float, ndmin=1)
        self.gc_lowess = values / values.sum()
        self.cache = {}

    def predict(self, x):
        bins = len(self.gc_lowess)
        idx = min(max(int(x * (bins - 1)), 0), bins - 1)
        return max(self.gc_lowess[idx], 0.0)

    def table(self, l):
        if l not in self.cache:
            bins = len(self.gc_lowess)
            # same float truncation as predict (k/l evaluated in float)
            idx = np.clip(((np.arange(l + 1) / float(l))
                           * (bins - 1)).astype(int), 0, bins - 1)
            self.cache[l] = np.maximum(self.gc_lowess[idx], 0.0)
        return self.cache[l]


def gc_map_bias(segment_filename, fragment_mean, fragment_stddev,
                gc_dist_filename, bias_filename, config, ref_data_dir):
    """Per-segment GC/mappability bias task (gcbias.py:218-225)."""
    segments = pd.read_csv(segment_filename, sep='\t',
                           converters={'chromosome': str})
    biases = calculate_gc_map_bias(
        segments, fragment_mean, fragment_stddev, gc_dist_filename,
        config, ref_data_dir)
    biases.to_csv(bias_filename, sep='\t', index=False)


def calculate_gc_map_bias(segments, fragment_mean, fragment_stddev,
                          gc_dist_filename, config, ref_data_dir):
    """Expected read-generation bias per segment (gcbias.py:228-259).

    The fragment-length distribution is truncated to its central 98% and
    stepped coarsely; each segment integrates per-position generation
    probabilities over it.
    """
    gc_curve = GCCurve()
    gc_curve.read(gc_dist_filename)

    length_dist = scipy.stats.norm(fragment_mean, fragment_stddev)
    length_lo = int(length_dist.ppf(0.01) - 1.)
    length_hi = int(length_dist.ppf(0.99) + 1.)

    mappability_filename = _ref_file(config, ref_data_dir, 'mappability')
    for chromosome, chrom_seg in segments.groupby('chromosome', sort=False):
        gc_cumsum = read_gc_cumsum(
            _ref_file(config, ref_data_dir, 'genome_fasta'), chromosome)
        mappability = read_mappability_indicator(
            mappability_filename, chromosome, gc_cumsum.shape[0],
            _param(config, 'map_qual_threshold'))

        for idx, (start, end) in chrom_seg[['start', 'end']].iterrows():
            segments.loc[idx, 'bias'] = calculate_segment_gc_map_bias(
                gc_cumsum[start:end], mappability[start:end],
                gc_curve, length_dist, length_lo, length_hi, 10,
                _param(config, 'gc_position_offset'),
                _param(config, 'mappability_length'),
                do_gc=_param(config, 'do_gc_correction'),
                do_map=_param(config, 'do_mappability_correction'))

    return segments


def _fragment_start_probabilities(gc_cumsum, mappability, gc_dist,
                                  fragment_length, position_offset,
                                  read_length, do_gc, do_map):
    """Per-start-position generation probability for one fragment length:
    GC-curve weight of the trimmed fragment window times the mappability of
    both read placements."""
    n_starts = gc_cumsum.shape[0] - fragment_length
    prob = np.ones(n_starts)

    if do_gc:
        window = fragment_length - 2 * position_offset
        window_gc = (
            gc_cumsum[fragment_length - position_offset:-position_offset]
            - gc_cumsum[position_offset:-fragment_length + position_offset])
        prob = prob * gc_dist.table(window)[window_gc]

    if do_map:
        mate_offset = fragment_length - read_length
        prob = prob * (mappability[:-fragment_length]
                       * mappability[mate_offset:-read_length])

    return prob


def calculate_segment_gc_map_bias(gc_cumsum, mappability, gc_dist,
                                  fragment_dist, fragment_min, fragment_max,
                                  fragment_step, position_offset, read_length,
                                  do_gc=True, do_map=True):
    """Expected read-generation bias of one segment: the integral over the
    fragment-length distribution of summed per-position probabilities
    (parity: reference gcbias.py:262-302)."""
    bias = 0.
    for fragment_length in range(fragment_min, fragment_max + 1,
                                 fragment_step):
        if fragment_length < read_length or (
                fragment_length >= gc_cumsum.shape[0]):
            continue
        start_probs = _fragment_start_probabilities(
            gc_cumsum, mappability, gc_dist, fragment_length,
            position_offset, read_length, do_gc, do_map)
        bias += fragment_dist.pdf(fragment_length) * start_probs.sum()
    return bias


def calculate_biased_length(segments):
    """Rescale segment length by normalized bias (gcbias.py:305-314)."""
    segments['bias'] /= segments['bias'].sum()
    segments['length'] = segments['bias'] * float(
        (segments['end'] - segments['start']).sum())
    return segments


def biased_length(length_filename, bias_filename):
    """Biased segment length task (gcbias.py:317-322)."""
    segments = pd.read_csv(bias_filename, sep='\t', converters={'chromosome': str})
    segments = calculate_biased_length(segments)
    segments.to_csv(length_filename, sep='\t', index=False)
