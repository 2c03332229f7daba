"""Data-prep layer tests: seqdata store roundtrip, segment/allele counting,
haplotype block logic, GC curve fitting.

Patterns from reference test_seqdata.py (write/read roundtrip),
test_haplotype.py (hand-built phasing samples), test strategy SURVEY.md §4.
"""

import numpy as np
import pandas as pd
import pytest

import remixt_jax.seqdataio as seqdataio
import remixt_jax.analysis.segment as segment_mod
import remixt_jax.analysis.haplotype as haplotype_mod
import remixt_jax.analysis.stats as stats_mod
import remixt_jax.analysis.gcbias as gcbias_mod


@pytest.fixture
def seqdata_file(tmp_path):
    rng = np.random.RandomState(0)
    n = 10000
    start = rng.randint(0, int(1e6), size=n)
    length = rng.randint(100, 400, size=n)

    fragments = pd.DataFrame({
        'fragment_id': np.arange(n),
        'start': start,
        'end': start + length,
        'mapping_quality': rng.choice([0, 10, 60], size=n),
        'is_duplicate': rng.choice([0, 1], size=n, p=[0.95, 0.05]),
    })
    alleles = pd.DataFrame({
        'fragment_id': rng.randint(0, n, size=n * 2),
        'position': rng.randint(0, int(1e6), size=n * 2),
        'is_alt': rng.randint(0, 2, size=n * 2),
    })

    path = str(tmp_path / 'seqdata.h5')
    writer = seqdataio.Writer(path)
    # write in two chunks to exercise append with index offsets
    writer.write('1', fragments.iloc[:6000], alleles.iloc[:12000])
    writer.write('1', fragments.iloc[6000:], alleles.iloc[12000:])
    writer.write('2', fragments.iloc[:100], alleles.iloc[:200])
    writer.close()
    return path, fragments, alleles


def test_seqdata_roundtrip(seqdata_file):
    path, fragments, alleles = seqdata_file

    reads = seqdataio.read_fragment_data(path, '1', filter_duplicates=None,
                                         map_qual_threshold=None, keep_cols=True)
    assert len(reads.index) == len(fragments.index)
    np.testing.assert_array_equal(reads['start'].values, fragments['start'].values)

    allele_data = seqdataio.read_allele_data(path, '1')
    assert len(allele_data.index) == len(alleles.index)

    assert seqdataio.read_chromosomes(path) == {'1', '2'}

    # filtering
    filtered = seqdataio.read_fragment_data(path, '1', filter_duplicates=True,
                                            map_qual_threshold=30)
    expected = fragments[(fragments['is_duplicate'] == 0)
                         & (fragments['mapping_quality'] >= 30)]
    assert len(filtered.index) == len(expected.index)

    # chunked reads concatenate to the full table
    chunks = list(seqdataio.read_fragment_data(path, '1', filter_duplicates=None,
                                               map_qual_threshold=None,
                                               chunksize=3000))
    assert sum(len(c.index) for c in chunks) == len(fragments.index)

    # missing chromosome yields the empty schema
    empty = seqdataio.read_fragment_data(path, 'MT')
    assert len(empty.index) == 0


def test_seqdata_merge(seqdata_file, tmp_path):
    path, fragments, alleles = seqdata_file
    merged_path = str(tmp_path / 'merged.h5')
    seqdataio.merge_overlapping_seqdata(merged_path, {'a': path, 'b': path}, ['1', '2'])
    reads = seqdataio.read_fragment_data(merged_path, '1', filter_duplicates=None,
                                         map_qual_threshold=None)
    assert len(reads.index) == 2 * len(fragments.index)
    # fragment ids must remain unique
    allele_data = seqdataio.read_allele_data(merged_path, '1')
    assert allele_data['fragment_id'].max() > alleles['fragment_id'].max()


def test_create_segments_drops_unconfigured_chromosomes(tmp_path):
    """Gap tables carry chrY/chrM/unplaced contigs; their inter-gap
    segments must not leak into the segmentation (the reference's inner
    merge drops them)."""
    import gzip

    fai = tmp_path / 'genome.fa.fai'
    fai.write_text('1\t30000\t0\t60\t61\n2\t20000\t0\t60\t61\n'
                   'Y\t10000\t0\t60\t61\n')
    gap = tmp_path / 'gaps.txt.gz'
    with gzip.open(gap, 'wt') as f:
        # bin chrom start end ix n size type bridge
        f.write('0\t1\t5000\t6000\t0\tN\t1000\ttelomere\tno\n')
        f.write('0\tY\t2000\t3000\t0\tN\t1000\ttelomere\tno\n')
    config = {
        'chromosomes': ['1', '2'],
        'segment_length': 10000,
        'chr_name_prefix': '',
        'gap_table_filename': str(gap),
        'genome_fai_filename': str(fai),
    }
    out = tmp_path / 'segments.tsv'
    segment_mod.create_segments(str(out), config, str(tmp_path))
    seg = pd.read_csv(out, sep='\t', converters={'chromosome': str})
    assert set(seg['chromosome']) == {'1', '2'}
    assert (seg['start'] < seg['end']).all()


def test_seqdata_merge_empty_allele_table(tmp_path):
    """A chromosome group with fragments but zero allele rows must not
    poison the fragment-id offsets of later files (NaN from empty .max())."""
    def build(filename, n):
        writer = seqdataio.Writer(str(filename))
        fragments = pd.DataFrame({
            'fragment_id': np.arange(n),
            'start': np.arange(n) * 10,
            'end': np.arange(n) * 10 + 5,
        })
        alleles = pd.DataFrame(
            columns=['fragment_id', 'position', 'is_alt']).astype(int)
        writer.write('1', fragments, alleles)
        writer.close()
        return str(filename)

    a = build(tmp_path / 'a.h5', 50)
    b = build(tmp_path / 'b.h5', 30)
    merged = str(tmp_path / 'empty_allele_merged.h5')
    seqdataio.merge_overlapping_seqdata(merged, {'a': a, 'b': b}, ['1'])

    reads = seqdataio.read_fragment_data(merged, '1', filter_duplicates=None,
                                         map_qual_threshold=None)
    assert len(reads.index) == 80
    ids = reads['fragment_id'].values
    assert ids.min() >= 0                      # no NaN -> int64 garbage
    assert len(np.unique(ids)) == 80           # ids stay unique


def test_segment_counting(seqdata_file):
    path, fragments, _ = seqdata_file
    segments = pd.DataFrame({
        'chromosome': ['1', '1', '1'],
        'start': [0, 300000, 600000],
        'end': [300000, 600000, 1100000],
    })
    counts = segment_mod.create_segment_counts(
        segments, path, filter_duplicates=False, map_qual_threshold=1)

    reads = fragments[(fragments['mapping_quality'] >= 1)]
    expected = [
        ((reads['start'] >= s) & (reads['end'] <= e)).sum()
        for s, e in zip(segments['start'], segments['end'])
    ]
    np.testing.assert_array_equal(counts['readcount'].values, expected)


def test_fragment_stats(seqdata_file):
    path, fragments, _ = seqdata_file
    stats = stats_mod.calculate_fragment_stats(path, {})
    lengths = []
    for chrom, frac in [('1', 1.0), ('2', 1.0)]:
        reads = seqdataio.read_fragment_data(path, chrom, filter_duplicates=False,
                                             map_qual_threshold=1)
        lengths.append(reads['end'].values - reads['start'].values)
    lengths = np.concatenate(lengths)
    np.testing.assert_allclose(stats.fragment_mean, lengths.mean(), rtol=1e-6)
    np.testing.assert_allclose(stats.fragment_stddev, lengths.std(), rtol=1e-6)


def test_calculate_haplotypes():
    """Hand-built phasing samples (pattern of reference test_haplotype.py:11-34)."""
    positions = [100, 200, 300, 400, 500]
    idx = pd.MultiIndex.from_tuples(
        [('1', p, 'A', 'T') for p in positions],
        names=['chromosome', 'position', 'ref', 'alt'])

    def sample(alleles):
        return pd.DataFrame(
            {'allele1': alleles, 'allele2': [1 - a for a in alleles]}, index=idx)

    # all samples agree: changepoint between position 200 and 300
    samples = [sample([0, 0, 1, 1, 1]) for _ in range(10)]
    haps = haplotype_mod.calculate_haplotypes(iter(samples), changepoint_threshold=0.95)

    assert list(haps['hap_label'].unique()) == [0]
    np.testing.assert_array_equal(haps['allele1'].values, [0, 0, 1, 1, 1])

    # disagreement at the changepoint splits the block
    samples = [sample([0, 0, 1, 1, 1]) for _ in range(5)] \
        + [sample([0, 0, 0, 0, 0]) for _ in range(5)]
    haps = haplotype_mod.calculate_haplotypes(iter(samples), changepoint_threshold=0.95)
    assert haps['hap_label'].nunique() == 2


def test_infer_haps_rejects_bad_chr_prefix(tmp_path):
    """A typo'd chr_name_prefix must raise, not silently phase against the
    wrong 1kg region (reference haplotype.py:365-371)."""
    with pytest.raises(ValueError, match='chr_name_prefix'):
        haplotype_mod.infer_haps_grch38_shapeit4(
            str(tmp_path / 'haps.tsv'), str(tmp_path / 'genotype.tsv'),
            '1', str(tmp_path / 'tmp'), {'chr_name_prefix': 'Chr'},
            str(tmp_path))


def test_infer_snp_genotype():
    data = pd.DataFrame({
        'ref_count': [30, 15, 0, 5],
        'alt_count': [0, 15, 30, 5],
    })
    haplotype_mod.infer_snp_genotype(data, base_call_error=0.005, call_threshold=0.9)
    np.testing.assert_array_equal(data['AA'].values, [1, 0, 0, 0])
    np.testing.assert_array_equal(data['AB'].values, [0, 1, 0, 1])
    np.testing.assert_array_equal(data['BB'].values, [0, 0, 1, 0])


def test_phase_segments():
    def make_counts(major_counts, minor_counts):
        rows = []
        for i, (ma, mi) in enumerate(zip(major_counts, minor_counts)):
            rows.append(('1', 0, 1000, i, 0, ma))
            rows.append(('1', 0, 1000, i, 1, mi))
        return pd.DataFrame(rows, columns=[
            'chromosome', 'start', 'end', 'hap_label', 'allele_id', 'readcount'])

    # library 0 has the stronger allelic imbalance and defines allele a
    t0 = make_counts([100, 90, 80], [10, 20, 15])
    t1 = make_counts([40, 45, 42], [38, 40, 41])

    phased = haplotype_mod.phase_segments(t0, t1)
    assert len(phased) == 2
    for tab in phased:
        assert 'is_allele_a' in tab.columns
    # allele 0 (major in library 0) should be allele a everywhere
    tab0 = phased[0]
    a_calls = tab0[tab0['allele_id'] == 0]['is_allele_a']
    assert (a_calls == 1).all()


def test_lowess_smoke():
    rng = np.random.RandomState(0)
    x = np.arange(101, dtype=float)
    y = np.exp(-(x - 50) ** 2 / 400) + rng.normal(0, 0.02, size=101)
    sm = gcbias_mod.lowess(y, x, frac=0.2)
    assert np.all(np.isfinite(sm))
    # smooth curve should reduce residual variance vs the noisy input
    assert np.std(np.diff(sm)) < np.std(np.diff(y))
    # peak position roughly preserved
    assert abs(int(np.argmax(sm)) - 50) <= 3


def test_gc_lowess_task(tmp_path):
    rng = np.random.RandomState(1)
    n = 5000
    gc = rng.uniform(0.2, 0.8, size=n)
    count = rng.poisson(5 * np.exp(-(gc - 0.45) ** 2 / 0.02))
    samples = pd.DataFrame({
        'chromosome': ['1'] * n,
        'position': np.arange(n),
        'gc': gc,
        'count': count,
    })
    samples_file = str(tmp_path / 'gc_samples.tsv')
    samples.to_csv(samples_file, sep='\t', header=False, index=False)

    dist_file = str(tmp_path / 'gc_dist.tsv')
    table_file = str(tmp_path / 'gc_table.tsv')
    gcbias_mod.gc_lowess(samples_file, dist_file, table_file)

    curve = np.loadtxt(dist_file)
    assert curve.shape[0] == 101
    assert np.nanmax(curve) <= 1.0 + 1e-9
    # curve should peak near gc=0.45
    assert abs(int(np.argmax(curve)) - 45) <= 10


def test_window_gc_fractions_brute_force():
    """Gather-based window GC vs a direct per-position count."""
    rng = np.random.RandomState(4)
    sequence = ''.join(rng.choice(list('ACGT'), size=200))
    fragment_length, offset = 20, 3
    positions = np.array([0, 5, 50, 170, 179, 180, 181, 199])

    got = gcbias_mod._window_gc_fractions(
        sequence, positions, fragment_length, offset)

    window = fragment_length - 2 * offset
    for p, g in zip(positions, got):
        lo, hi = p + offset, p + fragment_length - offset
        if p + fragment_length - offset > len(sequence):
            assert np.isnan(g)
        else:
            expected = sum(c in 'GC' for c in sequence[lo:hi]) / window
            np.testing.assert_allclose(g, expected)


def test_accumulate_matching_counts():
    acc = np.zeros(5, dtype=int)
    positions = np.array([10, 20, 20, 30, 40])
    gcbias_mod._accumulate_matching_counts(
        acc, positions, np.array([20, 20, 20, 30, 99]))
    np.testing.assert_array_equal(acc, [0, 3, 3, 1, 0])


def test_genome_coords_roundtrip():
    coords = gcbias_mod._GenomeCoords({'1': 100, '2': 50, 'X': 25})
    assert coords.total == 175
    positions = np.array([0, 99, 100, 149, 150, 174])
    names, local = coords.split(positions)
    np.testing.assert_array_equal(names, ['1', '1', '2', '2', 'X', 'X'])
    np.testing.assert_array_equal(local, [0, 99, 0, 49, 0, 24])
    sl, loc = coords.local_slice(positions, '2')
    assert (sl.start, sl.stop) == (2, 4)
    np.testing.assert_array_equal(loc, [0, 49])


def test_gc_curve_table_matches_predict(tmp_path):
    rng = np.random.RandomState(6)
    dist_file = str(tmp_path / 'dist.tsv')
    np.savetxt(dist_file, rng.rand(101))
    curve = gcbias_mod.GCCurve()
    curve.read(dist_file)
    for l in (7, 100, 345):
        table = curve.table(l)
        expected = [curve.predict(k / l) for k in range(l + 1)]
        np.testing.assert_allclose(table, expected)


def test_mappability_bedgraph_roundtrip(tmp_path):
    """Synthetic SAM -> bedgraph -> merged store -> indicator array."""
    import remixt_jax.mappability.tasks as map_tasks

    sam = str(tmp_path / 'aln.sam')
    rows = [
        '@SQ\tSN:1\tLN:100',
        # origin-faithful: contiguous qualities 60,60,60 then 10
        '1:0\t0\t1\t1\t60\t5M',
        '1:1\t0\t1\t2\t60\t5M',
        '1:2\t0\t1\t3\t60\t5M',
        '1:3\t0\t1\t4\t10\t5M',
        # gap at 4, then one more at 5
        '1:5\t0\t1\t6\t60\t5M',
        # realigns elsewhere: dropped
        '1:7\t0\t1\t9\t60\t5M',
        # other chromosome
        '2:0\t0\t2\t1\t60\t5M',
    ]
    with open(sam, 'w') as f:
        f.write('\n'.join(rows) + '\n')

    bedgraph = str(tmp_path / 'map.bed')
    map_tasks.create_bedgraph(sam, bedgraph)
    table = pd.read_csv(bedgraph, sep='\t', header=None,
                        names=['chromosome', 'start', 'end', 'quality'],
                        converters={'chromosome': str})
    expected = [('1', 0, 3, 60), ('1', 3, 4, 10), ('1', 5, 6, 60),
                ('2', 0, 1, 60)]
    assert [tuple(r) for r in table.itertuples(index=False)] == expected

    store = str(tmp_path / 'map.h5')
    map_tasks.merge_files_by_line({'only': bedgraph}, store)
    indicator = gcbias_mod.read_mappability_indicator(store, '1', 10, 60)
    np.testing.assert_array_equal(indicator, [1, 1, 1, 0, 0, 1, 0, 0, 0, 0])


def test_split_file_byline(tmp_path):
    import remixt_jax.mappability.tasks as map_tasks

    src = str(tmp_path / 'in.txt')
    with open(src, 'w') as f:
        f.writelines(f'line{i}\n' for i in range(7))
    out_names = []

    def namer(i):
        name = str(tmp_path / f'shard{i}.txt')
        out_names.append(name)
        return name

    map_tasks.split_file_byline(src, 3, namer)
    assert len(out_names) == 3
    contents = [open(n).read() for n in out_names]
    assert contents == ['line0\nline1\nline2\n',
                        'line3\nline4\nline5\n', 'line6\n']
