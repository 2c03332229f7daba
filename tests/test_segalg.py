"""Randomized optimized-vs-naive interval algorithm tests (pattern from
reference test_segalg.py:20-40)."""

import numpy as np
import pandas as pd
import pytest

from remixt_jax import segalg


def random_nonoverlapping(rng, n, max_gap=10, max_len=20):
    boundaries = np.cumsum(rng.randint(1, max_gap + max_len, size=2 * n))
    return boundaries.reshape(n, 2)


@pytest.mark.parametrize('seed', range(5))
def test_contained_counts(seed):
    rng = np.random.RandomState(seed)
    X = random_nonoverlapping(rng, 20)
    Y = np.sort(rng.randint(0, X.max() + 10, size=(50, 2)), axis=1)
    Y = Y[np.argsort(Y[:, 0])]
    np.testing.assert_array_equal(
        segalg.contained_counts(X, Y), segalg.contained_counts_unopt(X, Y))


@pytest.mark.parametrize('seed', range(5))
def test_find_contained_positions(seed):
    rng = np.random.RandomState(seed)
    X = random_nonoverlapping(rng, 20)
    Y = rng.randint(0, X.max() + 10, size=30)
    np.testing.assert_array_equal(
        segalg.find_contained_positions(X, Y),
        segalg.find_contained_positions_unopt(X, Y))


@pytest.mark.parametrize('seed', range(5))
def test_find_contained_segments(seed):
    rng = np.random.RandomState(seed)
    X = random_nonoverlapping(rng, 20)
    Y = np.sort(rng.randint(0, X.max() + 10, size=(30, 2)), axis=1)
    np.testing.assert_array_equal(
        segalg.find_contained_segments(X, Y),
        segalg.find_contained_segments_unopt(X, Y))


@pytest.mark.parametrize('seed', range(5))
def test_interval_position_overlap(seed):
    rng = np.random.RandomState(seed)
    intervals = np.sort(rng.randint(0, 200, size=(15, 2)), axis=1)
    positions = np.sort(rng.randint(0, 220, size=40))
    i1, p1 = segalg.interval_position_overlap(intervals, positions)
    i2, p2 = segalg.interval_position_overlap_unopt(intervals, positions)
    order1 = np.lexsort((p1, i1))
    order2 = np.lexsort((p2, i2))
    np.testing.assert_array_equal(i1[order1], i2[order2])
    np.testing.assert_array_equal(p1[order1], p2[order2])


def test_overlapping_counts():
    X = np.array([5, 10, 15, 20, 25])
    Y = np.array([[3, 12], [8, 30], [26, 27]])
    # naive mirror of the reference loop (segalg.py:71-84)
    C = np.zeros(X.shape[0])
    for y in Y:
        for i, x in enumerate(X):
            if y[0] < x < y[1]:
                C[i] += 1
    np.testing.assert_array_equal(segalg.overlapping_counts(X, Y), C)


def test_vrange():
    starts = np.array([1, 3, 4, 6])
    lengths = np.array([0, 2, 3, 0])
    np.testing.assert_array_equal(
        segalg.vrange(starts, lengths), np.array([3, 4, 4, 5, 6]))


def test_reindex_segments():
    cn_1 = pd.DataFrame({
        'chromosome': ['1', '1', '2'],
        'start': [0, 100, 0],
        'end': [100, 200, 50],
    })
    cn_2 = pd.DataFrame({
        'chromosome': ['1', '1'],
        'start': [0, 50],
        'end': [50, 150],
    })
    reseg = segalg.reindex_segments(cn_1, cn_2)
    # common refinement on chromosome 1: [0,50) [50,100) [100,150)
    assert list(reseg['start']) == [0, 50, 100]
    assert list(reseg['end']) == [50, 100, 150]
    assert list(reseg['idx_1']) == [0, 0, 1]
    assert list(reseg['idx_2']) == [0, 1, 1]


def test_reindex_segments_empty():
    empty = pd.DataFrame(columns=['chromosome', 'start', 'end'])
    out = segalg.reindex_segments(empty, empty)
    assert len(out.index) == 0
    assert list(out.columns) == ['chromosome', 'start', 'end', 'idx_1', 'idx_2']


def test_aggregate_adjacent():
    cnv = pd.DataFrame({
        'chromosome': ['1'] * 4,
        'start': [0, 10, 20, 30],
        'end': [10, 20, 30, 40],
        'length': [10.0, 10.0, 30.0, 10.0],
        'major_1': [1, 1, 2, 2],
        'minor_1': [1, 1, 0, 0],
        'major_2': [1, 1, 2, 2],
        'minor_2': [1, 1, 0, 0],
        'major_raw': [1.1, 0.9, 2.2, 1.8],
        'minor_raw': [1.0, 1.0, 0.1, 0.0],
        'major_raw_e': [1.0, 1.0, 2.0, 2.0],
        'minor_raw_e': [1.0, 1.0, 0.0, 0.0],
    })
    agg = segalg.aggregate_adjacent(cnv)
    assert len(agg.index) == 2
    assert list(agg['start']) == [0, 20]
    assert list(agg['end']) == [20, 40]
    # length weighted average of major_raw over the second group
    np.testing.assert_allclose(agg['major_raw'].values[1], (2.2 * 30 + 1.8 * 10) / 40)


def test_breakpoint_database_fuzzy_query():
    import pandas as pd
    from remixt_jax.utils import BreakpointDatabase

    table = pd.DataFrame({
        'prediction_id': ['a', 'b'],
        'chromosome_1': ['1', '1'], 'strand_1': ['+', '+'],
        'position_1': [1000, 5000],
        'chromosome_2': ['2', '1'], 'strand_2': ['-', '-'],
        'position_2': [2000, 9000],
    })
    db = BreakpointDatabase(table)

    exact = {'chromosome_1': '1', 'strand_1': '+', 'position_1': 1000,
             'chromosome_2': '2', 'strand_2': '-', 'position_2': 2000}
    assert db.query(exact, extend=0) == 'a'
    # sides swapped relative to the database entry still match
    swapped = {'chromosome_1': '2', 'strand_1': '-', 'position_1': 2000,
               'chromosome_2': '1', 'strand_2': '+', 'position_2': 1000}
    assert db.query(swapped, extend=0) == 'a'
    # within the fuzzy window
    fuzzy = dict(exact, position_1=1004, position_2=1997)
    assert db.query(fuzzy, extend=0) is None
    assert db.query(fuzzy, extend=5) == 'a'
    # both breakends must belong to the same prediction on opposite sides
    cross = dict(exact, position_1=5000, chromosome_2='2')
    assert db.query(cross, extend=0) is None
    near_b = {'chromosome_1': '1', 'strand_1': '+', 'position_1': 5001,
              'chromosome_2': '1', 'strand_2': '-', 'position_2': 8999}
    assert db.query(near_b, extend=2) == 'b'


def test_match_breakpoints_fuzzy():
    import pandas as pd
    from remixt_jax.analysis.breakpoints import match_breakpoints

    def bp_table(rows):
        return pd.DataFrame(rows, columns=[
            'prediction_id', 'chromosome_1', 'strand_1', 'position_1',
            'chromosome_2', 'strand_2', 'position_2'])

    bp1 = bp_table([
        ('p1', '1', '+', 1000, '2', '-', 5000),
        ('p2', '1', '+', 9000, '1', '-', 12000),
    ])
    bp2 = bp_table([
        # matches p1 with both ends shifted within range
        ('q1', '1', '+', 1100, '2', '-', 4950),
        # one end out of range of p2
        ('q2', '1', '+', 9100, '1', '-', 13000),
        # wrong strand on one end
        ('q3', '1', '-', 1000, '2', '-', 5000),
    ])

    matched = match_breakpoints(bp1, bp2, search_range=400)
    assert [tuple(r) for r in matched.itertuples(index=False)] == [
        ('p1', 'q1')]

    # sides swapped still matches
    bp2_swapped = bp_table([('q4', '2', '-', 5000, '1', '+', 1000)])
    matched = match_breakpoints(bp1, bp2_swapped, search_range=400)
    assert [tuple(r) for r in matched.itertuples(index=False)] == [
        ('p1', 'q4')]

    assert match_breakpoints(bp1, bp_table([]), search_range=400).empty
