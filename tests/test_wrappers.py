"""Competitor-wrapper input writers and result converters.

The execution stages need external installations, but everything around
them — seqdata -> tool-input extraction and tool-output -> standard-schema
conversion — is pure and tested here on synthetic fixtures.
"""

import os

import numpy as np
import pandas as pd
import pytest

import remixt_jax.seqdataio as seqdataio
from remixt_jax.wrappers import formats, wrapclonehd, wraptheta, wraptitan


@pytest.fixture()
def tiny_seqdata(tmp_path):
    """Two-chromosome seqdata: uniform fragments + het/hom SNP alleles."""
    rng = np.random.RandomState(0)

    def build(filename, depth_scale):
        writer = seqdataio.Writer(str(filename))
        for chromosome, length in (('1', 20000), ('2', 10000)):
            n_frag = int(depth_scale * length / 100)
            starts = rng.randint(0, length - 200, size=n_frag)
            fragments = pd.DataFrame({
                'fragment_id': np.arange(n_frag),
                'start': np.sort(starts),
                'end': np.sort(starts) + 150,
            })
            # SNPs every 1000 bp; even positions het (both alleles seen),
            # odd hom-ref
            rows = []
            for i, pos in enumerate(range(500, length, 1000)):
                for read in range(12):
                    is_alt = (read % 2) if i % 2 == 0 else 0
                    rows.append((rng.randint(n_frag), pos, is_alt))
            alleles = pd.DataFrame(
                rows, columns=['fragment_id', 'position', 'is_alt'])
            writer.write(chromosome, fragments, alleles)
        writer.close()
        return str(filename)

    return {
        'normal': build(tmp_path / 'normal.h5', 1.0),
        'tumour': build(tmp_path / 'tumour.h5', 1.5),
        'lengths': {'1': 20000, '2': 10000},
    }


def test_binned_read_counts(tiny_seqdata):
    binned = dict(formats.binned_read_counts(
        tiny_seqdata['normal'], tiny_seqdata['lengths'], bin_size=1000))
    assert set(binned) == {'1', '2'}
    assert len(binned['1']) == 20 and len(binned['2']) == 10
    assert sum(binned['1']) > 0


def test_het_tumour_allele_counts(tiny_seqdata):
    het = formats.het_tumour_allele_counts(
        tiny_seqdata['normal'], tiny_seqdata['tumour'])
    # only the even (het) SNPs survive the normal genotype call
    assert len(het.index) > 0
    assert (het['position'] % 2000 == 500).all()
    assert {'chromosome', 'position', 'ref_count', 'alt_count'} <= set(
        het.columns)


def test_titan_inputs_and_conversion(tiny_seqdata, tmp_path):
    paths = wraptitan.prepare_inputs(
        str(tmp_path / 'titan'), tiny_seqdata['normal'],
        tiny_seqdata['tumour'], tiny_seqdata['lengths'])
    wig = open(paths['tumour_wig']).read().splitlines()
    headers = [l for l in wig if l.startswith('fixedStep')]
    assert sorted(headers) == [
        'fixedStep chrom=1 start=1 step=1000 span=1000',
        'fixedStep chrom=2 start=1 step=1000 span=1000']
    assert len(open(paths['alleles']).read().splitlines()) > 0

    # synthetic params for two restarts; restart 1 has the better (lower)
    # S_Dbw index
    for idx, (sdbw, prev) in enumerate([(0.5, '0.8'), (0.2, '0.9 0.4')]):
        d = tmp_path / 'titan' / 'restart_{}'.format(idx)
        os.makedirs(d, exist_ok=True)
        clusters = idx + 1
        with open(d / 'params.txt', 'w') as f:
            f.write('Normal contamination estimate: 0.4\n')
            f.write('S_Dbw validity index: {}\n'.format(sdbw))
            f.write('Clonal cluster cellular prevalence Z={}: {}\n'.format(
                clusters, prev))
        pd.DataFrame({
            'Chromosome': ['1', '1'],
            'Start_Position(bp)': [0, 10000],
            'End_Position(bp)': [10000, 20000],
            'Copy_Number': [2, 3],
            'MajorCN': [1, 2],
            'MinorCN': [1, 1],
            'Clonal_Cluster': [1, 2],
        }).to_csv(d / 'cn.tsv', sep='\t', index=False)

    cn_out = str(tmp_path / 'cn.tsv')
    mix_out = str(tmp_path / 'mix.tsv')
    wraptitan.report(
        {0: str(tmp_path / 'titan' / 'restart_0'),
         1: str(tmp_path / 'titan' / 'restart_1')},
        cn_out, mix_out, {0: 1, 1: 2})

    mix = [float(v) for v in open(mix_out).read().split()]
    # restart 1 selected: n=0.4, t1=0.9, t2=0.4
    np.testing.assert_allclose(mix, [0.4, 0.6 * 0.4, 0.6 * 0.5])

    cn = pd.read_csv(cn_out, sep='\t', converters={'chromosome': str})
    # clonal segment replicated; subclonal segment's clone 2 is diploid
    assert cn.loc[0, 'major_2'] == 1 and cn.loc[0, 'total_2'] == 2
    assert cn.loc[1, 'total_1'] == 3 and cn.loc[1, 'total_2'] == 2


def test_theta_inputs_and_conversion(tiny_seqdata, tmp_path):
    segments = pd.DataFrame({
        'chromosome': ['1', '1', '2'],
        'start': [0, 10000, 0],
        'end': [10000, 20000, 10000],
    })
    paths = wraptheta.prepare_inputs(
        str(tmp_path / 'theta'), tiny_seqdata['normal'],
        tiny_seqdata['tumour'], segments)
    counts = pd.read_csv(paths['counts'], sep='\t', header=None,
                         names=wraptheta.INTERVAL_COLUMNS)
    assert len(counts.index) == 3
    assert (counts['count_tumour'] > 0).all()

    with open(tmp_path / 'theta' / 'theta2.BAF.NLL.results', 'w') as f:
        f.write('#NLL\tmu\tC\tp*\tBAF_NLL\n')
        f.write('100.\t0.4,0.35,0.25\t2,1:3,2:2,2\t-\t30.\n')
        f.write('90.\t0.5,0.3,0.2\t2,2:3,1:1,1\t-\t20.\n')

    chrom_names = {v: k for k, v in paths['chrom_idx'].items()}
    cn_out = str(tmp_path / 'theta_cn.tsv')
    mix_out = str(tmp_path / 'theta_mix.tsv')
    wraptheta.report(str(tmp_path / 'theta'), cn_out, mix_out, chrom_names)

    mix = [float(v) for v in open(mix_out).read().split()]
    np.testing.assert_allclose(mix, [0.5, 0.3, 0.2])  # lower total NLL row

    cn = pd.read_csv(cn_out, sep='\t', converters={'chromosome': str})
    assert list(cn['total_1']) == [2, 3, 1]
    assert list(cn['total_2']) == [2, 1, 1]
    assert list(cn['chromosome']) == ['1', '1', '2']


def test_theta_allele_file_has_nine_columns(tiny_seqdata, tmp_path):
    """THetA2's octave BAF model indexes columns positionally:
    chrom_idx, position, A, C, T, G, total, ref, alt."""
    segments = pd.DataFrame({
        'chromosome': ['1', '2'], 'start': [0, 0], 'end': [20000, 10000]})
    paths = wraptheta.prepare_inputs(
        str(tmp_path / 'theta'), tiny_seqdata['normal'],
        tiny_seqdata['tumour'], segments)
    table = pd.read_csv(paths['tumour_alleles'], sep='\t', header=None)
    assert table.shape[1] == 9
    # nucleotide columns zero-filled; total == ref + alt
    assert (table[[2, 3, 4, 5]] == 0).all().all()
    np.testing.assert_array_equal(
        table[6].values, (table[7] + table[8]).values)


def test_clonehd_baf_loci_not_shifted(tmp_path):
    """CNA loci are bin endpoints (shift one bin left); BAF loci are SNP
    positions (no shift — reference wrapclonehd.py:305 shifts cna only)."""
    cols = ['#chr', 'first-locus', 'last-locus', 'nloci', '0', '1']
    table = pd.DataFrame(
        [['1', 1000, 10000, 10, 0.2, 0.8]], columns=cols)
    path = str(tmp_path / 'posterior.txt')
    table.to_csv(path, sep=' ', index=False)

    shifted = wrapclonehd._argmax_calls(path, bin_size=1000)
    assert shifted.loc[0, 'start'] == 0
    unshifted = wrapclonehd._argmax_calls(path)
    assert unshifted.loc[0, 'start'] == 1000
    assert unshifted.loc[0, 'call'] == 1


def test_external_workflow_tasks_are_picklable(tmp_path, monkeypatch):
    """The scheduler's spawn pool pickles task functions; every stage of
    every external-tool workflow must survive pickling (max_jobs > 1)."""
    import pickle

    from remixt_jax.wrappers import wrapexternal

    # chromosome_lengths() needs a genome FAI on disk; the value itself is
    # a plain dict and irrelevant to picklability
    monkeypatch.setattr(wrapexternal.ExternalTool, 'chromosome_lengths',
                        lambda self: {'1': 20000, '2': 10000})
    config = {
        'titan': {'run_script': 'titan_run.R'},
        'theta': {'bin': 'RunTHetA', 'octave_bin_directory': '/opt/theta',
                  'segments_filename': str(tmp_path / 'segments.tsv')},
        'clonehd': {},
    }
    for tool_cls in (wrapexternal.TitanTool, wrapexternal.ThetaTool,
                     wrapexternal.CloneHDTool):
        tool = tool_cls(config, str(tmp_path))
        wf = wrapexternal.Workflow('{}_pickle'.format(tool.name))
        # bypass check_available: binaries are absent in the test image
        tool._add_stages(wf, 'normal.h5', 'tumour.h5',
                         str(tmp_path / 'results.h5'), str(tmp_path / 'wd'))
        for task in wf.tasks:
            pickle.dumps((task.func, task.args, task.kwargs))


def test_remixt_wrapper_rejects_multiple_tumours(tmp_path):
    from remixt_jax.wrappers import wrapremixt

    tool = wrapremixt.ReMixTTool({}, str(tmp_path))
    with pytest.raises(ValueError, match='exactly one tumour'):
        tool.create_workflow(
            {'n': 'n.h5', 't1': 't1.h5', 't2': 't2.h5'},
            'breakpoints.tsv', str(tmp_path / 'results.h5'),
            str(tmp_path / 'wd'), normal_id='n')


def test_clonehd_conversion(tmp_path):
    d = tmp_path / 'clonehd'
    os.makedirs(d)
    with open(d / 'tumour.summary.txt', 'w') as f:
        f.write('# 2 clones\n')
        f.write('1.2 0.5 0.3\n')

    def posterior(filename, rows, num_states):
        cols = ['#chr', 'first-locus', 'last-locus', 'nloci'] + [
            str(i) for i in range(num_states)]
        pd.DataFrame(rows, columns=cols).to_csv(
            filename, sep=' ', index=False)

    # clone 1: totals [2, 3]; alleles [1, 1]
    posterior(d / 'tumour.cna.subclone-1.txt',
              [['1', 1000, 10000, 10, 0.0, 0.1, 0.8, 0.1],
               ['1', 11000, 20000, 10, 0.0, 0.1, 0.2, 0.7]], 4)
    posterior(d / 'tumour.baf.subclone-1.txt',
              [['1', 1000, 10000, 10, 0.1, 0.8, 0.1, 0.0],
               ['1', 11000, 20000, 10, 0.1, 0.8, 0.1, 0.0]], 4)
    # clone 2: totals [2, 2]; alleles [0, 1]
    posterior(d / 'tumour.cna.subclone-2.txt',
              [['1', 1000, 10000, 10, 0.0, 0.1, 0.8, 0.1],
               ['1', 11000, 20000, 10, 0.0, 0.1, 0.8, 0.1]], 4)
    posterior(d / 'tumour.baf.subclone-2.txt',
              [['1', 1000, 10000, 10, 0.7, 0.2, 0.1, 0.0],
               ['1', 11000, 20000, 10, 0.1, 0.8, 0.1, 0.0]], 4)

    cn_out = str(tmp_path / 'chd_cn.tsv')
    mix_out = str(tmp_path / 'chd_mix.tsv')
    wrapclonehd.report(str(d), cn_out, mix_out)

    mix = [float(v) for v in open(mix_out).read().split()]
    np.testing.assert_allclose(mix, [0.2, 0.5, 0.3])

    cn = pd.read_csv(cn_out, sep='\t', converters={'chromosome': str})
    assert list(cn['total_1']) == [2, 3]
    assert list(cn['major_1']) == [1, 2]
    assert list(cn['minor_1']) == [1, 1]
    assert list(cn['major_2']) == [2, 1]
    assert list(cn['minor_2']) == [0, 1]
