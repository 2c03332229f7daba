"""cloneHD wrapper: input preparation, execution, result conversion.

Capability parity with /root/reference/remixt/wrappers/wrapclonehd.py:21-367.
Input writers and the result parser are self-contained; :func:`run` drives
the filterHD / cloneHD binaries when installed.

cloneHD input formats:
  * CNA track, headerless TSV: chromosome, bin end, count, num_obs(=1);
  * tumour BAF track: chromosome, position, minor_count, total_count at
    normal-het positions.
cloneHD outputs:
  * ``*.summary.txt`` — '# <n> clones' header followed by mass and
    per-clone fraction rows;
  * per-clone posterior tables ``*.cna.subclone-<i>.txt`` /
    ``*.baf.subclone-<i>.txt`` whose columns are candidate copy numbers
    and rows are segments — the call is the argmax column.
"""

import os
import subprocess

import numpy as np
import pandas as pd

import remixt_jax.segalg
from remixt_jax.wrappers import formats


def write_cna(cna_filename, seqdata_filename, chromosome_lengths,
              bin_size=1000):
    with open(cna_filename, 'w') as out:
        for chromosome, counts in formats.binned_read_counts(
                seqdata_filename, chromosome_lengths, bin_size):
            ends = (np.arange(len(counts)) + 1) * bin_size
            pd.DataFrame({
                'chromosome': chromosome,
                'end': ends,
                'count': counts.astype(int),
                'num_obs': 1,
            }).to_csv(out, sep='\t', index=False, header=False)


def write_baf(baf_filename, normal_seqdata, tumour_seqdata):
    het = formats.het_tumour_allele_counts(normal_seqdata, tumour_seqdata)
    table = pd.DataFrame({
        'chromosome': het['chromosome'],
        'position': het['position'],
        'minor_count': np.minimum(het['ref_count'], het['alt_count']),
        'total_count': het['ref_count'] + het['alt_count'],
    })
    table.to_csv(baf_filename, sep='\t', index=False, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata,
                   chromosome_lengths, bin_size=1000):
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'normal_cna': os.path.join(analysis_dir, 'normal.cna.txt'),
        'tumour_cna': os.path.join(analysis_dir, 'tumour.cna.txt'),
        'tumour_baf': os.path.join(analysis_dir, 'tumour.baf.txt'),
    }
    write_cna(paths['normal_cna'], normal_seqdata, chromosome_lengths,
              bin_size)
    write_cna(paths['tumour_cna'], tumour_seqdata, chromosome_lengths,
              bin_size)
    write_baf(paths['tumour_baf'], normal_seqdata, tumour_seqdata)
    return paths


def run(analysis_dir, filterhd_bin, clonehd_bin, seed=123):
    """filterHD on normal/tumour tracks, then cloneHD (requires installs)."""
    def path(name):
        return os.path.join(analysis_dir, name)

    # four filterHD passes (reference wrapclonehd.py:207-244): plain normal
    # and tumour CNA fits, a bias-corrected tumour CNA fit (against the
    # normal posterior) that yields the jump track cloneHD consumes, and
    # the reflected tumour BAF fit
    subprocess.check_call([
        filterhd_bin, '--data', path('normal.cna.txt'), '--mode', '3',
        '--pre', path('normal.cna'), '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.cna.txt'), '--mode', '3',
        '--pre', path('tumour.cna'), '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.cna.txt'), '--mode', '3',
        '--pre', path('tumour.cna.bias'),
        '--bias', path('normal.cna.posterior-1.txt'),
        '--sigma', '0', '--jumps', '1', '--rnd', '0'])
    subprocess.check_call([
        filterhd_bin, '--data', path('tumour.baf.txt'), '--mode', '1',
        '--pre', path('tumour.baf'), '--sigma', '0', '--jumps', '1',
        '--reflect', '1', '--dist', '1', '--rnd', '0'])
    subprocess.check_call([
        clonehd_bin,
        '--cna', path('tumour.cna.txt'), '--baf', path('tumour.baf.txt'),
        '--pre', path('tumour'),
        '--bias', path('normal.cna.posterior-1.txt'),
        '--seed', str(seed), '--trials', '2', '--nmax', '3', '--force', '2',
        '--max-tcn', '4',
        '--cna-jumps', path('tumour.cna.bias.jumps.txt'),
        '--baf-jumps', path('tumour.baf.jumps.txt'),
        '--min-jump', '0.01', '--restarts', '10', '--mass-gauging', '1'])


def parse_summary(summary_filename):
    """{num_clones, mass, frac_1..} from cloneHD's summary file."""
    info = {}
    names = []
    with open(summary_filename) as f:
        for line in f:
            if line.startswith('#'):
                names = line[1:].split()
                if len(names) == 2 and names[1] == 'clones':
                    info['num_clones'] = int(names[0])
                    names = ['mass'] + [
                        'frac_{}'.format(i + 1)
                        for i in range(info['num_clones'])]
            elif names:
                info.update(zip(names, line.split()))
    return info


def _argmax_calls(posterior_filename, bin_size=None):
    """Posterior table -> per-segment integer call (argmax column).

    ``bin_size`` shifts segment starts one bin left — CNA loci are bin
    endpoints, so CNA tables need it; BAF loci are SNP positions and must
    NOT be shifted (reference wrapclonehd.py:305 shifts cna_data only).
    """
    data = pd.read_csv(posterior_filename, sep=r'\s+')
    data = data.rename(columns={
        '#chr': 'chromosome', 'first-locus': 'start', 'last-locus': 'end'})
    data = data.drop(columns=['nloci'])
    if bin_size is not None:
        data['start'] = data['start'] - bin_size
    index_cols = ['chromosome', 'start', 'end']
    calls = (data.set_index(index_cols).fillna(0.)
             .idxmax(axis=1).astype(int))
    return calls.rename('call').reset_index()


def clone_cn_table(cna_filename, baf_filename, clone_id, bin_size=1000):
    """Combine a clone's total-CN and allele calls into major/minor columns
    on the overlap segmentation."""
    total = _argmax_calls(cna_filename, bin_size).rename(
        columns={'call': 'total'})
    allele = _argmax_calls(baf_filename).rename(
        columns={'call': 'allele'})

    overlap = remixt_jax.segalg.reindex_segments(total, allele)
    overlap['total'] = total['total'].values[overlap['idx_1'].values]
    overlap['allele'] = allele['allele'].values[overlap['idx_2'].values]

    other = overlap['total'] - overlap['allele']
    overlap['major_{}'.format(clone_id)] = np.maximum(
        overlap['allele'], other)
    # negative minors occur in cloneHD output; clamp as the reference does
    overlap['minor_{}'.format(clone_id)] = np.maximum(
        np.minimum(overlap['allele'], other), 0)
    overlap['total_{}'.format(clone_id)] = overlap['total']
    return overlap.drop(columns=['idx_1', 'idx_2', 'total', 'allele'])


def report(analysis_dir, output_cn_filename, output_mix_filename,
           bin_size=1000):
    """Write the standard cn/mix outputs from a cloneHD run directory."""
    def path(name):
        return os.path.join(analysis_dir, name)

    info = parse_summary(path('tumour.summary.txt'))
    fracs = [float(info['frac_{}'.format(i + 1)])
             for i in range(info['num_clones'])]
    mix = [1.0 - sum(fracs)] + fracs
    with open(output_mix_filename, 'w') as f:
        f.write('\t'.join(str(a) for a in mix) + '\n')

    table = None
    for clone_id in range(1, info['num_clones'] + 1):
        clone = clone_cn_table(
            path('tumour.cna.subclone-{}.txt'.format(clone_id)),
            path('tumour.baf.subclone-{}.txt'.format(clone_id)),
            clone_id, bin_size)
        if table is None:
            table = clone
            continue
        merged = remixt_jax.segalg.reindex_segments(table, clone)
        left = table.drop(columns=['chromosome', 'start', 'end'])
        right = clone.drop(columns=['chromosome', 'start', 'end'])
        for col in left.columns:
            merged[col] = left[col].values[merged['idx_1'].values]
        for col in right.columns:
            merged[col] = right[col].values[merged['idx_2'].values]
        table = merged.drop(columns=['idx_1', 'idx_2'])

    table.to_csv(output_cn_filename, sep='\t', index=False)
