"""TITAN wrapper: input preparation, execution, result conversion.

Capability parity with /root/reference/remixt/wrappers/wraptitan.py:41-391.
The input writers and the result converter are self-contained (testable
without TITAN); only :func:`run` shells out, requiring an R installation
with the TitanCNA package plus the TitanCNA-utils scripts.

TITAN input formats:
  * fixed-step WIG read-count tracks (1 kb bins) for tumour and normal;
  * a het-position allele-count table
    (chr, position, refBase, refCount, NrefBase, NrefCount, no header).
TITAN output formats:
  * ``params.txt`` — ``name: v1 v2 ...`` lines carrying the S_Dbw model
    selection index, normal contamination, and clonal-cluster cellular
    prevalences;
  * a segments TSV (from createTITANsegmentfiles.pl) with
    Chromosome/Start_Position(bp)/End_Position(bp)/Copy_Number/MajorCN/
    MinorCN/Clonal_Cluster columns.
"""

import os
import subprocess

import numpy as np
import pandas as pd

from remixt_jax.wrappers import formats


def write_wig(wig_filename, seqdata_filename, chromosome_lengths,
              bin_size=1000):
    """Fixed-step WIG track of binned fragment counts."""
    with open(wig_filename, 'w') as wig:
        for chromosome, counts in formats.binned_read_counts(
                seqdata_filename, chromosome_lengths, bin_size):
            wig.write('fixedStep chrom={0} start=1 step={1} span={1}\n'
                      .format(chromosome, bin_size))
            wig.write('\n'.join(str(int(c)) for c in counts))
            wig.write('\n')


def write_het_alleles(allele_filename, het_counts):
    """TITAN allele-count table from het tumour counts (formats.py).

    Base identities are not tracked by the seqdata store; TITAN only uses
    the counts, so fixed placeholder bases are written.
    """
    table = pd.DataFrame({
        'chr': het_counts['chromosome'],
        'position': het_counts['position'],
        'refBase': 'A',
        'refCount': het_counts['ref_count'].astype(int),
        'NrefBase': 'T',
        'NrefCount': het_counts['alt_count'].astype(int),
    })
    table.to_csv(allele_filename, sep='\t', index=False, header=False)


def prepare_inputs(analysis_dir, normal_seqdata, tumour_seqdata,
                   chromosome_lengths, bin_size=1000):
    """Write every TITAN input under analysis_dir; returns their paths."""
    os.makedirs(analysis_dir, exist_ok=True)
    paths = {
        'normal_wig': os.path.join(analysis_dir, 'normal.wig'),
        'tumour_wig': os.path.join(analysis_dir, 'tumour.wig'),
        'alleles': os.path.join(analysis_dir, 'alleles.tsv'),
    }
    write_wig(paths['normal_wig'], normal_seqdata, chromosome_lengths,
              bin_size)
    write_wig(paths['tumour_wig'], tumour_seqdata, chromosome_lengths,
              bin_size)
    write_het_alleles(paths['alleles'], formats.het_tumour_allele_counts(
        normal_seqdata, tumour_seqdata))
    return paths


def run(analysis_dir, run_titan_script, num_clusters, ploidy_init,
        normal_init, out_subdir):
    """Execute one TITAN restart via the TitanCNA run script (requires R +
    TitanCNA; see benchmark/tool_defs.yaml for installation)."""
    paths = {
        'tumour_wig': os.path.join(analysis_dir, 'tumour.wig'),
        'normal_wig': os.path.join(analysis_dir, 'normal.wig'),
        'alleles': os.path.join(analysis_dir, 'alleles.tsv'),
    }
    outdir = os.path.join(analysis_dir, out_subdir)
    os.makedirs(outdir, exist_ok=True)
    subprocess.check_call([
        'Rscript', run_titan_script,
        paths['alleles'], paths['tumour_wig'], paths['normal_wig'],
        str(num_clusters), str(ploidy_init), str(normal_init),
        os.path.join(outdir, 'cn.tsv'),
        os.path.join(outdir, 'params.txt'),
    ])
    return outdir


def read_params(params_filename):
    """Parse TITAN's ``name: v1 v2 ...`` parameter file into
    {name: float array}."""
    parsed = {}
    with open(params_filename) as f:
        for line in f:
            if ':' not in line:
                continue
            name, _, values = line.partition(':')
            parsed[name.strip()] = np.array(values.split(), dtype=float)
    return parsed


def select_best_restart(params_by_restart):
    """Index of the restart minimizing the S_Dbw validity index."""
    scores = {idx: p['S_Dbw validity index'][0]
              for idx, p in params_by_restart.items()}
    return min(scores, key=scores.get)


def convert_mix(params, num_clusters):
    """Clone mixture from normal contamination + cellular prevalences.

    One cluster -> [normal, tumour]; two clusters -> the dominant clone
    carries the smaller prevalence's complement (the reference's
    convention, wraptitan.py:330-346).
    """
    n = float(params['Normal contamination estimate'][0])
    prev = params[
        'Clonal cluster cellular prevalence Z={}'.format(num_clusters)]
    if num_clusters == 1:
        return [n, (1 - n) * float(prev[0])]
    if num_clusters == 2:
        t1, t2 = float(prev[0]), float(prev[1])
        return [n, (1 - n) * t2, (1 - n) * abs(t1 - t2)]
    raise ValueError('unsupported cluster count {}'.format(num_clusters))


def convert_cn_table(titan_segments):
    """TITAN segment calls -> the standard cn table.

    Clonal segments replicate into both tumour clones; subclonal segments
    (Clonal_Cluster != 1) get diploid clone 2 per the reference convention.
    """
    renames = {
        'Chromosome': 'chromosome',
        'Start_Position(bp)': 'start',
        'End_Position(bp)': 'end',
        'Copy_Number': 'total_1',
        'MajorCN': 'major_1',
        'MinorCN': 'minor_1',
    }
    table = titan_segments.rename(columns=renames)
    clonal = table['Clonal_Cluster'].fillna(1).astype(int) == 1
    table['total_2'] = np.where(clonal, table['total_1'], 2)
    table['major_2'] = np.where(clonal, table['major_1'], 1)
    table['minor_2'] = np.where(clonal, table['minor_1'], 1)
    return table[['chromosome', 'start', 'end',
                  'total_1', 'major_1', 'minor_1',
                  'total_2', 'major_2', 'minor_2']]


def report(restart_dirs, output_cn_filename, output_mix_filename,
           num_clusters_by_restart):
    """Select the best restart and write the standard cn/mix outputs."""
    params_by_restart = {
        idx: read_params(os.path.join(d, 'params.txt'))
        for idx, d in restart_dirs.items()}
    best = select_best_restart(params_by_restart)

    mix = convert_mix(params_by_restart[best], num_clusters_by_restart[best])
    with open(output_mix_filename, 'w') as f:
        f.write('\t'.join(str(a) for a in mix) + '\n')

    segments = pd.read_csv(
        os.path.join(restart_dirs[best], 'cn.tsv'), sep='\t',
        converters={'Chromosome': str})
    convert_cn_table(segments).to_csv(
        output_cn_filename, sep='\t', index=False)
