"""Haplotype inference: SNP genotyping, phasing, block allele counting.

Capability parity with /root/reference/remixt/analysis/haplotype.py:14-874,
organized around a single vectorized block-construction core:

* genotyping — binomial-posterior calls from the normal, or pooled
  one-sided binomial tail tests across tumours (both fully vectorized;
  the reference loops ``scipy.stats.binomtest`` per SNP);
* phasing drivers — shapeit4 (GRCh38) or shapeit2 (GRCh37) as
  subprocesses, decomposed into VCF/GEN staging, tool invocation and
  sample collection steps;
* block construction — ``_haplotype_blocks`` turns averaged changepoint
  fractions into confidence-thresholded haplotype blocks; both genome
  builds share it (the reference re-derives the labels with a Python
  loop in its shapeit2 path, haplotype.py:601-615);
* allele counting + cross-sample phasing of blocks into alleles a/b.

BCF parsing uses ``bcftools view`` text output (pysam/htslib are not
dependencies in this environment).
"""

import os
import subprocess

import numpy as np
import pandas as pd
import scipy.stats

import remixt_jax.config
import remixt_jax.segalg
import remixt_jax.seqdataio


HAPS_COLUMNS = ['chromosome', 'position', 'allele', 'hap_label', 'allele_id']


def _run(*args):
    subprocess.check_call([str(a) for a in args if str(a) != ''])


def _param(config, name):
    return remixt_jax.config.get_param(config, name)


def _ref_file(config, ref_data_dir, name, **kwargs):
    return remixt_jax.config.get_filename(config, ref_data_dir, name, **kwargs)


# ---------------------------------------------------------------------------
# SNP genotyping
# ---------------------------------------------------------------------------

def infer_snp_genotype(data, base_call_error=0.005, call_threshold=0.9):
    """Posterior genotype calls from ref/alt counts, in place.

    Each SNP's three genotype likelihoods are binomial PMFs of the
    observed allele split (error rate for homozygous, 1/2 for het); calls
    threshold the normalized posterior. Adds total_count, likelihood_*/
    posterior_*/evidence diagnostics and AA/AB/BB indicator columns
    (parity: reference haplotype.py:14-44).
    """
    alt = data['alt_count'].values
    total = (data['ref_count'] + data['alt_count']).values
    data['total_count'] = total

    # rows: AA, AB, BB — success prob of observing the *minority* allele
    genotypes = ('AA', 'AB', 'BB')
    observed = np.stack([alt, alt, total - alt])
    error_rates = np.array([base_call_error, 0.5, base_call_error])
    likelihood = scipy.stats.binom.pmf(
        observed, total[None, :], error_rates[:, None])
    posterior = likelihood / likelihood.sum(axis=0, keepdims=True)

    data['evidence'] = likelihood.sum(axis=0)
    for row, genotype in enumerate(genotypes):
        data['likelihood_' + genotype] = likelihood[row]
        data['posterior_' + genotype] = posterior[row]
        data[genotype] = (posterior[row] >= call_threshold).astype(int)


def read_snp_counts(seqdata_filename, chromosome, num_rows=1000000):
    """Ref/alt read counts per SNP position, sorted by position
    (parity: reference haplotype.py:47-95)."""
    per_chunk = [pd.DataFrame({'position': pd.Series(dtype=int),
                               'ref_count': pd.Series(dtype=int),
                               'alt_count': pd.Series(dtype=int)})]
    for chunk in remixt_jax.seqdataio.read_allele_data(
            seqdata_filename, chromosome, chunksize=num_rows):
        if chunk.empty:
            continue
        tallies = (
            chunk.groupby(['position', 'is_alt']).size().unstack(fill_value=0)
            .reindex(columns=[0, 1], fill_value=0))
        tallies.columns = ['ref_count', 'alt_count']
        per_chunk.append(tallies.reset_index())

    counts = pd.concat(per_chunk, ignore_index=True)
    if counts.empty:
        return counts
    # positions may straddle chunk boundaries; merge their partial tallies
    return (counts.groupby('position', as_index=False).sum()
            .sort_values('position'))


def infer_snp_genotype_from_normal(snp_genotype_filename, seqdata_filename,
                                   chromosome, config):
    """Genotypes called from the matched normal sample
    (parity: reference haplotype.py:98-123)."""
    counts = read_snp_counts(seqdata_filename, chromosome)
    infer_snp_genotype(counts,
                       _param(config, 'sequencing_base_call_error'),
                       _param(config, 'het_snp_call_threshold'))
    counts.to_csv(snp_genotype_filename, sep='\t',
                  columns=['position', 'AA', 'AB', 'BB'], index=False)


def infer_snp_genotype_from_tumour(snp_genotype_filename, seqdata_filenames,
                                   chromosome, config):
    """Genotypes pooled across tumour samples.

    An allele is "present" when its pooled count is an improbably large
    binomial tail under the base-call error rate; genotype indicators
    combine the two presence calls (parity: reference haplotype.py:126-176,
    which evaluates the same one-sided test per row with
    scipy.stats.binomtest — here the tail is a vectorized survival
    function: P(X >= k) = sf(k - 1)).
    """
    error_rate = _param(config, 'sequencing_base_call_error')
    p_threshold = _param(config, 'homozygous_p_value_threshold')

    pooled = pd.concat(
        [read_snp_counts(filename, chromosome)
         for filename in seqdata_filenames.values()],
        ignore_index=True)
    if not pooled.empty:
        pooled = pooled.groupby('position', as_index=False).sum()

    pooled['total_count'] = pooled['ref_count'] + pooled['alt_count']
    pooled = pooled[pooled['total_count'] > 50].copy()

    n = pooled['total_count'].values
    for allele, count_col in (('A', 'ref_count'), ('B', 'alt_count')):
        k = pooled[count_col].values
        tail_p = scipy.stats.binom.sf(k - 1, n, error_rate)
        pooled['prob_no_' + allele] = tail_p
        pooled['has_' + allele] = tail_p < p_threshold

    pooled['AA'] = (pooled['has_A'] & ~pooled['has_B']).astype(int)
    pooled['BB'] = (pooled['has_B'] & ~pooled['has_A']).astype(int)
    pooled['AB'] = (pooled['has_A'] & pooled['has_B']).astype(int)

    pooled.to_csv(snp_genotype_filename, sep='\t',
                  columns=['position', 'AA', 'AB', 'BB'], index=False)


# ---------------------------------------------------------------------------
# Haplotype blocks from phasing samples
# ---------------------------------------------------------------------------

def _haplotype_blocks(fraction_changepoint, block_break, threshold):
    """Vectorized block construction from changepoint fractions.

    Args:
        fraction_changepoint: (n,) fraction of phasing samples placing a
            changepoint before each het SNP
        block_break: (n,) bool, positions that must start a new block
            regardless of confidence (chromosome boundaries)
        threshold: confidence below which a block is split

    Returns dict of (n,) arrays: changepoint_confidence, is_changepoint,
    hap_label (0-based), allele1, allele2. A block splits wherever the
    consensus changepoint call is not confident; allele1 alternates at
    each consensus changepoint (parity: reference haplotype.py:276-292).
    """
    frac = np.asarray(fraction_changepoint, dtype=float)
    confidence = np.maximum(frac, 1.0 - frac)
    is_changepoint = np.round(frac).astype(int)
    split = (confidence < float(threshold)) | np.asarray(block_break, bool)
    return {
        'changepoint_confidence': confidence,
        'is_changepoint': is_changepoint,
        'hap_label': np.cumsum(split) - 1,
        'allele1': np.cumsum(is_changepoint) % 2,
        'allele2': 1 - (np.cumsum(is_changepoint) % 2),
    }


def calculate_haplotypes(phasing_samples, changepoint_threshold=0.95):
    """Consensus haplotype blocks from sampled phasings.

    Each sample contributes, per het SNP, whether its phase flips relative
    to the previous het SNP; the flip fractions are averaged and fed to
    the vectorized block builder (parity: reference haplotype.py:235-292).
    """
    fraction_sum = None
    num_samples = 0
    for sample in phasing_samples:
        het = sample[sample['allele1'] != sample['allele2']]
        flips = het['allele1'].diff().abs().astype(float).fillna(0.0)
        fraction_sum = flips if fraction_sum is None else fraction_sum + flips
        num_samples += 1

    consensus = (fraction_sum / float(num_samples)) \
        .rename('fraction_changepoint').reset_index()

    chrom = consensus['chromosome']
    blocks = _haplotype_blocks(
        consensus['fraction_changepoint'].values,
        chrom.ne(chrom.shift()).values,
        changepoint_threshold)
    # kept for parity with the reference output schema
    consensus['not_confident'] = (
        blocks['changepoint_confidence'] < float(changepoint_threshold))
    consensus['chrom_different'] = chrom.ne(chrom.shift())
    for name, values in blocks.items():
        consensus[name] = values
    return consensus


def _stack_allele_rows(haps, chromosome_col='chromosome'):
    """One row per (SNP, allele_id): allele_id 0 carries allele1, allele_id
    1 carries allele2 (= 1 - allele1)."""
    base = haps[[chromosome_col, 'position']].copy()
    rows = []
    for allele_id, source in enumerate(['allele1', 'allele2']):
        part = base.copy()
        part['allele'] = haps[source].values
        part['hap_label'] = haps['hap_label'].values
        part['allele_id'] = allele_id
        rows.append(part)
    stacked = pd.concat(rows, ignore_index=True)
    return stacked.rename(columns={chromosome_col: 'chromosome'})


def _write_null_haps(haps_filename):
    pd.DataFrame(columns=HAPS_COLUMNS).to_csv(
        haps_filename, sep='\t', index=False)


# ---------------------------------------------------------------------------
# GRCh38: shapeit4
# ---------------------------------------------------------------------------

def _to_1kg_chromosome(chromosome, chr_name_prefix):
    """Map a sample chromosome name onto the chr-prefixed 1kg naming."""
    if chr_name_prefix == '':
        return 'chr' + chromosome
    if chr_name_prefix == 'chr':
        return chromosome
    # a typo'd prefix would otherwise silently phase against the wrong
    # 1kg region (reference haplotype.py:365-371 raises likewise)
    raise ValueError(
        'unrecognized chr_name_prefix {!r}'.format(chr_name_prefix))


def _load_het_positions(snp_genotype_filename, snp_positions_filename,
                        chromosome):
    """Het SNPs for one chromosome joined with their ref/alt bases."""
    positions = pd.concat([
        chunk[chunk['chromosome'] == chromosome]
        for chunk in pd.read_csv(
            snp_positions_filename, sep='\t',
            names=['chromosome', 'position', 'ref', 'alt'],
            dtype={'chromosome': str}, chunksize=int(1e6))])

    genotypes = pd.read_csv(snp_genotype_filename, sep='\t')
    genotypes['chromosome'] = chromosome
    genotypes = genotypes.merge(positions)
    if genotypes.empty:
        raise ValueError('no snps to phase')

    is_het = ((genotypes['AB'] == 1) & (genotypes['AA'] == 0)
              & (genotypes['BB'] == 0))
    return genotypes[is_het]


def _stage_het_bcf(het_snps, chromosome_1kg, temp_directory):
    """Write the het SNPs as an indexed BCF for shapeit4."""
    vcf_filename = os.path.join(temp_directory, 'het_snps.vcf')
    bcf_filename = os.path.join(temp_directory, 'het_snps.bcf')
    for stale in (vcf_filename, vcf_filename + '.gz',
                  vcf_filename + '.gz.tbi'):
        if os.path.exists(stale):
            os.remove(stale)

    table = pd.DataFrame({
        '#CHROM': chromosome_1kg,
        'POS': het_snps['position'].values,
        'ID': [f"{chromosome_1kg}_{p}_{r}_{a}" for p, r, a in zip(
            het_snps['position'], het_snps['ref'], het_snps['alt'])],
        'REF': het_snps['ref'].values,
        'ALT': het_snps['alt'].values,
        'QUAL': '.', 'FILTER': '.', 'INFO': '.',
        'FORMAT': 'GT', 'NORMAL': '0/1',
    })
    with open(vcf_filename, 'w') as f:
        f.write('##fileformat=VCFv4.2\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,'
                'Description="Genotype">\n')
        table.to_csv(f, sep='\t', index=False)

    _run('bgzip', '--force', vcf_filename)
    _run('tabix', vcf_filename + '.gz')
    _run('bcftools', 'view', '-O', 'b', vcf_filename + '.gz',
         '-o', bcf_filename)
    _run('bcftools', 'index', bcf_filename)
    return bcf_filename


def read_bcf_phased_genotypes(bcf_filename):
    """Phased alleles from a BCF via ``bcftools view`` text output
    (parity: reference haplotype.py:179-213, which uses pysam)."""
    records = []
    text = subprocess.run(
        ['bcftools', 'view', '-H', bcf_filename],
        capture_output=True, text=True, check=True).stdout
    for line in text.splitlines():
        fields = line.split('\t')
        genotype = fields[9].split(':')[0].replace('/', '|')
        allele1, allele2 = (int(a) for a in genotype.split('|'))
        for alt in fields[4].split(','):
            records.append((fields[0], int(fields[1]), fields[3], alt,
                            allele1, allele2))
    return pd.DataFrame(records, columns=[
        'chromosome', 'position', 'ref', 'alt', 'allele1', 'allele2'])


def read_phasing_samples(bcf_filenames):
    """Phasing samples indexed by (chrom, pos, ref, alt)
    (parity: reference haplotype.py:216-232)."""
    for bcf_filename in bcf_filenames:
        yield read_bcf_phased_genotypes(bcf_filename).set_index(
            ['chromosome', 'position', 'ref', 'alt'])


def infer_haps_grch38_shapeit4(haps_filename, snp_genotype_filename,
                               chromosome, temp_directory, config,
                               ref_data_dir):
    """GRCh38 phasing: shapeit4 phasing graph, bingraphsample draws,
    consensus blocks (parity: reference haplotype.py:295-472)."""
    chromosome_1kg = _to_1kg_chromosome(
        chromosome, _param(config, 'chr_name_prefix'))

    phased_x = _param(config, 'grch38_1kg_phased_chromosome_x')
    unphasable = (
        str(chromosome_1kg) not in _param(config, 'grch38_1kg_chromosomes')
        # male X carries no het snps
        or (chromosome == phased_x and not _param(config, 'is_female')))
    if unphasable:
        _write_null_haps(haps_filename)
        return

    os.makedirs(temp_directory, exist_ok=True)

    het_snps = _load_het_positions(
        snp_genotype_filename,
        _ref_file(config, ref_data_dir, 'snp_positions'),
        chromosome)
    het_bcf = _stage_het_bcf(het_snps, chromosome_1kg, temp_directory)

    if chromosome_1kg == phased_x:
        panel_bcf = _ref_file(config, ref_data_dir, 'grch38_1kg_X_bcf_filename')
    else:
        panel_bcf = _ref_file(config, ref_data_dir, 'grch38_1kg_bcf_filename',
                              chromosome=chromosome_1kg)

    bingraph_filename = os.path.join(temp_directory, 'phasing.bingraph')
    _run('shapeit4',
         '--input', het_bcf,
         '--map', _ref_file(config, ref_data_dir,
                            'genetic_map_grch38_filename',
                            chromosome=chromosome_1kg),
         '--region', chromosome_1kg,
         '--reference', panel_bcf,
         '--bingraph', bingraph_filename)

    sample_filenames = []
    for seed in range(_param(config, 'shapeit_num_samples')):
        sample_filename = os.path.join(
            temp_directory, 'sampled.{}.bcf'.format(seed))
        _run('bingraphsample', '--input', bingraph_filename,
             '--output', sample_filename, '--sample', '--seed', str(seed))
        _run('bcftools', 'index', '-f', sample_filename)
        sample_filenames.append(sample_filename)

    consensus = calculate_haplotypes(
        read_phasing_samples(sample_filenames),
        changepoint_threshold=_param(config, 'shapeit_confidence_threshold'))

    haps = _stack_allele_rows(consensus)
    if _param(config, 'chr_name_prefix') == '':
        if not haps['chromosome'].str.startswith('chr').all():
            raise ValueError('unexpected chromosome prefix')
        haps['chromosome'] = haps['chromosome'].str.slice(start=3)

    haps[HAPS_COLUMNS].to_csv(haps_filename, sep='\t', index=False)


# ---------------------------------------------------------------------------
# GRCh37: shapeit2
# ---------------------------------------------------------------------------

def _stage_shapeit2_inputs(snp_genotype_filename, legend_filename,
                           chromosome, temp_directory):
    """Write the .gen/.sample inputs shapeit2 expects; returns their paths."""
    genotypes = pd.read_csv(snp_genotype_filename, sep='\t')
    if genotypes.empty:
        return None, None
    called = genotypes[(genotypes[['AA', 'AB', 'BB']] == 1).any(axis=1)]

    legend = pd.read_csv(legend_filename, compression='gzip', sep=' ',
                         usecols=['position', 'a0', 'a1'])
    bases = ['A', 'C', 'T', 'G']
    legend = legend[legend['a0'].isin(bases) & legend['a1'].isin(bases)]

    gen = legend.merge(called[['position', 'AA', 'AB', 'BB']],
                       on='position', how='inner', sort=False)
    gen.insert(0, 'chr', chromosome)
    gen.insert(1, 'chr_pos',
               gen['chr'].astype(str) + ':' + gen['position'].astype(str))

    gen_filename = os.path.join(temp_directory, 'snps.gen')
    gen.to_csv(gen_filename, sep=' ', index=False, header=False,
               columns=['chr', 'chr_pos', 'position', 'a0', 'a1',
                        'AA', 'AB', 'BB'])

    sample_filename = os.path.join(temp_directory, 'snps.sample')
    with open(sample_filename, 'w') as f:
        f.write('ID_1 ID_2 missing sex\n0 0 0 0\nUNR1 UNR1 0 2\n')
    return gen_filename, sample_filename


def _sample_shapeit2_phasing(hgraph_filename, sample_prefix, seed,
                             max_attempts=3):
    """One phasing draw from the shapeit2 haplotype graph.

    Returns the het-SNP phase as a position-indexed series; shapeit
    occasionally segfaults during sampling, so the draw retries
    (parity: reference haplotype.py:576-589).
    """
    log_filename = sample_prefix + '.log'
    for _ in range(max_attempts):
        try:
            _run('shapeit', '-convert', '--input-graph', hgraph_filename,
                 '--output-sample', sample_prefix,
                 '--seed', str(seed), '-L', log_filename)
            break
        except subprocess.CalledProcessError:
            print('failed sampling with seed {}, retrying'.format(seed))
    else:
        raise Exception(
            'failed to sample {} times with seed {}'.format(
                max_attempts, seed))

    draw = pd.read_csv(
        sample_prefix + '.haps', sep=' ', header=None,
        names=['id', 'id2', 'position', 'ref', 'alt', 'allele1', 'allele2'],
        usecols=['position', 'allele1', 'allele2'])
    draw = draw[draw['allele1'] != draw['allele2']]
    phase = draw.set_index('position')['allele1'].rename('allele')

    for suffix in ('.log', '.haps', '.sample'):
        os.remove(sample_prefix + suffix)
    return phase


def infer_haps_grch37_shapeit2(haps_filename, snp_genotype_filename,
                               chromosome, temp_directory, config,
                               ref_data_dir):
    """GRCh37 phasing: shapeit2 haplotype graph + sampled draws, consensus
    blocks via the shared vectorized builder
    (parity: reference haplotype.py:475-640)."""
    phasable = [str(a) for a in range(1, 23)] + ['X']
    if str(chromosome) not in phasable or (
            chromosome == 'X' and not _param(config, 'is_female')):
        _write_null_haps(haps_filename)
        return

    os.makedirs(temp_directory, exist_ok=True)

    panel_chromosome = chromosome
    if chromosome == 'X':
        panel_chromosome = _param(config, 'phased_chromosome_x')
    legend_filename = _ref_file(config, ref_data_dir, 'legend',
                                chromosome=panel_chromosome)

    gen_filename, sample_filename = _stage_shapeit2_inputs(
        snp_genotype_filename, legend_filename, chromosome, temp_directory)
    if gen_filename is None:
        _write_null_haps(haps_filename)
        return

    hgraph_filename = os.path.join(temp_directory, 'phased.hgraph')
    _run('shapeit',
         '-M', _ref_file(config, ref_data_dir, 'genetic_map',
                         chromosome=panel_chromosome),
         '-R', _ref_file(config, ref_data_dir, 'haplotypes',
                         chromosome=panel_chromosome),
         legend_filename,
         _ref_file(config, ref_data_dir, 'sample'),
         '-G', gen_filename, sample_filename,
         '--output-graph', hgraph_filename,
         '--chrX' if chromosome == 'X' else '',
         '--no-mcmc', '-L', hgraph_filename + '.log', '--seed', '12345')

    num_samples = _param(config, 'shapeit_num_samples')
    flip_sum = None
    phase = None
    for seed in range(num_samples):
        phase = _sample_shapeit2_phasing(
            hgraph_filename,
            os.path.join(temp_directory, 'sampled.{}'.format(seed)), seed)
        flips = phase.diff().abs().astype(float).fillna(0.0)
        flip_sum = flips if flip_sum is None else flip_sum + flips

    blocks = _haplotype_blocks(
        (flip_sum / float(num_samples)).values,
        np.zeros(len(flip_sum), dtype=bool),
        _param(config, 'shapeit_confidence_threshold'))

    # the reference's shapeit2 label loop starts at 0 and pre-increments,
    # i.e. labels are the inclusive count of low-confidence positions
    # (haplotype.py:605-615) — one above the shared builder's 0-based
    # first block, with identical block boundaries
    consensus = phase.to_frame()
    consensus['changepoint_confidence'] = blocks['changepoint_confidence']
    consensus['hap_label'] = blocks['hap_label'] + 1
    consensus = consensus.reset_index()
    consensus['chromosome'] = chromosome
    consensus['allele1'] = consensus['allele']
    consensus['allele2'] = 1 - consensus['allele']

    haps = _stack_allele_rows(consensus)
    haps = haps.sort_values(['position', 'allele_id'])
    haps[HAPS_COLUMNS].to_csv(haps_filename, sep='\t', index=False)


def infer_haps(haps_filename, snp_genotype_filename, chromosome,
               temp_directory, config, ref_data_dir):
    """Dispatch to the genome-build-appropriate phasing tool
    (parity: reference haplotype.py:643-650)."""
    build = _param(config, 'ensembl_genome_version')
    drivers = {
        'GRCh38': infer_haps_grch38_shapeit4,
        'GRCh37': infer_haps_grch37_shapeit2,
    }
    if build not in drivers:
        raise ValueError('unsupported genome version {}'.format(build))
    drivers[build](haps_filename, snp_genotype_filename, chromosome,
                   temp_directory, config, ref_data_dir)


# ---------------------------------------------------------------------------
# Block allele counting and cross-sample phasing
# ---------------------------------------------------------------------------

def count_allele_reads(seqdata_filename, haps, chromosome, segments,
                       filter_duplicates=False, map_qual_threshold=1):
    """Read count per (segment, haplotype block, allele)
    (parity: reference haplotype.py:653-746).

    A fragment votes for the (block, allele) of one of its covered SNPs
    (arbitrary representative), restricted to fragments fully contained
    in a segment and passing the duplicate/mapq filters.
    """
    empty = pd.DataFrame(columns=[
        'chromosome', 'start', 'end', 'hap_label', 'allele_id', 'readcount'])

    block_haps = haps[haps['chromosome'] == chromosome]

    snp_votes = pd.concat(
        [chunk.merge(block_haps, left_on=['position', 'is_alt'],
                     right_on=['position', 'allele'], how='inner')
         for chunk in remixt_jax.seqdataio.read_allele_data(
             seqdata_filename, chromosome, chunksize=1000000)],
        ignore_index=True)

    fragments = remixt_jax.seqdataio.read_fragment_data(
        seqdata_filename, chromosome,
        filter_duplicates=filter_duplicates,
        map_qual_threshold=map_qual_threshold)

    # joining fragment extents both drops filtered fragments and brings in
    # start/end for containment; keep one SNP vote per fragment
    votes = (snp_votes.merge(fragments, on='fragment_id')
             .drop_duplicates('fragment_id'))

    segments = segments.sort_values('start').reset_index(drop=True)
    votes['segment_idx'] = remixt_jax.segalg.find_contained_segments(
        segments[['start', 'end']].values, votes[['start', 'end']].values)
    votes = votes[votes['segment_idx'] >= 0]
    if votes.empty:
        return empty

    counts = (votes.groupby(['segment_idx', 'hap_label', 'allele_id'])
              .size().rename('readcount').reset_index())
    counts = counts.join(
        segments[['start', 'end']], on='segment_idx')
    counts['chromosome'] = chromosome
    return counts[['start', 'end', 'hap_label', 'allele_id', 'readcount',
                   'chromosome']]


def create_allele_counts(segments, seqdata_filename, haps_filename,
                         filter_duplicates=False, map_qual_threshold=1):
    """Allele counts over all chromosomes
    (parity: reference haplotype.py:749-789)."""
    haps = pd.read_csv(haps_filename, sep='\t',
                       converters={'chromosome': str})
    return pd.concat(
        [count_allele_reads(seqdata_filename, haps, chromosome,
                            chrom_segments.copy(),
                            filter_duplicates=filter_duplicates,
                            map_qual_threshold=map_qual_threshold)
         for chromosome, chrom_segments in segments.groupby('chromosome')],
        ignore_index=True)


SEGMENT_KEY = ['chromosome', 'start', 'end']


def _per_library_phase_evidence(allele_data, library_idx):
    """Per (segment, block): the library's major allele and, per segment,
    its normalized major-minor imbalance."""
    by_block = (allele_data
                .set_index(SEGMENT_KEY + ['hap_label', 'allele_id'])
                ['readcount'].astype(float).unstack(fill_value=0.0))

    major = by_block.idxmax(axis=1).rename('major_allele_id').reset_index()
    major['library_idx'] = library_idx

    spread = pd.DataFrame({
        'diff': by_block.max(axis=1) - by_block.min(axis=1),
        'total': by_block.max(axis=1) + by_block.min(axis=1),
    }).groupby(level=[0, 1, 2]).sum()
    spread = (spread['diff'] / spread['total']) \
        .rename('norm_diff_readcount').reset_index()
    spread['library_idx'] = library_idx
    return major, spread


def phase_segments(*allele_counts_tables):
    """Consistent allele a/b assignment across samples.

    For every segment, the library with the largest normalized allelic
    imbalance is trusted; its per-block major allele becomes allele a in
    every sample (parity: reference haplotype.py:792-874).
    """
    evidence = [_per_library_phase_evidence(table, idx)
                for idx, table in enumerate(allele_counts_tables)]
    block_major = pd.concat([e[0] for e in evidence], ignore_index=True)
    segment_spread = pd.concat([e[1] for e in evidence], ignore_index=True)

    # per segment: the library with the largest imbalance (ties go to the
    # lowest library index, matching argmax-first semantics)
    chosen = (segment_spread
              .sort_values('library_idx', kind='mergesort')
              .sort_values('norm_diff_readcount', kind='mergesort',
                           ascending=False)
              .drop_duplicates(SEGMENT_KEY)
              [SEGMENT_KEY + ['library_idx']])

    allele_a = (block_major
                .merge(chosen, on=SEGMENT_KEY + ['library_idx'], how='right')
                [SEGMENT_KEY + ['hap_label', 'major_allele_id']]
                .rename(columns={'major_allele_id': 'allele_a_id'}))

    out_columns = SEGMENT_KEY + ['hap_label', 'allele_id', 'readcount',
                                 'is_allele_a']
    phased = []
    for allele_data in allele_counts_tables:
        if allele_data.empty:
            phased.append(pd.DataFrame(columns=out_columns))
            continue
        labelled = allele_data.merge(
            allele_a, on=SEGMENT_KEY + ['hap_label'])
        labelled['is_allele_a'] = (
            labelled['allele_id'] == labelled['allele_a_id']).astype(int)
        phased.append(labelled[out_columns])
    return phased
