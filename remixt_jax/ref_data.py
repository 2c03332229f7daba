"""Reference dataset download and build.

Mirrors /root/reference/remixt/ref_data.py:12-163 — ensembl genome FASTA
assembly concatenation, UCSC gap table, 1000 Genomes phased panels (GRCh37
impute2 or GRCh38 VCF→BCF), SNP position extraction, genetic maps — with
sentinel-guarded idempotent steps. BCF parsing uses pysam when available,
falling back to ``bcftools view`` text parsing.
"""

import gzip
import os
import subprocess

import pandas as pd

import remixt_jax.config
import remixt_jax.utils


def _execute(*args):
    subprocess.check_call([str(a) for a in args])


def _iter_bcf_snps(bcf_filename):
    """Yield (chrom, pos, ref, alt) from a BCF."""
    try:
        import pysam
        for r in pysam.VariantFile(bcf_filename, 'r'):
            for alt in r.alts:
                yield r.chrom, r.pos, r.ref, alt
    except ImportError:
        out = subprocess.Popen(
            ['bcftools', 'view', '-H', bcf_filename],
            stdout=subprocess.PIPE, text=True)
        for line in out.stdout:
            fields = line.split('\t')
            chrom, pos, ref, alts = fields[0], int(fields[1]), fields[3], fields[4]
            for alt in alts.split(','):
                yield chrom, pos, ref, alt
        out.wait()


def create_ref_data(config, ref_data_dir, ref_data_sentinal, bwa_index_genome=False):
    os.makedirs(ref_data_dir, exist_ok=True)

    auto_sentinal = remixt_jax.utils.AutoSentinal(ref_data_dir + '/sentinal.')

    temp_directory = os.path.join(ref_data_dir, 'tmp')
    os.makedirs(temp_directory, exist_ok=True)

    get_param = lambda name: remixt_jax.config.get_param(config, name)
    get_filename = lambda name, **kw: remixt_jax.config.get_filename(
        config, ref_data_dir, name, **kw)

    def wget_genome_fasta():
        chr_name_prefix = get_param('chr_name_prefix')
        with open(get_filename('genome_fasta'), 'w') as genome_file:
            for assembly in get_param('ensembl_assemblies'):
                assembly_url = get_filename('ensembl_assembly_url',
                                            ensembl_assembly=assembly)
                assembly_fasta = os.path.join(
                    temp_directory, 'dna.assembly.{0}.fa'.format(assembly))
                if not os.path.exists(assembly_fasta):
                    remixt_jax.utils.wget_gunzip(assembly_url, assembly_fasta)
                with open(assembly_fasta, 'r') as assembly_file:
                    for line in assembly_file:
                        if line[0] == '>':
                            chromosome_name = line[1:].split()[0]
                            if chr_name_prefix == 'chr':
                                chromosome_name = 'chr' + chromosome_name
                            line = '>' + chromosome_name + '\n'
                        genome_file.write(line)
    auto_sentinal.run(wget_genome_fasta)

    def wget_gap_table():
        prefix = get_param('chr_name_prefix')
        if prefix not in ('', 'chr'):
            raise ValueError(f'unrecognized chr_name_prefix {prefix!r}')

        gap_filename = get_filename('gap_table')
        remixt_jax.utils.wget(get_filename('gap_url'), gap_filename)

        # UCSC gap tables name chromosomes chr-prefixed; when the genome
        # build uses bare names (ensembl), strip the prefix in place.
        gaps = pd.read_csv(gap_filename, sep='\t', header=None, dtype=str)
        if not gaps[1].str.startswith('chr').all():
            raise ValueError('gap table chromosome names lack the chr prefix')
        if prefix == '':
            gaps[1] = gaps[1].str.slice(3)
            gaps.to_csv(gap_filename, sep='\t', header=None, index=False)
    auto_sentinal.run(wget_gap_table)

    if bwa_index_genome:
        def bwa_index():
            _execute('bwa', 'index', get_filename('genome_fasta'))
        auto_sentinal.run(bwa_index)

    def samtools_faidx():
        _execute('samtools', 'faidx', get_filename('genome_fasta'))
    auto_sentinal.run(samtools_faidx)

    genome_version = get_param('ensembl_genome_version')

    if genome_version == 'GRCh37':
        def wget_thousand_genomes():
            tar_filename = os.path.join(temp_directory, 'thousand_genomes_download.tar.gz')
            remixt_jax.utils.wget(get_param('thousand_genomes_impute_url'), tar_filename)
            _execute('tar', '-C', ref_data_dir, '-xzvf', tar_filename)
            os.remove(tar_filename)
        auto_sentinal.run(wget_thousand_genomes)

        def create_snp_positions():
            with open(get_filename('snp_positions'), 'w') as snp_positions_file:
                for chromosome in remixt_jax.config.get_chromosomes(config, ref_data_dir):
                    phased_chromosome = chromosome
                    if chromosome == 'X':
                        phased_chromosome = get_param('phased_chromosome_x')
                    legend_filename = get_filename('legend', chromosome=phased_chromosome)
                    with gzip.open(legend_filename, 'rt') as legend_file:
                        for line in legend_file:
                            if line.startswith('id'):
                                continue
                            row = line.split()
                            position, a0, a1 = row[1], row[2], row[3]
                            if len(a0) != 1 or len(a1) != 1:
                                continue
                            snp_positions_file.write(
                                '\t'.join([chromosome, position, a0, a1]) + '\n')
        auto_sentinal.run(create_snp_positions)

    elif genome_version == 'GRCh38':
        def wget_thousand_genomes():
            for chromosome in get_param('grch38_1kg_chromosomes'):
                if chromosome == get_param('grch38_1kg_phased_chromosome_x'):
                    vcf_url = get_param('grch38_1kg_X_vcf_url')
                    vcf_filename = get_filename('grch38_1kg_X_vcf_filename')
                else:
                    vcf_url = get_filename('grch38_1kg_vcf_url', chromosome=chromosome)
                    vcf_filename = get_filename('grch38_1kg_vcf_filename',
                                                chromosome=chromosome)
                remixt_jax.utils.wget(vcf_url, vcf_filename)
        auto_sentinal.run(wget_thousand_genomes)

        def convert_bcf():
            for chromosome in get_param('grch38_1kg_chromosomes'):
                if chromosome == get_param('grch38_1kg_phased_chromosome_x'):
                    vcf_filename = get_filename('grch38_1kg_X_vcf_filename')
                    bcf_filename = get_filename('grch38_1kg_X_bcf_filename')
                else:
                    vcf_filename = get_filename('grch38_1kg_vcf_filename',
                                                chromosome=chromosome)
                    bcf_filename = get_filename('grch38_1kg_bcf_filename',
                                                chromosome=chromosome)
                _execute('bcftools', 'view', '-O', 'b', vcf_filename, '-o', bcf_filename)
                _execute('bcftools', 'index', bcf_filename)
        auto_sentinal.run(convert_bcf)

        def create_snp_positions():
            chr_name_prefix = get_param('chr_name_prefix')
            snps = []
            for chromosome in get_param('grch38_1kg_chromosomes'):
                if chromosome == get_param('grch38_1kg_phased_chromosome_x'):
                    bcf_filename = get_filename('grch38_1kg_X_bcf_filename')
                else:
                    bcf_filename = get_filename('grch38_1kg_bcf_filename',
                                                chromosome=chromosome)
                for chrom, coord, ref, alt in _iter_bcf_snps(bcf_filename):
                    if chr_name_prefix == '':
                        assert chrom.startswith('chr')
                        chrom = chrom[3:]
                    elif chr_name_prefix != 'chr':
                        raise ValueError(
                            f'unrecognized chr_name_prefix {chr_name_prefix}')
                    if ref not in ['A', 'C', 'T', 'G']:
                        continue
                    if alt not in ['A', 'C', 'T', 'G']:
                        continue
                    snps.append([chrom, coord, ref, alt])
            snps = pd.DataFrame(snps, columns=['chrom', 'coord', 'ref', 'alt'])
            snps.to_csv(get_filename('snp_positions'), index=False, header=False, sep='\t')
        auto_sentinal.run(create_snp_positions)

        def get_genetic_maps():
            tar_filename = os.path.join(temp_directory, 'genetic_maps.b38.tar.gz')
            remixt_jax.utils.wget(get_param('genetic_maps_grch38_url'), tar_filename)
            _execute('tar', '-C', ref_data_dir, '-xzvf', tar_filename)
            os.remove(tar_filename)
        auto_sentinal.run(get_genetic_maps)

    else:
        raise ValueError('unsupported genome version ' + genome_version)

    with open(ref_data_sentinal, 'w'):
        pass
