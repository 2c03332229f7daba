"""bwa mappability workflow: k-mers → bwa mem realignment → bedgraph → HDF5
store. Mirrors /root/reference/remixt/mappability/bwa/workflow.py:11-67.
"""

import os
import subprocess

import remixt_jax.config
import remixt_jax.mappability.tasks
from remixt_jax.scheduler import Workflow

KMERS_PER_CHUNK = 4000000


def _bwa_mem_to_file(genome_fasta, kmers_filename, alignment_filename):
    with open(alignment_filename, 'w') as out:
        subprocess.check_call(
            ['bwa', 'mem', '-M', genome_fasta, kmers_filename], stdout=out)


def _split_kmers(kmers_filename, chunk_template):
    filenames = []

    def callback(file_number):
        filename = chunk_template.format(file_number)
        filenames.append(filename)
        return filename

    remixt_jax.mappability.tasks.split_file_byline(
        kmers_filename, KMERS_PER_CHUNK, callback)
    return filenames


def _align_and_bedgraph(genome_fasta, kmers_filename, tempdir):
    """Per-chunk align + bedgraph, fused to avoid storing giant SAM files."""
    chunk_template = os.path.join(tempdir, 'kmers_chunk_{}.fa')
    chunk_files = _split_kmers(kmers_filename, chunk_template)

    bedgraph_files = {}
    for idx, chunk_file in enumerate(chunk_files):
        alignment_file = os.path.join(tempdir, f'alignments_{idx}.sam')
        _bwa_mem_to_file(genome_fasta, chunk_file, alignment_file)
        bedgraph_file = os.path.join(tempdir, f'bedgraph_{idx}.tsv')
        remixt_jax.mappability.tasks.create_bedgraph(alignment_file, bedgraph_file)
        os.remove(alignment_file)
        os.remove(chunk_file)
        bedgraph_files[idx] = bedgraph_file
    return bedgraph_files


def create_bwa_mappability_workflow(config, ref_data_dir, tempdir):
    mappability_length = remixt_jax.config.get_param(config, 'mappability_length')
    genome_fasta = remixt_jax.config.get_filename(config, ref_data_dir, 'genome_fasta')
    mappability_filename = remixt_jax.config.get_filename(config, ref_data_dir, 'mappability')

    os.makedirs(tempdir, exist_ok=True)
    kmers_filename = os.path.join(tempdir, 'kmers.fa')

    workflow = Workflow('bwa_mappability')

    workflow.transform(
        'create_kmers',
        remixt_jax.mappability.tasks.create_kmers,
        args=(genome_fasta, mappability_length, kmers_filename),
        inputs=[genome_fasta],
        outputs=[kmers_filename],
    )

    bedgraphs = workflow.transform(
        'align_and_bedgraph',
        _align_and_bedgraph,
        args=(genome_fasta, kmers_filename, tempdir),
        inputs=[kmers_filename],
    )

    workflow.transform(
        'merge_bedgraph',
        remixt_jax.mappability.tasks.merge_files_by_line,
        args=(bedgraphs, mappability_filename),
        outputs=[mappability_filename],
    )

    return workflow
