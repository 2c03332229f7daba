"""Mappability pipeline tasks: genome k-mer tiling, realignment bedgraph,
HDF5 store.

Capability parity with /root/reference/remixt/mappability/tasks.py:9-88.
The bedgraph step run-length-encodes per-position mapping quality with
vectorized numpy boundary detection (the reference uses a pandas
diff/groupby-apply chain), and the store is h5py-based (group
``chromosome_X`` with start/end/quality datasets) read back by
analysis.gcbias.read_mappability_indicator.
"""

import itertools

import numpy as np
import pandas as pd
import h5py

import remixt_jax.utils


def create_kmers(genome_fasta, k, kmers_filename):
    """FASTA of every N-free k-mer in the genome, named chromosome:start."""
    with open(kmers_filename, 'w') as kmers_file:
        for chromosome, sequence in remixt_jax.utils.read_sequences(
                genome_fasta):
            chromosome = chromosome.split()[0]
            sequence = sequence.upper()
            kmers_file.writelines(
                '>{0}:{1}\n{2}\n'.format(
                    chromosome, start, sequence[start:start + k])
                for start in range(len(sequence) - k + 1)
                if 'N' not in sequence[start:start + k])


def split_file_byline(in_filename, lines_per_file, out_filename_callback):
    """Shard a text file into consecutive ``lines_per_file`` chunks."""
    with open(in_filename, 'r') as in_file:
        for shard in itertools.count():
            lines = list(itertools.islice(in_file, lines_per_file))
            if not lines:
                break
            with open(out_filename_callback(shard), 'w') as out_file:
                out_file.writelines(lines)


def _origin_true_alignments(alignment_filename):
    """(chromosome, position, quality) of k-mers that realign exactly to
    their origin position (the k-mer read name encodes it)."""
    names, chroms, positions, quals = [], [], [], []
    with open(alignment_filename, 'r') as alignment_file:
        for line in alignment_file:
            if line.startswith('@'):
                continue
            fields = line.split('\t', 5)
            names.append(fields[0])
            chroms.append(fields[2])
            positions.append(int(fields[3]) - 1)  # SAM is 1-based
            quals.append(int(fields[4]))

    table = pd.DataFrame({
        'name': names, 'chromosome': chroms,
        'position': positions, 'quality': quals})
    origin = table['name'].str.rsplit(':', n=1, expand=True)
    at_origin = ((origin[0] == table['chromosome'])
                 & (origin[1].astype(int) == table['position']))
    return table.loc[at_origin, ['chromosome', 'position', 'quality']]


def _run_length_encode(table):
    """Collapse consecutive same-quality positions into intervals.

    The table must be sorted by (chromosome, position); a new interval
    opens when the chromosome changes, a position is skipped, or the
    quality changes.
    """
    chrom = table['chromosome'].values
    pos = table['position'].values
    qual = table['quality'].values

    opens = np.ones(len(pos), dtype=bool)
    opens[1:] = ((chrom[1:] != chrom[:-1])
                 | (pos[1:] != pos[:-1] + 1)
                 | (qual[1:] != qual[:-1]))
    start_idx = np.flatnonzero(opens)
    end_idx = np.concatenate([start_idx[1:], [len(pos)]]) - 1

    return pd.DataFrame({
        'chromosome': chrom[start_idx],
        'start': pos[start_idx],
        'end': pos[end_idx] + 1,
        'quality': qual[start_idx],
    })


def create_bedgraph(alignment_filename, bedgraph_filename):
    """Origin-faithful k-mer realignments → per-position mapping-quality
    bedgraph intervals."""
    aligned = _origin_true_alignments(alignment_filename)
    aligned = aligned.sort_values(['chromosome', 'position'],
                                  kind='mergesort')
    _run_length_encode(aligned).to_csv(
        bedgraph_filename, sep='\t', index=False, header=False,
        columns=['chromosome', 'start', 'end', 'quality'])


def merge_files_by_line(in_filenames, out_filename):
    """Merge bedgraph shards into the mappability HDF5 store."""
    shards = pd.concat(
        [pd.read_csv(name, sep='\t', header=None,
                     names=['chromosome', 'start', 'end', 'quality'],
                     converters={'chromosome': str})
         for name in in_filenames.values()],
        ignore_index=True)

    with h5py.File(out_filename, 'w') as store:
        for chromosome, chrom_data in shards.groupby('chromosome'):
            group = store.create_group('chromosome_' + chromosome)
            for column in ('start', 'end', 'quality'):
                group.create_dataset(
                    column, data=chrom_data[column].values.astype(np.int64),
                    compression='gzip', compression_opts=4)
