"""Seqdata store: per-chromosome fragment and allele tables in HDF5.

Format parity with the reference store (/root/reference/remixt/
seqdataio.py:9-331): keys ``/fragments/chromosome_X`` and
``/alleles/chromosome_X``, globally unique fragment indices across appended
chunks, chunked streaming reads. Implemented on h5py with resizable
compressed column datasets (PyTables is absent in this environment).
"""

import os

import numpy as np
import pandas as pd
import h5py


FRAGMENT_COLUMNS = ['fragment_id', 'start', 'end', 'mapping_quality', 'is_duplicate']
ALLELE_COLUMNS = ['fragment_id', 'position', 'is_alt']

empty_data = {
    'fragments': pd.DataFrame(dtype=np.int32, columns=FRAGMENT_COLUMNS),
    'alleles': pd.DataFrame(dtype=np.int32, columns=ALLELE_COLUMNS),
}


def _get_key(record_type, chromosome):
    return '/{}/chromosome_{}'.format(record_type, chromosome)


def _append_table(f, key, data, columns):
    """Append dataframe rows to resizable per-column datasets, offsetting the
    index to stay globally unique (seqdataio.py:35-44)."""
    group = f.require_group(key)
    nrows = group.attrs.get('nrows', 0)
    for col in columns:
        values = data[col].values.astype(np.int64)
        if col not in group:
            group.create_dataset(
                col, data=values, maxshape=(None,), chunks=(1 << 18,),
                compression='gzip', compression_opts=4)
        else:
            ds = group[col]
            ds.resize((nrows + len(values),))
            ds[nrows:] = values
    group.attrs['nrows'] = nrows + len(data.index)


def _read_table(f, key, columns, record_type, start=None, stop=None):
    if key not in f:
        return empty_data[record_type].copy()
    group = f[key]
    data = {}
    for col in columns:
        ds = group[col]
        data[col] = ds[start:stop]
    return pd.DataFrame(data)


def _table_nrows(f, key):
    if key not in f:
        return 0
    return int(f[key].attrs.get('nrows', 0))


class Writer(object):
    """Streaming writer of seqdata files (seqdataio.py:154-199)."""

    def __init__(self, seqdata_filename):
        self.store = h5py.File(seqdata_filename, 'w')

    def write(self, chromosome, fragment_data, allele_data):
        """Append a chunk of fragment and allele data; nominal
        mapping_quality/is_duplicate added when missing."""
        fragment_data = fragment_data.copy()
        if 'mapping_quality' not in fragment_data:
            fragment_data['mapping_quality'] = 60
        if 'is_duplicate' not in fragment_data:
            fragment_data['is_duplicate'] = 0

        fragment_data = fragment_data[FRAGMENT_COLUMNS]
        allele_data = allele_data[ALLELE_COLUMNS]

        _append_table(self.store, _get_key('fragments', chromosome),
                      fragment_data, FRAGMENT_COLUMNS)
        _append_table(self.store, _get_key('alleles', chromosome),
                      allele_data, ALLELE_COLUMNS)

    def close(self):
        self.store.close()


def create_chromosome_seqdata(seqdata_filename, bam_filename, snp_filename,
                              chromosome, max_fragment_length, max_soft_clipped,
                              check_proper_pair):
    """Extract one chromosome's fragments/alleles from a BAM into a seqdata
    store (seqdataio.py:86-112). Requires the native BAM reader."""
    import remixt_jax.io.bamreader as bamreader

    reader = bamreader.AlleleReader(
        bam_filename, snp_filename, chromosome,
        max_fragment_length, max_soft_clipped, check_proper_pair)

    writer = Writer(seqdata_filename)
    try:
        while reader.ReadAlignments(10000000):
            writer.write(chromosome, reader.GetFragmentTable(), reader.GetAlleleTable())
    finally:
        writer.close()


def create_seqdata(seqdata_filename, bam_filename, snp_filename,
                   max_fragment_length, max_soft_clipped, check_proper_pair,
                   tempdir, chromosomes):
    """Extract all chromosomes then merge (seqdataio.py:116-135)."""
    os.makedirs(tempdir, exist_ok=True)

    all_seqdata = {}
    for chrom in chromosomes:
        chrom_seqdata = os.path.join(tempdir, '{}_seqdata.h5'.format(chrom))
        all_seqdata[chrom] = chrom_seqdata
        create_chromosome_seqdata(
            chrom_seqdata, bam_filename, snp_filename, chrom,
            max_fragment_length, max_soft_clipped, check_proper_pair)

    merge_seqdata(seqdata_filename, all_seqdata)


def merge_seqdata(out_filename, in_filenames):
    """Merge seqdata files for non-overlapping chromosome sets
    (seqdataio.py:138-151)."""
    with h5py.File(out_filename, 'w') as out_store:
        for in_filename in in_filenames.values():
            with h5py.File(in_filename, 'r') as in_store:
                def copy(name, obj):
                    if isinstance(obj, h5py.Group) and 'nrows' in obj.attrs:
                        in_store.copy(obj, out_store, name=name)
                in_store.visititems(copy)


def merge_overlapping_seqdata(outfile, infiles, chromosomes):
    """Merge seqdata files that may share chromosomes, reassigning fragment
    ids to stay unique (seqdataio.py:47-83)."""
    index_offsets = pd.Series(0, index=chromosomes, dtype=np.int64)

    with h5py.File(outfile, 'w') as out_store:
        for _id, infile in infiles.items():
            with h5py.File(infile, 'r') as store:
                for chromosome in chromosomes:
                    allele_key = _get_key('alleles', chromosome)
                    fragment_key = _get_key('fragments', chromosome)

                    if allele_key not in store or fragment_key not in store:
                        continue

                    alleles = _read_table(store, allele_key, ALLELE_COLUMNS, 'alleles')
                    fragments = _read_table(store, fragment_key, FRAGMENT_COLUMNS, 'fragments')

                    alleles['fragment_id'] += index_offsets[chromosome]
                    fragments['fragment_id'] += index_offsets[chromosome]

                    # .max() of an empty table is NaN, which would poison
                    # every subsequent offset (silent id corruption); an
                    # empty table simply contributes no new ids
                    id_maxes = [int(t['fragment_id'].max())
                                for t in (alleles, fragments) if len(t) > 0]
                    if id_maxes:
                        index_offsets[chromosome] = max(id_maxes) + 1

                    _append_table(out_store, allele_key, alleles, ALLELE_COLUMNS)
                    _append_table(out_store, fragment_key, fragments, FRAGMENT_COLUMNS)


def _filter_reads(reads, filter_duplicates, map_qual_threshold, keep_cols):
    if 'is_duplicate' in reads and filter_duplicates is not None:
        if filter_duplicates:
            reads = reads[reads['is_duplicate'] == 0]
        if not keep_cols:
            reads = reads.drop(['is_duplicate'], axis=1)
    if 'mapping_quality' in reads and map_qual_threshold is not None:
        reads = reads[reads['mapping_quality'] >= map_qual_threshold]
        if not keep_cols:
            reads = reads.drop(['mapping_quality'], axis=1)
    return reads


def read_seq_data(seqdata_filename, record_type, chromosome, chunksize=None,
                  post=lambda x: x):
    """Read one table, whole or as an iterator of chunks
    (seqdataio.py:231-251)."""
    columns = FRAGMENT_COLUMNS if record_type == 'fragments' else ALLELE_COLUMNS
    key = _get_key(record_type, chromosome)

    if chunksize is None:
        with h5py.File(seqdata_filename, 'r') as f:
            return post(_read_table(f, key, columns, record_type))

    def chunk_iter():
        with h5py.File(seqdata_filename, 'r') as f:
            nrows = _table_nrows(f, key)
            if nrows == 0:
                yield empty_data[record_type].copy()
                return
            for i in range(nrows // chunksize + 1):
                chunk = _read_table(f, key, columns, record_type,
                                    start=i * chunksize, stop=(i + 1) * chunksize)
                yield post(chunk)

    return chunk_iter()


def read_fragment_data(seqdata_filename, chromosome, filter_duplicates=False,
                       map_qual_threshold=1, keep_cols=False, chunksize=None):
    """Fragment table with duplicate/quality filtering (seqdataio.py:254-290)."""
    post = lambda reads: _filter_reads(reads, filter_duplicates,
                                       map_qual_threshold, keep_cols)
    return read_seq_data(seqdata_filename, 'fragments', chromosome,
                         chunksize=chunksize, post=post)


def read_allele_data(seqdata_filename, chromosome, chunksize=None):
    """Allele table (seqdataio.py:293-310)."""
    return read_seq_data(seqdata_filename, 'alleles', chromosome,
                         chunksize=chunksize)


def read_chromosomes(seqdata_filename):
    """Chromosomes present in a seqdata store (seqdataio.py:313-330)."""
    with h5py.File(seqdata_filename, 'r') as store:
        chromosomes = set()

        def visit(name, obj):
            if 'chromosome_' in name and isinstance(obj, h5py.Group):
                chromosomes.add(name[name.index('chromosome_') + len('chromosome_'):])
        store.visititems(visit)
        return chromosomes
