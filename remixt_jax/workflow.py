"""Workflow factories: the end-to-end pipeline DAGs.

Mirrors the reference's seven pypeliner workflow builders
(/root/reference/remixt/workflow.py:8-549) on the make-style runner
(:mod:`remixt_jax.scheduler`): BAM extraction, haplotype inference, GC bias,
count preparation, model fitting, and the composed seqdata/bam pipelines.
Chromosome and sample axes fan out as independent tasks; the restart axis of
model fitting stays on-device (analysis/pipeline.py fits all restarts in one
process).
"""

import os

import remixt_jax.config
from remixt_jax.scheduler import Workflow

import remixt_jax.seqdataio
import remixt_jax.utils
import remixt_jax.analysis.segment
import remixt_jax.analysis.haplotype
import remixt_jax.analysis.readcount
import remixt_jax.analysis.stats
import remixt_jax.analysis.gcbias
import remixt_jax.analysis.experiment
import remixt_jax.analysis.pipeline
import remixt_jax.cn_plot


def _temp(tempdir, *parts):
    path = os.path.join(tempdir, *[str(p) for p in parts])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def create_extract_seqdata_workflow(bam_filename, seqdata_filename, config,
                                    ref_data_dir, tempdir,
                                    no_parallelism=False):
    """BAM → seqdata, chromosome-sharded (workflow.py:8-70)."""
    chromosomes = remixt_jax.config.get_chromosomes(config, ref_data_dir)
    snp_positions_filename = remixt_jax.config.get_filename(
        config, ref_data_dir, 'snp_positions')

    bam_max_fragment_length = remixt_jax.config.get_param(config, 'bam_max_fragment_length')
    bam_max_soft_clipped = remixt_jax.config.get_param(config, 'bam_max_soft_clipped')
    bam_check_proper_pair = remixt_jax.config.get_param(config, 'bam_check_proper_pair')

    workflow = Workflow('extract_seqdata')

    if no_parallelism:
        workflow.transform(
            'create_seqdata',
            remixt_jax.seqdataio.create_seqdata,
            args=(seqdata_filename, bam_filename, snp_positions_filename,
                  bam_max_fragment_length, bam_max_soft_clipped,
                  bam_check_proper_pair, _temp(tempdir, 'seqdata_temp'),
                  chromosomes),
            inputs=[bam_filename],
            outputs=[seqdata_filename],
        )
        return workflow

    chrom_files = {}
    for chromosome in chromosomes:
        chrom_file = _temp(tempdir, 'seqdata', f'{chromosome}.h5')
        chrom_files[chromosome] = chrom_file
        workflow.transform(
            f'create_chromosome_seqdata_{chromosome}',
            remixt_jax.seqdataio.create_chromosome_seqdata,
            args=(chrom_file, bam_filename, snp_positions_filename, chromosome,
                  bam_max_fragment_length, bam_max_soft_clipped,
                  bam_check_proper_pair),
            inputs=[bam_filename],
            outputs=[chrom_file],
        )

    workflow.transform(
        'merge_seqdata',
        remixt_jax.seqdataio.merge_seqdata,
        args=(seqdata_filename, chrom_files),
        inputs=list(chrom_files.values()),
        outputs=[seqdata_filename],
    )

    return workflow


def create_infer_haps_workflow(seqdata_filenames, haps_filename, config,
                               ref_data_dir, tempdir, normal_id=None):
    """SNP genotyping + phasing, chromosome-sharded (workflow.py:72-146)."""
    chromosomes = remixt_jax.config.get_chromosomes(config, ref_data_dir)

    workflow = Workflow('infer_haps')

    snp_genotype_files = {}
    haps_files = {}
    for chromosome in chromosomes:
        snp_genotype_file = _temp(tempdir, 'snp_genotype', f'{chromosome}.tsv')
        snp_genotype_files[chromosome] = snp_genotype_file

        if normal_id is not None:
            workflow.transform(
                f'infer_snp_genotype_from_normal_{chromosome}',
                remixt_jax.analysis.haplotype.infer_snp_genotype_from_normal,
                args=(snp_genotype_file, seqdata_filenames[normal_id],
                      chromosome, config),
                inputs=[seqdata_filenames[normal_id]],
                outputs=[snp_genotype_file],
            )
        else:
            workflow.transform(
                f'infer_snp_genotype_from_tumour_{chromosome}',
                remixt_jax.analysis.haplotype.infer_snp_genotype_from_tumour,
                args=(snp_genotype_file, seqdata_filenames, chromosome, config),
                inputs=list(seqdata_filenames.values()),
                outputs=[snp_genotype_file],
            )

        haps_file = _temp(tempdir, 'haps', f'{chromosome}.tsv')
        haps_files[chromosome] = haps_file
        workflow.transform(
            f'infer_haps_{chromosome}',
            remixt_jax.analysis.haplotype.infer_haps,
            args=(haps_file, snp_genotype_file, chromosome,
                  _temp(tempdir, 'haplotyping', chromosome), config, ref_data_dir),
            inputs=[snp_genotype_file],
            outputs=[haps_file],
        )

    workflow.transform(
        'merge_haps',
        remixt_jax.utils.merge_tables,
        args=tuple([haps_filename] + list(haps_files.values())),
        inputs=list(haps_files.values()),
        outputs=[haps_filename],
    )

    return workflow


def create_calc_bias_workflow(tumour_seqdata_filename, segment_filename,
                              segment_length_filename, config, ref_data_dir,
                              tempdir):
    """Fragment stats → GC sampling → LOWESS → per-segment bias → effective
    length (workflow.py:148-237)."""
    workflow = Workflow('calc_bias')

    fragstats = workflow.transform(
        'calc_fragment_stats',
        remixt_jax.analysis.stats.calculate_fragment_stats,
        args=(tumour_seqdata_filename, config),
        inputs=[tumour_seqdata_filename],
    )

    gcsamples_file = _temp(tempdir, 'gcsamples.tsv')
    workflow.transform(
        'sample_gc',
        remixt_jax.analysis.gcbias.sample_gc,
        args=(gcsamples_file, tumour_seqdata_filename,
              fragstats.prop('fragment_mean'), config, ref_data_dir),
        inputs=[tumour_seqdata_filename],
        outputs=[gcsamples_file],
    )

    gcloess_file = _temp(tempdir, 'gcloess.tsv')
    gctable_file = _temp(tempdir, 'gctable.tsv')
    workflow.transform(
        'gc_lowess',
        remixt_jax.analysis.gcbias.gc_lowess,
        args=(gcsamples_file, gcloess_file, gctable_file),
        inputs=[gcsamples_file],
        outputs=[gcloess_file, gctable_file],
    )

    biases_file = _temp(tempdir, 'biases.tsv')
    workflow.transform(
        'gc_map_bias',
        remixt_jax.analysis.gcbias.gc_map_bias,
        args=(segment_filename, fragstats.prop('fragment_mean'),
              fragstats.prop('fragment_stddev'), gcloess_file, biases_file,
              config, ref_data_dir),
        inputs=[segment_filename, gcloess_file],
        outputs=[biases_file],
    )

    workflow.transform(
        'biased_length',
        remixt_jax.analysis.gcbias.biased_length,
        args=(segment_length_filename, biases_file),
        inputs=[biases_file],
        outputs=[segment_length_filename],
    )

    return workflow


def create_prepare_counts_workflow(segment_filename, haplotypes_filename,
                                   tumour_filenames, count_filenames, config,
                                   tempdir):
    """Segment + allele read counts, phased across tumours
    (workflow.py:239-305)."""
    workflow = Workflow('prepare_counts')

    segment_counts_files = {}
    allele_counts_files = {}
    phased_counts_files = {}
    for tumour_id, seqdata_filename in tumour_filenames.items():
        segment_counts_file = _temp(tempdir, 'segment_counts', f'{tumour_id}.tsv')
        segment_counts_files[tumour_id] = segment_counts_file
        workflow.transform(
            f'segment_readcount_{tumour_id}',
            remixt_jax.analysis.readcount.segment_readcount,
            args=(segment_counts_file, segment_filename, seqdata_filename, config),
            inputs=[segment_filename, seqdata_filename],
            outputs=[segment_counts_file],
        )

        allele_counts_file = _temp(tempdir, 'allele_counts', f'{tumour_id}.tsv')
        allele_counts_files[tumour_id] = allele_counts_file
        workflow.transform(
            f'haplotype_allele_readcount_{tumour_id}',
            remixt_jax.analysis.readcount.haplotype_allele_readcount,
            args=(allele_counts_file, segment_filename, seqdata_filename,
                  haplotypes_filename, config),
            inputs=[segment_filename, seqdata_filename, haplotypes_filename],
            outputs=[allele_counts_file],
        )

        phased_counts_files[tumour_id] = _temp(
            tempdir, 'phased_allele_counts', f'{tumour_id}.tsv')

    workflow.transform(
        'phase_segments',
        remixt_jax.analysis.readcount.phase_segments,
        args=(allele_counts_files, phased_counts_files),
        inputs=list(allele_counts_files.values()),
        outputs=list(phased_counts_files.values()),
    )

    for tumour_id in tumour_filenames:
        workflow.transform(
            f'prepare_readcount_table_{tumour_id}',
            remixt_jax.analysis.readcount.prepare_readcount_table,
            args=(segment_counts_files[tumour_id],
                  phased_counts_files[tumour_id],
                  count_filenames[tumour_id]),
            inputs=[segment_counts_files[tumour_id], phased_counts_files[tumour_id]],
            outputs=[count_filenames[tumour_id]],
        )

    return workflow


def create_fit_model_workflow(experiment_filename, results_filename, config,
                              ref_data_dir, tempdir, tumour_id=None):
    """init → all restarts (device-parallel, one process) → collate
    (workflow.py:307-355)."""
    config = remixt_jax.config.get_sample_config(config, tumour_id)

    workflow = Workflow('fit_model')

    init_results_file = _temp(tempdir, 'init_results.h5')
    init_ret = workflow.transform(
        'init',
        remixt_jax.analysis.pipeline.init,
        args=(init_results_file, experiment_filename, config),
        inputs=[experiment_filename],
        outputs=[init_results_file],
    )

    fit_results_dir = _temp(tempdir, 'fit_results', 'x')
    fit_results_dir = os.path.dirname(fit_results_dir)
    fit_ret = workflow.transform(
        'fit',
        fit_all_restarts,
        args=(fit_results_dir, experiment_filename, init_ret, config),
        inputs=[experiment_filename],
        uses_device=True,
    )

    workflow.transform(
        'collate',
        remixt_jax.analysis.pipeline.collate,
        args=(results_filename, experiment_filename, init_results_file,
              fit_ret, config),
        inputs=[experiment_filename, init_results_file],
        outputs=[results_filename],
    )

    return workflow


def fit_all_restarts(fit_results_dir, experiment_filename, init_params, config):
    """Run every restart fit in-process, sharing one model so the state
    space and compiled engine are reused across the whole restart grid.
    Returns {init_id: results_filename}."""
    import pickle

    os.makedirs(fit_results_dir, exist_ok=True)

    with open(experiment_filename, 'rb') as f:
        experiment = pickle.load(f)

    all_results = remixt_jax.analysis.pipeline.fit_many(
        experiment, init_params, config)

    fit_results_filenames = {}
    for init_id, fit_results in all_results.items():
        results_filename = os.path.join(fit_results_dir, f'fit_{init_id}.pickle')
        with open(results_filename, 'wb') as f:
            pickle.dump(fit_results, f)
        fit_results_filenames[init_id] = results_filename
    return fit_results_filenames


def create_fit_cohort_workflow(experiment_filenames, results_filenames,
                               config, ref_data_dir, tempdir):
    """Multi-sample fit stage: per-sample init → ONE cohort fit task
    (samples distributed over disjoint device groups,
    analysis/pipeline.fit_many_cohort) → per-sample collate.

    The device-mesh replacement for the reference's per-``tumour_id``
    cluster fan-out of fit jobs (workflow.py:384-391); a single process
    drives all devices (a second process on a card would fail for want
    of memory).
    """
    workflow = Workflow('fit_cohort')

    init_results_files = {}
    init_rets = {}
    for sample_id, experiment_filename in experiment_filenames.items():
        sample_config = remixt_jax.config.get_sample_config(config, sample_id)
        init_results_file = _temp(tempdir, f'init_results_{sample_id}.h5')
        init_results_files[sample_id] = init_results_file
        init_rets[sample_id] = workflow.transform(
            f'init_{sample_id}',
            remixt_jax.analysis.pipeline.init,
            args=(init_results_file, experiment_filename, sample_config),
            inputs=[experiment_filename],
            outputs=[init_results_file],
        )

    fit_results_dir = os.path.dirname(_temp(tempdir, 'fit_results', 'x'))
    fit_ret = workflow.transform(
        'fit_cohort',
        fit_cohort_restarts,
        args=(fit_results_dir, dict(experiment_filenames), init_rets, config),
        inputs=list(experiment_filenames.values()),
        uses_device=True,
    )

    for sample_id, experiment_filename in experiment_filenames.items():
        sample_config = remixt_jax.config.get_sample_config(config, sample_id)
        workflow.transform(
            f'collate_{sample_id}',
            remixt_jax.analysis.pipeline.collate,
            args=(results_filenames[sample_id], experiment_filename,
                  init_results_files[sample_id], fit_ret[sample_id],
                  sample_config),
            inputs=[experiment_filename, init_results_files[sample_id]],
            outputs=[results_filenames[sample_id]],
        )

    return workflow


def fit_cohort_restarts(fit_results_dir, experiment_filenames,
                        init_params_per_sample, config):
    """Cohort fit task: every sample's restart grid, samples concurrent on
    disjoint device groups. Returns {sample_id: {init_id: filename}}."""
    import pickle

    experiments = {}
    for sample_id, filename in experiment_filenames.items():
        with open(filename, 'rb') as f:
            experiments[sample_id] = pickle.load(f)

    all_results = remixt_jax.analysis.pipeline.fit_many_cohort(
        experiments, init_params_per_sample, config)

    out = {}
    for sample_id, sample_results in all_results.items():
        sample_dir = os.path.join(fit_results_dir, str(sample_id))
        os.makedirs(sample_dir, exist_ok=True)
        out[sample_id] = {}
        for init_id, fit_results in sample_results.items():
            results_filename = os.path.join(
                sample_dir, f'fit_{init_id}.pickle')
            with open(results_filename, 'wb') as f:
                pickle.dump(fit_results, f)
            out[sample_id][init_id] = results_filename
    return out


def create_remixt_seqdata_workflow(breakpoint_filename, seqdata_filenames,
                                   results_filenames, raw_data_directory,
                                   config, ref_data_dir, normal_id=None):
    """seqdata → results: segments, haplotypes, counts, bias, experiment,
    ploidy plots, fits (workflow.py:357-487)."""
    chromosomes = remixt_jax.config.get_chromosomes(config, ref_data_dir)

    tumour_ids = list(seqdata_filenames.keys())
    if normal_id is not None:
        tumour_ids.remove(normal_id)

    segment_filename = os.path.join(raw_data_directory, 'segments.tsv')
    haplotypes_filename = os.path.join(raw_data_directory, 'haplotypes.tsv')
    counts_table_template = os.path.join(raw_data_directory, 'counts', 'sample_{tumour_id}.tsv')
    experiment_template = os.path.join(raw_data_directory, 'experiment', 'sample_{tumour_id}.pickle')
    ploidy_plots_template = os.path.join(raw_data_directory, 'ploidy_plots', 'sample_{tumour_id}.pdf')
    tempdir = os.path.join(raw_data_directory, 'tmp')

    os.makedirs(raw_data_directory, exist_ok=True)

    workflow = Workflow('remixt_seqdata')

    workflow.transform(
        'create_segments',
        remixt_jax.analysis.segment.create_segments,
        args=(segment_filename, config, ref_data_dir),
        kwargs={'breakpoint_filename': breakpoint_filename},
        inputs=[breakpoint_filename],
        outputs=[segment_filename],
    )

    workflow.subworkflow('infer_haps_workflow', create_infer_haps_workflow(
        seqdata_filenames, haplotypes_filename, config, ref_data_dir,
        os.path.join(tempdir, 'haps'), normal_id=normal_id))

    raw_counts_files = {
        tumour_id: _temp(tempdir, 'rawcounts', f'{tumour_id}.tsv')
        for tumour_id in tumour_ids}
    workflow.subworkflow('prepare_counts_workflow', create_prepare_counts_workflow(
        segment_filename, haplotypes_filename,
        {tid: seqdata_filenames[tid] for tid in tumour_ids},
        raw_counts_files, config, os.path.join(tempdir, 'counts')))

    for tumour_id in tumour_ids:
        counts_file = counts_table_template.format(tumour_id=tumour_id)
        os.makedirs(os.path.dirname(counts_file), exist_ok=True)
        workflow.subworkflow(f'calc_bias_workflow_{tumour_id}', create_calc_bias_workflow(
            seqdata_filenames[tumour_id], raw_counts_files[tumour_id],
            counts_file, config, ref_data_dir,
            os.path.join(tempdir, 'bias', str(tumour_id))))

        experiment_file = experiment_template.format(tumour_id=tumour_id)
        os.makedirs(os.path.dirname(experiment_file), exist_ok=True)
        workflow.transform(
            f'create_experiment_{tumour_id}',
            remixt_jax.analysis.experiment.create_experiment,
            args=(counts_file, breakpoint_filename, experiment_file),
            inputs=[counts_file, breakpoint_filename],
            outputs=[experiment_file],
        )

        plots_file = ploidy_plots_template.format(tumour_id=tumour_id)
        os.makedirs(os.path.dirname(plots_file), exist_ok=True)
        workflow.transform(
            f'ploidy_analysis_plots_{tumour_id}',
            remixt_jax.cn_plot.ploidy_analysis_plots,
            args=(experiment_file, plots_file),
            kwargs={'chromosomes': chromosomes},
            inputs=[experiment_file],
            outputs=[plots_file],
        )

    # fit stage: multi-tumour cohorts go through ONE cohort fit workflow
    # (samples over disjoint device groups — the reference's per-tumour
    # cluster fan-out, workflow.py:384-391, as device-level SPMD); a single
    # sample keeps the per-sample fit workflow
    if len(tumour_ids) > 1:
        workflow.subworkflow('fit_cohort_workflow', create_fit_cohort_workflow(
            {tid: experiment_template.format(tumour_id=tid)
             for tid in tumour_ids},
            {tid: results_filenames[tid] for tid in tumour_ids},
            config, ref_data_dir, os.path.join(tempdir, 'fit')))
    else:
        for tumour_id in tumour_ids:
            workflow.subworkflow(f'fit_model_{tumour_id}', create_fit_model_workflow(
                experiment_template.format(tumour_id=tumour_id),
                results_filenames[tumour_id], config, ref_data_dir,
                os.path.join(tempdir, 'fit', str(tumour_id)),
                tumour_id=tumour_id))

    return workflow


def create_remixt_bam_workflow(breakpoint_filename, bam_filenames,
                               results_filenames, raw_data_directory, config,
                               ref_data_dir, normal_id=None):
    """BAM → results: the full pipeline (workflow.py:490-549)."""
    sample_ids = list(bam_filenames.keys())

    seqdata_template = os.path.join(raw_data_directory, 'seqdata', 'sample_{sample_id}.h5')
    tempdir = os.path.join(raw_data_directory, 'tmp')

    os.makedirs(raw_data_directory, exist_ok=True)

    workflow = Workflow('remixt_bam')

    seqdata_filenames = {}
    for sample_id in sample_ids:
        seqdata_file = seqdata_template.format(sample_id=sample_id)
        os.makedirs(os.path.dirname(seqdata_file), exist_ok=True)
        seqdata_filenames[sample_id] = seqdata_file
        workflow.subworkflow(
            f'extract_seqdata_workflow_{sample_id}',
            create_extract_seqdata_workflow(
                bam_filenames[sample_id], seqdata_file, config, ref_data_dir,
                os.path.join(tempdir, 'extract', str(sample_id))))

    workflow.subworkflow('remixt_seqdata_workflow', create_remixt_seqdata_workflow(
        breakpoint_filename, seqdata_filenames, results_filenames,
        raw_data_directory, config, ref_data_dir, normal_id=normal_id))

    return workflow
