"""Cohort fit stage: multi-sample workflow through the scheduler.

The production consumer of parallel/distributed.cohort_partition: a multi-tumour run fits every sample's restart grid
through ONE cohort task, samples distributed over disjoint device groups
(analysis/pipeline.fit_many_cohort). Reference analog: per-``tumour_id``
fit-workflow fan-out (/root/reference/remixt/workflow.py:384-391).
"""

import pickle

import numpy as np
import pytest

from remixt_jax.analysis.experiment import Experiment
from remixt_jax.io.hdf5 import HDFStore
from remixt_jax.simulations import simple as sim
from remixt_jax import workflow as wf

from test_pipeline import make_tables


@pytest.mark.parametrize('seeds', [((22, 26))])
def test_fit_cohort_workflow(tmp_path, seeds):
    """create_fit_cohort_workflow runs init → cohort fit → collate for two
    samples through the scheduler and writes both results stores."""
    config = {
        'max_copy_number': 6,
        'num_em_iter': 1,
        'num_update_iter': 2,
        'divergence_weights': [1e-7],
        'tumour_mix_fractions': [0.4],
        'engine_dtype': 'float64',
        'min_ploidy': 1.0,
        'max_ploidy': 8.0,
        'h_normal': 0.08,
        'h_tumour': 0.075,
    }

    experiment_filenames = {}
    results_filenames = {}
    for sid, seed in zip(('sampleA', 'sampleB'), seeds):
        data = sim.simulate_experiment(
            N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
            negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=seed)
        count_data, breakpoint_data = make_tables(data)
        experiment_filename = str(tmp_path / f'experiment_{sid}.pickle')
        with open(experiment_filename, 'wb') as f:
            pickle.dump(Experiment(count_data, breakpoint_data), f)
        experiment_filenames[sid] = experiment_filename
        results_filenames[sid] = str(tmp_path / f'results_{sid}.h5')

    workflow = wf.create_fit_cohort_workflow(
        experiment_filenames, results_filenames, config,
        str(tmp_path / 'ref'), str(tmp_path / 'tmp'))
    workflow.run(str(tmp_path / 'work'), max_jobs=1)

    for sid, filename in results_filenames.items():
        with HDFStore(filename, 'r') as store:
            stats = store['stats']
            assert len(stats.index) >= 1, sid
            assert np.all(np.isfinite(stats['elbo'].values)), sid
            cn = store['cn']
            assert 'major_1' in cn.columns and len(cn.index) > 0, sid

    # resume: a second run must be a fast no-op (all outputs present)
    workflow2 = wf.create_fit_cohort_workflow(
        experiment_filenames, results_filenames, config,
        str(tmp_path / 'ref'), str(tmp_path / 'tmp'))
    import time
    t0 = time.time()
    workflow2.run(str(tmp_path / 'work'), max_jobs=1)
    assert time.time() - t0 < 30.0


def test_cohort_pins_each_sample_to_its_group(tmp_path, monkeypatch):
    """With more samples than devices, every group is one device: each
    sample's arrays must live on its own group's device, and a group's
    samples run one after another on that group's single worker."""
    import threading

    import jax
    from remixt_jax.analysis import pipeline

    devices = jax.devices()[:2]
    monkeypatch.setattr(jax, 'devices', lambda *args, **kwargs: list(devices))

    config = {
        'max_copy_number': 6,
        'num_em_iter': 1,
        'num_update_iter': 1,
        'divergence_weights': [1e-7],
        'tumour_mix_fractions': [0.4],
        'engine_dtype': 'float64',
        'min_ploidy': 1.0,
        'max_ploidy': 8.0,
        'h_normal': 0.08,
        'h_tumour': 0.075,
        'restart_chunk_size': 2,
    }
    experiments = {}
    init_params_dicts = {}
    for sid, seed in (('s0', 22), ('s1', 26), ('s2', 31)):
        data = sim.simulate_experiment(
            N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
            negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=seed)
        experiments[sid] = Experiment(*make_tables(data))
        experiment_filename = str(tmp_path / f'experiment_{sid}.pickle')
        with open(experiment_filename, 'wb') as f:
            pickle.dump(experiments[sid], f)
        init_params_dicts[sid] = pipeline.init(
            str(tmp_path / f'init_{sid}.h5'), experiment_filename, config)

    sample_of = {id(e): sid for sid, e in experiments.items()}
    placed = {sid: set() for sid in experiments}
    threads = {}
    extract = pipeline._extract_results

    def spy(model, experiment, init_params, config):
        sid = sample_of[id(experiment)]
        placed[sid].update(model.params.h.devices())
        placed[sid].update(model.state.posterior_marginals.devices())
        threads.setdefault(sid, set()).add(threading.get_ident())
        return extract(model, experiment, init_params, config)

    monkeypatch.setattr(pipeline, '_extract_results', spy)
    results = pipeline.fit_many_cohort(experiments, init_params_dicts, config)

    assert list(results) == ['s0', 's1', 's2']
    # samples are dealt round-robin over the two one-device groups
    assert placed == {'s0': {devices[0]}, 's1': {devices[1]},
                      's2': {devices[0]}}
    assert threads['s0'] == threads['s2'] != threads['s1']
    for sid, fits in results.items():
        for fit in fits.values():
            assert np.isfinite(fit['stats']['elbo']), sid
