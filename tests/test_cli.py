"""CLI and workflow-runner tests: fit from count tables, results export,
plots, HTML visualization, scheduler re-entrancy."""

import os
import json

import numpy as np
import pandas as pd
import pytest
import yaml

from remixt_jax.scheduler import Workflow
from remixt_jax.simulations import simple as sim
from test_pipeline import make_tables


def _write_tables(tmp, data):
    count_data, breakpoint_data = make_tables(data)
    count_file = str(tmp / 'counts.tsv')
    breakpoint_file = str(tmp / 'breakpoints.tsv')
    count_data.to_csv(count_file, sep='\t', index=False)
    breakpoint_data.to_csv(breakpoint_file, sep='\t', index=False)
    return count_file, breakpoint_file


@pytest.fixture(scope='module')
def cli_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('cli')
    data = sim.simulate_experiment(
        N=40, M=3, h=(0.08, 0.05, 0.025), cn_max=6,
        negbin_r=2000., betabin_M=2000., frac_genotyped=0.5, seed=7)
    count_file, breakpoint_file = _write_tables(tmp, data)

    config = {
        'max_copy_number': 6,
        'num_em_iter': 1,
        'num_update_iter': 2,
        'likelihood_min_segment_length': 1.0,
        'divergence_weights': [1e-7],
        'tumour_mix_fractions': [0.4],
        'engine_dtype': 'float64',
        'min_ploidy': 1.0,
        'max_ploidy': 8.0,
        'h_normal': 0.08,
        'h_tumour': 0.075,
    }
    config_file = str(tmp / 'config.yaml')
    with open(config_file, 'w') as f:
        yaml.dump(config, f)

    results_file = str(tmp / 'results.h5')

    import remixt_jax.ui.fit
    remixt_jax.ui.fit.fit(
        count_file=count_file,
        breakpoint_file=breakpoint_file,
        results_file=results_file,
        work_dir=str(tmp / 'work'),
        config=config_file,
        min_length=None,
    )
    return dict(tmp=tmp, results_file=results_file, data=data)


def test_fit_cli_results_exist(cli_results):
    assert os.path.exists(cli_results['results_file'])


def test_write_results_cli(cli_results):
    tmp = cli_results['tmp']
    import remixt_jax.ui.write_results
    remixt_jax.ui.write_results.write_results_tables(
        results_filename=cli_results['results_file'],
        cn_filename=str(tmp / 'cn.tsv'),
        brk_cn_filename=str(tmp / 'brk_cn.tsv'),
        meta_filename=str(tmp / 'meta.yaml'),
        max_ploidy=None, min_ploidy=None,
        max_proportion_divergent=0.5,
    )
    cn = pd.read_csv(str(tmp / 'cn.tsv'), sep='\t')
    assert 'major_1' in cn.columns
    meta = yaml.safe_load(open(str(tmp / 'meta.yaml')))
    assert 'elbo' in meta
    assert len(meta['mix']) == 3


def test_plot_results_cli(cli_results):
    tmp = cli_results['tmp']
    import remixt_jax.ui.plot_results
    for plot_type in ['raw', 'scatter', 'depth']:
        plot_file = str(tmp / f'plot_{plot_type}.png')
        remixt_jax.ui.plot_results.create_plot(
            results=cli_results['results_file'],
            plot_file=plot_file,
            plot_type=plot_type,
        )
        assert os.path.getsize(plot_file) > 0


def test_visualize_solutions_cli(cli_results):
    tmp = cli_results['tmp']
    import remixt_jax.ui.visualize_solutions
    html_file = str(tmp / 'solutions.html')
    remixt_jax.ui.visualize_solutions.create_visualization(
        results=cli_results['results_file'], html=html_file)
    html = open(html_file).read()
    assert 'remixt-jax solutions' in html
    assert 'major_raw' in html
    # the read-depth density panel (reference solutions view,
    # visualize.py:469-530) embeds its curves when the store carries
    # /read_depth — the collated results store always does
    assert '"read_depth": {' in html
    assert '"minor_modes"' in html


def test_main_parser():
    import remixt_jax.ui.main  # importable; subcommands registered
    assert hasattr(remixt_jax.ui.main, 'main')


# -- scheduler ---------------------------------------------------------------

def _write_file(path, content):
    with open(path, 'w') as f:
        f.write(content)


def _concat_files(out, *ins):
    with open(out, 'w') as f:
        for i in ins:
            f.write(open(i).read())


def test_scheduler_dag_and_resume(tmp_path):
    a = str(tmp_path / 'a.txt')
    b = str(tmp_path / 'b.txt')
    c = str(tmp_path / 'c.txt')

    def build():
        wf = Workflow('test')
        wf.transform('write_a', _write_file, args=(a, 'A'), outputs=[a])
        wf.transform('write_b', _write_file, args=(b, 'B'), outputs=[b])
        wf.transform('concat', _concat_files, args=(c, a, b),
                     inputs=[a, b], outputs=[c])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert open(c).read() == 'AB'

    # resume: tamper with c, rerun — completed tasks skipped, c untouched
    # unless inputs changed
    _write_file(c, 'TAMPERED')
    build().run(workdir)
    assert open(c).read() == 'TAMPERED' or open(c).read() == 'AB'

    # touching an input forces downstream rerun
    import time
    time.sleep(0.01)
    _write_file(a, 'A2')
    build().run(workdir)
    assert open(c).read() == 'A2B'


def test_scheduler_ret_values(tmp_path):
    def produce():
        return {'x': 41}

    def consume(out, value):
        _write_file(out, str(value + 1))

    out = str(tmp_path / 'out.txt')
    wf = Workflow('retvals')
    ret = wf.transform('produce', produce)
    wf.transform('consume', consume, args=(out, ret['x']), outputs=[out])
    wf.run(str(tmp_path / 'work'))
    assert open(out).read() == '42'


def test_scheduler_missing_ret_reruns(tmp_path):
    """A surviving sentinel whose return pickle is gone must not resume as
    completed — that would feed None into downstream task arguments."""
    out = str(tmp_path / 'out.txt')

    def produce():
        return {'x': 41}

    def consume(filename, value):
        _write_file(filename, str(value + 1))

    def build():
        wf = Workflow('retloss')
        ret = wf.transform('produce', produce)
        wf.transform('consume', consume, args=(out, ret['x']), outputs=[out])
        return wf

    workdir = str(tmp_path / 'work')
    build().run(workdir)
    assert open(out).read() == '42'

    os.remove(os.path.join(workdir, '.ret_produce.pickle'))
    os.remove(out)
    build().run(workdir)
    assert open(out).read() == '42'


def test_scheduler_parallel(tmp_path):
    outs = [str(tmp_path / f'f{i}.txt') for i in range(4)]
    wf = Workflow('par')
    for i, out in enumerate(outs):
        wf.transform(f'write_{i}', _write_file, args=(out, str(i)), outputs=[out])
    merged = str(tmp_path / 'merged.txt')
    wf.transform('merge', _concat_files, args=tuple([merged] + outs),
                 inputs=outs, outputs=[merged])
    wf.run(str(tmp_path / 'work'), max_jobs=3)
    assert open(merged).read() == '0123'


def _record_span(path, seconds):
    import time
    start = time.time()
    time.sleep(seconds)
    _write_file(path, '{} {} {}'.format(os.getpid(), start, time.time()))


def test_scheduler_runs_device_tasks_one_at_a_time(tmp_path):
    """Device tasks queue in one worker process (a second process on the
    card would fail for want of memory); host tasks keep the pool."""
    wf = Workflow('device')
    spans = {}
    for kind, n in (('device', 3), ('host', 3)):
        for i in range(n):
            path = str(tmp_path / f'{kind}{i}.txt')
            spans[(kind, i)] = path
            wf.transform(f'{kind}_{i}', _record_span, args=(path, 0.3),
                         outputs=[path], uses_device=(kind == 'device'))
    wf.run(str(tmp_path / 'work'), max_jobs=4)

    def read(path):
        pid, start, end = open(path).read().split()
        return int(pid), float(start), float(end)

    device = sorted(read(p) for (kind, _), p in spans.items()
                    if kind == 'device')
    host = [read(p) for (kind, _), p in spans.items() if kind == 'host']
    assert len({pid for pid, _, _ in device}) == 1
    for (_, _, end), (_, start, _) in zip(
            sorted(device, key=lambda s: s[1]),
            sorted(device, key=lambda s: s[1])[1:]):
        assert end <= start
    assert device[0][0] not in {pid for pid, _, _ in host}
    assert os.getpid() not in {pid for pid, _, _ in device + host}
