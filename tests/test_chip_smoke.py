"""chip_smoke.py: its refusal without a GPU, and each phase rehearsed on
the CPU at a tiny size (the full-width run needs the card)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    env.pop('PYTHONPATH', None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _assert_refused(proc):
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_smoke_refuses_the_cpu():
    proc = _run_smoke(REPO, 'chip_smoke.py')
    _assert_refused(proc)
    assert 'needs a GPU' in proc.stderr


def test_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    _assert_refused(_run_smoke(str(tmp_path), 'chip_smoke.py'))


def test_phase_device_refuses_the_cpu():
    with pytest.raises(RuntimeError, match='needs a GPU'):
        chip_smoke.phase_device()


TINY = dict(N=40, num_events=4, num_chains=2, max_copy_number=3)


def _tiny(seed=0):
    sample, data = chip_smoke.simulate_sample(seed, **TINY)
    config = dict(chip_smoke.fit_config(3, num_em_iter=1, num_update_iter=2),
                  tumour_mix_fractions=[0.45, 0.3],
                  divergence_weights=[1e-7], restart_chunk_size=2)
    return sample, data, config, chip_smoke.restart_grid(data, config)


def test_restart_grid_and_truth_measure():
    sample, data, config, grid = _tiny()
    assert len(grid) == 4
    assert {g['mode_idx'] for g in grid.values()} == {0, 1}
    assert len({g['max_depth'] for g in grid.values()}) == 1
    assert sample.x.shape == (TINY['N'], 3)
    # the truth decodes to itself; one wrong segment costs its length
    h = np.asarray(chip_smoke.H_TRUE)
    assert chip_smoke.dominant_cn_fraction(data['cn'], h, data) == 1.0
    cn = data['cn'].copy()
    cn[0, 1 + np.argmax(h[1:]), :] += 1
    expect = 1.0 - data['l'][0] / data['l'].sum()
    assert chip_smoke.dominant_cn_fraction(cn, h, data) == pytest.approx(expect)


def test_phases_compile_fit_and_reference(capsys):
    sample, data, config, grid = _tiny()
    wave = config['restart_chunk_size']
    _, spec, params_b, state_b = chip_smoke.phase_compile(
        sample, grid, config, wave)
    results, timings, accuracy = chip_smoke.phase_grid_fit(
        sample, data, grid, config, (spec, params_b, state_b))
    assert set(timings) == {'cold', 'warm'} and 0.0 <= accuracy <= 1.0
    assert set(results) == set(grid)
    norm_rel, marg_abs, argmax = chip_smoke.phase_reference(
        sample, grid, config, wave, (spec, params_b, state_b))
    # the reference ran on the same backend here
    assert (norm_rel, marg_abs, argmax) == (0.0, 0.0, 0.0)
    out = capsys.readouterr().out
    assert out.count('memory_analysis') == 3
    assert 'grid fit cold' in out and 'grid fit warm' in out
