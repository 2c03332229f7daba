"""The device fit path needs only numpy, scipy and JAX: it imports and
runs with pandas, h5py, scikit-learn and PyYAML unavailable."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r'''
import sys
for name in ('pandas', 'h5py', 'sklearn', 'yaml'):
    sys.modules[name] = None   # any import of them raises ImportError

import types
import numpy as np

from remixt_jax.analysis import pipeline
from remixt_jax.simulations import simple as sim

data = sim.simulate_experiment(N=30, M=3, h=(0.08, 0.05, 0.025), cn_max=3,
                               num_events=3, seed=1, num_chains=2)
sample = types.SimpleNamespace(
    x=data['x'], l=data['l'], adjacencies=data['adjacencies'],
    breakpoints=data['breakpoints'], segment_chromosome_id=None)
grid = {i: dict(mode_idx=0, h_normal=0.08, h_tumour=0.075, mix_frac=mix,
                divergence_weight=1e-7, max_depth=1.0)
        for i, mix in enumerate((0.45, 0.3))}
config = {'max_copy_number': 3, 'num_em_iter': 1, 'num_update_iter': 1,
          'use_compilation_cache': False}
results = pipeline.fit_many(sample, grid, config)
best = pipeline.optimal_init_id(
    list(results), [r['stats']['elbo'] for r in results.values()],
    [r['stats']['proportion_divergent'] for r in results.values()], 0.5)
assert best in results and np.isfinite(results[best]['stats']['elbo'])
assert not any(name in sys.modules and sys.modules[name] is not None
               for name in ('pandas', 'h5py', 'sklearn', 'yaml'))
print('FIT_OK')
'''


def test_fit_path_runs_without_host_table_packages():
    env = dict(os.environ, JAX_PLATFORMS='cpu', PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 'FIT_OK' in proc.stdout
