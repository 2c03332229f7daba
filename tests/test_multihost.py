"""2-process jax.distributed smoke test (DCN-style mesh on one machine).

Real N>=2-host runs need hardware this environment lacks; this test proves
the multi-host ENTRY POINTS work: two separate processes bring up the
jax.distributed runtime through parallel.distributed.initialize, build the
global (restart, chain, block) training mesh over both processes' devices,
and run a restart-sharded variational sweep whose cross-process shards
match single-device execution (tests/multihost_worker.py). The scaling
model for real multi-host deployments is documented in docs/DESIGN.md
("Multi-host scaling model").
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def test_two_process_distributed_sweep():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, 'tests', 'multihost_worker.py')
    port = _free_port()

    env = dict(os.environ)
    env['JAX_PLATFORMS'] = 'cpu'
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    env['PYTHONPATH'] = repo

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), '2', str(port)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]

    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=300)
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()

    for pid, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, (
            'worker {} failed:\n{}'.format(pid, out))
        assert 'MULTIHOST_WORKER_OK process={}'.format(pid) in out
