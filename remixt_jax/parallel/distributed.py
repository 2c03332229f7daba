"""Multi-host runtime: jax.distributed init, global meshes, cohort sharding.

The reference's only distributed backend is cluster job scheduling
(pypeliner qsub — SURVEY §2.4); the device-mesh equivalents here are:

* :func:`initialize` — bring up the ``jax.distributed`` runtime so every
  host sees the global device set.  Pass the coordinator address, the
  process count and this process's id; without them the call is a no-op
  on hosts where JAX finds no cluster.
* :func:`make_training_mesh` — the framework's global mesh:
  ``(restart, chain, block)`` axes over all devices.  Restarts are the
  cheapest axis (fully independent fits), chains communicate nothing
  inside the scan, and the block axis carries the intra-chain
  transfer-matrix exchange (ops/fb_blocked.py) — so the mesh is laid out
  restart-outermost (across hosts) and block-innermost (within a host).
* :func:`cohort_partition` — the cohort axis: a patient cohort is
  embarrassingly parallel across hosts, each host fitting its share of
  samples over its local mesh.  Deterministic, balanced, and stable under
  re-runs, replacing the reference's per-sample cluster fan-out
  (workflow.py:384-391).
"""

import numpy as np

import jax


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the jax.distributed runtime (no-op if already up).

    Must run before any backend use: probing ``jax.process_count()`` here
    would itself initialize a single-process backend and make the
    distributed runtime unreachable, so the already-up check goes through
    ``jax.distributed.is_initialized`` (tests/test_multihost.py covers the
    2-process bring-up).
    """
    if jax.distributed.is_initialized():
        return  # already brought up by the launcher
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        # single-process environments with no coordinator (tests,
        # one-host runs) are fine
        if coordinator_address is not None:
            raise


def factor_devices(n_devices, num_restarts=None, num_blocks=None):
    """Split a device count into (restart, chain, block) extents.

    Preference order: fill the block axis up to ``num_blocks`` (innermost),
    then restarts up to ``num_restarts``, remainder to chains.
    """
    def largest_divisor_leq(n, cap):
        best = 1
        for d in range(1, n + 1):
            if n % d == 0 and d <= cap:
                best = d
        return best

    n_block = largest_divisor_leq(n_devices, num_blocks or 1)
    remaining = n_devices // n_block
    n_restart = largest_divisor_leq(remaining, num_restarts or remaining)
    n_chain = remaining // n_restart
    return n_restart, n_chain, n_block


def make_training_mesh(devices=None, num_restarts=None, num_blocks=None):
    """Global (restart, chain, block) mesh over all hosts' devices."""
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    n_restart, n_chain, n_block = factor_devices(
        len(devices), num_restarts, num_blocks)
    grid = np.asarray(devices[:n_restart * n_chain * n_block]).reshape(
        n_restart, n_chain, n_block)
    return Mesh(grid, ('restart', 'chain', 'block'))


def cohort_partition(sample_ids, process_id=None, process_count=None):
    """This host's share of a sample cohort.

    Samples are ordered deterministically and dealt round-robin so every
    host computes the same global assignment without communication.
    """
    if process_id is None:
        process_id = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    ordered = sorted(sample_ids, key=str)
    return ordered[process_id::process_count]
