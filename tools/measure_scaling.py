"""Scaling measurement: E-step throughput vs device count.

Runs the restart-batched whole-genome sweep on nested sub-meshes of the
available devices (1, 2, 4, ... up to all) and records segments/s for
each, writing SCALING.json.  On a multi-card host this gives the
scaling table; on a one-device host it degenerates to the one-device row
(a virtual CPU mesh shares host cores, so CPU "scaling" numbers are not
meaningful and are labelled as such).

Usage:  python tools/measure_scaling.py [--restarts R] [--n N]
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(num_devices, num_restarts, N, num_events, iters=5):
    import jax
    from jax.sharding import Mesh
    from remixt_jax.parallel import restarts as par
    from remixt_jax.models import engine as eng

    sys.path.insert(0, os.path.join(REPO_ROOT, 'tools'))
    from accuracy_gate import make_problem

    model, data = make_problem(N=N, num_events=num_events)
    spec = model._build_spec(3)
    params = spec.init_params(
        data['h'], model.divergence_weight,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    state = spec.init_state()

    mesh = Mesh(np.asarray(jax.devices()[:num_devices]), ('restart',))
    params_b = par.stack_pytrees([
        params._replace(h=params.h * (1.0 + 0.01 * i))
        for i in range(num_restarts)])
    state_b = par.stack_pytrees([state] * num_restarts)
    params_b = par.shard_restarts(mesh, params_b)
    state_b = par.shard_restarts(mesh, state_b)

    sweep = jax.jit(functools.partial(eng.variational_sweep_restarts, spec))
    with mesh:
        state_b = sweep(params_b, state_b)          # compile
        jax.block_until_ready(state_b)
        times = []
        for _ in range(3):
            t0 = time.time()
            for _ in range(iters):
                state_b = sweep(params_b, state_b)
            jax.block_until_ready(state_b)
            times.append((time.time() - t0) / iters)
    dt = sorted(times)[len(times) // 2]
    return num_restarts * spec.N / dt


def main():
    import jax

    parser = argparse.ArgumentParser()
    parser.add_argument('--restarts', type=int, default=12)
    parser.add_argument('--n', type=int, default=6000)
    parser.add_argument('--events', type=int, default=300)
    args = parser.parse_args()

    devices = jax.devices()
    backend = jax.default_backend()
    counts = []
    c = 1
    while c <= len(devices):
        counts.append(c)
        c *= 2
    if counts[-1] != len(devices):
        counts.append(len(devices))

    rows = []
    for num_devices in counts:
        segs = measure(num_devices, args.restarts, args.n, args.events)
        row = {
            'num_devices': num_devices,
            'segments_per_s': round(segs, 1),
            'scaling_efficiency': None,
        }
        if rows:
            row['scaling_efficiency'] = round(
                segs / rows[0]['segments_per_s'] / num_devices, 3)
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {
        'backend': backend,
        'meaningful': backend != 'cpu',
        'note': ('cpu virtual devices share host cores; numbers are not a '
                 'scaling measurement' if backend == 'cpu' else
                 'restart-sharded whole-genome E-step sweep'),
        'num_restarts': args.restarts,
        'N': args.n,
        'rows': rows,
    }
    with open(os.path.join(REPO_ROOT, 'SCALING.json'), 'w') as f:
        json.dump(out, f, indent=2)
    print('wrote SCALING.json')


if __name__ == '__main__':
    sys.exit(main())
