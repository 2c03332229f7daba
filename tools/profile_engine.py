"""Engine profiler: capture a JAX profiler trace of whole-genome sweeps.

The replacement for the reference's print-based timing
(cn_model.py:423-442) and disabled Cython profiling hooks — produces a
TensorBoard-loadable trace of the variational sweep for kernel-level
inspection.

Usage:
    python tools/profile_engine.py [--n 6000] [--iters 5] [--outdir /tmp/trace]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    argparser = argparse.ArgumentParser()
    argparser.add_argument('--n', type=int, default=6000)
    argparser.add_argument('--events', type=int, default=300)
    argparser.add_argument('--iters', type=int, default=5)
    argparser.add_argument('--restarts', type=int, default=0,
                           help='trace the restart-batched sweep instead')
    argparser.add_argument('--outdir', default='/tmp/remixt_jax_trace')
    args = argparser.parse_args()

    import functools
    import jax
    import numpy as np
    from bench import build_problem

    spec, params, state, _ = build_problem(args.n, args.events)

    if args.restarts:
        from remixt_jax.parallel import restarts as par
        from remixt_jax.models import engine as eng
        R = args.restarts
        rng = np.random.RandomState(0)
        params = par.stack_pytrees([
            params._replace(h=params.h * (1.0 + 0.2 * rng.rand()))
            for _ in range(R)])
        state = par.stack_pytrees([state] * R)
        sweep = jax.jit(functools.partial(
            eng.variational_sweep_restarts, spec))
        per_call = R * spec.N
    else:
        sweep = spec.sweep
        per_call = spec.N

    state = sweep(params, state)
    jax.block_until_ready(state)

    with jax.profiler.trace(args.outdir):
        t0 = time.time()
        for _ in range(args.iters):
            state = sweep(params, state)
        jax.block_until_ready(state)
        dt = (time.time() - t0) / args.iters

    print('sweep: {:.1f} ms  ({:.0f} segments/s)'.format(
        dt * 1e3, per_call / dt))
    print('trace written to', args.outdir)


if __name__ == '__main__':
    main()
