"""One process of the 2-process jax.distributed CPU smoke test.

Launched by tests/test_multihost.py with argv: process_id num_processes
port. Exercises the real multi-host entry points — parallel.distributed
.initialize, make_training_mesh over the GLOBAL device set (a DCN-style
mesh: two processes, two local devices each), shard_restart_fn — by
running one restart-sharded variational sweep and checking this process's
addressable shards against a locally-computed single-device reference.
"""

import sys

import numpy as np


def main():
    process_id, num_processes, port = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

    import jax
    jax.config.update('jax_enable_x64', True)

    from remixt_jax.parallel import distributed
    distributed.initialize(
        coordinator_address='localhost:{}'.format(port),
        num_processes=num_processes, process_id=process_id)
    assert jax.process_count() == num_processes, 'distributed init failed'

    mesh = distributed.make_training_mesh()
    n_global = mesh.devices.size
    assert n_global == num_processes * len(jax.local_devices())
    assert mesh.shape['restart'] == n_global

    import functools
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from remixt_jax.models import engine as eng
    from remixt_jax.parallel import restarts as par

    sys.path.insert(0, 'tests')
    from helpers import make_problem

    prob = make_problem(seed=2, N=18, M=2, cn_max=2, num_breakpoints=3,
                        num_telomeres=2)
    spec = eng.ModelSpec(
        cn_states=prob['cn_states'], brk_states=prob['brk_states'],
        l=prob['l'], x=prob['x'], y=prob['y'],
        is_telomere=prob['is_telomere'],
        breakpoint_idx=prob['breakpoint_idx'],
        breakpoint_orient=prob['breakpoint_orient'],
        transition_penalty=prob['transition_penalty'],
        normal_contamination=prob['normal_contamination'],
        dtype=jnp.float64)

    R = n_global
    params_list = [
        spec.init_params(prob['h_init'] * (1.0 + 0.05 * r),
                         prob['divergence_weight'])
        for r in range(R)]
    params_host = jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *params_list)
    state_host = jax.tree.map(
        lambda x: np.stack([np.asarray(x)] * R), spec.init_state())

    # every process holds the full host copy; make_array_from_callback
    # builds the global sharded pytrees from it
    def globalize(tree):
        def leaf(x):
            sharding = NamedSharding(
                mesh, P('restart') if np.ndim(x) >= 1 else P())
            return jax.make_array_from_callback(
                x.shape, sharding, lambda idx, x=x: x[idx])
        return jax.tree.map(leaf, tree)

    params_b = globalize(params_host)
    state_b = globalize(state_host)

    sweep = jax.jit(par.shard_restart_fn(
        mesh, jax.vmap(functools.partial(eng.variational_sweep, spec)),
        n_batched=2))
    out = sweep(params_b, state_b)

    # reference for the restarts this process can address
    for shard in out.posterior_marginals.addressable_shards:
        lo = shard.index[0].start or 0
        got = np.asarray(shard.data)
        for row, r in enumerate(range(lo, lo + got.shape[0])):
            expected = eng.variational_sweep(
                spec, params_list[r], spec.init_state())
            np.testing.assert_allclose(
                got[row], np.asarray(expected.posterior_marginals),
                atol=1e-9)

    print('MULTIHOST_WORKER_OK process={}'.format(process_id), flush=True)


if __name__ == '__main__':
    main()
