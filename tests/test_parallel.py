"""Device-mesh parallelism tests on the virtual 8-device CPU mesh.

Sharded execution must be numerically equivalent to single-device
execution; the 2D (restart × chain) layout is the production configuration
validated by the driver's multichip dry run.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from remixt_jax.models import engine as eng
from remixt_jax.models.fit import BreakpointModel
from remixt_jax.parallel import restarts as par
from remixt_jax.parallel import chain as par_chain
from remixt_jax.simulations import simple as sim


@pytest.fixture(scope='module')
def problem():
    data = sim.simulate_experiment(
        N=48, M=3, h=(0.08, 0.05, 0.025), cn_max=4, num_events=5,
        num_chains=4, seed=3)
    model = BreakpointModel(
        data['x'], data['l'], data['adjacencies'], data['breakpoints'],
        max_copy_number=4, max_depth=1e9, min_segment_length=1.0,
        min_proportion_genotyped=0.0, divergence_weight=1e-7,
        dtype=jnp.float64, random_seed=0)
    spec = model._build_spec(3)
    params = spec.init_params(
        data['h'], 1e-7,
        total_mask=model._total_likelihood_mask.astype(float),
        allele_mask=model._allele_likelihood_mask.astype(float))
    state = spec.init_state()
    return spec, params, state


def test_restart_sharded_sweep_matches(problem):
    spec, params, state = problem
    R = 4

    params_list = [params._replace(h=params.h * (1.0 + 0.05 * i)) for i in range(R)]

    # single-device reference
    expected = [eng.variational_sweep(spec, p, state) for p in params_list]

    mesh = par.make_restart_mesh(jax.devices()[:4])
    params_b = par.shard_restarts(mesh, par.stack_pytrees(params_list))
    state_b = par.shard_restarts(mesh, par.stack_pytrees([state] * R))

    step = par.make_sharded_sweep(spec, mesh)
    with mesh:
        state_out = step(params_b, state_b)

    for i in range(R):
        np.testing.assert_allclose(
            np.asarray(state_out.posterior_marginals[i]),
            np.asarray(expected[i].posterior_marginals), atol=1e-9)
        np.testing.assert_allclose(
            float(state_out.hmm_log_norm_const[i]),
            float(expected[i].hmm_log_norm_const), rtol=1e-9)


def test_2d_mesh_matches_single_device(problem):
    spec, params, state = problem
    n_restart, n_chain = 2, 4
    R = n_restart

    params_list = [params._replace(h=params.h * (1.0 + 0.05 * i)) for i in range(R)]
    spec.chain_constraint = None
    expected_states = [eng.variational_sweep(spec, p, state) for p in params_list]
    expected_ell = [
        float(eng.expected_log_likelihood(spec, p, s))
        for p, s in zip(params_list, expected_states)]

    devices = np.asarray(jax.devices()[:8]).reshape(n_restart, n_chain)
    mesh = Mesh(devices, ('restart', 'chain'))

    params_b = par.shard_restarts(mesh, par.stack_pytrees(params_list))
    state_b = par.shard_restarts(mesh, par.stack_pytrees([state] * R))

    step = par_chain.make_2d_train_step(spec, mesh, h_step=0.0)
    try:
        with mesh:
            params_out, state_out, ell = step(params_b, state_b)

        for i in range(R):
            np.testing.assert_allclose(
                np.asarray(state_out.posterior_marginals[i]),
                np.asarray(expected_states[i].posterior_marginals), atol=1e-9)
            np.testing.assert_allclose(float(ell[i]), expected_ell[i], rtol=1e-9)
            if spec.K > 0:
                np.testing.assert_allclose(
                    np.asarray(state_out.p_breakpoint[i]),
                    np.asarray(expected_states[i].p_breakpoint), atol=1e-9)
    finally:
        spec.chain_constraint = None


def test_factor_devices():
    from remixt_jax.parallel import distributed

    assert distributed.factor_devices(8, num_restarts=2, num_blocks=2) == (2, 2, 2)
    assert distributed.factor_devices(8, num_restarts=None, num_blocks=None) == (8, 1, 1)
    assert distributed.factor_devices(8, num_restarts=4, num_blocks=1) == (4, 2, 1)
    # prime counts with capped restart/block axes land on the chain axis
    assert distributed.factor_devices(7, num_restarts=2, num_blocks=2) == (1, 7, 1)


def test_make_training_mesh():
    import jax
    from remixt_jax.parallel import distributed

    mesh = distributed.make_training_mesh(num_restarts=2, num_blocks=2)
    assert mesh.axis_names == ('restart', 'chain', 'block')
    assert mesh.devices.size <= len(jax.devices())


def test_cohort_partition_balanced_and_disjoint():
    from remixt_jax.parallel import distributed

    samples = ['s{}'.format(i) for i in range(10)]
    shares = [distributed.cohort_partition(samples, pid, 3) for pid in range(3)]
    merged = sorted(sum(shares, []))
    assert merged == sorted(samples)
    sizes = sorted(len(s) for s in shares)
    assert sizes == [3, 3, 4]


def test_restart_batched_sweep_matches_vmap():
    """The dedicated restart-batched sweep (shared static-transition gather
    + scheduled per-restart breakend fix-ups) must reproduce the vmapped
    per-restart sweep exactly."""
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np
    from remixt_jax.models import engine as eng
    from remixt_jax.parallel import restarts as par
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

    R = 3
    params_list = [
        spec.init_params(prob['h_init'] * (1.0 + 0.05 * r),
                         prob['divergence_weight'])
        for r in range(R)]
    params_b = par.stack_pytrees(params_list)
    state_b = par.stack_pytrees([spec.init_state()] * R)

    ref = jax.jit(jax.vmap(functools.partial(
        eng.variational_sweep, spec)))(params_b, state_b)
    got = jax.jit(functools.partial(
        eng.variational_sweep_restarts, spec))(params_b, state_b)

    for field in ('posterior_marginals', 'p_breakpoint', 'p_outlier_total',
                  'p_allele_swap', 'hmm_log_norm_const'):
        np.testing.assert_allclose(
            np.asarray(getattr(got, field)), np.asarray(getattr(ref, field)),
            atol=1e-9, err_msg=field)

    # a second sweep exercises the p_breakpoint_used / chain_scale carry
    ref2 = jax.jit(jax.vmap(functools.partial(
        eng.variational_sweep, spec)))(params_b, ref)
    got2 = jax.jit(functools.partial(
        eng.variational_sweep_restarts, spec))(params_b, got)
    np.testing.assert_allclose(
        np.asarray(got2.posterior_marginals),
        np.asarray(ref2.posterior_marginals), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(got2.p_breakpoint), np.asarray(ref2.p_breakpoint),
        atol=1e-9)


def test_production_fit_on_mesh_full_em_budget():
    """The COMPLETE production fit (5 EM x 5 VI: fused backtracking h
    update with accept/reject, likelihood-param grid zoom, per-restart
    RNG streams) executes restart-sharded on the 8-device mesh and matches
    the single-device batched driver. Restart count 11
    deliberately doesn't divide the device count, exercising the padding
    path."""
    from remixt_jax.models.fit_batched import fit_restarts_batched
    from remixt_jax.parallel import distributed

    data = sim.simulate_experiment(
        N=36, M=3, h=(0.08, 0.05, 0.025), cn_max=2, num_events=4,
        num_chains=2, seed=5)

    def build():
        model = BreakpointModel(
            data['x'], data['l'], data['adjacencies'], data['breakpoints'],
            max_copy_number=2, max_depth=1e9, min_segment_length=1.0,
            min_proportion_genotyped=0.0, divergence_weight=1e-7,
            dtype=jnp.float64, random_seed=1234)
        model.num_em_iter = 5
        model.num_update_iter = 5
        return model

    R = 11
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    dws = [1e-7, 1e-8] * 6
    dws = dws[:R]

    mesh = distributed.make_training_mesh()
    assert mesh.shape['restart'] == 8
    single = fit_restarts_batched(build(), h_inits, dws, chunk_size=12)
    meshed = fit_restarts_batched(build(), h_inits, dws, chunk_size=12,
                                  mesh=mesh)

    # shard_map compiles per-device batch extents, so reductions reassociate;
    # 5 EM iterations of backtracking line search amplify that to ~1e-6 on h
    # (measured: h rel 1.0e-6, marginals 1.1e-6, elbo rel 3.8e-8). The
    # discrete outputs — decoded states, accepted grid points — must be
    # identical.
    assert len(meshed) == R
    for i in range(R):
        np.testing.assert_allclose(
            np.asarray(meshed[i]['params'].h),
            np.asarray(single[i]['params'].h), rtol=1e-5,
            err_msg='restart {}'.format(i))
        np.testing.assert_allclose(
            np.asarray(meshed[i]['state'].posterior_marginals),
            np.asarray(single[i]['state'].posterior_marginals), atol=1e-5)
        np.testing.assert_array_equal(
            np.argmax(np.asarray(meshed[i]['state'].posterior_marginals), axis=1),
            np.argmax(np.asarray(single[i]['state'].posterior_marginals), axis=1))
        np.testing.assert_allclose(
            meshed[i]['elbo'], single[i]['elbo'], rtol=1e-6)
        # every scalar likelihood parameter landed on the same grid point
        for name in ('negbin_r_0', 'negbin_r_1', 'betabin_M_0',
                     'betabin_M_1', 'betabin_loh_p'):
            np.testing.assert_allclose(
                np.asarray(getattr(meshed[i]['params'], name)),
                np.asarray(getattr(single[i]['params'], name)), rtol=1e-9)


def test_blocked_sweep_agreement_pinned(problem):
    """Engine-level blocked intra-chain sweep vs the chain-batched sweep,
    pinned at the measured agreement (<=2.3e-11 over seeds; 1e-9 bound in
    f64) rather than the former loose 1e-4."""
    spec, params, state = problem
    ref = jax.jit(functools.partial(eng.variational_sweep, spec))(
        params, state)

    block_mesh = Mesh(np.asarray(jax.devices()), ('block',))
    par_chain.enable_block_sharding(spec, block_mesh, num_blocks=8)
    spec._jit_cache = {}
    try:
        with block_mesh:
            blk = jax.jit(functools.partial(eng.variational_sweep, spec))(
                params, state)
        diff = np.max(np.abs(np.asarray(ref.posterior_marginals)
                             - np.asarray(blk.posterior_marginals)))
        assert diff < 1e-9, diff
    finally:
        par_chain.enable_block_sharding(spec, None, num_blocks=1)
        spec._jit_cache = {}


def test_fused_multi_sweep_matches_looped():
    """variational_sweeps (emissions hoisted out of the sweep loop) and
    variational_sweeps_restarts must equal their looped counterparts."""
    import functools
    import jax
    import jax.numpy as jnp
    import numpy as np
    from remixt_jax.models import engine as eng
    from remixt_jax.parallel import restarts as par
    from helpers import make_problem

    prob = make_problem(seed=6, N=14, M=2, cn_max=2, num_breakpoints=2,
                        num_telomeres=1)
    spec = eng.ModelSpec(
        cn_states=prob['cn_states'], brk_states=prob['brk_states'],
        l=prob['l'], x=prob['x'], y=prob['y'],
        is_telomere=prob['is_telomere'],
        breakpoint_idx=prob['breakpoint_idx'],
        breakpoint_orient=prob['breakpoint_orient'],
        transition_penalty=prob['transition_penalty'],
        normal_contamination=prob['normal_contamination'],
        dtype=jnp.float64)
    params = spec.init_params(prob['h_init'], prob['divergence_weight'])
    state = spec.init_state()

    looped = state
    for _ in range(3):
        looped = spec.sweep(params, looped)
    fused = spec.sweep_n(3)(params, state)
    np.testing.assert_allclose(
        np.asarray(fused.posterior_marginals),
        np.asarray(looped.posterior_marginals), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(fused.p_breakpoint),
        np.asarray(looped.p_breakpoint), atol=1e-12)

    R = 2
    params_b = par.stack_pytrees(
        [params._replace(h=params.h * (1.0 + 0.1 * r)) for r in range(R)])
    state_b = par.stack_pytrees([state] * R)
    looped_b = state_b
    step = jax.jit(functools.partial(eng.variational_sweep_restarts, spec))
    for _ in range(3):
        looped_b = step(params_b, looped_b)
    fused_b = jax.jit(functools.partial(
        eng.variational_sweeps_restarts, spec, num_sweeps=3))(
            params_b, state_b)
    np.testing.assert_allclose(
        np.asarray(fused_b.posterior_marginals),
        np.asarray(looped_b.posterior_marginals), atol=1e-12)


def test_2d_step_h_gradient_matches_production_objective(problem):
    """The 2D training step's in-graph h ascent (parallel/chain.py) is a
    fixed-step variant of the production fused backtracking update; both
    must climb the SAME objective. Pin its ell and gradient to
    jax.value_and_grad of engine.expected_log_likelihood evaluated
    unsharded on the post-sweep state."""
    spec, params, state = problem
    n_restart, n_chain = 2, 4
    R = n_restart
    h_step = 1e-6

    params_list = [
        params._replace(h=params.h * (1.0 + 0.05 * i)) for i in range(R)]
    spec.chain_constraint = None

    expected = []
    for p in params_list:
        s = eng.variational_sweep(spec, p, state)
        ell, grad = jax.value_and_grad(
            lambda h, p=p, s=s: eng.expected_log_likelihood(
                spec, p._replace(h=h), s))(p.h)
        new_h = np.clip(np.asarray(p.h) + h_step * np.asarray(grad),
                        1e-8, 10.0)
        expected.append((float(ell), new_h))

    devices = np.asarray(jax.devices()[:8]).reshape(n_restart, n_chain)
    mesh = Mesh(devices, ('restart', 'chain'))
    params_b = par.shard_restarts(mesh, par.stack_pytrees(params_list))
    state_b = par.shard_restarts(mesh, par.stack_pytrees([state] * R))

    step = par_chain.make_2d_train_step(spec, mesh, h_step=h_step)
    try:
        with mesh:
            params_out, _, ell = step(params_b, state_b)
        for i in range(R):
            np.testing.assert_allclose(float(ell[i]), expected[i][0],
                                       rtol=1e-9)
            np.testing.assert_allclose(np.asarray(params_out.h[i]),
                                       expected[i][1], rtol=1e-9)
    finally:
        spec.chain_constraint = None


def test_production_fit_small_grid_uses_2d_mesh():
    """A grid smaller than the device count factors restart x chain
    (R=4 on 8 devices -> 4x2) instead of padding half the chips with
    duplicate restarts, and the 2D fit matches the single-device batched
    driver."""
    from remixt_jax.models.fit_batched import fit_restarts_batched
    from remixt_jax.analysis.pipeline import _production_mesh

    data = sim.simulate_experiment(
        N=36, M=3, h=(0.08, 0.05, 0.025), cn_max=2, num_events=4,
        num_chains=2, seed=9)

    def build():
        model = BreakpointModel(
            data['x'], data['l'], data['adjacencies'], data['breakpoints'],
            max_copy_number=2, max_depth=1e9, min_segment_length=1.0,
            min_proportion_genotyped=0.0, divergence_weight=1e-7,
            dtype=jnp.float64, random_seed=1234)
        model.num_em_iter = 3
        model.num_update_iter = 3
        return model

    R = 4
    h_inits = [data['h'] * (1.0 + 0.02 * i) for i in range(R)]
    dws = [1e-7, 1e-8, 1e-7, 1e-8]

    mesh = _production_mesh({}, num_restarts=R)
    assert mesh.shape['restart'] == 4
    assert mesh.shape['chain'] == 2

    single = fit_restarts_batched(build(), h_inits, dws, chunk_size=4)
    meshed = fit_restarts_batched(build(), h_inits, dws, chunk_size=4,
                                  mesh=mesh)

    assert len(meshed) == R
    for i in range(R):
        np.testing.assert_allclose(
            np.asarray(meshed[i]['params'].h),
            np.asarray(single[i]['params'].h), rtol=1e-5,
            err_msg='restart {}'.format(i))
        np.testing.assert_allclose(
            np.asarray(meshed[i]['state'].posterior_marginals),
            np.asarray(single[i]['state'].posterior_marginals), atol=1e-6,
            err_msg='restart {}'.format(i))
        np.testing.assert_allclose(
            meshed[i]['elbo'], single[i]['elbo'], rtol=1e-6,
            err_msg='restart {}'.format(i))
