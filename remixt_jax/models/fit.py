"""BreakpointModel: the user-facing fit API.

Mirrors the reference wrapper (/root/reference/remixt/cn_model.py:29-628):
host-side segmentation remap and likelihood masks, state-space construction,
the EM × VI fit loop, Viterbi decode and breakpoint copy-number extraction —
but drives the JAX engine (:mod:`remixt_jax.models.engine`) and the
batched EM drivers (:mod:`remixt_jax.models.em`) instead of a Cython core.
"""

import logging

import numpy as np
import jax.numpy as jnp

from remixt_jax.models import em as em_mod
from remixt_jax.models import engine as eng
from remixt_jax.models import states as states_mod
from remixt_jax.models.remap import SegmentRemap

logger = logging.getLogger('remixt_jax.fit')


LIKELIHOOD_PARAM_BOUNDS = {
    # cn_model.py:215-226
    'negbin_r_0': (10., 2000.),
    'negbin_r_1': (1., 2000.),
    'betabin_M_0': (10., 2000.),
    'betabin_M_1': (1., 2000.),
    'negbin_hdel_mu': (1e-9, 1e-4),
    'negbin_hdel_r_0': (10., 2000.),
    'negbin_hdel_r_1': (1., 200.),
    'betabin_loh_p': (1e-5, 1e-2),
    'betabin_loh_M_0': (10., 2000.),
    'betabin_loh_M_1': (1., 200.),
}


class BreakpointModel:
    """Joint segment + breakpoint copy-number model over one sample.

    Args:
        x (ndarray): observed (major, minor, total) read counts, (N, 3)
        l (ndarray): effective segment lengths, (N,)
        adjacencies (set of tuple): wild-type adjacent segment pairs
        breakpoints (dict): breakpoint id -> frozenset of (segment, side)

    KwArgs mirror cn_model.py:40-74 (max_copy_number, normal_contamination,
    divergence_weight, min_segment_length, min_proportion_genotyped,
    max_depth, transition_log_prob, disable_breakpoints, normal_copies,
    do_h_update, ...), plus:
        dtype: engine compute dtype (default float32; tests use float64)
        random_seed: seed for the EM subsampling RNG
    """

    def __init__(self, x, l, adjacencies, breakpoints, **kwargs):
        # observed data ordered major, minor, total (cn_model.py:54-55)
        assert np.all(x[:, 1] <= x[:, 0])

        self.N = x.shape[0]

        if len(breakpoints) > 0:
            self.breakpoint_ids, self.breakpoints = zip(*breakpoints.items())
        else:
            self.breakpoint_ids, self.breakpoints = (), ()

        self.max_copy_number = kwargs.get('max_copy_number', 6)
        self.max_copy_number_diff = kwargs.get('max_copy_number_diff', 1)
        self.normal_contamination = kwargs.get('normal_contamination', True)
        self.is_female = kwargs.get('is_female', True)
        self.divergence_weight = kwargs.get('divergence_weight', 1e6)
        self.min_segment_length = kwargs.get('min_segment_length', 10000)
        self.min_proportion_genotyped = kwargs.get('min_proportion_genotyped', 0.01)
        self.max_depth = kwargs.get('max_depth')
        self.transition_log_prob = kwargs.get('transition_log_prob', 10.)
        self.transition_model = kwargs.get('transition_model', 0)
        self.disable_breakpoints = kwargs.get('disable_breakpoints', False)
        self.breakpoint_init = kwargs.get('breakpoint_init', None)
        self.normal_copies = np.asarray(
            kwargs.get('normal_copies', np.array([[1, 1]] * self.N)))
        self.do_h_update = kwargs.get('do_h_update', True)
        self.dtype = kwargs.get('dtype', jnp.float32)
        self.random_seed = kwargs.get('random_seed', None)

        if self.max_depth is None:
            raise ValueError('must specify max depth')

        if not self.normal_contamination:
            self.normal_copies = self.normal_copies * 0

        # segmentation remap (cn_model.py:82-161)
        self.remap = SegmentRemap(self.N, adjacencies, self.breakpoints)
        self.N1 = self.remap.N1
        self.seg_fwd_remap = self.remap.seg_fwd_remap
        self.seg_rev_remap = self.remap.seg_rev_remap
        self.num_breakpoints = self.remap.num_breakpoints
        self.is_telomere = self.remap.is_telomere
        self.breakpoint_idx = self.remap.breakpoint_idx
        self.breakpoint_orient = self.remap.breakpoint_orient

        self.x1, self.l1 = self.remap.expand_data(x, l)

        # Likelihood masks (semantics of cn_model.py:169-184): segments the
        # model cannot describe are dropped from the likelihood — too short,
        # or amplified past max_depth; the allele term additionally needs
        # enough genotypable (allele-assigned) reads.
        total_reads = self.x1[:, 2].astype(float)
        depth = total_reads / (self.l1.astype(float) + 1e-16)
        genotyped_fraction = (
            self.x1[:, :2].sum(axis=1).astype(float) / (total_reads + 1e-16))

        modellable = (
            (self.l1 >= self.min_segment_length) & (depth <= self.max_depth))
        self._total_likelihood_mask = modellable
        self._allele_likelihood_mask = modellable & (
            genotyped_fraction >= self.min_proportion_genotyped)

        # Optionally disable integrated breakpoint inference
        # (cn_model.py:186-190): every junction reverts to the plain
        # no-breakend transition.
        if self.disable_breakpoints:
            self.num_breakpoints = 0
            self.breakpoint_idx = np.full_like(self.breakpoint_idx, -1)
            self.breakpoint_orient = np.zeros_like(self.breakpoint_orient)

        self.check_elbo = False
        self.prev_elbo = None
        self.prev_elbo_diff = None
        self._em_iter = 0
        self.num_em_iter = 1
        self.num_update_iter = 1

        self.likelihood_params = [
            'negbin_r_0',
            'negbin_r_1',
            'betabin_M_0',
            'betabin_M_1',
        ]
        if not self.normal_contamination:
            self.likelihood_params.extend([
                'negbin_hdel_mu',
                'negbin_hdel_r_0',
                'negbin_hdel_r_1',
                'betabin_loh_p',
                'betabin_loh_M_0',
                'betabin_loh_M_1',
            ])
        self.likelihood_param_bounds = dict(LIKELIHOOD_PARAM_BOUNDS)

        self.spec = None
        self.params = None
        self.state = None

    # -- model assembly ------------------------------------------------------

    def _build_spec(self, num_clones):
        cn_states_one = states_mod.enumerate_cn_states(
            num_clones, 2, self.max_copy_number, self.max_copy_number_diff)
        cn_states = np.tile(cn_states_one[None], (self.N, 1, 1, 1))
        cn_states[:, :, 0, :] = self.normal_copies[:, None, :]

        # remap states to the expanded segmentation (cn_model.py:363-364)
        cn_states = cn_states[self.seg_rev_remap]

        brk_states = states_mod.enumerate_brk_states(
            num_clones, self.max_copy_number, self.max_copy_number_diff)

        return eng.ModelSpec(
            cn_states=cn_states,
            brk_states=brk_states,
            l=self.l1,
            x=self.x1[:, 2],
            y=self.x1[:, 0:2],
            is_telomere=self.is_telomere,
            breakpoint_idx=self.breakpoint_idx,
            breakpoint_orient=self.breakpoint_orient,
            transition_penalty=self.transition_log_prob,
            normal_contamination=self.normal_contamination,
            transition_model=self.transition_model,
            dtype=self.dtype,
        )

    def _init_p_breakpoint(self):
        """Optional informative q(brk) init (cn_model.py:389-402)."""
        if self.breakpoint_init is None or self.num_breakpoints == 0:
            return None
        brk_states = np.asarray(self.spec.brk_states)
        p_breakpoint = np.ones((self.num_breakpoints, brk_states.shape[0]))
        for k, bp in enumerate(self.breakpoints):
            cn = self.breakpoint_init[bp]
            match = np.all(brk_states == np.asarray(cn)[None, :], axis=1)
            p_breakpoint[k, match] = 1000.
        p_breakpoint /= p_breakpoint.sum(axis=-1, keepdims=True)
        return p_breakpoint

    # -- fitting -------------------------------------------------------------

    def reset_restart(self, max_depth=None, divergence_weight=None):
        """Re-point this model at a new restart's configuration without
        rebuilding the state space or recompiling: masks and the divergence
        weight are traced Params fields, so the spec and all jitted engine
        functions are shared across the whole restart grid (the reference
        spends one 32 GB job per restart instead — workflow.py:318-340)."""
        if divergence_weight is not None:
            self.divergence_weight = divergence_weight
        if max_depth is not None:
            self.max_depth = max_depth
            self._total_likelihood_mask = np.ones(self.N1, dtype=bool)
            self._allele_likelihood_mask = np.ones(self.N1, dtype=bool)
            self._total_likelihood_mask &= (self.l1 >= self.min_segment_length)
            self._allele_likelihood_mask &= (self.l1 >= self.min_segment_length)
            p = self.x1[:, :2].sum(axis=1).astype(float) / (
                self.x1[:, 2].astype(float) + 1e-16)
            self._allele_likelihood_mask &= (p >= self.min_proportion_genotyped)
            depth = self.x1[:, 2].astype(float) / (self.l1.astype(float) + 1e-16)
            self._total_likelihood_mask &= (depth <= self.max_depth)
            self._allele_likelihood_mask &= (depth <= self.max_depth)
        self.prev_elbo = None
        self.prev_elbo_diff = None

    # -- snapshot checkpointing (reference cn_model.py:286-307
    #    _write_model/_read_model) --------------------------------------------

    def save_snapshot(self, filename):
        """Write a resumable snapshot: variational state, params, host RNG,
        and fit-loop progress. Atomic (tmp + rename) so a kill mid-write
        never leaves a truncated snapshot."""
        import pickle
        import jax

        payload = {
            'params': jax.tree.map(np.asarray, self.params),
            'state': jax.tree.map(np.asarray, self.state),
            'rng_state': self._rng.get_state(),
            'em_iter': self._em_iter,
            'prev_elbo': (None if self.prev_elbo is None
                          else float(self.prev_elbo)),
            'prev_elbo_diff': (None if self.prev_elbo_diff is None
                               else float(self.prev_elbo_diff)),
            'num_clones': self._spec_num_clones,
        }
        tmp = filename + '.tmp'
        with open(tmp, 'wb') as f:
            pickle.dump(payload, f)
        import os
        os.replace(tmp, filename)

    def load_snapshot(self, filename):
        """Restore a snapshot written by save_snapshot; the spec is rebuilt
        (it is derived from the problem, not part of the snapshot)."""
        import pickle

        with open(filename, 'rb') as f:
            payload = pickle.load(f)

        M = payload['num_clones']
        if self.spec is None or getattr(self, '_spec_num_clones', None) != M:
            self.spec = self._build_spec(M)
            self._spec_num_clones = M
        self.params = payload['params']
        self.state = payload['state']
        self._rng = np.random.RandomState()
        self._rng.set_state(payload['rng_state'])
        self._em_iter = payload['em_iter']
        self.prev_elbo = payload['prev_elbo']
        self.prev_elbo_diff = payload['prev_elbo_diff']

    def fit(self, h_init, snapshot_filename=None):
        """EM × VI fit loop (cn_model.py:354-428).

        With ``snapshot_filename``, a snapshot is written after every EM
        iteration and, if the file already exists, the fit resumes from it
        mid-grid instead of restarting — byte-identical to an
        uninterrupted run (the host RNG state rides the snapshot).
        """
        import os

        h_init = np.asarray(h_init, dtype=float)
        M = h_init.shape[0]

        if snapshot_filename is not None and os.path.exists(snapshot_filename):
            self.load_snapshot(snapshot_filename)
            logger.info('resumed from snapshot at EM iteration %d',
                        self._em_iter)
        else:
            if self.spec is None or getattr(self, '_spec_num_clones', None) != M:
                self.spec = self._build_spec(M)
                self._spec_num_clones = M
            self.params = self.spec.init_params(
                h_init, self.divergence_weight,
                total_mask=self._total_likelihood_mask.astype(float),
                allele_mask=self._allele_likelihood_mask.astype(float),
            )
            self.state = self.spec.init_state(self._init_p_breakpoint())
            self._rng = np.random.RandomState(self.random_seed)
            self._em_iter = 0

        if self.prev_elbo is None:
            self.prev_elbo = float(self.spec.elbo(self.params, self.state))

        # inside the loop the ELBO stays a device scalar and per-iteration
        # diagnostics are gated: every float()/np.asarray() of a device
        # value waits for the device and copies to the host
        verbose = logger.isEnabledFor(logging.INFO)
        while self._em_iter < self.num_em_iter:
            if self.check_elbo:
                for j in range(self.num_update_iter):
                    self.variational_update()
            else:
                # fused multi-sweep: emissions computed once per EM iter
                self.state = self.spec.sweep_n(self.num_update_iter)(
                    self.params, self.state)

            if self.do_h_update:
                self.em_update_h()

            elbo = self.em_update_params()
            if elbo is None:
                elbo = self.spec.elbo(self.params, self.state)

            self.prev_elbo_diff = elbo - self.prev_elbo
            self.prev_elbo = elbo
            self._em_iter += 1

            if verbose:
                logger.info('completed iteration %d', self._em_iter - 1)
                logger.info('    elbo: %.10f', float(self.prev_elbo))
                logger.info('    elbo diff: %.10f', float(self.prev_elbo_diff))
                logger.info('    h = %s', np.asarray(self.params.h))
                for name, value in self.get_likelihood_param_values().items():
                    logger.info('    %s = %s', name, value)

            if snapshot_filename is not None:
                self.save_snapshot(snapshot_filename)

        # one deferred host pull finalizes the loop's device scalars
        self.prev_elbo = float(self.prev_elbo)
        self.prev_elbo_diff = (None if self.prev_elbo_diff is None
                               else float(self.prev_elbo_diff))

    def _elbo_guard(self, name, fn, threshold=-1e-6):
        """Optional per-update ELBO decrease check (cn_model.py:430-442)."""
        if not self.check_elbo:
            fn()
            return
        before = float(self.spec.elbo(self.params, self.state))
        fn()
        after = float(self.spec.elbo(self.params, self.state))
        logger.info('    %s elbo diff: %.10f', name, after - before)
        if after - before < threshold:
            raise Exception('elbo error for step {}!'.format(name))

    def variational_update(self):
        """One sweep of all variational updates in reference order."""
        if self.check_elbo:
            # stepwise, guarded (only used by tests/debug)
            ll_fns = [
                ('update_p_allele_swap', self._step_swap),
                ('p_cn', self._step_cn),
                ('p_breakpoint', self._step_breakpoint),
                ('p_outlier_total', self._step_outlier_total),
                ('p_outlier_allele', self._step_outlier_allele),
            ]
            for name, fn in ll_fns:
                self._elbo_guard(name, fn)
        else:
            self.state = self.spec.sweep(self.params, self.state)

    def _emission(self):
        return eng.emission_tensors(self.spec, self.params)

    def _step_swap(self):
        _, ll_alle = self._emission()
        self.state = eng.update_p_allele_swap(self.spec, self.params, self.state, ll_alle)

    def _step_cn(self):
        ll_tot, ll_alle = self._emission()
        self.state = eng.update_p_cn(self.spec, self.params, self.state, ll_tot, ll_alle)

    def _step_breakpoint(self):
        self.state = eng.update_p_breakpoint(self.spec, self.params, self.state)

    def _step_outlier_total(self):
        ll_tot, _ = self._emission()
        self.state = eng.update_p_outlier_total(self.spec, self.params, self.state, ll_tot)

    def _step_outlier_allele(self):
        _, ll_alle = self._emission()
        self.state = eng.update_p_outlier_allele(self.spec, self.params, self.state, ll_alle)

    def em_update_h(self):
        def step():
            self.params, accepted = em_mod.update_h_fused(
                self.spec, self.params, self.state, self._rng)
            # pulling the accept flag is a host round trip — only when
            # someone is listening
            if logger.isEnabledFor(logging.INFO) and not bool(accepted):
                logger.info('    h update rejected')
        self._elbo_guard('h', step)

    def em_update_params(self):
        """Returns the post-update ELBO as a device scalar on the fused
        path (assembled in-graph from the accept/reject bookkeeping),
        None on the stepwise path."""
        if self.check_elbo:
            # stepwise host path with per-parameter ELBO guards
            for name in self.likelihood_params:
                def step(name=name):
                    weights = em_mod.param_sample_weights(
                        self.spec, self.state, name)
                    self.params, accepted = em_mod.update_param(
                        self.spec, self.params, self.state, name,
                        self.likelihood_param_bounds[name], self._rng, weights)
                    if not accepted:
                        logger.info('    %s update rejected', name)
                self._elbo_guard(name, step)
            return None

        # fused single-dispatch path; weights computed on device in one
        # call (the per-name host path re-pulls the marginals per
        # parameter)
        weights_list = em_mod.param_sample_weights_all(
            self.spec, self.state, self.likelihood_params)
        self.params, accepts, elbo = em_mod.update_params_fused(
            self.spec, self.params, self.state, self.likelihood_params,
            self.likelihood_param_bounds, self._rng, weights_list)
        if logger.isEnabledFor(logging.INFO):
            for name, accepted in zip(self.likelihood_params,
                                      np.asarray(accepts)):
                if not accepted:
                    logger.info('    %s update rejected', name)
        return elbo

    # -- outputs -------------------------------------------------------------

    def get_likelihood_param_values(self):
        return {name: float(getattr(self.params, name))
                for name in self.likelihood_params}

    def optimal_cn(self):
        """Viterbi decode + breakpoint copy number (cn_model.py:571-598).

        Returns:
            cn (N, M, 2) in the ORIGINAL segmentation, brk_cn dict
        """
        seq, _ = self.spec.decode(self.params, self.state)
        seq = np.asarray(seq)

        class_cn = self.spec.class_cn_np          # (C, S, M, 2)
        seg_class = self.spec.seg_class_np
        cn1 = class_cn[seg_class, seq]            # (N1, M, 2)

        # breakpoint copy number by transition compatibility (cn_model.py:576-593)
        brk_states = np.asarray(self.spec.brk_states)
        num_brk_states = brk_states.shape[0]
        tp = self.transition_log_prob

        brk_cn = dict()
        if self.num_breakpoints > 0:
            # vectorized over all breakend junctions: each junction n with
            # breakpoint k contributes -tp * |d_m - orient * brk_states| per
            # clone to that breakpoint's state score
            at_brk = np.flatnonzero(self.breakpoint_idx[:self.N1 - 1] >= 0)
            k_idx = self.breakpoint_idx[at_brk]                   # (J,)
            d = (cn1[at_brk].sum(axis=2)
                 - cn1[at_brk + 1].sum(axis=2))                   # (J, M)
            orient = self.breakpoint_orient[at_brk]               # (J,)
            score = -tp * np.abs(
                d[:, None, :] - orient[:, None, None] * brk_states[None, :, :]
            ).sum(axis=2)                                         # (J, S_b)
            log_p = np.zeros((self.num_breakpoints, num_brk_states))
            np.add.at(log_p, k_idx, score)
            best = brk_states[log_p.argmax(axis=1)]
            brk_cn = {self.breakpoint_ids[k]: best[k]
                      for k in range(self.num_breakpoints)}

        cn = cn1[self.seg_fwd_remap]
        return cn, brk_cn

    def breakpoint_prob(self):
        p_breakpoint = np.asarray(self.state.p_breakpoint)
        return dict(zip(self.breakpoints, p_breakpoint))

    @property
    def h(self):
        return np.asarray(self.params.h)

    @property
    def p_breakpoint(self):
        return np.asarray(self.state.p_breakpoint)

    @property
    def p_outlier_total(self):
        return np.asarray(self.state.p_outlier_total)[self.seg_fwd_remap]

    @property
    def p_outlier_allele(self):
        return np.asarray(self.state.p_outlier_allele)[self.seg_fwd_remap]

    @property
    def total_likelihood_mask(self):
        return self._total_likelihood_mask[self.seg_fwd_remap]

    @property
    def allele_likelihood_mask(self):
        return self._allele_likelihood_mask[self.seg_fwd_remap]


def decode_breakpoints_naive(cn, adjacencies, breakpoints):
    """Decode breakpoint copy number from segment copy number alone, as the
    min residual copy-number 'flow' at the two breakends
    (cn_model.py:631-687). Used when integrated breakpoint inference is
    disabled.
    """
    cn = cn.sum(axis=-1)

    breakend_adj = dict()
    for seg_1, seg_2 in adjacencies:
        breakend_adj[(seg_1, 1)] = (seg_2, 0)
        breakend_adj[(seg_2, 0)] = (seg_1, 1)

    brk_cn = dict()
    for breakpoint_id, breakpoint in breakpoints.items():
        breakend_cn = dict()
        for breakend in breakpoint:
            n, side = breakend
            cn_self = cn[n, :]
            if breakend in breakend_adj:
                n_adj, _ = breakend_adj[breakend]
                cn_adj = cn[n_adj, :]
            else:
                cn_adj = 0
            breakend_cn[(n, side)] = np.maximum(cn_self - cn_adj, 0)

        ((n_1, side_1), (n_2, side_2)) = breakpoint
        brk_cn[breakpoint_id] = np.minimum(
            breakend_cn[(n_1, side_1)], breakend_cn[(n_2, side_2)])

    return brk_cn
