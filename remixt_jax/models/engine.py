"""Variational inference engine.

Functional JAX re-design of the reference inference core
(/root/reference/remixt/bpmodel.pyx:397-1210). Same math, different
architecture:

* **Factored state space.** Segments fall into a handful of *classes*
  (distinct germline copy-number rows: (1,1) autosome, (1,0) male X, (0,0)
  no-contamination). The (N, S, M, 2) state tensor is never materialized;
  per-class (C, S, ...) planes are gathered by a per-segment class id.

* **Transition banks.** The per-pair (S, S) transition log-weight matrices
  take only ``1 + C² + 2K`` distinct values: the zero matrix (telomere
  boundaries), one matrix per class pair (plain adjacencies), and one per
  breakend (dependent on the variational breakpoint distribution q(brk)).
  The forward-backward scan gathers from this bank — O(N·S) live state
  versus the reference's O(N·S²) materialization (bpmodel.pyx:558, the
  32 GB fit jobs of workflow.py:331).

* **Bank-indexed pairwise statistics.** Pairwise posterior marginals are
  never stored; every consumer (breakpoint update, ELBO energy/entropy)
  needs only contractions of xi against bank matrices, so a single chunked
  pass accumulates ``Acc[b] = Σ_{pairs using bank b} xi_n`` and each
  consumer contracts Acc with the bank it cares about. Breakend slots of
  Acc are exactly the per-breakend joint marginals.

* **Matmul-shaped contractions.** Total-copy-number penalty matrices are built
  as one-hot einsum chains (E₁ᵀ·W·E₂ with E the S×T state-total one-hot),
  turning the reference's scalar histogram loops (bpmodel.pyx:619-684)
  into batched matmuls.

All update functions are pure: ``(spec, params, state) -> state`` pytree
transforms, jit/vmap/shard_map-compatible. Restart fan-out vmaps over
``params``/``state``; the spec (static per problem) is closed over.

Emission special cases (hdel / LOH / masks / zero-count segments) follow
bpmodel.pyx:751-853 exactly, encoded as precomputed boolean planes and
double-where guards so ``jax.grad`` stays NaN-free.
"""

import functools
from typing import NamedTuple, Any

import numpy as np
import jax
import jax.numpy as jnp

from remixt_jax.models import states as states_mod
from remixt_jax.ops import fb_scan
from remixt_jax.ops.special import einsum, exp_normalize, plogp


class Params(NamedTuple):
    """Per-restart model parameters (traced; vmapped over restarts).

    Likelihood parameter names and init values follow bpmodel.pyx:586-597.
    Masks and divergence weight live here because they vary per restart
    (max_depth differs across initializations — analysis/pipeline.py:85-103).
    """
    h: Any                       # (M,) haploid read depths
    negbin_r_0: Any
    negbin_r_1: Any
    negbin_hdel_mu: Any
    negbin_hdel_r_0: Any
    negbin_hdel_r_1: Any
    betabin_M_0: Any
    betabin_M_1: Any
    betabin_loh_p: Any
    betabin_loh_M_0: Any
    betabin_loh_M_1: Any
    divergence_weight: Any       # scalar
    total_mask: Any              # (N,) float 0/1
    allele_mask: Any             # (N,) float 0/1


class VState(NamedTuple):
    """Variational distributions + cached chain quantities.

    ``chain_scale`` is 0 before the first chain update: the stored
    framelogprob/alphas/betas then reproduce the reference's construction-time
    state (framelogprob of ones, zero transition matrices, uniform joint
    marginals — bpmodel.pyx:556-567) so the initial ELBO matches exactly.
    """
    p_breakpoint: Any            # (K, B)
    p_breakpoint_used: Any       # (K, B) value used by the last chain update
    posterior_marginals: Any     # (N, S)
    alphas: Any                  # (N, S)
    betas: Any                   # (N, S)
    framelogprob: Any            # (N, S)
    hmm_log_norm_const: Any      # scalar
    chain_scale: Any             # scalar 0.0 / 1.0
    p_allele_swap: Any           # (N, 2)
    p_outlier_total: Any         # (N, 2)
    p_outlier_allele: Any        # (N, 2)


class ModelSpec:
    """Static per-problem data: state space, chain structure, data vectors.

    Host-built from the same construction arguments as the reference
    RemixtModel (bpmodel.pyx:461-604). Arrays are jnp device constants; engine
    functions close over the spec so XLA treats them as compile-time
    constants.
    """

    def __init__(self,
                 cn_states,            # (N, S, M, 2) int
                 brk_states,           # (B, M) int
                 l, x, y,              # (N,), (N,), (N,2)
                 is_telomere,          # (N,)
                 breakpoint_idx,       # (N,)
                 breakpoint_orient,    # (N,)
                 transition_penalty,
                 normal_contamination,
                 transition_model=0,
                 dtype=jnp.float32,
                 xi_chunk=256):
        cn_states = np.asarray(cn_states, dtype=np.int64)
        brk_states = np.asarray(brk_states, dtype=np.int64)
        N, S, M, _ = cn_states.shape
        B = brk_states.shape[0]
        is_telomere = np.asarray(is_telomere, dtype=np.int64)
        breakpoint_idx = np.asarray(breakpoint_idx, dtype=np.int64)
        breakpoint_orient = np.asarray(breakpoint_orient, dtype=np.int64)

        self.N, self.S, self.M, self.B = N, S, M, B
        self.K = int(breakpoint_idx.max() + 1) if np.any(breakpoint_idx >= 0) else 0
        self.cn_max = int(max(cn_states.max(), brk_states.max()))
        self.normal_contamination = bool(normal_contamination)
        self.transition_model = int(transition_model)
        self.transition_penalty = float(abs(transition_penalty))
        self.dtype = dtype
        self.xi_chunk = int(xi_chunk)

        assert not np.any((breakpoint_idx >= 0) & (is_telomere == 1))

        # ---- segment classes: distinct state tensors -----------------------
        # The tumour block must be shared; only the normal row varies
        # (cn_model.py:354-364 constructs states this way).
        tumour = cn_states[:, :, 1:, :]
        assert np.all(tumour == tumour[0]), 'tumour state block must be segment-invariant'
        normal_rows = cn_states[:, 0, 0, :]  # (N, 2)
        uniq_rows, seg_class = np.unique(normal_rows, axis=0, return_inverse=True)
        C = uniq_rows.shape[0]
        self.C = C
        self.seg_class_np = seg_class.astype(np.int32)

        class_cn = np.zeros((C, S, M, 2), dtype=np.int64)
        class_cn[:, :, 1:, :] = tumour[0][None]
        class_cn[:, :, 0, :] = uniq_rows[:, None, :]
        self.class_cn_np = class_cn
        class_total = class_cn.sum(axis=-1)          # (C, S, M)
        self.class_total_np = class_total

        ind = states_mod.state_indicators(class_cn)
        class_is_hdel = ind['is_hdel'].astype(bool)  # (C, S)
        class_is_loh = ind['is_loh'].astype(bool)
        # subclonality depends only on the tumour block (bpmodel.pyx:505)
        self.num_alleles_subclonal = jnp.asarray(
            ind['num_alleles_subclonal'][0], dtype=dtype)  # (S,)

        nc = self.normal_contamination
        hdel_override = class_is_hdel[seg_class] if not nc else np.zeros((N, S), dtype=bool)   # (N, S)
        loh_override = class_is_loh[seg_class] if not nc else np.zeros((N, S), dtype=bool)     # (N, S)
        self.hdel_override = jnp.asarray(hdel_override)
        self.loh_override = jnp.asarray(loh_override)
        self.is_hdel_plane = jnp.asarray(class_is_hdel[seg_class])
        self.is_loh_plane = jnp.asarray(class_is_loh[seg_class])

        # ---- chain structure ----------------------------------------------
        self.seg_class = jnp.asarray(seg_class, dtype=jnp.int32)
        self.is_telomere = jnp.asarray(is_telomere)
        self.breakpoint_idx_np = breakpoint_idx
        self.breakpoint_orient_np = breakpoint_orient

        be_n = np.where(breakpoint_idx[:N - 1] >= 0)[0]
        # breakends on the final segment have no following pair; the reference
        # transition loop also ignores them (bpmodel.pyx:648: n < N-1)
        self.J = J = be_n.shape[0]
        self.be_n = jnp.asarray(be_n, dtype=jnp.int32)
        self.be_k = jnp.asarray(breakpoint_idx[be_n], dtype=jnp.int32)
        be_orient01 = (breakpoint_orient[be_n] > 0).astype(np.int32)
        self.be_orient01 = jnp.asarray(be_orient01)
        self.be_c1 = jnp.asarray(seg_class[be_n], dtype=jnp.int32)
        self.be_c2 = jnp.asarray(seg_class[be_n + 1], dtype=jnp.int32)

        # ---- transition tables --------------------------------------------
        T = self.cn_max + 1                        # total copy values 0..cn_max
        D = self.cn_max + 1                        # |d| <= cn_max; range pads ±1
        d_vals = np.arange(-D, D + 1)              # (Dn,) Dn = 2*cn_max+3
        self.T, self.Dn = T, d_vals.shape[0]

        def f_trans(dv):
            if self.transition_model == 0:
                return np.abs(dv).astype(np.float64)
            return (dv != 0).astype(np.float64)

        # F[o, m, d, b] = f(d - orient_o * brk_states[b, m]), orient −1/+1
        orient_vals = np.array([-1, 1])
        F = f_trans(d_vals[None, None, :, None]
                    - orient_vals[:, None, None, None] * brk_states.T[None, :, None, :])
        self.F = jnp.asarray(F, dtype=dtype)       # (2, M, Dn, B)

        # dsel[t1, t2] = index of (t1 - t2) in d_vals
        t = np.arange(T)
        self.dsel = jnp.asarray(t[:, None] - t[None, :] + D, dtype=jnp.int32)  # (T, T)

        # didx_onehot[t1, t2, d] = 1 when t1 - t2 == d_vals[d]
        didx = np.zeros((T, T, self.Dn))
        didx[t[:, None].repeat(T, 1), t[None, :].repeat(T, 0), t[:, None] - t[None, :] + D] = 1.0
        self.didx_onehot = jnp.asarray(didx, dtype=dtype)

        # Ecls[c, m, s, t] = 1 when class_total[c, s, m] == t
        Ecls = np.zeros((C, M, S, T))
        cc, ss, mm = np.meshgrid(np.arange(C), np.arange(S), np.arange(M), indexing='ij')
        Ecls[cc.transpose(0, 2, 1), mm.transpose(0, 2, 1), ss.transpose(0, 2, 1),
             class_total.transpose(0, 2, 1)] = 1.0
        self.Ecls = jnp.asarray(Ecls, dtype=dtype)

        # ---- static bank: telomere zeros + per-class-pair plain matrices ---
        tp = self.transition_penalty
        # allele-consistency term (bpmodel.pyx:670-684), per class pair
        A = np.zeros((C, C, S, S))
        P = np.zeros((C, C, S, S))
        for c1 in range(C):
            for c2 in range(C):
                dT = class_total[c1][:, None, :] - class_total[c2][None, :, :]
                total_term = f_trans(dT).sum(axis=-1)
                cn1 = class_cn[c1]
                cn2 = class_cn[c2]
                noflip = f_trans(cn1[:, None, :, :] - cn2[None, :, :, :]).sum(axis=(-2, -1))
                flip = f_trans(cn1[:, None, :, :] - cn2[None, :, :, ::-1]).sum(axis=(-2, -1))
                A[c1, c2] = -tp * np.minimum(noflip - total_term, flip - total_term)
                P[c1, c2] = -tp * total_term
        self.A = jnp.asarray(A, dtype=dtype)       # (C, C, S, S)
        # exp(A) per class pair, for the fused exp-space breakend bank
        # (breakend_tmats_exp): exp(-tp*tot) * expA replaces
        # exp(-tp*tot + A), skipping a full (J, S, S) log-bank pass
        self.expA = jnp.asarray(np.exp(A), dtype=dtype)

        static_bank = np.zeros((1 + C * C, S, S))
        static_bank[1:] = (A + P).reshape(C * C, S, S)
        self.static_bank = jnp.asarray(static_bank, dtype=dtype)
        self.num_static_bank = 1 + C * C
        self.num_bank = self.num_static_bank + J

        bank_idx = np.zeros(N - 1, dtype=np.int32)
        plain = (is_telomere[:N - 1] == 0) & (breakpoint_idx[:N - 1] < 0)
        bank_idx[plain] = 1 + seg_class[:N - 1][plain] * C + seg_class[1:][plain]
        bank_idx[be_n] = self.num_static_bank + np.arange(J)
        self.bank_idx = jnp.asarray(bank_idx)
        self.bank_idx_np = bank_idx

        # ---- chain batching -------------------------------------------------
        # the chain factorizes at free (telomere) junctions; batch the
        # independent sub-chains so the scan's serial length is the longest
        # chain, not the whole genome (see fb_scan.forward_backward_chains)
        tel_pairs = np.where(is_telomere[:N - 1] == 1)[0]
        bounds = np.concatenate([[0], tel_pairs + 1, [N]])
        starts, ends = bounds[:-1], bounds[1:]
        lengths = ends - starts
        Q, L = len(starts), int(lengths.max())
        self.Q, self.L = Q, L
        chain_seg_map = np.full((Q, L), N, dtype=np.int32)
        chain_bank_idx = np.zeros((Q, max(L - 1, 1)), dtype=np.int32)
        for q, (s, e) in enumerate(zip(starts, ends)):
            chain_seg_map[q, :e - s] = np.arange(s, e)
            if e - s > 1:
                chain_bank_idx[q, :e - s - 1] = bank_idx[s:e - 1]
        self.chain_seg_map = jnp.asarray(chain_seg_map)
        self.chain_bank_idx = jnp.asarray(chain_bank_idx[:, :max(L - 1, 1)])
        self.chain_last = jnp.asarray((lengths - 1).astype(np.int32))

        # ---- data ----------------------------------------------------------
        self.l = jnp.asarray(l, dtype=dtype)
        self.x = jnp.asarray(x, dtype=dtype)
        self.y = jnp.asarray(y, dtype=dtype)
        self.total_reads = jnp.asarray(np.asarray(y).sum(axis=-1), dtype=dtype)

        self.brk_states = jnp.asarray(brk_states, dtype=jnp.int32)
        self.prior_outlier_total = 0.01
        self.prior_outlier_allele = 0.01

        self._ctf = jnp.asarray(class_total, dtype=dtype)
        self._cmf = jnp.asarray(class_cn[:, :, :, 0], dtype=dtype)

        # optional device-mesh sharding hook for the chain (Q) axis, set by
        # remixt_jax.parallel.chain.enable_chain_sharding
        self.chain_constraint = None

        # optional intra-chain blocking (ops/fb_blocked.py): >1 splits every
        # chain's position axis into this many blocks, with
        # block_constraint sharding the block axis over a mesh — set by
        # remixt_jax.parallel.chain.enable_block_sharding
        self.num_chain_blocks = 1
        self.block_constraint = None

        self._jit_cache = {}

    @property
    def restart_plan(self):
        if getattr(self, '_restart_plan', None) is None:
            self._restart_plan = fb_scan.build_restart_plan(
                np.asarray(self.chain_bank_idx), self.num_static_bank)
        return self._restart_plan

    # -- initial pytrees -----------------------------------------------------

    def init_params(self, h_init, divergence_weight,
                    total_mask=None, allele_mask=None):
        dt = self.dtype
        ones = jnp.ones(self.N, dtype=dt)
        return Params(
            h=jnp.asarray(h_init, dtype=dt),
            negbin_r_0=jnp.asarray(500.0, dt),
            negbin_r_1=jnp.asarray(10.0, dt),
            negbin_hdel_mu=jnp.asarray(1e-5, dt),
            negbin_hdel_r_0=jnp.asarray(10.0, dt),
            negbin_hdel_r_1=jnp.asarray(1.0, dt),
            betabin_M_0=jnp.asarray(500.0, dt),
            betabin_M_1=jnp.asarray(10.0, dt),
            betabin_loh_p=jnp.asarray(1e-3, dt),
            betabin_loh_M_0=jnp.asarray(10.0, dt),
            betabin_loh_M_1=jnp.asarray(1.0, dt),
            divergence_weight=jnp.asarray(abs(divergence_weight), dt),
            total_mask=(ones if total_mask is None
                        else jnp.asarray(total_mask, dtype=dt)),
            allele_mask=(ones if allele_mask is None
                         else jnp.asarray(allele_mask, dtype=dt)),
        )

    def init_state(self, p_breakpoint=None):
        dt = self.dtype
        N, S, K, B = self.N, self.S, self.K, self.B
        if p_breakpoint is None:
            # favour breakpoint states with at most one copy (bpmodel.pyx:547-554)
            fav = (np.asarray(self.brk_states).max(axis=1) <= 1).astype(np.float64)
            p_breakpoint = np.tile(fav / fav.sum(), (K, 1))
        p_breakpoint = jnp.asarray(p_breakpoint, dtype=dt)
        return VState(
            p_breakpoint=p_breakpoint,
            p_breakpoint_used=p_breakpoint,
            posterior_marginals=jnp.full((N, S), 1.0 / S, dtype=dt),
            alphas=jnp.zeros((N, S), dtype=dt),
            betas=jnp.zeros((N, S), dtype=dt),
            framelogprob=jnp.ones((N, S), dtype=dt),
            hmm_log_norm_const=jnp.asarray(0.0, dt),
            chain_scale=jnp.asarray(0.0, dt),
            p_allele_swap=jnp.full((N, 2), 0.5, dtype=dt),
            p_outlier_total=jnp.tile(jnp.asarray(
                [1 - self.prior_outlier_total, self.prior_outlier_total], dt), (N, 1)),
            p_outlier_allele=jnp.tile(jnp.asarray(
                [1 - self.prior_outlier_allele, self.prior_outlier_allele], dt), (N, 1)),
        )

    # -- jitted entry points -------------------------------------------------

    def _jit(self, name, fn):
        if name not in self._jit_cache:
            self._jit_cache[name] = jax.jit(functools.partial(fn, self))
        return self._jit_cache[name]

    @property
    def sweep(self):
        """One full variational update sweep (reference update order)."""
        return self._jit('sweep', variational_sweep)

    def sweep_n(self, num_sweeps):
        """``num_sweeps`` fused sweeps, emissions computed once."""
        key = ('sweep_n', num_sweeps)
        if key not in self._jit_cache:
            self._jit_cache[key] = jax.jit(functools.partial(
                variational_sweeps, self, num_sweeps=num_sweeps))
        return self._jit_cache[key]

    @property
    def elbo(self):
        return self._jit('elbo', calculate_elbo)

    @property
    def expected_log_likelihood(self):
        return self._jit('ell', expected_log_likelihood)

    @property
    def expected_log_likelihood_and_grad_h(self):
        if 'ellgh' not in self._jit_cache:
            def f(spec, params, state, sample):
                def obj(h):
                    return expected_log_likelihood(
                        spec, params._replace(h=h), state, sample)
                return jax.value_and_grad(obj)(params.h)
            self._jit_cache['ellgh'] = jax.jit(functools.partial(f, self))
        return self._jit_cache['ellgh']

    @property
    def decode(self):
        return self._jit('decode', viterbi_decode)


# ===========================================================================
# emission model
# ===========================================================================

def _emission_row_arrays(spec, params, idx=None):
    """The per-segment arrays emissions are computed from, optionally
    gathered at a fixed-size row index (the M-step subsample)."""
    take = (lambda a: a) if idx is None else (
        lambda a: jnp.take(a, idx, axis=0))
    return dict(
        seg_class=take(spec.seg_class),
        l=take(spec.l), x=take(spec.x), y=take(spec.y),
        total_reads=take(spec.total_reads),
        hdel_override=take(spec.hdel_override),
        loh_override=take(spec.loh_override),
        is_hdel_plane=take(spec.is_hdel_plane),
        total_mask=take(params.total_mask),
        allele_mask=take(params.allele_mask),
    )


def _total_emission_plane(spec, params, rows, u):
    """One outlier component's (n, S) negative-binomial plane.

    Per-plane form so M-step accept/reject can evaluate only the planes
    a parameter touches; the stacked ll_total (2, n, S) is
    COMPONENT-MAJOR, keeping (n, S) as the contiguous minor dims rather
    than a trailing length-2 component axis. Shared subexpressions across
    planes (mu, masks, count lgammas) are deduplicated by XLA CSE when
    both planes appear in one jit.

    Double-where guard: masked segments and degenerate zero-mean lanes
    (zero-length dummy segments) contribute exactly 0 and cannot poison
    gradients (parity: bpmodel.pyx:751-776).

    lgamma factoring: the overdispersion r is a two-valued plane (the
    hdel override selects between two scalars), so every lgamma whose
    argument is x+r or r is evaluated ONCE PER BRANCH at (n, 1)/scalar
    cost and where-selected — the emission keeps only the log(nb_p)
    planes as full (n, S) transcendentals. Term order matches
    ops.special.negbin_log_likelihood exactly (bit-identical values)."""
    lgamma = jax.lax.lgamma
    depth_total_c = einsum('csm,m->cs', spec.class_total_f(), params.h)
    depth_total = depth_total_c[rows['seg_class']]

    hdel = rows['hdel_override']
    mu = rows['l'][:, None] * depth_total
    mu_eff = jnp.where(hdel, params.negbin_hdel_mu, mu)
    zero_tot = (rows['total_mask'] == 0)[:, None] | (mu_eff <= 0.0)
    mu_safe = jnp.where(zero_tot, 1.0, mu_eff)

    x = rows['x']
    xc = x[:, None]
    lg_x1 = lgamma(x + 1.0)[:, None]                       # (n, 1)

    r_plain, r_hdel = (
        (params.negbin_r_0, params.negbin_hdel_r_0),
        (params.negbin_r_1, params.negbin_hdel_r_1))[u]
    r = jnp.where(hdel, r_hdel, r_plain)
    nb_p = mu_safe / (r + mu_safe)
    nb_p = jnp.where((nb_p < 0.0) | (nb_p > 1.0), 0.5, nb_p)
    lg_r = jnp.where(hdel, lgamma(r_hdel), lgamma(r_plain))
    if spec.dtype == jnp.float32:
        # float32 accuracy: the count lgammas reach ~2e6 at whole-genome
        # read counts, so their separately-rounded difference carries an
        # O(0.1) COMPONENT-DEPENDENT error (r differs per outlier
        # component u) that produced the round-3 5e-2 outlier-posterior
        # plateau (ACCURACY.json). lgamma_shift combines them
        # cancellation-free, and the two log terms are rewritten so no
        # intermediate is evaluated near log(1) at huge x
        # (x·log(nb_p) = -x·log1p(r/mu); r·log1p(-nb_p) = r·(log r -
        # log(r+mu))). Same math as the reference, reassociated; the
        # float64 branch keeps bpmodel.pyx's exact term order.
        from remixt_jax.ops.special import lgamma_shift
        count_term = jnp.where(hdel, lgamma_shift(xc, r_hdel),
                               lgamma_shift(xc, r_plain)) - lg_r
        ll = (count_term - xc * jnp.log1p(r / mu_safe)
              + r * (jnp.log(r) - jnp.log(r + mu_safe)))
    else:
        lg_xr = jnp.where(hdel, lgamma(xc + r_hdel), lgamma(xc + r_plain))
        ll = (lg_xr - lg_x1 - lg_r
              + xc * jnp.log(nb_p) + r * jnp.log1p(-nb_p))
    return jnp.where(zero_tot, 0.0, ll)


def _total_emission_rows(spec, params, rows):
    """ll_total (2, n, S), component-major (see _total_emission_plane)."""
    return jnp.stack([_total_emission_plane(spec, params, rows, u)
                      for u in range(2)], axis=0)


def _allele_emission_plane(spec, params, rows, k):
    """One (outlier v, swap w) component's (n, S) beta-binomial plane,
    k = v·2 + w: minor-allele counts with the hdel/LOH overrides
    (parity: bpmodel.pyx:809-853). Per-plane form for the M-step's
    component-level accept/reject; see _total_emission_plane for the
    component-major layout rationale."""
    cls = rows['seg_class']
    depth_total = einsum('csm,m->cs', spec.class_total_f(), params.h)[cls]
    depth_minor = einsum('csm,m->cs', spec.class_minor_f(), params.h)[cls]

    safe_total = jnp.where(depth_total > 0, depth_total, 1.0)
    p = jnp.where(depth_total > 0, depth_minor / safe_total, 0.0)
    p = jnp.where(rows['is_hdel_plane'], 0.0, p)
    p = jnp.where(rows['loh_override'],
                  jnp.where(p == 0.0, params.betabin_loh_p, 1.0 - params.betabin_loh_p),
                  p)
    M0 = jnp.where(rows['loh_override'], params.betabin_loh_M_0, params.betabin_M_0)
    M1 = jnp.where(rows['loh_override'], params.betabin_loh_M_1, params.betabin_M_1)

    zero = ((rows['total_reads'] == 0)[:, None]
            | (rows['allele_mask'] == 0)[:, None]
            | (p <= 0.0) | (p >= 1.0))
    p_safe = jnp.where(zero, 0.5, p)

    # lgamma factoring: M is a two-valued plane (the LOH override selects
    # between two scalars) and k/n depend only on the segment row, so of
    # the nine lgammas in the beta-binomial pmf only the four with
    # p-dependent arguments (k+Mp, n-k+Mq, Mp, Mq) stay full (n, S)
    # planes; the rest evaluate per branch at (n, 1)/scalar cost and
    # where-select. Term order matches ops.special.betabin_log_likelihood
    # exactly (bit-identical values).
    lgamma = jax.lax.lgamma
    loh = rows['loh_override']
    tr = rows['total_reads'][:, None]
    v, w = divmod(k, 2)
    M_plain, M_loh = ((params.betabin_M_0, params.betabin_loh_M_0),
                      (params.betabin_M_1, params.betabin_loh_M_1))[v]
    Mv = jnp.where(loh, M_loh, M_plain)
    Mp = Mv * p_safe
    Mq = Mv * (1.0 - p_safe)
    lg_Mp = lgamma(Mp)
    lg_Mq = lgamma(Mq)
    lg_trM = jnp.where(loh, lgamma(tr + M_loh), lgamma(tr + M_plain))
    lg_M = jnp.where(loh, lgamma(M_loh), lgamma(M_plain))
    kk = rows['y'][:, w][:, None]
    if spec.dtype == jnp.float32:
        # float32 accuracy: pair each large-argument lgamma with its
        # matching count lgamma via the cancellation-free lgamma_shift
        # (see _total_emission_plane) — the pairing is exact algebra:
        #   ll = [lgamma(k+Mp) - lgamma(k+1)]
        #      + [lgamma(n-k+Mq) - lgamma(n-k+1)]
        #      - [lgamma(n+M) - lgamma(n+1)] - lgamma(Mp) - lgamma(Mq)
        #      + lgamma(M)
        # The allele-outlier components v differ in M, so the unpaired
        # form's absolute rounding at counts ~1e5 was component-dependent
        # (the same mechanism as the total-outlier plateau).
        from remixt_jax.ops.special import lgamma_shift
        ll = (lgamma_shift(kk, Mp) - lg_Mp
              + lgamma_shift(tr - kk, Mq) - lg_Mq
              - jnp.where(loh, lgamma_shift(tr, M_loh),
                          lgamma_shift(tr, M_plain)) + lg_M)
    else:
        lg_tr1 = lgamma(tr + 1.0)                          # (n, 1)
        lg_k1 = lgamma(kk + 1.0)
        lg_nk1 = lgamma(tr - kk + 1.0)
        ll = (lg_tr1 - lg_k1 - lg_nk1
              + lgamma(kk + Mp) + lgamma(tr - kk + Mq)
              - lg_trM - lg_Mp - lg_Mq + lg_M)
    return jnp.where(zero, 0.0, ll)


def _allele_emission_rows(spec, params, rows):
    """ll_allele (4, n, S), component-major, k = v·2 + w
    (see _allele_emission_plane)."""
    return jnp.stack([_allele_emission_plane(spec, params, rows, k)
                      for k in range(4)], axis=0)


def _emission_tensors_rows(spec, params, rows):
    """ll_total and ll_allele over the given row arrays
    (bpmodel.pyx:751-853)."""
    return (_total_emission_rows(spec, params, rows),
            _allele_emission_rows(spec, params, rows))


def emission_tensors(spec, params):
    """Log-likelihood tensors over every segment (N,S,2) / (N,S,2,2)."""
    return _emission_tensors_rows(
        spec, params, _emission_row_arrays(spec, params))


def log_prior_cn(spec, params):
    """Divergence prior per (n, s) (bpmodel.pyx:746-749)."""
    return (-spec.num_alleles_subclonal[None, :]
            * spec.l[:, None] * params.divergence_weight)


def _allele_mix_weights(state):
    """(n, 4) outlier×swap mixture weights, k = v·2 + w."""
    w4 = einsum('nv,nw->nvw', state.p_outlier_allele,
                state.p_allele_swap)
    return w4.reshape(w4.shape[0], 4)


def _mix_framelogprob(spec, params, state, ll_tot, ll_alle):
    frame = einsum('uns,nu->ns', ll_tot, state.p_outlier_total)
    frame += einsum('kns,nk->ns', ll_alle, _allele_mix_weights(state))
    frame += log_prior_cn(spec, params)
    return frame


def _class_total_f(spec):
    return spec._ctf


def _class_minor_f(spec):
    return spec._cmf


ModelSpec.class_total_f = _class_total_f
ModelSpec.class_minor_f = _class_minor_f


# ===========================================================================
# transition banks
# ===========================================================================

def breakend_tot_expectation(spec, p_breakpoint):
    """Expected total-copy transition penalty per breakend, (J, S, S).

    w[j,m,d] = E_{q(brk_kj)}[ f(d − orient_j·b_m) ] (bpmodel.pyx:658-664),
    expanded to (S, S) through one-hot total matmuls.
    """
    pj = p_breakpoint[spec.be_k]                      # (J, B)
    Fj = spec.F[spec.be_orient01]                     # (J, M, Dn, B)
    w = einsum('jb,jmdb->jmd', pj, Fj)                # (J, M, Dn)
    Wmat = w[:, :, spec.dsel]                         # (J, M, T, T)
    E1 = spec.Ecls[spec.be_c1]                        # (J, M, S, T)
    E2 = spec.Ecls[spec.be_c2]
    return einsum('jmst,jmtu,jmzu->jsz', E1, Wmat, E2)


def breakend_tmats(spec, p_breakpoint):
    """Per-breakend transition log-weight matrices (J, S, S): the expected
    total penalty plus the class-pair allele-consistency matrix."""
    if spec.J == 0:
        return jnp.zeros((0, spec.S, spec.S), dtype=spec.dtype)
    tot = breakend_tot_expectation(spec, p_breakpoint)
    return -spec.transition_penalty * tot + spec.A[spec.be_c1, spec.be_c2]


def breakend_tmats_exp(spec, p_breakpoint):
    """exp-space breakend transition weights, (J, S, S).

    ``exp(-tp·tot) * expA`` in ONE fused elementwise pass over the tot
    einsum's output — the log bank (J, S, S) is never materialized.
    """
    if spec.J == 0:
        return jnp.zeros((0, spec.S, spec.S), dtype=spec.dtype)
    tot = breakend_tot_expectation(spec, p_breakpoint)
    return (jnp.exp(-spec.transition_penalty * tot)
            * spec.expA[spec.be_c1, spec.be_c2])


def full_bank(spec, p_breakpoint):
    return jnp.concatenate([spec.static_bank, breakend_tmats(spec, p_breakpoint)], axis=0)


# ===========================================================================
# pairwise marginal statistics
# ===========================================================================

def xi_transition_dots(spec, state):
    """Transition contractions of the pairwise marginals:

        dot_used = Σ_n ⟨xi_n, bank_used[idx_n]⟩   (chain entropy term)
        dot_cur  = Σ_n ⟨xi_n, bank_cur[idx_n]⟩    (energy term, current q(brk))

    xi is defined by the used bank (the potentials the chain was computed
    under); the energy contracts it against the bank implied by the current
    breakpoint distribution (reference cached_log_transmat semantics,
    bpmodel.pyx:603-604, 985, 1112-1115). Thin wrapper over the
    restart-batched implementation at R=1.
    """
    state_b = jax.tree.map(lambda x: jnp.asarray(x)[None], state)
    dot_used, dot_cur = xi_transition_dots_restarts(spec, state_b)
    return dot_used[0], dot_cur[0]


def _xi_static_idx(spec):
    """Pair → static-bank index with breakend pairs pointed at the zero
    telomere entry (their contributions come from the breakend-side pass;
    the zero matrix makes them contribute exactly 0 here). Cached numpy."""
    idx = getattr(spec, '_xi_static_idx_np', None)
    if idx is None:
        idx = np.array(spec.bank_idx_np, copy=True)
        idx[np.asarray(spec.be_n)] = 0
        spec._xi_static_idx_np = idx
    return idx


def xi_transition_dots_restarts(spec, state_b):
    """Restart-batched xi·bank contractions, (R,) dot_used and dot_cur.

    The naive per-restart form (vmap of a per-pair bank gather) re-reads
    two (S, S) matrices per pair PER RESTART — the R-fold redundant HBM
    gather this engine bans from the sweep path (see
    variational_sweep_restarts). Here the static transition bank is
    gathered ONCE per pair chunk and shared across the restart axis, and
    breakend pairs go through the same xi-free one-hot factoring as the
    breakpoint update (breakend_cn_diff_marginals) — xi is never
    materialized on either path.

    Contract: ``chain_scale`` ∈ {0, 1} per restart (the only values the
    engine produces — 0 is the construction-time state, 1 after any chain
    update). The scale enters through scalar selects, which keeps every
    gathered matrix restart-independent.

    Numerics: per-axis max shifts (u_a, u_fb) instead of the joint
    (S, S)-block shift — all bank log-weights are ≤ 0 so every product is
    bounded by 1; joint configurations ~88 nats (f32) below the axis
    maxima underflow to 0, the same contract as the scan semirings and
    breakend_cn_diff_marginals.
    """
    R = state_b.alphas.shape[0]
    dtype = state_b.alphas.dtype
    scale = state_b.chain_scale                             # (R,)
    tiny = jnp.finfo(dtype).tiny
    npair = spec.N - 1
    if npair <= 0:
        zero = jnp.zeros((R,), dtype=dtype)
        return zero, zero

    # ---- static (non-breakend) pairs: shared bank gather ---------------
    chunk = min(spec.xi_chunk, npair)
    nchunks = -(-npair // chunk)
    pad = nchunks * chunk - npair

    idx = jnp.asarray(np.concatenate(
        [_xi_static_idx(spec), np.zeros(pad, dtype=np.int32)]))
    a = jnp.concatenate([
        state_b.alphas[:, :npair],
        jnp.zeros((R, pad, spec.S), dtype=dtype)], axis=1)
    fb = state_b.framelogprob[:, 1:] + state_b.betas[:, 1:]
    fb = jnp.concatenate([fb, jnp.zeros((R, pad, spec.S), dtype=dtype)],
                         axis=1)

    idx = idx.reshape(nchunks, chunk)
    # chunk-major so the scan slices are contiguous
    a = a.reshape(R, nchunks, chunk, spec.S).transpose(1, 0, 2, 3)
    fb = fb.reshape(R, nchunks, chunk, spec.S).transpose(1, 0, 2, 3)

    def step(acc, inputs):
        ci, ca, cfb = inputs
        Bc = spec.static_bank[ci]                           # (chunk, S, S)
        expBc = jnp.exp(Bc)
        Gc = expBc * Bc
        u_a = jnp.exp(ca - jnp.max(ca, axis=-1, keepdims=True))
        u_fb = jnp.exp(cfb - jnp.max(cfb, axis=-1, keepdims=True))
        right_E = einsum('csz,rcz->rcs', expBc, u_fb)
        right_G = einsum('csz,rcz->rcs', Gc, u_fb)
        right_B = einsum('csz,rcz->rcs', Bc, u_fb)
        sE = einsum('rcs,rcs->rc', u_a, right_E)
        sG = einsum('rcs,rcs->rc', u_a, right_G)
        sB = einsum('rcs,rcs->rc', u_a, right_B)
        s0 = jnp.sum(u_a, axis=-1) * jnp.sum(u_fb, axis=-1)
        # scale=1: xi under exp(B), numerator expB⊙B; scale=0: xi under
        # the ones bank (exp of the zero used matrices), numerator B
        # (the unscaled current bank). Padded pairs and breakend slots
        # carry the zero matrix: numerators vanish identically.
        ratio = jnp.where(scale[:, None] > 0,
                          sG / jnp.maximum(sE, tiny),
                          sB / jnp.maximum(s0, tiny))
        return acc + jnp.sum(ratio, axis=-1), None

    acc0 = jnp.zeros((R,), dtype=dtype)
    static_sel, _ = jax.lax.scan(step, acc0, (idx, a, fb))
    # static entries of bank_used and bank_cur coincide at scale=1, and
    # the used dot vanishes at scale=0
    dot_used = scale * static_sel
    dot_cur = static_sel

    # ---- breakend pairs: xi-free one-hot factoring ---------------------
    if spec.J:
        be_used, be_cur = _xi_breakend_dots_restarts(spec, state_b)
        dot_used = dot_used + be_used
        dot_cur = dot_cur + be_cur
    return dot_used, dot_cur


def _xi_breakend_dots_restarts(spec, state_b, be_exp_used_b=None):
    """Breakend pairs' contribution to the xi transition dots, (R,) each.

    Per pair j the used log-weight matrix is scale·(−tp·tot_used + A) and
    the current one −tp·tot_cur + A, so with xi factored as
    diag(u_a)·E·diag(u_fb)/z (E the exp-space used bank):

        ⟨xi, tot_·⟩ = Σ_{m,d} p_d[j,m,d] · w_·[j,m,d]
        ⟨xi, A⟩     = u_aᵀ (E ⊙ A_j) u_fb / z

    with p_d the per-clone total-difference marginals of
    breakend_cn_diff_marginals and w_· the q(brk) expectations of the
    penalty histogram — the identity update_p_breakpoint is built on.
    Both scale branches are evaluated in factored form (the scale=0
    branch drops E entirely) and selected per restart, so the ones-bank
    is never materialized.

    ``be_exp_used_b`` optionally supplies the (R, J, S, S) exp-space bank
    for ``p_breakpoint_used`` (unpadded width).
    """
    dtype = state_b.alphas.dtype
    scale = state_b.chain_scale                             # (R,)
    tiny = jnp.finfo(dtype).tiny
    tp = spec.transition_penalty

    n = spec.be_n
    a = state_b.alphas[:, n]                                # (R, J, S)
    fb = state_b.framelogprob[:, n + 1] + state_b.betas[:, n + 1]
    u_a = jnp.exp(a - jnp.max(a, axis=-1, keepdims=True))
    u_fb = jnp.exp(fb - jnp.max(fb, axis=-1, keepdims=True))

    if be_exp_used_b is None:
        be_exp_used_b = jax.vmap(
            lambda pb: breakend_tmats_exp(spec, pb))(
            state_b.p_breakpoint_used)                      # (R, J, S, S)
    E = be_exp_used_b
    A_g = spec.A[spec.be_c1, spec.be_c2]                    # (J, S, S)

    # normalizer and allele-consistency numerator, both scale branches
    z1 = einsum('rjs,rjsz,rjz->rj', u_a, E, u_fb)
    numA1 = einsum('rjs,rjsz,jsz,rjz->rj', u_a, E, A_g, u_fb)
    z0 = jnp.sum(u_a, axis=-1) * jnp.sum(u_fb, axis=-1)
    numA0 = einsum('rjs,jsz,rjz->rj', u_a, A_g, u_fb)
    ratioA = jnp.sum(
        jnp.where(scale[:, None] > 0,
                  numA1 / jnp.maximum(z1, tiny),
                  numA0 / jnp.maximum(z0, tiny)), axis=-1)  # (R,)

    # per-clone total-difference marginals, both scale branches
    E1 = spec.Ecls[spec.be_c1]                              # (J, M, S, T)
    E2 = spec.Ecls[spec.be_c2]
    right = E2[None] * u_fb[:, :, None, :, None]            # (R, J, M, S, T)
    left = E1[None] * u_a[:, :, None, :, None]
    mid = einsum('rjsz,rjmzu->rjmsu', E, right)
    Cmat1 = einsum('rjmst,rjmsu->rjmtu', left, mid)      # (R, J, M, T, T)
    p_d1 = einsum('rjmtu,tud->rjmd', Cmat1, spec.didx_onehot) \
        / jnp.maximum(z1, tiny)[:, :, None, None]
    left0 = einsum('jmst,rjs->rjmt', E1, u_a)
    right0 = einsum('jmzu,rjz->rjmu', E2, u_fb)
    p_d0 = einsum('rjmt,rjmu,tud->rjmd', left0, right0,
                  spec.didx_onehot) \
        / jnp.maximum(z0, tiny)[:, :, None, None]
    p_d = jnp.where(scale[:, None, None, None] > 0, p_d1, p_d0)

    Fj = spec.F[spec.be_orient01]                           # (J, M, Dn, B)
    w_used = einsum('rjb,jmdb->rjmd',
                    state_b.p_breakpoint_used[:, spec.be_k], Fj)
    w_cur = einsum('rjb,jmdb->rjmd',
                   state_b.p_breakpoint[:, spec.be_k], Fj)
    tot_used = einsum('rjmd,rjmd->r', p_d, w_used)
    tot_cur = einsum('rjmd,rjmd->r', p_d, w_cur)

    dot_used = scale * (-tp * tot_used + ratioA)
    dot_cur = -tp * tot_cur + ratioA
    return dot_used, dot_cur


def breakend_cn_diff_marginals(spec, state, exp_tm_used=None):
    """Per-breakend histogram of total-copy differences under the pairwise
    chain marginals, (J, M, Dn) — WITHOUT materializing xi.

    xi_j ∝ diag(u_a) · exp_tm_j · diag(u_fb) with u_a = exp(α_n − max α_n),
    u_fb = exp(f_{n+1} + β_{n+1} − max), so the one-hot histogram
    contraction E1ᵀ·xi·E2 (bpmodel.pyx:619-637) factors into two batched
    (T, S)×(S, S)×(S, T) matmuls over the exp-space bank the chain update
    already built (shared via CSE inside the fused sweep jit); the (J, S,
    S) pairwise-marginal tensor of the direct form — (R·)J·S² floats — is
    never formed. The
    normalizer is recovered from the contraction itself: rows of E sum to
    one, so Σ_tu Cmat[j, m] = Σ_sz xi_j for every m.

    The per-axis max shift bounds every product at 1 (exp_tm ≤ 1); joint
    configurations more than ~85 nats (f32) below the independent axis
    maxima clamp to zero, the same underflow contract as the scan
    semirings; the TINY denominator floor keeps a fully-clamped junction
    finite (it then contributes a flat histogram, matching its vanishing
    posterior weight).
    """
    if exp_tm_used is None:
        exp_tm_used = breakend_tmats_exp(spec, state.p_breakpoint_used)
        # chain_scale = 0 encodes the construction-time zero bank
        # (exp = 1). The select is a full (J, S, S) materialization
        # pass, so callers that guarantee a prior chain update — the
        # fused sweeps, whose update order runs the chain first
        # (cn_model.py:444-460) — pass the bank explicitly and skip it.
        exp_tm_used = jnp.where(state.chain_scale > 0, exp_tm_used,
                                jnp.ones_like(exp_tm_used))
    n = spec.be_n
    a = state.alphas[n]                                   # (J, S)
    fb = state.framelogprob[n + 1] + state.betas[n + 1]   # (J, S)
    u_a = jnp.exp(a - jnp.max(a, axis=-1, keepdims=True))
    u_fb = jnp.exp(fb - jnp.max(fb, axis=-1, keepdims=True))
    E1 = spec.Ecls[spec.be_c1]                            # (J, M, S, T)
    E2 = spec.Ecls[spec.be_c2]
    left = E1 * u_a[:, None, :, None]                     # (J, M, S, T)
    right = E2 * u_fb[:, None, :, None]
    mid = einsum('jsz,jmzu->jmsu', exp_tm_used, right)
    Cmat = einsum('jmst,jmsu->jmtu', left, mid)             # (J, M, T, T)
    denom = jnp.sum(Cmat[:, 0], axis=(-2, -1))            # (J,) = Σ xi_j
    denom = jnp.maximum(denom, jnp.finfo(Cmat.dtype).tiny)
    p_d = einsum('jmtu,tud->jmd', Cmat, spec.didx_onehot)
    return p_d / denom[:, None, None]


# ===========================================================================
# variational updates (bpmodel.pyx:921-1042; order cn_model.py:444-460)
# ===========================================================================

def update_p_allele_swap(spec, params, state, ll_alle):
    t4 = einsum('kns,ns->nk', ll_alle,
                state.posterior_marginals).reshape(-1, 2, 2)
    log_p = einsum('nvw,nv->nw', t4, state.p_outlier_allele)
    return state._replace(p_allele_swap=exp_normalize(log_p, axis=-1))


def update_p_cn(spec, params, state, ll_tot, ll_alle):
    """Chain update: forward-backward under the transition bank of the
    current q(brk)."""
    frame = _mix_framelogprob(spec, params, state, ll_tot, ll_alle)
    if spec.num_chain_blocks > 1:
        # intra-chain blocked two-pass: a chain can span mesh devices
        from remixt_jax.ops import fb_blocked
        bank = full_bank(spec, state.p_breakpoint)
        alphas, betas, log_norm = fb_blocked.forward_backward_chains_blocked(
            frame, bank, spec.chain_bank_idx, spec.chain_seg_map,
            spec.chain_last, spec.num_chain_blocks,
            block_constraint=spec.block_constraint)
    else:
        bank = full_bank(spec, state.p_breakpoint)
        alphas, betas, log_norm = fb_scan.forward_backward_chains(
            frame, bank, spec.chain_bank_idx, spec.chain_seg_map,
            spec.chain_last, chain_constraint=spec.chain_constraint)
    marginals = exp_normalize(alphas + betas, axis=-1)
    return state._replace(
        posterior_marginals=marginals,
        alphas=alphas,
        betas=betas,
        framelogprob=frame,
        hmm_log_norm_const=log_norm,
        chain_scale=jnp.asarray(1.0, dtype=frame.dtype),
        p_breakpoint_used=state.p_breakpoint,
    )


def update_p_breakpoint(spec, params, state, exp_tm_used=None):
    """q(brk) update from breakend pairwise marginals (bpmodel.pyx:964-985),
    via the xi-free histogram contraction.

    ``exp_tm_used`` optionally supplies the exp-space breakend bank for
    ``state.p_breakpoint_used`` — the fused sweep passes the bank its
    chain update just built so it is constructed once per sweep."""
    if spec.K == 0:
        return state
    p_d = breakend_cn_diff_marginals(spec, state, exp_tm_used)  # (J, M, Dn)
    Fj = spec.F[spec.be_orient01]                     # (J, M, Dn, B)
    contrib = -spec.transition_penalty * einsum('jmd,jmdb->jb', p_d, Fj)
    log_p = jax.ops.segment_sum(contrib, spec.be_k, num_segments=spec.K)
    return state._replace(p_breakpoint=exp_normalize(log_p, axis=-1))


def update_p_outlier_total(spec, params, state, ll_tot):
    log_p = einsum('ns,uns->nu', state.posterior_marginals, ll_tot)
    prior = jnp.log(jnp.asarray(
        [1.0 - spec.prior_outlier_total, spec.prior_outlier_total], dtype=log_p.dtype))
    return state._replace(p_outlier_total=exp_normalize(log_p + prior[None, :], axis=-1))


def update_p_outlier_allele(spec, params, state, ll_alle):
    t4 = einsum('kns,ns->nk', ll_alle,
                state.posterior_marginals).reshape(-1, 2, 2)
    log_p = einsum('nvw,nw->nv', t4, state.p_allele_swap)
    prior = jnp.log(jnp.asarray(
        [1.0 - spec.prior_outlier_allele, spec.prior_outlier_allele], dtype=log_p.dtype))
    return state._replace(p_outlier_allele=exp_normalize(log_p + prior[None, :], axis=-1))


def _sweep_with_emissions(spec, params, state, ll_tot, ll_alle):
    # the named scopes label each component's HLO ops so profiler traces
    # attribute the FUSED sweep (tools/sweep_budget.py --trace)
    with jax.named_scope('sweep_p_allele_swap'):
        state = update_p_allele_swap(spec, params, state, ll_alle)
    # the exp-space breakend bank of the q(brk) the chain is about to run
    # under; after the chain update p_breakpoint_used is exactly that
    # q(brk), so the breakpoint update consumes this bank
    with jax.named_scope('sweep_be_bank'):
        be_exp = (breakend_tmats_exp(spec, state.p_breakpoint)
                  if spec.K else None)
    with jax.named_scope('sweep_p_cn_chain'):
        state = update_p_cn(spec, params, state, ll_tot, ll_alle)
    with jax.named_scope('sweep_p_breakpoint'):
        state = update_p_breakpoint(spec, params, state, exp_tm_used=be_exp)
    with jax.named_scope('sweep_p_outlier_total'):
        state = update_p_outlier_total(spec, params, state, ll_tot)
    with jax.named_scope('sweep_p_outlier_allele'):
        state = update_p_outlier_allele(spec, params, state, ll_alle)
    return state


def variational_sweep(spec, params, state):
    """One sweep in the reference's update order (cn_model.py:444-460):
    allele swap, chain, breakpoints, total outliers, allele outliers."""
    ll_tot, ll_alle = emission_tensors(spec, params)
    return _sweep_with_emissions(spec, params, state, ll_tot, ll_alle)


def variational_sweeps(spec, params, state, num_sweeps):
    """``num_sweeps`` VI sweeps with the emission tensors computed ONCE.

    The lgamma-heavy emission depends only on params, which are constant
    across the VI sweeps inside one EM iteration, so it is not recomputed
    per sweep.
    """
    with jax.named_scope('sweep_emissions'):
        ll_tot, ll_alle = emission_tensors(spec, params)

    def body(s, _):
        return _sweep_with_emissions(spec, params, s, ll_tot, ll_alle), None

    state, _ = jax.lax.scan(body, state, None, length=num_sweeps)
    return state


def update_p_cn_restarts(spec, params_b, state_b, ll_tot_b, ll_alle_b):
    """Restart-batched chain update: the elementwise mixing vmaps, the
    forward-backward runs through the dedicated restart-batched scan
    (fb_scan.forward_backward_chains_restarts) whose static transition
    gather is shared across the restart axis."""
    R = ll_tot_b.shape[0]
    frame_b = jax.vmap(functools.partial(_mix_framelogprob, spec))(
        params_b, state_b, ll_tot_b, ll_alle_b)

    be_bank_b = jax.vmap(
        lambda pb: breakend_tmats(spec, pb))(state_b.p_breakpoint)
    alphas, betas, log_norm = fb_scan.forward_backward_chains_restarts(
        frame_b, spec.static_bank, be_bank_b, spec.restart_plan,
        np.asarray(spec.chain_seg_map), spec.chain_last)

    marginals = exp_normalize(alphas + betas, axis=-1)
    return state_b._replace(
        posterior_marginals=marginals,
        alphas=alphas,
        betas=betas,
        framelogprob=frame_b,
        hmm_log_norm_const=log_norm,
        chain_scale=jnp.ones((R,), dtype=frame_b.dtype),
        p_breakpoint_used=state_b.p_breakpoint,
    )


def _sweep_restarts_with_emissions(spec, params_b, state_b, ll_tot, ll_alle):
    vm = lambda f: jax.vmap(functools.partial(f, spec))
    with jax.named_scope('sweep_p_allele_swap'):
        state_b = vm(update_p_allele_swap)(params_b, state_b, ll_alle)
    with jax.named_scope('sweep_p_cn_chain'):
        state_b = update_p_cn_restarts(spec, params_b, state_b, ll_tot,
                                       ll_alle)
    with jax.named_scope('sweep_p_breakpoint'):
        state_b = vm(update_p_breakpoint)(params_b, state_b)
    with jax.named_scope('sweep_p_outlier_total'):
        state_b = vm(update_p_outlier_total)(params_b, state_b, ll_tot)
    with jax.named_scope('sweep_p_outlier_allele'):
        state_b = vm(update_p_outlier_allele)(params_b, state_b, ll_alle)
    return state_b


def variational_sweep_restarts(spec, params_b, state_b):
    """One sweep over a stacked restart axis.

    Equivalent to ``vmap(variational_sweep)`` but with the chain update
    routed through the restart-batched scan — the vmapped scan's
    per-(restart, lane) transition gather is R-fold redundant HBM traffic
    that grows with R.
    """
    ll_tot, ll_alle = jax.vmap(
        functools.partial(emission_tensors, spec))(params_b)
    return _sweep_restarts_with_emissions(
        spec, params_b, state_b, ll_tot, ll_alle)


def variational_sweeps_restarts(spec, params_b, state_b, num_sweeps):
    """``num_sweeps`` restart-batched VI sweeps, emissions computed once."""
    with jax.named_scope('sweep_emissions'):
        ll_tot, ll_alle = jax.vmap(
            functools.partial(emission_tensors, spec))(params_b)

    def body(s_b, _):
        return _sweep_restarts_with_emissions(
            spec, params_b, s_b, ll_tot, ll_alle), None

    state_b, _ = jax.lax.scan(body, state_b, None, length=num_sweeps)
    return state_b


# ===========================================================================
# objectives (bpmodel.pyx:1044-1157)
# ===========================================================================

def calculate_elbo_from_halves(spec, params, state,
                               ll_total_half, ll_allele_half):
    """ELBO given the two emission-likelihood contractions.

    ``ll_total_half``/``ll_allele_half`` are exactly
    ``expected_log_likelihood_{total,allele}_half`` — callers that
    already maintain them (the fused M-step accept/reject bookkeeping)
    get the ELBO for just the cost of the state-only terms."""
    trans_dot_used, trans_dot_cur = xi_transition_dots(spec, state)

    entropy = -state.hmm_log_norm_const
    entropy += jnp.sum(state.posterior_marginals * state.framelogprob)
    entropy += trans_dot_used
    entropy += jnp.sum(plogp(state.p_breakpoint))
    entropy += jnp.sum(plogp(state.p_outlier_total))
    entropy += jnp.sum(plogp(state.p_outlier_allele))
    entropy += jnp.sum(plogp(state.p_allele_swap))

    energy = jnp.sum(state.posterior_marginals * log_prior_cn(spec, params))
    energy += ll_total_half
    energy += jnp.sum(state.p_outlier_total[:, 0]) * jnp.log(1.0 - spec.prior_outlier_total)
    energy += jnp.sum(state.p_outlier_total[:, 1]) * jnp.log(spec.prior_outlier_total)
    energy += ll_allele_half
    energy += jnp.sum(state.p_outlier_allele[:, 0]) * jnp.log(1.0 - spec.prior_outlier_allele)
    energy += jnp.sum(state.p_outlier_allele[:, 1]) * jnp.log(spec.prior_outlier_allele)
    energy += trans_dot_cur

    return energy - entropy


def calculate_elbo(spec, params, state):
    """ELBO with the reference's bookkeeping: the entropy contracts pairwise
    marginals with the transition bank they were computed under; the energy
    contracts them with the bank implied by the current q(brk). The two
    differ only at breakend pairs, so the energy term is the entropy term
    plus a breakend-only correction."""
    ll_tot, ll_alle = emission_tensors(spec, params)
    ll_total_half = einsum('ns,nu,uns->', state.posterior_marginals,
                           state.p_outlier_total, ll_tot)
    ll_allele_half = einsum('ns,nk,kns->', state.posterior_marginals,
                            _allele_mix_weights(state), ll_alle)
    return calculate_elbo_from_halves(
        spec, params, state, ll_total_half, ll_allele_half)


def calculate_elbo_from_halves_restarts(spec, params_b, state_b,
                                        ll_total_half_b, ll_allele_half_b):
    """Restart-batched ELBO assembly given per-restart emission halves.

    Same bookkeeping as calculate_elbo_from_halves, but the transition
    dots run through the shared-gather restart implementation — a plain
    vmap of the per-restart assembly re-gathers two (S, S) banks per pair
    per restart; this form gathers them once for all restarts.
    """
    dot_used, dot_cur = xi_transition_dots_restarts(spec, state_b)
    marg = state_b.posterior_marginals

    entropy = -state_b.hmm_log_norm_const
    entropy += einsum('rns,rns->r', marg, state_b.framelogprob)
    entropy += dot_used
    entropy += jnp.sum(plogp(state_b.p_breakpoint), axis=(1, 2))
    entropy += jnp.sum(plogp(state_b.p_outlier_total), axis=(1, 2))
    entropy += jnp.sum(plogp(state_b.p_outlier_allele), axis=(1, 2))
    entropy += jnp.sum(plogp(state_b.p_allele_swap), axis=(1, 2))

    # Σ_ns marg · log_prior_cn = −dw · Σ_ns marg[n,s]·l[n]·nas[s]
    energy = -params_b.divergence_weight * einsum(
        'rns,n,s->r', marg, spec.l, spec.num_alleles_subclonal)
    energy += ll_total_half_b
    energy += (jnp.sum(state_b.p_outlier_total[:, :, 0], axis=1)
               * jnp.log(1.0 - spec.prior_outlier_total))
    energy += (jnp.sum(state_b.p_outlier_total[:, :, 1], axis=1)
               * jnp.log(spec.prior_outlier_total))
    energy += ll_allele_half_b
    energy += (jnp.sum(state_b.p_outlier_allele[:, :, 0], axis=1)
               * jnp.log(1.0 - spec.prior_outlier_allele))
    energy += (jnp.sum(state_b.p_outlier_allele[:, :, 1], axis=1)
               * jnp.log(spec.prior_outlier_allele))
    energy += dot_cur

    return energy - entropy


def calculate_elbo_restarts(spec, params_b, state_b):
    """Restart-batched ELBO: vmapped emission halves + the shared-gather
    batched assembly. Drop-in faster equivalent of vmap(calculate_elbo)."""
    tot_b, alle_b = jax.vmap(
        functools.partial(expected_log_likelihood_halves, spec))(
        params_b, state_b)
    return calculate_elbo_from_halves_restarts(
        spec, params_b, state_b, tot_b, alle_b)


def expected_log_likelihood(spec, params, state, sample=None):
    """Likelihood-only expected log joint over (optionally sampled) segments
    (bpmodel.pyx:1125-1157). Differentiable in params (EM M-step objective)."""
    ll_tot, ll_alle = emission_tensors(spec, params)
    if sample is None:
        sample = jnp.ones(spec.N, dtype=ll_tot.dtype)
    energy = einsum('n,ns,nu,uns->', sample, state.posterior_marginals,
                    state.p_outlier_total, ll_tot)
    energy += einsum('n,ns,nk,kns->', sample, state.posterior_marginals,
                     _allele_mix_weights(state), ll_alle)
    return energy


def expected_log_likelihood_halves(spec, params, state):
    """(total, allele) halves of the full-genome expected log likelihood.

    Likelihood parameters each touch only one emission half, so the EM
    accept/reject comparison needs only the affected half recomputed — the
    other cancels (cn_model.py:563-569 semantics at half the cost)."""
    rows = _emission_row_arrays(spec, params)
    ll_tot = _total_emission_rows(spec, params, rows)
    ll_alle = _allele_emission_rows(spec, params, rows)
    total = einsum('ns,nu,uns->', state.posterior_marginals,
                   state.p_outlier_total, ll_tot)
    allele = einsum('ns,nk,kns->', state.posterior_marginals,
                    _allele_mix_weights(state), ll_alle)
    return total, allele


def expected_log_likelihood_total_half(spec, params, state):
    rows = _emission_row_arrays(spec, params)
    ll_tot = _total_emission_rows(spec, params, rows)
    return einsum('ns,nu,uns->', state.posterior_marginals,
                  state.p_outlier_total, ll_tot)


def expected_log_likelihood_allele_half(spec, params, state):
    rows = _emission_row_arrays(spec, params)
    ll_alle = _allele_emission_rows(spec, params, rows)
    return einsum('ns,nk,kns->', state.posterior_marginals,
                  _allele_mix_weights(state), ll_alle)


def expected_log_likelihood_components(spec, params, state, half, comps):
    """Per-component full-genome expected-log-likelihood contractions.

    ``half='total'``: component u contracts marg·p_outlier_total[:, u]
    against ll_total plane u; ``half='allele'``: component k = v·2 + w
    uses p_outlier_allele[:, v]·p_allele_swap[:, w]. Returns a list of
    scalars, one per requested component. The M-step accept/reject
    recomputes only the components its parameter touches — the emission
    planes are lgamma-bound, and each scalar likelihood parameter enters
    at most two of the six planes (em.PARAM_COMPONENTS).
    """
    rows = _emission_row_arrays(spec, params)
    marg = state.posterior_marginals
    out = []
    if half == 'total':
        for u in comps:
            plane = _total_emission_plane(spec, params, rows, u)
            out.append(einsum('ns,n,ns->', marg,
                              state.p_outlier_total[:, u], plane))
    else:
        for k in comps:
            v, w = divmod(k, 2)
            wk = state.p_outlier_allele[:, v] * state.p_allele_swap[:, w]
            plane = _allele_emission_plane(spec, params, rows, k)
            out.append(einsum('ns,n,ns->', marg, wk, plane))
    return out


def expected_log_likelihood_indexed(spec, params, state, idx):
    """expected_log_likelihood restricted to the gathered segments ``idx``
    — the M-step subsample objective at subsample cost. The reference
    likewise evaluates only the ~200 sampled segments (cn_model.py:482-531,
    bpmodel.pyx:1159-1195); computing emissions genome-wide per candidate
    made the grid zoom the fit's dominant cost."""
    rows = _emission_row_arrays(spec, params, idx)
    ll_tot, ll_alle = _emission_tensors_rows(spec, params, rows)
    marg = jnp.take(state.posterior_marginals, idx, axis=0)
    out_tot = jnp.take(state.p_outlier_total, idx, axis=0)
    out_alle = jnp.take(state.p_outlier_allele, idx, axis=0)
    swap = jnp.take(state.p_allele_swap, idx, axis=0)
    energy = einsum('ns,nu,uns->', marg, out_tot, ll_tot)
    w4 = einsum('nv,nw->nvw', out_alle, swap).reshape(-1, 4)
    energy += einsum('ns,nk,kns->', marg, w4, ll_alle)
    return energy


# ===========================================================================
# decoding (bpmodel.pyx:1197-1210)
# ===========================================================================

def viterbi_decode(spec, params, state):
    """Viterbi decode using the stored chain potentials (the reference decodes
    with framelogprob/log_transmat from the last chain update).

    Returns (state_sequence (N,), logprob). The reference's allele-swap
    application loop is a no-op (it reassigns its own loop variable), so
    states are emitted unswapped — reproduced here for parity.
    """
    bank = full_bank(spec, state.p_breakpoint_used) * state.chain_scale
    return fb_scan.viterbi_chains(
        state.framelogprob, bank, spec.chain_bank_idx, spec.chain_seg_map,
        spec.chain_last)
