"""Chain message passing over per-pair transition banks.

The genome segment chain (N segments, S copy-number states) uses a different
transition matrix per adjacent pair, but the matrices take only a few distinct
values: one shared matrix per (segment-class, segment-class) pair for plain
adjacencies, the zero matrix for telomere boundaries, and one matrix per
breakend (dependent on the variational breakpoint distribution). The scan
carries an S-vector and gathers the pair's matrix from a stacked bank —
O(N·S) live memory instead of the reference's O(N·S²) materialization
(/root/reference/remixt/bpmodel.pyx:558, the 32 GB memory wall).

Reference recursions: sum_product (bpmodel.pyx:1213-1246), max_product
(bpmodel.pyx:1295-1333).
"""

import jax
import jax.numpy as jnp

from remixt_jax.ops.special import einsum, logsumexp


def forward_backward(framelogprob, bank, bank_idx):
    """Log-space forward-backward.

    Args:
        framelogprob: (N, S) emission log probabilities
        bank: (num_bank, S, S) stacked transition log-weight matrices
        bank_idx: (N-1,) int index of the matrix for each adjacent pair

    Returns:
        alphas (N, S), betas (N, S), log_norm_const (scalar)
    """
    f0 = framelogprob[0]
    fs = framelogprob[1:]

    def fwd_step(alpha, inputs):
        idx, f_next = inputs
        tmat = jax.lax.dynamic_index_in_dim(bank, idx, keepdims=False)
        alpha_next = logsumexp(alpha[:, None] + tmat, axis=0) + f_next
        return alpha_next, alpha_next

    _, alphas_rest = jax.lax.scan(fwd_step, f0, (bank_idx, fs))
    alphas = jnp.concatenate([f0[None], alphas_rest], axis=0)

    def bwd_step(beta, inputs):
        idx, f_next = inputs
        tmat = jax.lax.dynamic_index_in_dim(bank, idx, keepdims=False)
        beta_prev = logsumexp(tmat + (f_next + beta)[None, :], axis=1)
        return beta_prev, beta_prev

    beta_last = jnp.zeros_like(f0)
    _, betas_rest = jax.lax.scan(
        bwd_step, beta_last, (bank_idx, fs), reverse=True)
    betas = jnp.concatenate([betas_rest, beta_last[None]], axis=0)

    log_norm = logsumexp(alphas[-1], axis=-1)
    return alphas, betas, log_norm


def forward_backward_chains(framelogprob, bank, chain_bank_idx, chain_seg_map,
                            chain_last, chain_constraint=None):
    """Chain-batched log-space forward-backward.

    The genome chain factorizes exactly at free (telomere) junctions
    (bpmodel.pyx:648-650: zero transition matrices), so chromosomes/chains
    are independent sub-chains. Batching them — scan over the longest chain,
    vmap over chains — cuts the serial dependency from N steps to
    max-chain-length steps and makes the chain axis shardable across devices
    with no communication inside the scan.

    Per-chain alphas/betas differ from the single-long-chain formulation only
    by per-chain scalar shifts (the cumulative log-norm carry across free
    junctions), which cancel in every normalized consumer; the total log
    normalizer is the sum of per-chain log norms.

    Args:
        framelogprob: (N, S) global emission log probs
        bank: (num_bank, S, S); bank[0] MUST be the zero (cut) matrix
        chain_bank_idx: (Q, L-1) bank index per within-chain pair (0 on pads)
        chain_seg_map: (Q, L) global segment index, N for pads
        chain_last: (Q,) index of each chain's last real position
        chain_constraint: optional callable (array, q_axis) -> array applying
            a device-mesh sharding constraint on the chain (Q) axis — the
            sequence-parallel analogue. The scan has no cross-chain
            communication, so sharding Q is communication-free.

    Returns:
        alphas (N, S), betas (N, S), log_norm (scalar)
    """
    S = framelogprob.shape[-1]
    Q, L = chain_seg_map.shape

    pad_row = jnp.zeros((1, S), dtype=framelogprob.dtype)
    frame_ext = jnp.concatenate([framelogprob, pad_row], axis=0)
    F = frame_ext[chain_seg_map]                      # (Q, L, S)

    Ft = jnp.swapaxes(F, 0, 1)                        # (L, Q, S)
    Bt = jnp.swapaxes(chain_bank_idx, 0, 1)           # (L-1, Q)

    if chain_constraint is not None:
        Ft = chain_constraint(Ft, 1)
        Bt = chain_constraint(Bt, 1)

    # Real-space semiring: transition log-weights are <= 0, so exp(bank) is
    # in [0, 1] and the per-step log-matvec becomes a batched matmul after a
    # per-lane max shift. Paths below the dtype underflow threshold relative
    # to the lane maximum clip to zero exactly as in max-shifted logsumexp;
    # a state whose every incoming path clips goes to -inf and recovers next
    # step (its posterior mass is below precision either way). exp(bank) is
    # loop-invariant and hoisted out of the scan by XLA.
    exp_bank = jnp.exp(bank)

    def fwd_step(alpha, inputs):
        bidx, f_next = inputs                         # (Q,), (Q, S)
        P = exp_bank[bidx]                            # (Q, S, S)
        amax = jnp.max(alpha, axis=-1, keepdims=True)
        u = jnp.exp(alpha - amax)
        s = einsum('qi,qij->qj', u, P,
                   preferred_element_type=alpha.dtype)
        alpha_next = jnp.log(s) + amax + f_next
        if chain_constraint is not None:
            alpha_next = chain_constraint(alpha_next, 0)
        return alpha_next, alpha_next

    alpha0 = Ft[0]
    _, alphas_rest = jax.lax.scan(fwd_step, alpha0, (Bt, Ft[1:]))
    alphas_b = jnp.concatenate([alpha0[None], alphas_rest], axis=0)   # (L, Q, S)

    def bwd_step(beta, inputs):
        bidx, f_next = inputs
        P = exp_bank[bidx]
        fb = f_next + beta
        bmax = jnp.max(fb, axis=-1, keepdims=True)
        w = jnp.exp(fb - bmax)
        s = einsum('qij,qj->qi', P, w,
                   preferred_element_type=beta.dtype)
        beta_prev = jnp.log(s) + bmax
        if chain_constraint is not None:
            beta_prev = chain_constraint(beta_prev, 0)
        return beta_prev, beta_prev

    beta_last = jnp.zeros_like(alpha0)
    _, betas_rest = jax.lax.scan(bwd_step, beta_last, (Bt, Ft[1:]), reverse=True)
    betas_b = jnp.concatenate([betas_rest, beta_last[None]], axis=0)  # (L, Q, S)

    alphas_b = jnp.swapaxes(alphas_b, 0, 1)           # (Q, L, S)
    betas_b = jnp.swapaxes(betas_b, 0, 1)

    # per-chain log norm at each chain's true last position
    alpha_last = jnp.take_along_axis(
        alphas_b, chain_last[:, None, None].astype(jnp.int32), axis=1)[:, 0, :]
    log_norm = jnp.sum(logsumexp(alpha_last, axis=-1))

    # scatter back to the global segment layout (pads write to row N, dropped)
    N = framelogprob.shape[0]
    alphas = jnp.zeros((N + 1, S), dtype=framelogprob.dtype)
    alphas = alphas.at[chain_seg_map.reshape(-1)].set(
        alphas_b.reshape(-1, S))[:N]
    betas = jnp.zeros((N + 1, S), dtype=framelogprob.dtype)
    betas = betas.at[chain_seg_map.reshape(-1)].set(
        betas_b.reshape(-1, S))[:N]

    return alphas, betas, log_norm


def viterbi_chains(framelogprob, bank, chain_bank_idx, chain_seg_map, chain_last):
    """Chain-batched max-product decoding; same batching as
    forward_backward_chains. Returns (state_sequence (N,), logprob)."""
    S = framelogprob.shape[-1]
    Q, L = chain_seg_map.shape
    N = framelogprob.shape[0]

    pad_row = jnp.zeros((1, S), dtype=framelogprob.dtype)
    frame_ext = jnp.concatenate([framelogprob, pad_row], axis=0)
    F = frame_ext[chain_seg_map]
    Ft = jnp.swapaxes(F, 0, 1)
    Bt = jnp.swapaxes(chain_bank_idx, 0, 1)

    def fwd_step(score, inputs):
        bidx, f_next = inputs
        tmat = bank[bidx]
        cand = score[:, :, None] + tmat
        best = jnp.max(cand, axis=1)
        ptr = jnp.argmax(cand, axis=1).astype(jnp.int32)
        return best + f_next, (best + f_next, ptr)

    score0 = Ft[0]
    _, (scores_rest, ptrs) = jax.lax.scan(fwd_step, score0, (Bt, Ft[1:]))
    scores = jnp.concatenate([score0[None], scores_rest], axis=0)  # (L, Q, S)
    scores_b = jnp.swapaxes(scores, 0, 1)                          # (Q, L, S)

    # start traceback at each chain's true last position. For pads past the
    # end the pointer rows select argmax of a constant matrix (zeros), so a
    # reverse scan from L-1 would corrupt the carry; instead gather the state
    # at last and walk back with positional masking.
    last_state = jnp.argmax(jnp.take_along_axis(
        scores_b, chain_last[:, None, None].astype(jnp.int32), axis=1)[:, 0, :],
        axis=-1).astype(jnp.int32)
    logprob = jnp.sum(jnp.max(jnp.take_along_axis(
        scores_b, chain_last[:, None, None].astype(jnp.int32), axis=1)[:, 0, :],
        axis=-1))

    ptrs_b = jnp.swapaxes(ptrs, 0, 1)                              # (Q, L-1, S)

    def back_step(state, inputs):
        t, ptr_row = inputs                                        # (Q, S)
        prev = jnp.take_along_axis(ptr_row, state[:, None], axis=1)[:, 0]
        # only step back where t < chain_last (pair feeds a real position)
        state_prev = jnp.where(t < chain_last, prev, state)
        return state_prev, state_prev

    ts = jnp.arange(L - 1, dtype=jnp.int32)
    _, seq_rest = jax.lax.scan(
        back_step, last_state, (ts, jnp.swapaxes(ptrs_b, 0, 1)), reverse=True)
    # seq_rest[t] = state at position t for each chain (t in 0..L-2)
    seq_b = jnp.concatenate([jnp.swapaxes(seq_rest, 0, 1),
                             last_state[:, None]], axis=1)          # (Q, L)
    # positions beyond chain_last hold the (stationary) last state; for the
    # true last position take last_state explicitly
    seq_b = jnp.where(jnp.arange(L)[None, :] >= chain_last[:, None],
                      last_state[:, None], seq_b)

    seq = jnp.zeros((N + 1,), dtype=jnp.int32)
    seq = seq.at[chain_seg_map.reshape(-1)].set(seq_b.reshape(-1))[:N]
    return seq, logprob


def viterbi(framelogprob, bank, bank_idx):
    """Max-product decoding with first-maximum tie-breaking.

    Returns:
        state_sequence (N,) int32, logprob (scalar)
    """
    f0 = framelogprob[0]
    fs = framelogprob[1:]

    def fwd_step(score, inputs):
        idx, f_next = inputs
        tmat = jax.lax.dynamic_index_in_dim(bank, idx, keepdims=False)
        cand = score[:, None] + tmat
        best = jnp.max(cand, axis=0)
        ptr = jnp.argmax(cand, axis=0).astype(jnp.int32)
        return best + f_next, (best + f_next, ptr)

    _, (scores_rest, ptrs) = jax.lax.scan(fwd_step, f0, (bank_idx, fs))
    final_score = jnp.concatenate([f0[None], scores_rest], axis=0)[-1]

    last_state = jnp.argmax(final_score).astype(jnp.int32)
    logprob = final_score[last_state]

    def back_step(state, ptr_row):
        prev = ptr_row[state]
        return prev, prev

    _, seq_rest = jax.lax.scan(back_step, last_state, ptrs, reverse=True)
    state_sequence = jnp.concatenate([seq_rest, last_state[None]], axis=0)
    return state_sequence, logprob


def build_restart_plan(chain_bank_idx_np, num_static_bank):
    """Host-side schedule for the restart-batched scan.

    Splits the per-pair bank indices into a static-class plane (breakend
    pairs mapped to the cut class 0) and a compact per-step breakend
    schedule: at most ``kmax`` (lane, breakend) fix-ups per step, -1
    padded.  Returns dict with 'static_idx' (Q, T), 'sched_lane' and
    'sched_slot' (T, kmax) for T = chain_bank_idx.shape[1] steps.
    """
    import numpy as np

    cls = np.asarray(chain_bank_idx_np)
    is_be = cls >= num_static_bank
    static_idx = np.where(is_be, 0, cls).astype(np.int32)

    T = cls.shape[1]
    counts = is_be.sum(axis=0)
    kmax = max(int(counts.max()) if T else 1, 1)
    sched_lane = -np.ones((T, kmax), dtype=np.int32)
    sched_slot = np.zeros((T, kmax), dtype=np.int32)
    for t in range(T):
        for j, q in enumerate(np.flatnonzero(is_be[:, t])):
            sched_lane[t, j] = q
            sched_slot[t, j] = cls[q, t] - num_static_bank
    return dict(static_idx=static_idx, sched_lane=sched_lane,
                sched_slot=sched_slot, kmax=kmax)


def forward_backward_chains_restarts(frame_b, static_bank, be_bank_b, plan,
                                     chain_seg_map, chain_last):
    """Restart-batched chain forward-backward.

    The naively vmapped scan gathers an (R*Q, S, S) transition slab from
    HBM every step — R-fold redundant, since the static class matrix of a
    lane is identical across restarts (only the J breakend matrices depend
    on the restart's q(brk)).  Here the static contraction gathers (Q, S,
    S) once per step shared across restarts (one dense
    'rqi,qij->rqj'), and per-restart breakend matrices apply as at most
    ``kmax`` scheduled per-lane fix-ups ('ri,rij->rj').

    Args:
        frame_b: (R, N, S) per-restart emission log probs
        static_bank: (num_static, S, S) shared transition log-weights
        be_bank_b: (R, J, S, S) per-restart breakend log-weights
        plan: build_restart_plan output
        chain_seg_map: (Q, L) global segment index, N for pads
        chain_last: (Q,) last real position per chain

    Returns:
        alphas (R, N, S), betas (R, N, S), log_norm (R,)
    """
    R, N, S = frame_b.shape
    Q, L = chain_seg_map.shape
    kmax = plan['kmax']

    pad_row = jnp.zeros((R, 1, S), dtype=frame_b.dtype)
    frame_ext = jnp.concatenate([frame_b, pad_row], axis=1)
    F = frame_ext[:, chain_seg_map.reshape(-1)].reshape(R, Q, L, S)
    Ft = jnp.transpose(F, (2, 0, 1, 3))               # (L, R, Q, S)

    exp_static = jnp.exp(static_bank)
    exp_be = jnp.exp(be_bank_b) if be_bank_b.shape[1] else (
        jnp.zeros((R, 1, S, S), dtype=frame_b.dtype))

    static_idx = jnp.asarray(plan['static_idx']).T    # (T, Q)
    sched_lane = jnp.asarray(plan['sched_lane'])      # (T, kmax)
    sched_slot = jnp.asarray(plan['sched_slot'])

    def contract(u, idx_row, lanes, slots, reverse):
        """u (R, Q, S) -> s (R, Q, S) through this step's matrices."""
        P = exp_static[idx_row]                       # (Q, S, S)
        if reverse:
            s = einsum('rqj,qij->rqi', u, P)
        else:
            s = einsum('rqi,qij->rqj', u, P)
        for k in range(kmax):
            lane = lanes[k]
            safe = jnp.maximum(lane, 0)
            u_lane = u[:, safe, :]                    # (R, S)
            M = exp_be[:, slots[k]]                   # (R, S, S)
            if reverse:
                v = einsum('rij,rj->ri', M, u_lane)
            else:
                v = einsum('ri,rij->rj', u_lane, M)
            s = jnp.where(lane >= 0, s.at[:, safe, :].set(v), s)
        return s

    def fwd_step(alpha, inputs):
        idx_row, lanes, slots, f_next = inputs
        amax = jnp.max(alpha, axis=-1, keepdims=True)
        u = jnp.exp(alpha - amax)
        s = contract(u, idx_row, lanes, slots, reverse=False)
        alpha_next = jnp.log(s) + amax + f_next
        return alpha_next, alpha_next

    alpha0 = Ft[0]
    _, alphas_rest = jax.lax.scan(
        fwd_step, alpha0, (static_idx, sched_lane, sched_slot, Ft[1:]))
    alphas_t = jnp.concatenate([alpha0[None], alphas_rest], axis=0)

    def bwd_step(beta, inputs):
        idx_row, lanes, slots, f_next = inputs
        fb = f_next + beta
        bmax = jnp.max(fb, axis=-1, keepdims=True)
        w = jnp.exp(fb - bmax)
        s = contract(w, idx_row, lanes, slots, reverse=True)
        beta_prev = jnp.log(s) + bmax
        return beta_prev, beta_prev

    beta_last = jnp.zeros_like(alpha0)
    _, betas_rest = jax.lax.scan(
        bwd_step, beta_last, (static_idx, sched_lane, sched_slot, Ft[1:]),
        reverse=True)
    betas_t = jnp.concatenate([betas_rest, beta_last[None]], axis=0)

    alphas_b = jnp.transpose(alphas_t, (1, 2, 0, 3))  # (R, Q, L, S)
    betas_b = jnp.transpose(betas_t, (1, 2, 0, 3))

    alpha_last = jnp.take_along_axis(
        alphas_b, chain_last[None, :, None, None].astype(jnp.int32)
        * jnp.ones((R, Q, 1, 1), jnp.int32), axis=2)[:, :, 0, :]
    log_norm = jnp.sum(logsumexp(alpha_last, axis=-1), axis=-1)  # (R,)

    alphas = jnp.zeros((R, N + 1, S), dtype=frame_b.dtype)
    alphas = alphas.at[:, chain_seg_map.reshape(-1)].set(
        alphas_b.reshape(R, -1, S))[:, :N]
    betas = jnp.zeros((R, N + 1, S), dtype=frame_b.dtype)
    betas = betas.at[:, chain_seg_map.reshape(-1)].set(
        betas_b.reshape(R, -1, S))[:, :N]
    return alphas, betas, log_norm
