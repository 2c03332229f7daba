"""Blocked two-pass forward-backward: intra-chain sequence parallelism.

The chain-batched scan (ops/fb_scan.py) parallelizes over independent
chains, so its serial latency is the longest chromosome and a chain never
spans devices.  This module splits each chain's position axis into B
blocks and runs the classic two-pass scheme:

  Pass 1 (parallel over blocks): each block folds its per-step operators
      M_t = P_t * diag(exp(f_{t+1})) into one S x S *transfer matrix*
      T_b = prod_t M_t (max-normalized, with a scalar log offset).  The
      same T_b serves both directions: alpha_{end} = alpha_{start} @ T_b
      and beta_{start} = T_b @ beta_{end}.
  Boundary combine (tiny, serial in B): prefix products of the T_b give
      the exact incoming alpha at every block start; suffix products give
      the incoming beta at every block end.  On a device mesh this is the
      only cross-device data: B matrices of S x S (an all-gather of a few
      MB), the direct analogue of ring/context-parallel boundary exchange.
  Pass 2 (parallel over blocks): the ordinary vector scan re-runs inside
      each block from its exact boundary message.

Pass 1 trades O(L/B * S^3) matmuls for B-fold parallelism: the S x S
matmul chain is dense work while the vector scan is latency-bound.
Results equal the serial scan up to floating-point association.

Reference analog: the serial recursion at
/root/reference/remixt/bpmodel.pyx:1213-1246 — the thing to out-scale
(SURVEY.md §7.3 hard part 3).
"""

import functools

import jax
import jax.numpy as jnp

from remixt_jax.ops.special import logsumexp, matmul


def _fold_block_matrices(exp_bank, idx_blk, f_blk, valid_blk):
    """Per-block transfer matrices.

    Args:
        exp_bank: (num_bank, S, S) exp-space transition matrices
        idx_blk: (B, Lb) bank index per step
        f_blk: (B, Lb, S) emission of each step's TARGET position
        valid_blk: (B, Lb) bool, False for padded steps (carry unchanged)

    Returns:
        T: (B, S, S) max-normalized exp-space transfers, off: (B,) log offsets
    """
    S = f_blk.shape[-1]

    def fold_one(idx_seq, f_seq, valid_seq):
        def step(carry, inp):
            T, off = carry
            idx, f_next, valid = inp
            fmax = jnp.max(f_next)
            M = exp_bank[idx] * jnp.exp(f_next - fmax)[None, :]
            T2 = matmul(T, M)
            m = jnp.max(T2)
            T_new = jnp.where(valid, T2 / m, T)
            off_new = jnp.where(valid, off + jnp.log(m) + fmax, off)
            return (T_new, off_new), None

        init = (jnp.eye(S, dtype=f_seq.dtype), jnp.zeros((), f_seq.dtype))
        (T, off), _ = jax.lax.scan(step, init, (idx_seq, f_seq, valid_seq))
        return T, off

    return jax.vmap(fold_one)(idx_blk, f_blk, valid_blk)


def _boundary_messages(T, off, alpha0, S):
    """Exact boundary vectors from the block transfers.

    Args:
        T: (B, S, S), off: (B,), alpha0: (S,) log alpha at chain start

    Returns:
        alpha_in: (B, S) log alpha at each block's first position
        beta_in: (B, S) log beta at each block's LAST+1 position
    """
    def fwd(carry, inp):
        T_b, off_b = inp
        amax = jnp.max(carry)
        nxt = jnp.log(matmul(jnp.exp(carry - amax), T_b)) + amax + off_b
        return nxt, carry

    _, alpha_in = jax.lax.scan(fwd, alpha0, (T, off))

    def bwd(carry, inp):
        T_b, off_b = inp
        bmax = jnp.max(carry)
        prv = jnp.log(matmul(T_b, jnp.exp(carry - bmax))) + bmax + off_b
        return prv, carry

    beta_last = jnp.zeros((S,), dtype=alpha0.dtype)
    _, beta_in = jax.lax.scan(
        bwd, beta_last, (T, off), reverse=True)
    return alpha_in, beta_in


def _vector_passes(exp_bank, idx_blk, f_blk, valid_blk, alpha_in, beta_in):
    """Pass 2: per-block vector scans from exact boundary messages.

    Returns alphas (B, Lb, S) and betas (B, Lb, S) for each block's
    positions (alpha[b, i] is at global position s_b + i; beta likewise).
    """
    def run_one(idx_seq, f_seq, valid_seq, a0, b_end):
        def fstep(alpha, inp):
            idx, f_next, valid = inp
            amax = jnp.max(alpha)
            nxt = (jnp.log(matmul(jnp.exp(alpha - amax), exp_bank[idx]))
                   + amax + f_next)
            nxt = jnp.where(valid, nxt, alpha)
            return nxt, nxt

        _, alphas_rest = jax.lax.scan(
            fstep, a0, (idx_seq[:-1], f_seq[:-1], valid_seq[:-1]))
        alphas = jnp.concatenate([a0[None], alphas_rest], axis=0)

        def bstep(beta, inp):
            idx, f_next, valid = inp
            fb = f_next + beta
            bmax = jnp.max(fb)
            prv = jnp.log(matmul(exp_bank[idx], jnp.exp(fb - bmax))) + bmax
            prv = jnp.where(valid, prv, beta)
            return prv, prv

        _, betas = jax.lax.scan(
            bstep, b_end, (idx_seq, f_seq, valid_seq), reverse=True)
        return alphas, betas

    return jax.vmap(run_one)(idx_blk, f_blk, valid_blk, alpha_in, beta_in)


def forward_backward_blocked(framelogprob, bank, bank_idx, num_blocks,
                             block_constraint=None):
    """Blocked two-pass forward-backward on a single chain.

    Same contract as fb_scan.forward_backward, computed with num_blocks-way
    position parallelism.  ``block_constraint(arr, b_axis)`` optionally
    applies a device-mesh sharding constraint on the block axis — with it,
    passes 1 and 2 shard across devices and only the (B, S, S) transfer
    stack crosses the mesh.

    Returns alphas (N, S), betas (N, S), log_norm.
    """
    N, S = framelogprob.shape
    B = num_blocks
    Lb = -(-N // B)
    Np = B * Lb

    f = jnp.concatenate(
        [framelogprob,
         jnp.zeros((Np - N, S), dtype=framelogprob.dtype)], axis=0)
    # step p connects position p -> p+1; valid for p < N-1
    idx = jnp.concatenate(
        [bank_idx, jnp.zeros((Np - N + 1,), dtype=bank_idx.dtype)])
    step_valid = jnp.arange(Np) < (N - 1)
    # emission of each step's target position
    f_next = jnp.concatenate(
        [f[1:], jnp.zeros((1, S), dtype=f.dtype)], axis=0)

    idx_blk = idx.reshape(B, Lb)
    f_blk = f_next.reshape(B, Lb, S)
    valid_blk = step_valid.reshape(B, Lb)
    if block_constraint is not None:
        idx_blk = block_constraint(idx_blk, 0)
        f_blk = block_constraint(f_blk, 0)
        valid_blk = block_constraint(valid_blk, 0)

    exp_bank = jnp.exp(bank)

    T, off = _fold_block_matrices(exp_bank, idx_blk, f_blk, valid_blk)
    alpha_in, beta_in = _boundary_messages(T, off, framelogprob[0], S)

    alphas_blk, betas_blk = _vector_passes(
        exp_bank, idx_blk, f_blk, valid_blk, alpha_in, beta_in)

    alphas = alphas_blk.reshape(Np, S)[:N]
    betas = betas_blk.reshape(Np, S)[:N]
    log_norm = logsumexp(alphas[N - 1], axis=-1)
    return alphas, betas, log_norm


def forward_backward_chains_blocked(framelogprob, bank, chain_bank_idx,
                                    chain_seg_map, chain_last, num_blocks,
                                    block_constraint=None):
    """Chain-batched blocked forward-backward: every chain is additionally
    split into ``num_blocks`` position blocks, so a single chromosome can
    span devices.  Same contract as fb_scan.forward_backward_chains.
    """
    S = framelogprob.shape[-1]
    Q, L = chain_seg_map.shape
    N = framelogprob.shape[0]
    B = num_blocks
    Lb = -(-L // B)
    Lp = B * Lb

    pad_row = jnp.zeros((1, S), dtype=framelogprob.dtype)
    frame_ext = jnp.concatenate([framelogprob, pad_row], axis=0)
    F = frame_ext[chain_seg_map]                              # (Q, L, S)
    F = jnp.concatenate(
        [F, jnp.zeros((Q, Lp - L, S), dtype=F.dtype)], axis=1)

    idx = jnp.concatenate(
        [chain_bank_idx,
         jnp.zeros((Q, Lp - chain_bank_idx.shape[1]),
                   dtype=chain_bank_idx.dtype)], axis=1)      # (Q, Lp)
    # step t of chain q valid while t < chain_last[q]
    step_valid = (jnp.arange(Lp)[None, :] < chain_last[:, None])

    f_next = jnp.concatenate(
        [F[:, 1:], jnp.zeros((Q, 1, S), dtype=F.dtype)], axis=1)

    idx_blk = idx.reshape(Q, B, Lb)
    f_blk = f_next.reshape(Q, B, Lb, S)
    valid_blk = step_valid.reshape(Q, B, Lb)
    if block_constraint is not None:
        idx_blk = block_constraint(idx_blk, 1)
        f_blk = block_constraint(f_blk, 1)
        valid_blk = block_constraint(valid_blk, 1)

    exp_bank = jnp.exp(bank)

    fold = jax.vmap(functools.partial(_fold_block_matrices, exp_bank))
    T, off = fold(idx_blk, f_blk, valid_blk)                  # (Q, B, S, S)

    boundaries = jax.vmap(
        functools.partial(_boundary_messages, S=S))
    alpha_in, beta_in = boundaries(T, off, F[:, 0, :])        # (Q, B, S)

    passes = jax.vmap(functools.partial(_vector_passes, exp_bank))
    alphas_blk, betas_blk = passes(
        idx_blk, f_blk, valid_blk, alpha_in, beta_in)         # (Q, B, Lb, S)

    alphas_b = alphas_blk.reshape(Q, Lp, S)[:, :L]
    betas_b = betas_blk.reshape(Q, Lp, S)[:, :L]

    alpha_last = jnp.take_along_axis(
        alphas_b, chain_last[:, None, None].astype(jnp.int32), axis=1)[:, 0, :]
    log_norm = jnp.sum(logsumexp(alpha_last, axis=-1))

    alphas = jnp.zeros((N + 1, S), dtype=framelogprob.dtype)
    alphas = alphas.at[chain_seg_map.reshape(-1)].set(
        alphas_b.reshape(-1, S))[:N]
    betas = jnp.zeros((N + 1, S), dtype=framelogprob.dtype)
    betas = betas.at[chain_seg_map.reshape(-1)].set(
        betas_b.reshape(-1, S))[:N]
    return alphas, betas, log_norm
