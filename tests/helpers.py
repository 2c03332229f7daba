"""Shared test fixtures: small random model problems with known structure.

Follows the reference test strategy (SURVEY.md §4): brute-force enumeration
oracles on tiny chains, randomized data, seeded generators.
"""

import numpy as np

from remixt_jax.models import states as states_mod
from remixt_jax.models.oracle import OracleModel


def make_problem(seed=0, N=6, M=2, cn_max=2, num_breakpoints=1,
                 normal_contamination=True, h=None,
                 transition_penalty=2.0, divergence_weight=1e-7,
                 mean_depth=100.0, num_telomeres=0):
    """Build a small random model problem and matching OracleModel kwargs.

    Breakpoints are placed at random interior non-adjacent pair positions,
    two breakends each, with random orientations.
    """
    rng = np.random.RandomState(seed)

    cn_states_one = states_mod.enumerate_cn_states(M, 2, cn_max, 1)
    if not normal_contamination:
        cn_states_one = cn_states_one.copy()
        cn_states_one[:, 0, :] = 0
    S = cn_states_one.shape[0]
    cn_states = np.tile(cn_states_one[None], (N, 1, 1, 1))
    brk_states = states_mod.enumerate_brk_states(M, cn_max, 1)

    if h is None:
        h = np.array([0.2] + [0.6 / (M - 1)] * (M - 1))[:M]
    h = np.asarray(h, dtype=float)

    # simulate data from a random true state path
    true_states = rng.randint(S, size=N)
    true_cn = cn_states[np.arange(N), true_states]
    l = rng.uniform(0.5e6, 2e6, size=N)
    depth_scale = mean_depth / max(np.einsum('nml,m->', true_cn, h) / (2.0 * N), 1e-9)
    mu = l * np.einsum('nml,m->n', true_cn, h) / 1e6 * depth_scale
    x_total = rng.poisson(np.maximum(mu, 1e-3)).astype(float)
    minor_depth = np.einsum('nm,m->n', true_cn[:, :, 0], h)
    total_depth = np.einsum('nml,m->n', true_cn, h)
    ratio = np.where(total_depth > 0, minor_depth / np.maximum(total_depth, 1e-9), 0.5)
    ratio = np.clip(ratio, 0.05, 0.95)
    y_total = rng.binomial(np.maximum(x_total.astype(int), 1), 0.8).astype(float)
    y_minor = rng.binomial(y_total.astype(int), ratio).astype(float)
    y = np.stack([y_minor, y_total - y_minor], axis=-1)

    is_telomere = np.zeros(N, dtype=np.int64)
    breakpoint_idx = -np.ones(N, dtype=np.int64)
    breakpoint_orient = np.zeros(N, dtype=np.int64)
    all_pairs = rng.permutation(N - 1)
    tel_pairs = all_pairs[:num_telomeres]
    is_telomere[tel_pairs] = 1
    free_pairs = all_pairs[num_telomeres:]
    positions = free_pairs[:min(2 * num_breakpoints, len(free_pairs))]
    kk = 0
    for k in range(num_breakpoints):
        if 2 * k + 1 >= len(positions):
            break
        for p in (positions[2 * k], positions[2 * k + 1]):
            breakpoint_idx[p] = k
            breakpoint_orient[p] = rng.choice([-1, 1])
        kk += 1

    return dict(
        num_clones=M,
        num_segments=N,
        num_breakpoints=kk,
        normal_contamination=normal_contamination,
        cn_states=cn_states,
        brk_states=brk_states,
        h_init=h,
        l=l / 1e6,
        x=x_total,
        y=y,
        is_telomere=is_telomere,
        breakpoint_idx=breakpoint_idx,
        breakpoint_orient=breakpoint_orient,
        transition_penalty=transition_penalty,
        divergence_weight=divergence_weight,
    )


def make_oracle(**kwargs):
    return OracleModel(**make_problem(**kwargs))


def brute_force_chain(framelogprob, log_transmat):
    """Exact chain quantities by enumerating all state sequences.

    Returns (log_norm_const, marginals (N,S), joint_marginals (N-1,S,S),
    map_sequence).
    """
    import itertools
    N, S = framelogprob.shape
    log_joint = {}
    best_seq, best_lp = None, -np.inf
    for seq in itertools.product(range(S), repeat=N):
        lp = framelogprob[0, seq[0]]
        for n in range(1, N):
            lp += log_transmat[n - 1, seq[n - 1], seq[n]] + framelogprob[n, seq[n]]
        log_joint[seq] = lp
        if lp > best_lp:
            best_lp, best_seq = lp, seq

    lps = np.array(list(log_joint.values()))
    vmax = lps.max()
    log_norm = np.log(np.sum(np.exp(lps - vmax))) + vmax

    marginals = np.zeros((N, S))
    joints = np.zeros((N - 1, S, S))
    for seq, lp in log_joint.items():
        p = np.exp(lp - log_norm)
        for n in range(N):
            marginals[n, seq[n]] += p
        for n in range(N - 1):
            joints[n, seq[n], seq[n + 1]] += p

    return log_norm, marginals, joints, np.array(best_seq)


def build_chain_problem(seed, chain_lengths, S=7, num_static=5, be_frac=0.25):
    """Random chain-batched forward-backward problem in the engine's bank
    layout: ``bank[0]`` is the zero cut matrix, ``num_static`` shared
    matrices, then one matrix per breakend pair. Returns numpy arrays."""
    rng = np.random.RandomState(seed)
    chain_lengths = np.asarray(chain_lengths)
    Q = len(chain_lengths)
    L = int(chain_lengths.max())
    N = int(chain_lengths.sum())

    framelogprob = -5.0 * rng.rand(N, S)

    # transition banks: log-weights <= 0, bank[0] = zero cut matrix
    static_bank = -3.0 * rng.rand(num_static, S, S)
    static_bank[0] = 0.0

    # chain layout: segments numbered consecutively chain by chain
    chain_seg_map = np.full((Q, L), N, dtype=np.int32)
    offset = 0
    for q, length in enumerate(chain_lengths):
        chain_seg_map[q, :length] = np.arange(offset, offset + length)
        offset += length

    # per-pair bank indices: mostly static classes, a sample of breakends
    chain_bank_idx = np.zeros((Q, max(L - 1, 1)), dtype=np.int32)
    be_positions = []
    for q, length in enumerate(chain_lengths):
        for t in range(length - 1):
            if rng.rand() < be_frac:
                be_positions.append((q, t))
            else:
                chain_bank_idx[q, t] = rng.randint(num_static)
    J = len(be_positions)
    be_bank = -3.0 * rng.rand(max(J, 1), S, S)
    for j, (q, t) in enumerate(be_positions):
        chain_bank_idx[q, t] = num_static + j

    return dict(
        framelogprob=framelogprob,
        static_bank=static_bank,
        be_bank=be_bank,
        full_bank=np.concatenate([static_bank, be_bank[:J]], axis=0),
        chain_bank_idx=chain_bank_idx,
        chain_seg_map=chain_seg_map,
        chain_last=(chain_lengths - 1).astype(np.int32),
        N=N,
        num_breakends=J,
    )


def dense_chain_forward_backward(framelogprob, full_bank, chain_bank_idx,
                                 chain_seg_map, chain_last):
    """Plain float64 numpy forward-backward, one chain at a time, with
    each pair's (S, S) log-weight matrix taken from the bank.

    Returns (alphas (N, S), betas (N, S), log_norm summed over chains)."""
    from scipy.special import logsumexp

    alphas = np.zeros_like(framelogprob)
    betas = np.zeros_like(framelogprob)
    log_norm = 0.0
    for q in range(chain_seg_map.shape[0]):
        n = int(chain_last[q]) + 1
        segs = chain_seg_map[q, :n]
        tmats = full_bank[chain_bank_idx[q, :n - 1]]
        f = framelogprob[segs]
        a = np.zeros((n, f.shape[1]))
        b = np.zeros((n, f.shape[1]))
        a[0] = f[0]
        for t in range(1, n):
            a[t] = logsumexp(a[t - 1][:, None] + tmats[t - 1], axis=0) + f[t]
        for t in range(n - 2, -1, -1):
            b[t] = logsumexp(tmats[t] + (f[t + 1] + b[t + 1])[None, :], axis=1)
        alphas[segs] = a
        betas[segs] = b
        log_norm += logsumexp(a[-1])
    return alphas, betas, log_norm
