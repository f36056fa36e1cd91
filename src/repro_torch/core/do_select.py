"""Function 2: the DO algorithm — approximate top-q block selection (host).

Paper §4.2.2: instead of sorting all B_N blocks, sample s (default 500)
pairs, sort the sample, estimate the q-th priority threshold as the
(q*s/B_N)-th sample, then one O(B_N) pass collects blocks above the
threshold; only those ~q blocks are sorted.

Two implementations share the structure:

  do_select        - host, numpy, exact CBP comparator (Function 1),
                     copied from the reference: from identical numpy
                     inputs and an identical `np.random.Generator` state
                     it returns identical queues;
  do_select_device - fixed-shape tensor analogue for the device backend:
                     uniform sampling without replacement as the top s
                     of noise over live blocks, the same cut-index
                     threshold, ranking by the scalar `do_score`.  It
                     takes the noise its caller drew, so given the
                     reference's own Gumbel draw it returns the
                     reference's queue exactly.

The port's draw (`step_key`, `uniform_noise`) is a counter-based integer
hash of (seed, stream position, group, job, block): the same bits on the
CPU and on CUDA, no generator state, and no host sync.  `jax.random`'s
bits are not reproduced; what the reference promises of its draw holds
(a superstep draws the same numbers whatever the sync cadence, and each
run draws fresh ones).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.priority import cbp, cbp_key_sort, do_score

DEFAULT_SAMPLES = 500  # paper default


def do_select(node_un: np.ndarray, p_mean: np.ndarray, q: int,
              rng: np.random.Generator, s: int = DEFAULT_SAMPLES) -> np.ndarray:
    """Return ~q block indices in CBP-descending order (Function 2).

    Converged blocks (node_un == 0) never enter the queue.
    """
    b_n = len(node_un)
    live = np.nonzero(node_un > 0)[0]
    if len(live) == 0:
        return np.empty(0, dtype=np.int64)
    q = max(1, min(q, len(live)))
    if len(live) <= q:           # queue covers everything that is unconverged
        order = cbp_key_sort(node_un[live], p_mean[live])
        return live[order]

    s_eff = min(s, len(live))
    samples = rng.choice(live, size=s_eff, replace=False)
    order = cbp_key_sort(node_un[samples], p_mean[samples])
    samples = samples[order]  # priority-descending

    # lower bound of the top-q priority estimated from the sample
    cutindex = min(int(q * s_eff / b_n), s_eff - 1)
    thresh = (float(node_un[samples[cutindex]]),
              float(p_mean[samples[cutindex]]))

    picked = [int(r) for r in live
              if cbp((float(node_un[r]), float(p_mean[r])), thresh)]
    if not picked:  # threshold estimate too aggressive; fall back to samples
        picked = [int(x) for x in samples[:q]]
    picked = np.asarray(picked, dtype=np.int64)
    order = cbp_key_sort(node_un[picked], p_mean[picked])
    return picked[order][:q]


# --------------------------------------------------------------------------
# device sampler: the port's draw + Function 2 on fixed shapes
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9   # offsets counters so that 0 is no fixed point


def _mix32(x):
    """A bijection of [0, 2^32) with full avalanche (two xorshift-multiply
    rounds).  Works on python ints and int64 tensors alike; the multiplier
    stays below 2^27 so no int64 product overflows."""
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    x = x ^ (x >> 16)
    x = (x * 0x45D9F3B) & _M32
    return x ^ (x >> 16)


def seed_key(seed: int) -> int:
    """The stream's root key (the counterpart of `jax.random.PRNGKey`)."""
    return _mix32((int(seed) + _GOLDEN) & _M32)


def fold_in(key, data):
    """Derive a key from `key` and a counter (ints or int64 tensors in
    [0, 2^32), broadcasting): distinct counters give distinct keys."""
    return _mix32(key ^ _mix32((data + _GOLDEN) & _M32))


def step_key(seed: int, position):
    """The draw key of the superstep at stream `position` (an int, or an
    int64 tensor inside a device chunk).  The device driver and the
    scheduler's list interface both draw from it, so the stream depends
    on the position alone: not on run boundaries or the sync cadence."""
    return fold_in(seed_key(seed), position)


def uniform_noise(key, group: int, shape, device, *, job0: int = 0,
                  shard=None) -> torch.Tensor:
    """[J, B_N] float32 noise for one view group's DO sampling at one
    superstep: uniform on the integers [0, 2^24), exact in float32,
    drawn from `key` (an int or an int64 0-dim tensor) and the
    (group, job, block) counters.

    On a mesh (`dist.mesh2d`) a rank draws for its slice: rows are the
    GLOBAL jobs job0 .. job0 + J - 1, and a block shard's draw is keyed
    by its index (`shard`, None for the whole block axis), so a job mesh
    draws exactly what one device draws for the same jobs."""
    j, bn = shape
    k = fold_in(key, group)
    if shard is not None:
        k = fold_in(k, shard)
    jobs = torch.arange(j, dtype=torch.int64, device=device)
    rows = fold_in(k, jobs + job0 if job0 else jobs)
    x = fold_in(rows[:, None],
                torch.arange(bn, dtype=torch.int64, device=device)[None, :])
    return (x >> 8).to(torch.float32)


def _top_k(x: torch.Tensor, k: int):
    """Top-k along the last axis with `jax.lax.top_k`'s tie order (the
    lower index first among equal values): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def do_select_device(node_un: torch.Tensor, p_mean: torch.Tensor, q: int,
                     noise: torch.Tensor, s: int = DEFAULT_SAMPLES):
    """Device Function 2: fixed-shape (sel [..., q] int32, msk [..., q]
    float32) for [..., B_N] pairs (one job, or a batch of jobs).

    `noise` [..., B_N] is the caller's draw; the live mask is applied
    here, as the reference applies it to its Gumbel draw.  Step for step
    the reference's `do_select_device`:
      * s live blocks are sampled uniformly without replacement (the top
        s_cap of the noise over live blocks);
      * the q-th priority threshold is the (q*s_eff/B_N)-th highest-
        scoring sample;
      * blocks at or above it are ranked by `do_score`.
    Converged blocks never enter the queue; with fewer than q live
    blocks the queue is the whole live set.  Invalid slots alias block 0
    and carry msk 0.  No host sync: every index is a tensor."""
    b_n = node_un.shape[-1]
    k = min(q, b_n)
    neg = float("-inf")
    score = do_score(node_un, p_mean)                  # -inf when converged
    live = node_un > 0
    n_live = live.sum(-1, keepdim=True)

    # uniform sample of s_eff live blocks, without replacement
    s_cap = max(1, min(int(s), b_n))
    _, samp_idx = _top_k(torch.where(live, noise, neg), s_cap)
    s_eff = torch.clamp(n_live, max=s_cap)
    ar = torch.arange(s_cap, dtype=torch.int64, device=node_un.device)
    samp_scores = torch.where(ar < s_eff, score.gather(-1, samp_idx), neg)
    samp_sorted = torch.sort(samp_scores, dim=-1, descending=True).values

    # lower bound of the top-q priority estimated from the sample
    cut = torch.minimum(torch.clamp((q * s_eff) // b_n, min=0),
                        torch.clamp(s_eff - 1, min=0))
    thresh = samp_sorted.gather(-1, cut)
    eligible = torch.where(n_live <= k, live, live & (score >= thresh))

    topv, topi = _top_k(torch.where(eligible, score, neg), k)
    msk = torch.isfinite(topv).to(torch.float32)
    sel = torch.where(msk > 0, topi, 0).to(torch.int32)
    if k < q:   # q beyond B_N: pad to the fixed [q] layout
        pad = (0, q - k)
        sel = torch.nn.functional.pad(sel, pad)
        msk = torch.nn.functional.pad(msk, pad)
    return sel, msk


def group_queues_device(node_un: torch.Tensor, p_mean: torch.Tensor, key,
                        group: int, q: int, s: int = DEFAULT_SAMPLES):
    """One view group's DO queues at one superstep: [J, B_N] pairs ->
    (sel, msk) [J, q], each job's noise drawn from (key, group, job,
    block).  The one device Function 2 of the port: the device driver
    calls it per group, the scheduler's list interface as group 0."""
    noise = uniform_noise(key, group, tuple(node_un.shape), node_un.device)
    return do_select_device(node_un, p_mean, q, noise, s)
