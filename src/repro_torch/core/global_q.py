"""De_Gl_Priority: synthesize the global priority queue (paper §4.2.3, Fig. 7).

Each job's queue of length q_j assigns rank weights Pri = q, q-1, ..., 1 from
head to tail.  Cumulative Pri per block orders the global queue; the top
alpha*q blocks are taken by cumulative weight, and the remaining (1-alpha)*q
slots are reserved for blocks that top *individual* queues but miss the
global cut (round-robin over jobs, head-first).

Two implementations:

  global_queue          - host, numpy, list-of-queues in / ids out, copied
                          from the reference (exact round-robin reserve);
  global_queue_device / - fixed-shape tensor analogue over [J, q] queues:
  accumulate_priority     the same weighted scatter-add, then the quota-
                          respecting fill of `synthesize_topq` — ceil(alpha
                          *q) slots strictly by cumulative weight, the
                          (1-alpha)q reserved slots for the best not-yet-
                          selected job heads, unclaimed reserve slots back
                          to the next-best weighted blocks.

The device functions are deterministic, and bit-identical to the
reference's on identical inputs: top-k is a stable descending sort (the
lower index first among ties, as `jax.lax.top_k`), and the weights are
integers below 2^24 in float32, so `index_add_` sums them exactly in any
order.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

DEFAULT_ALPHA = 0.8   # paper default


def global_queue(job_queues: Sequence[np.ndarray], num_blocks: int, q: int,
                 alpha: float = DEFAULT_ALPHA) -> np.ndarray:
    """job_queues: per-job block ids, priority-descending.  Returns <=q ids."""
    q = max(1, q)
    pri = np.zeros(num_blocks, dtype=np.int64)
    for queue in job_queues:
        L = len(queue)
        if L == 0:
            continue
        # head gets Pri = q (paper assigns q..1 over the queue)
        weights = np.arange(q, q - L, -1, dtype=np.int64)
        np.add.at(pri, queue, np.maximum(weights, 1))

    candidates = np.nonzero(pri > 0)[0]
    if len(candidates) == 0:
        return np.empty(0, dtype=np.int64)

    n_global = min(max(1, int(np.ceil(alpha * q))), len(candidates), q)
    top = candidates[np.argsort(-pri[candidates], kind="stable")][:n_global]
    queue: List[int] = [int(b) for b in top]
    in_queue = set(queue)

    # reserved slots: round-robin over jobs, head of each queue first
    depth = 0
    while len(queue) < q:
        added = False
        for jq in job_queues:
            if depth < len(jq):
                b = int(jq[depth])
                if b not in in_queue:
                    queue.append(b)
                    in_queue.add(b)
                    added = True
                    if len(queue) >= q:
                        break
        depth += 1
        if not added and depth > max((len(jq) for jq in job_queues), default=0):
            break
    return np.asarray(queue, dtype=np.int64)


def reserved_slots(q: int, alpha: float = DEFAULT_ALPHA) -> int:
    """(1-alpha)q slots reserved for individual queue heads (Fig. 7); the
    weighted tier keeps at least ONE slot, as the host cut does."""
    q = max(1, q)
    return max(0, q - max(1, int(math.ceil(alpha * q))))


# --------------------------------------------------------------------------
# device synthesis: fixed-shape [J, q] queues -> dense priority -> top-q
# --------------------------------------------------------------------------


def _scatter_any(flags: torch.Tensor, idx: torch.Tensor,
                 on: torch.Tensor) -> torch.Tensor:
    """flags [B_N] bool with flags[idx[i]] |= on[i] (an integer scatter-max:
    torch has no bool scatter_reduce)."""
    m = flags.to(torch.int32)
    m.scatter_reduce_(0, idx.long(), on.to(torch.int32), reduce="amax")
    return m > 0


def accumulate_priority(pri: torch.Tensor, heads: torch.Tensor,
                        sel: torch.Tensor, msk: torch.Tensor,
                        q: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add one batch of job queues into (pri, head-mask).

    sel/msk are [J, q] (fixed-shape DO queues, msk marks valid slots);
    slots get Pri = q down to 1 at the tail, exactly the host weighting;
    `heads` ([B_N] bool) collects which blocks top an individual queue —
    the candidates for the reserved slots in `synthesize_topq`.  Call once
    per view group, accumulating into one (pri, heads)."""
    w = torch.arange(q, 0, -1, dtype=torch.float32,
                     device=sel.device)[None, :] * msk
    pri = pri.index_add(0, sel.reshape(-1).long(), w.reshape(-1))
    heads = _scatter_any(heads, sel[:, 0], msk[:, 0] > 0)
    return pri, heads


def priority_topq(pri: torch.Tensor, q: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense cumulative priority -> (gsel [q] int32, gmsk [q] float32)."""
    k = min(q, pri.shape[-1])
    gv, gsel = torch.sort(pri, descending=True, stable=True)
    gv, gsel = gv[:k], gsel[:k]
    gmsk = (gv > 0.0).to(torch.float32)
    gsel = torch.where(gmsk > 0, gsel, 0).to(torch.int32)
    if k < q:
        gsel = torch.nn.functional.pad(gsel, (0, q - k))
        gmsk = torch.nn.functional.pad(gmsk, (0, q - k))
    return gsel, gmsk


def synthesize_topq(pri: torch.Tensor, heads: torch.Tensor, q: int,
                    alpha: float = DEFAULT_ALPHA
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 7's two-tier cut over a dense priority, fixed [q] output.

    ceil(alpha*q) slots go by cumulative weight alone; the (1-alpha)q
    reserved slots take the highest-priority not-yet-selected HEADS;
    reserve slots no head claims fall back to the next-best weighted
    blocks.  Valid slots come first, in tier order."""
    n_res = reserved_slots(q, alpha)
    if n_res == 0:
        return priority_topq(pri, q)
    bn = pri.shape[-1]
    s1, m1 = priority_topq(pri, q - n_res)            # weighted slots
    taken = _scatter_any(torch.zeros(bn, dtype=torch.bool,
                                     device=pri.device), s1, m1 > 0)
    s2, m2 = priority_topq(                           # reserved: best heads
        torch.where(heads & ~taken, pri, 0.0), n_res)
    taken = _scatter_any(taken, s2, m2 > 0)
    s3, m3 = priority_topq(torch.where(taken, 0.0, pri), n_res)
    spare = n_res - m2.sum()
    m3 = m3 * (torch.arange(n_res, dtype=torch.int64, device=pri.device)
               < spare)
    cand = torch.cat([s1, s2, s3])
    cmsk = torch.cat([m1, m2, m3])
    order = torch.argsort((cmsk <= 0).to(torch.int32), stable=True)[:q]
    return cand[order].to(torch.int32), cmsk[order]


def global_queue_device(job_sel: torch.Tensor, job_msk: torch.Tensor,
                        num_blocks: int, q: int,
                        alpha: float = DEFAULT_ALPHA
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """De_Gl_Priority over fixed-shape [J, q] DO queues: (gsel [q] int32,
    gmsk [q] float32) — the host `global_queue`'s blocks whenever the
    candidate set fits the queue, the cumulative-weight top with reserved
    per-job heads otherwise."""
    dev = job_sel.device
    pri, heads = accumulate_priority(
        torch.zeros(num_blocks, dtype=torch.float32, device=dev),
        torch.zeros(num_blocks, dtype=torch.bool, device=dev),
        job_sel, job_msk, q)
    return synthesize_topq(pri, heads, q, alpha)
