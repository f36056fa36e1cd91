"""De_Gl_Priority: synthesize the global priority queue (paper §4.2.3, Fig. 7).

Each job's queue of length q_j assigns rank weights Pri = q, q-1, ..., 1 from
head to tail.  Cumulative Pri per block orders the global queue; the top
alpha*q blocks are taken by cumulative weight, and the remaining (1-alpha)*q
slots are reserved for blocks that top *individual* queues but miss the
global cut (round-robin over jobs, head-first).

Copied from the reference's host `global_queue` and `reserved_slots`; the
device synthesis (`accumulate_priority`, `synthesize_topq`) waits for the
port's device backend.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

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
