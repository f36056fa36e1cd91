"""TwoLevelScheduler: the paper's scheduling core (host backend).

Priority pairs -> per-job DO queues (Function 2) -> global-queue synthesis
(Fig. 7), in numpy with the exact CBP comparator, sampling from the
scheduler-owned `np.random.default_rng(seed)` — the same stream as the
reference's, so identical pairs give identical queues.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.do_select import do_select, DEFAULT_SAMPLES
from repro_torch.core.global_q import global_queue, DEFAULT_ALPHA

PRITER_C = 100.0  # paper §5.1: q = C * B_N / sqrt(V_N), C = 100

BACKENDS = ("host",)


def optimal_queue_length(num_blocks: int, n_vertices: int,
                         c: float = PRITER_C) -> int:
    q = int(c * num_blocks / math.sqrt(max(n_vertices, 1)))
    return max(1, min(q, num_blocks))


class TwoLevelScheduler:
    """Per-job DO queues + global-queue synthesis over `num_blocks` units."""

    def __init__(self, num_blocks: int, q: int, *,
                 alpha: float = DEFAULT_ALPHA,
                 samples: int = DEFAULT_SAMPLES,
                 seed: int = 0,
                 backend: str = "host"):
        if backend == "device":
            raise NotImplementedError(
                "the device scheduler backend is not ported yet (ROADMAP "
                "A5/A6, the next slice)")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {backend}")
        self.num_blocks = num_blocks
        self.q = q
        self.alpha = alpha
        self.samples = samples
        self.seed = seed
        self.backend = backend
        self.rng = np.random.default_rng(seed)
        self.last_occupancy = 0  # |global queue| at the latest synthesize()

    def reset(self, seed: Optional[int] = None) -> None:
        """Restore the RNG stream (optionally re-seeding)."""
        if seed is not None:
            self.seed = seed
        self.rng = np.random.default_rng(self.seed)

    # -- level 1: per-job DO queues (paper §4.2.2, Function 2) ---------------

    def job_queues(self, node_un: np.ndarray, p_mean: np.ndarray,
                   active: Optional[np.ndarray] = None,
                   q: Optional[int] = None) -> List[np.ndarray]:
        """[J, B_N] pairs -> per-job block queues, priority-descending.

        `active` masks jobs whose queue should be empty without consuming
        RNG draws (converged jobs / free session slots).
        """
        q = self.q if q is None else q
        return [do_select(node_un[j], p_mean[j], q, self.rng, self.samples)
                if active is None or active[j]
                else np.empty(0, dtype=np.int64)
                for j in range(node_un.shape[0])]

    # -- level 2: global queue (paper §4.2.3, Fig. 7) ------------------------

    def synthesize(self, queues: Sequence[np.ndarray],
                   q: Optional[int] = None) -> np.ndarray:
        q = self.q if q is None else q
        gq = global_queue(queues, self.num_blocks, q, self.alpha)
        # callers stage (and count) exactly len(gq) blocks
        if len(gq) > max(1, q):
            raise AssertionError(
                f"global queue overflows its budget: {len(gq)} > {q}")
        self.last_occupancy = int(len(gq))
        return gq

    def select(self, node_un: np.ndarray, p_mean: np.ndarray,
               active: Optional[np.ndarray] = None,
               q: Optional[int] = None
               ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Both levels at once: (per-job queues, global queue)."""
        queues = self.job_queues(node_un, p_mean, active, q)
        return queues, self.synthesize(queues, q)
