"""TwoLevelScheduler: the paper's scheduling core.

Priority pairs -> per-job DO queues (Function 2) -> global-queue synthesis
(Fig. 7).  Both levels are backend-pluggable:

  backend="host"   - numpy + the exact CBP comparator, sampling from the
                     scheduler-owned `np.random.default_rng(seed)` — the
                     same stream as the reference's, so identical pairs
                     give identical queues;
  backend="device" - the tensor analogues (`group_queues_device`,
                     `global_queue_device`) on the scheduler's device
                     (``device=None`` means CUDA and raises without it;
                     pass ``device="cpu"``), drawing the key of stream
                     position `_step`, which each call advances
                     (`_next_key`).  The list in/out interface is
                     unchanged.

The device driver (`core.policy`) calls the same functions inside its
superstep rather than through this object, and draws the same stream:
superstep p draws `step_key(seed, p)` in both.  A list-interface call
stands for view group 0, so on a one-view session `select` at position p
stages what a `TwoLevel(backend="device")` run stages at superstep p.
This object stays the one home for q, alpha, samples, seed and the
stream position either way.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.do_select import (do_select, group_queues_device,
                                        step_key, DEFAULT_SAMPLES)
from repro_torch.core.global_q import (global_queue, global_queue_device,
                                       DEFAULT_ALPHA)
from repro_torch.kernels.common import resolve_device

PRITER_C = 100.0  # paper §5.1: q = C * B_N / sqrt(V_N), C = 100

BACKENDS = ("host", "device")


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
                 backend: str = "host",
                 device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}: {backend}")
        # where the device backend's tensors live; the host backend has none
        self.device = resolve_device(device) if backend == "device" else None
        self.num_blocks = num_blocks
        self.q = q
        self.alpha = alpha
        self.samples = samples
        self.seed = seed
        self.backend = backend
        self.rng = np.random.default_rng(seed)
        self._step = 0        # device-backend stream position
        self.last_occupancy = 0  # |global queue| at the latest synthesize()

    def reset(self, seed: Optional[int] = None) -> None:
        """Restore the RNG stream (optionally re-seeding), both backends."""
        if seed is not None:
            self.seed = seed
        self.rng = np.random.default_rng(self.seed)
        self._step = 0

    def _next_key(self) -> int:
        """The draw key of stream position `_step` (the one the device
        driver draws at that superstep), advanced once per call as the
        host RNG is."""
        key = step_key(self.seed, self._step)
        self._step += 1
        return key

    # -- level 1: per-job DO queues (paper §4.2.2, Function 2) ---------------

    def job_queues(self, node_un: np.ndarray, p_mean: np.ndarray,
                   active: Optional[np.ndarray] = None,
                   q: Optional[int] = None) -> List[np.ndarray]:
        """[J, B_N] pairs -> per-job block queues, priority-descending.

        `active` masks jobs whose queue should be empty without consuming
        RNG draws (converged jobs / free session slots).
        """
        q = self.q if q is None else q
        if self.backend == "device":
            return self._job_queues_device(node_un, p_mean, active, q)
        return [do_select(node_un[j], p_mean[j], q, self.rng, self.samples)
                if active is None or active[j]
                else np.empty(0, dtype=np.int64)
                for j in range(node_un.shape[0])]

    def _job_queues_device(self, node_un, p_mean, active, q):
        j = node_un.shape[0]
        nu, pm = (torch.as_tensor(np.asarray(x, dtype=np.float32),
                                  device=self.device)
                  for x in (node_un, p_mean))
        sel, msk = group_queues_device(nu, pm, self._next_key(), 0, q,
                                       self.samples)
        sel, msk = sel.cpu().numpy(), msk.cpu().numpy()
        return [sel[i][msk[i] > 0].astype(np.int64)
                if active is None or active[i]
                else np.empty(0, dtype=np.int64)
                for i in range(j)]

    # -- level 2: global queue (paper §4.2.3, Fig. 7) ------------------------

    def synthesize(self, queues: Sequence[np.ndarray],
                   q: Optional[int] = None) -> np.ndarray:
        q = self.q if q is None else q
        if self.backend == "device":
            gq = self._synthesize_device(queues, q)
        else:
            gq = global_queue(queues, self.num_blocks, q, self.alpha)
        # callers stage (and count) exactly len(gq) blocks
        if len(gq) > max(1, q):
            raise AssertionError(
                f"global queue overflows its budget: {len(gq)} > {q}")
        self.last_occupancy = int(len(gq))
        return gq

    def _synthesize_device(self, queues, q):
        j = max(1, len(queues))
        sel = np.zeros((j, q), dtype=np.int32)
        msk = np.zeros((j, q), dtype=np.float32)
        for i, jq in enumerate(queues):
            n = min(len(jq), q)
            sel[i, :n] = jq[:n]
            msk[i, :n] = 1.0
        gsel, gmsk = global_queue_device(
            torch.as_tensor(sel, device=self.device),
            torch.as_tensor(msk, device=self.device),
            self.num_blocks, q, self.alpha)
        gsel, gmsk = gsel.cpu().numpy(), gmsk.cpu().numpy()
        return gsel[gmsk > 0].astype(np.int64)

    def select(self, node_un: np.ndarray, p_mean: np.ndarray,
               active: Optional[np.ndarray] = None,
               q: Optional[int] = None
               ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Both levels at once: (per-job queues, global queue)."""
        queues = self.job_queues(node_un, p_mean, active, q)
        return queues, self.synthesize(queues, q)
