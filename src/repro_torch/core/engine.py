"""Legacy concurrent-engine API, a thin shim over GraphSession.

`make_run` + `ConcurrentEngine.run_two_level/run_fused/run_independent/
run_all_blocks` declare a FIXED job set up front and run it to a joint
fixpoint.  Each run_* call drives a GraphSession under the matching
SchedulePolicy with capacity == J (no padding) and a freshly reset
scheduler stream, so the shim drives exactly what a static session batch
would.  New code should use `GraphSession` directly.

Metrics: `tile_loads` counts block stagings.  In two_level/all_blocks a
staged tile serves all J jobs; independent pays J separate stagings — the
paper's memory-access redundancy, measurable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.algorithms.base import Algorithm
from repro_torch.core.do_select import DEFAULT_SAMPLES
from repro_torch.core.global_q import DEFAULT_ALPHA
from repro_torch.core.policy import (RunMetrics, SchedulePolicy, TwoLevel,
                                     Fused, Independent, AllBlocks)
from repro_torch.core.push import compute_pairs, push_plus_one, push_min_one
from repro_torch.core.scheduler import PRITER_C, optimal_queue_length
from repro_torch.core.session import GraphSession
from repro_torch.graph.structure import BlockedGraph, CSRGraph, build_blocked

__all__ = [
    "ConcurrentEngine", "ConcurrentRun", "RunMetrics", "make_run",
    "optimal_queue_length", "PRITER_C",
    "push_plus_one", "push_min_one", "compute_pairs",
]


@dataclasses.dataclass
class ConcurrentRun:
    """J jobs of the same semiring sharing one BlockedGraph view."""

    algs: List[Algorithm]
    graph: BlockedGraph
    values: torch.Tensor   # [J, B_N, Vb]
    deltas: torch.Tensor   # [J, B_N, Vb]
    push_scale: torch.Tensor  # [J]

    @property
    def num_jobs(self) -> int:
        return len(self.algs)


def make_run(algs: Sequence[Algorithm], csr: CSRGraph, block_size: int, *,
             device=None) -> ConcurrentRun:
    """Build the shared graph view + stacked job states on `device`
    (None: CUDA).

    All jobs must share (semiring, graph_fill, graph_normalize,
    graph_symmetrize) — the Seraph-style shared-data premise.
    """
    a0 = algs[0]
    for a in algs:
        if (a.semiring, a.graph_fill, a.graph_normalize, a.graph_symmetrize) != \
           (a0.semiring, a0.graph_fill, a0.graph_normalize, a0.graph_symmetrize):
            raise ValueError("concurrent jobs must share one graph view")
    g_csr = csr.symmetrized() if a0.graph_symmetrize else csr
    g = build_blocked(g_csr, block_size, fill=a0.graph_fill,
                      normalize=a0.graph_normalize, device=device)
    vals, dels = [], []
    for a in algs:
        v, d = a.init(g)
        vals.append(v)
        dels.append(d)
    return ConcurrentRun(
        algs=list(algs), graph=g,
        values=torch.stack(vals), deltas=torch.stack(dels),
        push_scale=torch.tensor([a.get_push_scale() for a in algs],
                                dtype=torch.float32, device=g.device))


class ConcurrentEngine:
    """Runs a ConcurrentRun to convergence under a chosen schedule (shim).

    `use_pallas=None` resolves as it does on `GraphSession`: the fused
    superstep kernel on a CUDA run, the plain pair sweep on the CPU."""

    def __init__(self, run: ConcurrentRun, *,
                 c: float = PRITER_C,
                 alpha: float = DEFAULT_ALPHA,
                 samples: int = DEFAULT_SAMPLES,
                 seed: int = 0,
                 use_pallas: Optional[bool] = None):
        self.session = GraphSession.from_run(
            run, c=c, alpha=alpha, samples=samples, seed=seed,
            use_pallas=use_pallas)
        self.run = run

    # configuration lives on the session/scheduler; these properties keep
    # the historical attributes readable AND writable

    @property
    def q(self) -> int:
        return self.session.q

    @property
    def seed(self) -> int:
        return self.session.seed

    @seed.setter
    def seed(self, value: int) -> None:
        self.session.seed = value

    @property
    def alpha(self) -> float:
        return self.session.alpha

    @alpha.setter
    def alpha(self, value: float) -> None:
        self.session.alpha = value

    @property
    def samples(self) -> int:
        return self.session.samples

    @samples.setter
    def samples(self, value: int) -> None:
        self.session.samples = value

    @property
    def use_pallas(self) -> bool:
        return self.session.use_pallas

    @use_pallas.setter
    def use_pallas(self, value: bool) -> None:
        self.session.use_pallas = value

    def _drive(self, policy: SchedulePolicy, max_supersteps: int,
               mesh=None) -> RunMetrics:
        # historical behaviour: every run_* call restarts its stream
        self.session.scheduler.reset()
        m = self.session.run(policy, max_supersteps, mesh=mesh)
        self.run = dataclasses.replace(
            self.run, values=self.session.values, deltas=self.session.deltas,
            push_scale=self.session.push_scale)
        return m

    def run_two_level(self, max_supersteps: int = 100000, *,
                      mesh=None, backend: str = "host",
                      steps_per_sync=1) -> RunMetrics:
        """The paper's schedule: MPDS (DO queues + global queue) + CAJS
        push.  backend="device" moves both scheduling levels onto the
        device; steps_per_sync then sets how many supersteps run per host
        read."""
        return self._drive(
            TwoLevel(backend=backend, steps_per_sync=steps_per_sync),
            max_supersteps, mesh)

    def run_independent(self, max_supersteps: int = 100000) -> RunMetrics:
        """Per-job queues processed separately (paper Fig. 3 'current
        mode')."""
        return self._drive(Independent(), max_supersteps)

    def run_all_blocks(self, max_supersteps: int = 100000) -> RunMetrics:
        """Non-prioritized synchronous baseline: all blocks, shared
        staging."""
        return self._drive(AllBlocks(), max_supersteps)

    def run_fused(self, max_supersteps: int = 100000, *,
                  mesh=None, steps_per_sync=None) -> RunMetrics:
        """The whole two-level loop on the device (`Fused` is
        TwoLevel(backend="device", steps_per_sync=inf)); a finite
        steps_per_sync reads the host every K supersteps instead."""
        k = math.inf if steps_per_sync is None else steps_per_sync
        return self._drive(Fused(steps_per_sync=k), max_supersteps, mesh)

    # -- results -------------------------------------------------------------

    def results(self) -> np.ndarray:
        """[J, n_real] per-job algorithm results.  After a run on a mesh
        `self.run` holds this rank's slice (`dist.graph.shard_run`'s
        layout) and the results are gathered: a collective, so every
        rank calls it."""
        r = self.run
        values, deltas = r.values, r.deltas
        if self.session._mesh2d is not None:
            values, deltas, _ = self.session._full_state(
                self.session._sole_group())
        out = []
        for j, a in enumerate(r.algs):
            res = a.result(values[j], deltas[j])
            res = res.reshape(-1)[:r.graph.n_real]
            out.append(res.cpu().numpy())  # noqa: RPT002 - a result a job, after the run
        return np.stack(out)
