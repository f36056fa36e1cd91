"""Concurrent request admission: the paper's two-level scheduling applied
one level up, to requests arriving at a shared graph session.

Mapping:
  graph job        <-> request stream (a tenant's stream of requests)
  graph block      <-> request group (the block a request's job starts in)
  block priority   <-> <n_waiting, mean_urgency> pair (Eq. 1, verbatim)
  MPDS/global queue<-> admission: per-stream DO queues -> De_Gl_Priority

The scheduler runs on the SAME TwoLevelScheduler object as the graph
engine (repro_torch.core.scheduler): the policy core is
data-structure-agnostic.

Admission is deterministic (streams visited in sorted id order, not dict
insertion order) and linear in the number of waiting requests (per-group
FIFO cursors instead of repeated list scans/removals).

Streams are HETEROGENEOUS, mirroring GraphSession's mixed-semiring jobs:
a stream declares a `family` (the workload kind, e.g. "pagerank" next to
"sssp").  Families never partition admission: ONE global queue is
synthesized across every stream's DO queue regardless of family.
`schedule_step` reports the per-family admitted mix.

Host numpy, copied from the reference (`repro.serve.concurrent`): for a
seed the host backend admits the same requests in the same order.  The
device backend's scheduler lives on `device` (None means CUDA and raises
without one; pass "cpu").
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.scheduler import TwoLevelScheduler
from repro_torch.obs.serve import ServeMetrics


@dataclasses.dataclass
class Request:
    stream_id: int
    group: int              # bucket (e.g. shared-prefix / SLA class)
    urgency: float          # higher = more urgent (deadline-derived)
    tokens_left: int


class RequestStream:
    """One tenant's queue of requests ('job').

    `family` tags the workload kind (the serve analogue of a graph job's
    semiring family); mixed-family streams share one admission pass."""

    def __init__(self, stream_id: int, family: str = "default"):
        self.stream_id = stream_id
        self.family = family
        self.waiting: List[Request] = []

    def add(self, req: Request):
        self.waiting.append(req)


class ConcurrentServeScheduler:
    """Admission control: which waiting requests start this step."""

    def __init__(self, n_groups: int, batch_budget: int, *,
                 alpha: float = 0.8, seed: int = 0, backend: str = "host",
                 metrics: bool = True, trace=None, slo=None, device=None):
        """backend selects where the two-level policy core computes its
        selection ("host" numpy / "device" torch, on `device`) — the SAME
        pluggable TwoLevelScheduler core as the graph engine, so the serve
        layer inherits the device analogues without any code of its own.

        `metrics` (default on — recording is an appended float per event)
        drives a ServeMetrics with per-stream wait time, service time and
        per-family queue depth; `trace` optionally takes a
        repro_torch.obs.TraceRecorder to share a GraphSession's trace timeline
        (admissions land as instant events on its clock); `slo` optionally
        takes a repro_torch.obs.SLOTracker that rides the same hooks (and the
        same first-seen stamps) for sliding-window SLIs judged against
        declared SLOTargets."""
        self.n_groups = n_groups
        self.batch_budget = batch_budget
        self.scheduler = TwoLevelScheduler(
            n_groups, max(1, batch_budget // 4), alpha=alpha, seed=seed,
            backend=backend, device=device)
        self.streams: Dict[int, RequestStream] = {}
        # per-family admitted counts of the most recent schedule_step
        self.last_admitted_by_family: Dict[str, int] = {}
        # pending dirty-group priority injection (see notify_group_update)
        self._dirty_boost: np.ndarray | None = None
        self.metrics: Optional[ServeMetrics] = \
            ServeMetrics() if metrics else None
        self.trace = trace
        self.slo = slo
        self._step_idx = 0

    # batch_budget is mutable between steps (schedule_step recomputes q from
    # it); alpha lives canonically on the scheduler, delegated for the same
    # mutability
    @property
    def alpha(self) -> float:
        return self.scheduler.alpha

    @alpha.setter
    def alpha(self, value: float) -> None:
        self.scheduler.alpha = value

    def add_stream(self, stream: RequestStream):
        self.streams[stream.stream_id] = stream

    def notify_group_update(self, groups, boost: float = 1e6) -> None:
        """Shared-data mutation hook — the serve-layer analogue of the
        graph engine's dirty-block injection (repro_torch.stream): when the data
        behind some request groups changes (a prefix cache invalidated, a
        bucket's snapshot refreshed), those groups' P_mean is boosted on
        the NEXT schedule_step only, so every stream's waiting requests on
        updated groups are admitted first.  Groups with no waiting
        requests are unaffected (the boost multiplies into pairs with
        n_waiting > 0 only); repeated calls between steps accumulate by
        max."""
        vec = np.zeros(self.n_groups, dtype=np.float32)
        for g in groups:
            if not 0 <= int(g) < self.n_groups:
                raise ValueError(f"group {g} out of range")
            vec[int(g)] = boost
        self._dirty_boost = (vec if self._dirty_boost is None
                             else np.maximum(self._dirty_boost, vec))

    def _pairs(self, stream: RequestStream):
        """<Node_un, P_mean> per group for one stream (paper Eq. 1)."""
        n_un = np.zeros(self.n_groups, dtype=np.float32)
        p_sum = np.zeros(self.n_groups, dtype=np.float32)
        for r in stream.waiting:
            n_un[r.group] += 1
            p_sum[r.group] += r.urgency
        p_mean = np.where(n_un > 0, p_sum / np.maximum(n_un, 1), 0.0)
        return n_un, p_mean

    def schedule_step(self) -> List[Request]:
        """Pick request groups via the two-level policy, then admit requests
        from selected groups (all streams share them — CAJS) up to budget."""
        streams = [self.streams[sid] for sid in sorted(self.streams)]
        step = self._step_idx
        if self.metrics is not None or self.slo is not None:
            stamp = (self.metrics or self.slo).on_seen
            for stream in streams:          # stamp first-seen (wait clock)
                for r in stream.waiting:
                    stamp(r, step)
        node_un = np.zeros((len(streams), self.n_groups), dtype=np.float32)
        p_mean = np.zeros((len(streams), self.n_groups), dtype=np.float32)
        for i, stream in enumerate(streams):
            node_un[i], p_mean[i] = self._pairs(stream)
        if self._dirty_boost is not None:   # dirty-group injection, one step
            p_mean = p_mean + self._dirty_boost[None, :] * (node_un > 0)
            self._dirty_boost = None
        _, gq = self.scheduler.select(node_un, p_mean,
                                      q=max(1, self.batch_budget // 4))

        # one pass builds per-(stream, group) FIFO cursors; admission below
        # is O(total waiting), no list.remove scans
        buckets = [dict() for _ in streams]
        for si, stream in enumerate(streams):
            for i, r in enumerate(stream.waiting):
                buckets[si].setdefault(r.group, deque()).append(i)
        taken = [set() for _ in streams]
        admitted: List[Request] = []

        def admit(si: int, i: int) -> bool:
            """Admit waiting[i] unless the budget is already spent; returns
            True once the batch is full (a full batch never admits)."""
            if len(admitted) >= self.batch_budget:
                return True
            req = streams[si].waiting[i]
            admitted.append(req)
            taken[si].add(i)
            if self.metrics is not None:
                self.metrics.on_admit(req, step)
            if self.slo is not None:
                self.slo.on_admit(req, streams[si].family, step)
            return len(admitted) >= self.batch_budget

        full = False
        # round-robin across streams within selected groups (fair sharing)
        for g in gq:
            if full:
                break
            for si in range(len(streams)):
                fifo = buckets[si].get(int(g))
                if not fifo:
                    continue
                full = admit(si, fifo.popleft())
                if full:
                    break
        # fill remaining budget from any group (paper: finished jobs keep
        # computing low-priority blocks instead of idling)
        for si, stream in enumerate(streams):
            if full:
                break
            for i in range(len(stream.waiting)):
                if i in taken[si]:
                    continue
                full = admit(si, i)
                if full:
                    break
        by_family: Dict[str, int] = {}
        for si, stream in enumerate(streams):
            if taken[si]:
                stream.waiting = [r for i, r in enumerate(stream.waiting)
                                  if i not in taken[si]]
                by_family[stream.family] = (by_family.get(stream.family, 0)
                                            + len(taken[si]))
        self.last_admitted_by_family = by_family
        self._step_idx += 1
        if self.metrics is not None or self.slo is not None:
            depth: Dict[str, int] = {}      # queue pressure AFTER admission
            for stream in streams:
                depth[stream.family] = (depth.get(stream.family, 0)
                                        + len(stream.waiting))
            if self.metrics is not None:
                self.metrics.on_step(len(admitted), depth,
                                     self.scheduler.last_occupancy)
            if self.slo is not None:
                self.slo.on_step(step, depth)
        if self.trace is not None:
            self.trace.instant("serve.admit", cat="serve", tid=3,
                               step=step, admitted=len(admitted),
                               by_family=dict(by_family))
        return admitted

    def complete(self, req: Request, service_s: Optional[float] = None
                 ) -> None:
        """Report a request finished decoding; records service time (wall
        seconds since admission, or an explicit duration)."""
        if self.metrics is not None:
            self.metrics.on_complete(req, service_s)
        if self.slo is not None:
            stream = self.streams.get(req.stream_id)
            family = stream.family if stream is not None else "default"
            self.slo.on_complete(req, family, self._step_idx)
