"""Serve-layer latency instrumentation.

``ConcurrentServeScheduler`` owns a ``ServeMetrics``: every
``schedule_step`` records per-stream wait time (enqueue -> admission, in
wall seconds AND scheduler steps — the step count is deterministic, so
tests can pin it), per-family queue depth after admission, admitted batch
sizes and global-queue occupancy.  ``complete(request)`` closes the loop
with service time (admission -> completion).  ``summary()`` surfaces
p50/p99 percentiles — the job-latency distribution an SLO-aware admission
policy needs as its input signal.

Host numpy, copied from the reference (`repro.obs.serve`): the same
calls record the same samples and summaries.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["LatencyStats", "ServeMetrics", "percentile_summary"]


def percentile_summary(samples: List[float]) -> dict:
    """{count, mean, p50, p99, max} of a sample list (empty -> zeros)."""
    if not samples:
        return {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(samples, dtype=np.float64)
    return {"count": int(a.size), "mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


@dataclasses.dataclass
class LatencyStats:
    """An appendable latency sample set with percentile summaries."""

    samples: List[float] = dataclasses.field(default_factory=list)

    def add(self, value: float) -> None:
        self.samples.append(float(value))

    def summary(self) -> dict:
        return percentile_summary(self.samples)


class ServeMetrics:
    """What the serve scheduler observed; one instance per scheduler."""

    def __init__(self):
        self.wait_steps = LatencyStats()      # enqueue -> admit, in steps
        self.wait_s = LatencyStats()          # enqueue -> admit, wall time
        self.service_s = LatencyStats()       # admit -> complete, wall time
        self.wait_steps_by_stream: Dict[int, LatencyStats] = {}
        self.queue_depth_by_family: Dict[str, List[int]] = {}
        self.admitted_per_step: List[int] = []
        self.gq_occupancy: List[int] = []
        self.steps = 0

    # -- recording hooks (called by ConcurrentServeScheduler) ----------------

    def on_seen(self, req, step: int) -> None:
        """First schedule_step that saw this waiting request."""
        if getattr(req, "_seen_step", None) is None:
            req._seen_step = step
            req._enqueue_ts = getattr(req, "_enqueue_ts",
                                      time.perf_counter())

    def on_admit(self, req, step: int) -> None:
        seen = getattr(req, "_seen_step", step)
        self.wait_steps.add(step - seen)
        self.wait_steps_by_stream.setdefault(
            req.stream_id, LatencyStats()).add(step - seen)
        now = time.perf_counter()
        self.wait_s.add(now - getattr(req, "_enqueue_ts", now))
        req._admit_ts = now

    def on_complete(self, req, service_s: Optional[float] = None) -> None:
        if service_s is None:
            service_s = time.perf_counter() - getattr(
                req, "_admit_ts", time.perf_counter())
        self.service_s.add(service_s)

    def on_step(self, admitted: int, depth_by_family: Dict[str, int],
                gq_occupancy: int) -> None:
        self.steps += 1
        self.admitted_per_step.append(int(admitted))
        self.gq_occupancy.append(int(gq_occupancy))
        for fam, depth in depth_by_family.items():
            self.queue_depth_by_family.setdefault(fam, []).append(int(depth))

    # -- reporting -----------------------------------------------------------

    def summary(self) -> dict:
        """p50/p99 wait & service latency + queue pressure, JSON-ready."""
        return {
            "steps": self.steps,
            "wait_steps": self.wait_steps.summary(),
            "wait_s": self.wait_s.summary(),
            "service_s": self.service_s.summary(),
            "wait_steps_by_stream": {
                str(sid): st.summary()
                for sid, st in sorted(self.wait_steps_by_stream.items())},
            "queue_depth_by_family": {
                fam: {"mean": float(np.mean(d)) if d else 0.0,
                      "max": int(max(d)) if d else 0}
                for fam, d in sorted(self.queue_depth_by_family.items())},
            "admitted": percentile_summary(
                [float(x) for x in self.admitted_per_step]),
            "gq_occupancy": percentile_summary(
                [float(x) for x in self.gq_occupancy]),
        }
