"""SLO tracking and a metrics registry for the serve front.

``ServeMetrics`` (repro_torch.obs.serve) answers "what happened since the
scheduler was born"; an operator needs "are we inside our targets RIGHT
NOW".  This module adds that second view without duplicating the first:

  SlidingWindowLatency  a ``LatencyStats`` whose sample set is the last
                        `window` observations only
  SLOTarget             declared per-family objectives: p50/p99 job
                        latency (in scheduler steps, enqueue->complete),
                        per-request deadlines, minimum throughput, maximum
                        queue depth
  SLOTracker            per-family AND per-tenant sliding-window SLIs,
                        evaluated against the declared targets; attach it
                        via ``ConcurrentServeScheduler(slo=...)`` and it
                        rides the same on_seen/on_admit/on_complete hooks
                        (and the same ``req._seen_step`` stamps) as
                        ServeMetrics
  MetricsRegistry       one snapshot() over every registered source
                        (ServeMetrics, SLOTracker, TelemetrySeries,
                        RunMetrics, plain dicts) to schema-validated JSON
                        or Prometheus text exposition

Latencies are counted in SCHEDULER STEPS, not wall seconds: steps are
deterministic under a fixed seed, so a serve run's SLIs reproduce
bit-for-bit.

Host numpy, copied from the reference (`repro.obs.slo`): the schema tag,
the snapshot and the Prometheus names (prefix ``repro_``) are the
reference's, so one scrape configuration reads either package.
"""

from __future__ import annotations

import dataclasses
import json
import re
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.obs.serve import LatencyStats, percentile_summary

__all__ = ["SlidingWindowLatency", "SLOTarget", "SLOTracker",
           "MetricsRegistry", "validate_registry_snapshot",
           "REGISTRY_SCHEMA"]

REGISTRY_SCHEMA = "repro.obs.registry/v1"

_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_.:-]*$")


class SlidingWindowLatency(LatencyStats):
    """``LatencyStats`` over the most recent `window` samples.

    Extends (not re-implements) the base class: ``summary()`` and the
    ``samples`` list keep their meaning; only retention changes."""

    def __init__(self, window: int = 512):
        super().__init__()
        if window < 1:
            raise ValueError(f"window must be >= 1: {window}")
        self.window = int(window)

    def add(self, value: float) -> None:
        super().add(value)
        if len(self.samples) > self.window:
            del self.samples[: len(self.samples) - self.window]


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Declared objectives for one algorithm family (``"*"`` = catch-all).

    All latencies are in scheduler steps (enqueue -> complete).  ``None``
    disables that clause.  ``min_throughput`` is completions per step over
    the tracker's sliding window; ``deadline_steps`` is a PER-REQUEST
    deadline — each completion past it counts one violation."""

    family: str = "*"
    p50_latency_steps: Optional[float] = None
    p99_latency_steps: Optional[float] = None
    deadline_steps: Optional[float] = None
    min_throughput: Optional[float] = None
    max_queue_depth: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SLOTracker:
    """Sliding-window SLIs per family and per tenant, judged vs targets.

    Wire it with ``ConcurrentServeScheduler(slo=tracker)``; the scheduler
    calls the hooks below alongside its ServeMetrics.  The tracker shares
    the metrics' ``req._seen_step`` stamp (idempotent first-seen), so the
    two views never disagree on when a request entered the system."""

    def __init__(self, targets: Iterable[SLOTarget] = (),
                 window: int = 512):
        self.window = int(window)
        self.targets: Tuple[SLOTarget, ...] = tuple(targets)
        by_fam = {}
        for t in self.targets:
            if t.family in by_fam:
                raise ValueError(f"duplicate SLOTarget family: {t.family}")
            by_fam[t.family] = t
        self._target_by_family: Dict[str, SLOTarget] = by_fam
        self.latency_by_family: Dict[str, SlidingWindowLatency] = {}
        self.latency_by_tenant: Dict[int, SlidingWindowLatency] = {}
        self.wait_by_family: Dict[str, SlidingWindowLatency] = {}
        # (completion step, family) pairs inside the window (throughput SLI)
        self._completions: deque = deque()
        self.queue_depth_by_family: Dict[str, deque] = {}
        self.deadline_violations: Dict[str, int] = {}
        self.completed: int = 0
        self.steps: int = 0

    # -- target resolution ---------------------------------------------------

    def target_for(self, family: str) -> Optional[SLOTarget]:
        """Exact family match first, else the ``"*"`` catch-all."""
        t = self._target_by_family.get(family)
        return t if t is not None else self._target_by_family.get("*")

    # -- recording hooks (called by ConcurrentServeScheduler) ----------------

    def on_seen(self, req, step: int) -> None:
        """Same first-seen stamp as ServeMetrics.on_seen (idempotent)."""
        if getattr(req, "_seen_step", None) is None:
            req._seen_step = step

    def on_admit(self, req, family: str, step: int) -> None:
        seen = getattr(req, "_seen_step", step)
        self.wait_by_family.setdefault(
            family, SlidingWindowLatency(self.window)).add(step - seen)

    def on_complete(self, req, family: str, step: int) -> None:
        seen = getattr(req, "_seen_step", step)
        latency = float(step - seen)
        self.latency_by_family.setdefault(
            family, SlidingWindowLatency(self.window)).add(latency)
        self.latency_by_tenant.setdefault(
            int(req.stream_id), SlidingWindowLatency(self.window)).add(
                latency)
        self._completions.append((int(step), family))
        self.completed += 1
        t = self.target_for(family)
        if t is not None and t.deadline_steps is not None \
                and latency > t.deadline_steps:
            self.deadline_violations[family] = (
                self.deadline_violations.get(family, 0) + 1)

    def on_step(self, step: int, depth_by_family: Dict[str, int]) -> None:
        self.steps = max(self.steps, int(step) + 1)
        for fam, depth in depth_by_family.items():
            dq = self.queue_depth_by_family.setdefault(
                fam, deque(maxlen=self.window))
            dq.append(int(depth))
        floor = int(step) - self.window
        while self._completions and self._completions[0][0] <= floor:
            self._completions.popleft()

    # -- SLIs ----------------------------------------------------------------

    def throughput(self, family: Optional[str] = None) -> float:
        """Completions per step over the sliding window."""
        span = max(1, min(self.steps, self.window))
        n = sum(1 for _, fam in self._completions
                if family is None or fam == family)
        return n / span

    def families(self) -> List[str]:
        return sorted(set(self.latency_by_family)
                      | set(self.wait_by_family)
                      | set(self.queue_depth_by_family))

    def _judge(self, family: str, lat: dict, thr: float,
               depth_max: int) -> Optional[dict]:
        t = self.target_for(family)
        if t is None:
            return None
        verdict = {"target": t.to_dict()}
        ok = True
        if t.p50_latency_steps is not None:
            verdict["p50_ok"] = lat["p50"] <= t.p50_latency_steps
            ok &= verdict["p50_ok"]
        if t.p99_latency_steps is not None:
            verdict["p99_ok"] = lat["p99"] <= t.p99_latency_steps
            ok &= verdict["p99_ok"]
        if t.min_throughput is not None:
            verdict["throughput_ok"] = thr >= t.min_throughput
            ok &= verdict["throughput_ok"]
        if t.max_queue_depth is not None:
            verdict["queue_depth_ok"] = depth_max <= t.max_queue_depth
            ok &= verdict["queue_depth_ok"]
        if t.deadline_steps is not None:
            verdict["deadline_violations"] = \
                self.deadline_violations.get(family, 0)
            ok &= verdict["deadline_violations"] == 0
        verdict["ok"] = bool(ok)
        return verdict

    def report(self) -> dict:
        """JSON-ready sliding-window SLI report + per-target verdicts."""
        fams = {}
        for fam in self.families():
            lat = self.latency_by_family.get(fam)
            lat_s = (lat.summary() if lat is not None
                     else percentile_summary([]))
            wait = self.wait_by_family.get(fam)
            depths = self.queue_depth_by_family.get(fam)
            thr = self.throughput(fam)
            depth_max = int(max(depths)) if depths else 0
            entry = {
                "latency_steps": lat_s,
                "wait_steps": (wait.summary() if wait is not None
                               else percentile_summary([])),
                "throughput_per_step": round(thr, 6),
                "queue_depth": {
                    "mean": (round(float(np.mean(depths)), 6)
                             if depths else 0.0),
                    "max": depth_max},
                "deadline_violations":
                    self.deadline_violations.get(fam, 0),
            }
            verdict = self._judge(fam, lat_s, thr, depth_max)
            if verdict is not None:
                entry["slo"] = verdict
            fams[fam] = entry
        return {
            "window": self.window,
            "steps": self.steps,
            "completed": self.completed,
            "throughput_per_step": round(self.throughput(), 6),
            "deadline_violations_total":
                sum(self.deadline_violations.values()),
            "families": fams,
            "tenants": {
                str(sid): st.summary()
                for sid, st in sorted(self.latency_by_tenant.items())},
        }


# ---------------------------------------------------------------------------
# the registry: one snapshot over every metrics source
# ---------------------------------------------------------------------------


def _resolve(source):
    """A source is a callable, a dict, or an object with report()/
    summary()/to_dict() — in that precedence order."""
    if callable(source) and not hasattr(source, "report") \
            and not hasattr(source, "summary") \
            and not hasattr(source, "to_dict"):
        return source()
    if isinstance(source, dict):
        return source
    for meth in ("report", "summary", "to_dict"):
        fn = getattr(source, meth, None)
        if callable(fn):
            return fn()
    if callable(source):
        return source()
    raise TypeError(
        f"unsupported registry source: {type(source).__name__} "
        "(want a dict, a callable, or report()/summary()/to_dict())")


def _check_payload(name: str, value, path: str) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(k, str):
                raise ValueError(
                    f"source {name!r}: non-string key at {path}: {k!r}")
            _check_payload(name, v, f"{path}.{k}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_payload(name, v, f"{path}[{i}]")
    elif isinstance(value, bool) or value is None \
            or isinstance(value, (int, str)):
        return
    elif isinstance(value, float):
        if not np.isfinite(value):
            raise ValueError(
                f"source {name!r}: non-finite float at {path}: {value}")
    else:
        raise ValueError(
            f"source {name!r}: non-JSON value at {path}: "
            f"{type(value).__name__}")


def validate_registry_snapshot(doc) -> int:
    """Schema check for a MetricsRegistry snapshot; raises ValueError on
    the first offence, returns the number of sources when valid."""
    if not isinstance(doc, dict):
        raise ValueError(f"snapshot must be a dict, got "
                         f"{type(doc).__name__}")
    if doc.get("schema") != REGISTRY_SCHEMA:
        raise ValueError(f"bad schema tag: {doc.get('schema')!r} "
                         f"(want {REGISTRY_SCHEMA!r})")
    sources = doc.get("sources")
    if not isinstance(sources, dict):
        raise ValueError("snapshot['sources'] must be a dict")
    for name, payload in sources.items():
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise ValueError(f"bad source name: {name!r}")
        if not isinstance(payload, dict):
            raise ValueError(
                f"source {name!r}: payload must be a dict, got "
                f"{type(payload).__name__}")
        _check_payload(name, payload, "$")
    return len(sources)


def _prom_name(*parts: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", "_".join(parts)).strip("_")


def _prom_lines(name: str, value, out: List[tuple]) -> None:
    """Flatten numeric leaves to (metric_name, float) pairs; lists (the
    telemetry series columns) are summarized as _sum/_last, not exploded
    into thousands of exposition lines."""
    if isinstance(value, bool):
        out.append((name, 1.0 if value else 0.0))
    elif isinstance(value, (int, float)):
        if np.isfinite(value):
            out.append((name, float(value)))
    elif isinstance(value, dict):
        for k, v in value.items():
            _prom_lines(_prom_name(name, str(k)), v, out)
    elif isinstance(value, (list, tuple)):
        nums = [float(v) for v in value
                if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if nums and len(nums) == len(value):
            out.append((_prom_name(name, "sum"), float(sum(nums))))
            out.append((_prom_name(name, "last"), nums[-1]))
    # strings / None carry no numeric signal: skipped


class MetricsRegistry:
    """Named metrics sources -> one schema-tagged snapshot.

    register() accepts anything _resolve understands: ``ServeMetrics``
    (summary), ``SLOTracker`` (report), ``TelemetrySeries`` / ``RunMetrics``
    (to_dict), plain dicts, or zero-arg callables re-evaluated per
    snapshot (register a live ``lambda: sess.run_metrics.to_dict()`` and
    every snapshot sees current values)."""

    def __init__(self):
        self._sources: Dict[str, object] = {}

    def register(self, name: str, source) -> None:
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"bad source name: {name!r}")
        if name in self._sources:
            raise ValueError(f"source already registered: {name!r}")
        self._sources[name] = source

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)

    def names(self) -> List[str]:
        return sorted(self._sources)

    def snapshot(self) -> dict:
        doc = {"schema": REGISTRY_SCHEMA,
               "sources": {name: _resolve(self._sources[name])
                           for name in self.names()}}
        validate_registry_snapshot(doc)
        return doc

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def export(self, path) -> dict:
        """Write the JSON snapshot to `path`; returns the snapshot."""
        doc = self.snapshot()
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        return doc

    def to_prometheus(self) -> str:
        """Prometheus text exposition (gauges; numeric leaves only)."""
        doc = self.snapshot()
        lines: List[str] = []
        for name, payload in doc["sources"].items():
            flat: List[tuple] = []
            _prom_lines(_prom_name("repro", name), payload, flat)
            for metric, value in flat:
                lines.append(f"# TYPE {metric} gauge")
                val = (f"{value:.6g}" if value != int(value)
                       else str(int(value)))
                lines.append(f"{metric} {val}")
        return "\n".join(lines) + "\n"
