"""Structured trace events, exported as Chrome/Perfetto trace-event JSON.

A ``TraceRecorder`` collects the discrete story of a session — job
submit/detach, run and superstep spans, apply_updates batches, overlay
compactions, serve admissions — as Trace Event Format records
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

  ph="X"  complete span (ts + dur)
  ph="i"  instant event
  ph="C"  counter track (per-superstep telemetry series)
  ph="M"  metadata (process/thread names, emitted at export)

``export(path)`` writes ``{"traceEvents": [...]}`` — loadable in
chrome://tracing and https://ui.perfetto.dev as-is.  Timestamps are
microseconds on a perf_counter clock anchored at recorder creation.

Recording is cheap (an appended dict per event) but still gated on
``enabled`` so telemetry-off sessions pay literally nothing; a disabled
recorder's export writes an empty-but-valid trace.

Copied from the reference (`repro.obs.trace`): the same calls record the
same events.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

__all__ = ["TraceRecorder", "validate_trace_events"]

# phases this recorder emits (export-time schema guarantee)
_PHASES = ("X", "i", "C", "M")

REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


class TraceRecorder:
    """Append-only trace-event collector with a session-local clock."""

    def __init__(self, enabled: bool = True, *, pid: int = 1):
        self.enabled = enabled
        self.pid = pid
        self.events: List[dict] = []
        self._t0 = time.perf_counter()
        self._thread_names: Dict[int, str] = {1: "session"}

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        """Microseconds since recorder creation (the trace timebase)."""
        return (time.perf_counter() - self._t0) * 1e6

    # -- event emitters ------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        self.events.append(ev)

    def instant(self, name: str, cat: str = "session",
                ts_us: Optional[float] = None, tid: int = 1, **args) -> None:
        """One instant event (ph='i'), e.g. a job submit or a compaction."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": self.now_us() if ts_us is None else ts_us,
                    "pid": self.pid, "tid": tid, "args": args})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 cat: str = "session", tid: int = 1, **args) -> None:
        """A finished span (ph='X') with explicit start/duration."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "X", "ts": ts_us,
                    "dur": max(dur_us, 0.0), "pid": self.pid, "tid": tid,
                    "args": args})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "session", tid: int = 1, **args):
        """Context manager emitting one complete span around the body."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, cat=cat, tid=tid,
                          **args)

    def counter(self, name: str, values: Dict[str, float],
                ts_us: Optional[float] = None, cat: str = "telemetry",
                tid: int = 1) -> None:
        """One counter sample (ph='C'); each key renders as a track."""
        if not self.enabled:
            return
        self._emit({"name": name, "cat": cat, "ph": "C",
                    "ts": self.now_us() if ts_us is None else ts_us,
                    "pid": self.pid, "tid": tid,
                    "args": {k: float(v) for k, v in values.items()}})

    def name_thread(self, tid: int, name: str) -> None:
        self._thread_names[tid] = name

    # -- export --------------------------------------------------------------

    def _metadata(self) -> List[dict]:
        meta = [{"name": "process_name", "ph": "M", "ts": 0.0, "pid": self.pid,
                 "tid": 1, "args": {"name": "repro_torch.GraphSession"}}]
        for tid, name in sorted(self._thread_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "ts": 0.0,
                         "pid": self.pid, "tid": tid, "args": {"name": name}})
        return meta

    def to_json(self) -> dict:
        # ts-sorted: chrome://tracing tolerates disorder, Perfetto's JSON
        # importer is stricter about counter tracks
        events = self._metadata() + sorted(self.events,
                                           key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write the Chrome trace-event JSON file; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path

    def clear(self) -> None:
        self.events.clear()


def validate_trace_events(doc: dict) -> int:
    """Schema-check an exported trace document; returns the event count.

    Raises ValueError on the first malformed event — used by tests and the
    fig_trace benchmark to prove the export loads in Chrome/Perfetto.
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must have a traceEvents list")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        for k in REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing key {k!r}: {ev}")
        if ev["ph"] not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ev['ph']!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {i} missing dur: {ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has invalid ts: {ev['ts']!r}")
    return len(events)
