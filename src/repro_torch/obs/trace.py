"""Structured trace events, exported as Chrome/Perfetto trace-event JSON.

A ``TraceRecorder`` collects the discrete story of a session — job
submit/detach, run and superstep spans, the drivers' phases inside them,
apply_updates batches, overlay compactions, serve admissions — as Trace
Event Format records
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU):

  ph="X"  complete span (ts + dur)
  ph="i"  instant event
  ph="C"  counter track (per-superstep telemetry series)
  ph="M"  metadata (process/thread names, emitted at export)

``export(path)`` writes ``{"traceEvents": [...]}`` — loadable in
chrome://tracing and https://ui.perfetto.dev as-is.

The clock is the profiler's: timestamps are microseconds since the Unix
epoch, anchored once at creation by one (``time.time_ns()``,
``time.perf_counter_ns()``) pair and advanced by ``perf_counter``, so the
export lines up with a torch.profiler (Kineto) trace of the same
process.  Durations are perf_counter differences.

``span(name, **args)`` is the one span path.  Enabled, a span records
its name, start, duration, a span id and its parent's id (the innermost
span open on this recorder) in its args, adds its duration to per-name
``totals()``, and, only while a torch.profiler runs, opens a
``record_function`` range named ``rt.<name>``, so a device trace can put
each idle gap down to what the program was doing.  Disabled, it is one
attribute test and a shared object that does nothing: no clock read, no
``record_function``.

The event calls are the reference's (`repro.obs.trace`): the same calls
record the same events, with the span ids added to a span's args.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import torch

__all__ = ["TraceRecorder", "validate_trace_events", "SPAN_PREFIX"]

# phases this recorder emits (export-time schema guarantee)
_PHASES = ("X", "i", "C", "M")

REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")

#: prefix of a span's torch.profiler range
SPAN_PREFIX = "rt."


class _NullSpan:
    """What a disabled recorder's ``span`` returns: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args) -> None:
        """Args known only inside the span (a job id, a count)."""


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span of an enabled recorder; its event is appended when
    it opens, so ``events`` lists spans in the order they started."""

    __slots__ = ("rec", "name", "ev", "t0", "rf")

    def __init__(self, rec: "TraceRecorder", name: str, ev: dict):
        self.rec, self.name, self.ev = rec, name, ev
        self.rf = None

    def __enter__(self):
        rec, args = self.rec, self.ev["args"]
        rec._last_id += 1
        args["span_id"] = rec._last_id
        args["parent_id"] = rec._open[-1] if rec._open else 0
        rec._open.append(rec._last_id)
        rec.events.append(self.ev)
        self.t0 = time.perf_counter_ns()
        self.ev["ts"] = rec._stamp_us(self.t0)
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(
                SPAN_PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        dur = time.perf_counter_ns() - self.t0
        rec = self.rec
        rec._open.pop()
        self.ev["dur"] = dur / 1e3
        tot = rec._totals.get(self.name)
        if tot is None:
            rec._totals[self.name] = [dur / 1e9, 1]
        else:
            tot[0] += dur / 1e9
            tot[1] += 1
        return False

    def note(self, **args) -> None:
        self.ev["args"].update(args)

    @property
    def end_us(self) -> float:
        """The span's end on the recorder's clock (once it has closed)."""
        return self.ev["ts"] + self.ev["dur"]


class TraceRecorder:
    """Append-only trace-event collector on the profiler's clock."""

    def __init__(self, enabled: bool = True, *, pid: int = 1):
        self.enabled = enabled
        self.pid = pid
        self.events: List[dict] = []
        # the anchor: Unix-epoch ns at perf_counter_ns() == _pc0
        self._epoch0 = time.time_ns()  # noqa: RPT004,RPA004 - trace stamps only
        self._pc0 = time.perf_counter_ns()
        self._thread_names: Dict[int, str] = {1: "session"}
        self._totals: Dict[str, list] = {}
        self._open: List[int] = []     # ids of the spans open, innermost last
        self._last_id = 0

    # -- clock ---------------------------------------------------------------

    def _stamp_us(self, pc_ns: int) -> float:
        return (self._epoch0 + (pc_ns - self._pc0)) / 1e3

    def now_us(self) -> float:
        """Microseconds since the Unix epoch (the trace timebase, the
        profiler's clock)."""
        return self._stamp_us(time.perf_counter_ns())

    # -- event emitters ------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        self.events.append(ev)

    def instant(self, name: str, cat: str = "session",
                ts_us: Optional[float] = None, tid: int = 1, **args) -> None:
        """One instant event (ph='i'), e.g. a compaction."""
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

    def span(self, name: str, cat: str = "session", tid: int = 1, **args):
        """A context manager recording one complete span around its body
        (see the module's docstring); ``with rec.span(...) as sp:
        sp.note(k=v)`` adds args known only inside it."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, {"name": name, "cat": cat, "ph": "X",
                                  "ts": 0.0, "dur": 0.0, "pid": self.pid,
                                  "tid": tid, "args": args})

    def totals(self) -> Dict[str, list]:
        """{span name: [total seconds, count]} of the spans closed so far."""
        return {k: list(v) for k, v in self._totals.items()}

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
        """Drop the events and the totals recorded so far."""
        self.events.clear()
        self._totals.clear()


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
