"""Spans around the benchmark's calls into the program, and the reading
of a torch.profiler trace into the plain numbers the per-layer readers
take.

`Spans` times each call on the host clock (totals by name) and, while a
profiler runs (only after the measured window has closed), also marks
it as a `record_function` range named "gb.<name>", so the trace can tell
what the host was doing while the device sat idle.

`summarize` works on plain event lists (name, start us, end us), so a
test can feed it a recorded trace without a card.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

SPAN_PREFIX = "gb."
#: the program's B1/B2 kernel (`fused_superstep.cu`)
B1B2_KERNEL = "superstep_kernel"
TOP = 10


class Spans:
    """Host-clock totals of the benchmark's calls, by name."""

    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.marking = False   # also emit record_function ranges

    def snapshot(self) -> dict:
        """{name: [total seconds, count]} so far."""
        return {k: [self.total[k], self.count[k]] for k in self.total}

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = contextlib.nullcontext()
        if self.marking:
            import torch
            mark = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.total[name] += time.perf_counter() - t0
                self.count[name] += 1


def less(a: dict, b: dict) -> dict:
    """Span totals `a` less the stretch `b` ({name: [seconds, count]})."""
    return {k: [v[0] - b.get(k, [0.0, 0])[0], v[1] - b.get(k, [0.0, 0])[1]]
            for k, v in a.items()}


def profiler_events(prof):
    """(device, spans) from a finished torch.profiler run: device
    operations and the benchmark's spans as (name, start us, end us).
    Read from the raw Kineto events, which skips the profiler's own
    building of its event tree."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    device, spans = [], []
    for e in events:
        name = e.name()
        start, end = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
        if name.startswith(SPAN_PREFIX):
            if e.device_type() == DeviceType.CPU:
                spans.append((name[len(SPAN_PREFIX):], start, end))
        elif e.device_type() == DeviceType.CUDA:
            device.append((name, start, end))
    return device, spans


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(s, e, w0, w1):
    return max(s, w0), min(e, w1)


def span_table(spans):
    """(bounds, names): between bounds[i] and bounds[i + 1] the host was
    in names[i], the latest-starting span holding that stretch, or
    "none"."""
    bounds = sorted({x for _, s, e in spans for x in (s, e)})
    names = []
    for a, b in zip(bounds, bounds[1:]):
        mid, best, name = 0.5 * (a + b), None, "none"
        for n, s, e in spans:
            if s <= mid < e and (best is None or s > best):
                best, name = s, n
        names.append(name)
    return bounds, names


def split_by_span(table, g0: float, g1: float):
    """[(name, seconds)] of the stretch [g0, g1] by the span `span_table`
    puts at each part of it."""
    bounds, names = table
    lo, hi = bisect.bisect_right(bounds, g0), bisect.bisect_left(bounds, g1)
    cuts = [g0] + bounds[lo:hi] + [g1]
    out = []
    for a, b in zip(cuts, cuts[1:]):
        i = bisect.bisect_right(bounds, 0.5 * (a + b)) - 1
        out.append((names[i] if 0 <= i < len(names) else "none", b - a))
    return out


def summarize(device, spans) -> dict:
    """The traced stretch's numbers (seconds): from the first span's
    start to the last span's end, the device's busy time, B1/B2's device
    time, the device time by operation, and the idle time by the
    innermost span the host was in."""
    if not spans:
        return {}
    w0 = min(s for _, s, _ in spans)
    w1 = max(e for _, _, e in spans)
    busy = union(_clip(s, e, w0, w1) for _, s, e in device
                 if min(e, w1) > max(s, w0))
    by_op = defaultdict(float)
    for name, s, e in device:
        cs, ce = _clip(s, e, w0, w1)
        if ce > cs:
            by_op[name] += ce - cs
    idle = defaultdict(float)
    table = span_table(spans)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            for name, dt in split_by_span(table, g0, g1):
                idle[name] += dt
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": sum(e - s for s, e in busy) * us,
        "b1b2_s": sum(v for k, v in by_op.items() if B1B2_KERNEL in k) * us,
        "device_ops": [[k, v * us] for k, v in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_by_span": [[k, v * us] for k, v in
                         sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
        "has_device": bool(device),
    }
