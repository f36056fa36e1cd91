"""Benchmark-record regression gate: ``python -m repro_torch.obs.regress``.

Compares freshly produced ``BENCH_*.json`` records (the benchmark
schema: ``{"mode": ..., "records": [{"name": ..., <metric>: ...}, ...]}``)
against a baseline directory of committed ones, with per-metric
tolerance bands, and exits nonzero when the trajectory regresses, so a
change cannot silently trade away what an earlier one measured in.  The
same gate as the reference's (`repro.obs.regress`): the same metric
classes, bands, direction rules, flags and exit codes, kept here as a
copy of its own (the port imports nothing of the reference).

Metric classes (unlisted metrics are informational and never gated):

  timing    one-sided relative band, default +15% (``--timing-rtol``);
            wall-clock is machine-sensitive, so ``--skip-timing`` drops
            the class entirely (CI compares counters only)
  counter   deterministic under the benchmark seeds — exact by default
            (``rtol=0``), a few carry a small band where float32
            accumulation order can wiggle (halo_bytes)

Direction matters: for most metrics bigger is worse (time, loads,
syncs, supersteps, latency); for completed/throughput smaller is worse.
Only the worse direction fails — getting faster is not a regression.

Exit codes: 0 clean, 1 regression detected, 2 usage/load error.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["TolSpec", "METRIC_SPECS", "compare_rows", "compare_docs",
           "load_bench_dir", "run_gate", "main"]


@dataclasses.dataclass(frozen=True)
class TolSpec:
    """One gated metric: its class, band, and which direction is worse."""

    kind: str                 # "timing" | "counter"
    rtol: float = 0.0         # one-sided relative band
    atol: float = 1e-9        # absolute slack (floats that should be exact)
    worse: str = "higher"     # "higher" | "lower"


METRIC_SPECS: Dict[str, TolSpec] = {
    # timing (machine-sensitive; skippable)
    "us_per_call": TolSpec("timing", rtol=0.15),
    # deterministic counters — exact under the benchmark seeds
    "supersteps": TolSpec("counter"),
    "tile_loads": TolSpec("counter"),
    "tile_pair_loads": TolSpec("counter"),
    "job_block_pushes": TolSpec("counter"),
    "host_syncs": TolSpec("counter"),
    "series_len": TolSpec("counter"),
    "inc_tile_loads": TolSpec("counter"),
    "restart_tile_loads": TolSpec("counter"),
    "inc_supersteps": TolSpec("counter"),
    "restart_supersteps": TolSpec("counter"),
    "pair_tiles": TolSpec("counter"),
    "max_shard_pair_tiles": TolSpec("counter"),
    # float32 accumulation order can wiggle the last bits across BLAS
    "halo_bytes": TolSpec("counter", rtol=0.01),
    # serve-front SLIs (fig_serve): deterministic in ticks
    "arrivals": TolSpec("counter"),
    "admitted": TolSpec("counter", worse="lower"),
    "completed": TolSpec("counter", worse="lower"),
    "p50_latency_ticks": TolSpec("counter", atol=1e-6),
    "p99_latency_ticks": TolSpec("counter", atol=1e-6),
    "throughput_per_tick": TolSpec("counter", atol=1e-6, worse="lower"),
}


@dataclasses.dataclass
class Violation:
    mode: str
    row: str
    metric: str
    baseline: float
    fresh: float
    limit: float
    kind: str

    def __str__(self) -> str:
        if self.kind == "missing":
            # the reference looks "<doc>" / "<row>" up in METRIC_SPECS and
            # raises KeyError under --require-all (ROADMAP C)
            return (f"[{self.mode}/{self.row}] {self.metric}: missing from "
                    f"the fresh records")
        arrow = (">" if METRIC_SPECS[self.metric].worse == "higher"
                 else "<")
        return (f"[{self.mode}/{self.row}] {self.metric}: "
                f"{self.fresh:g} {arrow} allowed {self.limit:g} "
                f"(baseline {self.baseline:g}, {self.kind})")


def _limit(base: float, spec: TolSpec) -> float:
    band = abs(base) * spec.rtol + spec.atol
    return base + band if spec.worse == "higher" else base - band


def compare_rows(mode: str, base_row: dict, fresh_row: dict, *,
                 skip_timing: bool = False,
                 timing_rtol: Optional[float] = None) -> List[Violation]:
    """Gate every spec'd metric present (numerically) in BOTH rows."""
    out: List[Violation] = []
    name = str(base_row.get("name", "?"))
    for metric, spec in METRIC_SPECS.items():
        if spec.kind == "timing":
            if skip_timing:
                continue
            if timing_rtol is not None:
                spec = dataclasses.replace(spec, rtol=timing_rtol)
        b, f = base_row.get(metric), fresh_row.get(metric)
        if not isinstance(b, (int, float)) or isinstance(b, bool):
            continue
        if not isinstance(f, (int, float)) or isinstance(f, bool):
            continue
        limit = _limit(float(b), spec)
        bad = (float(f) > limit if spec.worse == "higher"
               else float(f) < limit)
        if bad:
            out.append(Violation(mode, name, metric, float(b), float(f),
                                 limit, spec.kind))
    return out


def compare_docs(base_doc: dict, fresh_doc: dict, *,
                 skip_timing: bool = False,
                 timing_rtol: Optional[float] = None,
                 require_all: bool = False
                 ) -> Tuple[List[Violation], List[str]]:
    """Match rows by name; returns (violations, warnings)."""
    mode = str(base_doc.get("mode", "?"))
    fresh_rows = {str(r.get("name")): r
                  for r in fresh_doc.get("records", [])}
    violations: List[Violation] = []
    warnings: List[str] = []
    for base_row in base_doc.get("records", []):
        name = str(base_row.get("name"))
        fresh_row = fresh_rows.get(name)
        if fresh_row is None:
            msg = f"[{mode}] row {name!r} missing from fresh records"
            if require_all:
                violations.append(Violation(mode, name, "<row>", 1.0, 0.0,
                                            1.0, "missing"))
            warnings.append(msg)
            continue
        violations.extend(compare_rows(mode, base_row, fresh_row,
                                       skip_timing=skip_timing,
                                       timing_rtol=timing_rtol))
    return violations, warnings


def load_bench_dir(path: str, modes: Optional[List[str]] = None
                   ) -> Dict[str, dict]:
    """All BENCH_<mode>.json docs in `path`, keyed by mode."""
    docs: Dict[str, dict] = {}
    for fn in sorted(glob.glob(os.path.join(path, "BENCH_*.json"))):
        with open(fn) as f:
            doc = json.load(f)
        mode = str(doc.get("mode",
                           os.path.basename(fn)[len("BENCH_"):-len(".json")]))
        if modes and mode not in modes:
            continue
        docs[mode] = doc
    return docs


def run_gate(baseline_dir: str, fresh_dir: str, *,
             modes: Optional[List[str]] = None, skip_timing: bool = False,
             timing_rtol: Optional[float] = None, require_all: bool = False
             ) -> dict:
    """The gate as a callable (the CLI is a thin shell around this)."""
    baseline = load_bench_dir(baseline_dir, modes)
    if not baseline:
        raise FileNotFoundError(
            f"no BENCH_*.json records under {baseline_dir!r}"
            + (f" for modes {modes}" if modes else ""))
    fresh = load_bench_dir(fresh_dir, modes)
    violations: List[Violation] = []
    warnings: List[str] = []
    compared: List[str] = []
    for mode, base_doc in sorted(baseline.items()):
        fresh_doc = fresh.get(mode)
        if fresh_doc is None:
            msg = f"[{mode}] no fresh record in {fresh_dir!r}"
            if require_all:
                violations.append(Violation(mode, "<doc>", "<doc>", 1.0,
                                            0.0, 1.0, "missing"))
            warnings.append(msg)
            continue
        compared.append(mode)
        v, w = compare_docs(base_doc, fresh_doc, skip_timing=skip_timing,
                            timing_rtol=timing_rtol,
                            require_all=require_all)
        violations.extend(v)
        warnings.extend(w)
    return {"compared_modes": compared,
            "violations": violations,
            "warnings": warnings,
            "ok": not violations}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="gate fresh BENCH_*.json records against the "
                    "committed perf trajectory")
    ap.add_argument("--baseline", default=".",
                    help="dir holding the committed BENCH_*.json "
                         "(default: repo root)")
    ap.add_argument("--fresh", default=None,
                    help="dir holding freshly produced records "
                         "(default: --baseline, i.e. a self-gate)")
    ap.add_argument("--modes", default=None,
                    help="comma-separated mode filter "
                         "(e.g. fig_sync,fig_trace)")
    ap.add_argument("--skip-timing", action="store_true",
                    help="gate deterministic counters only")
    ap.add_argument("--timing-rtol", type=float, default=None,
                    help="override the timing band (default 0.15)")
    ap.add_argument("--require-all", action="store_true",
                    help="a baseline mode/row missing from fresh is a "
                         "failure, not a warning")
    ap.add_argument("--json", default=None, metavar="OUT",
                    help="also write the verdict as JSON")
    args = ap.parse_args(argv)

    try:
        result = run_gate(
            args.baseline, args.fresh or args.baseline,
            modes=args.modes.split(",") if args.modes else None,
            skip_timing=args.skip_timing, timing_rtol=args.timing_rtol,
            require_all=args.require_all)
    except (FileNotFoundError, json.JSONDecodeError) as e:
        print(f"regress: error: {e}", file=sys.stderr)
        return 2

    for w in result["warnings"]:
        print(f"regress: warning: {w}")
    print(f"regress: compared modes: "
          f"{', '.join(result['compared_modes']) or '(none)'}")
    for v in result["violations"]:
        print(f"regress: REGRESSION {v}")
    verdict = "OK" if result["ok"] else \
        f"FAIL ({len(result['violations'])} regression(s))"
    print(f"regress: {verdict}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"ok": result["ok"],
                       "compared_modes": result["compared_modes"],
                       "warnings": result["warnings"],
                       "violations": [dataclasses.asdict(v)
                                      for v in result["violations"]]},
                      f, indent=2)
            f.write("\n")
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
