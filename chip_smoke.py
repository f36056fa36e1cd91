#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Device and settings: the card's name and power limit, TF32 off, and
   the CUDA kernels built from the sources in this checkout; B1/B2's
   ptxas registers and spills at Vb=64 and their thread blocks per SM.
2. Each kernel against its plain PyTorch version on the card, on the
   slice's real block pairs (rmat_graph(2**16, 8), Vb=64) with
   numpy-seeded random state and every source live: J=4 (the main
   path's job axis), a prime J, and a width-contract case (d at B_N,
   outputs at B_loc < B_N).  Bars: plus-times rtol = atol = 1e-5 with
   node_un exact; min-plus values, deltas and node_un bit-equal, p_sum
   rtol 1e-6.  Each kernel and its plain version are timed (`Timer`:
   device time per launch by CUDA events around a run of back-to-back
   launches queued behind a spin, and host time per call by the host
   clock around a run of calls) beside the all-pairs bound.
3. The main path at full size: GraphSession(rmat_graph(2**16, 8), 64,
   capacity=4) on CUDA with PageRank, PPR(3), SSSP(0), SSSP(4097) — two
   graph views — run under TwoLevel() to convergence with the launch
   counts set to 0 just before and read just after, keeping each
   push's selection mask.  SSSP is held bit-equal to scipy's Dijkstra,
   PageRank/PPR to a float64 power iteration at rtol 5e-3, atol 1e-4.
2b. B1/B2 on the main path's own selections: the masks of an early, a
   middle and a late push of phase 3, d masked by them, against the
   plain version at phase 2's bars, a repeat call bit-identical, timed
   beside the bound of the live pairs alone.
4. The device scheduling backend at full size, on the same session: the
   four jobs resubmitted and run under Fused() (both scheduling levels
   and the push on the card, one host read per chunk), checked as in
   phase 3 with the launch counts set to 0 just before and read just
   after; then resubmitted under TwoLevel(backend="device",
   steps_per_sync=8), which must give the same supersteps, tile_loads and
   tile_pair_loads (chunk invariance); then a cadence sweep, K = 4, 8,
   16 (INF_CHUNK), 32 and back, each run held to the same schedule and
   results (ms per superstep, host_syncs and B1/B2 launches against K;
   the two passes show the drift of the host's speed within the run);
   then one chunk of the step function under
   torch.cuda.set_sync_debug_mode("error").  Then telemetry
   (TelemetryConfig() on the same session, its own step-function entry):
   Fused() and TwoLevel() rerun from the same start as their
   telemetry-off runs must give the same supersteps, tile_loads,
   tile_pair_loads, job_block_pushes and host_syncs and bit-identical
   values and deltas, with series that sum to the totals; ms per
   superstep on and off; two telemetry chunks, the second under
   set_sync_debug_mode("error"), rows written in place; telemetry's
   cost as medians over 20 interleaved off/on pairs of a Fused chunk's
   host enqueue and of an 8-superstep TwoLevel() run, beside the torch
   ops a Fused superstep dispatches.  The scheduler's stream is put back,
   so phases 5-6 run as they would without telemetry.
5. B3 and B4 at their entry points on the full-size views: mj_spmm
   (both semirings, J=4 and a prime J=7, q=400 distinct rows of the
   view's ELL tiles) against its plain version, timed beside
   torch.matmul for plus-times; push_shared on both views (the jobs'
   fresh state, the host TwoLevel's first global queue with padded
   slots) against the port's ELL push; priority_pairs on each view's
   vertex priorities at submit and after 20 host supersteps ([4, 1024,
   64], L2-resident) against core.priority.block_pairs, then at the
   byte-bound size [16, 16384, 64] (64 MB, more than the L2), beside the
   scalar variant on the same inputs and the launch floor (an empty
   kernel timed the same way).  B3's and B4's
   launch counts are read around their entry-point runs (push_shared,
   priority_pairs).
6. Evolving graphs at full size, on the same session: the four jobs
   converge, then take the reference's own update generator,
   mutation_stream(csr, 4, inserts_per_batch=512, deletes_per_batch=256,
   seed=1) (768 updates a batch, about 0.15% of the edges), each batch
   applied with `apply_updates` and the jobs rerun to convergence
   (Fused() after batches 1 and 3, TwoLevel() after 2 and 4); then a
   hand-built batch of inserts on block pairs that own no tile slot (the
   overlay and the kernel route's ride-along, under Fused(), with live
   overlay entries asserted) and a batch with more new pairs in one
   block row than its overlay holds (compaction, under TwoLevel()); then
   an explicit `compact()`.  Each rerun is held to phase 3's bars on the
   updated graph, the session's CSR to a plain application of the
   batches, and after compaction every view's tiles, neighbour ids and
   mask and its rebuilt BlockPairs to a fresh build on the card.  Per
   batch it prints the apply_updates seconds, the StreamStats, the live
   overlay entries, the pair-view rebuild seconds and the rerun's wall,
   supersteps, tile_loads, tile_pair_loads and host_syncs; then the
   phase's peak device memory.  B1/B2 launches over the reruns are the
   `stream` entry of `launches_by_path`.
7. The serve front at full size, with the first session freed: the
   open-loop harness (obs.loadgen: seeded Poisson arrivals with a burst
   envelope, 64 tenants on the default family mix pagerank/ppr/sssp/bfs,
   a mutation_stream batch of 8 inserts and 4 deletes every 80 ticks
   forwarded to notify_group_update) admits requests through a
   ConcurrentServeScheduler over 1024 request groups (one per block)
   into GraphSession(rmat_graph(2**16, 8), 64, capacity=8,
   telemetry=True), at most 8 running, 8 supersteps a tick; once under
   TwoLevel() and once under TwoLevel(backend="device",
   steps_per_sync=8), each on a fresh session whose three views are
   built before the first tick.  Every SSSP/BFS result is held bit-equal
   to scipy's Dijkstra/BFS on the CSR it finished on, the first three
   PageRank/PPR results to phase 3's bars; every request admitted and
   completed, at most 8 running and 8 at the peak (the load of 0.4
   requests a tick, as in examples/serve_slo.py, fills the slots: the
   admission headroom reaches 0), the series' tile_loads summing to the
   harness's, the exported trace (build/chip_smoke/serve_trace_*.json) valid
   with serve.admit instants, the MetricsRegistry snapshot valid.  It
   prints arrivals, ticks, supersteps, throughput, p50/p99 latency in
   ticks (overall and by family), wall, ms per tick and per superstep,
   B1/B2 launches (the `serve` entry of `launches_by_path`) and the
   peak device memory.

Then one JSON line of kernel figures, the card's name and power limit,
and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --trace

adds traced reruns of the same four jobs under torch.profiler after the
checks, one on each backend (the per-layer breakdown: device time by
kernel, the device's busy share); the untraced runs above give the
end-to-end numbers.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_VERTICES = 2**16
AVG_DEGREE = 8
BLOCK = 64
CAPACITY = 4
MAX_SUPERSTEPS = 5000
PPR_SOURCE = 3
SSSP_SOURCES = (0, 4097)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/fused_superstep/csrc/fused_superstep.cu"
REPLACES = {"plus_times": "src/repro/kernels/fused_superstep/kernel.py:46",
            "min_plus": "src/repro/kernels/fused_superstep/kernel.py:75"}
B3_SOURCE = "src/repro_torch/kernels/mj_spmm/csrc/mj_spmm.cu"
B3_REPLACES = {"plus_times": "src/repro/kernels/mj_spmm/kernel.py:29",
               "min_plus": "src/repro/kernels/mj_spmm/kernel.py:35"}
B4_SOURCE = ("src/repro_torch/kernels/priority_pairs/csrc/"
             "priority_pairs.cu")
B4_REPLACES = "src/repro/kernels/priority_pairs/kernel.py:19"
SEMIRINGS = ("plus_times", "min_plus")
Q_B3 = 400                     # selected rows of the mj_spmm entry point
DEVICE_CADENCE = 8             # steps_per_sync of the chunk-invariance run
CADENCE_SWEEP = (4, 8, 16, 32)  # run in this order, then in reverse
PADDED_SLOTS = 3               # padded slots in push_shared's queue
SELECTION_POINTS = (("early", 0.1), ("middle", 0.5), ("late", 0.9))
B4_BIG = (16, 16384, 64)       # 16 jobs over 2**20 vertices: 64 MB > L2
# phase 6: the reference's own update generator, 0.15% of the edges a batch
STREAM_BATCHES, STREAM_INSERTS, STREAM_DELETES, STREAM_SEED = 4, 512, 256, 1
STREAM_DELETE = 1              # UpdateBatch.op of a delete
# phase 7: the serve front, one request group per block, the load
# generator's default family mix
SERVE_CAPACITY = 8             # the session's job slots per view
SERVE_MAX_RUNNING = 8          # admitted jobs sharing the supersteps
SERVE_STEPS_PER_TICK = 8
SERVE_LOAD = dict(seed=33, ticks=240, base_rate=0.4, burst_amplitude=0.6,
                  burst_period=60, n_tenants=64, update_every=80)
SERVE_PT_CHECKED = 3           # PageRank/PPR results held per run
TELEMETRY_PAIRS = 20           # interleaved off/on timings of telemetry
HOST_TIMED_STEPS = 8           # supersteps per timed TwoLevel() run
# back-to-back calls per timed run, so that a run lasts about 1 ms or more
R_B1B2, R_B3, R_B4, R_B4_BIG = 20, 10, 200, 50
R_PLAIN, R_B4_PLAIN, R_B4_BIG_PLAIN = 2, 20, 10
TIMING = ("ms: device time per launch, CUDA events around a run of "
          "back-to-back launches queued behind a spin, median of 5 runs; "
          "host_ms_per_call: host clock around a run of calls, no sync")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Time per call of a function on the card.

    Host time: the host clock around `launches` back-to-back calls with no
    synchronise inside, over the count (what a caller pays before it can
    go on).  Device time: a pair of CUDA events around `launches`
    back-to-back calls, over the count.  A spin kernel
    (`torch.cuda._sleep`) is queued first and outlasts the host's enqueue
    of the whole run, so the device runs the launches back to back and
    never waits for the host: the events read device time even where the
    host's wrapper takes longer than the kernel.  `queued` says whether
    every run was still behind the spin when its last call was enqueued
    (False for a function that waits on the device itself).  Each value
    is the median over `runs` runs, after `warmup` calls (with the range of
    the host runs, since the host's clock varies more than the card's);
    each call's outputs are released within the run."""

    def __init__(self, torch):
        self.torch = torch
        cycles = 10**7
        self._sleep(cycles)                  # warm the spin kernel
        a, b = self._events()
        a.record()
        self._sleep(cycles)
        b.record()
        b.synchronize()
        self.cycles_per_ms = cycles / a.elapsed_time(b)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def _sleep(self, cycles):
        self.torch.cuda._sleep(int(cycles))

    def __call__(self, fn, launches: int, runs: int = 5,
                 warmup: int = 2) -> dict:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(runs):
            t0 = time.perf_counter()
            for _ in range(launches):
                fn()
            host.append(1e3 * (time.perf_counter() - t0) / launches)
            torch.cuda.synchronize()
        host_ms = statistics.median(host)
        dev, queued = [], True
        for _ in range(runs):
            a, b = self._events()
            self._sleep(self.cycles_per_ms * (2 * host_ms * launches + 1))
            a.record()
            for _ in range(launches):
                fn()
            b.record()
            queued &= not a.query()
            b.synchronize()
            dev.append(a.elapsed_time(b) / launches)
        return dict(ms=statistics.median(dev), host_ms=host_ms,
                    host_ms_range=[min(host), max(host)],
                    launches_per_run=launches, queued=queued)


def fmt(t: dict) -> str:
    """A Timer reading as text."""
    return (f"{t['ms']:.5f} ms device ({t['launches_per_run']} back to "
            f"back{'' if t['queued'] else ', NOT queued behind the spin'})"
            f", {t['host_ms']:.5f} ms host per call (runs "
            f"{t['host_ms_range'][0]:.5f}-{t['host_ms_range'][1]:.5f})")


def random_state(torch, rng, j, bn_src, bn_loc, vb, semiring, device):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    if semiring == "plus_times":
        # non-negative, as the main path's PageRank/PPR deltas are (signed
        # inputs over runs of ~1000 pairs cancel, and a fixed atol then
        # measures the cancellation, not the kernel)
        return (t(rng.random((j, bn_src, vb))),
                t(rng.random((j, bn_loc, vb))), None)
    d = (rng.random((j, bn_src, vb)) * 10).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    vals = (rng.random((j, bn_loc, vb)) * 10).astype(np.float32)
    base = np.where(rng.random(vals.shape) < 0.5, vals, np.inf)
    return t(d), t(base), t(vals)


def compare(semiring, got, want, rows) -> float:
    """Raise unless the kernel's outputs meet the bar; max |error|."""
    got = [x.cpu().numpy()[:, rows] for x in got]
    want = [x.cpu().numpy()[:, rows] for x in want]
    if semiring == "plus_times":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    else:
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    err = 0.0
    for a, b in zip(got, want):
        fin = np.isfinite(a) & np.isfinite(b)
        if fin.any():
            err = max(err, float(np.abs(a[fin] - b[fin]).max()))
    return err


def bound(semiring, j, bn_src, bn_loc, vb, p, runs):
    """Least time for one call with every source live: bytes each
    read/written once over HBM rate vs flops over the float32 rate, over
    all P tiles."""
    states_in = 1 if semiring == "plus_times" else 2       # base (+values)
    states_out = 1 if semiring == "plus_times" else 2      # out (+values)
    nbytes = (4 * p * vb * vb                              # tiles
              + 4 * (2 * p + runs + 1)                     # src, dst, runs
              + 4 * j * bn_src * vb                        # d
              + 4 * j * bn_loc * vb * (states_in + states_out)
              + 4 * 2 * j * bn_loc)                        # node_un, p_sum
    flops = 2.0 * j * p * vb * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def live_bound(semiring, j, bn_loc, vb, src_np, live_np, runs, chunks):
    """Least time for one call on a selection: the tiles of the live pairs
    (source selected) and the d rows of their distinct sources, src for
    all P, the run and chunk tables, the [B_N] mask and the state, each
    read or written once, over the HBM rate vs 2*J*Vb^2 flops per live
    pair over the float32 rate.  Returns (ms, by, live pairs)."""
    on = live_np[src_np]
    n_live = int(on.sum())
    n_src = int(np.unique(src_np[on]).size)
    states = 2 if semiring == "plus_times" else 4   # base, out (+values, dout)
    nbytes = (4 * n_live * vb * vb + 4 * j * n_src * vb
              + 4 * (len(src_np) + runs + 1 + 2 * chunks + 1)
              + live_np.size
              + 4 * j * bn_loc * vb * states + 4 * 2 * j * bn_loc)
    flops = 2.0 * j * n_live * vb * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", n_live)


def masked_state(torch, rng, j, bn, vb, semiring, live, device):
    """random_state with the rows of d outside `live` set to the semiring
    identity (what fused_push hands the kernel)."""
    d, base, vals = random_state(torch, rng, j, bn, bn, vb, semiring, device)
    ident = 0.0 if semiring == "plus_times" else float("inf")
    return torch.where(live[None, :, None], d, ident), base, vals


def record_selections(fops):
    """Wrap fused_superstep_call in kernels.fused_superstep.ops so each
    push's `src_live` mask is kept per semiring (a reference only: no
    device work, no sync).  Returns (masks, restore)."""
    real = fops.fused_superstep_call
    masks = {"plus_times": [], "min_plus": []}

    def spy(*a, **kw):
        masks[kw["semiring"]].append(kw["src_live"])
        return real(*a, **kw)
    fops.fused_superstep_call = spy

    def restore():
        fops.fused_superstep_call = real
    return masks, restore


def check_selections(torch, timer, sess, groups, device, masks):
    """Phase 2b: B1/B2 on the main path's own selections (the src_live
    masks of an early, a middle and a late push of the phase-3 run), d
    masked by them, against the plain version; timed beside the plain
    version and the live-pair bound.  Returns {semiring: [selection
    figures]}."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

    figures = {}
    for semiring, grp in groups.items():
        bp = sess._pair_data(grp)
        bn, vb = grp.graph.num_blocks, grp.graph.block_size
        jb = _pick_job_block(CAPACITY, vb, semiring)
        rows = bp.dst_touched.cpu().numpy()
        src_np = bp.src.cpu().numpy()
        rec = masks[semiring]
        rng = np.random.default_rng(17)
        inputs = [("all live", None,
                   random_state(torch, rng, CAPACITY, bn, bn, vb, semiring,
                                device))]
        for label, frac in SELECTION_POINTS:
            k = min(len(rec) - 1, int(frac * len(rec)))
            live = rec[k]
            inputs.append((f"{label} (push {k} of {len(rec)})", live,
                           masked_state(torch, rng, CAPACITY, bn, vb,
                                        semiring, live, device)))
        figures[semiring] = []
        for label, live, (d, base, vals) in inputs:
            def kern():
                return fk.fused_superstep_call(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, run_start=bp.run_start,
                    chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                    arrivals=bp.arrivals(CAPACITY // jb), src_live=live,
                    semiring=semiring, job_block=jb)

            def plain():
                return fused_superstep_ref(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, src_live=live, semiring=semiring)
            want = plain()
            got = kern()
            got2 = kern()
            torch.cuda.synchronize()
            err = compare(semiring, got, want, rows)
            for a, b in zip(got, got2):
                if not torch.equal(a[:, bp.dst_touched],
                                   b[:, bp.dst_touched]):
                    raise AssertionError(f"{semiring} {label}: two calls "
                                         f"on the same inputs differ")
            if live is None:
                continue
            live_np = live.cpu().numpy()
            k = timer(kern, R_B1B2)
            p = timer(plain, R_PLAIN)
            b_ms, b_by, n_live = live_bound(
                semiring, CAPACITY, bn, vb, src_np, live_np, bp.num_runs,
                bp.chunk_run.numel())
            log(f"  {semiring} main-path selection {label}: "
                f"{int(live_np.sum())} of {bn} sources live, {n_live} of "
                f"{bp.num_pairs} pairs; matches plain (max |err| {err:.3g}),"
                f" repeat call bit-identical; kernel {fmt(k)}; plain "
                f"{fmt(p)}; live-pair bound {b_ms:.4f} ms ({b_by}); "
                f"{100 * b_ms / k['ms']:.1f}% of the bound")
            figures[semiring].append(dict(
                selection=label, live_sources=int(live_np.sum()),
                live_pairs=n_live, ms=k["ms"],
                host_ms_per_call=k["host_ms"],
                host_ms_range=k["host_ms_range"], queued=k["queued"],
                plain_ms=p["ms"], bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err))
        del inputs
        torch.cuda.empty_cache()
    return figures


def ptxas_report(common, fk):
    """The fused superstep kernels' ptxas lines at Vb=64 (registers,
    spills), their shared memory and thread blocks per SM at J=4."""
    name = None
    info = {}
    for line in common.build_log("fused_superstep").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            info.setdefault(name, []).append(line.strip())
    for sr, tag in (("plus_times", "ILi64ELb0E"), ("min_plus", "ILi64ELb1E")):
        for fn, lines in info.items():
            if tag in fn:
                log(f"  ptxas {sr} Vb=64: {' | '.join(lines)}")
        log(f"  {sr} Vb=64 jb=4: {fk.smem_bytes(4, 64)} B shared memory, "
            f"{fk.blocks_per_sm(4, 64, sr)} thread blocks per SM")


def check_kernels(torch, timer, sess, groups, device):
    """Phase 2: kernels vs plain versions on the real pairs."""
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep.ops import _pick_job_block
    from repro_torch.kernels.fused_superstep.ref import fused_superstep_ref

    figures = {}
    for semiring, grp in groups.items():
        bp = sess._pair_data(grp)
        bn, vb = grp.graph.num_blocks, grp.graph.block_size
        rows_all = bp.dst_touched.cpu().numpy()
        rng = np.random.default_rng(11)
        cases = [(CAPACITY, bn, None), (7, bn, None), (7, bn, 1),
                 (CAPACITY, bn // 2, None)]
        errs = []
        for j, bn_loc, jb in cases:
            d, base, vals = random_state(torch, rng, j, bn, bn_loc, vb,
                                         semiring, device)
            jb = jb or _pick_job_block(j, vb, semiring)

            def kern():
                return fk.fused_superstep_call(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, run_start=bp.run_start,
                    chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                    arrivals=bp.arrivals(j // jb), semiring=semiring,
                    job_block=jb)

            def plain():
                return fused_superstep_ref(
                    bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                    values=vals, semiring=semiring)

            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = compare(semiring, got, want, rows_all[:bn_loc])
            errs.append(err)
            log(f"  {semiring}: J={j} jb={jb} B_loc={bn_loc} P={bp.num_pairs}"
                f" matches plain (max |err| {err:.3g})")
            if (j, bn_loc, jb) == (CAPACITY, bn,
                                   _pick_job_block(j, vb, semiring)):
                k = timer(kern, R_B1B2)
                p = timer(plain, R_PLAIN)
                b_ms, b_by = bound(semiring, j, bn, bn_loc, vb,
                                   bp.num_pairs, bp.num_runs)
                log(f"  {semiring}: kernel {fmt(k)}; plain {fmt(p)}; bound "
                    f"{b_ms:.4f} ms ({b_by}); {k['ms'] / b_ms:.2f}x the "
                    f"bound")
                figures[semiring] = dict(
                    ms=k["ms"], host_ms_per_call=k["host_ms"],
                    queued=k["queued"], plain_ms=p["ms"], bound_ms=b_ms,
                    bound_by=b_by)
        figures[semiring]["max_abs_err"] = max(errs)
        del d, base, vals, got, want
        torch.cuda.empty_cache()
    return figures


def pagerank_ref(csr, damping, source=None, tol=1e-13, max_iter=2000):
    """float64 power iteration of x = (1-d) s + d P^T x (s = 1 for
    PageRank, the unit vector at `source` for PPR), independent of the
    code under test."""
    import scipy.sparse as sp
    n = csr.n
    deg = np.diff(csr.indptr).astype(np.float64)
    src = np.repeat(np.arange(n), np.diff(csr.indptr))
    w = csr.weights.astype(np.float64) / deg[src]
    pt = sp.csr_matrix((w, (csr.indices, src)), shape=(n, n))
    s = np.ones(n) if source is None else np.eye(1, n, source).ravel()
    x = (1 - damping) * s
    for _ in range(max_iter):
        nxt = (1 - damping) * s + damping * (pt @ x)
        if np.abs(nxt - x).sum() < tol * max(1.0, np.abs(x).sum()):
            return nxt
        x = nxt
    return x


def timed_policy(base):
    """`base` (a SchedulePolicy class) with its host select timed: the
    scheduling layer's time (DO queues + global queue), per superstep."""
    class Timed(base):
        select_s = 0.0

        def select(self, sess, node_un, p_mean, active):
            t0 = time.perf_counter()
            try:
                return super().select(sess, node_un, p_mean, active)
            finally:
                self.select_s += time.perf_counter() - t0

    return Timed()


def resubmit(torch, sess, handles):
    """Detach the jobs and submit them again (fresh state, same slots):
    the next run starts over from the initial state."""
    algs = [h.alg for h in handles]
    for h in handles:
        sess.detach(h)
    out = [sess.submit(a) for a in algs]
    torch.cuda.synchronize()
    return out


def traced_rerun(torch, sess, handles, policy):
    """Resubmit the jobs and rerun them under torch.profiler: device time
    by kernel and the device's busy share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = sess.run(policy, MAX_SUPERSTEPS)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    log(f"traced rerun ({policy.name}, backend={policy.backend}): "
        f"supersteps={m.supersteps} wall {wall:.3f} s, device "
        f"busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
        f"of wall (idle {100 - 100 * busy_us / 1e6 / wall:.1f}%)")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")
    return handles


def sssp_ref(csr, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    a = sp.csr_matrix((csr.weights.astype(np.float64), csr.indices,
                       csr.indptr), shape=(csr.n, csr.n))
    return dijkstra(a, directed=True, indices=list(sources))


def check_results(sess, handles, csr, refs, label):
    """Phase 3's checks of a run's results: SSSP bit-equal to scipy's
    Dijkstra, PageRank/PPR within rtol 5e-3, atol 1e-4 of the float64
    power iteration."""
    res = [sess.result(h) for h in handles]
    for r in res:
        if r.shape != (csr.n,) or r.dtype != np.float32:
            raise RuntimeError(f"result shape/dtype {r.shape} {r.dtype}")
    for r, h, want in zip(res, handles, refs):
        if h.alg.semiring == "min_plus":
            np.testing.assert_array_equal(r, want)
            log(f"{label}: SSSP(source={h.alg.source}) bit-equal to scipy "
                f"dijkstra ({int(np.isfinite(want).sum())} reachable)")
        else:
            if not np.isfinite(r).all():
                raise RuntimeError(f"{h.alg.name}: non-finite result")
            np.testing.assert_allclose(r, want, rtol=5e-3, atol=1e-4)
            log(f"{label}: {h.alg.name} within rtol 5e-3, atol 1e-4 of the "
                f"float64 power iteration (max |err| "
                f"{np.abs(r - want).max():.3g})")


def drive(torch, sess, policy, fk):
    """Run `policy` to convergence with the fused kernels' launch counts
    set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    m = sess.run(policy, MAX_SUPERSTEPS)       # ends in a device sync
    wall = time.perf_counter() - t0
    return m, wall, dict(fk.launches), torch.cuda.max_memory_allocated()


def report_run(torch, label, m, wall, launches, peak):
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"{label}: converged={m.converged} supersteps={m.supersteps} "
        f"tile_loads={m.tile_loads} tile_pair_loads={m.tile_pair_loads} "
        f"job_block_pushes={m.job_block_pushes} host_syncs={m.host_syncs}")
    log(f"{label}: wall {wall:.3f} s, "
        f"{1e3 * wall / max(1, m.supersteps):.3f} ms/superstep; "
        f"launches {launches}; peak device memory {peak / 1e9:.2f} GB "
        f"({100.0 * peak / total:.1f}% of {total / 1e9:.1f} GB)")
    if not m.converged:
        raise RuntimeError(f"{label}: no convergence in {MAX_SUPERSTEPS} "
                           f"supersteps")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched")


def device_backend(torch, sess, handles, csr, refs, fk, host):
    """Phase 4: Fused() and TwoLevel(device, K) at full size, then one
    chunk under the sync-debug mode.  Returns (handles, Fused's launch
    counts, (Fused's RunMetrics, wall, final state))."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.core.policy import INF_CHUNK, device_inputs

    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    m, wall, launches, peak = drive(torch, sess, Fused(), fk)
    report_run(torch, "device backend (Fused)", m, wall, launches, peak)
    fused = (m, wall, snapshot(sess))
    check_results(sess, handles, csr, refs, "device backend")
    hm, hwall, _ = host
    log(f"host vs device backend: supersteps {hm.supersteps} vs "
        f"{m.supersteps}, tile_loads {hm.tile_loads} vs {m.tile_loads}, "
        f"host_syncs {hm.host_syncs} vs {m.host_syncs}, wall {hwall:.3f} vs "
        f"{wall:.3f} s, ms/superstep "
        f"{1e3 * hwall / max(1, hm.supersteps):.3f} vs "
        f"{1e3 * wall / max(1, m.supersteps):.3f}")

    handles = resubmit(torch, sess, handles)
    sess.scheduler.reset()
    pol_k = TwoLevel(backend="device", steps_per_sync=DEVICE_CADENCE)
    mk_, wall_k, launches_k, peak_k = drive(torch, sess, pol_k, fk)
    report_run(torch, f"device backend (steps_per_sync={DEVICE_CADENCE})",
               mk_, wall_k, launches_k, peak_k)
    for f in ("supersteps", "tile_loads", "tile_pair_loads"):
        if getattr(mk_, f) != getattr(m, f):
            raise RuntimeError(f"chunk invariance: {f} {getattr(mk_, f)} "
                               f"at steps_per_sync={DEVICE_CADENCE} != "
                               f"{getattr(m, f)} under Fused()")
    log(f"chunk invariance: supersteps, tile_loads and tile_pair_loads "
        f"identical for Fused() and steps_per_sync={DEVICE_CADENCE}")
    check_results(sess, handles, csr, refs, "device backend, K=8")

    # the cadence against what it costs: host reads, gated launches, time;
    # each K runs once on the way up and once on the way down
    sweep = {k: [] for k in CADENCE_SWEEP}
    for k in CADENCE_SWEEP + CADENCE_SWEEP[::-1]:
        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m_s, wall_s, launches_s, _ = drive(
            torch, sess, TwoLevel(backend="device", steps_per_sync=k), fk)
        for f in ("supersteps", "tile_loads", "tile_pair_loads"):
            if getattr(m_s, f) != getattr(m, f):
                raise RuntimeError(f"chunk invariance: {f} at "
                                   f"steps_per_sync={k} differs")
        check_results(sess, handles, csr, refs, f"device backend, K={k}")
        sweep[k].append((m_s, wall_s, launches_s))
    for k, runs in sweep.items():
        m_s, _, launches_s = runs[0]
        ms = [f"{1e3 * w / m_s.supersteps:.6f}" for _, w, _ in runs]
        log(f"cadence K={k}{' (INF_CHUNK)' if k == INF_CHUNK else ''}: "
            f"host_syncs {m_s.host_syncs}, launches {launches_s} for "
            f"{m_s.supersteps} supersteps, ms/superstep up, down: "
            f"{', '.join(ms)}")

    handles = resubmit(torch, sess, handles)
    step_fn = sess._device_step_fn(pol_k)
    state, *args = device_inputs(sess)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it_h, un_h = torch.stack([state[0], un.to(torch.int64)]).tolist()
    if it_h != step_fn.chunk:
        raise RuntimeError(f"sync-debug chunk ran {it_h} supersteps")
    log(f"one chunk ({step_fn.chunk} supersteps) ran under "
        f"set_sync_debug_mode('error'): no implicit sync; "
        f"{un_h} vertices unconverged after it")
    # is a chunk bound by the host's enqueue or by the device?
    t0 = time.perf_counter()
    state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
    t_enq = time.perf_counter() - t0
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    log(f"next chunk: host enqueue {1e3 * t_enq / step_fn.chunk:.3f} ms "
        f"per superstep, enqueue + drain {1e3 * t_all / step_fn.chunk:.3f} "
        f"ms per superstep")
    return handles, launches, fused


def snapshot(sess):
    """Copies of every view group's values and deltas."""
    return [(g.values.clone(), g.deltas.clone()) for g in sess.view_groups()]


def check_series(m, label):
    """A run's telemetry series against its totals."""
    tel = m.telemetry
    if tel is None or len(tel) != m.supersteps or tel.truncated:
        raise RuntimeError(f"{label}: series of {len(tel or ())} rows for "
                           f"{m.supersteps} supersteps")
    for f in ("tile_loads", "job_block_pushes", "tile_pair_loads"):
        if int(getattr(tel, f).sum()) != getattr(m, f):
            raise RuntimeError(f"{label}: the series' {f} sums to "
                               f"{int(getattr(tel, f).sum())}, the run "
                               f"counted {getattr(m, f)}")


class OpCount:
    """Counts the torch operations dispatched inside a `with` block."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(mode, func, types, args=(), kwargs=None):
                self.n += 1
                return func(*args, **(kwargs or {}))
        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def telemetry_on_off(torch, sess, handles, csr, refs, fk, host, fused):
    """Phase 4, telemetry: the same session with TelemetryConfig() (its
    step-function cache gets a telemetry entry beside the one without),
    Fused() and then TwoLevel() from the same start as the telemetry-off
    runs of phases 3 and 4.  Same schedule, host reads and bit-identical
    state; the series sums equal the totals; one chunk with the series
    under set_sync_debug_mode("error"); the cost per superstep.  The
    scheduler's stream leaves as it came, so the later phases run as
    they would without this one.  Returns the handles."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.core.policy import device_inputs
    from repro_torch.obs import TelemetryConfig

    stream = (copy.deepcopy(sess.scheduler.rng), sess.scheduler._step)

    def same(label, m, wall, off):
        m_off, wall_off, state_off = off
        for f in ("supersteps", "tile_loads", "tile_pair_loads",
                  "job_block_pushes", "host_syncs"):
            if getattr(m, f) != getattr(m_off, f):
                raise RuntimeError(f"{label}: telemetry on gives {f} "
                                   f"{getattr(m, f)}, off "
                                   f"{getattr(m_off, f)}")
        for g, (v, d) in zip(sess.view_groups(), state_off):
            if not (torch.equal(g.values, v) and torch.equal(g.deltas, d)):
                raise RuntimeError(f"{label}: {g.semiring} state with "
                                   f"telemetry differs from without")
        check_series(m, label)
        tel = m.telemetry
        log(f"{label}: telemetry on = off in supersteps, tile_loads, "
            f"tile_pair_loads, job_block_pushes, host_syncs "
            f"({m.host_syncs}) and bit for bit in every view's values and "
            f"deltas; series of {len(tel)} rows sums to the totals "
            f"(max_residual first/last "
            f"{tel.max_residual[0].tolist()} / "
            f"{tel.max_residual[-1].tolist()}); ms/superstep off "
            f"{1e3 * wall_off / max(1, m_off.supersteps):.3f}, on "
            f"{1e3 * wall / max(1, m.supersteps):.3f}")

    sess.telemetry = TelemetryConfig()
    try:
        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m, wall, launches, peak = drive(torch, sess, Fused(), fk)
        report_run(torch, "device backend (Fused), telemetry on", m, wall,
                   launches, peak)
        same("Fused", m, wall, fused)
        check_results(sess, handles, csr, refs, "device backend, telemetry")

        handles = resubmit(torch, sess, handles)
        step_fn = sess._device_step_fn(Fused())
        state, *args = device_inputs(sess)
        ptr = state[8].data_ptr()
        state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, un = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        rows = state[8][:, 1].cpu().numpy()                 # tile_loads
        it_h = int(state[0].item())
        if (state[8].data_ptr() != ptr
                or not (rows[:it_h] > 0).all() or rows[it_h:].any()):
            raise RuntimeError("telemetry chunk: rows or buffers wrong")
        log(f"two chunks ({it_h} supersteps) with telemetry, the second "
            f"under set_sync_debug_mode('error'): no implicit sync; "
            f"{it_h} rows written in place")

        handles = resubmit(torch, sess, handles)
        sess.scheduler.reset()
        m, wall, launches, peak = drive(torch, sess, TwoLevel(), fk)
        report_run(torch, "main path (TwoLevel), telemetry on", m, wall,
                   launches, peak)
        same("TwoLevel", m, wall, host)
        check_results(sess, handles, csr, refs, "main path, telemetry")

        # the cost per superstep, off and on interleaved: the host enqueue
        # of one Fused chunk (the chunk's ops do not depend on the data,
        # and a sync before each call keeps the device from holding the
        # host back), and a TwoLevel() run of HOST_TIMED_STEPS supersteps
        # from the jobs' initial state; medians over TELEMETRY_PAIRS each
        cfg = sess.telemetry
        chunks = {}
        for on in (False, True):
            sess.telemetry = cfg if on else None
            handles = resubmit(torch, sess, handles)
            step_fn = sess._device_step_fn(Fused())
            state, *args = device_inputs(sess)
            chunks[on] = [step_fn, state, args]
        enq_ms, host_ms = {False: [], True: []}, {False: [], True: []}
        for i in range(TELEMETRY_PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                step_fn, state, args = chunks[on]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = step_fn(state, *args, MAX_SUPERSTEPS, sess.seed,
                                   0)
                enq_ms[on].append(1e3 * (time.perf_counter() - t0)
                                  / step_fn.chunk)
                chunks[on][1] = state
        torch.cuda.synchronize()
        del chunks, state, args
        for i in range(TELEMETRY_PAIRS):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                sess.telemetry = cfg if on else None
                handles = resubmit(torch, sess, handles)
                sess.scheduler.reset()
                t0 = time.perf_counter()
                m = sess.run(TwoLevel(), HOST_TIMED_STEPS)  # ends in a sync
                host_ms[on].append(1e3 * (time.perf_counter() - t0)
                                   / m.supersteps)
        # and what a Fused chunk dispatches: torch ops per superstep
        ops = {}
        for on in (False, True):
            sess.telemetry = cfg if on else None
            handles = resubmit(torch, sess, handles)
            step_fn = sess._device_step_fn(Fused())
            state, *args = device_inputs(sess)
            with OpCount() as count:
                step_fn(state, *args, MAX_SUPERSTEPS, sess.seed, 0)
            ops[on] = count.n / step_fn.chunk
            del state, args
        torch.cuda.synchronize()
        log(f"torch ops dispatched per Fused superstep: telemetry off "
            f"{ops[False]:.2f}, on {ops[True]:.2f}")
        for name, ms in (("Fused chunk, host enqueue", enq_ms),
                         (f"TwoLevel, {HOST_TIMED_STEPS}-superstep run",
                          host_ms)):
            q = {on: statistics.quantiles(ms[on], n=4) for on in ms}
            # within a pair the two timings are adjacent, so the host's
            # drift across the loop cancels in their difference
            diff = [b - a for a, b in zip(ms[False], ms[True])]
            log(f"telemetry cost, {name}: ms/superstep over "
                f"{TELEMETRY_PAIRS} interleaved off/on pairs, median (lower"
                f" quartile, upper quartile): off {q[False][1]:.4f} "
                f"({q[False][0]:.4f}, {q[False][2]:.4f}), on "
                f"{q[True][1]:.4f} ({q[True][0]:.4f}, {q[True][2]:.4f}); "
                f"on - off {q[True][1] - q[False][1]:+.4f} ms; within a "
                f"pair on - off median {statistics.median(diff):+.4f} ms, "
                f"on slower in {sum(d > 0 for d in diff)} of "
                f"{len(diff)} pairs")
    finally:
        sess.telemetry = None
        sess.scheduler.rng, sess.scheduler._step = stream
    return handles


def max_err(got, want) -> float:
    a, b = got.cpu().numpy(), want.cpu().numpy()
    fin = np.isfinite(a) & np.isfinite(b)
    if not np.array_equal(np.isfinite(a), np.isfinite(b)):
        raise AssertionError("kernel and plain version differ in which "
                             "entries are infinite")
    return float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0


def b3_bound(q, k, j, vb):
    """Least time of one mj_spmm call: each selected tile, d row and
    output read/written once over the HBM rate vs 2 operations per
    (row, slot, job, v, w) over the float32 rate."""
    nbytes = 4 * (q * k * vb * vb + q * j * vb + q * k * j * vb)
    ops = 2.0 * q * k * j * vb * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def b3_state(torch, rng, q, j, vb, semiring, device):
    d = rng.random((q, j, vb)).astype(np.float32)
    if semiring == "min_plus":
        d = d * 10
        d[rng.random(d.shape) < 0.5] = np.inf
    return torch.as_tensor(d, device=device)


def check_mj_spmm(torch, timer, groups, device):
    """Phase 5a: mj_spmm kernel against its plain version on q=400
    distinct rows of each view's real ELL tiles; timed beside the plain
    version and (plus-times) one torch.matmul."""
    from repro_torch.kernels.mj_spmm import mj_spmm
    from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref

    figures = {}
    rng = np.random.default_rng(23)
    for semiring, grp in groups.items():
        tiles = grp.graph.tiles
        bn, k, vb = tiles.shape[0], tiles.shape[1], tiles.shape[2]
        rows = rng.choice(bn, Q_B3, replace=False).astype(np.int32)
        idx = torch.as_tensor(rows, device=device)
        tiles_sel = tiles[idx.long()]                  # [q, K, Vb, Vb]
        errs = []
        for j in (CAPACITY, 7):
            d = b3_state(torch, rng, Q_B3, j, vb, semiring, device)
            got = mj_spmm(d, tiles_sel, semiring)
            got_i = mj_spmm(d, tiles, semiring, tile_index=idx)
            torch.cuda.synchronize()
            want = mj_spmm_ref(d, tiles_sel, semiring)
            if semiring == "min_plus":
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            else:
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-5,
                                           atol=1e-5)
            if not torch.equal(got, got_i):
                raise AssertionError("tile_index read differs from the "
                                     "gathered read")
            errs.append(max_err(got, want))
            log(f"  mj_spmm {semiring}: q={Q_B3} K={k} J={j} Vb={vb} "
                f"matches plain (max |err| {errs[-1]:.3g}); tile_index "
                f"read bit-equal to the gathered read")
            if j != CAPACITY:
                continue
            del got, got_i, want
            kt = timer(lambda: mj_spmm(d, tiles_sel, semiring), R_B3)
            ki = timer(lambda: mj_spmm(d, tiles, semiring, tile_index=idx),
                       R_B3)
            p = timer(lambda: mj_spmm_ref(d, tiles_sel, semiring), R_PLAIN)
            lib = None
            if semiring == "plus_times":
                lib = timer(lambda: torch.matmul(d[:, None], tiles_sel),
                            R_B3)
            b_ms, b_by = b3_bound(Q_B3, k, j, vb)
            log(f"  mj_spmm {semiring}: kernel {fmt(kt)}; with tile_index "
                f"{fmt(ki)}; plain {fmt(p)}; library "
                f"{'none' if lib is None else fmt(lib)}; bound "
                f"{b_ms:.4f} ms ({b_by}); {kt['ms'] / b_ms:.2f}x the bound")
            figures[semiring] = dict(
                ms=kt["ms"], host_ms_per_call=kt["host_ms"],
                queued=kt["queued"], indexed_ms=ki["ms"], plain_ms=p["ms"],
                library_ms=None if lib is None else lib["ms"],
                bound_ms=b_ms, bound_by=b_by)
        figures[semiring]["max_abs_err"] = max(errs)
        del tiles_sel, d
        torch.cuda.empty_cache()
    return figures


def check_push_shared(torch, timer, sess, groups, device):
    """Phase 5b: push_shared (the kernel-backed engine push through
    mj_spmm with tile_index) on both views, launch counts around it;
    then held against the port's ELL push."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.policy import _read_pairs
    from repro_torch.core.push import compute_pairs, shared_push_fn
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import push_shared

    nus, pms, acts = [], [], []
    for g in sess.view_groups():
        nu, pm = _read_pairs(*compute_pairs(g.alg, g.values, g.deltas))
        nus.append(nu)
        pms.append(pm)
        acts.append(nu.sum(-1) > 0)
    selection = TwoLevel().select(sess, nus, pms, acts)
    sel = np.asarray(selection.sel, np.int32).copy()
    msk = np.asarray(selection.msk, np.float32).copy()
    n = int((msk > 0).sum())
    sel[n - PADDED_SLOTS:n] = 0          # padded slots alias block 0
    msk[n - PADDED_SLOTS:n] = 0.0
    sel_t = torch.as_tensor(sel, device=device)
    msk_t = torch.as_tensor(msk, device=device)
    log(f"  push_shared: the host TwoLevel's first global queue, "
        f"{n - PADDED_SLOTS} blocks + {len(sel) - n + PADDED_SLOTS} padded "
        f"slots (q={len(sel)})")

    def kern(grp):
        return push_shared(grp.values, grp.deltas, grp.graph.tiles,
                           grp.graph.nbr_ids, sel_t, msk_t, grp.push_scale,
                           semiring=grp.semiring)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launches()
    outs = {sr: kern(grp) for sr, grp in groups.items()}
    torch.cuda.synchronize()
    launches = dict(mk.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  push_shared on both views: mj_spmm launches {launches}; peak "
        f"device memory {peak / 1e9:.2f} GB")
    for sr, n_l in launches.items():
        if n_l <= 0:
            raise RuntimeError(f"mj_spmm {sr} was not launched by "
                               f"push_shared")
    for sr, grp in groups.items():
        ell = shared_push_fn(sr, grp.push_one, use_pallas=False)
        want = ell(grp.values, grp.deltas, grp.graph.tiles,
                   grp.graph.nbr_ids, sel_t, msk_t, grp.push_scale,
                   grp.overlay, None)
        (v_k, d_k), (v_e, d_e) = outs[sr], want
        if sr == "min_plus":
            np.testing.assert_array_equal(v_k.cpu().numpy(),
                                          v_e.cpu().numpy())
            np.testing.assert_array_equal(d_k.cpu().numpy(),
                                          d_e.cpu().numpy())
        else:
            np.testing.assert_allclose(v_k.cpu().numpy(), v_e.cpu().numpy(),
                                       rtol=1e-6)
            np.testing.assert_allclose(d_k.cpu().numpy(), d_e.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
        err = max(max_err(v_k, v_e), max_err(d_k, d_e))
        del want, v_e, d_e
        k = timer(lambda: kern(grp), R_B3)
        e = timer(lambda: ell(
            grp.values, grp.deltas, grp.graph.tiles, grp.graph.nbr_ids,
            sel_t, msk_t, grp.push_scale, grp.overlay, None), 1, runs=3,
            warmup=0)
        log(f"  push_shared {sr}: matches the ELL push (max |err| "
            f"{err:.3g}); {fmt(k)} (ELL push {fmt(e)})")
    del outs
    torch.cuda.empty_cache()
    return launches


def b4_bound(j, bn, vb):
    nbytes = 4 * (j * bn * vb + 2 * j * bn)
    ops = 2.0 * j * bn * vb
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def check_priority_pairs(torch, timer, sess, groups):
    """Phase 5c: priority_pairs on each view's vertex priorities at
    submit and after 20 host supersteps (launch counts around those
    calls), then against core.priority.block_pairs, and timed; then at
    the byte-bound size B4_BIG, numpy-seeded with half the entries <= 0,
    against block_pairs and timed; the scalar variant (`lanes=0`) on the
    same inputs at both sizes, held and timed beside the vector one; and
    the library's empty kernel, the launch floor."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.priority import block_pairs
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.kernels.priority_pairs import priority_pairs

    torch.cuda.synchronize()
    pk.reset_launches()
    outs = []
    for stage in ("at submit", "after 20 host supersteps"):
        if stage != "at submit":
            sess.run(TwoLevel(), 20)
        for sr, grp in groups.items():
            vp = grp.alg.vertex_priority(grp.values, grp.deltas)
            outs.append((stage, sr, vp, priority_pairs(vp)))
    torch.cuda.synchronize()
    launches = pk.launches["priority_pairs"]
    if launches <= 0:
        raise RuntimeError("priority_pairs was not launched")

    def held(vp, nu, pm):
        nu_p, pm_p = block_pairs(vp)
        np.testing.assert_array_equal(nu.cpu().numpy(), nu_p.cpu().numpy())
        np.testing.assert_allclose(pm.cpu().numpy(), pm_p.cpu().numpy(),
                                   rtol=1e-6)
        return max(max_err(nu, nu_p), max_err(pm, pm_p))

    def variant(vp):
        lanes = pk.pick_variant(vp.shape[-1], vp.data_ptr())
        return f"vector, {lanes} lanes per row" if lanes else "scalar"

    errs = []
    for stage, sr, vp, (nu, pm) in outs:
        errs.append(held(vp, nu, pm))
        log(f"  priority_pairs {sr} {stage}: {tuple(vp.shape)} "
            f"({variant(vp)}), node_un exact, p_mean within rtol 1e-6 "
            f"(max |err| {errs[-1]:.3g}; {int(nu.sum().item())} "
            f"unconverged vertices)")
    vp = outs[-2][2]
    floor = timer(lambda: pk.launch_empty(vp.device), R_B4)
    log(f"  launch floor (the priority_pairs library's empty kernel): "
        f"{fmt(floor)}")
    k = timer(lambda: priority_pairs(vp), R_B4)
    p = timer(lambda: block_pairs(vp), R_B4_PLAIN)
    sc_err = held(vp, *pk.priority_pairs_call(vp, lanes=0))
    sc = timer(lambda: pk.priority_pairs_call(vp, lanes=0), R_B4)
    b_ms, b_by = b4_bound(*vp.shape)
    log(f"  priority_pairs {tuple(vp.shape)}: kernel {fmt(k)}; scalar "
        f"variant (a warp per row) on the same input "
        f"{fmt(sc)} (max |err| {sc_err:.3g}); plain {fmt(p)}; bound "
        f"{b_ms:.6f} ms ({b_by}); {k['ms'] / floor['ms']:.2f}x the launch "
        f"floor; launches on its path {launches}")

    rng = np.random.default_rng(29)
    big = torch.as_tensor(rng.standard_normal(B4_BIG, dtype=np.float32),
                          device=vp.device)        # half the entries <= 0
    nu, pm = priority_pairs(big)
    torch.cuda.synchronize()
    big_err = held(big, nu, pm)
    del nu, pm
    kb = timer(lambda: priority_pairs(big), R_B4_BIG)
    pb = timer(lambda: block_pairs(big), R_B4_BIG_PLAIN)
    scb_err = held(big, *pk.priority_pairs_call(big, lanes=0))
    scb = timer(lambda: pk.priority_pairs_call(big, lanes=0), R_B4_BIG)
    bb_ms, bb_by = b4_bound(*B4_BIG)
    log(f"  priority_pairs {B4_BIG} ({variant(big)}; "
        f"{big.numel() * 4 / 2**20:.0f} MiB): node_un exact, p_mean within "
        f"rtol 1e-6 (max |err| {big_err:.3g}); kernel {fmt(kb)}; scalar "
        f"variant {fmt(scb)} (max |err| {scb_err:.3g}); plain {fmt(pb)}; "
        f"bound {bb_ms:.6f} ms ({bb_by}); {100 * bb_ms / kb['ms']:.1f}% of "
        f"the bound (scalar {100 * bb_ms / scb['ms']:.1f}%)")
    del big
    torch.cuda.empty_cache()
    return dict(ms=k["ms"], device_ms=k["ms"], host_ms_per_call=k["host_ms"],
                host_ms_range=k["host_ms_range"],
                queued=k["queued"], launch_floor_ms=floor["ms"],
                launch_floor_host_ms=floor["host_ms"], plain_ms=p["ms"],
                scalar_variant_device_ms=sc["ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=list(vp.shape),
                max_abs_err=max(errs + [big_err, sc_err, scb_err]),
                launches=launches,
                byte_bound_size=dict(
                    shape=list(B4_BIG), device_ms=kb["ms"],
                    host_ms_per_call=kb["host_ms"],
                    host_ms_range=kb["host_ms_range"], queued=kb["queued"],
                    scalar_variant_device_ms=scb["ms"],
                    plain_ms=pb["ms"], bound_ms=bb_ms, bound_by=bb_by,
                    max_abs_err=max(big_err, scb_err)))


# -- phase 6: evolving graphs ------------------------------------------------


def plain_adjacency(csr):
    """The graph as a scipy CSR matrix: the plain side of phase 6."""
    import scipy.sparse as sp
    return sp.csr_matrix((csr.weights.astype(np.float32), csr.indices,
                          csr.indptr), shape=(csr.n, csr.n))


def plain_update(adj, batch):
    """`adj` after `batch`, independent of the port's apply_to_csr: ops in
    order, an insert sets the weight (in-batch duplicate inserts keep the
    smaller), a delete removes the edge."""
    import scipy.sparse as sp
    coo = adj.tocoo()
    edges = dict(zip(zip(coo.row.tolist(), coo.col.tolist()),
                     coo.data.tolist()))
    fresh = set()
    for u, v, w, op in zip(batch.src.tolist(), batch.dst.tolist(),
                           batch.w.tolist(), batch.op.tolist()):
        if op == STREAM_DELETE:
            edges.pop((u, v), None)
            fresh.discard((u, v))
        elif (u, v) in fresh:
            edges[(u, v)] = min(edges[(u, v)], w)
        else:
            edges[(u, v)] = w
            fresh.add((u, v))
    keys = np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    w = np.array([edges[k] for k in map(tuple, keys.tolist())], np.float32)
    out = sp.csr_matrix((w, (keys[:, 0], keys[:, 1])), shape=adj.shape)
    out.sort_indices()
    return out


def plain_csr(adj):
    """The (n, indptr, indices, weights) view the references read."""
    import types
    return types.SimpleNamespace(n=adj.shape[0], indptr=adj.indptr,
                                 indices=adj.indices, weights=adj.data)


def references(csr, handles):
    """Each job's plain answer on `csr`: Dijkstra for SSSP, the float64
    power iteration for PageRank/PPR."""
    sources = [h.alg.source for h in handles if h.alg.semiring == "min_plus"]
    dist = iter(sssp_ref(csr, sources).astype(np.float32))
    return [next(dist) if h.alg.semiring == "min_plus"
            else pagerank_ref(csr, h.alg.damping, getattr(h.alg, "source",
                                                          None))
            for h in handles]


def new_pairs(sess, grp, rows, per_row, reach):
    """Inserts (u, v) on block pairs that own no tile slot in `grp`: for
    each source block of `rows`, `per_row` edges from its first vertex
    `reach` marks (finite SSSP distance) to distinct destination blocks
    outside its ELL row, none an existing edge."""
    ids = grp.graph.nbr_ids.cpu().numpy()
    msk = grp.graph.nbr_mask.cpu().numpy()
    n, bn = sess._csr.n, grp.graph.num_blocks
    src, dst = [], []
    for b in rows:
        lanes = [u for u in range(b * BLOCK, min(n, (b + 1) * BLOCK))
                 if reach[u]]
        if not lanes:
            raise RuntimeError(f"block {b} has no reachable vertex")
        u = lanes[0]
        taken = set(ids[b][msk[b]].tolist())
        free = [db for db in range(bn) if db not in taken]
        picked = 0
        for db in free:
            v = db * BLOCK + (u % BLOCK)
            if v < n and v != u and sess._csr.edge_weight(u, v) is None:
                src.append(u)
                dst.append(v)
                picked += 1
                if picked == per_row:
                    break
        if picked < per_row:
            raise RuntimeError(f"block {b}: {picked} of {per_row} pairs")
    return src, dst


def stream_phase(torch, sess, handles, csr, fk):
    """Phase 6: the evolving-graph path at full size on the session of
    phases 3-5.  The jobs converge on the generated graph, then take
    `mutation_stream` batches (Fused after batches 1 and 3, TwoLevel
    after 2 and 4), a hand-built batch of inserts on block pairs without
    a tile slot (the overlay and the kernel route's ride-along, under
    Fused) and a batch that overflows one block row's overlay (compaction,
    under TwoLevel); then an explicit compact().  Each rerun is held to
    the phase 3 bars on the updated graph, and the session's CSR to a
    plain application of the batches; after compaction each view's tiles
    and pair view to a fresh build.  Returns the B1/B2 launch counts of
    the reruns."""
    from repro_torch.core import Fused, TwoLevel
    from repro_torch.graph import (build_block_pairs, build_blocked,
                                   mutation_stream)
    from repro_torch.stream import UpdateBatch

    groups = sess.view_groups()
    handles = resubmit(torch, sess, handles)
    m0 = sess.run(TwoLevel(), MAX_SUPERSTEPS)
    if not m0.converged:
        raise RuntimeError("phase 6: no convergence before the stream")
    adj = plain_adjacency(csr)
    t0 = time.perf_counter()
    batches = mutation_stream(csr, STREAM_BATCHES,
                              inserts_per_batch=STREAM_INSERTS,
                              deletes_per_batch=STREAM_DELETES,
                              seed=STREAM_SEED)
    log(f"stream: mutation_stream({STREAM_BATCHES} batches of "
        f"{STREAM_INSERTS} inserts + {STREAM_DELETES} deletes, seed "
        f"{STREAM_SEED}) generated in {time.perf_counter() - t0:.2f} s")
    totals = {sr: 0 for sr in SEMIRINGS}
    peak = [0]
    total_mem = torch.cuda.get_device_properties(0).total_memory

    def peak_of(fn):
        """fn()'s result and the device memory peak while it ran, in GB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        got = torch.cuda.max_memory_allocated()
        peak[0] = max(peak[0], got)
        return out, got / 1e9

    def step(label, batch, policy):
        nonlocal adj
        t0 = time.perf_counter()
        st, apply_gb = peak_of(lambda: sess.apply_updates(batch))
        apply_s = time.perf_counter() - t0
        adj = plain_update(adj, batch)
        for f, want in (("indptr", adj.indptr), ("indices", adj.indices),
                        ("weights", adj.data)):
            if not np.array_equal(getattr(sess._csr, f), want):
                raise RuntimeError(f"{label}: the session's CSR {f} differs "
                                   f"from the plain application")
        live = sum(int(g.overlay.mask.sum()) for g in groups)
        t0 = time.perf_counter()
        for g in groups:
            sess._pair_data(g)
        torch.cuda.synchronize()
        pairs_s = time.perf_counter() - t0
        m, wall, launches, run_peak = drive(torch, sess, policy, fk)
        peak[0] = max(peak[0], run_peak)
        for sr in totals:
            totals[sr] += launches[sr]
        log(f"{label} ({policy.name}, backend={policy.backend}): "
            f"apply_updates {apply_s:.3f} s; updates {st.updates_applied}, "
            f"dirty_blocks {st.dirty_blocks}, reseed_fraction "
            f"{st.reseed_fraction:.6f}, compacted_views "
            f"{st.compacted_views}; overlay entries live {live}, pair view "
            f"rebuilt in {pairs_s:.3f} s; rerun wall {wall:.3f} s, "
            f"supersteps {m.supersteps}, tile_loads {m.tile_loads}, "
            f"tile_pair_loads {m.tile_pair_loads}, host_syncs "
            f"{m.host_syncs}, launches {launches}; updates_applied "
            f"{m.updates_applied}, dirty_blocks {m.dirty_blocks} in "
            f"RunMetrics; device memory peak {apply_gb:.2f} GB in "
            f"apply_updates, {run_peak / 1e9:.2f} GB in the rerun")
        if not m.converged:
            raise RuntimeError(f"{label}: no convergence in "
                               f"{MAX_SUPERSTEPS} supersteps")
        if (m.updates_applied, m.dirty_blocks) != (st.updates_applied,
                                                   st.dirty_blocks):
            raise RuntimeError(f"{label}: RunMetrics did not drain the "
                               f"stream counters")
        check_results(sess, handles, plain_csr(adj),
                      references(plain_csr(adj), handles), label)
        return st, live

    for i, b in enumerate(batches):
        step(f"stream batch {i + 1}/{len(batches)}", b,
             Fused() if i % 2 == 0 else TwoLevel())

    # inserts on block pairs without a tile slot: they land in the overlay
    reach = np.isfinite(sess.result(handles[-2]))
    bn = groups[0].graph.num_blocks
    src, dst = new_pairs(sess, groups[0], range(7, bn, bn // 8), 1, reach)
    _, live = step("stream overlay batch", UpdateBatch.inserts(src, dst),
                   Fused())
    if live == 0:
        raise RuntimeError("the overlay batch left no live overlay entry")

    # more new pairs in one block row than its overlay holds: compaction
    counts = groups[0].graph.nbr_mask.sum(dim=1).cpu().numpy()
    row = int(np.argmin(counts))
    src, dst = new_pairs(sess, groups[0], [row],
                         sess.overlay_capacity + 1,
                         np.ones(sess._csr.n, dtype=bool))
    st, _ = step(f"stream overflow batch (block row {row})",
                 UpdateBatch.inserts(src, dst), TwoLevel())
    if st.compacted_views != len(groups):
        raise RuntimeError(f"overflow batch compacted {st.compacted_views} "
                           f"of {len(groups)} views")
    t0 = time.perf_counter()
    _, compact_gb = peak_of(sess.compact)
    compact_s = time.perf_counter() - t0

    def same_as_fresh(g):
        _, fill, normalize, _ = g.key
        fresh = build_blocked(sess._csr, BLOCK, fill=fill,
                              normalize=normalize, device=sess.device)
        bp, fb = sess._pair_data(g), build_block_pairs(fresh)
        for f in ("tiles", "nbr_ids", "nbr_mask"):
            if not torch.equal(getattr(g.graph, f), getattr(fresh, f)):
                raise RuntimeError(f"compacted {g.semiring} view: {f} "
                                   f"differs from a fresh build")
        for f in ("src", "dst", "tiles", "run_start", "chunk_start",
                  "chunk_run"):
            if not torch.equal(getattr(bp, f), getattr(fb, f)):
                raise RuntimeError(f"compacted {g.semiring} view: pairs "
                                   f"{f} differ from a fresh build")

    check_gb = []
    for g in groups:
        check_gb.append(peak_of(lambda: same_as_fresh(g))[1])
        torch.cuda.empty_cache()
    log(f"stream: compact() of {len(groups)} views {compact_s:.3f} s "
        f"(device memory peak {compact_gb:.2f} GB); tiles, nbr_ids, "
        f"nbr_mask and pairs (src, dst, tiles, run_start, chunk_start, "
        f"chunk_run) bit-equal to a fresh build of the final CSR "
        f"({sess._csr.nnz} edges) on the card (peak "
        f"{', '.join(f'{x:.2f}' for x in check_gb)} GB while checking)")
    log(f"stream: peak device memory {peak[0] / 1e9:.2f} GB "
        f"({100.0 * peak[0] / total_mem:.1f}% of {total_mem / 1e9:.1f} GB)"
        f"; launches over the reruns {totals}")
    for sr, n in totals.items():
        if n <= 0:
            raise RuntimeError(f"stream: kernel {sr} was not launched")
    return handles, totals


# -- phase 7: the serve front ------------------------------------------------


def peak_running(h) -> int:
    """Most requests running at once, from the harness's logs: admissions
    at tick t join before completions stamped t + 1 leave."""
    admits = sorted(t for t, *_ in h.admission_log)
    leaves = sorted(t for t, *_ in h.completion_log)
    peak, ai, li = 0, 0, 0
    for t in range(h.ticks_run + 1):
        while ai < len(admits) and admits[ai] <= t:
            ai += 1
        peak = max(peak, ai - li)
        while li < len(leaves) and leaves[li] <= t + 1:
            li += 1
    return peak


def serve_run(torch, csr, policy, fk, out_dir):
    """One open-loop harness run of phase 7 on a fresh session; returns
    its B1/B2 launch counts."""
    from repro_torch.algorithms import BFS, PageRank, SSSP
    from repro_torch.core import GraphSession
    from repro_torch.obs import (LoadgenConfig, MetricsRegistry,
                                 OpenLoopHarness, SLOTarget, SLOTracker,
                                 validate_registry_snapshot,
                                 validate_trace_events)
    from repro_torch.serve import ConcurrentServeScheduler
    from scipy.sparse.csgraph import dijkstra
    import scipy.sparse as sp

    label = f"serve ({policy.name}, backend={policy.backend})"
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    sess = GraphSession(csr, BLOCK, capacity=SERVE_CAPACITY, seed=0,
                        telemetry=True)
    # set-up outside the served ticks: the three views the family mix
    # needs (plus-times, min-plus, unit-weight min-plus) and their pairs
    for alg in (PageRank(), SSSP(source=0), BFS(source=0)):
        sess.detach(sess.submit(alg))
    for g in sess.view_groups():
        sess._pair_data(g)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem_setup = torch.cuda.memory_allocated()
    n_groups = sess.scheduler.num_blocks
    slo = SLOTracker(targets=[SLOTarget(family="*", p99_latency_steps=60)])
    sched = ConcurrentServeScheduler(n_groups, batch_budget=SERVE_MAX_RUNNING,
                                     seed=5, trace=sess.trace, slo=slo)
    h = OpenLoopHarness(sess, sched, LoadgenConfig(**SERVE_LOAD),
                        policy=policy, max_running=SERVE_MAX_RUNNING,
                        supersteps_per_tick=SERVE_STEPS_PER_TICK)
    # the script's view of the run: every RunMetrics, each detached job's
    # result with the CSR it finished on, and the seconds and device
    # memory peak inside run() and apply_updates() against the rest (the
    # harness, submit, detach, the convergence poll)
    runs, done = [], []
    secs = {"run": 0.0, "apply_updates": 0.0}
    peaks = {"run": 0, "apply_updates": 0, "rest": 0}
    real = {k: getattr(sess, k) for k in ("run", "apply_updates",
                                           "detach")}

    def segment(name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            peaks["rest"] = max(peaks["rest"],
                                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            if name == "run":
                runs.append(out)
            return out
        return call

    def detach(handle):
        res = real["detach"](handle)
        done.append((handle.alg, res, sess._csr))
        return res
    sess.run, sess.apply_updates = segment("run"), segment("apply_updates")
    sess.detach = detach

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    t0 = time.perf_counter()
    s = h.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fk.launches)
    peaks["rest"] = max(peaks["rest"], torch.cuda.max_memory_allocated())
    peak = max(peaks.values())

    # -- checks ------------------------------------------------------------
    if not s["admitted"] == s["completed"] == s["arrivals"] > 0:
        raise RuntimeError(f"{label}: arrivals {s['arrivals']}, admitted "
                           f"{s['admitted']}, completed {s['completed']}")
    # the load must fill the slots: at the peak the admission headroom
    # (the scheduler's batch budget) is 0
    most = peak_running(h)
    if most != SERVE_MAX_RUNNING:
        raise RuntimeError(f"{label}: at most {most} requests ran at once, "
                           f"not the {SERVE_MAX_RUNNING} the load should "
                           f"fill")
    # request-ticks of service over the ticks: the mean number running
    mean_running = (sum(c[0] for c in h.completion_log)
                    - sum(a[0] for a in h.admission_log)) / h.ticks_run
    for m in runs:
        check_series(m, label)
    tel_loads = sum(int(m.telemetry.tile_loads.sum()) for m in runs)
    if tel_loads != s["counters"]["tile_loads"]:
        raise RuntimeError(f"{label}: series tile_loads {tel_loads} != "
                           f"harness {s['counters']['tile_loads']}")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"{label}: kernel {k} was not launched")
    trace_path = out_dir / f"serve_trace_{policy.backend}.json"
    sess.trace.export(str(trace_path))
    doc = json.loads(trace_path.read_text())
    n_events = validate_trace_events(doc)
    admits = sum(e["name"] == "serve.admit" for e in doc["traceEvents"])
    if admits == 0:
        raise RuntimeError(f"{label}: no serve.admit instant in the trace")
    reg = MetricsRegistry()
    reg.register("serve", sched.metrics)
    reg.register("slo", slo)
    reg.register("loadgen", s)
    reg.register("last_run", runs[-1].to_dict(include_telemetry=True))
    n_sources = validate_registry_snapshot(reg.snapshot())

    # each result against its plain answer on the CSR it finished on
    versions, cache = {}, {}
    n_min = n_pt = 0
    for alg, res, g in done:
        v = versions.setdefault(id(g), len(versions))
        if alg.semiring == "min_plus":
            key = (v, alg.name, alg.source)
            if key not in cache:
                a = sp.csr_matrix((g.weights.astype(np.float64), g.indices,
                                   g.indptr), shape=(g.n, g.n))
                cache[key] = dijkstra(a, directed=True, indices=alg.source,
                                      unweighted=alg.name == "bfs"
                                      ).astype(np.float32)
            np.testing.assert_array_equal(res, cache[key])
            n_min += 1
        elif n_pt < SERVE_PT_CHECKED:
            src = getattr(alg, "source", None)
            key = (v, alg.name, src)
            if key not in cache:
                cache[key] = pagerank_ref(g, alg.damping, src)
            if not np.isfinite(res).all():
                raise RuntimeError(f"{label}: non-finite {alg.name}")
            np.testing.assert_allclose(res, cache[key], rtol=5e-3,
                                       atol=1e-4)
            n_pt += 1

    lat, fams = s["latency_ticks"], s["latency_by_family"]
    steps = max(1, s["supersteps"])
    log(f"{label}: device memory {mem0 / 1e9:.2f} GB allocated before the "
        f"session, {mem_setup / 1e9:.2f} GB after its set-up; peak "
        f"{peaks['run'] / 1e9:.2f} GB in run(), "
        f"{peaks['apply_updates'] / 1e9:.2f} GB in apply_updates(), "
        f"{peaks['rest'] / 1e9:.2f} GB elsewhere; seconds in run() "
        f"{secs['run']:.3f}, in apply_updates() {secs['apply_updates']:.3f},"
        f" elsewhere {wall - secs['run'] - secs['apply_updates']:.3f} (the "
        f"harness, submit, detach, the convergence poll; each call fenced "
        f"by a sync)")
    log(f"{label}: set-up {setup_s:.2f} s (3 views + pairs); arrivals "
        f"{s['arrivals']}, admitted {s['admitted']}, completed "
        f"{s['completed']}, at most {most} running, {mean_running:.3f} "
        f"on average; ticks {s['ticks']}, "
        f"supersteps {s['supersteps']}, updates {s['updates_applied']}; "
        f"throughput {s['throughput_per_tick']} per tick; latency ticks "
        f"p50 {lat['p50']} p99 {lat['p99']} max {lat['max']}")
    log(f"{label}: by family " + "; ".join(
        f"{f} n={x['count']} p50 {x['p50']} p99 {x['p99']}"
        for f, x in fams.items()))
    log(f"{label}: wall {wall:.3f} s, {1e3 * wall / max(1, s['ticks']):.3f} "
        f"ms/tick, {1e3 * wall / steps:.3f} ms/superstep; launches "
        f"{launches}; counters {s['counters']}; peak device memory "
        f"{peak / 1e9:.2f} GB")
    log(f"{label}: {n_min} SSSP/BFS results bit-equal to scipy on the CSR "
        f"they finished on ({len(versions)} CSR versions), {n_pt} "
        f"PageRank/PPR within rtol 5e-3, atol 1e-4; every run's series "
        f"sums to its totals, {len(runs)} runs' tile_loads {tel_loads} = "
        f"the harness's; trace {n_events} events ({admits} serve.admit) "
        f"valid; registry snapshot of {n_sources} sources valid; SLO "
        f"p99 <= 60 ticks met by family: " + ", ".join(
            f"{f} {e['slo']['ok']}"
            for f, e in slo.report()["families"].items() if "slo" in e))
    for k, fn in real.items():
        setattr(sess, k, fn)
    del sess, h, sched, runs, done
    return launches


def serve_phase(torch, csr, fk, out_dir):
    """Phase 7: the open-loop serve front at full size, once on each
    scheduling backend.  Returns the B1/B2 launches of both runs."""
    from repro_torch.core import TwoLevel
    totals = {sr: 0 for sr in SEMIRINGS}
    for policy in (TwoLevel(), TwoLevel(backend="device",
                                        steps_per_sync=SERVE_STEPS_PER_TICK)):
        launches = serve_run(torch, csr, policy, fk, out_dir)
        for sr in totals:
            totals[sr] += launches[sr]
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true",
                    help="add a traced rerun (per-layer breakdown)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root / "src"))
    from repro_torch.algorithms import (PageRank, PersonalizedPageRank,
                                        SSSP)
    from repro_torch.core import Fused, GraphSession, TwoLevel
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_superstep import kernel as fk
    from repro_torch.kernels.fused_superstep import ops as fops

    # -- phase 1: device and settings ------------------------------------
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    common.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in common.KERNEL_SOURCES:
        for line in common.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas ({name}): {line.strip()}")
    ptxas_report(common, fk)

    # -- the slice's graph and session (two views) -------------------------
    t0 = time.perf_counter()
    csr = rmat_graph(N_VERTICES, AVG_DEGREE, seed=0)
    log(f"rmat_graph({N_VERTICES}, {AVG_DEGREE}): {csr.nnz} edges in "
        f"{time.perf_counter() - t0:.2f} s")
    sess = GraphSession(csr, BLOCK, capacity=CAPACITY, seed=0)
    if not sess.use_pallas:
        raise RuntimeError("a CUDA session must push through the kernels")
    algs = [PageRank(), PersonalizedPageRank(source=PPR_SOURCE)] + [
        SSSP(source=s) for s in SSSP_SOURCES]
    handles = []
    for alg in algs:
        t0 = time.perf_counter()
        handles.append(sess.submit(alg))
        torch.cuda.synchronize()
        log(f"submit {type(alg).__name__}: {time.perf_counter() - t0:.2f} s"
            f" (the first job of a view builds its block-ELL tiles)")
    groups = {g.semiring: g for g in sess.view_groups()}
    for sr, g in groups.items():
        t0 = time.perf_counter()
        bp = sess._pair_data(g)
        torch.cuda.synchronize()
        gr = g.graph
        log(f"view {sr}: B_N={gr.num_blocks} K={gr.max_nbr_blocks} "
            f"P={bp.num_pairs} runs={bp.num_runs}; ELL tiles "
            f"{gr.tiles.numel() * 4 / 1e9:.2f} GB, pair tiles "
            f"{bp.tiles.numel() * 4 / 1e9:.2f} GB; pairs built in "
            f"{time.perf_counter() - t0:.2f} s")
    # phases 6 and 7 replace or free the views: a name bound here would
    # keep one alive
    del bp, gr, g

    # -- phase 2: kernels against their plain versions ---------------------
    timer = Timer(torch)
    figures = check_kernels(torch, timer, sess, groups, sess.device)

    # -- phase 3: the main path (host backend) ------------------------------
    dist = sssp_ref(csr, SSSP_SOURCES).astype(np.float32)
    refs = [pagerank_ref(csr, a.damping, getattr(a, "source", None))
            for a in algs[:2]] + list(dist)
    policy = timed_policy(TwoLevel)
    masks, restore = record_selections(fops)
    try:
        m, wall, launches, peak = drive(torch, sess, policy, fk)
    finally:
        restore()
    report_run(torch, "main path", m, wall, launches, peak)
    host_state = snapshot(sess)
    check_results(sess, handles, csr, refs, "main path")

    # -- phase 2b: B1/B2 on the main path's selections ---------------------
    sel_figures = check_selections(torch, timer, sess, groups, sess.device,
                                   masks)
    del masks
    steps = max(1, m.supersteps)
    select_ms = 1e3 * policy.select_s / steps
    kern_all = sum(launches[k] * figures[k]["ms"] for k in launches)
    kern_sel = sum(launches[k] * statistics.mean(
        f["ms"] for f in sel_figures[k]) for k in launches)
    log(f"main path per superstep: host scheduling (select) "
        f"{select_ms:.3f} ms; kernels {kern_sel / steps:.3f} ms (launches x "
        f"mean time on the three main-path selections; "
        f"{kern_all / steps:.3f} ms at the all-live time); the rest "
        f"{1e3 * wall / steps - select_ms - kern_sel / steps:.3f}"
        f" ms (pair reduction and its read, state ops, Python)")

    # -- phase 4: the device scheduling backend ----------------------------
    handles, dev_launches, fused = device_backend(
        torch, sess, handles, csr, refs, fk, (m, wall, host_state))
    handles = telemetry_on_off(torch, sess, handles, csr, refs, fk,
                               (m, wall, host_state), fused)
    del host_state, fused

    # -- phase 5: B3 and B4 at their entry points ---------------------------
    handles = resubmit(torch, sess, handles)
    b3 = check_mj_spmm(torch, timer, groups, sess.device)
    b3_launches = check_push_shared(torch, timer, sess, groups, sess.device)
    b4 = check_priority_pairs(torch, timer, sess, groups)

    if args.trace:
        handles = traced_rerun(torch, sess, handles, TwoLevel())
        handles = traced_rerun(torch, sess, handles, Fused())

    # -- phase 6: evolving graphs -------------------------------------------
    handles, stream_launches = stream_phase(torch, sess, handles, csr, fk)

    # -- phase 7: the serve front (the first session's views freed) ---------
    del sess, groups, handles
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = root / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    serve_launches = serve_phase(torch, csr, fk, out_dir)

    kernels = []
    for sr in SEMIRINGS:
        f = figures[sr]
        kernels.append({
            "name": f"fused_superstep_{sr}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[sr],
            "launches": (launches[sr] + dev_launches[sr]
                         + stream_launches[sr] + serve_launches[sr]),
            "launches_by_path": {"host_two_level": launches[sr],
                                 "device_fused": dev_launches[sr],
                                 "stream": stream_launches[sr],
                                 "serve": serve_launches[sr]},
            "max_abs_err": max([f["max_abs_err"]] + [
                x["max_abs_err"] for x in sel_figures[sr]]),
            "ms": f["ms"], "kernel_ms": f["ms"], "device_ms": f["ms"],
            "host_ms_per_call": f["host_ms_per_call"],
            "queued": f["queued"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None, "timing": TIMING,
            "main_path_selections": sel_figures[sr]})
    for sr in SEMIRINGS:
        f = b3[sr]
        kernels.append({
            "name": f"mj_spmm_{sr}", "route": "cuda", "source": B3_SOURCE,
            "replaces": B3_REPLACES[sr], "launches": b3_launches[sr],
            "max_abs_err": f["max_abs_err"], "ms": f["ms"],
            "kernel_ms": f["ms"], "device_ms": f["ms"],
            "host_ms_per_call": f["host_ms_per_call"],
            "queued": f["queued"], "indexed_ms": f["indexed_ms"],
            "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
            "bound_by": f["bound_by"], "library_ms": f["library_ms"],
            "timing": TIMING})
    kernels.append({
        "name": "priority_pairs", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES, "kernel_ms": b4["ms"], "timing": TIMING,
        **b4})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
