#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. Device and settings: the card's name and power limit, TF32 off, and
   the CUDA kernels built from the sources in this checkout.
2. Each kernel against its plain PyTorch version on the card, on the
   slice's real block pairs (rmat_graph(2**16, 8), Vb=64) with
   numpy-seeded random state: J=4 (the main path's job axis), a prime J,
   and a width-contract case (d at B_N, outputs at B_loc < B_N).  Bars:
   plus-times rtol = atol = 1e-5 with node_un exact; min-plus values,
   deltas and node_un bit-equal, p_sum rtol 1e-6.  Each kernel and its
   plain version are timed with CUDA events (median of 10 after warm-up).
3. The main path at full size: GraphSession(rmat_graph(2**16, 8), 64,
   capacity=4) on CUDA with PageRank, PPR(3), SSSP(0), SSSP(4097) — two
   graph views — run under TwoLevel() to convergence with the launch
   counts set to 0 just before and read just after.  SSSP is held
   bit-equal to scipy's Dijkstra, PageRank/PPR to a float64 power
   iteration at rtol 5e-3, atol 1e-4.

Then one JSON line of kernel figures, the card's name and power limit,
and last {"ok": true, "device": {...}}.

    python3 chip_smoke.py --trace

adds a traced rerun of the same four jobs under torch.profiler after the
checks (the per-layer breakdown: device time by kernel, the device's busy
share); the untraced main path above gives the end-to-end numbers.
"""

from __future__ import annotations

import argparse
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
    """Least time for one call: bytes each read/written once over HBM
    rate vs flops over the float32 rate.  Every call sweeps all P tiles
    (selection is encoded by masking d rows)."""
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


def check_kernels(torch, sess, groups, device):
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
                    values=vals, run_start=bp.run_start, semiring=semiring,
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
                k_ms = median_ms(torch, kern)
                p_ms = median_ms(torch, plain)
                b_ms, b_by = bound(semiring, j, bn, bn_loc, vb,
                                   bp.num_pairs, bp.num_runs)
                log(f"  {semiring}: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                    f"{k_ms / b_ms:.2f}x the bound")
                figures[semiring] = dict(ms=k_ms, plain_ms=p_ms,
                                         bound_ms=b_ms, bound_by=b_by)
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


def traced_rerun(torch, sess, handles, policy):
    """Resubmit the jobs and rerun them under torch.profiler: device time
    by kernel and the device's busy share of the run's wall time."""
    from torch.profiler import ProfilerActivity, profile
    algs = [h.alg for h in handles]
    for h in handles:
        sess.detach(h)
    for a in algs:
        sess.submit(a)
    torch.cuda.synchronize()
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
    log(f"traced rerun: supersteps={m.supersteps} wall {wall:.3f} s, device "
        f"busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
        f"of wall (idle {100 - 100 * busy_us / 1e6 / wall:.1f}%)")
    for dev_us, count, key in rows[:10]:
        log(f"  {dev_us / 1e3:9.2f} ms  {count:6d} calls  {key[:90]}")


def sssp_ref(csr, sources):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra
    a = sp.csr_matrix((csr.weights.astype(np.float64), csr.indices,
                       csr.indptr), shape=(csr.n, csr.n))
    return dijkstra(a, directed=True, indices=list(sources))


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
    from repro_torch.core import GraphSession, TwoLevel
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels import common
    from repro_torch.kernels.fused_superstep import kernel as fk

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
    for line in common.build_log("fused_superstep").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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

    # -- phase 2: kernels against their plain versions ---------------------
    figures = check_kernels(torch, sess, groups, sess.device)

    # -- phase 3: the main path --------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    policy = timed_policy(TwoLevel)
    t0 = time.perf_counter()
    m = sess.run(policy, MAX_SUPERSTEPS)
    wall = time.perf_counter() - t0
    launches = dict(fk.launches)
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"main path: converged={m.converged} supersteps={m.supersteps} "
        f"tile_loads={m.tile_loads} tile_pair_loads={m.tile_pair_loads} "
        f"job_block_pushes={m.job_block_pushes} host_syncs={m.host_syncs}")
    log(f"main path: wall {wall:.3f} s, "
        f"{1e3 * wall / max(1, m.supersteps):.3f} ms/superstep; "
        f"launches {launches}; peak device memory {peak / 1e9:.2f} GB "
        f"({100.0 * peak / total:.1f}% of {total / 1e9:.1f} GB)")
    steps = max(1, m.supersteps)
    kern_ms = sum(launches[k] * figures[k]["ms"] for k in launches)
    log(f"main path per superstep: host scheduling (select) "
        f"{1e3 * policy.select_s / steps:.3f} ms; kernels "
        f"{kern_ms / steps:.3f} ms (launches x median call time); the rest "
        f"{1e3 * wall / steps - 1e3 * policy.select_s / steps - kern_ms / steps:.3f}"
        f" ms (pair reduction and its read, state ops, Python)")
    if not m.converged:
        raise RuntimeError(f"no convergence in {MAX_SUPERSTEPS} supersteps")
    for k, n in launches.items():
        if n <= 0:
            raise RuntimeError(f"kernel {k} was not launched on the main path")

    res = [sess.result(h) for h in handles]
    for r in res:
        if r.shape != (csr.n,) or r.dtype != np.float32:
            raise RuntimeError(f"result shape/dtype {r.shape} {r.dtype}")
    dist = sssp_ref(csr, SSSP_SOURCES).astype(np.float32)
    for k, (h, want) in enumerate(zip(handles[2:], dist)):
        np.testing.assert_array_equal(res[2 + k], want)
        log(f"SSSP(source={h.alg.source}) bit-equal to scipy dijkstra "
            f"({int(np.isfinite(want).sum())} reachable)")
    for r, alg in zip(res[:2], algs[:2]):
        src = getattr(alg, "source", None)
        want = pagerank_ref(csr, alg.damping, src)
        if not np.isfinite(r).all():
            raise RuntimeError(f"{alg.name}: non-finite result")
        np.testing.assert_allclose(r, want, rtol=5e-3, atol=1e-4)
        log(f"{alg.name}: within rtol 5e-3, atol 1e-4 of the float64 power "
            f"iteration (max |err| {np.abs(r - want).max():.3g})")

    if args.trace:
        traced_rerun(torch, sess, handles, TwoLevel())

    kernels = []
    for sr in ("plus_times", "min_plus"):
        f = figures[sr]
        kernels.append({
            "name": f"fused_superstep_{sr}", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[sr],
            "launches": launches[sr], "max_abs_err": f["max_abs_err"],
            "ms": f["ms"], "kernel_ms": f["ms"], "plain_ms": f["plain_ms"],
            "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
