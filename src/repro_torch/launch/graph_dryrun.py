"""Dry run of the paper's own workload at pod scale: one superstep of the
fused two-level engine over a production-sized concurrent-PageRank fleet
(the reference's `repro.launch.graph_dryrun`).

The reference compiles one superstep of a pure step function
(`fused_superstep`) on 256 or 512 fake host devices under GSPMD and
reads XLA's memory analysis and HLO.  The port has no GSPMD: what runs
across ranks is its own jobs x blocks engine (`dist.mesh2d`), which
places pair shards by destination, exchanges one [J_loc, q, Vb] frontier
over the blocks group a superstep and runs the fused kernels B1/B2 on
the rank's pairs.  So `run` runs the port's PRODUCTION superstep as one
rank (rank 0 unless asked) of a fake world of the mesh's size
(`launch.dryrun.fake_world`), on the meta device, where nothing is
allocated and no card is needed:

- the fleet's CSR is built on the host from a seed as a regular block
  graph (`fleet_graph`): each source block has exactly `avg_nbr_blocks`
  destination blocks at fixed offsets, one edge a pair, the only form of
  the reference's abstract `nbr_ids [B_N, K]` a session can take;
- an empty `GraphSession(csr, vb, capacity=n_jobs, device="meta")` is
  placed on `make_mesh2d(jobs, blocks, device_type="meta")` before its
  jobs are submitted, so each view is built as the rank's slices alone
  (`dist.mesh2d.build_group_slices`; on meta the tiles are allocated
  there and never filled on the host);
- the chunk function of `Fused(steps_per_sync=1)` (`recorded_step`) is
  called once on `dist.mesh2d.device_inputs_2d`'s carry under
  `FlopCounterMode`, `MemTracker` and `dist.comm.record`, as
  `core.policy._run_device` calls it; its result is never read (a meta
  tensor has no value), and `GraphSession.run` is never called.

The mesh is jobs x blocks: (16, 16) is 16 job shards x 16 block shards,
(2, 16, 16) 32 job shards (pod x model) x 16 block shards; the records
keep the reference's labels "16x16" and "2x16x16".

Record keys (the reference's where the meaning holds; raw bytes beside
the GiB figures):
  q, num_blocks, vb     the session's queue length, B_N and Vb;
  arg_gib_analytic      the reference's five arguments (values, deltas
                        [J, B_N, Vb], tiles [B_N, K, Vb, Vb], nbr_ids,
                        push_scale) under its shardings, by its rule
                        (each split dim holds its ceiling share,
                        `launch.dryrun.local_bytes`): the number the
                        reference reports;
  arg_gib_per_dev       the bytes of every tensor the rank's placed
                        session holds when the step starts: pair shard,
                        job state, overlay, the ELL rows' metadata and
                        the carry.  The kernel route reads the pair
                        shard alone, so a view holds no ELL tiles (they
                        are built only for a route that reads them,
                        `graph.structure.BlockedGraph.tiles`): about the
                        reference's tile bytes;
  temp_gib_per_dev      `MemTracker`'s peak over the step less what the
                        rank held when it started;
  collectives, calls    each recorded call as a `cost.Collective` with
                        its group, summed by `cost.collective_summary`;
                        a group that spans nodes of `cost.NODE_SIZE`
                        ranks goes on the network term;
  wire_gib_per_dev      their wire bytes;
  flops_one_device      `FlopCounterMode`'s count of `fused_superstep`
                        on the whole fleet on meta: the fleet's whole
                        push on one device;
  flops_per_dev         the kernel route's share, flops_one_device /
                        (job shards x block shards): the kernels multiply
                        only pairs whose source is in the global queue,
                        and the regular graph spreads them evenly;
  flops_plain_per_dev   `FlopCounterMode`'s count of what the plain route
                        multiplied on meta (every pair of the shard);
  live_pairs_per_dev    the shard's pairs whose source is one of q
                        selected blocks (any q: the graph is regular);
  roofline              `cost.roofline_terms` of flops_per_dev, the B1
                        byte bound at that many live pairs
                        (`cost.fused_live_bytes`) and the wire bytes;
  kernel_route          whether B1/B2 take the cell on the card: Vb must
                        be in `SUPPORTED_VB` (every power of two from 8
                        to 512, the fleet's 512 included) and the job
                        layout must fit `SMEM_BUDGET`; else "plain only"
                        and why;
  kernel_pass_jobs      the live jobs one pass of B1/B2 holds on that
                        route (`fused_superstep.kernel.layout`: at Vb =
                        512, 12 for 4 local jobs, 2 for 2), or None;
  trace_s               host seconds of the step (the reference's
                        compile_s).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.graph_dryrun
  PYTHONPATH=src python -m repro_torch.launch.graph_dryrun --vertices 16384 \\
      --jobs 16 --vb 64 --nbr-blocks 8 --out /tmp/g.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.algorithms import PageRank
from repro_torch.core.policy import Fused
from repro_torch.core.priority import do_score
from repro_torch.core.push import compute_pairs, push_plus_one
from repro_torch.core.session import GraphSession
from repro_torch.dist import comm
from repro_torch.dist.mesh2d import (device_inputs_2d, make_mesh2d,
                                     shard_session_2d)
from repro_torch.dist.sharding import Placement
from repro_torch.graph.structure import (PAIR_CHUNK, CSRGraph,
                                         block_adjacency)
from repro_torch.kernels import common
from repro_torch.kernels.fused_superstep import kernel as fk
from repro_torch.launch import cost
from repro_torch.launch.dryrun import (META, fake_world, local_bytes,
                                       tensor_bytes)
from repro_torch.launch.mesh import make_production_mesh


def fused_superstep(alg, num_blocks: int, q: int, nbr_k: int, vb: int):
    """One two-level superstep as a pure function of (values, deltas,
    tiles, nbr_ids, push_scale) on ELL tiles: pairs, DO score, per-job
    top-q, the summed global priority, the global top-q and the
    plus-times push of every job (the reference's `fused_superstep`)."""
    del nbr_k, vb

    def step(values, deltas, tiles, nbr_ids, push_scale):
        node_un, p_mean = compute_pairs(alg, values, deltas)
        score = do_score(node_un, p_mean)
        topv, topi = torch.topk(score, q, dim=-1)
        valid = torch.isfinite(topv)
        w = torch.arange(q, 0, -1, dtype=torch.float32,
                         device=values.device) * valid
        gpri = torch.zeros(num_blocks, dtype=torch.float32,
                           device=values.device)
        gpri.scatter_add_(0, topi.reshape(-1), w.reshape(-1))
        gv, gsel = torch.topk(gpri, q)
        gmask = (gv > 0.0).to(torch.float32)
        gsel = gsel.to(torch.int32)
        pushed = [push_plus_one(values[j], deltas[j], tiles, nbr_ids, gsel,
                                gmask, push_scale[j])
                  for j in range(values.shape[0])]
        values = torch.stack([v for v, _ in pushed])
        deltas = torch.stack([d for _, d in pushed])
        un = alg.unconverged(values, deltas).sum()
        return values, deltas, un

    return step


def fleet_graph(n_vertices: int, vb: int, avg_nbr_blocks: int,
                seed: int = 0) -> CSRGraph:
    """A regular block graph: source block b has destination blocks
    (b + k * (B_N // K)) mod B_N for k < K, one edge a pair between
    vertices drawn from `seed`: B_N x K pairs."""
    bn, k = n_vertices // vb, avg_nbr_blocks
    if bn * vb != n_vertices or not 1 <= k <= bn:
        raise ValueError(f"{n_vertices} vertices in blocks of {vb} with "
                         f"{k} neighbour blocks a block")
    sb = np.repeat(np.arange(bn, dtype=np.int64), k)
    db = (sb + np.tile(np.arange(k, dtype=np.int64) * (bn // k), bn)) % bn
    rng = np.random.default_rng(seed)
    src = sb * vb + rng.integers(0, vb, size=sb.size)
    dst = db * vb + rng.integers(0, vb, size=sb.size)
    return CSRGraph.from_edges(n_vertices, src, dst)


def fleet_session(csr: CSRGraph, vb: int, n_jobs: int, mesh,
                  device) -> GraphSession:
    """An empty session placed on `mesh`, then `n_jobs` PageRank jobs."""
    sess = GraphSession(csr, vb, capacity=n_jobs, device=device)
    shard_session_2d(mesh, sess)
    for _ in range(n_jobs):
        sess.submit(PageRank())
    return sess


def _tensors(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def held_tensors(sess, inputs) -> list:
    """Every tensor a placed session holds (each view's job state, ELL
    metadata and ELL tiles where built, overlay and pair shard) and
    those of `inputs`."""
    out: list = []
    for g in sess.view_groups():
        _tensors((g.values, g.deltas, g.push_scale, g.graph, g.overlay,
                  g.pair_shards[1]), out)
    return _tensors(inputs, out)


def recorded_step(sess, *, count_flops: bool = True,
                  track_memory: bool = False) -> dict:
    """One `Fused(steps_per_sync=1)` superstep on a placed session: its
    chunk function called once on `device_inputs_2d`'s
    carry, as `_run_device` calls it, its result never read here.
    Returns the carry it leaves (`state`), the recorded collectives
    (`calls`, each a `comm.Call`), the bytes of the tensors held when it
    starts (`resident_bytes`), the FLOPs
    `FlopCounterMode` counts (`flops`), and with `track_memory`
    `MemTracker`'s resident and peak bytes; on a CUDA session the card's
    `memory_allocated` before the step (`card_base_bytes`) and its
    `max_memory_allocated` over it (`card_peak_bytes`), reset before."""
    policy = Fused(steps_per_sync=1)
    step_fn = sess._device_step_fn(policy)
    state, *args = device_inputs_2d(policy, sess)
    held = held_tensors(sess, (state, args))
    out = {"resident_bytes": tensor_bytes(held)}
    cuda = sess.device.type == "cuda"
    with contextlib.ExitStack() as modes:
        calls = modes.enter_context(comm.record())
        fc = (modes.enter_context(FlopCounterMode(display=False))
              if count_flops else None)
        if track_memory:
            mt = MemTracker()
            mt.track_external(*held)
            out["tracked_bytes"] = int(
                mt.get_tracker_snapshot("current")[sess.device]["Total"])
            modes.enter_context(mt)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out["card_base_bytes"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out["state"] = step_fn(state, *args, 1, sess.seed,
                               sess.scheduler._step)[0]
        if cuda:
            torch.cuda.synchronize()
        out["trace_s"] = time.perf_counter() - t0
    if cuda:
        out["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    if track_memory:
        out["peak_bytes"] = int(
            mt.get_tracker_snapshot("peak")[sess.device]["Total"])
    out["calls"] = list(calls)
    out["flops"] = float(fc.get_total_flops()) if count_flops else None
    return out


def dry_run_session(build: Callable, mesh_shape: Sequence[int],
                    rank: int = 0) -> dict:
    """`recorded_step` (memory tracked) of the session `build(mesh,
    device)` places, as `rank` of a fake world of the (jobs, blocks)
    mesh's size, on the meta device; with the session's q, B_N and the
    rank's placement."""
    jobs, blocks = mesh_shape
    with fake_world(jobs * blocks, rank):
        mesh = make_mesh2d(jobs, blocks, device_type="meta")
        sess = build(mesh, META)
        rec = recorded_step(sess, track_memory=True)
        spec = sess._mesh2d
        rec.update(q=int(sess.q), num_blocks=int(sess.scheduler.num_blocks),
                   job_shards=spec.jobs_shards,
                   block_shards=spec.block_shards,
                   blocks_index=spec.blocks_index,
                   local_jobs=[g.values.shape[0]
                               for g in sess.view_groups()])
    return rec


def call_rows(calls) -> list:
    """[op, dtype, shape, bytes, group size, link] of each recorded
    call."""
    return [[c.op, c.dtype, list(c.shape), c.nbytes, len(c.ranks),
             "nvlink" if cost.within_node(c.ranks) else "network"]
            for c in calls]


def kernel_route(vb: int, local_jobs: int) -> str:
    """"B1/B2" where the fused kernels take a view of block size `vb` with
    `local_jobs` job rows on the card, else "plain only" and why."""
    try:
        fk.check_shape(local_jobs, vb)
    except ValueError as e:
        return f"plain only: {e}"
    return "B1/B2"


def shard_live_pairs(csr: CSRGraph, vb: int, q: int, n_shards: int,
                     shard: int) -> dict:
    """The pairs of block shard `shard` (destinations in its range) and,
    with the first q source blocks selected, its live pairs, their
    distinct sources, its runs and its work items (`PAIR_CHUNK`)."""
    adj = block_adjacency(csr, vb)
    b_loc = adj.num_blocks // n_shards
    mine = adj.tile_db // b_loc == shard
    src, dst = adj.tile_sb[mine], adj.tile_db[mine]
    on = src < q
    per_run = np.bincount(dst - shard * b_loc, minlength=b_loc)
    per_run = per_run[per_run > 0]
    return dict(pairs=int(mine.sum()), live=int(on.sum()),
                sources=int(np.unique(src[on]).size), runs=len(per_run),
                chunks=int(np.sum(-(-per_run // PAIR_CHUNK))))


def reference_arg_bytes(n_vertices: int, n_jobs: int, vb: int,
                        avg_nbr_blocks: int, multi_pod: bool) -> int:
    """The reference's five arguments under its shardings on its
    production mesh, by its rule (`launch.dryrun.local_bytes`)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    bn = n_vertices // vb
    job_axes = ("pod", "model") if multi_pod else "model"

    def arg(shape, dtype, spec):
        return (torch.empty(shape, dtype=dtype, device=META),
                Placement(mesh, spec))
    args = (arg((n_jobs, bn, vb), torch.float32, (job_axes, "data", None)),
            arg((n_jobs, bn, vb), torch.float32, (job_axes, "data", None)),
            arg((bn, avg_nbr_blocks, vb, vb), torch.float32,
                ("data", None, None, None)),
            arg((bn, avg_nbr_blocks), torch.int32, ("data", None)),
            arg((n_jobs,), torch.float32, ()))
    return local_bytes(tuple(a for a, _ in args), tuple(p for _, p in args))


def run(n_vertices: int = 1 << 20, n_jobs: int = 64, vb: int = 512,
        avg_nbr_blocks: int = 32, multi_pod: bool = False, *,
        rank: int = 0) -> dict:
    """The record of one superstep of the fleet on the single-pod or the
    multi-pod mesh, run as `rank` (see the module docstring)."""
    mesh_shape = (32, 16) if multi_pod else (16, 16)
    bn = n_vertices // vb
    csr = fleet_graph(n_vertices, vb, avg_nbr_blocks)
    rec = dry_run_session(functools.partial(fleet_session, csr, vb, n_jobs),
                          mesh_shape, rank)
    q = rec["q"]
    shards = rec["job_shards"] * rec["block_shards"]
    alg = PageRank()
    step = fused_superstep(alg, bn, q, avg_nbr_blocks, vb)
    whole = [torch.empty(s, dtype=dt, device=META) for s, dt in (
        ((n_jobs, bn, vb), torch.float32), ((n_jobs, bn, vb), torch.float32),
        ((bn, avg_nbr_blocks, vb, vb), torch.float32),
        ((bn, avg_nbr_blocks), torch.int32), ((n_jobs,), torch.float32))]
    fc = FlopCounterMode(display=False)
    with fc:
        step(*whole)
    flops_one = float(fc.get_total_flops())
    flops_dev = flops_one / shards
    live = shard_live_pairs(csr, vb, q, rec["block_shards"],
                            rec["blocks_index"])
    j_loc = rec["local_jobs"][0]
    b_loc = bn // rec["block_shards"]
    hbm = cost.fused_live_bytes("plus_times", j_loc, bn, b_loc, vb,
                                live["pairs"], live["live"],
                                live["sources"], live["runs"],
                                live["chunks"])
    colls = [cost.Collective(c.op, c.nbytes, len(c.ranks), 1, "superstep",
                             c.ranks) for c in rec["calls"]]
    csum = cost.collective_summary(colls)
    arg_ana = reference_arg_bytes(n_vertices, n_jobs, vb, avg_nbr_blocks,
                                  multi_pod)
    temp = rec["peak_bytes"] - rec["tracked_bytes"]
    route = kernel_route(vb, j_loc)
    return {
        "cell": f"graph-pagerank-V{n_vertices}-J{n_jobs}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mesh_jobs_blocks": list(mesh_shape),
        "rank": rank,
        "status": "ok",
        "trace_s": rec["trace_s"],
        "q": q, "num_blocks": rec["num_blocks"], "vb": vb,
        "local_jobs": j_loc,
        "arg_bytes_analytic": arg_ana,
        "arg_gib_analytic": arg_ana / 2**30,
        "arg_bytes_per_dev": rec["resident_bytes"],
        "arg_gib_per_dev": rec["resident_bytes"] / 2**30,
        "temp_bytes_per_dev": temp,
        "temp_gib_per_dev": temp / 2**30,
        "wire_gib_per_dev": csum["total_wire_bytes"] / 2**30,
        "collectives": csum,
        "calls": call_rows(rec["calls"]),
        "flops_one_device": flops_one,
        "flops_per_dev": flops_dev,
        "flops_plain_per_dev": rec["flops"],
        "live_pairs_per_dev": live["live"],
        "pairs_per_dev": live["pairs"],
        "roofline": cost.roofline_terms(flops_dev, hbm,
                                        csum["nvlink_wire_bytes"],
                                        csum["network_wire_bytes"]),
        "kernel_route": route,
        "kernel_pass_jobs": (fk.layout(j_loc, vb).pass_jobs
                             if route == "B1/B2" else None),
    }


def graph_table(records) -> str:
    """A markdown table of `run`'s records."""
    out = ["| mesh | q | B_N | Vb | arg GiB/dev (analytic / held) | temp "
           "GiB/dev | wire GiB/dev | flops/dev (kernel / plain) | "
           "dominant | kernel route |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        out.append(
            f"| {r['mesh']} | {r['q']} | {r['num_blocks']} | {r['vb']} | "
            f"{r['arg_gib_analytic']:.4f} / {r['arg_gib_per_dev']:.4f} | "
            f"{r['temp_gib_per_dev']:.4f} | {r['wire_gib_per_dev']:.6f} | "
            f"{r['flops_per_dev']:.5g} / {r['flops_plain_per_dev']:.5g} | "
            f"{r['roofline']['dominant']} | {r['kernel_route']}"
            + (f" ({r['kernel_pass_jobs']} jobs a pass)"
               if r.get("kernel_pass_jobs") else "") + " |")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=1 << 20)
    ap.add_argument("--jobs", type=int, default=64)
    ap.add_argument("--vb", type=int, default=512)
    ap.add_argument("--nbr-blocks", type=int, default=32)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--out", default="experiments/graph_dryrun_torch.json")
    args = ap.parse_args(argv)
    records = []
    for mp in (False, True):
        rec = run(args.vertices, args.jobs, args.vb, args.nbr_blocks, mp,
                  rank=args.rank)
        print(json.dumps(rec, indent=1))
        records.append(rec)
    print(graph_table(records))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
