"""Dry run: what one device of a production mesh holds, computes and
sends, for every (architecture x input shape) cell on the single-pod
(16, 16) and multi-pod (2, 16, 16) meshes (the reference's
`repro.launch.dryrun`).

The reference lowers and compiles each cell on 512 fake host devices and
reads XLA's memory and cost analyses and the compiled HLO.  The port has
no compiler to ask, so it runs the port's own step once, as one rank of
the mesh (rank 0 unless asked), on the meta device, where nothing is
allocated and no card is needed: the run describes 256 or 512 devices
that no machine here holds, as the reference's did on fake CPU devices.
`run_cell`:

- enters a fake world of the mesh's size as that rank
  (`torch.distributed`'s "fake" backend: every collective returns at
  once, its buffers untouched), with `dist.comm`'s group cache cleared
  on entry and on exit, and destroys it on exit, even on error;
- builds the cell (`launch.specs.build_cell`) with an LM on the meta
  device placed as the rank holds it (a train cell's whole weights; a
  serve cell's slices under `param_shardings(serve=True)`), and its
  arguments placed by `in_shardings` (the rank's slices).  A serve
  cell's cache is what the port's rank holds: its rows of the batch and
  its KV heads, every layer, filled to seq_len - 1 for decode (the
  reference's `cache_shardings` may split a stacked cache's cycles, a
  layout the port does not run);
- runs the cell's function once under `FlopCounterMode`, `MemTracker`
  and `dist.comm.record`.

Record keys (the reference's where the meaning holds):
  hlo_flops_per_dev   FLOPs `FlopCounterMode` counts in the step (its
                      matmuls, einsums and convolutions; the recomputed
                      forward of remat inside the backward counted, as
                      XLA's HLO holds it);
  arg_bytes_analytic  the bytes of every argument under its placement,
                      by the reference's rule: each dim split over mesh
                      axes holds its ceiling share;
  arg_bytes_per_dev   the bytes of the argument tensors the rank holds
                      when the step starts (a serve cell's cache as
                      above; a train state's step is a host int);
  peak_bytes_per_dev  `MemTracker`'s peak of the rank's live tensors over
                      the step: the arguments and the model's own
                      parameters tracked from the start, then what the
                      step allocates (autograd's saved tensors, remat's
                      recomputed cycle, gradients, temporaries,
                      collective buffers);
  temp_bytes_per_dev  the peak less what the rank held when the step
                      started (arguments and parameters);
  hbm_bytes_per_dev_est  2 x arg_bytes_analytic + temp_bytes_per_dev
                      (the reference's traffic model);
  collectives         `cost.collective_summary` of the recorded calls
                      (by op, total, by link), n_hlo_collectives their
                      count; comm_calls / comm_bytes `dist.comm.STATS`'s
                      count of the same calls;
  fits_80gb           the peak under `cost.HBM_PER_CARD`;
  trace_s             the host seconds of the run (time.perf_counter).
The reference's lower_s, compile_s, out/alias bytes, hlo_*_top and
scan_trip have no meaning here.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.dist import comm
from repro_torch.dist.act import activation_sharding
from repro_torch.dist.sharding import (_shape, entry_axes, param_shardings,
                                       reshard)
from repro_torch.launch import cost, specs
from repro_torch.launch.analytic import cell_flops
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.train.optimizer import adamw_init
from repro_torch.tree import leaves, members, tree_map

META = torch.device("meta")


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of `n` ranks, this process as `rank`."""
    if dist.is_initialized():
        raise RuntimeError("a dry run starts its own fake world: a process "
                           "group is already initialized here")
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    comm.clear_groups()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
        comm.clear_groups()


def local_bytes(args, shardings) -> int:
    """Rank 0's bytes of `args` under `shardings` (matching trees of
    meta tensors and Placements): each dim split over mesh axes holds
    its ceiling share (the reference's rule, `dryrun.py`'s
    `_local_bytes`)."""
    total = 0
    for a, pl in zip(leaves(args), leaves(shardings)):
        shape = _shape(a)
        parts = list(pl.spec) + [None] * (len(shape) - len(pl.spec))
        n = 1
        for dim, part in zip(shape, parts):
            k = 1
            for ax in entry_axes(part):
                k *= pl.mesh.shape[ax]
            n *= -(-dim // k)
        total += n * members(a)[0].element_size()
    return total


def members_of(tree) -> list:
    """Every tensor of `tree` (a Stacked's members apart; host ints
    dropped)."""
    return [t for leaf in leaves(tree) for t in members(leaf)
            if isinstance(t, torch.Tensor)]


def tensor_bytes(tensors) -> int:
    """The bytes of `tensors`, each tensor once."""
    seen = {id(t): t for t in tensors}
    return sum(t.numel() * t.element_size() for t in seen.values())


def placed_cell(arch: str, shape_name: str, mesh, *, device=META,
                accum_steps: int = 1,
                cfg: Optional[ModelConfig] = None,
                policy: Optional[str] = None, force_sp: bool = False,
                shape: Optional[ShapeConfig] = None):
    """(cell, its arguments as this rank holds them), in a world of the
    mesh's size (none for one device).  The cell's LM is on `device`,
    drawn from seed 0 (nothing is drawn on the meta device): a train
    cell's whole, a serve cell's slices (`LM(..., shardings=)`).  A train
    cell's arguments are `adamw_init`'s state over the parameters placed
    by `in_shardings` and the batch; a serve cell's the model's own
    weights, its cache (above) and its inputs.  The inputs are drawn on
    the host from seed 0 (empty on the meta device) and placed by
    `in_shardings`."""
    device = torch.device(device)
    kw = dict(accum_steps=accum_steps, policy=policy, force_sp=force_sp,
              shape=shape)
    spec = specs.build_cell(arch, shape_name, mesh, cfg=cfg, **kw)
    cfg, rules = spec.meta["cfg"], spec.meta["rules"]
    train = spec.shape.kind == "train"
    model = LM(cfg, device=device, seed=0, shardings=None if train else
               param_shardings(rules, LM(cfg, device=META).param_tree(),
                               serve=True))
    cell = specs.build_cell(arch, shape_name, mesh, model=model, **kw)
    gen = torch.Generator().manual_seed(0)

    def draw(t):
        if device.type == "meta":
            return torch.empty(t.shape, dtype=t.dtype, device=META)
        if t.dtype == torch.int32:
            x = torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                              dtype=torch.int32)
        else:
            x = torch.randn(t.shape, generator=gen).to(t.dtype)
        return x.to(device)

    def inputs(k: int):
        return reshard(tree_map(draw, cell.args[k]), cell.in_shardings[k])
    if train:
        params = reshard(model.param_tree(),
                         cell.in_shardings[0]["params"])
        return cell, ({"params": params, "opt": adamw_init(params)},
                      inputs(1))
    tokens = tuple(inputs(k) for k in range(2, len(cell.args)))
    with activation_sharding(rules, serve=not force_sp):
        cache = model.init_cache(tokens[0].shape[0], cell.shape.seq_len)
    cache["pos"] = cell.shape.seq_len - 1 if cell.shape.kind == "decode" \
        else 0
    return cell, (model.param_tree(), specs.stacked_cache(cfg, cache)) \
        + tokens


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             accum_steps: int = 1, *, cfg: Optional[ModelConfig] = None,
             policy: Optional[str] = None, force_sp: bool = False,
             shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[Sequence[int]] = None,
             rank: int = 0) -> dict:
    """The record of one cell on the production mesh (`mesh_shape`: a
    ("data", "model") mesh of those sizes instead), run as `rank`."""
    if mesh_shape is None:
        base = make_production_mesh(multi_pod=multi_pod)
        sizes, names = base.sizes, base.axis_names
    else:
        sizes, names = tuple(mesh_shape), ("data", "model")
    n_dev = int(np.prod(sizes))
    with fake_world(n_dev, rank):
        mesh = make_mesh(sizes, names, [META] * n_dev)
        cell, args = placed_cell(arch, shape_name, mesh,
                                 accum_steps=accum_steps, cfg=cfg,
                                 policy=policy, force_sp=force_sp,
                                 shape=shape)
        model = cell.meta["model"]
        held = members_of(args)
        mt = MemTracker()
        mt.track_external(*held, model)
        resident = mt.get_tracker_snapshot("current")[META]["Total"]
        calls0, bytes0 = comm.STATS["calls"], comm.STATS["bytes"]
        fc = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with comm.record() as calls, fc, mt:
            cell.fn(*args)
        trace_s = time.perf_counter() - t0
        peak_snap = mt.get_tracker_snapshot("peak")[META]
    cfg = cell.meta["cfg"]
    flops_dev = float(fc.get_total_flops())
    colls = [cost.Collective(c.op, c.nbytes, len(c.ranks), 1, "step",
                             c.ranks) for c in calls]
    csum = cost.collective_summary(colls)
    ana = cell_flops(cfg, cell.shape)
    arg_analytic = local_bytes(cell.args, cell.in_shardings)
    peak = int(peak_snap["Total"])
    temp = peak - int(resident)
    hbm_dev = 2.0 * arg_analytic + float(temp)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in sizes),
        "n_devices": n_dev,
        "rank": rank,
        "status": "ok",
        "trace_s": trace_s,
        "arg_bytes_per_dev": tensor_bytes(held),
        "resident_bytes_per_dev": int(resident),
        "temp_bytes_per_dev": temp,
        "peak_bytes_per_dev": peak,
        "peak_by_kind": {str(k.value if hasattr(k, "value") else k): int(v)
                         for k, v in peak_snap.items() if k != "Total"},
        "arg_bytes_analytic": int(arg_analytic),
        "fits_80gb": bool(peak < cost.HBM_PER_CARD),
        "collectives": {k: (round(v, 1) if isinstance(v, float) else v)
                        for k, v in csum.items()},
        "n_hlo_collectives": len(colls),
        "comm_calls": comm.STATS["calls"] - calls0,
        "comm_bytes": comm.STATS["bytes"] - bytes0,
        "calls": [[c.op, c.nbytes, list(c.ranks)] for c in calls],
        "hlo_flops_per_dev": flops_dev,
        "hbm_bytes_per_dev_est": hbm_dev,
        "policy": cell.meta["policy"],
        "analytic": ana,
        "model_flops_ratio": (ana["model_flops"]
                              / max(flops_dev * n_dev, 1.0)),
        "roofline": cost.roofline_terms(flops_dev, hbm_dev,
                                        csum["nvlink_wire_bytes"],
                                        csum["network_wire_bytes"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else configs.ARCH_NAMES
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records}

    def save():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)

    for arch in archs:
        for shape_name in shapes:
            ok, why = specs.cell_is_applicable(arch, shape_name)
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                if (arch, shape_name, mesh_name) in done:
                    continue
                if not ok:
                    records.append({"arch": arch, "shape": shape_name,
                                    "mesh": mesh_name, "status": "skipped",
                                    "reason": why})
                    print(f"SKIP {arch} {shape_name} {mesh_name}: {why}")
                    save()
                    continue
                try:
                    rec = run_cell(arch, shape_name, mp)
                    print(f"OK   {arch:22s} {shape_name:12s} {mesh_name:8s} "
                          f"trace={rec['trace_s']:7.1f}s "
                          f"peak={rec['peak_bytes_per_dev']/2**30:6.2f}GiB "
                          f"fits={rec['fits_80gb']} "
                          f"wire={rec['collectives']['total_wire_bytes']/2**20:10.1f}MiB")
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"FAIL {arch} {shape_name} {mesh_name}: {e}")
                records.append(rec)
                save()

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors -> {args.out}")
    return 0 if n_err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
