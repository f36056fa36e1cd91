"""Hill-climbing: re-run one cell's dry run under a named variant (one
hypothesis each) and record its roofline terms beside the baseline's (the
reference's `repro.launch.hillclimb`).

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch minicpm-2b --shape train_4k --variant accum2

A variant that the port cannot run is recorded as `launch.dryrun`
records a failed cell (status "error"): `full_sp`'s serve cell outside a
serve context raises where the "tp" rules split the weights
(`launch.specs.build_cell`'s `force_sp`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

from repro_torch import configs
from repro_torch.launch import dryrun as DR
from repro_torch.models.config import SHAPES


# named variants: cfg/cell overrides implementing one hypothesis each
def variant_overrides(name: str, cfg):
    """Returns (new_cfg, build_kwargs)."""
    if name == "baseline":
        return cfg, {}
    if name == "accum2":
        # hypothesis: halving the microbatch halves live remat residuals
        # (memory term) at <2% collective cost (same grads, one extra loop)
        return cfg, {"accum_steps": 2}
    if name == "accum4":
        return cfg, {"accum_steps": 4}
    if name == "policy_tp":
        return cfg, {"policy": "tp"}
    if name == "policy_dp":
        return cfg, {"policy": "dp"}
    if name == "kv_chunk_2k":
        # hypothesis: larger kv chunks cut per-chunk overheads in prefill
        return dataclasses.replace(cfg, kv_chunk=2048), {}
    if name == "q_chunk_1k":
        return dataclasses.replace(cfg, q_chunk=1024, kv_chunk=2048), {}
    if name == "q_chunk_2k":
        return dataclasses.replace(cfg, q_chunk=2048, kv_chunk=4096), {}
    if name == "q_chunk_4k":
        return dataclasses.replace(cfg, q_chunk=4096, kv_chunk=8192), {}
    if name == "bf16_reduce":
        # hypothesis: TP partial sums all-reduced in the float32
        # accumulation dtype; bf16 halves those wire bytes
        return dataclasses.replace(cfg, reduce_dtype="bfloat16"), {}
    if name == "qkv_sp":
        # hypothesis: uniform seq-sharded q/k/v keeps attention chunk math
        # shard-local; collectives collapse to one k/v gather per layer
        return dataclasses.replace(cfg, qkv_spec="sp"), {}
    if name == "full_sp":
        # hypothesis: with seq-sharded carries too the whole prefill is
        # sequence-resident (weights gathered FSDP-style, activations local)
        return dataclasses.replace(cfg, qkv_spec="sp"), {"force_sp": True}
    if name == "no_remat":
        # hypothesis: decode/prefill don't backprop; remat only pays off in
        # training
        return dataclasses.replace(cfg, remat=False), {}
    if name == "unroll_layers":
        return dataclasses.replace(cfg, scan_layers=False), {}
    if name == "dense_expert":
        # hypothesis (decode): at tiny token counts, computing ALL experts
        # densely (E x overcompute on a trivial FLOP budget) eliminates the
        # dispatch machinery; weights are read either way
        return dataclasses.replace(cfg, capacity_factor=float(
            cfg.n_experts) / max(cfg.top_k, 1)), {}
    raise ValueError(name)


def run(arch: str, shape: str, variant: str, multi_pod: bool = False) -> dict:
    cfg, kwargs = variant_overrides(variant, configs.get(arch))
    try:
        rec = DR.run_cell(arch, shape, multi_pod, cfg=cfg, **kwargs)
    except Exception as e:  # noqa: BLE001 - recorded as dryrun records it
        rec = {"arch": arch, "shape": shape,
               "mesh": "2x16x16" if multi_pod else "16x16",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    rec["variant"] = variant
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--variant", required=True)
    ap.add_argument("--out", default="experiments/hillclimb_torch.json")
    args = ap.parse_args(argv)

    rec = run(args.arch, args.shape, args.variant)
    if rec["status"] == "ok":
        t = rec["roofline"]
        print(f"{args.arch} {args.shape} [{args.variant}]  "
              f"compute={t['compute_s']*1e3:.1f}ms "
              f"memory={t['memory_s']*1e3:.1f}ms "
              f"collective={t['collective_s']*1e3:.1f}ms "
              f"dominant={t['dominant']} "
              f"peak={rec['peak_bytes_per_dev']/2**30:.1f}GiB "
              f"wire={rec['collectives']['total_wire_bytes']/2**30:.2f}GiB")
    else:
        print(f"{args.arch} {args.shape} [{args.variant}]  FAIL "
              f"{rec['error']}")
    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    records.append(rec)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    return 0 if rec["status"] == "ok" else 1


if __name__ == "__main__":
    raise SystemExit(main())
