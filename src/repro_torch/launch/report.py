"""Markdown tables of a dry run's records (the reference's
`repro.launch.report`), retargeted to the H100: the peak is the meta
device's (`launch.dryrun`), "fits" reads against the card's 80 GB
(`cost.HBM_PER_CARD`), and the collective term is split by link.

  PYTHONPATH=src python -m repro_torch.launch.report experiments/dryrun_torch.json
prints markdown to stdout.
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch import cost


def gib(x) -> str:
    return f"{x / 2**30:.2f}"


def fmt_s(x) -> str:
    if x >= 0.1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def dryrun_table(records) -> str:
    out = ["| arch | shape | mesh | policy | trace | arg GiB/dev "
           "(analytic) | peak GiB/dev (meta) | fits 80 GB | wire GiB/dev "
           "(NVLink / network) |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                       f"skip | — | — | n/a | — |")
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | "
                       f"ERROR | — | — | — | — |")
            continue
        c = r["collectives"]
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['policy']} | "
            f"{r['trace_s']:.0f}s | {gib(r['arg_bytes_analytic'])} | "
            f"{gib(r['peak_bytes_per_dev'])} | "
            f"{'Y' if r['fits_80gb'] else 'N'} | "
            f"{gib(c['nvlink_wire_bytes'])} / "
            f"{gib(c['network_wire_bytes'])} |")
    return "\n".join(out)


def recompute_terms(r) -> dict:
    """Terms from stored fields (memory model: 2x analytic args + temp)."""
    hbm = 2.0 * r["arg_bytes_analytic"] + r["temp_bytes_per_dev"]
    c = r["collectives"]
    return cost.roofline_terms(r["hlo_flops_per_dev"], hbm,
                               c["nvlink_wire_bytes"],
                               c["network_wire_bytes"])


def roofline_table(records) -> str:
    out = ["| arch | shape | compute | memory | collective (NVLink + "
           "network) | dominant | MODEL/counted | roofline-frac |",
           "|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["status"] != "ok" or r["mesh"] != "16x16":
            continue
        t = recompute_terms(r)
        bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
        frac = t["compute_s"] / bound if bound else 0.0
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['compute_s'])} | "
            f"{fmt_s(t['memory_s'])} | {fmt_s(t['collective_s'])} "
            f"({fmt_s(t['nvlink_s'])} + {fmt_s(t['network_s'])}) | "
            f"**{t['dominant']}** | {r['model_flops_ratio']:.2f} | "
            f"{frac:.2f} |")
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        "experiments/dryrun_torch.json"
    with open(path) as f:
        records = json.load(f)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = len(records) - n_ok - n_skip
    print(f"## Dry-run ({n_ok} ok / {n_skip} skipped-documented / "
          f"{n_err} errors)\n")
    print(dryrun_table(records))
    print("\n## Roofline (single-pod 16x16; per-device terms at the H100's "
          "published rates)\n")
    print(roofline_table(records))


if __name__ == "__main__":
    main()
