"""Collective and roofline accounting of a dry run (the port's side of
`repro/launch/hlo_analysis.py`).

The reference reads XLA's compiled HLO text: it splits it into
computations, finds the loop trip counts, and parses the dots, the
collectives and the bytes of each op (`_computation_blocks`,
`parse_dot_flops`, `estimate_hbm_bytes`, `parse_collectives`).  The port
compiles nothing, so that half has no counterpart here: a dry run
(`launch.dryrun`) runs the step itself and counts what it does
(`torch.utils.flop_counter`, `dist.comm.record`).  This module keeps the
accounting half: `Collective` and its ring wire bytes, formula for
formula; `collective_summary`, with the same keys; and `roofline_terms`,
retargeted from the reference's TPU v5e to the NVIDIA H100.

The figures are published ones, not measured: one H100 80GB HBM3 (SXM,
700 W power limit) computes 989.4 TFLOP/s dense bf16 and reads its HBM
at 3.35 TB/s (NVIDIA's data sheet).  `HBM_PER_CARD` is the card's memory
as torch reports it (`torch.cuda.get_device_properties(0).total_memory`
of an H100 80GB HBM3).  The reference's one link rate (`ICI_BW`) becomes
two, those of an assumed DGX H100 cluster: eight GPUs a node joined by
NVLink 4 at 450 GB/s a direction a GPU, and one 400 Gb/s NIC a GPU (50
GB/s) between nodes.  A collective whose group stays within one node
(global ranks r // 8 all equal: 8 consecutive ranks) runs over NVLink;
any other over the network.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

PEAK_FLOPS = 989.4e12       # dense bf16 a card (H100 SXM, 700 W)
HBM_BW = 3.35e12            # bytes/s a card
HBM_PER_CARD = 85_017_493_504   # total_memory of an H100 80GB HBM3
NODE_SIZE = 8               # GPUs a node (DGX H100)
NVLINK_BW = 450e9           # bytes/s a GPU a direction (NVLink 4)
NETWORK_BW = 50e9           # bytes/s a GPU (one 400 Gb/s NIC)


def within_node(ranks) -> bool:
    """Whether global `ranks` all sit in one node of NODE_SIZE."""
    return len({r // NODE_SIZE for r in ranks}) <= 1


@dataclasses.dataclass
class Collective:
    op: str
    tensor_bytes: int      # the op's output on one device
    group_size: int
    multiplier: int        # times the op runs
    computation: str
    ranks: Tuple[int, ...] = ()   # the group's global ranks

    @property
    def wire_bytes_per_device(self) -> float:
        """Ring-algorithm bytes crossing each device's links, per op.

        tensor_bytes is the op's OUTPUT on one device:
          all-gather:      out = full gathered  -> wire = b*(g-1)/g
          all-reduce:      out = local buffer   -> wire = 2*b*(g-1)/g
          reduce-scatter:  out = 1/g shard      -> wire = b*(g-1)
          all-to-all:      out = local buffer   -> wire = b*(g-1)/g
          collective-permute (and any other op): one hop -> wire = b
        """
        g = max(self.group_size, 1)
        b = self.tensor_bytes
        if self.op == "all-reduce":
            return 2.0 * b * (g - 1) / g
        if self.op == "all-gather":
            return b * (g - 1) / g
        if self.op == "reduce-scatter":
            return float(b) * (g - 1)
        if self.op == "all-to-all":
            return b * (g - 1) / g
        return float(b)

    @property
    def link(self) -> str:
        """"nvlink" within a node, else "network"."""
        return "nvlink" if within_node(self.ranks) else "network"


def collective_summary(colls: List[Collective]) -> Dict[str, float]:
    """Wire bytes a device by op, their total and the op count (the
    reference's keys), and the total split by link."""
    by_op: Dict[str, float] = {}
    by_link = {"nvlink": 0.0, "network": 0.0}
    total = 0.0
    for c in colls:
        wire = c.wire_bytes_per_device * c.multiplier
        by_op[c.op] = by_op.get(c.op, 0.0) + wire
        by_link[c.link] += wire
        total += wire
    by_op["total_wire_bytes"] = total
    by_op["n_ops"] = float(len(colls))
    by_op["nvlink_wire_bytes"] = by_link["nvlink"]
    by_op["network_wire_bytes"] = by_link["network"]
    return by_op


def fused_live_bytes(semiring: str, j: int, bn: int, bn_loc: int, vb: int,
                     n_pairs: int, n_live: int, n_src: int, runs: int,
                     chunks: int) -> int:
    """Least bytes one fused superstep call (B1 plus-times, B2 min-plus)
    moves on a selection, each read or written once: the tiles of the
    `n_live` live pairs (source selected) and the d rows of their
    `n_src` distinct sources, src of all `n_pairs` pairs, the run and
    chunk tables, the [B_N] mask and the [J, B_loc] state (base and out;
    min-plus values and its out too) with its (node_un, p_sum)."""
    states = 2 if semiring == "plus_times" else 4
    return (4 * n_live * vb * vb + 4 * j * n_src * vb
            + 4 * (n_pairs + runs + 1 + 2 * chunks + 1) + bn
            + 4 * j * bn_loc * vb * states + 4 * 2 * j * bn_loc)


def fused_live_flops(j: int, n_live: int, vb: int) -> float:
    """The FLOPs of the same call: a [Vb] row times a [Vb, Vb] tile for
    every job and live pair."""
    return 2.0 * j * n_live * vb * vb


def roofline_terms(flops_per_dev: float, hbm_bytes_per_dev: float,
                   nvlink_wire_bytes: float,
                   network_wire_bytes: float = 0.0) -> Dict[str, float]:
    """Seconds a device needs for its FLOPs at PEAK_FLOPS, its HBM bytes
    at HBM_BW and its wire bytes at each link's rate (all per-device
    quantities); `collective_s` is the two links' sum."""
    compute_s = flops_per_dev / PEAK_FLOPS
    memory_s = hbm_bytes_per_dev / HBM_BW
    nvlink_s = nvlink_wire_bytes / NVLINK_BW
    network_s = network_wire_bytes / NETWORK_BW
    collective_s = nvlink_s + network_s
    dominant = max(("compute", compute_s), ("memory", memory_s),
                   ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "nvlink_s": nvlink_s,
        "network_s": network_s,
        "dominant": dominant,
    }
