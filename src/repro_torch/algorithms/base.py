"""Delta-based accumulative iterative algorithms (PrIter / paper Eq. 3).

Two semirings cover the paper's algorithm families:

  PLUS_TIMES : v <- v + delta;   new_delta[dst] += push_scale * delta[src] * w
               (PageRank, PPR, Katz, ...)
  MIN_PLUS   : v <- min(v, cand);  cand[dst] = min_src(delta[src] + w)
               (SSSP, BFS, connected components via 0-weight label prop)

State is blocked to match `BlockedGraph`: values [B_N, Vb] and deltas
[B_N, Vb] float32 tensors per job (the session adds a job axis).  For
MIN_PLUS, `deltas` holds the pending-propagation distance and +inf when
nothing is pending.  Vertex priority is POSITIVE with 0 == converged
(min-plus uses the monotone transform 1/(1+dist)).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.graph.structure import BlockedGraph

PLUS_TIMES = "plus_times"
MIN_PLUS = "min_plus"

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Algorithm:
    """Base class; subclasses override init/vertex_priority as needed."""

    name: str = "abstract"
    semiring: str = PLUS_TIMES
    tolerance: float = 1e-6     # |delta| < tol  ==> vertex converged (plus-times)

    def get_push_scale(self) -> float:
        """Multiplies deltas before the push (PageRank damping, Katz alpha)."""
        return 1.0

    # ---- state -------------------------------------------------------------
    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    # graph build parameters this algorithm requires
    graph_fill: float = 0.0
    graph_normalize: str | None = None
    graph_symmetrize: bool = False

    # ---- priority ----------------------------------------------------------
    def vertex_priority(self, values: torch.Tensor,
                        deltas: torch.Tensor) -> torch.Tensor:
        """Positive priority per vertex; exactly 0 for converged vertices."""
        if self.semiring == PLUS_TIMES:
            p = deltas.abs()
            return torch.where(p >= self.tolerance, p, 0.0)
        # MIN_PLUS: pending vertices carry finite delta
        return torch.where(torch.isfinite(deltas), 1.0 / (1.0 + deltas), 0.0)

    def unconverged(self, values: torch.Tensor,
                    deltas: torch.Tensor) -> torch.Tensor:
        if self.semiring == PLUS_TIMES:
            return deltas.abs() >= self.tolerance
        return torch.isfinite(deltas)

    # ---- final extraction ----------------------------------------------------
    def result(self, values: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
        """Algorithm result per vertex (values plus any unfolded deltas)."""
        if self.semiring == PLUS_TIMES:
            return values + deltas
        return values


def _blocked_full(g: BlockedGraph, value: float) -> torch.Tensor:
    return torch.full((g.num_blocks, g.block_size), value,
                      dtype=torch.float32, device=g.device)
