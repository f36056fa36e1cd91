"""MIN_PLUS family: SSSP / BFS / WCC in delta (frontier) form.

State: values = best distance (or best label for WCC); deltas = pending
distance (finite only where the vertex improved since it was last pushed).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.algorithms.base import Algorithm, MIN_PLUS, _blocked_full
from repro_torch.graph.structure import BlockedGraph


@dataclasses.dataclass(frozen=True)
class SSSP(Algorithm):
    name: str = "sssp"
    semiring: str = MIN_PLUS
    source: int = 0
    graph_fill: float = float("inf")
    graph_normalize: str | None = None

    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        values = _blocked_full(g, float("inf"))
        deltas = _blocked_full(g, float("inf"))
        b, u = divmod(self.source, g.block_size)
        values[b, u] = 0.0
        deltas[b, u] = 0.0
        return values, deltas


@dataclasses.dataclass(frozen=True)
class BFS(SSSP):
    """Hop distance: SSSP over unit weights."""

    name: str = "bfs"
    graph_normalize: str | None = "unit"


@dataclasses.dataclass(frozen=True)
class WCC(Algorithm):
    """Weakly connected components = min-label propagation over the
    symmetrized graph with 0-weight edges; label(v) converges to the minimum
    vertex id in v's component."""

    name: str = "wcc"
    semiring: str = MIN_PLUS
    graph_fill: float = float("inf")
    graph_normalize: str | None = "zero"
    graph_symmetrize: bool = True

    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        ids = torch.arange(g.n_padded, dtype=torch.float32,
                           device=g.device).reshape(g.num_blocks,
                                                    g.block_size)
        ids = torch.where(g.vertex_mask, ids, float("inf"))
        return ids, ids.clone()

    def vertex_priority(self, values, deltas):
        # every pending vertex counts equally; labels are not magnitudes
        return torch.where(torch.isfinite(deltas), 1.0, 0.0)
