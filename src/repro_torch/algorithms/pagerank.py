"""PLUS_TIMES family: PageRank / PPR / Katz in delta-accumulative form.

Paper Eq. 3:   P^k = P^{k-1} + dP^k ;   dP^{k+1}_j = sum_i d * dP^k_i / |N(i)|

With tiles normalized by out-degree, one push of block b is
  contrib[dst] = push_scale * (delta[b] @ tile[b, k])
and the pushed delta folds into values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.algorithms.base import Algorithm, PLUS_TIMES, _blocked_full
from repro_torch.graph.structure import BlockedGraph


@dataclasses.dataclass(frozen=True)
class PageRank(Algorithm):
    name: str = "pagerank"
    semiring: str = PLUS_TIMES
    damping: float = 0.85
    tolerance: float = 1e-6
    graph_normalize: str | None = "out_degree"

    def get_push_scale(self) -> float:
        return self.damping

    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        values = _blocked_full(g, 0.0)
        deltas = torch.where(g.vertex_mask, 1.0 - self.damping, 0.0)
        return values, deltas.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class PersonalizedPageRank(Algorithm):
    """PPR from a single source vertex (rooted random walk with restart)."""

    name: str = "ppr"
    semiring: str = PLUS_TIMES
    damping: float = 0.85
    source: int = 0
    tolerance: float = 1e-7
    graph_normalize: str | None = "out_degree"

    def get_push_scale(self) -> float:
        return self.damping

    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        values = _blocked_full(g, 0.0)
        deltas = _blocked_full(g, 0.0)
        b, u = divmod(self.source, g.block_size)
        deltas[b, u] = 1.0 - self.damping
        return values, deltas


@dataclasses.dataclass(frozen=True)
class Katz(Algorithm):
    """Katz centrality: c = sum_k alpha^k (A^T)^k beta."""

    name: str = "katz"
    semiring: str = PLUS_TIMES
    alpha: float = 0.05
    beta: float = 1.0
    tolerance: float = 1e-6
    graph_normalize: str | None = None  # raw adjacency

    def get_push_scale(self) -> float:
        return self.alpha

    def init(self, g: BlockedGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        values = _blocked_full(g, 0.0)
        deltas = torch.where(g.vertex_mask, self.beta, 0.0)
        return values, deltas.to(torch.float32)
