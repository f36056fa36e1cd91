from repro_torch.algorithms.base import Algorithm, PLUS_TIMES, MIN_PLUS
from repro_torch.algorithms.pagerank import (PageRank, PersonalizedPageRank,
                                             Katz)
from repro_torch.algorithms.sssp import SSSP, BFS, WCC

__all__ = [
    "Algorithm", "PLUS_TIMES", "MIN_PLUS",
    "PageRank", "PersonalizedPageRank", "Katz",
    "SSSP", "BFS", "WCC",
]
