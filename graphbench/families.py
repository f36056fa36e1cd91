"""Job families a traffic mix may name, and the program's algorithm for
each.  A family's parameters (damping, tolerance) come from the
configuration, so no run can converge faster by loosening them.

  pagerank  global PageRank (no source), plus-times over the out-degree
            normalized weights
  ppr       personalized PageRank from a source vertex, the same view
  sssp      single-source shortest paths, min-plus over the weights
  bfs       hop distance from a source vertex, min-plus over unit weights

Each family's view is the program's view key for its algorithm: jobs of
one view share its tiles and its job slots.
"""

from __future__ import annotations

from graphbench.reference import MIN, MIN_UNIT, PLUS

#: family -> (view, whether a job draws a source vertex)
FAMILIES = {
    "pagerank": (PLUS, False),
    "ppr": (PLUS, True),
    "sssp": (MIN, True),
    "bfs": (MIN_UNIT, True),
}


def algorithm(family: str, cfg: dict, source):
    """The program's Algorithm for one job of `family`."""
    from repro_torch.algorithms import (BFS, SSSP, PageRank,
                                        PersonalizedPageRank)
    if family == "pagerank":
        return PageRank(damping=cfg["damping"],
                        tolerance=cfg["pagerank_tolerance"])
    if family == "ppr":
        return PersonalizedPageRank(damping=cfg["damping"],
                                    tolerance=cfg["ppr_tolerance"],
                                    source=int(source))
    if family == "sssp":
        return SSSP(source=int(source))
    if family == "bfs":
        return BFS(source=int(source))
    raise ValueError(f"unknown job family {family!r}")
