"""The benchmark's own graph: Graph500's Kronecker (R-MAT) graph, made from
the run's seed (numpy only; nothing of the program is imported here).

`rmat_draw` is a frozen copy of the draw in the program's
`repro_torch.graph.rmat_graph` (a CPU test holds the two byte for byte).
`graph500` follows the Graph500 specification from that draw: vertex
labels permuted, edge weights uniform in [0, 1), the edge list read as
undirected.  `csr_from_edges` dedups as
`repro_torch.graph.CSRGraph.from_edges` does (a duplicate keeps its
smallest weight).  The benchmark makes its CSR here, hands the same
arrays to the program, and hands them to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Csr:
    """Out-edge CSR: row u holds u's destinations in ascending order."""

    n: int
    indptr: np.ndarray    # [n + 1] int64
    indices: np.ndarray   # [nnz] int32
    weights: np.ndarray   # [nnz] float32

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def edges(self):
        """(src int64, dst int64, weight float32), in CSR order."""
        src = np.repeat(np.arange(self.n, dtype=np.int64), self.out_degree)
        return src, self.indices.astype(np.int64), self.weights


def rmat_draw(scale: int, edgefactor: int, *, a: float, b: float,
              c: float, rng):
    """2**scale vertices and 2**scale * edgefactor R-MAT draws (Kronecker
    initiator [[a, b], [c, 1-a-b-c]], one bit of source and destination
    a level), as (n, src int64, dst int64)."""
    n = 2 ** scale
    m = n * edgefactor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for lvl in range(scale):
        r = rng.random(m)
        go_b = (r >= a) & (r < a + b)
        go_c = (r >= a + b) & (r < a + b + c)
        go_d = r >= a + b + c
        src += ((go_c | go_d) << lvl)
        dst += ((go_b | go_d) << lvl)
    return n, src, dst


def csr_from_edges(n: int, src, dst, weights) -> Csr:
    """Dedup (src, dst), keeping the smallest weight, into a CSR."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    key = src * n + dst
    order = np.lexsort((weights, key))
    key, src, dst, weights = key[order], src[order], dst[order], weights[order]
    keep = np.ones(len(key), dtype=bool)
    keep[1:] = key[1:] != key[:-1]
    src, dst, weights = src[keep], dst[keep], weights[keep]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    return Csr(n=n, indptr=indptr, indices=dst.astype(np.int32),
               weights=weights.astype(np.float32))


def graph500(cfg: dict, rng) -> Csr:
    """The configuration's Graph500 graph, drawn from `rng`: the R-MAT
    draw, a random permutation of the vertex labels, a weight a draw
    (uniform in [0, 1), drawn in float64 and stored in float32), and each
    undirected edge as both of its directions.  Self loops are dropped,
    and of an edge drawn more than once the lightest draw stands, in both
    directions (Graph500's kernels ignore both)."""
    n, src, dst = rmat_draw(cfg["scale"], cfg["edgefactor"], a=cfg["a"],
                            b=cfg["b"], c=cfg["c"], rng=rng)
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    w = rng.random(len(src)).astype(np.float32)
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    return csr_from_edges(n, np.concatenate([src, dst]),
                          np.concatenate([dst, src]),
                          np.concatenate([w, w]))


def search_keys(csr: Csr) -> np.ndarray:
    """The vertices a job may start from: those with an edge, as
    Graph500 draws its search keys."""
    return np.flatnonzero(csr.out_degree > 0)
