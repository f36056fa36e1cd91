"""The plain reference the benchmark holds the program's answers to, and
its lower-precision control (numpy and scipy only: nothing of the program
and nothing it made).

  plus-times (PageRank, PPR)  float64 power iteration of
                              x = (1 - d) s + d P^T x, P[u, v] = w_uv /
                              outdeg(u) (s = 1 for PageRank, the unit
                              vector at the source for PPR), to an L1
                              change under 1e-13 of |x|_1
  min-plus (SSSP)             scipy's Dijkstra in float64 over the weights
  min-plus, unit (BFS)        the same over unit weights

The control is the same arithmetic with its state held in bfloat16 (the
nearest precision below the float32 the configuration states): each
iterate of the power iteration is rounded to bfloat16, and each path sum
of a Bellman-Ford relaxation.

Comparison (`gap`): an answer by its largest gap against the reference
over the reference's largest finite value; a vertex that one side
reaches and the other does not makes the gap infinite.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

PLUS, MIN, MIN_UNIT = "plus_times", "min_plus", "min_plus_unit"

#: the power iteration's stop: L1 change under this share of |x|_1
REF_TOL = 1e-13
MAX_ITER = 2000
#: the control's cap: a bfloat16 iterate stalls or cycles near the fixpoint
MAX_ITER_BF16 = 400


def to_bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return r.astype(np.uint32).view(np.float32).astype(np.float64)


def transition_t(csr) -> sp.csr_matrix:
    """P^T in float64: entry (v, u) = w_uv / outdeg(u)."""
    src, dst, w = csr.edges()
    deg = np.maximum(csr.out_degree, 1).astype(np.float64)
    vals = w.astype(np.float64) / deg[src]
    return sp.csr_matrix((vals, (dst, src)), shape=(csr.n, csr.n))


def restart_columns(n: int, sources) -> np.ndarray:
    """[n, k] restart vectors: ones for None (PageRank), else the unit
    vector at the source (PPR)."""
    s = np.zeros((n, len(sources)))
    for i, src in enumerate(sources):
        if src is None:
            s[:, i] = 1.0
        else:
            s[src, i] = 1.0
    return s


def plus_times(csr, damping: float, sources, *, bf16: bool = False,
               pt=None) -> np.ndarray:
    """[n, k] fixpoints for `sources` (None = PageRank), each column
    stopped on its own; `bf16` rounds every iterate (the control)."""
    pt = transition_t(csr) if pt is None else pt
    s = (1.0 - damping) * restart_columns(csr.n, sources)
    x = to_bf16(s) if bf16 else s.copy()
    live = np.ones(x.shape[1], dtype=bool)
    for _ in range(MAX_ITER_BF16 if bf16 else MAX_ITER):
        if not live.any():
            break
        cols = np.flatnonzero(live)
        y = pt @ x[:, cols]
        if bf16:
            nxt = to_bf16(s[:, cols] + to_bf16(damping * to_bf16(y)))
        else:
            nxt = s[:, cols] + damping * y
        change = np.abs(nxt - x[:, cols]).sum(axis=0)
        norm = np.maximum(1.0, np.abs(x[:, cols]).sum(axis=0))
        x[:, cols] = nxt
        live[cols[change < REF_TOL * norm]] = False
        if bf16:   # a rounded iterate can settle into a two-cycle
            live[cols[change == 0]] = False
    return x


def _weights(csr, unit: bool) -> np.ndarray:
    return (np.ones(csr.nnz) if unit
            else csr.weights.astype(np.float64))


def min_plus(csr, sources, *, unit: bool = False) -> np.ndarray:
    """[k, n] float64 shortest distances (inf where unreachable), over
    unit weights with `unit`."""
    a = sp.csr_matrix((_weights(csr, unit), csr.indices, csr.indptr),
                      shape=(csr.n, csr.n))
    return np.atleast_2d(dijkstra(a, directed=True, indices=list(sources)))


def min_plus_bf16(csr, sources, *, unit: bool = False) -> np.ndarray:
    """[k, n] Bellman-Ford distances with every path sum rounded to
    bfloat16 (the control)."""
    src, dst, _ = csr.edges()
    w = _weights(csr, unit)
    order = np.argsort(dst, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    heads = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]])
    out = np.full((len(sources), csr.n), np.inf)
    for i, s in enumerate(sources):
        d = np.full(csr.n, np.inf)
        d[s] = 0.0
        while True:
            cand = np.minimum.reduceat(to_bf16(d[src] + w), heads)
            nd = d.copy()
            nd[dst[heads]] = np.minimum(d[dst[heads]], cand)
            if np.array_equal(nd, d):
                break
            d = nd
        out[i] = d
    return out


def gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| over the largest finite |want|; inf where one
    side is finite and the other is not."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    fin = np.isfinite(want)
    if not np.array_equal(fin, np.isfinite(got)):
        return float("inf")
    diff = np.abs(got[fin] - want[fin]).max(initial=0.0)
    if diff == 0.0:
        return 0.0
    return float(diff / np.abs(want[fin]).max())


def solve(view: str, csr, damping: float, sources, *,
          bf16: bool = False) -> list:
    """One answer ([n] float64) per source of `view` (None: PageRank);
    `bf16` gives the control's."""
    if view == PLUS:
        x = plus_times(csr, damping, sources, bf16=bf16)
        return [x[:, i] for i in range(len(sources))]
    fn = min_plus_bf16 if bf16 else min_plus
    return list(fn(csr, sources, unit=view == MIN_UNIT))
