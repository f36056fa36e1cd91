"""Deterministic graph generators (host-side numpy).

Copied from the reference (`repro.graph.generators`): the same seed gives
the same CSR byte for byte.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import CSRGraph


def _finish(n: int, src: np.ndarray, dst: np.ndarray, rng: np.random.Generator,
            weighted: bool, w_max: float) -> CSRGraph:
    # drop self loops
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # guarantee no dangling vertices (every vertex has >=1 out-edge): append
    # a ring edge for any vertex with out-degree 0
    deg = np.bincount(src, minlength=n)
    lonely = np.nonzero(deg == 0)[0]
    if len(lonely):
        src = np.concatenate([src, lonely])
        dst = np.concatenate([dst, (lonely + 1) % n])
    if weighted:
        w = rng.uniform(1.0, w_max, size=len(src)).astype(np.float32)
    else:
        w = np.ones(len(src), dtype=np.float32)
    return CSRGraph.from_edges(n, src.astype(np.int64), dst.astype(np.int64), w)


def rmat_graph(n: int, avg_degree: int = 8, *, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               weighted: bool = False, w_max: float = 10.0) -> CSRGraph:
    """R-MAT power-law generator (Chakrabarti et al.); n rounded up to 2^k."""
    rng = np.random.default_rng(seed)
    levels = int(np.ceil(np.log2(max(n, 2))))
    m = n * avg_degree
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for lvl in range(levels):
        r = rng.random(m)
        go_b = (r >= a) & (r < a + b)
        go_c = (r >= a + b) & (r < a + b + c)
        go_d = r >= a + b + c
        src += ((go_c | go_d) << lvl)
        dst += ((go_b | go_d) << lvl)
    keep = (src < n) & (dst < n)
    return _finish(n, src[keep], dst[keep], rng, weighted, w_max)


def uniform_graph(n: int, avg_degree: int = 8, *, seed: int = 0,
                  weighted: bool = False, w_max: float = 10.0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return _finish(n, src, dst, rng, weighted, w_max)


def chain_graph(n: int, *, weighted: bool = False, w_max: float = 10.0,
                seed: int = 0) -> CSRGraph:
    """Directed ring 0->1->...->n-1->0 (worst case for prioritized iteration)."""
    rng = np.random.default_rng(seed)
    src = np.arange(n, dtype=np.int64)
    dst = (src + 1) % n
    return _finish(n, src, dst, rng, weighted, w_max)


def mutation_stream(csr: CSRGraph, n_batches: int, *,
                    inserts_per_batch: int = 8, deletes_per_batch: int = 4,
                    seed: int = 0, weighted: bool = False,
                    w_max: float = 10.0):
    """Deterministic edge-update stream for evolving-graph workloads.

    Each batch mixes PREFERENTIAL-ATTACHMENT inserts (destination sampled
    proportionally to current in-degree + 1, source uniform — the organic
    growth model of social/web graphs, which keeps feeding the hub blocks
    the two-level scheduler already prioritizes) with UNIFORM deletes of
    existing edges.  The stream is degree-safe: a source's last out-edge
    is never deleted (no vertex goes dangling, keeping out-degree
    normalized plus-times views well defined), self-loops are skipped,
    and an insert that collides with an existing edge becomes a reweight.
    Batches evolve the edge set as they are generated, so batch k+1
    mutates the graph AS LEFT by batch k.

    Returns a list of `repro_torch.stream.UpdateBatch` (apply in order).
    """
    from repro_torch.stream.updates import UpdateBatch, _edge_dict

    rng = np.random.default_rng(seed)
    n = csr.n
    edges = _edge_dict(csr)
    out_deg = np.diff(csr.indptr).astype(np.int64)
    in_deg = np.bincount(csr.indices, minlength=n).astype(np.int64)

    batches = []
    for _ in range(n_batches):
        ins_s, ins_d, ins_w = [], [], []
        for _ in range(inserts_per_batch):
            p = (in_deg + 1) / float((in_deg + 1).sum())
            for _attempt in range(8):
                u = int(rng.integers(n))
                v = int(rng.choice(n, p=p))
                if u != v:
                    break
            else:
                continue
            w = float(rng.uniform(1.0, w_max)) if weighted else 1.0
            ins_s.append(u)
            ins_d.append(v)
            ins_w.append(w)
            if (u, v) not in edges:
                out_deg[u] += 1
                in_deg[v] += 1
            edges[(u, v)] = w
        del_s, del_d = [], []
        if edges and deletes_per_batch:
            keys = sorted(edges)
            order = rng.permutation(len(keys))
            for i in order:
                if len(del_s) >= deletes_per_batch:
                    break
                u, v = keys[i]
                if out_deg[u] <= 1 or (u, v) not in edges:
                    continue            # never orphan a source vertex
                del edges[(u, v)]
                out_deg[u] -= 1
                in_deg[v] -= 1
                del_s.append(u)
                del_d.append(v)
        batches.append(UpdateBatch.concat([
            UpdateBatch.inserts(np.asarray(ins_s, np.int64),
                                np.asarray(ins_d, np.int64),
                                np.asarray(ins_w, np.float32)),
            UpdateBatch.deletes(np.asarray(del_s, np.int64),
                                np.asarray(del_d, np.int64))]))
    return batches


def grid_graph(side: int, *, weighted: bool = False, w_max: float = 10.0,
               seed: int = 0) -> CSRGraph:
    """side x side 4-neighbour grid, edges in +x/+y and -x/-y directions."""
    rng = np.random.default_rng(seed)
    n = side * side
    ids = np.arange(n).reshape(side, side)
    srcs, dsts = [], []
    for (dy, dx) in ((0, 1), (1, 0), (0, -1), (-1, 0)):
        ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        ny, nx_ = ys + dy, xs + dx
        ok = (ny >= 0) & (ny < side) & (nx_ >= 0) & (nx_ < side)
        srcs.append(ids[ys[ok], xs[ok]])
        dsts.append(ids[ny[ok], nx_[ok]])
    return _finish(n, np.concatenate(srcs), np.concatenate(dsts), rng,
                   weighted, w_max)
