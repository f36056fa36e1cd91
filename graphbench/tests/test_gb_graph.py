"""The benchmark's Graph500 graph: its R-MAT draw against the program's
generator byte for byte, the Graph500 steps on top of it, and the CSR
the program is handed."""

import numpy as np
import pytest

from graphbench.graph import (csr_from_edges, graph500, rmat_draw,
                              search_keys)

CFG = dict(scale=9, edgefactor=16, a=0.57, b=0.19, c=0.19)


@pytest.mark.parametrize("scale,edgefactor,seed", [
    (8, 4, 0), (10, 16, 7), (11, 8, 2 ** 31 + 5), (9, 16, 2 ** 63 + 11)])
def test_rmat_draw_matches_the_program_byte_for_byte(scale, edgefactor,
                                                     seed):
    from repro_torch.graph import rmat_graph
    want = rmat_graph(2 ** scale, edgefactor, seed=seed)
    n, src, dst = rmat_draw(scale, edgefactor, a=0.57, b=0.19, c=0.19,
                            rng=np.random.default_rng(seed))
    # what rmat_graph adds to the draw: self loops dropped, and a ring
    # edge (u, u + 1 mod n) for a vertex left without an out-edge
    keep = src != dst
    src, dst = src[keep], dst[keep]
    lonely = np.flatnonzero(np.bincount(src, minlength=n) == 0)
    src = np.concatenate([src, lonely])
    dst = np.concatenate([dst, (lonely + 1) % n])
    got = csr_from_edges(n, src, dst, np.ones(len(src), np.float32))
    assert got.n == want.n
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.weights, want.weights)):
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


def test_csr_matches_from_edges_with_duplicates():
    from repro_torch.graph.structure import CSRGraph
    rng = np.random.default_rng(3)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    w = rng.random(400).astype(np.float32)
    got = csr_from_edges(50, src, dst, w)
    want = CSRGraph.from_edges(50, src, dst, w)
    for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.weights, want.weights)):
        assert a.tobytes() == b.tobytes()


def test_graph500_is_undirected_simple_and_weighted():
    g = graph500(CFG, np.random.default_rng(5))
    src, dst, w = g.edges()
    assert (src != dst).all()
    fwd = dict(zip(zip(src.tolist(), dst.tolist()), w.tolist()))
    assert all(fwd[(d, s)] == x for (s, d), x in fwd.items())
    assert len(fwd) == g.nnz   # no edge twice
    assert (w >= 0).all() and (w < 1).all() and len(np.unique(w)) > g.nnz // 4
    keys = search_keys(g)
    assert (g.out_degree[keys] > 0).all()
    assert len(keys) < g.n   # isolated vertices stay in the graph


def test_graph500_permutes_the_labels():
    # unpermuted, R-MAT piles the degree on the low labels (a = 0.57)
    n, src, _ = rmat_draw(CFG["scale"], CFG["edgefactor"], a=0.57, b=0.19,
                          c=0.19, rng=np.random.default_rng(5))
    raw = np.bincount(src, minlength=n)
    g = graph500(CFG, np.random.default_rng(5))
    half = g.n // 2
    assert raw[:half].sum() > 2 * raw[half:].sum()
    deg = g.out_degree
    assert 0.8 < deg[:half].sum() / deg[half:].sum() < 1.25


def test_graph_handed_to_the_program_is_the_same():
    from repro_torch.graph.structure import CSRGraph
    csr = graph500(CFG, np.random.default_rng(2 ** 40 + 1))
    port = CSRGraph.from_edges(csr.n, *csr.edges())
    assert port.indptr.tobytes() == csr.indptr.tobytes()
    assert port.indices.tobytes() == csr.indices.tobytes()
    assert port.weights.tobytes() == csr.weights.tobytes()


def test_graph_depends_on_its_seed_alone():
    a = graph500(CFG, np.random.default_rng(1))
    b = graph500(CFG, np.random.default_rng(1))
    c = graph500(CFG, np.random.default_rng(2))
    assert a.indices.tobytes() == b.indices.tobytes()
    assert a.weights.tobytes() == b.weights.tobytes()
    assert a.indices.tobytes() != c.indices.tobytes()
