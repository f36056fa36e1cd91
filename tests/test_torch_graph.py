"""Parity of the port's graph substrate (repro_torch.graph) with repro.graph.

Same numpy-seeded inputs through both packages: generator CSRs are byte
equal, block-ELL layouts and destination-sorted block pairs equal field by
field (the port's extra `run_start` agrees with first/last), and the port
package stands alone — importing it and running a tiny CPU session loads
neither jax nor repro.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as rg  # noqa: E402
import repro_torch.graph as tg  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


GENERATORS = [
    ("rmat_graph", (150,), dict(avg_degree=4, seed=13)),
    ("rmat_graph", (1000,), dict(avg_degree=8, seed=0, weighted=True)),
    ("uniform_graph", (150,), dict(avg_degree=4, seed=21, weighted=True,
                                   w_max=7.0)),
    ("uniform_graph", (300,), dict(avg_degree=3, seed=2)),
    ("chain_graph", (64,), dict(seed=1, weighted=True)),
    ("grid_graph", (12,), dict(seed=3)),
    ("grid_graph", (9,), dict(seed=4, weighted=True)),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_byte_equal(name, args, kw):
    a = getattr(rg, name)(*args, **kw)
    b = getattr(tg, name)(*args, **kw)
    assert a.n == b.n
    for f in ("indptr", "indices", "weights"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        assert x.tobytes() == y.tobytes()


def test_csr_helpers_match():
    a = rg.uniform_graph(120, 4, seed=5, weighted=True)
    b = tg.uniform_graph(120, 4, seed=5, weighted=True)
    sa, sb = a.symmetrized(), b.symmetrized()
    assert sa.indptr.tobytes() == sb.indptr.tobytes()
    assert sa.weights.tobytes() == sb.weights.tobytes()
    for u in (0, 7, 119):
        for x, y in zip(a.row(u), b.row(u)):
            np.testing.assert_array_equal(x, y)
        for v in range(0, 120, 13):
            assert a.edge_weight(u, v) == b.edge_weight(u, v)
    empty = tg.CSRGraph.from_edges(10, [], [])
    assert empty.nnz == 0 and empty.indptr.tolist() == [0] * 11
    with pytest.raises(ValueError):
        tg.CSRGraph.from_edges(4, [0, 5], [1, 2])


@pytest.mark.parametrize("normalize", [None, "out_degree", "unit", "zero"])
@pytest.mark.parametrize("fill", [0.0, float("inf")])
def test_build_blocked_equal(fill, normalize):
    csr_r = rg.rmat_graph(200, 4, seed=7, weighted=True)
    csr_t = tg.rmat_graph(200, 4, seed=7, weighted=True)
    a = rg.build_blocked(csr_r, 16, fill=fill, normalize=normalize)
    b = tg.build_blocked(csr_t, 16, fill=fill, normalize=normalize,
                         device="cpu")
    assert (a.n_real, a.block_size, a.num_blocks, a.max_nbr_blocks,
            a.fill) == (b.n_real, b.block_size, b.num_blocks,
                        b.max_nbr_blocks, b.fill)
    for f in ("nbr_ids", "nbr_mask", "tiles", "vertex_mask"):
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


def test_build_blocked_rejects_unknown_normalize():
    with pytest.raises(ValueError):
        tg.build_blocked(tg.chain_graph(8), 4, normalize="bogus",
                         device="cpu")


def _pair_fields_equal(a, b):
    assert (a.num_pairs, a.block_size, a.num_blocks) == (
        b.num_pairs, b.block_size, b.num_blocks)
    for f in ("src", "dst", "slot", "first", "last", "src_nnz",
              "dst_touched", "tiles"):
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    first, rs = _np(b.first), _np(b.run_start)
    assert rs.dtype == np.int32 and rs[0] == 0 and rs[-1] == b.num_pairs
    np.testing.assert_array_equal(rs[:-1], np.flatnonzero(first))
    # every run ends at a `last` flag and covers one destination block
    last, dst = _np(b.last), _np(b.dst)
    np.testing.assert_array_equal(rs[1:] - 1, np.flatnonzero(last))
    for r0, r1 in zip(rs[:-1], rs[1:]):
        assert (dst[r0:r1] == dst[r0]).all()


@pytest.mark.parametrize("case", ["plus", "min", "dense", "grid"])
def test_build_block_pairs_equal(case):
    if case == "plus":
        csr_r, csr_t = (m.rmat_graph(150, 4, seed=13) for m in (rg, tg))
        kw = dict(fill=0.0, normalize="out_degree")
    elif case == "min":
        csr_r, csr_t = (m.uniform_graph(150, 4, seed=13, weighted=True,
                                        w_max=7.0) for m in (rg, tg))
        kw = dict(fill=float("inf"))
    elif case == "dense":
        csr_r, csr_t = (m.rmat_graph(100, 6, seed=2) for m in (rg, tg))
        kw = dict(fill=0.0, normalize="out_degree")
    else:
        csr_r, csr_t = (m.grid_graph(10, seed=1) for m in (rg, tg))
        kw = dict(fill=float("inf"), normalize="unit")
    a = rg.build_block_pairs(rg.build_blocked(csr_r, 16, **kw))
    b = tg.build_block_pairs(tg.build_blocked(csr_t, 16, device="cpu",
                                              **kw))
    _pair_fields_equal(a, b)
    assert (a.dense_op is None) == (b.dense_op is None)
    if case == "dense":
        assert b.dense_op is not None
    if b.dense_op is not None:
        np.testing.assert_array_equal(_np(a.dense_op), _np(b.dense_op))


@pytest.mark.parametrize("fill", [0.0, float("inf")])
def test_edgeless_pad_pair_equal(fill):
    csr_r = rg.CSRGraph.from_edges(40, [], [])
    csr_t = tg.CSRGraph.from_edges(40, [], [])
    a = rg.build_block_pairs(rg.build_blocked(csr_r, 16, fill=fill))
    b = tg.build_block_pairs(tg.build_blocked(csr_t, 16, fill=fill,
                                              device="cpu"))
    _pair_fields_equal(a, b)
    assert b.num_pairs == 1 and b.num_runs == 1
    assert not _np(b.dst_touched).any()


def test_empty_overlay_matches():
    a, b = rg.empty_overlay(5), tg.empty_overlay(5, device="cpu")
    assert a.capacity == b.capacity == 0
    for f in ("src_u", "dst", "w", "mask"):
        assert _np(getattr(a, f)).shape == _np(getattr(b, f)).shape


def test_port_imports_neither_jax_nor_repro():
    """Importing the port and running a tiny CPU session leaves jax and
    repro out of sys.modules (a fresh interpreter)."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert\n"
        "from repro_torch.graph import rmat_graph\n"
        "from repro_torch.algorithms import PageRank, SSSP\n"
        "from repro_torch.core import GraphSession, TwoLevel\n"
        "s = GraphSession(rmat_graph(64, 3, seed=1), 16, device='cpu')\n"
        "s.submit(PageRank()); s.submit(SSSP(source=2))\n"
        "assert s.run(TwoLevel(), 5000).converged\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {r for r in _imported_roots(f)} & {"jax", "jaxlib", "repro"}
        assert not bad, f"{f}: imports {bad}"


# -- a session's view: pair tiles built alone, ELL tiles on demand -------------


def _graph500(scale):
    """A Graph500 draw (the benchmark's generator, graphbench/graph.py) as
    the port's CSR; None draws the edgeless graph."""
    if scale is None:
        return tg.CSRGraph.from_edges(200, [], [])
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from graphbench.graph import graph500
    c = graph500(dict(scale=scale, edgefactor=16, a=0.57, b=0.19, c=0.19),
                 np.random.default_rng(2))
    return tg.CSRGraph.from_edges(c.n, *c.edges())


VIEW_GRAPHS = [(9, 8), (10, 64), (11, 512), (None, 64)]
VIEW_KEYS = [(0.0, "out_degree"), (float("inf"), None),
             (float("inf"), "unit")]


@pytest.mark.parametrize("fill,normalize", VIEW_KEYS)
@pytest.mark.parametrize("scale,vb", VIEW_GRAPHS)
def test_view_pairs_equal_pairs_of_the_ell_build(scale, vb, fill,
                                                 normalize):
    """`build_view`'s pair view, built from the block adjacency, equals
    `build_block_pairs(build_blocked(...))` field by field and tile by
    tile (its dense operator too), and no ELL tiles are made."""
    csr = _graph500(scale)
    kw = dict(fill=fill, normalize=normalize, device="cpu")
    want = tg.build_block_pairs(tg.build_blocked(csr, vb, **kw))
    g, got = tg.build_view(csr, vb, **kw)
    assert g.ell is None and g.ell_bytes == 0
    _pair_fields_equal(got, want)
    for f in ("run_start", "chunk_start", "chunk_run"):
        x, y = _np(getattr(got, f)), _np(getattr(want, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    assert (got.dense_op is None) == (want.dense_op is None)
    if want.dense_op is not None:
        np.testing.assert_array_equal(_np(got.dense_op), _np(want.dense_op))
    if scale == 9 and fill == 0.0:
        assert got.dense_op is not None       # the dense operator's path
    if scale is None:
        assert got.num_pairs == 1 and not _np(got.dst_touched).any()


@pytest.mark.parametrize("fill,normalize", VIEW_KEYS)
@pytest.mark.parametrize("scale,vb", VIEW_GRAPHS)
def test_view_ell_on_demand_equals_build_blocked(scale, vb, fill,
                                                 normalize):
    """A view's ELL tiles, built on first use from its pair view, equal
    `build_blocked`'s; its metadata equals it before any build; the
    tiles then stay with the view."""
    csr = _graph500(scale)
    kw = dict(fill=fill, normalize=normalize, device="cpu")
    want = tg.build_blocked(csr, vb, **kw)
    g, _ = tg.build_view(csr, vb, **kw)
    for f in ("n_real", "block_size", "num_blocks", "max_nbr_blocks",
              "fill"):
        assert getattr(g, f) == getattr(want, f), f
    for f in ("nbr_ids", "nbr_mask", "vertex_mask"):
        x, y = _np(getattr(g, f)), _np(getattr(want, f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)
    assert g.ell is None
    tiles = g.tiles
    assert tiles.dtype == torch.float32 and tiles.is_contiguous()
    np.testing.assert_array_equal(_np(tiles), _np(want.tiles))
    assert g.tiles is tiles and g.ell is tiles
    assert g.ell_bytes == want.tiles.numel() * 4


@pytest.mark.parametrize("shards", [1, 4])
def test_view_shard_rows_on_demand_equal_the_whole_build(shards):
    """`build_view_shard`'s ELL rows, left unbuilt, equal the whole
    build's rows when asked for: from its pair view with one shard,
    from the adjacency with several."""
    csr = _graph500(10)
    kw = dict(fill=0.0, normalize="out_degree", device="cpu")
    whole = tg.build_blocked(csr, 32, **kw)
    b_loc = whole.num_blocks // shards
    for s in range(shards):
        g, _, _ = tg.structure.build_view_shard(csr, 32, shards, s, **kw)
        assert g.ell is None
        np.testing.assert_array_equal(
            _np(g.tiles), _np(whole.tiles[s * b_loc:(s + 1) * b_loc]))
        np.testing.assert_array_equal(
            _np(g.nbr_ids), _np(whole.nbr_ids[s * b_loc:(s + 1) * b_loc]))


def test_view_without_a_way_to_build_ell_says_so():
    g, _ = tg.build_view(_graph500(9), 8, device="cpu")
    g.build_ell = None
    with pytest.raises(RuntimeError, match="no ELL tiles"):
        g.tiles
