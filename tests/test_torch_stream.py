"""Parity of the port's evolving-graph path (repro_torch.stream) with
repro.stream, on the CPU.

The reference's graphs at Vb = 32: uniform_graph(300, 5, seed=8),
uniform_graph(200, 5, seed=9, weighted=True, w_max=9.0) and
chain_graph(256).  Bars: CSRs, update batches, tiles, overlay arrays,
host mirrors, dirty boosts, StreamStats and min-plus state bit-equal to
the reference; plus-times deltas after an update at rtol 1e-6, atol
1e-7; converged plus-times results at the session tolerance, rtol 1e-4,
atol 1e-6.

`apply_updates` is compared on identical inputs: the port converges the
jobs, the reference takes that state and any earlier batches, and the
port then starts from the reference's mid-stream state through
`convert` (graph, job state, overlay and mirrors), so both packages
absorb the same batch from the same bits.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.algorithms as ra  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.core.push as rpush  # noqa: E402
import repro.graph as rg  # noqa: E402
import repro.stream as rs  # noqa: E402
from repro.graph.structure import TileOverlay as RefOverlay  # noqa: E402
from repro.obs import trace as rtrace  # noqa: E402
import repro_torch.algorithms as ta  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.push as tpush  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.graph.structure import TileOverlay  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402

VB = 32
GRAPHS = {
    "uniform": ("uniform_graph", (300, 5), dict(seed=8)),
    "weighted": ("uniform_graph", (200, 5),
                 dict(seed=9, weighted=True, w_max=9.0)),
    "chain": ("chain_graph", (256,), {}),
}
PKG = {"ref": (rc, ra, rg, rs, {}),
       "port": (tc, ta, tg, ts, {"device": "cpu"})}


def _csr(pkg, graph):
    name, args, kw = GRAPHS[graph]
    return getattr(PKG[pkg][2], name)(*args, **kw)


def _algs(pkg, specs):
    """Algorithms of `pkg` from [(class name, kwargs dict or pairs)]."""
    return [getattr(PKG[pkg][1], name)(**dict(kw)) for name, kw in specs]


def _batch(pkg, ops):
    """An UpdateBatch of `pkg` from [("ins", src, dst[, w]) | ("del",
    src, dst)] in order."""
    ub = PKG[pkg][3].UpdateBatch
    return ub.concat([ub.inserts(*op[1:]) if op[0] == "ins"
                      else ub.deletes(*op[1:]) for op in ops])


def _same_csr(t, r):
    assert t.n == r.n
    for f in ("indptr", "indices", "weights"):
        a, b = getattr(t, f), getattr(r, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _same_batch(t, r):
    for f in ("src", "dst", "w", "op"):
        a, b = getattr(t, f), getattr(r, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def _edges(csr, idx):
    """(src, dst) of the CSR's edges at flat positions `idx`."""
    src = np.repeat(np.arange(csr.n), np.diff(csr.indptr))
    idx = np.asarray(idx)
    return src[idx], csr.indices[idx]


# -- updates.py and mutation_stream ------------------------------------------


@pytest.mark.parametrize("case", ["upsert_delete_in_order",
                                  "delete_then_insert_keeps_min"])
def test_apply_to_csr_matches_reference(case):
    """tests/test_stream.py:86-108 in both packages: ordered upserts and
    deletes, an absent delete, then delete-then-insert with in-batch
    duplicate inserts keeping the minimum weight."""
    ops = [[("ins", [0, 2], [3, 0], [1.5, 4.0]), ("ins", [0], [1], [9.0]),
            ("del", [1], [2]), ("del", [3], [0])]]
    if case == "delete_then_insert_keeps_min":
        ops.append([("del", [0], [1]), ("ins", [0, 0], [1, 1], [5.0, 4.0])])
    got = {}
    for pkg in PKG:
        g = PKG[pkg][2].CSRGraph.from_edges(4, [0, 1], [1, 2], [2.0, 3.0])
        for o in ops:
            b = _batch(pkg, o)
            g = PKG[pkg][3].apply_to_csr(g, b)
        got[pkg] = (g, b)
        with pytest.raises(ValueError):
            PKG[pkg][3].apply_to_csr(g, _batch(pkg, [("ins", [0], [99])]))
        with pytest.raises(ValueError, match="ragged"):
            PKG[pkg][3].UpdateBatch([0], [1, 2], [1.0], [0])
    _same_csr(got["port"][0], got["ref"][0])
    _same_batch(got["port"][1], got["ref"][1])
    assert got["port"][0].edge_weight(0, 1) == (
        4.0 if case == "delete_then_insert_keeps_min" else 9.0)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_mutation_stream_and_apply_to_csr_match_reference(graph):
    """The same CSR and seed give byte-equal batches, and applying them in
    order gives byte-equal CSRs, batch after batch."""
    kw = dict(inserts_per_batch=7, deletes_per_batch=4, seed=3,
              weighted=graph == "weighted", w_max=9.0)
    csr = {pkg: _csr(pkg, graph) for pkg in PKG}
    streams = {pkg: PKG[pkg][2].mutation_stream(csr[pkg], 3, **kw)
               for pkg in PKG}
    assert len(streams["port"]) == 3
    for bt, br in zip(streams["port"], streams["ref"]):
        _same_batch(bt, br)
        assert bt.num_inserts == br.num_inserts > 0
        assert bt.num_deletes == br.num_deletes > 0
        csr = {pkg: PKG[pkg][3].apply_to_csr(csr[pkg], b)
               for pkg, b in (("port", bt), ("ref", br))}
        _same_csr(csr["port"], csr["ref"])


# -- the overlay push and the plus-times correction --------------------------


def _overlay_case(rng, semiring, bn=6, vb=8, cap=5, j=3):
    """An overlay whose selected rows send many entries to the same few
    destinations, and state for both semirings."""
    src_u = rng.integers(0, vb, (bn, cap)).astype(np.int32)
    dst = (rng.integers(0, 3, (bn, cap)) * vb
           + rng.integers(0, 2, (bn, cap))).astype(np.int32)
    w = rng.uniform(0.5, 4.0, (bn, cap)).astype(np.float32)
    mask = (rng.random((bn, cap)) < 0.8).astype(np.float32)
    sel = np.array([3, 0, 5, 1], np.int32)
    vals = rng.uniform(0.0, 9.0, (j, bn, vb)).astype(np.float32)
    deltas = rng.uniform(0.0, 1.0, (j, bn, vb)).astype(np.float32)
    d_sel = rng.uniform(0.0, 3.0, (j, len(sel), vb)).astype(np.float32)
    if semiring == "min_plus":
        deltas[rng.random(deltas.shape) < 0.5] = np.inf
        d_sel[rng.random(d_sel.shape) < 0.3] = np.inf
    live = dst[sel][mask[sel] > 0]
    assert len(np.unique(live)) < len(live)     # repeated destinations
    return (src_u, dst, w, mask), sel, vals, deltas, d_sel


@pytest.mark.parametrize("jobs", ["one_job", "job_axis"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_overlay_push_sums_and_mins_repeated_destinations(semiring, jobs):
    """overlay_push_plus / overlay_push_min on rows whose entries share
    destinations: every entry counts, as with the reference's
    `.at[].add` / `.at[].min` (an indexed `+=` would keep one per
    destination).  Min-plus bit-equal, plus-times at rtol 1e-6."""
    rng = np.random.default_rng(5 if semiring == "plus_times" else 6)
    arrs, sel, vals, deltas, d_sel = _overlay_case(rng, semiring)
    rov = RefOverlay(arrs[0].shape[1], *map(jnp.asarray, arrs))
    tov = TileOverlay(arrs[0].shape[1], *map(torch.from_numpy, arrs))
    want = []
    for j in range(vals.shape[0]):
        if semiring == "plus_times":
            want.append((vals[j], np.asarray(rpush.overlay_push_plus(
                jnp.asarray(deltas[j]), jnp.asarray(d_sel[j]), rov,
                jnp.asarray(sel)))))
        else:
            v, d = rpush.overlay_push_min(
                jnp.asarray(vals[j]), jnp.asarray(deltas[j]),
                jnp.asarray(d_sel[j]), rov, jnp.asarray(sel))
            want.append((np.asarray(v), np.asarray(d)))
    t = torch.from_numpy
    if jobs == "one_job":
        got = []
        for j in range(vals.shape[0]):
            if semiring == "plus_times":
                got.append((t(vals[j]), tpush.overlay_push_plus(
                    t(deltas[j]), t(d_sel[j]), tov, t(sel))))
            else:
                got.append(tpush.overlay_push_min(
                    t(vals[j]), t(deltas[j]), t(d_sel[j]), tov, t(sel)))
    elif semiring == "plus_times":
        d = tpush.overlay_push_plus(t(deltas), t(d_sel), tov, t(sel))
        got = [(t(vals[j]), d[j]) for j in range(vals.shape[0])]
    else:
        v, d = tpush.overlay_push_min(t(vals), t(deltas), t(d_sel), tov,
                                      t(sel))
        got = list(zip(v, d))
    for (gv, gd), (wv, wd) in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), wv)
        if semiring == "plus_times":
            np.testing.assert_allclose(gd.numpy(), wd, rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(gd.numpy(), wd)
    if semiring == "plus_times":     # the sum really landed
        assert not np.array_equal(got[0][1].numpy(), deltas[0])


def test_adjust_plus_times_sums_repeated_destinations():
    """adjust_plus_times: dst_idx repeats whenever two sources feed one
    vertex, and those terms sum (rtol 1e-6, atol 1e-7)."""
    rng = np.random.default_rng(7)
    values = rng.uniform(0.0, 2.0, (3, 4, 8)).astype(np.float32)
    deltas = rng.uniform(-1.0, 1.0, (3, 4, 8)).astype(np.float32)
    scale = np.array([0.85, 0.5, 1.0], np.float32)
    u_idx = rng.integers(0, 32, 40)
    dst_idx = rng.integers(0, 6, 40)             # six distinct targets
    dw = rng.uniform(-0.5, 0.5, 40).astype(np.float32)
    rg_ = types.SimpleNamespace(values=jnp.asarray(values),
                                deltas=jnp.asarray(deltas),
                                push_scale=jnp.asarray(scale))
    tg_ = types.SimpleNamespace(values=torch.from_numpy(values),
                                deltas=torch.from_numpy(deltas.copy()),
                                push_scale=torch.from_numpy(scale))
    rs.adjust_plus_times(rg_, u_idx, dst_idx, dw)
    ts.adjust_plus_times(tg_, u_idx, dst_idx, dw)
    np.testing.assert_allclose(tg_.deltas.numpy(), np.asarray(rg_.deltas),
                               rtol=1e-6, atol=1e-7)


# -- apply_updates on identical sessions --------------------------------------


def _src_dst(graph, idx):
    return [a.tolist() for a in _edges(_csr("port", graph), idx)]


# case -> (graph, job specs, overlay_capacity, earlier batches, the batch,
#          supersteps the port runs first: None = to convergence)
CASES = {
    "pagerank_degree_rescale": (
        "uniform", [("PageRank", {}), ("PersonalizedPageRank",
                                       dict(source=7))], 32, [],
        [("ins", [7, 7, 100], [33, 231, 5]),
         ("del", *_src_dst("uniform", [10, 120]))], None),
    "pagerank_overlay_rescale": (
        "chain", [("PageRank", {})], 4, [[("ins", [5], [200])]],
        [("ins", [5], [100]), ("del", [10], [11]), ("ins", [33], [40])], 12),
    "katz_weighted_reweight": (
        "weighted", [("Katz", dict(alpha=0.01))], 32, [],
        [("ins", *_src_dst("weighted", [3, 40]), [0.25, 8.0]),
         ("del", *_src_dst("weighted", [80])), ("ins", [5], [190], [2.0])],
        None),
    "katz_symmetrized_full_reseed": (
        "chain", [("Katz", dict(alpha=0.02, graph_symmetrize=True))], 4, [],
        [("ins", [5], [200]), ("del", [10], [11])], 10),
    "sssp_insert_fast_path": (
        "weighted", [("SSSP", dict(source=0))], 32, [],
        [("ins", [0, 3], [150, 77], [0.5, 0.25])], None),
    "sssp_delete_support_reseed": (
        "weighted", [("SSSP", dict(source=0)), ("SSSP", dict(source=17))],
        32, [], [("del", *_src_dst("weighted", [2, 18, 33, 55, 72, 81]))],
        None),  # edges that alone support a shortest distance
    "overlay_slot_reclaimed_in_batch": (
        "chain", [("SSSP", dict(source=0))], 1, [[("ins", [5], [200])]],
        [("del", [5], [200]), ("ins", [6], [210])], None),
    "overlay_overflow_compacts": (
        "chain", [("SSSP", dict(source=0)), ("PageRank", {})], 2, [],
        [("ins", [1, 2, 3], [100, 150, 200])], 20),
    "wcc_delete_splits_component": (
        "chain", [("WCC", {})], 32, [], [("del", [10, 50], [11, 51])],
        None),
}


def _np(x):
    return np.asarray(x)


def _from_port_state_to_mid_stream(case):
    """(ref, port) sessions holding the same mid-stream state: the port
    converges the jobs, the reference takes that state and the earlier
    batches, the port takes the reference's state through `convert`."""
    graph, specs, cap, earlier, _, steps = CASES[case]
    kw = dict(capacity=2, seed=0, overlay_capacity=cap)
    p0 = tc.GraphSession(_csr("port", graph), VB, device="cpu", **kw)
    for a in _algs("port", specs):
        p0.submit(a)
    p0.run(tc.TwoLevel(), steps or 50000)
    ref = rc.GraphSession(_csr("ref", graph), VB, **kw)
    for a in _algs("ref", specs):
        ref.submit(a)
    for gp, gr in zip(p0.view_groups(), ref.view_groups()):
        gr.values = jnp.asarray(gp.values.numpy())
        gr.deltas = jnp.asarray(gp.deltas.numpy())
    for ops in earlier:
        ref.apply_updates(_batch("ref", ops))
    c = ref._csr
    port = tc.GraphSession(
        convert.csr_from_arrays(c.n, c.indptr, c.indices, c.weights), VB,
        device="cpu", **kw)
    for a in _algs("port", specs):
        port.submit(a)
    for gr in ref.view_groups():
        g, ov = gr.graph, gr.overlay
        convert.load_group_state(port, gr.key, _np(gr.values),
                                 _np(gr.deltas), _np(gr.push_scale),
                                 gr.active)
        convert.load_overlay(
            port, gr.key, ov.capacity, _np(ov.src_u), _np(ov.dst),
            _np(ov.w), _np(ov.mask), gr.ov_used, gr.ov_entry,
            graph=convert.blocked_from_arrays(
                g.n_real, g.block_size, g.num_blocks, g.max_nbr_blocks,
                g.fill, _np(g.nbr_ids), _np(g.nbr_mask), _np(g.tiles),
                _np(g.vertex_mask), device="cpu"))
    port._dirty_boost = (None if ref._dirty_boost is None
                         else ref._dirty_boost.copy())
    port._stream_pending = dict(ref._stream_pending)
    return ref, port


def _same_structure(gp, gr):
    for f in ("tiles", "nbr_ids", "nbr_mask"):
        np.testing.assert_array_equal(getattr(gp.graph, f).numpy(),
                                      _np(getattr(gr.graph, f)))
    assert gp.graph.max_nbr_blocks == gr.graph.max_nbr_blocks
    assert gp.overlay.capacity == gr.overlay.capacity
    for f in ("src_u", "dst", "w", "mask"):
        a, b = getattr(gp.overlay, f).numpy(), _np(getattr(gr.overlay, f))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert gp.ov_entry == gr.ov_entry
    if gr.ov_used is None:
        assert gp.ov_used is None
    else:
        np.testing.assert_array_equal(gp.ov_used, gr.ov_used)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_updates_matches_reference(case):
    """One apply_updates on identical sessions: the CSR, tiles, overlay
    arrays, ov_entry, ov_used, the dirty boost, StreamStats and the
    min-plus values and deltas bit-equal; plus-times deltas at rtol
    1e-6, atol 1e-7.  Every batch drops the cached pair view."""
    ref, port = _from_port_state_to_mid_stream(case)
    for g in port.view_groups():
        port._pair_data(g)                 # a pair view the batch must drop
    ops = CASES[case][4]
    st_r = ref.apply_updates(_batch("ref", ops))
    st_p = port.apply_updates(_batch("port", ops))
    assert dataclasses.asdict(st_p) == dataclasses.asdict(st_r)
    _same_csr(port._csr, ref._csr)
    np.testing.assert_array_equal(port._dirty_boost, ref._dirty_boost)
    assert port._stream_pending == ref._stream_pending
    for gp, gr in zip(port.view_groups(), ref.view_groups()):
        assert gp.pairs is None
        _same_structure(gp, gr)
        np.testing.assert_array_equal(gp.values.numpy(), _np(gr.values))
        if gr.semiring == "min_plus":
            np.testing.assert_array_equal(gp.deltas.numpy(),
                                          _np(gr.deltas))
        else:
            np.testing.assert_allclose(gp.deltas.numpy(), _np(gr.deltas),
                                       rtol=1e-6, atol=1e-7)
    if case == "overlay_overflow_compacts":
        assert st_p.compacted_views == 2
    if case == "overlay_slot_reclaimed_in_batch":
        assert port.view_groups()[0].ov_entry == {(6, 210): (0, 0)}
    if case in ("sssp_delete_support_reseed",
                "wcc_delete_splits_component"):
        assert st_p.reseed_fraction > 0.0
    if case == "sssp_insert_fast_path":
        assert st_p.reseed_fraction == 0.0


# -- runs to convergence after updates ----------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_fixpoint(graph, specs, stream=None, ops=None):
    """Results of a fresh reference session on the updated CSR (mutation
    stream `stream` = (n_batches, kwargs items), or the batch `ops`)."""
    csr = _csr("ref", graph)
    if stream is not None:
        for b in rg.mutation_stream(csr, stream[0], **dict(stream[1])):
            csr = rs.apply_to_csr(csr, b)
    if ops is not None:
        csr = rs.apply_to_csr(csr, _batch("ref", ops))
    sess = rc.GraphSession(csr, VB, capacity=2, seed=0)
    hs = [sess.submit(a) for a in _algs("ref", specs)]
    assert sess.run(rc.TwoLevel(), 50000).converged
    return tuple(sess.result(h) for h in hs)


def _check(specs, got, want):
    for (name, _), g, w in zip(specs, got, want):
        if name in ("SSSP", "BFS", "WCC"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


POLICIES = {"host": lambda: tc.TwoLevel(),
            "device_k4": lambda: tc.TwoLevel(backend="device",
                                             steps_per_sync=4),
            "fused": lambda: tc.Fused()}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_updates_between_and_during_runs_reach_reference_fixpoint(policy):
    """tests/test_stream.py:114 on the port: batches land mid-run, then a
    run to convergence reaches the reference's fixpoint of the final
    graph (min-plus bit-equal)."""
    specs = (("PageRank", ()), ("SSSP", (("source", 0),)))
    spec_kw = [(n, dict(kw)) for n, kw in specs]
    stream = (2, (("inserts_per_batch", 6), ("deletes_per_batch", 3),
                  ("seed", 3)))
    pol = POLICIES[policy]()
    csr = _csr("port", "uniform")
    sess = tc.GraphSession(csr, VB, capacity=2, seed=0, device="cpu")
    hs = [sess.submit(a) for a in _algs("port", spec_kw)]
    sess.run(pol, max_supersteps=7)
    for b in tg.mutation_stream(csr, stream[0], **dict(stream[1])):
        sess.apply_updates(b)
        sess.run(pol, max_supersteps=5)
    assert sess.run(pol, 50000).converged
    _check(spec_kw, [sess.result(h) for h in hs],
           _ref_fixpoint("uniform", specs, stream=stream))


def test_use_pallas_routes_consume_the_overlay():
    """tests/test_stream.py:382 on the port: the kernel route (its plain
    version here) and the plain routes absorb a structural insert
    through the overlay ride-along; min-plus bit-equal to each other and
    to the reference, plus-times at rtol 1e-5 between the routes."""
    ops = (("ins", (3,), (100,)),)
    csr = tg.chain_graph(128)
    res = {}
    for pallas in (False, True):
        sess = tc.GraphSession(csr, VB, capacity=1, seed=0, device="cpu",
                               use_pallas=pallas)
        hs = [sess.submit(ta.SSSP(source=0)), sess.submit(ta.PageRank())]
        assert sess.run(tc.TwoLevel(), 50000).converged
        sess.apply_updates(_batch("port", ops))
        assert all(g.overlay.capacity > 0 for g in sess.view_groups())
        assert sess.run(tc.TwoLevel(), 50000).converged
        res[pallas] = [sess.result(h) for h in hs]
    np.testing.assert_array_equal(res[True][0], res[False][0])
    np.testing.assert_allclose(res[True][1], res[False][1], rtol=1e-5,
                               atol=1e-7)
    ref = rc.GraphSession(rs.apply_to_csr(rg.chain_graph(128),
                                          _batch("ref", ops)),
                          VB, capacity=1, seed=0)
    hs = [ref.submit(ra.SSSP(source=0)), ref.submit(ra.PageRank())]
    assert ref.run(rc.TwoLevel(), 50000).converged
    np.testing.assert_array_equal(res[True][0], ref.result(hs[0]))
    np.testing.assert_allclose(res[True][1], ref.result(hs[1]), rtol=1e-4,
                               atol=1e-6)


# -- compaction ---------------------------------------------------------------


def test_compaction_equals_fresh_build_and_reference():
    """An overflow compaction, a later overlay insert, then an explicit
    compact(): the port's tiles, neighbour ids and mask and its rebuilt
    BlockPairs equal a fresh port build of the final CSR bit for bit, and
    the reference's compacted arrays; the run afterwards reaches the
    reference's fixpoint."""
    batches = [(("ins", (1, 2, 3), (100, 150, 200)),),
               (("ins", (40,), (230,)),)]
    specs = (("SSSP", (("source", 0),)),)
    sess = {"ref": rc.GraphSession(_csr("ref", "chain"), VB, capacity=1,
                                   seed=0, overlay_capacity=2),
            "port": tc.GraphSession(_csr("port", "chain"), VB, capacity=1,
                                    seed=0, overlay_capacity=2,
                                    device="cpu")}
    h = {pkg: s.submit(_algs(pkg, [("SSSP", dict(source=0))])[0])
         for pkg, s in sess.items()}
    assert sess["port"].run(tc.TwoLevel(), 50000).converged
    stats = [sess["port"].apply_updates(_batch("port", b)) for b in batches]
    for b in batches:
        sess["ref"].apply_updates(_batch("ref", b))
    assert [s.compacted_views for s in stats] == [1, 0]
    grp = sess["port"].view_groups()[0]
    assert grp.overlay.capacity == 2 and grp.ov_entry == {(40, 230): (1, 0)}
    for s in sess.values():
        s.compact()
    gp, gr = sess["port"].view_groups()[0], sess["ref"].view_groups()[0]
    _same_structure(gp, gr)
    assert gp.overlay.capacity == 0 and gp.pair_slot is None
    fresh = tg.build_blocked(sess["port"]._csr, VB, fill=float("inf"),
                             device="cpu")
    for f in ("tiles", "nbr_ids", "nbr_mask"):
        assert torch.equal(getattr(gp.graph, f), getattr(fresh, f)), f
    bp, fb = sess["port"]._pair_data(gp), tg.build_block_pairs(fresh)
    for f in ("src", "dst", "tiles", "run_start", "chunk_start",
              "chunk_run"):
        assert torch.equal(getattr(bp, f), getattr(fb, f)), f
    assert sess["port"].run(tc.TwoLevel(), 50000).converged
    want = _ref_fixpoint("chain", specs, ops=batches[0] + batches[1])
    np.testing.assert_array_equal(sess["port"].result(h["port"]), want[0])


# -- scheduling integration, counters, errors ----------------------------------


class _SpyTwoLevel(tc.TwoLevel):
    """TwoLevel recording the p_mean each superstep's selection sees."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.p_means = []

    def select(self, sess, node_un, p_mean, active):
        self.p_means.append(np.array(p_mean[0]))
        return super().select(sess, node_un, p_mean, active)

    def device_select(self, node_uns, p_means, actives, key, **kw):
        self.p_means.append(p_means[0].clone())
        return super().device_select(node_uns, p_means, actives, key, **kw)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_dirty_boost_reaches_both_drivers_and_is_consumed(backend):
    """After apply_updates the first superstep of the next run sees the
    dirty blocks' P_mean boosted where work pends, and only that one."""
    csr = _csr("port", "uniform")
    sess = tc.GraphSession(csr, VB, capacity=1, seed=0, device="cpu")
    sess.submit(ta.SSSP(source=0))
    kw = {} if backend == "host" else dict(backend="device",
                                            steps_per_sync=2)
    assert sess.run(tc.TwoLevel(**kw), 50000).converged
    # a new edge from the source into block 7
    v = next(v for v in range(7 * VB, 8 * VB) if csr.edge_weight(0, v)
             is None)
    sess.apply_updates(_batch("port", [("ins", [0], [v], [1.0])]))
    boost = sess._dirty_boost
    assert boost is not None and (boost > 0).sum() == 2   # blocks 0 and 7
    spy = _SpyTwoLevel(**kw)
    m = sess.run(spy, 2)
    assert sess._dirty_boost is None
    assert m.updates_applied == 1 and m.dirty_blocks == 2
    first, second = (np.asarray(p) for p in spy.p_means[:2])
    assert first[0, 0] >= ts.DIRTY_BOOST           # block 0 pends work
    assert first[0, 7] == 0.0                      # no work: no boost
    assert second.max() < ts.DIRTY_BOOST
    assert sess.run(tc.TwoLevel(**kw), 50000).converged


def test_stream_counters_and_apply_updates_errors():
    """RunMetrics drains the counters of every apply_updates since the
    last run, then reads 0; a session without its own CSR and a batch
    that is not an UpdateBatch raise as in the reference; updates before
    the first submit only advance the CSR."""
    csr = _csr("port", "weighted")
    sess = tc.GraphSession(csr, VB, capacity=1, seed=0, device="cpu")
    h = sess.submit(ta.SSSP(source=0))
    assert sess.run(tc.TwoLevel(), 50000).converged
    s1 = sess.apply_updates(_batch("port", [("del", *_src_dst("weighted",
                                                                [0]))]))
    s2 = sess.apply_updates(_batch("port", [("ins", [1], [2], [0.1])]))
    m = sess.run(tc.TwoLevel(), 50000)
    assert m.converged and m.updates_applied == 2
    assert m.dirty_blocks == s1.dirty_blocks + s2.dirty_blocks >= 1
    assert 0.0 <= m.reseed_fraction <= 1.0
    assert m.to_dict()["updates_applied"] == 2
    m2 = sess.run(tc.TwoLevel(), 50000)
    assert (m2.updates_applied, m2.dirty_blocks, m2.reseed_fraction) == (
        0, 0, 0.0)
    del h
    eng = tc.ConcurrentEngine(tc.make_run([ta.PageRank()], csr, VB,
                                          device="cpu"), seed=0)
    with pytest.raises(ValueError, match="CSRGraph"):
        eng.session.apply_updates(_batch("port", [("ins", [0], [1])]))
    with pytest.raises(ValueError, match="CSRGraph"):
        eng.session.compact()
    with pytest.raises(TypeError):
        tc.GraphSession(csr, VB, device="cpu").apply_updates([(0, 1, 1.0)])
    early = tc.GraphSession(csr, VB, capacity=1, seed=0, device="cpu")
    st = early.apply_updates(_batch("port", [("ins", [0], [150], [0.5])]))
    assert (st.updates_applied, st.dirty_blocks) == (1, 0)
    assert early._csr.edge_weight(0, 150) == 0.5


# -- trace --------------------------------------------------------------------


def _record(mod):
    tr = mod.TraceRecorder(enabled=True)
    tr.name_thread(2, "supersteps")
    tr.instant("submit", cat="job", alg="SSSP", slot=0)
    with tr.span("apply_updates", cat="stream", updates=3):
        pass
    tr.complete("superstep", 5.0, 2.0, cat="superstep", tid=2, step=0)
    tr.counter("telemetry", {"tile_loads": 4, "active_jobs": 1})
    tr.instant("compact", cat="stream", view="('min_plus',)")
    off = mod.TraceRecorder(enabled=False)
    off.instant("submit")
    assert off.events == []
    return tr


def _strip(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_trace_recorder_matches_reference():
    """The same calls give the same event names, phases and args; each
    package's export passes the other's validator; a port session with an
    enabled recorder emits the submit/superstep/run/apply_updates/
    compact/detach story."""
    got, want = _record(ttrace), _record(rtrace)
    assert _strip(got.events) == _strip(want.events)
    doc = got.to_json()
    assert rtrace.validate_trace_events(doc) == len(want.to_json()[
        "traceEvents"])
    assert ttrace.validate_trace_events(want.to_json()) > 0
    with pytest.raises(ValueError):
        rtrace.validate_trace_events({"traceEvents": [{"name": "x"}]})
    with pytest.raises(ValueError):
        ttrace.validate_trace_events({"traceEvents": [{"name": "x"}]})
    sess = tc.GraphSession(_csr("port", "chain"), VB, capacity=1,
                           device="cpu")
    assert not sess.trace.enabled           # telemetry off: records nothing
    sess.trace = ttrace.TraceRecorder(enabled=True)
    h = sess.submit(ta.SSSP(source=0))
    sess.run(tc.TwoLevel(), 3)
    sess.apply_updates(_batch("port", [("ins", [5], [200])]))
    sess.compact()
    sess.run(tc.Fused(), 50000)
    sess.detach(h)
    names = [e["name"] for e in sess.trace.events]
    assert names[0] == "submit" and names[-1] == "detach"
    for n in ("superstep", "run", "apply_updates", "compact",
              "device_chunk", "converged"):
        assert n in names, n
    assert rtrace.validate_trace_events(sess.trace.to_json()) > 0
