"""End-to-end parity of the port's GraphSession (CPU) with repro's.

The same graphs and job mixes as tests/test_kernels.py:122-192 run in
both packages: SSSP/BFS results bit-equal, PageRank at rtol 1e-4,
atol 1e-6 (and within rtol 5e-3, atol 1e-4 of networkx).  Also the three
host policies, the job lifecycle (mid-run submit, detach and slot
recycling, capacity doubling) and `convert`, which carries a reference
run's graph and mid-run state into the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as ra  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.graph as rg  # noqa: E402
import repro_torch.algorithms as ta  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.push as tpush  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch import convert  # noqa: E402

PKGS = {"ref": (rc, ra, rg, {}), "port": (tc, ta, tg, {"device": "cpu"})}


def _session(pkg, graph, *, use_pallas=False, **kw):
    c, _, g, dev = PKGS[pkg]
    name, args, gkw = graph
    csr = getattr(g, name)(*args, **gkw)
    return c.GraphSession(csr, 16, use_pallas=use_pallas, **kw, **dev)


def _algs(pkg, specs):
    a = PKGS[pkg][1]
    return [getattr(a, name)(**kw) for name, kw in specs]


RMAT = ("rmat_graph", (150, 4), dict(seed=13))
UNIFORM_W = ("uniform_graph", (150, 4), dict(seed=21, weighted=True,
                                             w_max=7.0))


def _run_both(graph, specs, policy="TwoLevel", use_pallas=False,
              steps=20000, **kw):
    out = {}
    for pkg in PKGS:
        sess = _session(pkg, graph, use_pallas=use_pallas, **kw)
        hs = [sess.submit(a) for a in _algs(pkg, specs)]
        m = sess.run(getattr(PKGS[pkg][0], policy)(), steps)
        out[pkg] = (m, [sess.result(h) for h in hs], sess)
    return out


def _check_results(specs, out):
    for (name, _), r, t in zip(specs, out["ref"][1], out["port"][1]):
        assert t.dtype == np.float32 and t.shape == r.shape
        if name in ("SSSP", "BFS", "WCC"):
            np.testing.assert_array_equal(t, r)
        else:
            np.testing.assert_allclose(t, r, rtol=1e-4, atol=1e-6)


def _networkx_pagerank(csr, damping):
    import networkx as nx
    g = nx.DiGraph()
    g.add_nodes_from(range(csr.n))
    src = np.repeat(np.arange(csr.n), csr.out_degree)
    g.add_edges_from(zip(src.tolist(), csr.indices.tolist()))
    ref = nx.pagerank(g, alpha=damping, tol=1e-12, max_iter=500)
    return np.array([ref[i] for i in range(csr.n)]) * csr.n


@pytest.mark.parametrize("use_pallas", [False, True])
def test_pagerank_end_to_end(use_pallas):
    """tests/test_kernels.py:123: two PageRank jobs reach the reference's
    fixpoint and networkx's."""
    specs = [("PageRank", {}), ("PageRank", dict(damping=0.6))]
    out = _run_both(RMAT, specs, use_pallas=use_pallas, capacity=2, seed=5)
    assert out["port"][0].converged
    _check_results(specs, out)
    csr = tg.rmat_graph(150, 4, seed=13)
    for res, damp in zip(out["port"][1], (0.85, 0.6)):
        np.testing.assert_allclose(res, _networkx_pagerank(csr, damp),
                                   rtol=5e-3, atol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_min_plus_two_views_end_to_end(use_pallas):
    """tests/test_kernels.py:147: SSSP + BFS over two views, bit-equal to
    the reference on both push routes."""
    specs = [("SSSP", dict(source=0)), ("SSSP", dict(source=33)),
             ("BFS", dict(source=7))]
    out = _run_both(UNIFORM_W, specs, use_pallas=use_pallas, capacity=4,
                    seed=3)
    assert out["port"][0].converged
    assert len(out["port"][2].view_groups()) == 2
    _check_results(specs, out)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_heterogeneous_end_to_end(use_pallas):
    """tests/test_kernels.py:170: one selection per superstep drives the
    plus-times and the min-plus push."""
    specs = [("PageRank", {}), ("SSSP", dict(source=3))]
    out = _run_both(RMAT, specs, use_pallas=use_pallas, capacity=2, seed=5)
    assert out["port"][0].converged
    _check_results(specs, out)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paper_block_width_end_to_end(use_pallas):
    """The paper's block width, Vb = 512, on a graph of B_N = 6 blocks:
    PageRank, PPR and two SSSP jobs over two views on the port's kernel
    route (on the CPU its plain version, B1/B2's function) and its ELL
    route, against the reference's session: SSSP bit-equal, PageRank/PPR
    at rtol 1e-4, atol 1e-6."""
    specs = [("PageRank", {}), ("PersonalizedPageRank", dict(source=3)),
             ("SSSP", dict(source=0)), ("SSSP", dict(source=2900))]
    out = {}
    for pkg in PKGS:
        c, _, g, dev = PKGS[pkg]
        csr = g.rmat_graph(3000, 4, seed=13)
        sess = c.GraphSession(csr, 512, capacity=4, seed=5,
                              use_pallas=use_pallas and pkg == "port", **dev)
        hs = [sess.submit(a) for a in _algs(pkg, specs)]
        assert sess.scheduler.num_blocks == 6
        m = sess.run(c.TwoLevel(), 20000)
        assert m.converged
        out[pkg] = (m, [sess.result(h) for h in hs], sess)
    assert len(out["port"][2].view_groups()) == 2
    _check_results(specs, out)


def test_min_plus_counters_equal_reference():
    """On a min-plus-only session the schedule counters also agree with the
    reference.  block_pairs' p_mean is not bit-equal in general (see
    tests/test_torch_scheduler.py), so this pins what holds on these
    inputs: the CBP decisions never fall on a last-bit difference here."""
    specs = [("SSSP", dict(source=0)), ("SSSP", dict(source=33)),
             ("BFS", dict(source=7))]
    out = _run_both(UNIFORM_W, specs, use_pallas=True, capacity=4, seed=3)
    keys = ("supersteps", "tile_loads", "tile_pair_loads",
            "job_block_pushes", "host_syncs", "converged")
    mr, mt = out["ref"][0].to_dict(), out["port"][0].to_dict()
    assert {k: mr[k] for k in keys} == {k: mt[k] for k in keys}
    np.testing.assert_array_equal(out["ref"][0].iterations_per_job,
                                  out["port"][0].iterations_per_job)


@pytest.mark.parametrize("policy", ["TwoLevel", "Independent", "AllBlocks"])
def test_host_policies_match_reference(policy):
    specs = [("PageRank", {}), ("PersonalizedPageRank", dict(source=3)),
             ("SSSP", dict(source=3)), ("WCC", {})]
    out = _run_both(RMAT, specs, policy=policy, use_pallas=True, capacity=2,
                    seed=5)
    m = out["port"][0]
    assert m.converged and m.tile_loads > 0 and m.tile_pair_loads > 0
    assert m.host_syncs == m.supersteps + 1
    _check_results(specs, out)


def test_mid_run_submit_matches_reference():
    """A job submitted between run() calls joins the shared state."""
    res = {}
    for pkg in PKGS:
        sess = _session(pkg, UNIFORM_W, capacity=2, seed=1)
        a0, a1 = _algs(pkg, [("SSSP", dict(source=5)),
                             ("BFS", dict(source=40))])
        h0 = sess.submit(a0)
        m = sess.run(max_supersteps=4)
        assert not m.converged and m.supersteps == 4
        h1 = sess.submit(a1)
        assert sess.run(max_supersteps=20000).converged
        res[pkg] = [sess.result(h0), sess.result(h1)]
    for a, b in zip(res["ref"], res["port"]):
        np.testing.assert_array_equal(b, a)


def test_detach_recycles_slot_and_capacity_doubles():
    specs = [("SSSP", dict(source=s)) for s in (0, 11, 22)]
    res = {}
    for pkg in PKGS:
        sess = _session(pkg, UNIFORM_W, capacity=1, seed=2)
        hs = [sess.submit(a) for a in _algs(pkg, specs)]
        assert sess.capacity == 4                 # 1 -> 2 -> 4
        assert sess.run(max_supersteps=20000).converged
        r0 = sess.detach(hs[0])
        with pytest.raises(KeyError):
            sess.result(hs[0])                    # stale handle
        h3 = sess.submit(_algs(pkg, [("SSSP", dict(source=33))])[0])
        assert h3.slot == hs[0].slot and h3.gen == hs[0].gen + 1
        assert sess.num_active == 3
        counts = sess.unconverged_counts()
        assert counts[sess.job_index(h3)] > 0
        assert not sess.converged(h3) and sess.converged(hs[1])
        assert sess.run(max_supersteps=20000).converged
        res[pkg] = [r0] + [sess.result(h) for h in (hs[1], hs[2], h3)]
    for a, b in zip(res["ref"], res["port"]):
        np.testing.assert_array_equal(b, a)


def test_load_group_state_continues_reference_run():
    """Run the reference k supersteps, carry its state (and its scheduler
    stream) into the port, run both on: min-plus results bit-equal and
    the continued schedules agree."""
    csr = rg.uniform_graph(150, 4, seed=21, weighted=True, w_max=7.0)
    ref = rc.GraphSession(csr, 16, capacity=4, seed=3)
    specs = [("SSSP", dict(source=0)), ("SSSP", dict(source=33))]
    hr = [ref.submit(a) for a in _algs("ref", specs)]
    assert not ref.run(max_supersteps=6).converged
    port = tc.GraphSession(
        convert.csr_from_arrays(csr.n, csr.indptr, csr.indices, csr.weights),
        16, capacity=4, seed=3, device="cpu")
    ht = [port.submit(a) for a in _algs("port", specs)]
    (key, grp), = ref.groups.items()
    convert.load_group_state(
        port, key, np.asarray(grp.values), np.asarray(grp.deltas),
        np.asarray(grp.push_scale), grp.active,
        rng_state=ref.scheduler.rng.bit_generator.state)
    np.testing.assert_array_equal(port.unconverged_counts(),
                                  np.asarray(ref.unconverged_counts()))
    mr = ref.run(max_supersteps=20000)
    mt = port.run(max_supersteps=20000)
    assert mr.converged and mt.converged
    assert mt.supersteps == mr.supersteps
    assert mt.tile_loads == mr.tile_loads
    for a, b in zip(hr, ht):
        np.testing.assert_array_equal(port.result(b), ref.result(a))


def test_convert_graph_arrays_equal_port_builds():
    csr = rg.rmat_graph(120, 4, seed=4)
    g = rg.build_blocked(csr, 16, normalize="out_degree")
    bp = rg.build_block_pairs(g)
    tcsr = convert.csr_from_arrays(csr.n, csr.indptr, csr.indices,
                                   csr.weights)
    tgr = convert.blocked_from_arrays(
        g.n_real, g.block_size, g.num_blocks, g.max_nbr_blocks, g.fill,
        np.asarray(g.nbr_ids), np.asarray(g.nbr_mask), np.asarray(g.tiles),
        np.asarray(g.vertex_mask), device="cpu")
    tbp = convert.pairs_from_arrays(
        bp.num_pairs, bp.block_size, bp.num_blocks, *(np.asarray(x) for x in (
            bp.src, bp.dst, bp.slot, bp.first, bp.last, bp.src_nnz,
            bp.dst_touched, bp.tiles)),
        dense_op=None if bp.dense_op is None else np.asarray(bp.dense_op),
        device="cpu")
    own_g = tg.build_blocked(tcsr, 16, normalize="out_degree", device="cpu")
    own_bp = tg.build_block_pairs(own_g)
    for f in ("nbr_ids", "nbr_mask", "tiles", "vertex_mask"):
        assert torch.equal(getattr(tgr, f), getattr(own_g, f))
    for f in ("src", "dst", "slot", "first", "last", "src_nnz",
              "dst_touched", "tiles", "run_start"):
        assert torch.equal(getattr(tbp, f), getattr(own_bp, f)), f
    assert (tbp.dense_op is None) == (own_bp.dense_op is None)


def test_session_needs_explicit_cpu_without_cuda(monkeypatch):
    """device=None means CUDA: without it the session raises and does not
    run on the CPU; use_pallas resolves per device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    csr = tg.chain_graph(64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.GraphSession(csr, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.build_blocked(csr, 16)
    sess = tc.GraphSession(csr, 16, device="cpu")
    assert sess.device.type == "cpu" and sess.use_pallas is False
    assert tc.GraphSession(csr, 16, device="cpu", use_pallas=True).use_pallas


def test_unported_options_raise(tmp_path):
    csr = tg.chain_graph(32)
    # telemetry is ported (repro_torch.obs.telemetry)
    assert tc.GraphSession(csr, 16, device="cpu",
                           telemetry=True).telemetry is not None
    sess = tc.GraphSession(csr, 16, device="cpu")
    h = sess.submit(ta.SSSP())
    # mesh= is ported (repro_torch.dist): it takes a DeviceMesh over an
    # initialized process group, and on a one-rank world equals no mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        sess.run(mesh=object())
    import torch.distributed as dist
    from repro_torch.dist.graph import make_job_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_job_mesh(device_type="cpu")
        placed = tc.GraphSession(csr, 16, device="cpu")
        hp = placed.submit(ta.SSSP())
        mp = placed.run(mesh=mesh)
        rp = placed.result(hp)          # a collective on a placed session
    finally:
        dist.destroy_process_group()
    unplaced = tc.GraphSession(csr, 16, device="cpu")
    hu = unplaced.submit(ta.SSSP())
    mu = unplaced.run()
    assert mp.converged and mp.to_dict() | {"wall_time_s": 0} == \
        mu.to_dict() | {"wall_time_s": 0}
    np.testing.assert_array_equal(rp, unplaced.result(hu))
    orphan = tc.GraphSession(csr, 16, device="cpu")
    orphan.submit(ta.SSSP())
    with pytest.raises(RuntimeError, match="process group"):
        orphan.run(mesh=mesh)
    # a non-empty overlay is ported (repro_torch.stream): an all-inert one
    # is an exact no-op on the push
    assert sess.run().converged
    inert = tc.GraphSession(csr, 16, device="cpu")
    h2 = inert.submit(ta.SSSP())
    grp, = inert.view_groups()
    grp.overlay = tg.empty_overlay(grp.graph.num_blocks, 4, device="cpu")
    assert inert.run().converged
    np.testing.assert_array_equal(inert.result(h2), sess.result(h))


# -- views that hold their pair tiles alone ------------------------------------


def _g500_small():
    """A Graph500 draw at scale 8 (256 vertices; the benchmark's
    generator, graphbench/graph.py) as the port's CSR."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from graphbench.graph import graph500
    c = graph500(dict(scale=8, edgefactor=16, a=0.57, b=0.19, c=0.19),
                 np.random.default_rng(2))
    return tg.CSRGraph.from_edges(c.n, *c.edges())


def _dense_walk(csr):
    """[n, n] float64 matrix of the out-degree normalized view's weights
    (w_uv / outdeg(u) in float32, as the view holds them)."""
    src = np.repeat(np.arange(csr.n), csr.out_degree)
    deg = np.maximum(csr.out_degree, 1).astype(np.float32)
    a = torch.zeros((csr.n, csr.n), dtype=torch.float64)
    a[src, csr.indices] = torch.from_numpy(
        (csr.weights / deg[src]).astype(np.float32)).double()
    return a


def _power_iteration(csr, damping, source=None):
    """x = b + damping A^T x by power iteration in float64, with b
    (1 - damping) at every vertex (PageRank) or at `source` (PPR)."""
    at = _dense_walk(csr).T
    b = torch.zeros(csr.n, dtype=torch.float64)
    if source is None:
        b[:] = 1.0 - damping
    else:
        b[source] = 1.0 - damping
    x = b.clone()
    for _ in range(2000):
        nxt = b + damping * (at @ x)
        if torch.max(torch.abs(nxt - x)) < 1e-14:
            break
        x = nxt
    return nxt.numpy()


def _bellman_ford(csr, source, unit):
    """Shortest distances from `source` by Bellman-Ford on a dense
    matrix.  Relaxed in float32, as the session relaxes: each relaxation
    is monotone, so every fair order from +inf ends at the same float32
    fixpoint, and the answers are compared bit for bit."""
    src = np.repeat(np.arange(csr.n), csr.out_degree)
    w = torch.full((csr.n, csr.n), float("inf"), dtype=torch.float32)
    w[src, csr.indices] = torch.from_numpy(
        np.ones_like(csr.weights) if unit else csr.weights)
    d = torch.full((csr.n,), float("inf"), dtype=torch.float32)
    d[source] = 0.0
    for _ in range(csr.n):
        nxt = torch.minimum(d, (d[:, None] + w).min(dim=0).values)
        if torch.equal(nxt, d):
            break
        d = nxt
    return d.numpy()


VIEW_POLICIES = {"Fused": lambda: tc.Fused(),
                 "TwoLevel": lambda: tc.TwoLevel(),
                 "Independent": lambda: tc.Independent(),
                 "AllBlocks": lambda: tc.AllBlocks()}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("policy", list(VIEW_POLICIES))
def test_pair_views_match_a_plain_dense_solve(policy, use_pallas):
    """Sessions on views that hold their pair tiles alone, against a
    plain float64 power iteration (PageRank, PPR; rtol 5e-3, atol 1e-4,
    the bar of an independent solver) and Bellman-Ford on a dense matrix
    (SSSP, BFS; bit for bit).  The ELL tiles are built only where the
    route reads them: the per-job route (Independent) and the plain
    min-plus route."""
    csr = _g500_small()
    sess = tc.GraphSession(csr, 16, capacity=2, seed=4, device="cpu",
                           use_pallas=use_pallas)
    keys = np.flatnonzero(csr.out_degree > 0)
    s1, s2 = int(keys[7]), int(keys[40])
    hs = [sess.submit(ta.PageRank()), sess.submit(ta.PersonalizedPageRank(
        source=s1)), sess.submit(ta.SSSP(source=s2)),
        sess.submit(ta.BFS(source=s1))]
    assert sess.run(VIEW_POLICIES[policy](), 20000).converged
    got = [sess.result(h) for h in hs]
    np.testing.assert_allclose(got[0], _power_iteration(csr, 0.85),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_allclose(got[1], _power_iteration(csr, 0.85, s1),
                               rtol=5e-3, atol=1e-4)
    np.testing.assert_array_equal(got[2], _bellman_ford(csr, s2, False))
    np.testing.assert_array_equal(got[3], _bellman_ford(csr, s1, True))
    for g, vb in zip(sess.view_groups(), sess.view_bytes()):
        assert vb["view"] == g.key
        assert vb["pair_bytes"] == g.pairs.tiles.numel() * 4 > 0
        reads = tpush.reads_ell(g.semiring, use_pallas,
                                policy != "Independent")
        assert vb["ell_builds"] == int(reads)
        assert vb["ell_bytes"] == (g.graph.tiles.numel() * 4 if reads
                                   else 0)


def test_fused_kernel_route_builds_no_ell():
    """A plus-times view (and every other) after a Fused run on the
    kernel-route contract (use_pallas) holds 0 ELL bytes and no
    `view.ell` span was recorded, after set-up and after the run."""
    from repro_torch.obs import TelemetryConfig
    csr = _g500_small()
    sess = tc.GraphSession(csr, 16, capacity=2, seed=4, device="cpu",
                           use_pallas=True,
                           telemetry=TelemetryConfig(capacity=0))
    for a in (ta.PageRank(), ta.SSSP(source=3), ta.BFS(source=3)):
        sess.submit(a)
    for _ in range(2):
        assert all(v["ell_bytes"] == 0 and v["ell_builds"] == 0
                   for v in sess.view_bytes())
        assert all(g.graph.ell is None for g in sess.view_groups())
        assert "view.ell" not in sess.trace.totals()
        assert "view.build" in sess.trace.totals()
        sess.run(tc.Fused(), 20000)
    assert sess.view_groups()[0].semiring == "plus_times"


def test_plain_route_builds_ell_once_until_the_view_is_rebuilt():
    """The plain min-plus route asks for the view's ELL tiles: built
    once under a `view.ell` span, kept across runs, dropped by a
    compaction and built again when next asked."""
    from repro_torch.obs import TelemetryConfig
    sess = tc.GraphSession(_g500_small(), 16, capacity=2, seed=4,
                           device="cpu", use_pallas=False,
                           telemetry=TelemetryConfig(capacity=0))
    h = sess.submit(ta.SSSP(source=3))
    grp = sess.view_groups()[0]
    sess.run(tc.TwoLevel(), 3)
    sess.run(tc.TwoLevel(), 3)
    assert grp.ell_builds == 1 and sess.trace.totals()["view.ell"][1] == 1
    built = grp.graph.tiles
    assert sess.view_bytes()[0]["ell_bytes"] == built.numel() * 4
    sess.compact()
    assert sess.view_bytes()[0]["ell_bytes"] == 0
    assert sess.run(tc.TwoLevel(), 20000).converged
    assert grp.ell_builds == 2
    np.testing.assert_array_equal(grp.graph.tiles.numpy(), built.numpy())
    np.testing.assert_array_equal(
        sess.result(h), _bellman_ford(sess._csr, 3, False))
