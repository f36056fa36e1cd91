"""Live updates, compaction, new views, growth and the serve front on a
session placed on a mesh (repro_torch.dist), on gloo worlds of CPU ranks,
against the port on one device and against repro.

The ranks run in `run_world` worlds (tests/test_torch_dist_stream_ranks.py,
which imports no JAX): one world of 4 ranks runs the (1 x 4) and (2 x 2)
scenarios, one of 2 the (2,) job mesh and the (1 x 2) serve front.  The
one-device port and repro run in this process (repro on one JAX device,
as its own tests run it; nothing in repro changes).  Sizes are those of
tests/test_dist_mesh2d.py and tests/test_serve_slo.py.  Bars:

  * slice builds, a single batch's edits (ELL rows, pair shards, overlay),
    gathered job state and StreamStats: the one-device port bit for bit
    (the symmetrized plus-times view's full reseed sums its matvec in the
    pair shard's order on a blocks mesh: rtol 1e-5, atol 1e-7);
  * STREAM_SCRIPT: min-plus bit-equal to repro's fresh session on the
    mutated graph, plus-times within rtol 1e-3, atol 1e-4 (the reference
    test's bar); tiles and pair shards equal a fresh build;
  * job mesh: the port's one-device run bit for bit (results, supersteps,
    tile_loads); serve logs equal to the port's on one device and, under
    TwoLevel(), to repro's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_stream_ranks as ranks  # noqa: E402
from repro_torch.dist.world import run_world  # noqa: E402

BLOCK = ranks.BLOCK
SYM_PLUS = ("plus_times", 0.0, None, True)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the port on one device, repro, and the worlds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's one-device runs in this process use one intra-op
    thread, as every rank does: their many small ops run no slower, and
    the parallel test workers are not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base_state():
    """The state every single-batch case starts from: the core session
    six host supersteps in, on one device."""
    import repro_torch.core as tc
    sess, _ = ranks.core_session()
    sess.run(tc.TwoLevel(), 6)
    return ranks.group_state(sess)


@pytest.fixture(scope="module")
def one_device(base_state):
    """The port on one device: each single-batch case from the same
    state, the STREAM_SCRIPT CSR's fresh views, the grow scenario and the
    serve harness."""
    import repro_torch.algorithms as ta
    import repro_torch.core as tc
    from repro_torch.graph import build_block_pairs
    out = {}
    for case in ranks.CASES:
        sess, _ = ranks.core_session()
        ranks.load_state(sess, base_state)
        st = sess.apply_updates(ranks.case_batch(sess._csr, case))
        out[case] = dict(
            stats=dataclasses.asdict(st),
            graphs={g.key: g.graph for g in sess.view_groups()},
            pairs={g.key: build_block_pairs(g.graph)
                   for g in sess.view_groups()},
            overlays={g.key: g.overlay for g in sess.view_groups()},
            state={g.key: (g.values.numpy(), g.deltas.numpy())
                   for g in sess.view_groups()})
    sess, hs = ranks.core_session()
    sess.run(tc.TwoLevel(), 20000)
    hs.append(sess.submit(ta.BFS(source=0)))
    bfs = sess.groups[hs[-1].view]
    out["bfs_view"] = (bfs.graph, build_block_pairs(bfs.graph))
    hs += [sess.submit(ta.SSSP(source=s)) for s in (30, 60, 90)]
    m = sess.run(tc.TwoLevel(), 20000)
    out["grow"] = dict(converged=m.converged,
                       results=[sess.result(h) for h in hs],
                       capacities=[g.capacity for g in sess.view_groups()])
    for tag, policy, k in (("two_level", tc.TwoLevel(), 1),
                           ("device", tc.TwoLevel(backend="device",
                                                  steps_per_sync=8), 8)):
        out["serve/" + tag] = ranks.harness_logs(
            ranks.harness(policy=policy, supersteps_per_tick=k))
    return out


@pytest.fixture(scope="module")
def refs():
    """repro: STREAM_SCRIPT's fresh session on the mutated graph, and the
    serve harness under TwoLevel()."""
    import repro.algorithms as ra
    import repro.core as rc
    import repro.graph as rg
    import repro.obs as ro
    import repro.serve as rsv
    from repro.stream import apply_to_csr

    csr = rg.rmat_graph(96, 3, seed=3)
    for b in rg.mutation_stream(csr, 2, inserts_per_batch=4,
                                deletes_per_batch=2, seed=9, weighted=False,
                                w_max=4.0):
        csr = apply_to_csr(csr, b)
    fresh = rc.GraphSession(csr, BLOCK, capacity=2, seed=11)
    algs = [ra.PageRank(), ra.SSSP(source=5), ra.Katz(alpha=0.02)]
    fh = [fresh.submit(a) for a in algs]
    assert fresh.run(rc.TwoLevel(), 50000).converged
    out = {"stream": [np.asarray(fresh.result(h)) for h in fh]}

    g = rg.rmat_graph(192, 5, seed=9)
    sess = rc.GraphSession(g, 32, capacity=3, seed=3)
    slo = ro.SLOTracker(targets=[ro.SLOTarget(
        family="*", p99_latency_steps=500, deadline_steps=600)], window=128)
    sched = rsv.ConcurrentServeScheduler(-(-g.n // 32), batch_budget=3,
                                         seed=5, slo=slo)
    h = ro.OpenLoopHarness(sess, sched, ro.LoadgenConfig(
        seed=11, ticks=90, base_rate=0.25, n_tenants=30, update_every=30),
        max_running=3)
    s = h.run()
    out["serve"] = dict(admission=list(h.admission_log),
                        completion=list(h.completion_log), summary=s)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory, base_state):
    return run_world(ranks.world4, 4, device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("world4")),
                     args=(base_state,))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(ranks.world2, 2, device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("world2")))


def test_ranks_import_neither_jax_nor_repro(world4, world2):
    assert world4["imports_clean"] and world2["imports_clean"]


# ---------------------------------------------------------------------------
# slice builds straight from the CSR
# ---------------------------------------------------------------------------


VIEW_KEYS = {"raw": (float("inf"), None, False),
             "out_degree": (0.0, "out_degree", False),
             "unit": (float("inf"), "unit", False),
             "symmetrized": (0.0, None, True)}


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("view", list(VIEW_KEYS))
def test_slice_build_equals_slicing_a_whole_build(n_shards, view):
    """`build_view_shard` for every shard: the ELL rows and the pair
    shard bit for bit what `partition_block_pairs` cuts from the whole
    build, with the shard's real-pair counts."""
    from repro_torch.dist.mesh2d import partition_block_pairs
    from repro_torch.graph import (build_block_pairs, build_blocked,
                                   rmat_graph)
    from repro_torch.graph.structure import build_view_shard
    fill, normalize, sym = VIEW_KEYS[view]
    csr = rmat_graph(128, 4, seed=7)
    csr = csr.symmetrized() if sym else csr
    whole = build_blocked(csr, BLOCK, fill=fill, normalize=normalize,
                          device="cpu")
    bp = build_block_pairs(whole)
    b_loc = whole.num_blocks // n_shards
    for s in range(n_shards):
        g, lp, counts = build_view_shard(csr, BLOCK, n_shards, s,
                                         fill=fill, normalize=normalize,
                                         device="cpu")
        ps = partition_block_pairs(bp, n_shards, fill, s)
        assert counts == ps.shard_pairs and sum(counts) == bp.num_pairs
        assert (g.num_blocks, g.max_nbr_blocks) == (whole.num_blocks,
                                                    whole.max_nbr_blocks)
        for f in ("tiles", "nbr_ids", "nbr_mask"):
            assert torch.equal(getattr(g, f),
                               getattr(whole, f)[s * b_loc:(s + 1) * b_loc])
        assert torch.equal(g.vertex_mask, whole.vertex_mask)
        assert (lp.num_pairs, lp.num_blocks) == (ps.local.num_pairs, b_loc)
        for f in ranks.PAIR_FIELDS:
            want = getattr(ps.local, f)
            assert getattr(lp, f).dtype == want.dtype, f
            assert torch.equal(getattr(lp, f), want), f


# ---------------------------------------------------------------------------
# one batch on (1 x 4) and (2 x 2) against the port on one device
# ---------------------------------------------------------------------------


def _check_held(rank_held, dev, n_shards):
    """One rank's slices against the one-device view after the batch."""
    from repro_torch.dist.mesh2d import partition_block_pairs
    for key, h in rank_held.items():
        b0, bl = h["block_range"]
        g = dev["graphs"][key]
        for f, got in h["ell"].items():
            np.testing.assert_array_equal(got,
                                          getattr(g, f)[b0:b0 + bl].numpy())
        s, shard, counts = h["shard"]
        assert s == n_shards
        want = partition_block_pairs(dev["pairs"][key], s, key[1], shard)
        assert tuple(counts) == want.shard_pairs
        for f, got in h["pairs"].items():
            np.testing.assert_array_equal(got,
                                          getattr(want.local, f).numpy())
        ov = dev["overlays"][key]
        assert h["overlay"]["capacity"] == ov.capacity
        for f in ("src_u", "dst", "w", "mask"):
            np.testing.assert_array_equal(h["overlay"][f],
                                          getattr(ov, f).numpy())


@pytest.mark.parametrize("case", ranks.CASES)
@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_single_batch_matches_one_device(world4, one_device, shape, case):
    """Each rank's ELL rows, pair shard (a partition of the one-device
    rebuilt pairs) and overlay, the gathered values and deltas and the
    StreamStats equal the port's one-device batch from the same loaded
    state."""
    got, dev = world4[f"{shape}/{case}"], one_device[case]
    if case == "overlay":
        assert all(int(ov.mask.sum()) > 0
                   for ov in dev["overlays"].values())
        assert all(got["dense"])
    assert (dev["stats"]["compacted_views"] > 0) == (case == "overflow")
    assert got["stats"] == dev["stats"]
    assert all(st == dev["stats"] for st in got["stats_all"])
    for rank_held in got["held"]:
        _check_held(rank_held, dev, 4 if shape == "1x4" else 2)
    for key, (v, d) in got["state"].items():
        want_v, want_d = dev["state"][key]
        np.testing.assert_array_equal(v, want_v)
        if key == SYM_PLUS:
            np.testing.assert_allclose(d, want_d, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_batch_collectives(world4, shape):
    """A batch gathers each view's job state once, and the first batch
    after a build also its ELL metadata: the same count on every rank."""
    for case in ranks.CASES:
        n = world4[f"{shape}/{case}"]["collectives"]
        assert len(set(n)) == 1 and n[0] == 2 * 3, (case, n)


def test_overflow_compacts_on_every_rank(world4, one_device):
    """A batch that overflows an overlay row compacts that view on every
    rank in the same batch: empty overlays, slices of a fresh build."""
    from repro_torch.graph import build_blocked
    for shape in ("1x4", "2x2"):
        got = world4[f"{shape}/overflow"]
        assert got["stats"]["compacted_views"] >= 2
        assert got["stats"]["compacted_views"] == \
            one_device["overflow"]["stats"]["compacted_views"]
        for rank_held in got["held"]:
            for key in (("plus_times", 0.0, "out_degree", False),
                        ("min_plus", float("inf"), None, False)):
                assert rank_held[key]["overlay"]["capacity"] == 0
    csr = ranks.core_session()[0]._csr
    from repro_torch.stream import apply_to_csr
    csr = apply_to_csr(csr, ranks.case_batch(csr, "overflow"))
    fresh = build_blocked(csr, BLOCK, fill=float("inf"), device="cpu")
    np.testing.assert_array_equal(
        one_device["overflow"]["graphs"][
            ("min_plus", float("inf"), None, False)].tiles.numpy(),
        fresh.tiles.numpy())


# ---------------------------------------------------------------------------
# STREAM_SCRIPT on (2 x 2), and unsharding after it
# ---------------------------------------------------------------------------


def _fresh_views(run):
    from repro_torch.graph import CSRGraph, build_block_pairs, build_blocked
    indptr, indices, weights = run["csr"]
    csr = CSRGraph(n=len(indptr) - 1, indptr=indptr, indices=indices,
                   weights=weights)
    out = {}
    for a in ranks.stream_algs():
        key = (a.semiring, a.graph_fill, a.graph_normalize,
               a.graph_symmetrize)
        g = build_blocked(csr, BLOCK, fill=a.graph_fill,
                          normalize=a.graph_normalize, device="cpu")
        out[key] = (g, build_block_pairs(g))
    return out


@pytest.mark.parametrize("driver", ["host", "device"])
def test_stream_script_2x2(world4, refs, driver):
    """The reference's STREAM_SCRIPT on (2 x 2): overlay updates, then
    compact(); every rank's slices equal a fresh build of the mutated
    graph, and the fixpoints equal repro's fresh session there."""
    from repro_torch.dist.mesh2d import partition_block_pairs
    run = world4["stream/" + driver]
    assert run["metrics"]["converged"]
    assert any(sum(x) > 0 for x in run["live"])     # the overlay was live
    assert all(run["dense"])
    fresh = _fresh_views(run)
    for rank_held in run["held"]:
        for key, h in rank_held.items():
            g, bp = fresh[key]
            b0, bl = h["block_range"]
            assert h["overlay"]["capacity"] == 0    # compact() folded it
            for f, got in h["ell"].items():
                np.testing.assert_array_equal(
                    got, getattr(g, f)[b0:b0 + bl].numpy())
            s, shard, _ = h["shard"]
            want = partition_block_pairs(bp, s, key[1], shard).local
            for f, got in h["pairs"].items():
                np.testing.assert_array_equal(got, getattr(want, f).numpy())
    for a, got, want in zip(ranks.stream_algs(), run["results"],
                            refs["stream"]):
        if a.semiring == "min_plus":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want)


@pytest.mark.parametrize("driver", ["host", "device"])
def test_unshard_rebuilds_without_an_ell_gather(world4, driver):
    """`unshard_session` after updates and compaction: whole ELL views
    equal to a fresh build, from one collective a view (its job state)."""
    run = world4["stream/" + driver]
    fresh = _fresh_views(run)
    assert run["unshard_collectives"] == len(fresh)
    for key, arrays in run["unsharded"].items():
        for f, got in arrays.items():
            np.testing.assert_array_equal(got,
                                          getattr(fresh[key][0], f).numpy())


def test_step_cache_follows_the_pair_shards(world4):
    """Fused() on (1 x 4) after a reweight batch (tile edits in place: no
    new step function), an overlay batch (overlay capacity grows: a new
    one) and an overflowing batch (compacted shards: a new one); the
    fixpoints equal the same sequence on one device (min-plus bitwise,
    plus-times within the bar: the device draw on a blocks mesh differs
    from one device's)."""
    import repro_torch.core as tc
    got = world4["cache/1x4"]
    assert got["sizes"] == [1, 1, 2, 3] and got["converged"]
    sess, hs = ranks.core_session()
    sess.run(tc.Fused(), 20000)
    for batch in (ranks.reweight_batch(sess._csr),
                  ranks.case_batch(sess._csr, "overlay"),
                  ranks.case_batch(sess._csr, "overflow")):
        sess.apply_updates(batch)
        assert sess.run(tc.Fused(), 20000).converged
    for a, r, h in zip(ranks.core_algs(), got["results"], hs):
        if a.semiring == "min_plus":
            np.testing.assert_array_equal(r, sess.result(h))
        else:
            _close(r, sess.result(h))


# ---------------------------------------------------------------------------
# a new view and growth on a placed session
# ---------------------------------------------------------------------------


def test_new_view_and_growth_on_2x2(world4, one_device):
    """A BFS view built on (2 x 2) from this rank's slices alone equals a
    partition of the whole build; the SSSP group grows 2 -> 8 (rows move
    between ranks); the fixpoints equal one device (min-plus bitwise)."""
    from repro_torch.dist.mesh2d import partition_block_pairs
    got, dev = world4["grow/2x2"], one_device["grow"]
    assert got["metrics"]["converged"] and dev["converged"]
    assert got["capacities"] == dev["capacities"]
    sssp = got["capacities"][1]
    assert sssp == 8 and got["local_jobs"][1] == sssp // 2
    g, bp = one_device["bfs_view"]
    for h in got["new_view"]:
        b0, bl = h["block_range"]
        for f, arr in h["ell"].items():
            np.testing.assert_array_equal(arr,
                                          getattr(g, f)[b0:b0 + bl].numpy())
        s, shard, _ = h["shard"]
        want = partition_block_pairs(bp, s, g.fill, shard).local
        for f, arr in h["pairs"].items():
            np.testing.assert_array_equal(arr, getattr(want, f).numpy())
    algs = ranks.core_algs()
    for i, (r, w) in enumerate(zip(got["results"], dev["results"])):
        if i < len(algs) and algs[i].semiring == "plus_times":
            _close(r, w)
        else:
            np.testing.assert_array_equal(r, w)


def test_job_mesh_growth_and_warning(world2):
    """Capacity 1 on a (2,) job mesh replicates with one warning; growth
    to 2 and 4 shards the rows again; results, supersteps and tile_loads
    equal one device bit for bit."""
    got, want = world2["jobs/grow"], world2["one_device"]["grow"]
    msgs = world2["jobs/grow_warnings"]
    assert len(msgs) == 1 and "jobs-replicated" in msgs[0], msgs
    assert got["capacity"] == 4 and got["local_jobs"] == 2
    for g, w in zip(got["metrics"], want["metrics"]):
        assert g["converged"]
        for k in ("converged", "supersteps", "tile_loads"):
            assert g[k] == w[k], k
    np.testing.assert_array_equal(got["results"], want["results"])


# ---------------------------------------------------------------------------
# the (2,) job mesh under a stream, bit for bit
# ---------------------------------------------------------------------------


def test_job_mesh_stream_equals_one_device(world2):
    """Generated batches, an overlay insert and an overflowing row on a
    (2,) job mesh, a run after each: every run's supersteps and
    tile_loads and every result equal one device bit for bit."""
    got = world2["jobs/stream"]
    want = world2["one_device"]["stream"]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["metrics"]["converged"]
        for k in ("converged", "supersteps", "tile_loads"):
            assert g["metrics"][k] == w["metrics"][k], k
        for r, x in zip(g["results"], w["results"]):
            np.testing.assert_array_equal(r, x)


# ---------------------------------------------------------------------------
# the serve front on a placed session
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,dev_tag", [("1x2/two_level", "two_level"),
                                         ("jobs/device", "device")])
def test_serve_logs_equal_one_device(world2, one_device, tag, dev_tag):
    """OpenLoopHarness on a session placed before its first view: the
    admission and completion logs and the summary equal the port's on
    one device; every request served, every slot free at the end."""
    got, want = world2["serve/" + tag], one_device["serve/" + dev_tag]
    assert got["admission"] == want["admission"]
    assert got["completion"] == want["completion"]
    s = got["summary"]
    assert s["admitted"] == s["completed"] == s["arrivals"] > 0
    assert s["updates_applied"] > 0 and got["active"] == 0
    for k in ("arrivals", "ticks", "supersteps", "latency_ticks",
              "throughput_per_tick"):
        assert s[k] == want["summary"][k], k
    assert got["capacities"] == want["capacities"]


def test_serve_logs_equal_repro(world2, refs):
    """Under TwoLevel() the (1 x 2) logs are repro's."""
    got, want = world2["serve/1x2/two_level"], refs["serve"]
    assert got["admission"] == want["admission"]
    assert got["completion"] == want["completion"]
    for k in ("arrivals", "admitted", "completed", "ticks", "supersteps",
              "latency_ticks"):
        assert got["summary"][k] == want["summary"][k], k
