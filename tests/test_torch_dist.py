"""The port's multi-device graph engine (repro_torch.dist) against repro's
one-device results, on gloo worlds of CPU ranks.

The ranks run in `run_world` worlds (tests/test_torch_dist_ranks.py): one
world of 4 ranks runs every (1 x 4), (2 x 2) and (4 x 1) scenario, one
world of 2 the job mesh and the restores onto (1 x 2); the test
functions read their results.  The reference side runs in this process
on one JAX device, as repro's own tests run it; nothing in repro
changes.  Sizes are those of tests/test_dist_graph.py and
tests/test_dist_mesh2d.py.  Bars:

  * job mesh: the port's one-device run bit for bit (results, supersteps,
    tile_loads); repro's supersteps and tile_loads, and its results at
    the port's one-device bar (rtol 1e-4, atol 1e-6);
  * jobs x blocks: min-plus bit-equal to repro's one-device fixpoint,
    plus-times within rtol 1e-3, atol 1e-4 (the reference test's bar);
  * halo_bytes above 0 and at most supersteps x (sum of capacity x q x
    Vb x 4 + 8 x B_N); every shard's pair tiles at most half the view's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_dist_ranks as ranks  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.dist.world import run_world  # noqa: E402

BLOCK = ranks.BLOCK


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the reference side (repro, one JAX device) and the port on one device
# ---------------------------------------------------------------------------


def _repro_core(rc, ra, csr, **kw):
    sess = rc.GraphSession(csr, BLOCK, capacity=2, seed=0, **kw)
    hs = [sess.submit(ra.PageRank()), sess.submit(ra.PageRank(damping=0.7)),
          sess.submit(ra.SSSP(source=3)), sess.submit(ra.SSSP(source=17))]
    return sess, hs


@pytest.fixture(scope="module")
def refs():
    import repro.algorithms as ra
    import repro.core as rc
    import repro.graph as rg
    from repro.dist.fault import checkpoint_session

    out = {}
    sess, hs = _repro_core(rc, ra, rg.rmat_graph(128, 4, seed=7))
    m = sess.run(rc.TwoLevel(), 20000)
    assert m.converged
    out["core"] = ([sess.result(h) for h in hs], m)

    csr = rg.rmat_graph(256, 5, seed=11)
    algs = [ra.PageRank(), ra.PageRank(damping=0.7)] + [
        ra.PersonalizedPageRank(source=13 * i + 2) for i in range(6)]
    for n in (8, 5):
        eng = rc.ConcurrentEngine(rc.make_run(algs[:n], csr, BLOCK), seed=0)
        m = eng.run_two_level(20000)
        assert m.converged
        out[f"jobs{n}"] = (eng.results(), m)

    def fault_session():
        s = rc.GraphSession(rg.rmat_graph(128, 4, seed=13), BLOCK,
                            capacity=2, seed=2)
        return s, [s.submit(ra.SSSP(source=3)), s.submit(ra.SSSP(source=40)),
                   s.submit(ra.PageRank())]

    sess, hs = fault_session()
    m = sess.run(rc.TwoLevel(), 20000)
    assert m.converged
    out["fault"] = ([sess.result(h) for h in hs], m)
    sess, _ = fault_session()
    m = sess.run(rc.TwoLevel(), 5)
    snap = checkpoint_session(sess)
    out["fault_snapshot"] = (convert.snapshot_from_repro(
        {"keys": snap["keys"],
         "values": [np.asarray(v) for v in snap["values"]],
         "deltas": [np.asarray(d) for d in snap["deltas"]],
         "step": snap["step"]}), m.supersteps)

    s6 = rc.GraphSession(rg.rmat_graph(96, 3, seed=5), BLOCK, capacity=2,
                         seed=0)
    h6 = s6.submit(ra.SSSP(source=1))
    s6.run(rc.TwoLevel(), 20000)
    out["odd"] = s6.result(h6)
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(ranks.world4, 4, device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("world4")))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, world4, refs):
    snaps = {"port": world4["fault"]["snapshot"],
             "repro": refs["fault_snapshot"][0]}
    return run_world(ranks.world2, 2, device="cpu",
                     store_dir=str(tmp_path_factory.mktemp("world2")),
                     args=(snaps,))


def test_ranks_import_neither_jax_nor_repro(world4, world2):
    assert world4["imports_clean"] and world2["imports_clean"]


# ---------------------------------------------------------------------------
# job mesh (2 ranks): tests/test_dist_graph.py's eight jobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", ["two_level", "fused"])
def test_job_mesh_equals_one_device(world2, call):
    """The job mesh reaches the port's one-device run (in the same world,
    no mesh) bit for bit, with the same supersteps and tile_loads (four
    jobs a rank)."""
    got = world2["jobs/" + call]
    want = world2["one_device"][(8, "run_" + call)]
    assert got["local_jobs"] == 4
    assert got["metrics"]["converged"] and want["metrics"]["converged"]
    assert got["metrics"]["supersteps"] == want["metrics"]["supersteps"]
    assert got["metrics"]["tile_loads"] == want["metrics"]["tile_loads"]
    np.testing.assert_array_equal(got["results"], want["results"])


def test_job_mesh_matches_repro(world2, refs):
    """Against repro's one-device two-level run: the same schedule
    (supersteps, tile_loads) and the port's one-device result bar."""
    got = world2["jobs/two_level"]
    want, m = refs["jobs8"]
    assert got["metrics"]["supersteps"] == m.supersteps
    assert got["metrics"]["tile_loads"] == m.tile_loads
    np.testing.assert_allclose(got["results"], want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(world2["jobs/fused"]["results"], want,
                               rtol=1e-4, atol=1e-6)


def test_job_mesh_remainder_replicates(world2, refs):
    """J=5 on two ranks: replicated, still exact, one warning."""
    got = world2["jobs/remainder"]
    assert got["local_jobs"] == 5
    assert len(got["warnings"]) == 1
    assert "jobs-replicated" in got["warnings"][0]
    np.testing.assert_array_equal(
        got["results"], world2["one_device"][(5, "run_two_level")]["results"])
    np.testing.assert_allclose(got["results"], refs["jobs5"][0], rtol=1e-4,
                               atol=1e-6)
    assert world2["shard_run"] == (4, 16, BLOCK)


# ---------------------------------------------------------------------------
# jobs x blocks (4 ranks): tests/test_dist_mesh2d.py's session
# ---------------------------------------------------------------------------


def _check_core(results, refs):
    want = refs["core"][0]
    np.testing.assert_array_equal(results[2], want[2])
    np.testing.assert_array_equal(results[3], want[3])
    _close(results[0], want[0])
    _close(results[1], want[1])


def _frontier_bound(run, supersteps):
    return supersteps * (sum(c * run["q"] * BLOCK * 4
                             for c in run["capacities"])
                         + 8 * run["num_blocks"])


@pytest.mark.parametrize("policy", ["fused", "two_level"])
def test_blocks_mesh_fixpoint(world4, refs, policy):
    run = world4["1x4/" + policy]
    assert run["metrics"]["converged"]
    _check_core(run["results"], refs)


@pytest.mark.parametrize("policy", ["fused", "two_level"])
def test_blocks_mesh_shard_bytes(world4, policy):
    """Every rank's pair tiles, per view, are at most half the view's."""
    run = world4["1x4/" + policy]
    for rank_bytes in run["shard_bytes"]:
        for got, whole in zip(rank_bytes, run["view_bytes"]):
            assert got <= whole // 2, (got, whole)
    assert all(len(p) == 4 for p in run["shard_pairs"])


@pytest.mark.parametrize("policy", ["fused", "two_level"])
def test_blocks_mesh_halo_bounded(world4, policy):
    run = world4["1x4/" + policy]
    m = run["metrics"]
    assert 0 < m["halo_bytes"] <= _frontier_bound(run, m["supersteps"])
    tile_bytes = sum(run["view_bytes"])
    assert m["halo_bytes"] < tile_bytes * m["supersteps"]
    np.testing.assert_array_equal(run["series"]["halo"].sum(),
                                  m["halo_bytes"])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_graph_dryrun_equals_the_world_call_for_call(world4, shape):
    """One `Fused(steps_per_sync=1)` superstep of a session placed empty
    and then given its jobs: the graph dry run of every rank in a fake
    world of 4 on the meta device makes the gloo world's calls (op,
    bytes, group, dtype, shape), holds its bytes to the byte and counts
    its FLOPs."""
    from repro_torch.launch.graph_dryrun import dry_run_session
    real = world4["dryrun/%dx%d" % shape]
    assert len(real) == 4
    for rank, mine in enumerate(real):
        dry = dry_run_session(ranks.dry_core, shape, rank)
        assert [tuple(c) for c in dry["calls"]] == mine["calls"], rank
        assert dry["resident_bytes"] == mine["resident_bytes"], rank
        assert dry["flops"] == mine["flops"] > 0, rank
        assert len(mine["calls"]) >= 3


@pytest.mark.parametrize("policy", ["fused", "two_level"])
def test_record_hook_changes_no_count_or_result(world4, policy):
    """`Mesh2DSpec.all_reduce` lists its calls in `comm.record()`; inside
    it the (1 x 4) runs keep `COLLECTIVES`, `comm.STATS`, their metrics
    and their results bit for bit."""
    plain, rec = world4["plain/" + policy], world4["recorded/" + policy]
    assert plain["calls"] == [] and len(rec["calls"]) == rec["collectives"]
    assert rec["collectives"] == plain["collectives"] > 0
    assert rec["comm_stats"] == plain["comm_stats"]
    for key, val in plain["metrics"].items():
        if key not in ("wall_time_s", "collective_s"):
            np.testing.assert_array_equal(rec["metrics"][key], val, key)
    for got, want in zip(rec["results"], plain["results"]):
        np.testing.assert_array_equal(got, want)
    assert {c.op for c in rec["calls"]} == {"all-reduce"}


def test_host_halo_is_the_frontier(world4):
    """On the host driver every superstep's halo is the occupied queue
    slots x Vb x 4 bytes x live jobs (`host_halo_bytes`)."""
    s = world4["1x4/two_level"]["series"]
    np.testing.assert_array_equal(
        s["halo"], s["occ"].astype(np.float64) * BLOCK * 4 * s["active"])


@pytest.mark.parametrize("name", [g[0] for g in ranks.GRID])
def test_policy_grid_2x2(world4, refs, name):
    run = world4["2x2/" + name]
    assert run["metrics"]["converged"], name
    _check_core(run["results"], refs)


@pytest.mark.parametrize("name", [g[0] for g in ranks.GRID])
def test_policy_grid_halo_bounded(world4, name):
    m = world4["2x2/" + name]["metrics"]
    core = world4["1x4/fused"]
    assert 0 < m["halo_bytes"] <= _frontier_bound(core, m["supersteps"])


def test_host_two_level_2x2_equals_one_device(world4, refs):
    """The host driver's schedule is the one-device schedule: supersteps
    equal repro's, min-plus bitwise."""
    m = world4["2x2/host/two_level"]["metrics"]
    assert m["supersteps"] == refs["core"][1].supersteps
    assert m["tile_loads"] == refs["core"][1].tile_loads


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_compressed_halo(world4, refs, shape):
    """int8 frontier rows with error feedback: min-plus bitwise (never
    quantized), plus-times within the bar, a smaller payload."""
    run = world4[shape + "/compressed"]
    assert run["metrics"]["converged"]
    _check_core(run["results"], refs)
    plain = world4[("1x4/fused" if shape == "1x4" else "2x2/device/fused")]
    assert 0 < run["metrics"]["halo_bytes"] < plain["metrics"]["halo_bytes"]


@pytest.mark.parametrize("policy", ["two_level", "fused"])
def test_overlay_rides_along_on_a_mesh(world4, policy):
    """Views with live overlay entries and a pending dirty-block boost
    (two update batches before placement) on (2 x 2): each shard applies
    the overlay edges whose destinations it owns; min-plus bit-equal to
    the same session on one device, plus-times within the bar."""
    run = world4["overlay/" + policy]
    assert run["metrics"]["converged"] and all(n > 0 for n in run["live"])
    for sr, got, want in zip(run["semirings"], run["results"],
                             run["one_device"]):
        if sr == "min_plus":
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want)


def test_blocks_fallback_warns_once(world4, refs):
    """B_N = 6 on four block shards: blocks-replicated, one warning, the
    one-device fixpoint; the same layout again stays silent."""
    fb = world4["fallback"]
    assert len(fb["blocks"]["warnings"]) == 1
    assert "blocks-replicated" in fb["blocks"]["warnings"][0]
    assert fb["blocks_again"]["warnings"] == []
    for tag in ("blocks", "blocks_again", "jobs"):
        assert fb[tag]["converged"]
        np.testing.assert_array_equal(fb[tag]["result"], refs["odd"])


def test_jobs_fallback_warns(world4):
    msgs = world4["fallback"]["jobs"]["warnings"]
    assert any("jobs-replicated" in m for m in msgs), msgs


def test_step_cache_one_entry_per_placement(world4, refs):
    """Entering, leaving and re-entering a mesh: one step-function entry
    for one device, one for the mesh, none added after."""
    c = world4["cache"]
    assert c["sizes"] == [1, 2, 2, 2]
    assert c["keys"] == 2
    np.testing.assert_array_equal(c["results"][2], refs["core"][0][2])


# ---------------------------------------------------------------------------
# elastic reshard: checkpoint on (2 x 2), restore onto (1 x 2) / one device
# ---------------------------------------------------------------------------


def test_checkpoint_gathers_whole_state(world4):
    snap = world4["fault"]["snapshot"]
    assert world4["fault"]["metrics"]["supersteps"] == 5
    assert not world4["fault"]["metrics"]["converged"]
    # the host backend draws from the scheduler's generator, whose state
    # the snapshot carries; the device stream position stays at 0
    assert snap["step"] == 0 and snap["rng"] is not None
    for v, d in zip(snap["values"], snap["deltas"]):
        assert v.shape == d.shape and v.shape[0] == 2
        assert v.shape[1:] == (8, BLOCK)


def _check_fault(results, supersteps, refs):
    want, m = refs["fault"]
    assert 5 + supersteps == m.supersteps, (supersteps, m.supersteps)
    np.testing.assert_array_equal(results[0], want[0])
    np.testing.assert_array_equal(results[1], want[1])
    _close(results[2], want[2])


@pytest.mark.parametrize("source", ["port", "repro"])
def test_restore_onto_smaller_mesh(world2, refs, source):
    run = world2["restore/" + source]
    assert run["metrics"]["converged"]
    _check_fault(run["results"], run["metrics"]["supersteps"], refs)


@pytest.mark.parametrize("source", ["port", "repro"])
def test_restore_onto_one_device(world4, refs, source):
    import repro_torch.core as tc
    from repro_torch.dist.fault import restore_session
    snap = (world4["fault"]["snapshot"] if source == "port"
            else refs["fault_snapshot"][0])
    sess, hs = ranks.build_fault()
    restore_session(sess, snap)
    m = sess.run(tc.TwoLevel(), 20000)
    assert m.converged
    _check_fault([sess.result(h) for h in hs], m.supersteps, refs)


def test_snapshot_from_repro_is_numpy(refs):
    snap, pre = refs["fault_snapshot"]
    assert pre == 5 and snap["step"] == 0 and snap["rng"] is None
    assert all(isinstance(k, tuple) for k in snap["keys"])
    assert all(v.dtype == np.float32 for v in snap["values"])


# ---------------------------------------------------------------------------
# quantize_ef against repro.dist.compression (the reference test's inputs)
# ---------------------------------------------------------------------------


def _frontier_deltas(seed=0, j=3, b=4, vb=16, density=0.25):
    rng = np.random.default_rng(seed)
    t = rng.normal(scale=0.1, size=(j, b, vb)).astype(np.float32)
    t *= rng.random((j, b, vb)) < density
    t[:, 1, :] = 0.0
    return t


def _both(t, **kw):
    from repro.dist.compression import quantize_ef as r_q
    from repro_torch.dist.compression import quantize_ef as t_q
    want = [np.asarray(x) for x in r_q(t, **kw)]
    got = [x.numpy() for x in t_q(torch.from_numpy(t), **kw)]
    return got, want


@pytest.mark.parametrize("axis", [-1, None, (1, 2)])
def test_quantize_ef_equals_reference(axis):
    t = _frontier_deltas(seed=1)
    (deq, err), (r_deq, r_err) = _both(t, bits=8, axis=axis)
    np.testing.assert_array_equal(deq, r_deq)
    np.testing.assert_array_equal(err, r_err)
    np.testing.assert_allclose(deq + err, t, rtol=0, atol=1e-6)
    assert not deq[:, 1, :].any() and not err[:, 1, :].any()


def test_quantize_ef_per_row_scales():
    t = np.zeros((2, 2, 16), np.float32)
    t[0, 0, :4] = [1e3, -2e3, 5e2, 1.5e3]
    t[1, 1, :4] = [1e-3, -2e-3, 5e-4, 1.5e-3]
    (deq, err), (r_deq, r_err) = _both(t, bits=8, axis=-1)
    np.testing.assert_array_equal(deq, r_deq)
    np.testing.assert_array_equal(err, r_err)
    assert np.abs(err[1, 1]).max() <= 2e-3 / 127 + 1e-12


def test_quantize_ef_error_feedback_telescopes():
    from repro.dist.compression import quantize_ef as r_q
    from repro_torch.dist.compression import quantize_ef as t_q
    err = np.zeros((3, 4, 16), np.float32)
    r_err = err.copy()
    sent = np.zeros_like(err)
    produced = np.zeros_like(err)
    for k in range(12):
        t = _frontier_deltas(seed=100 + k)
        deq, e = t_q(torch.from_numpy(t + err), bits=8, axis=-1)
        deq, err = deq.numpy(), e.numpy()
        r_deq, r_err = (np.asarray(x) for x in r_q(t + r_err, bits=8,
                                                   axis=-1))
        np.testing.assert_array_equal(deq, r_deq)
        np.testing.assert_array_equal(err, r_err)
        sent += deq
        produced += t
    np.testing.assert_allclose(produced - sent, err, rtol=0, atol=1e-4)
    assert np.abs(err).max() < 0.05


def test_run_world_reports_a_failing_rank(tmp_path):
    with pytest.raises(Exception, match="rank 1 failed"):
        run_world(ranks.fail_on_rank_one, 2, device="cpu",
                  store_dir=str(tmp_path))


def test_nccl_needs_a_card_per_rank():
    from repro_torch.dist.world import choose_backend
    assert choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError):
        choose_backend("cpu", 2, "nccl")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="one card per rank"):
        choose_backend("cuda", n + 1, "nccl")
