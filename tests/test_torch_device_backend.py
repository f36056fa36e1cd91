"""The port's device scheduling backend, engine shim and paper API on the
CPU, against the reference.

* Every policy on ``backend="device"`` (TwoLevel at steps_per_sync 1, 4
  and inf, Fused, Independent, AllBlocks) reaches the reference's
  host-backend fixpoint on the random graphs and job mixes of
  tests/test_policy_properties.py:92-117: min-plus bit-equal, plus-times
  rtol 1e-4, atol 1e-6.
* The schedule does not depend on the cadence (supersteps, tile_loads,
  tile_pair_loads identical across K); host_syncs is one per chunk.
* A converged group is never pushed; the draw's stream advances across
  runs and `reset` restores it; `Fused()` and the literal
  `TwoLevel(backend="device", steps_per_sync=inf)` share one cached step
  (tests/test_device_scheduler.py:165-178, :303-339).
* The engine shim reaches the reference shim's fixpoints and equals a
  static session batch bit for bit (tests/test_session.py:71-84); the
  paper API loop reaches the reference's min-plus fixpoint bitwise.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as ra  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.graph as rg  # noqa: E402
import repro_torch.algorithms as ta  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402

BLOCK = 16


def _edges(seed, n, deg, weighted):
    """tests/test_policy_properties.py:_random_csr's edge list."""
    rng = np.random.default_rng(seed)
    m = n * deg
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    w = rng.uniform(0.5, 4.0, m).astype(np.float32) if weighted else None
    return n, src, dst, w


def _specs(seed, n, weighted):
    """tests/test_policy_properties.py:_job_mix as (name, kwargs) specs."""
    rng = np.random.default_rng(seed + 1)
    pool = [lambda: ("Katz", dict(alpha=0.02)),
            lambda: ("SSSP", dict(source=int(rng.integers(n)))),
            lambda: ("BFS", dict(source=int(rng.integers(n))))]
    if not weighted:
        pool += [lambda: ("PageRank",
                          dict(damping=float(rng.uniform(0.6, 0.9)))),
                 lambda: ("PersonalizedPageRank",
                          dict(source=int(rng.integers(n))))]
    k = int(rng.integers(2, 5))
    return [pool[int(rng.integers(len(pool)))]() for _ in range(k)]


def _algs(mod, specs):
    return [getattr(mod, name)(**kw) for name, kw in specs]


def _check(specs, got, want):
    for (name, _), g, w in zip(specs, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        if name in ("SSSP", "BFS", "WCC"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def _ref_fixpoint(edges, specs, seed):
    sess = rc.GraphSession(rg.CSRGraph.from_edges(*edges), BLOCK,
                           capacity=2, seed=seed)
    hs = [sess.submit(a) for a in _algs(ra, specs)]
    assert sess.run(rc.TwoLevel(), 50000).converged
    return [sess.result(h) for h in hs]


def _port_run(edges, specs, policy, seed, use_pallas=False):
    sess = tc.GraphSession(tg.CSRGraph.from_edges(*edges), BLOCK,
                           capacity=2, seed=seed, device="cpu",
                           use_pallas=use_pallas)
    hs = [sess.submit(a) for a in _algs(ta, specs)]
    m = sess.run(policy, 50000)
    assert m.converged, (policy.name, specs)
    return m, [sess.result(h) for h in hs]


GRAPHS = [(11, 40, 3, False), (12, 24, 2, True), (13, 56, 4, False),
          (14, 40, 1, False)]


def _grid():
    return {"two_level_k1": tc.TwoLevel(backend="device", steps_per_sync=1),
            "two_level_k4": tc.TwoLevel(backend="device", steps_per_sync=4),
            "two_level_inf": tc.TwoLevel(backend="device",
                                         steps_per_sync=math.inf),
            "fused": tc.Fused(),
            "independent": tc.Independent(backend="device"),
            "all_blocks": tc.AllBlocks(backend="device", steps_per_sync=4)}


@pytest.mark.parametrize("seed,n,deg,weighted", GRAPHS)
def test_device_policies_reach_reference_host_fixpoint(seed, n, deg,
                                                       weighted):
    edges = _edges(seed, n, deg, weighted)
    specs = _specs(seed, n, weighted)
    want = _ref_fixpoint(edges, specs, seed % 97)
    metrics = {}
    for name, policy in _grid().items():
        m, got = _port_run(edges, specs, policy, seed % 97)
        _check(specs, got, want)
        metrics[name] = m
    # the schedule does not depend on the cadence
    two_level = [metrics[k] for k in ("two_level_k1", "two_level_k4",
                                      "two_level_inf", "fused")]
    for m in two_level[1:]:
        assert (m.supersteps, m.tile_loads, m.tile_pair_loads,
                m.job_block_pushes) == (
            two_level[0].supersteps, two_level[0].tile_loads,
            two_level[0].tile_pair_loads, two_level[0].job_block_pushes)
        np.testing.assert_array_equal(m.iterations_per_job,
                                      two_level[0].iterations_per_job)
    for name, m in metrics.items():
        chunk = _grid()[name].steps_per_sync
        chunk = tpol.INF_CHUNK if chunk == math.inf else chunk
        assert m.host_syncs == math.ceil(m.supersteps / chunk), name


def test_fused_kernel_route_on_cpu_matches_plain_route():
    """use_pallas=True on the CPU takes the fused superstep's plain
    version inside the device chunk: the same trajectory, min-plus
    bitwise."""
    edges = _edges(5, 48, 3, False)
    specs = [("PageRank", {}), ("SSSP", dict(source=2)),
             ("BFS", dict(source=7))]
    m0, r0 = _port_run(edges, specs, tc.Fused(), 3, use_pallas=False)
    m1, r1 = _port_run(edges, specs, tc.Fused(), 3, use_pallas=True)
    np.testing.assert_array_equal(r1[1], r0[1])
    np.testing.assert_array_equal(r1[2], r0[2])
    np.testing.assert_allclose(r1[0], r0[0], rtol=1e-5, atol=1e-7)
    assert m1.tile_pair_loads > 0


def test_device_run_metrics_match_host_accounting():
    """tile_loads counts the staged slots, job_block_pushes the (job,
    block) pairs dispatched, iterations_per_job the supersteps each slot
    was active: the same accounting the host driver keeps."""
    csr = tg.rmat_graph(200, 4, seed=3)
    sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=1, device="cpu")
    sess.submit(ta.PageRank())
    sess.submit(ta.SSSP(source=5))
    m = sess.run(tc.AllBlocks(backend="device", steps_per_sync=3), 20000)
    bn = sess.scheduler.num_blocks
    assert m.converged and m.tile_loads == bn * m.supersteps
    assert m.job_block_pushes == bn * int(m.iterations_per_job.sum())
    assert m.iterations_per_job.max() == m.supersteps
    assert m.iterations_per_job.dtype == np.int64


def test_device_backend_never_pushes_a_converged_group():
    """tests/test_device_scheduler.py:303-327: once PageRank(0.5) on a
    30x30 grid has converged, further device supersteps (SSSP still
    hot) leave its group bit-identical."""
    sess = tc.GraphSession(tg.grid_graph(30), 32, capacity=1, seed=3,
                           device="cpu")
    h_pr = sess.submit(ta.PageRank(damping=0.5))
    h_ss = sess.submit(ta.SSSP(source=0))
    pol = tc.TwoLevel(backend="device")
    for _ in range(500):
        if sess.converged(h_pr):
            break
        sess.run(pol, max_supersteps=1)
    assert sess.converged(h_pr) and not sess.converged(h_ss)
    pt = [g for g in sess.view_groups() if g.semiring == "plus_times"][0]
    snap_v, snap_d = pt.values.clone(), pt.deltas.clone()
    m = sess.run(tc.TwoLevel(backend="device", steps_per_sync=4),
                 max_supersteps=10)
    assert m.supersteps == 10 and not sess.converged(h_ss)
    assert torch.equal(pt.values, snap_v) and torch.equal(pt.deltas, snap_d)


def test_gated_superstep_leaves_state_bit_identical():
    """A chunk longer than the budget: the supersteps past it are gated,
    leave the state exactly as it was and count nothing."""
    csr = tg.rmat_graph(200, 4, seed=3)
    out = {}
    for k in (1, 8):
        sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=2, device="cpu")
        sess.submit(ta.PageRank())
        sess.submit(ta.SSSP(source=1))
        m = sess.run(tc.TwoLevel(backend="device", steps_per_sync=k), 3)
        assert m.supersteps == 3 and not m.converged
        assert sess.scheduler._step == 3
        out[k] = (m, [g.values.clone() for g in sess.view_groups()],
                  [g.deltas.clone() for g in sess.view_groups()])
    (m1, v1, d1), (m8, v8, d8) = out[1], out[8]
    assert (m1.tile_loads, m1.job_block_pushes, m1.tile_pair_loads) == (
        m8.tile_loads, m8.job_block_pushes, m8.tile_pair_loads)
    assert m1.host_syncs == 3 and m8.host_syncs == 1
    for a, b in zip(v1 + d1, v8 + d8):
        assert torch.equal(a, b)


def test_device_run_advances_the_stream_and_reset_restores_it():
    """tests/test_device_scheduler.py:165-178: the stream position
    advances by the supersteps consumed, so the next run draws fresh
    numbers; reset() restores it, and the same state then replays the
    same trajectory."""
    csr = tg.rmat_graph(300, 5, seed=7)

    def fresh():
        s = tc.GraphSession(csr, 32, capacity=2, seed=5, device="cpu")
        s.submit(ta.PageRank())
        return s

    sess = fresh()
    pos0 = sess.scheduler._step
    m1 = sess.run(tc.TwoLevel(backend="device"), max_supersteps=5)
    assert sess.scheduler._step == pos0 + m1.supersteps == pos0 + 5
    m2 = sess.run(tc.TwoLevel(backend="device"), 20000)
    assert m2.converged
    assert sess.scheduler._step == pos0 + m1.supersteps + m2.supersteps
    # a second session reset after 5 supersteps replays the run from
    # stream position 0, not the first session's continuation
    other = fresh()
    other.run(tc.TwoLevel(backend="device"), max_supersteps=5)
    other.scheduler.reset()
    m3 = other.run(tc.TwoLevel(backend="device"), 20000)
    assert m3.converged and other.scheduler._step == m3.supersteps
    replay = fresh()
    replay.run(tc.TwoLevel(backend="device"), max_supersteps=5)
    replay.scheduler.reset()
    m4 = replay.run(tc.Fused(), 20000)
    assert (m4.supersteps, m4.tile_loads) == (m3.supersteps, m3.tile_loads)


def test_fused_and_explicit_device_two_level_share_one_step():
    """tests/test_device_scheduler.py:329-339: one cache entry for both,
    and from the same state and stream position one trajectory."""
    csr = tg.rmat_graph(300, 5, seed=7)
    ms = []
    sess = tc.GraphSession(csr, 32, capacity=2, seed=5, device="cpu")
    sess.submit(ta.PageRank())
    for pol in (tc.Fused(), tc.TwoLevel(backend="device",
                                        steps_per_sync=math.inf)):
        h = sess.submit(ta.PersonalizedPageRank(source=7))
        sess.scheduler.reset()
        ms.append(sess.run(pol, 20000))
        assert ms[-1].converged
        sess.detach(h)
    assert len([k for k in sess._jit_cache if k[0] == "superstep"]) == 1
    assert ms[0].tile_loads > 0
    # a finite cadence is a different chunk function
    sess.run(tc.Fused(steps_per_sync=4), 20000)
    assert len([k for k in sess._jit_cache if k[0] == "superstep"]) == 2


def test_device_step_is_reused_across_runs_and_resubmissions():
    csr = tg.rmat_graph(300, 5, seed=7)
    sess = tc.GraphSession(csr, 32, capacity=2, seed=5, device="cpu")
    h0 = sess.submit(ta.PageRank())
    assert sess.run(tc.Fused(), 20000).converged
    sess.submit(ta.PersonalizedPageRank(source=7))
    assert sess.run(tc.Fused(), 20000).converged
    sess.detach(h0)
    sess.submit(ta.PageRank(damping=0.6))          # recycled slot
    assert sess.run(tc.Fused(), 20000).converged
    assert len(sess._jit_cache) == 1


# --- engine shim -------------------------------------------------------------

SHIM_CSR = dict(n=150, deg=4, seed=13)


def _shim(pkg, mod, specs, **kw):
    g = rg if pkg is rc else tg
    csr = g.rmat_graph(SHIM_CSR["n"], SHIM_CSR["deg"], seed=SHIM_CSR["seed"])
    dev = {} if pkg is rc else {"device": "cpu"}
    run = pkg.make_run(_algs(mod, specs), csr, BLOCK, **dev)
    return pkg.ConcurrentEngine(run, seed=11, **kw)


SHIM_CALLS = {
    "two_level": lambda e: e.run_two_level(20000),
    "two_level_device": lambda e: e.run_two_level(
        20000, backend="device", steps_per_sync=4),
    "fused": lambda e: e.run_fused(20000),
    "fused_k2": lambda e: e.run_fused(20000, steps_per_sync=2),
    "independent": lambda e: e.run_independent(20000),
    "all_blocks": lambda e: e.run_all_blocks(20000),
}


@pytest.mark.parametrize("specs", [
    [("PageRank", dict(damping=0.85)), ("PageRank", dict(damping=0.7))],
    [("SSSP", dict(source=0)), ("SSSP", dict(source=17)),
     ("SSSP", dict(source=3))]], ids=["plus_times", "min_plus"])
def test_engine_shim_reaches_reference_shim_fixpoint(specs):
    ref = _shim(rc, ra, specs)
    ref.run_two_level(20000)
    want = ref.results()
    eng = _shim(tc, ta, specs)
    assert eng.use_pallas is False            # use_pallas=None on the CPU
    for name, call in SHIM_CALLS.items():
        m = call(eng)
        assert m.converged, name
        got = eng.results()
        assert got.shape == want.shape and got.dtype == np.float32
        _check(specs, list(got), list(want))
    # the host backend's shim equals the reference shim's schedule (the
    # same numpy stream, restarted per call)
    m_r = ref.run_two_level(20000)
    m_t = eng.run_two_level(20000)
    if specs[0][0] == "SSSP":
        assert (m_t.supersteps, m_t.tile_loads) == (m_r.supersteps,
                                                    m_r.tile_loads)


def test_session_static_batch_is_bitwise_equal_to_engine_shim():
    """tests/test_session.py:71-84, in the port, on both backends."""
    specs = [("PageRank", dict(damping=0.85)), ("PageRank",
                                                 dict(damping=0.7))]
    csr = tg.rmat_graph(SHIM_CSR["n"], SHIM_CSR["deg"],
                        seed=SHIM_CSR["seed"])
    for shim_call, pol in (
            (lambda e: e.run_two_level(20000), tc.TwoLevel()),
            (lambda e: e.run_fused(20000), tc.Fused())):
        eng = _shim(tc, ta, specs)
        m_e = shim_call(eng)
        sess = tc.GraphSession(csr, BLOCK, capacity=2, seed=11,
                               device="cpu")
        handles = [sess.submit(a) for a in _algs(ta, specs)]
        m_s = sess.run(pol, 20000)
        assert m_e.converged and m_s.converged
        assert (m_e.supersteps, m_e.tile_loads, m_e.job_block_pushes) == (
            m_s.supersteps, m_s.tile_loads, m_s.job_block_pushes)
        np.testing.assert_array_equal(
            eng.results(), np.stack([sess.result(h) for h in handles]))


def test_engine_shim_properties_and_unported_mesh():
    eng = _shim(tc, ta, [("SSSP", dict(source=0))])
    assert eng.q == eng.session.q and eng.seed == 11
    eng.alpha = 0.5
    eng.samples = 40
    eng.seed = 3
    assert (eng.session.alpha, eng.session.samples, eng.session.seed) == (
        0.5, 40, 3)
    eng.use_pallas = True
    assert eng.session.use_pallas is True
    # mesh= is ported (repro_torch.dist) and takes a DeviceMesh
    for call in (lambda: eng.run_two_level(mesh=object()),
                 lambda: eng.run_fused(mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    with pytest.raises(ValueError, match="share one graph view"):
        tc.make_run([ta.SSSP(), ta.PageRank()], tg.chain_graph(20), BLOCK,
                    device="cpu")


# --- the paper's four-function API ------------------------------------------


def test_paper_api_loop_reaches_reference_min_plus_fixpoint():
    """initPtable -> (De_In_Priority -> De_Gl_Priority -> Con_processing)*
    in the port reaches the reference's fixpoint bit for bit, and each
    superstep's queues equal the reference's (the same numpy stream,
    identical pairs: SSSP's priorities are exact)."""
    csr_r = rg.uniform_graph(120, 4, seed=21, weighted=True, w_max=7.0)
    csr_t = tg.uniform_graph(120, 4, seed=21, weighted=True, w_max=7.0)
    specs = [("SSSP", dict(source=0)), ("SSSP", dict(source=33))]
    run_r = rc.make_run(_algs(ra, specs), csr_r, BLOCK)
    run_t = tc.make_run(_algs(ta, specs), csr_t, BLOCK, device="cpu")
    a_t = run_t.algs[0]
    v0, d0 = tc.initPtable(a_t, run_t.graph)
    np.testing.assert_array_equal(v0.numpy(), np.asarray(run_r.values[0]))
    bn = run_t.graph.num_blocks
    q = tc.optimal_queue_length(bn, run_t.graph.n_real)
    rng_r, rng_t = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(500):
        jq_r = rc.De_In_Priority(run_r.algs[0], run_r.values, run_r.deltas,
                                 q, rng_r)
        jq_t = tc.De_In_Priority(a_t, run_t.values, run_t.deltas, q, rng_t)
        for a, b in zip(jq_t, jq_r):
            np.testing.assert_array_equal(a, b)
        gq_r = rc.De_Gl_Priority(jq_r, bn, q)
        gq_t = tc.De_Gl_Priority(jq_t, bn, q)
        np.testing.assert_array_equal(gq_t, gq_r)
        if len(gq_t) == 0:
            break
        v_r, d_r = rc.Con_processing(run_r, gq_r, q)
        v_t, d_t = tc.Con_processing(run_t, gq_t, q)
        run_r.values, run_r.deltas = v_r, d_r
        run_t.values, run_t.deltas = v_t, d_t
    else:
        pytest.fail("the paper API loop did not converge")
    np.testing.assert_array_equal(run_t.values.numpy(),
                                  np.asarray(run_r.values))
    np.testing.assert_array_equal(run_t.deltas.numpy(),
                                  np.asarray(run_r.deltas))


@pytest.mark.parametrize("splits", [(6,), (2, 1, 3)], ids=["one_run",
                                                          "three_runs"])
def test_list_interface_loop_stages_what_the_device_driver_stages(splits):
    """One device scheduling stream: a paper-API loop whose queues come
    from `TwoLevelScheduler(backend="device")` (pairs -> select ->
    Con_processing) and a one-view session driven by
    `TwoLevel(backend="device")` over the same supersteps, in one run or
    several, reach the same min-plus state bit for bit."""
    csr = tg.uniform_graph(320, 4, seed=8, weighted=True, w_max=7.0)
    specs = [("SSSP", dict(source=0)), ("SSSP", dict(source=171))]
    run_l = tc.make_run(_algs(ta, specs), csr, BLOCK, device="cpu")
    run_d = tc.make_run(_algs(ta, specs), csr, BLOCK, device="cpu")
    # a short queue and a small sample, so the draw decides the schedule
    sess = tc.GraphSession.from_run(run_d, c=5.0, samples=6, seed=6)
    assert sess.q < sess.scheduler.num_blocks
    for n in splits:
        assert sess.run(tc.TwoLevel(backend="device"), n).supersteps == n
    sched = tc.TwoLevelScheduler(sess.scheduler.num_blocks, sess.q,
                                 samples=6, seed=6,
                                 backend="device", device="cpu")
    alg = run_l.algs[0]
    for _ in range(sum(splits)):
        nu, pm = (x.numpy() for x in tc.compute_pairs(alg, run_l.values,
                                                      run_l.deltas))
        _, gq = sched.select(nu, pm)
        run_l.values, run_l.deltas = tc.Con_processing(run_l, gq, sess.q)
    assert sched._step == sess.scheduler._step == sum(splits)
    grp = sess.view_groups()[0]
    assert torch.equal(run_l.values, grp.values)
    assert torch.equal(run_l.deltas, grp.deltas)
