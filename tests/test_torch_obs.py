"""Parity of the port's telemetry (repro_torch.obs.telemetry, the drivers'
series, the session's trace tracks) with repro's, on the CPU.

The reference's own sizes (tests/test_obs.py, tests/test_serve_slo.py):
rmat_graph(300, 5, seed=7), Vb = 32, PageRank + SSSP(0) in two views.

  * the host-backend series equals the reference's column for column
    under TwoLevel, Independent and AllBlocks (max_residual at rtol 1e-6:
    the pair reduction's lane sums differ by a few ulp);
  * the series sums equal the run totals on every policy x cadence and
    under Fused;
  * telemetry on leaves the fixpoint bitwise unchanged and adds no host
    read;
  * the host and device series are equal within the port;
  * capacity truncation, the dirty_blocks spike, trace counter tracks,
    to_dict and coerce;
  * the spans of both drivers and of the session (names, parents, counts,
    job ids, totals), spans off recording nothing, spans without the
    series (capacity 0), and the recorder's clock against Kineto's.

Known difference: under steps_per_sync=inf the port's device driver runs
chunks of INF_CHUNK = 16 supersteps, so a full series comes at
ceil(supersteps / 16) host reads where the reference reports 1
(tests/test_obs.py:99).
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as ra  # noqa: E402
import repro.core as rc  # noqa: E402
import repro.graph as rg  # noqa: E402
import repro.obs as ro  # noqa: E402
import repro.stream as rs  # noqa: E402
import repro_torch.algorithms as ta  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import repro_torch.obs as to  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core.policy import INF_CHUNK, device_inputs  # noqa: E402
from repro_torch.obs import telemetry as ttel  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops, which one intra-op thread runs
    fastest; under a parallel test run more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {"ref": (rc, ra, rg, ro, rs, {}),
        "port": (tc, ta, tg, to, ts, {"device": "cpu"})}
POLICIES = ["TwoLevel", "Independent", "AllBlocks"]
CADENCES = {"host": dict(), "device": dict(backend="device"),
            "device_inf": dict(backend="device", steps_per_sync=math.inf)}
INT_COLUMNS = ("active_jobs", "tile_loads", "job_block_pushes",
               "gq_occupancy", "dirty_blocks", "tile_pair_loads",
               "halo_bytes", "unconverged")


def _session(pkg="port", telemetry=True, **kw):
    c, a, g, _, _, dev = PKGS[pkg]
    sess = c.GraphSession(g.rmat_graph(300, 5, seed=7), 32, capacity=2,
                          seed=3, telemetry=telemetry, **kw, **dev)
    sess.submit(a.PageRank())
    sess.submit(a.SSSP(source=0))
    return sess


def _policy(pkg, name, **kw):
    return getattr(PKGS[pkg][0].policy, name)(**kw)


def _same_series(a, b):
    assert len(a) == len(b)
    for f in INT_COLUMNS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    np.testing.assert_allclose(a.max_residual, b.max_residual, rtol=1e-6,
                               atol=1e-7)


# --- config and series surface ----------------------------------------------


def _fields(cfg):
    """The fields both packages keep (the reference's `jax_profiler` has
    no port counterpart: every port span is a profiler range)."""
    return None if cfg is None else (cfg.capacity, cfg.trace)


@pytest.mark.parametrize("value", [None, False, True, "cfg", 42])
def test_telemetry_config_coerce_matches_reference(value):
    out = {}
    for pkg in PKGS:
        mod = PKGS[pkg][3]
        v = (mod.TelemetryConfig(capacity=16, trace=False) if value == "cfg"
             else value)
        if value == 42:
            with pytest.raises(TypeError):
                mod.TelemetryConfig.coerce(v)
            continue
        got = mod.TelemetryConfig.coerce(v)
        out[pkg] = _fields(got)
        if value == "cfg":
            assert got is v
    assert out.get("ref") == out.get("port")
    assert to.SERIES_FIELDS == ro.SERIES_FIELDS
    assert to.GROUP_FIELDS == ro.GROUP_FIELDS
    assert ttel.DEFAULT_CAPACITY == ro.telemetry.DEFAULT_CAPACITY


def test_telemetry_off_session_records_nothing():
    sess = _session(telemetry=None)
    m = sess.run(tc.TwoLevel(), 500)
    assert m.converged and m.telemetry is None
    assert not sess.trace.enabled and sess.trace.events == []
    to.validate_trace_events(sess.trace.to_json())


def test_trace_follows_the_config():
    assert _session(telemetry=True).trace.enabled
    assert not _session(
        telemetry=to.TelemetryConfig(trace=False)).trace.enabled


# --- the host series against the reference's ---------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_host_series_matches_reference(policy):
    m = {pkg: _session(pkg).run(_policy(pkg, policy), 500) for pkg in PKGS}
    assert m["ref"].converged and m["port"].converged
    assert m["port"].supersteps == m["ref"].supersteps
    assert m["port"].host_syncs == m["ref"].host_syncs
    t = m["port"].telemetry
    assert isinstance(t, to.TelemetrySeries) and not t.truncated
    assert t.num_groups == 2 and t.view_keys == m["ref"].telemetry.view_keys
    _same_series(t, m["ref"].telemetry)
    assert t.max_residual.dtype == np.float32
    assert (t.active_jobs >= 1).all() and (t.dirty_blocks == 0).all()


# --- sums against totals ------------------------------------------------------


@pytest.mark.parametrize("cadence", list(CADENCES))
@pytest.mark.parametrize("policy", POLICIES)
def test_series_sums_reproduce_run_totals(policy, cadence):
    m = _session().run(_policy("port", policy, **CADENCES[cadence]), 500)
    assert m.converged
    tel = m.telemetry
    assert len(tel) == m.supersteps and not tel.truncated
    assert int(tel.tile_loads.sum()) == m.tile_loads
    assert int(tel.job_block_pushes.sum()) == m.job_block_pushes
    assert int(tel.tile_pair_loads.sum()) == m.tile_pair_loads > 0
    assert float(tel.halo_bytes.sum()) == m.halo_bytes == 0.0


def test_series_sums_reproduce_run_totals_fused():
    m = _session().run(tc.Fused(), 500)
    assert m.converged
    tel = m.telemetry
    assert len(tel) == m.supersteps
    assert int(tel.tile_loads.sum()) == m.tile_loads
    assert int(tel.tile_pair_loads.sum()) == m.tile_pair_loads > 0
    # the known difference: one read per INF_CHUNK supersteps, not one
    assert m.host_syncs == math.ceil(m.supersteps / INF_CHUNK)


# --- observation never perturbs ----------------------------------------------


@pytest.mark.parametrize("cadence", list(CADENCES))
def test_telemetry_does_not_perturb_the_fixpoint(cadence):
    """Bitwise: values/deltas after a telemetry-on run equal the
    telemetry-off run's, on every backend and cadence."""
    s_on, s_off = _session(telemetry=True), _session(telemetry=None)
    m_on = s_on.run(tc.TwoLevel(**CADENCES[cadence]), 500)
    m_off = s_off.run(tc.TwoLevel(**CADENCES[cadence]), 500)
    assert m_on.converged and m_off.converged
    for f in ("supersteps", "tile_loads", "tile_pair_loads",
              "job_block_pushes", "host_syncs"):
        assert getattr(m_on, f) == getattr(m_off, f), f
    np.testing.assert_array_equal(m_on.iterations_per_job,
                                  m_off.iterations_per_job)
    for g_on, g_off in zip(s_on.view_groups(), s_off.view_groups()):
        assert torch.equal(g_on.values, g_off.values)
        assert torch.equal(g_on.deltas, g_off.deltas)


@pytest.mark.parametrize("cadence", list(CADENCES))
@pytest.mark.parametrize("policy", ["TwoLevel", "AllBlocks"])
def test_telemetry_adds_no_host_read(monkeypatch, policy, cadence):
    """Every device->host copy the drivers make (`.cpu()`, `.tolist()`,
    `.item()`) is counted: a telemetry-on run makes exactly as many as a
    telemetry-off run."""
    counts = {}
    for on in (True, None):
        sess = _session(telemetry=on)
        pol = _policy("port", policy, **CADENCES[cadence])
        n = [0]
        for name in ("cpu", "tolist", "item"):
            real = getattr(torch.Tensor, name)

            def counted(self, *a, _real=real, **kw):
                n[0] += 1
                return _real(self, *a, **kw)
            monkeypatch.setattr(torch.Tensor, name, counted)
        m = sess.run(pol, 500)
        monkeypatch.undo()
        assert m.converged
        counts[on] = n[0]
    assert counts[True] == counts[None] > 0


@pytest.mark.parametrize("policy", POLICIES + ["Fused"])
def test_host_and_device_record_identical_series(policy):
    """q saturates on this graph, so the host numpy draw and the device
    draw never actually sample: both backends log the same schedule."""
    m_h = _session().run(
        _policy("port", "TwoLevel" if policy == "Fused" else policy), 500)
    m_d = _session().run(
        tc.Fused() if policy == "Fused"
        else _policy("port", policy, backend="device"), 500)
    assert m_h.converged and m_d.converged
    assert m_h.supersteps == m_d.supersteps
    _same_series(m_h.telemetry, m_d.telemetry)


# --- the device buffers -------------------------------------------------------


def test_device_write_is_in_place_and_gated():
    bufs = to.device_buffers(4, 2, "cpu")
    assert bufs.shape == (4, len(to.SERIES_FIELDS) + 2 * 2)
    assert bufs.dtype == torch.float64
    ptr = bufs.data_ptr()
    one = torch.ones((), dtype=torch.int32)

    def row(v, live):
        return to.device_write(
            bufs, torch.tensor([1]), torch.tensor(live), one * v, one * v,
            one * v, one * v, one * v, torch.tensor([v, v]),
            torch.tensor([0.5 * v, v]), one * v)
    row(3, True)
    row(7, False)                     # a gated slot keeps the row
    assert bufs.data_ptr() == ptr
    series = to.series_from_device(bufs, 2, [("a",), ("b",)])
    assert len(series) == 2 and not series.truncated
    np.testing.assert_array_equal(series.tile_loads, [0, 3])
    np.testing.assert_array_equal(series.unconverged, [[0, 0], [3, 3]])
    np.testing.assert_array_equal(series.max_residual, [[0, 0], [1.5, 3]])
    np.testing.assert_array_equal(series.halo_bytes, [0.0, 0.0])
    assert to.series_from_device(bufs, 9, [("a",), ("b",)]).truncated


def test_device_buffers_keep_their_addresses_across_chunks():
    sess = _session(telemetry=to.TelemetryConfig(capacity=64))
    pol = tc.TwoLevel(backend="device", steps_per_sync=4)
    step_fn = sess._device_step_fn(pol)
    state, *args = device_inputs(sess)
    assert len(state) == 9 and state[8].shape[0] == 64
    ptr = state[8].data_ptr()
    for _ in range(3):
        state, _ = step_fn(state, *args, 500, sess.seed, 0)
    assert state[8].data_ptr() == ptr
    tile_loads = state[8][:, to.SERIES_FIELDS.index("tile_loads")]
    assert int(tile_loads[:12].gt(0).sum()) == 12     # 12 rows written
    off = _session(telemetry=None)
    off_state, *_ = device_inputs(off)
    assert len(off_state) == 8


def test_device_totals_are_exact_past_2_24():
    """The device driver's totals count in int64: a carry started past
    2^24 (where float32 steps by 2) still equals the series sum
    exactly."""
    sess = _session()
    step_fn = sess._device_step_fn(
        tc.TwoLevel(backend="device", steps_per_sync=4))
    state, *args = device_inputs(sess)
    big = 2**24 + 1
    state = state[:3] + tuple(torch.full_like(x, big) for x in state[3:6]) \
        + state[6:]
    state, _ = step_fn(state, *args, 500, sess.seed, 0)
    tel = to.series_from_device(state[8], 4, [g.key for g in
                                              sess.view_groups()])
    for i, f in ((3, "tile_loads"), (4, "job_block_pushes"),
                 (5, "tile_pair_loads")):
        assert int(state[i]) == big + int(getattr(tel, f).sum()), f


def test_step_cache_key_carries_the_capacity():
    for tel, cap in ((None, 0), (to.TelemetryConfig(capacity=64), 64)):
        sess = _session(telemetry=tel)
        assert sess.run(tc.Fused(), 500).converged
        assert sess.run(tc.Fused(), 500).converged
        keys = [k for k in sess._jit_cache if k[0] == "superstep"]
        assert len(keys) == 1 and keys[0][-1] == cap


@pytest.mark.parametrize("cadence", ["device", "device_inf"])
def test_capacity_truncation_keeps_converging(cadence):
    """A run longer than the buffers converges; the series holds the
    first rows, and its last row is the last executed superstep's (the
    gated slots after convergence do not overwrite it)."""
    m = _session(telemetry=to.TelemetryConfig(capacity=8)).run(
        tc.TwoLevel(**CADENCES[cadence]), 500)
    assert m.converged and m.supersteps > 8
    tel = m.telemetry
    assert tel.truncated and len(tel) == 8
    full = _session().run(tc.TwoLevel(**CADENCES[cadence]), 500).telemetry
    assert not full.truncated and len(full) == m.supersteps
    for f in INT_COLUMNS:
        np.testing.assert_array_equal(getattr(tel, f)[:7],
                                      getattr(full, f)[:7])
        np.testing.assert_array_equal(getattr(tel, f)[7],
                                      getattr(full, f)[-1])


@pytest.mark.parametrize("backend", ["host", "device"])
def test_dirty_blocks_series_spikes_once_after_apply_updates(backend):
    out = {}
    for pkg in PKGS:
        sess = _session(pkg)
        pol = _policy(pkg, "TwoLevel", **CADENCES[backend])
        assert sess.run(pol, 500).converged
        sess.apply_updates(PKGS[pkg][4].UpdateBatch.inserts(
            np.array([1, 2]), np.array([5, 9]), np.array([1.0, 1.0])))
        m = sess.run(pol, 500)
        tel = m.telemetry
        assert m.dirty_blocks > 0
        assert int(tel.dirty_blocks[0]) == m.dirty_blocks
        assert (tel.dirty_blocks[1:] == 0).all()
        out[pkg] = m
    assert out["port"].dirty_blocks == out["ref"].dirty_blocks
    if backend == "host":
        _same_series(out["port"].telemetry, out["ref"].telemetry)


# --- trace, to_dict, profiler spans ------------------------------------------


def test_trace_counter_tracks_match_the_series(tmp_path):
    sess = _session()
    h = sess.submit(ta.PersonalizedPageRank(source=9))
    m = sess.run(tc.TwoLevel(), 500)
    assert m.converged
    sess.apply_updates(ts.UpdateBatch.inserts(
        np.array([0]), np.array([7]), np.array([1.0])))
    assert sess.run(tc.TwoLevel(), 500).converged
    sess.detach(h)
    path = tmp_path / "trace.json"
    sess.trace.export(str(path))
    doc = json.loads(path.read_text())
    assert to.validate_trace_events(doc) == len(doc["traceEvents"])
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"submit", "detach", "run", "superstep", "apply_updates",
            "converged", "process_name", "telemetry", "group0",
            "group1"} <= names
    tracks = [e for e in sess.trace.events
              if e["ph"] == "C" and e["name"] == "telemetry"]
    assert set(to.SERIES_FIELDS) <= set(tracks[0]["args"])
    first = tracks[:m.supersteps]
    # each row is stamped at the end of its superstep span
    steps = [e for e in sess.trace.events if e["name"] == "superstep"
             and "step" in e["args"]][:m.supersteps]
    assert [e["ts"] for e in first] == [e["ts"] + e["dur"] for e in steps]
    assert sum(e["args"]["tile_pair_loads"] for e in first) \
        == m.tile_pair_loads
    assert sum(e["args"]["tile_loads"] for e in first) == m.tile_loads
    groups = [e for e in sess.trace.events
              if e["ph"] == "C" and e["name"] == "group1"][:m.supersteps]
    np.testing.assert_array_equal(
        [e["args"]["unconverged"] for e in groups],
        m.telemetry.unconverged[:, 1])


def test_device_chunks_traced_per_sync():
    sess = _session()
    m = sess.run(tc.TwoLevel(backend="device", steps_per_sync=8), 500)
    chunks = [e for e in sess.trace.events if e["name"] == "device_chunk"]
    assert len(chunks) == m.host_syncs
    reads = [e for e in sess.trace.events if e["name"] == "chunk.read"]
    tracks = [e for e in sess.trace.events if e["name"] == "telemetry"]
    assert len(tracks) == m.supersteps
    # each row is stamped at the end of the chunk.read that returned it
    ends = [e["ts"] + e["dur"] for e in reads]
    for i, ev in enumerate(tracks):
        assert ev["ts"] == ends[i // 8]


def test_run_metrics_to_dict_matches_reference():
    m = {pkg: _session(pkg).run(_policy(pkg, "TwoLevel"), 500)
         for pkg in PKGS}
    d = {pkg: m[pkg].to_dict(include_telemetry=True) for pkg in PKGS}
    assert "telemetry" not in m["port"].to_dict()
    assert m["port"].wall_time_s > 0
    for pkg in PKGS:
        d[pkg].pop("wall_time_s")
        d[pkg]["telemetry"].pop("max_residual")
    assert d["port"] == d["ref"]
    json.dumps(m["port"].to_dict(include_telemetry=True))


def test_profiler_ranges_name_every_span():
    """Under a torch.profiler, every span is also a range `rt.<name>`."""
    sess = _session(telemetry=to.TelemetryConfig(capacity=0, trace=True))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sess.run(tc.TwoLevel(), 3)
        sess.run(tc.TwoLevel(backend="device", steps_per_sync=2), 4)
        sess.unconverged_counts()
    keys = {e.key for e in prof.key_averages()}
    want = {"run", "superstep", "step.pairs", "step.read", "step.select",
            "step.push", "run.finish", "device_chunk", "chunk.enqueue",
            "chunk.read", "counts"}
    assert {to.trace.SPAN_PREFIX + n for n in want} <= keys


# --- spans inside the drivers and the session --------------------------------


def _spans(sess):
    return [e for e in sess.trace.events if e["ph"] == "X"]


def _parent(by_id, e):
    return by_id.get(e["args"]["parent_id"], {"name": None})["name"]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_span_tree_of_both_drivers(backend):
    """Names and parents of every span; one chunk.read a chunk (host
    syncs), one step.read a group a live superstep, the job id on
    submit/detach, and totals() equal to the recorded spans' sums."""
    sess = tc.GraphSession(tg.rmat_graph(300, 5, seed=7), 32, capacity=2,
                           seed=3, device="cpu",
                           telemetry=to.TelemetryConfig(capacity=0))
    h0 = sess.submit(ta.PageRank())
    h1 = sess.submit(ta.SSSP(source=0))
    pol = (tc.TwoLevel() if backend == "host"
           else tc.TwoLevel(backend="device", steps_per_sync=4))
    m = sess.run(pol, 500)
    assert m.converged
    assert not sess.unconverged_counts().any()
    sess.detach(h1)
    spans = _spans(sess)
    by_id = {e["args"]["span_id"]: e for e in spans}
    assert len(by_id) == len(spans)
    parents = {}
    for e in spans:
        parents.setdefault(e["name"], set()).add(_parent(by_id, e))
    assert parents["submit"] == parents["run"] == parents["counts"] \
        == parents["detach"] == {None}
    assert parents["view.build"] == {"submit"}
    # a view is built with its pair view; the plain min-plus route of
    # the SSSP view asks for its ELL tiles once, the PageRank view never
    assert "pairs.build" not in parents
    assert parents["view.ell"] == ({"step.push"} if backend == "host"
                                   else {"run"})
    ells = [e for e in spans if e["name"] == "view.ell"]
    assert [e["args"]["view"] for e in ells] == [str(
        sess.view_groups()[1].key)]
    assert parents["run.finish"] == {"run"}
    if backend == "host":
        assert parents["superstep"] == {"run"}
        for n in ("step.pairs", "step.read", "step.select", "step.push"):
            assert parents[n] == {"superstep"}, n
        steps = [e for e in spans if e["name"] == "superstep"]
        assert len(steps) == m.host_syncs == m.supersteps + 1
        # one read a group a superstep, up to the read that finds the
        # group converged (each view holds one job: slots 0 and 2)
        reads = sum(min(int(m.iterations_per_job[off]) + 1, m.host_syncs)
                    for off in (0, 2))
        assert sum(e["name"] == "step.read" for e in spans) == reads
    else:
        assert parents["device_chunk"] == {"run"}
        assert parents["chunk.enqueue"] == parents["chunk.read"] \
            == {"device_chunk"}
        n = {k: sum(e["name"] == k for e in spans)
             for k in ("device_chunk", "chunk.read", "chunk.enqueue")}
        assert n == dict.fromkeys(n, m.host_syncs)
        assert not any(e["name"].startswith("step.") for e in spans)
    # children lie inside their parents
    for e in spans:
        p = by_id.get(e["args"]["parent_id"])
        if p is not None:
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    # the job id on submit and detach: (view, slot, generation)
    subs = [e for e in spans if e["name"] == "submit"]
    assert [e["args"]["job"] for e in subs] == [
        (str(h.view), h.slot, h.gen) for h in (h0, h1)]
    det = [e for e in spans if e["name"] == "detach"]
    assert [e["args"]["job"] for e in det] == [(str(h1.view), h1.slot, 0)]
    # totals are the recorded spans' sums
    tot = sess.trace.totals()
    assert set(tot) == {e["name"] for e in spans}
    for name, (secs, count) in tot.items():
        mine = [e["dur"] for e in spans if e["name"] == name]
        assert count == len(mine)
        assert secs == pytest.approx(sum(mine) / 1e6, rel=1e-9, abs=1e-9)
    assert m.telemetry is None
    to.validate_trace_events(sess.trace.to_json())


def test_spans_off_record_nothing(monkeypatch):
    """A session that does not trace records no event and never enters
    record_function, even under a profiler; a disabled span is one
    shared object and reads no clock."""
    def boom(*a, **kw):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    for cfg in (None, to.TelemetryConfig(trace=False)):
        sess = _session(telemetry=cfg)
        assert not sess.trace.enabled
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for pol in (tc.TwoLevel(), tc.Fused()):
                sess.run(pol, 500)
            sess.unconverged_counts()
        assert sess.trace.events == [] and sess.trace.totals() == {}
    rec = to.TraceRecorder(enabled=False)
    a, b = rec.span("x"), rec.span("y", job=(1, 2, 3))
    assert a is b
    ticks = []
    monkeypatch.setattr(to.trace.time, "perf_counter_ns",
                        lambda: ticks.append(1) or 0)
    with a as sp:
        sp.note(k=1)
    assert ticks == [] and rec.events == []


@pytest.mark.parametrize("policy", ["Fused", "TwoLevel"])
def test_spans_without_the_series(policy):
    """capacity=0: spans, no series, and the device chunk is the
    telemetry-off one (the same cache key and carry)."""
    pol = tc.Fused() if policy == "Fused" else tc.TwoLevel()
    on = _session(telemetry=to.TelemetryConfig(capacity=0, trace=True))
    off = _session(telemetry=None)
    assert on.trace.enabled and on.series_capacity == 0
    m_on, m_off = on.run(pol, 500), off.run(pol, 500)
    assert m_on.converged and m_on.telemetry is None
    assert m_on.supersteps == m_off.supersteps
    assert not any(e["ph"] == "C" for e in on.trace.events)
    assert on.trace.totals()["run"][1] == 1
    if policy == "Fused":
        assert list(on._jit_cache) == list(off._jit_cache)
        assert len(device_inputs(on)[0]) == len(device_inputs(off)[0]) == 8
    for g_on, g_off in zip(on.view_groups(), off.view_groups()):
        assert torch.equal(g_on.values, g_off.values)


def test_spans_share_the_profiler_clock():
    """The recorder's stamps and the Kineto starts of the same spans'
    rt.* ranges agree: median gap under 1 ms over 20 spans."""
    rec = to.TraceRecorder(enabled=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with rec.span(f"clock{i}"):
                torch.ones(64).sum()
    prefix = to.trace.SPAN_PREFIX
    kineto = {e.name(): e.start_ns() / 1e3
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith(prefix + "clock")}
    gaps = [abs(kineto[prefix + e["name"]] - e["ts"]) for e in rec.events]
    assert len(gaps) == 20
    assert float(np.median(gaps)) < 1e3
