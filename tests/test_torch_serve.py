"""Parity of the port's serve front (repro_torch.serve,
repro_torch.obs.serve/slo/loadgen) with repro's, on the CPU.

The same seeded request streams go through both packages' schedulers;
the same LoadgenConfig through both generators and both harnesses, at
the reference's own sizes (tests/test_obs.py, tests/test_serve_slo.py):

  * admissions, ServeMetrics and SLOTracker reports equal, sample by
    sample (wall-clock samples aside);
  * the registry's JSON snapshot and Prometheus text equal;
  * generate_arrivals equal, Arrival by Arrival;
  * OpenLoopHarness admission and completion logs and summaries equal,
    with and without interleaved graph updates, and max_running held.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.graph as rg  # noqa: E402
import repro.obs as ro  # noqa: E402
import repro.serve.concurrent as rsc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import repro_torch.obs as to  # noqa: E402
import repro_torch.serve as tsv  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small ops, which one intra-op thread runs
    fastest; under a parallel test run more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKGS = {"ref": (rc, rg, ro, rsc, {}),
        "port": (tc, tg, to, tsv, {"device": "cpu"})}
# ServeMetrics keys that hold wall-clock samples (not comparable)
WALL = ("wait_s", "service_s")


def _streams(pkg, seed, n_streams=5, n_groups=8, n_req=40, **kw):
    """A scheduler with `n_streams` seeded streams of mixed families."""
    sv = PKGS[pkg][3]
    rng = np.random.default_rng(seed)
    sched = sv.ConcurrentServeScheduler(n_groups, 4, seed=seed, **kw)
    fams = ("chat", "batch", "route")
    for sid in rng.permutation(n_streams).tolist():
        sched.add_stream(sv.RequestStream(sid, family=fams[sid % 3]))
    for _ in range(n_req):
        sid = int(rng.integers(n_streams))
        sched.streams[sid].add(sv.Request(
            sid, int(rng.integers(n_groups)),
            float(np.round(rng.uniform(0.1, 1.0), 6)), 1))
    return sched


def _drain(sched, notify_at=None):
    log, step = [], 0
    while any(s.waiting for s in sched.streams.values()):
        if notify_at is not None and step == notify_at:
            sched.notify_group_update([1, 6])
        got = sched.schedule_step()
        log.append([(r.stream_id, r.group, r.urgency) for r in got])
        for r in got:
            sched.complete(r, service_s=0.01)
        step += 1
    return log


def _summary(sched):
    s = sched.metrics.summary()
    for k in WALL:
        s.pop(k)
    return s


@pytest.mark.parametrize("notify_at", [None, 2])
@pytest.mark.parametrize("seed", [0, 7, 19])
def test_admissions_and_reports_match_reference(seed, notify_at):
    out = {}
    for pkg in PKGS:
        slo = PKGS[pkg][2].SLOTracker(targets=[PKGS[pkg][2].SLOTarget(
            family="*", p99_latency_steps=6, deadline_steps=8)], window=32)
        sched = _streams(pkg, seed, slo=slo)
        log = _drain(sched, notify_at)
        out[pkg] = (log, _summary(sched), slo.report(),
                    sched.last_admitted_by_family)
    assert out["port"] == out["ref"]
    assert sum(len(x) for x in out["port"][0]) == 40


def test_serve_device_backend_admits_everything():
    sched = _streams("port", 3, backend="device", device="cpu")
    assert sched.scheduler.device.type == "cpu"
    log = _drain(sched)
    assert sum(len(x) for x in log) == 40
    assert all(len(x) <= 4 for x in log)


def test_serve_device_backend_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.ConcurrentServeScheduler(4, 2, backend="device")
    # the host backend has no device
    assert tsv.ConcurrentServeScheduler(4, 2).scheduler.device is None


def test_serve_metrics_opt_out_and_group_range():
    sched = tsv.ConcurrentServeScheduler(4, 2, metrics=False)
    st = tsv.RequestStream(0)
    sched.add_stream(st)
    st.add(tsv.Request(0, 0, 1.0, 1))
    assert sched.metrics is None
    assert len(sched.schedule_step()) == 1
    with pytest.raises(ValueError):
        sched.notify_group_update([4])


def test_serve_admissions_land_on_a_shared_trace():
    sess = tc.GraphSession(tg.rmat_graph(300, 5, seed=7), 32, device="cpu",
                           telemetry=True)
    sched = tsv.ConcurrentServeScheduler(4, 2, trace=sess.trace)
    st = tsv.RequestStream(0)
    sched.add_stream(st)
    st.add(tsv.Request(0, 0, 1.0, 1))
    sched.schedule_step()
    ev = [e for e in sess.trace.events if e["name"] == "serve.admit"]
    assert len(ev) == 1 and ev[0]["args"]["admitted"] == 1
    to.validate_trace_events(sess.trace.to_json())


# --- SLO tracking and the registry ------------------------------------------


def test_slo_tracker_verdicts_match_reference():
    class R:
        def __init__(self, sid):
            self.stream_id = sid
            self._seen_step = None

    reports = {}
    for pkg in PKGS:
        o = PKGS[pkg][2]
        t = o.SLOTracker(targets=[
            o.SLOTarget(family="fast", p50_latency_steps=5,
                        p99_latency_steps=8, deadline_steps=10),
            o.SLOTarget(family="*", deadline_steps=100,
                        min_throughput=0.01, max_queue_depth=3)], window=64)
        r1, r2, r3 = R(0), R(0), R(1)
        t.on_seen(r1, 0)
        t.on_seen(r2, 0)
        t.on_seen(r3, 2)
        t.on_admit(r1, "fast", 1)
        t.on_complete(r1, "fast", 4)
        t.on_complete(r2, "fast", 20)
        t.on_complete(r3, "slow", 30)
        t.on_step(30, {"fast": 2, "slow": 0})
        reports[pkg] = t.report()
        with pytest.raises(ValueError):
            o.SLOTracker(targets=[o.SLOTarget(family="x"),
                                  o.SLOTarget(family="x")])
    assert reports["port"] == reports["ref"]
    assert reports["port"]["families"]["fast"]["slo"]["ok"] is False


def test_sliding_window_latency_retention():
    w = to.SlidingWindowLatency(window=4)
    for i in range(10):
        w.add(float(i))
    assert w.samples == [6.0, 7.0, 8.0, 9.0]
    with pytest.raises(ValueError):
        to.SlidingWindowLatency(window=0)
    assert to.percentile_summary([]) == ro.percentile_summary([])
    xs = [0.5, 3.0, 1.25, 9.0, 2.0]
    assert to.percentile_summary(xs) == ro.percentile_summary(xs)


def test_registry_json_and_prometheus_match_reference(tmp_path):
    texts, docs = {}, {}
    for pkg in PKGS:
        o = PKGS[pkg][2]
        slo = o.SLOTracker(window=16)
        sched = _streams(pkg, 5, slo=slo)
        _drain(sched)
        reg = o.MetricsRegistry()
        reg.register("serve", lambda s=sched: _summary(s))
        reg.register("slo", slo)
        reg.register("plain", {"wait": {"p50": 1.5, "p99": 9.0}, "ok": True,
                               "note": "ignored", "series": [1, 2, 3]})
        docs[pkg] = reg.snapshot()
        texts[pkg] = reg.to_prometheus()
        assert o.validate_registry_snapshot(docs[pkg]) == 3
        out = tmp_path / f"{pkg}.json"
        assert reg.export(out) == json.loads(out.read_text())
    assert to.REGISTRY_SCHEMA == ro.REGISTRY_SCHEMA
    assert docs["port"] == docs["ref"]
    assert texts["port"] == texts["ref"]
    assert "repro_plain_series_sum 6" in texts["port"].splitlines()
    # both packages' validators reject the same malformed snapshots
    for bad in ({"schema": "nope", "sources": {}},
                {"schema": ro.REGISTRY_SCHEMA,
                 "sources": {"s": {"x": float("nan")}}},
                {"schema": ro.REGISTRY_SCHEMA, "sources": {"bad name!": {}}}):
        for pkg in PKGS:
            with pytest.raises(ValueError):
                PKGS[pkg][2].validate_registry_snapshot(bad)


def test_registry_rejects_bad_sources():
    reg = to.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.register("bad name!", {})
    reg.register("a", {"x": 1})
    with pytest.raises(ValueError):
        reg.register("a", {})
    reg.register("b", 42)
    with pytest.raises(TypeError):
        reg.snapshot()


# --- load generation ----------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(seed=4, ticks=200, base_rate=0.8, n_tenants=50),
    dict(seed=33, ticks=240, base_rate=0.1, burst_period=60, n_tenants=64),
    dict(seed=1, ticks=90, base_rate=0.25, n_tenants=30,
         families=(("sssp", 1.0), ("wcc", 0.5), ("katz", 0.25)))])
def test_generate_arrivals_match_reference(cfg):
    a_ref = ro.generate_arrivals(ro.LoadgenConfig(**cfg), 10, 300)
    a_port = to.generate_arrivals(to.LoadgenConfig(**cfg), 10, 300)
    assert len(a_port) == len(a_ref) > 0
    for x, y in zip(a_port, a_ref):
        assert isinstance(x, to.Arrival)
        assert dataclass_values(x) == dataclass_values(y)


def dataclass_values(a):
    return (a.tick, a.tenant, a.family, a.group, a.source, a.urgency)


@pytest.mark.parametrize("bad", [dict(base_rate=0.0),
                                 dict(families=(("nope", 1.0),)),
                                 dict(families=(("sssp", -1.0),)),
                                 dict(ticks=0)])
def test_loadgen_config_validation(bad):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            PKGS[pkg][2].LoadgenConfig(**bad)


def _world(pkg, seed=11, ticks=90, max_running=3, update_every=30,
           policy=None, telemetry=None, supersteps_per_tick=1):
    c, g, o, sv, dev = PKGS[pkg]
    csr = g.rmat_graph(192, 5, seed=9)
    sess = c.GraphSession(csr, 32, capacity=max(2, max_running), seed=3,
                          telemetry=telemetry, **dev)
    n_groups = -(-csr.n // 32)
    slo = o.SLOTracker(targets=[o.SLOTarget(family="*", p99_latency_steps=500,
                                            deadline_steps=600)], window=128)
    sched = sv.ConcurrentServeScheduler(n_groups, batch_budget=max_running,
                                        seed=5, slo=slo)
    cfg = o.LoadgenConfig(seed=seed, ticks=ticks, base_rate=0.25,
                          n_tenants=30, update_every=update_every)
    return (o.OpenLoopHarness(sess, sched, cfg, max_running=max_running,
                              policy=policy,
                              supersteps_per_tick=supersteps_per_tick),
            sched, slo)


def _peak_running(h):
    """Concurrency from the logs: admissions at tick t join before
    completions stamped t + 1 leave."""
    admits = sorted(t for t, *_ in h.admission_log)
    leaves = sorted(t for t, *_ in h.completion_log)
    peak, ai, li = 0, 0, 0
    for t in range(h.ticks_run + 1):
        while ai < len(admits) and admits[ai] <= t:
            ai += 1
        peak = max(peak, ai - li)
        while li < len(leaves) and leaves[li] <= t + 1:
            li += 1
    return peak


@pytest.mark.parametrize("update_every,max_running",
                         [(30, 3), (0, 3), (30, 2)])
def test_harness_logs_match_reference(update_every, max_running):
    runs = {}
    for pkg in PKGS:
        h, sched, slo = _world(pkg, update_every=update_every,
                               max_running=max_running)
        s = h.run()
        runs[pkg] = (h, s, _summary(sched), slo.report())
    h, s = runs["port"][:2]
    assert h.admission_log == runs["ref"][0].admission_log
    assert h.completion_log == runs["ref"][0].completion_log
    assert s == runs["ref"][1]
    assert runs["port"][2:] == runs["ref"][2:]
    assert s["admitted"] == s["completed"] == s["arrivals"] > 0
    assert (s["updates_applied"] > 0) == (update_every > 0)
    assert 0 < _peak_running(h) <= max_running
    assert sum(g.num_active for g in h.sess.view_groups()) == 0


def test_harness_rejects_mismatched_groups():
    sess = tc.GraphSession(tg.rmat_graph(192, 5, seed=9), 32, device="cpu")
    sched = tsv.ConcurrentServeScheduler(3, batch_budget=2, seed=5)
    with pytest.raises(ValueError, match="block count"):
        to.OpenLoopHarness(sess, sched, to.LoadgenConfig(seed=1))
    with pytest.raises(ValueError, match="max_running"):
        to.OpenLoopHarness(sess, tsv.ConcurrentServeScheduler(6, 2),
                           to.LoadgenConfig(seed=1), max_running=0)


def test_harness_on_the_device_backend_with_telemetry():
    """The serve front over a device-backend policy: every arrival served,
    max_running held, and the runs' series sum to the harness counters."""
    h, _, _ = _world("port", ticks=60, policy=tc.TwoLevel(
        backend="device", steps_per_sync=8), telemetry=True,
        supersteps_per_tick=8)
    runs = []
    real = h.sess.run

    def run(*a, **kw):
        runs.append(real(*a, **kw))
        return runs[-1]
    h.sess.run = run
    s = h.run()
    assert s["admitted"] == s["completed"] == s["arrivals"] > 0
    assert 0 < _peak_running(h) <= 3
    assert sum(int(m.telemetry.tile_loads.sum()) for m in runs) \
        == s["counters"]["tile_loads"]
    assert sum(m.supersteps for m in runs) == s["supersteps"]
    chunks = [e for e in h.sess.trace.events if e["name"] == "device_chunk"]
    assert len(chunks) == sum(m.host_syncs for m in runs)
