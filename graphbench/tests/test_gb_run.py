"""Whole runs of a tiny cell on the CPU through the harness's internal
entry: the result line's keys, `correct` on a sound program, and
`correct` false on each fault the cells can have."""

import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from graphbench.harness import run_cell

CELLS = ("s15vb64.fused.c64", "s15vb512.host.c64")
SEED = 2 ** 31 + 12345


def run(cell, trace=False, seconds=2.0, drain_s=20.0, **kwargs):
    return run_cell(cell, SEED, seconds, trace, device="cpu",
                    drain_s=drain_s, log=lambda msg: None, **kwargs)


@pytest.mark.parametrize("workload", CELLS)
def test_window_is_correct_and_line_has_the_keys(tiny_cell, workload):
    cell = tiny_cell(workload)
    out = run(cell, seconds=6.0)
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, out["lines"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and np.isfinite(got["value"])
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(res["checks"]) == {"pt_gap", "mp_gap", "unanswered"}
    for v in res["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(res)   # one line of JSON
    assert len(out["lines"]) == 3


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics(tiny_cell, workload):
    cell = tiny_cell(workload)
    out = run(cell, trace=True, seconds=6.0)
    res, rec = out["result"], out["record"]
    assert res["correct"] is True, (out["lines"], res["attempted"])
    assert rec["jobs_done"] > 0, rec["spans"]
    names = {m["name"] for m in cell.per_layer}
    # on the CPU the device readers find nothing to read
    device_only = {"b1b2_roofline", "device_idle_pct", "graph_gb"}
    assert names - device_only <= set(res["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_same_seed_same_jobs(tiny_cell):
    a = run(tiny_cell(CELLS[1]), seconds=6.0)["record"]
    b = run(tiny_cell(CELLS[1]), seconds=6.0)["record"]
    n = min(len(a["job_supersteps"]), len(b["job_supersteps"]))
    assert n > 0
    assert a["job_supersteps"][:n] == b["job_supersteps"][:n]


def unchanged_push(monkeypatch):
    """Every push returns the state it was given."""
    import repro_torch.core.policy as pol

    def fn(*args, **kwargs):
        return lambda values, deltas, *rest, **kw: (values, deltas)
    monkeypatch.setattr(pol, "shared_push_fn", fn)


def half_the_jobs(monkeypatch):
    """The push leaves the second half of each view's job slots out."""
    import repro_torch.core.policy as pol
    real = pol.shared_push_fn

    def fn(*args, **kwargs):
        push = real(*args, **kwargs)

        def half(values, deltas, *rest, **kw):
            v, d = push(values, deltas, *rest, **kw)
            h = values.shape[0] // 2
            return (torch_cat(v[:h], values[h:]), torch_cat(d[:h], deltas[h:]))
        return half
    monkeypatch.setattr(pol, "shared_push_fn", fn)


def torch_cat(a, b):
    import torch
    return torch.cat([a, b])


def altered_answer(monkeypatch):
    """Each job's answer comes back with one vertex's value changed."""
    from repro_torch.core.session import GraphSession
    real = GraphSession.result

    def result(self, handle):
        r = real(self, handle).copy()
        i = int(np.argmax(np.where(np.isfinite(r), r, -1)))
        r[i] = r[i] * 1.01 + 1.0
        return r
    monkeypatch.setattr(GraphSession, "result", result)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [unchanged_push, half_the_jobs,
                                   altered_answer])
def test_fault_makes_correct_false(tiny_cell, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run(tiny_cell(workload), seconds=1.5, drain_s=2.0)["result"]
    assert res["correct"] is False
    assert res["failed"] > 0


def test_profiler_never_runs_in_the_window(tiny_cell, monkeypatch):
    import torch.profiler
    from graphbench import harness
    starts = []
    real = torch.profiler.profile.start

    def start(self):
        starts.append(harness.time.perf_counter())
        return real(self)
    monkeypatch.setattr(torch.profiler.profile, "start", start)
    real_poll = harness.Loop.poll
    window = []

    def poll(self, submitting):
        if self.window_open:
            window.append(harness.time.perf_counter())
        return real_poll(self, submitting)
    monkeypatch.setattr(harness.Loop, "poll", poll)
    run(tiny_cell(CELLS[0]), trace=True, seconds=3.0)
    assert len(starts) == 1 and window
    assert starts[0] > max(window)


@pytest.mark.parametrize("workload", CELLS)
def test_control_comes_out_not_correct(tiny_cell, workload):
    from graphbench.control import readings
    cell = tiny_cell(workload)
    for seed in (1, 2, 3):
        r = readings(cell, seed, 4.0, device="cpu", drain_s=20.0,
                     log=lambda msg: None)
        assert r["program_correct"] is True, r
        assert r["control_correct"] is False, r
        for name in ("pt_gap", "mp_gap"):
            c = r["control"][name]
            assert c["value"] > c["limit"] > r["program"][name]["value"]


def test_no_forbidden_module_is_loaded():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import graphbench.harness, graphbench.control\n"
            "import repro_torch.core, repro_torch.graph\n"
            "from graphbench.harness import forbidden_modules\n"
            "print(forbidden_modules())\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_module_check_compares_whole_names(monkeypatch):
    from graphbench.harness import forbidden_modules
    assert "repro" not in forbidden_modules()   # repro_torch is allowed
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert forbidden_modules() == ["repro"]


@pytest.mark.parametrize("name", ["reference.py", "graph.py",
                                  "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    import ast
    tree = ast.parse((ROOT / "graphbench" / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "dataclasses", "numpy", "scipy"}, mods


def test_cli_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "graphbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_cli_on_the_card(card, tmp_path):
    out = subprocess.run(
        [sys.executable, "graphbench/run.py", "--workload", CELLS[1],
         "--seed", "5", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
