"""Each per-layer reader on records of traced runs on the card
(`run.py --record`, H100 80GB HBM3 at 700 W), and the trace summary on
a hand-made event list."""

import json

import numpy as np
import pytest

from conftest import ROOT
from graphbench import roofline
from graphbench.harness import load_reader
from graphbench.trace import summarize, union

DATA = ROOT / "graphbench" / "tests" / "data"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def record(cell):
    return json.loads((DATA / f"record_{cell}.json").read_text())


FUSED, HOST = "s15vb64.fused.c64", "s15vb512.host.c64"


def expected(name, r):
    sp, t = r["spans"], r["trace"]
    return {
        "lifecycle_ms_per_job": 1e3 * (sp["submit"][0] + sp["detach"][0]
                                       + sp["poll"][0]) / r["jobs_done"],
        "superstep_ms": 1e3 * sp["run"][0] / r["supersteps"],
        "supersteps_per_job": np.mean(r["job_supersteps"]),
        "job_supersteps_p95": np.percentile(r["job_supersteps"], 95),
        "select_ms": (1e3 * sp["select"][0] / r["supersteps"]
                      if "select" in sp else None),
        "b1b2_roofline": 100 * roofline.bound_s(
            roofline.fused_bytes(r["vb"], r["capacity"], r["num_blocks"],
                                 r["semirings"], t["supersteps"],
                                 t["tile_loads"], t["tile_pair_loads"]),
            roofline.fused_flops(r["vb"], r["capacity"],
                                 t["tile_pair_loads"]))[0] / t["b1b2_s"],
        "tile_gb_per_job": r["tile_pair_loads"] * r["vb"] ** 2 * 4 / 1e9
        / r["jobs_done"],
        "device_idle_pct": 100 * (1 - (t["busy_s"] / t["supersteps"])
                                  / (r["window_s"] / r["supersteps"])),
        "view_build_s": r["view_build_s"],
        "graph_gb": r["graph_bytes"] / 1e9,
    }[name]


@pytest.mark.parametrize("cell", [FUSED, HOST])
@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_on_a_recorded_run(cell, name):
    r = record(cell)
    got = load_reader(name)(r)
    want = expected(name, r)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("cell", [FUSED, HOST])
def test_shares_stay_under_100_on_recorded_runs(cell):
    r = record(cell)
    for name in ("b1b2_roofline", "device_idle_pct"):
        assert 0 < load_reader(name)(r) < 100


@pytest.mark.parametrize("name", PER_LAYER)
def test_reader_finds_nothing_without_a_trace(name):
    r = dict(record(HOST), trace=None)
    got = load_reader(name)(r)
    if name in ("b1b2_roofline", "device_idle_pct"):
        assert got is None
    else:
        assert got is not None


def test_union_merges_overlaps():
    assert union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_summary_by_hand():
    # host spans (us): run 0-100 holding select 10-40, poll 100-110
    spans = [("run", 0.0, 100.0), ("select", 10.0, 40.0),
             ("poll", 100.0, 110.0)]
    device = [("void superstep_kernel<64, false>(Args)", 40.0, 70.0),
              ("void superstep_kernel<64, true>(Args)", 60.0, 80.0),
              ("copy", 90.0, 95.0), ("before", -50.0, 5.0)]
    s = summarize(device, spans)
    assert s["window_s"] == pytest.approx(110e-6)
    # busy: 0-5, 40-80, 90-95
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["b1b2_s"] == pytest.approx(50e-6)
    idle = dict(s["idle_by_span"])
    # idle: 5-10 run, 10-40 select, 80-90 run, 95-100 run, 100-110 poll
    assert idle == pytest.approx({"run": 20e-6, "select": 30e-6,
                                  "poll": 10e-6})
    assert s["device_ops"][0][0] == "void superstep_kernel<64, false>(Args)"
