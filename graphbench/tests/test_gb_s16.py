"""The scale-16 configuration, the two cells that joined the first two
(`s15vb512.fused.c64`, `s16vb64.fused.c64`) and the two per-layer
metrics that read every cell (`b1b2_device_ms`, `view_gb`): their form
under the README's contract, the readers on the recorded records, the
sizes the configuration states, and a whole tiny run of each new cell
on the CPU."""

import json

import numpy as np
import pytest

from conftest import ROOT, TINY_CONFIG
from graphbench.graph import graph500
from graphbench.harness import load_reader, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: c for c in BENCH["configs"]}
CELLS = {w["name"]: w for w in BENCH["workloads"]}
METRICS = {m["name"]: m for m in BENCH["per_layer"]}
NEW_CELLS = ("s15vb512.fused.c64", "s16vb64.fused.c64")
ALL_CELLS = ["s15vb64.fused.c64", "s15vb512.host.c64", *NEW_CELLS]
NEW_METRICS = ("b1b2_device_ms", "view_gb")
DATA = ROOT / "graphbench" / "tests" / "data"
RECORDED = ("s15vb64.fused.c64", "s15vb512.host.c64")


def config(name):
    return json.loads((ROOT / CONFIGS[name]["file"]).read_text())


def record(cell):
    return json.loads((DATA / f"record_{cell}.json").read_text())


def test_s16_config_is_the_s15_deployment_at_scale_16():
    new, old = config("g500-s16-vb64"), config("g500-s15-vb64")
    assert set(new) == set(old)
    differ = {k for k in old if new[k] != old[k]}
    assert differ == {"source", "deployment", "scale", "assumed"}
    assert new["scale"] == 16 and new["block_size"] == 64
    assert new["graph_seed"] == 2 and new["precision"] == "float32"
    assert new["reduced"] == CONFIGS["g500-s16-vb64"]["reduced"] == [
        "scale", "graph_seed"]
    assert new["source"] == CONFIGS["g500-s16-vb64"]["source"]
    assert len(new["source"]) <= 200
    # the slots hold the largest view's clients (38 plus-times jobs) and
    # are a multiple of the 16 jobs one B1/B2 thread block holds at Vb 64
    assert new["capacity"] >= 38 and new["capacity"] % 16 == 0
    assert set(new["assumed"]) == set(old["assumed"])
    for key in ("pt_gap_limit", "mp_gap_limit"):
        assert 0 < new[key] < 1e-2
        assert "control" in new["assumed"][key]
    assert "17" in new["assumed"]["scale"]


def test_s16_sizes_are_those_the_configuration_states():
    """The pair count and pair-tile GB a view that `assumed.scale`
    states, from the host's block adjacency of the generator's graph."""
    from repro_torch.graph.structure import CSRGraph, block_adjacency
    cfg = config("g500-s16-vb64")
    csr = graph500(cfg, np.random.default_rng(cfg["graph_seed"]))
    adj = block_adjacency(CSRGraph.from_edges(csr.n, *csr.edges()),
                          cfg["block_size"], "out_degree")
    pairs = len(adj.tile_sb)
    vb = cfg["block_size"]
    text = cfg["assumed"]["scale"]
    assert adj.num_blocks == 1024
    assert f"{pairs:,} block pairs" in text
    assert f"{pairs * vb * vb * 4 / 1e9:.2f} GB of pair tiles" in text
    assert f"{3 * pairs * vb * vb * 4 / 1e9:.2f} GB" in text
    assert pairs * vb * vb > 2 ** 31
    ell = adj.num_blocks * adj.k_max * vb * vb * 4 / 1e9
    assert f"{ell:.2f} GB a view" in text


def test_new_cells_and_metrics_are_entries_at_the_end():
    names = [w["name"] for w in BENCH["workloads"]]
    assert names[-2:] == list(NEW_CELLS)
    assert [c["name"] for c in BENCH["configs"]][-1] == "g500-s16-vb64"
    assert [m["name"] for m in BENCH["per_layer"]][-2:] == list(NEW_METRICS)
    for name, cfg in zip(NEW_CELLS, ("g500-s15-vb512", "g500-s16-vb64")):
        w = CELLS[name]
        assert (w["config"], w["traffic"], w["chips"]) == (
            cfg, "fused.c64", 1)
        assert len(w["why"]) <= 200
    for name in NEW_METRICS:
        m = METRICS[name]
        assert m["workloads"] == ALL_CELLS
        assert (ROOT / "graphbench" / "metrics" / f"{name}.py").is_file()
    # a layer the benchmark already names keeps its name letter for letter
    assert METRICS["b1b2_device_ms"]["layer"] == \
        METRICS["b1b2_roofline"]["layer"]
    assert METRICS["view_gb"]["layer"] == METRICS["graph_gb"]["layer"]
    assert METRICS["b1b2_device_ms"]["moves"] == "jobs_per_s"
    assert METRICS["view_gb"]["moves"] == "peak_mem_gb"
    assert METRICS["b1b2_device_ms"]["source"] == "device_trace"
    assert METRICS["view_gb"]["source"] == "program_counter"


@pytest.mark.parametrize("cell", RECORDED)
def test_new_readers_on_recorded_runs(cell):
    r = record(cell)
    t = r["trace"]
    assert load_reader("b1b2_device_ms")(r) == pytest.approx(
        1e3 * t["b1b2_s"] / t["supersteps"], rel=1e-12)
    assert load_reader("view_gb")(r) == pytest.approx(
        r["graph_bytes"] / len(r["semirings"]) / 1e9, rel=1e-12)
    # three views: one plus-times, two min-plus
    assert 0 < load_reader("view_gb")(r) < load_reader("graph_gb")(r)


@pytest.mark.parametrize("cell", RECORDED)
def test_new_readers_find_nothing_where_nothing_was_read(cell):
    r = record(cell)
    b1b2 = load_reader("b1b2_device_ms")
    assert b1b2(dict(r, trace=None)) is None
    assert b1b2(dict(r, trace=dict(r["trace"], b1b2_s=0.0))) is None
    assert load_reader("view_gb")(dict(r, graph_bytes=0)) is None


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_new_cell_runs_correct_at_test_size(tiny_cell, workload):
    cell = tiny_cell(workload)
    assert cell.config["block_size"] == TINY_CONFIG["block_size"]
    out = run_cell(cell, 2 ** 31 + 4321, 6.0, False, device="cpu",
                   drain_s=20.0, log=lambda msg: None)
    res = out["result"]
    assert res["correct"] is True, out["lines"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"jobs_per_s", "job_p95_s",
                                   "peak_mem_gb", "setup_s"}
