"""The benchmark is driven by data: BENCHMARK.json keeps the contract's
form, and a new configuration, traffic mix and per-layer metric are new
files plus new entries, with no file that is there edited."""

import json
import re
import shutil
import subprocess
import sys

from conftest import ROOT, TINY_CLIENTS, TINY_CONFIG

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_the_contract_form():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["graphbench"]
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert c["file"].startswith("graphbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
    assert len({c["source"] for c in b["configs"]}) == len(configs)
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (ROOT / "graphbench" / "mixes"
                / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in {"lower", "higher"} and m["source"] in SOURCES
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (ROOT / "graphbench" / "metrics"
                / f"{m['name']}.py").is_file()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


def test_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "graphbench", root / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}

    gb = root / "graphbench"
    cfg = json.loads((gb / "configs" / "g500-s15-vb64.json").read_text())
    cfg.update(TINY_CONFIG, source="a tiny R-MAT for this test")
    (gb / "configs" / "tiny-r10.json").write_text(json.dumps(cfg))
    (gb / "mixes" / "sssp.c4.json").write_text(json.dumps(
        {"loop": "closed", "think_s": 0, "policy": "two_level",
         "poll_supersteps": 4, "clients": [TINY_CLIENTS[2]]}))
    (gb / "metrics" / "jobs_done.py").write_text(
        "def read(rec):\n    return rec['jobs_done']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-r10", "source": cfg["source"],
                             "file": "graphbench/configs/tiny-r10.json",
                             "reduced": ["scale"], "why": "a test"})
    bench["workloads"].append({"name": "tiny.sssp.c4", "config": "tiny-r10",
                               "traffic": "sssp.c4", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "a test", "moves": "jobs_per_s",
                               "workloads": ["tiny.sssp.c4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from graphbench.harness import load_cell, run_cell\n"
        f"cell = load_cell(Path({str(root)!r}), 'tiny.sssp.c4')\n"
        "out = run_cell(cell, 9, 6.0, True, device='cpu', drain_s=20,\n"
        "               log=lambda m: None)\n"
        "print(json.dumps(out['result']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["jobs_done"]["value"] > 0
    assert set(res["checks"]) == {"mp_gap", "unanswered"}
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
