"""The port's benchmark-record gate (`repro_torch.obs.regress`) against
the reference's (`repro.obs.regress`).

The same metric specs, and on every document built here in the BENCH
schema (`{"mode": ..., "records": [{"name": ..., <metric>: ...}]}`) the
same exit code, the same printed report and the same JSON verdict from
both CLIs, plus the same violations from the library calls.  No
committed record is read.

One difference, a fault in the reference (ROADMAP C): under
`--require-all` a missing mode or row is a violation whose metric is
"<doc>" or "<row>", and the reference's report looks that up in
`METRIC_SPECS` and raises KeyError (`python -m repro.obs.regress` then
exits 1 with a traceback).  The port reports the same violation as a
"missing" line and exits 1.
"""

import copy
import dataclasses
import json

import pytest

import repro.obs.regress as R
import repro_torch.obs.regress as T

BASE = {
    "fig_sync": {"mode": "fig_sync", "records": [
        {"name": "warm", "us_per_call": 120.0, "supersteps": 40,
         "tile_loads": 900, "host_syncs": 41, "note": "informational"},
        {"name": "cold", "us_per_call": 900.0, "supersteps": 40,
         "tile_loads": 900, "halo_bytes": 1000.0}]},
    "fig_serve": {"mode": "fig_serve", "records": [
        {"name": "load0.4", "arrivals": 35, "admitted": 35, "completed": 35,
         "p50_latency_ticks": 6.0, "p99_latency_ticks": 21.0,
         "throughput_per_tick": 0.4}]},
}


def _edit(mode, row, **kw):
    def f(docs):
        for r in docs[mode]["records"]:
            if r["name"] == row:
                r.update(kw)
    return f


def _drop_mode(mode):
    def f(docs):
        del docs[mode]
    return f


def _drop_row(mode, row):
    def f(docs):
        docs[mode]["records"] = [r for r in docs[mode]["records"]
                                 if r["name"] != row]
    return f


def _faster(docs):
    """Better in every gated direction: no regression."""
    _edit("fig_sync", "warm", us_per_call=60.0, tile_loads=800)(docs)
    _edit("fig_serve", "load0.4", throughput_per_tick=0.5)(docs)


# name -> (edit of the fresh docs, extra CLI flags, expected exit code)
CASES = {
    "clean": (None, [], 0),
    "faster": (_faster, [], 0),
    "timing_plus_20pct": (_edit("fig_sync", "warm", us_per_call=144.0),
                          [], 1),
    "timing_plus_20pct_skip_timing": (
        _edit("fig_sync", "warm", us_per_call=144.0), ["--skip-timing"], 0),
    "timing_plus_20pct_wide_band": (
        _edit("fig_sync", "warm", us_per_call=144.0),
        ["--timing-rtol", "0.25"], 0),
    "counter_off_by_one": (_edit("fig_sync", "cold", tile_loads=901), [], 1),
    "counter_off_by_one_skip_timing": (
        _edit("fig_sync", "cold", tile_loads=901), ["--skip-timing"], 1),
    "halo_within_band": (_edit("fig_sync", "cold", halo_bytes=1009.0),
                         [], 0),
    "halo_past_band": (_edit("fig_sync", "cold", halo_bytes=1011.0), [], 1),
    "completed_lower": (_edit("fig_serve", "load0.4", completed=34), [], 1),
    "completed_higher": (_edit("fig_serve", "load0.4", completed=36), [], 0),
    "latency_higher": (_edit("fig_serve", "load0.4",
                             p99_latency_ticks=21.5), [], 1),
    "missing_mode": (_drop_mode("fig_serve"), [], 0),
    "missing_mode_require_all": (_drop_mode("fig_serve"),
                                 ["--require-all"], 1),
    "missing_row": (_drop_row("fig_sync", "cold"), [], 0),
    "missing_row_require_all": (_drop_row("fig_sync", "cold"),
                                ["--require-all"], 1),
    "modes_filter": (_edit("fig_serve", "load0.4", completed=34),
                     ["--modes", "fig_sync"], 0),
    "non_numeric_ignored": (_edit("fig_sync", "warm", supersteps="40",
                                  host_syncs=True), [], 0),
}


def _write(root, docs):
    root.mkdir(parents=True, exist_ok=True)
    for mode, doc in docs.items():
        (root / f"BENCH_{mode}.json").write_text(json.dumps(doc))
    return root


def _run(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr()


def test_metric_specs_equal_reference():
    assert list(T.METRIC_SPECS) == list(R.METRIC_SPECS)
    for k, spec in R.METRIC_SPECS.items():
        assert dataclasses.asdict(T.METRIC_SPECS[k]) == dataclasses.asdict(
            spec)
    assert T.__all__ == R.__all__
    assert [f.name for f in dataclasses.fields(T.TolSpec)] == [
        f.name for f in dataclasses.fields(R.TolSpec)]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_equals_reference(tmp_path, capsys, case):
    edit, flags, want_rc = CASES[case]
    base = _write(tmp_path / "base", BASE)
    fresh_docs = copy.deepcopy(BASE)
    if edit is not None:
        edit(fresh_docs)
    fresh = _write(tmp_path / "fresh", fresh_docs)
    out = {}
    for name, mod in (("ref", R), ("port", T)):
        js = tmp_path / f"{name}.json"
        argv = ["--baseline", str(base), "--fresh", str(fresh), "--json",
                str(js)] + flags
        if name == "ref" and case.endswith("_require_all"):
            with pytest.raises(KeyError, match="<doc>|<row>"):
                mod.main(argv)            # the reference's fault: exit 1
            out[name] = (1, capsys.readouterr().out)
            continue
        rc, cap = _run(mod, argv, capsys)
        out[name] = (rc, cap.out, cap.err, json.loads(js.read_text()))
    assert out["port"][0] == out["ref"][0] == want_rc
    if case.endswith("_require_all"):
        # the reference prints up to its first missing violation
        lines = out["port"][1].splitlines()
        done = out["ref"][1].splitlines()
        assert lines[:len(done)] == done
        missing = [x for x in lines[len(done):] if "REGRESSION" in x]
        assert missing and all(x.endswith("missing from the fresh records")
                               for x in missing)
        assert lines[-1] == f"regress: FAIL ({len(missing)} regression(s))"
        assert not out["port"][3]["ok"]
        return
    assert out["port"] == out["ref"]
    assert ("regress: OK" in out["port"][1]) == (want_rc == 0)


@pytest.mark.parametrize("case", ["clean", "timing_plus_20pct",
                                  "missing_mode_require_all"])
def test_run_gate_equals_reference(tmp_path, case):
    edit, flags, _ = CASES[case]
    base = _write(tmp_path / "base", BASE)
    fresh_docs = copy.deepcopy(BASE)
    if edit is not None:
        edit(fresh_docs)
    fresh = _write(tmp_path / "fresh", fresh_docs)
    kw = dict(require_all="--require-all" in flags)
    r = R.run_gate(str(base), str(fresh), **kw)
    t = T.run_gate(str(base), str(fresh), **kw)
    assert [dataclasses.asdict(v) for v in t["violations"]] == [
        dataclasses.asdict(v) for v in r["violations"]]
    assert [str(v) for v in t["violations"] if v.kind != "missing"] == [
        str(v) for v in r["violations"] if v.kind != "missing"]
    assert (t["ok"], t["warnings"], t["compared_modes"]) == (
        r["ok"], r["warnings"], r["compared_modes"])
    rows_r = R.compare_rows("m", BASE["fig_sync"]["records"][0],
                            fresh_docs["fig_sync"]["records"][0])
    rows_t = T.compare_rows("m", BASE["fig_sync"]["records"][0],
                            fresh_docs["fig_sync"]["records"][0])
    assert [dataclasses.asdict(v) for v in rows_t] == [
        dataclasses.asdict(v) for v in rows_r]
    assert T.load_bench_dir(str(base)) == R.load_bench_dir(str(base))


@pytest.mark.parametrize("bad", ["no_dir", "empty_dir", "bad_json"])
def test_load_errors_exit_2_like_reference(tmp_path, capsys, bad):
    base = tmp_path / "base"
    if bad == "empty_dir":
        base.mkdir()
    elif bad == "bad_json":
        base.mkdir()
        (base / "BENCH_fig_sync.json").write_text("{not json")
    out = {}
    for name, mod in (("ref", R), ("port", T)):
        rc, cap = _run(mod, ["--baseline", str(base)], capsys)
        out[name] = (rc, cap.out, cap.err)
    assert out["port"] == out["ref"]
    assert out["port"][0] == 2 and out["port"][2].startswith(
        "regress: error:")


def test_usage_error_exits_2(capsys):
    for mod in (R, T):
        with pytest.raises(SystemExit) as e:
            mod.main(["--timing-rtol", "not-a-number"])
        assert e.value.code == 2
    capsys.readouterr()


def test_port_imports_nothing_of_the_reference():
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(T))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if n == "repro" or n.startswith("repro.")
                or n.startswith("jax")]
