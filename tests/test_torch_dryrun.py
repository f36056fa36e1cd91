"""The port's dry run (`launch/{cost,dryrun,report,hillclimb}.py`)
against `repro.launch`'s.

(a) `cost.Collective`'s ring wire bytes equal `hlo_analysis.Collective`'s
    for every op and group size, `collective_summary` keeps the
    reference's keys, and `roofline_terms` picks the dominant term at the
    H100's published rates; (b) every architecture's argument bytes a
    device at its published widths, at train_4k and decode_32k on both
    production meshes, equal the reference's rule (`dryrun.py`'s
    `_local_bytes`) applied to `repro.launch.specs.build_cell`'s specs
    and shardings (the reference's meshes are `AbstractMesh`es: no
    devices); (c) the FLOPs counted on a smoke train cell against the
    analytic model (the reference's bar, 0.5-2x the forward x 3) and
    against `repro`'s dot count of the same step compiled on one CPU
    device (within 35%); (d) every hill-climb variant's overrides; (e)
    the report's helpers, and its tables rendering records of
    `run_cell`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

torch = pytest.importorskip("torch")

from repro import configs as rconfigs  # noqa: E402
from repro.launch import hillclimb as rhill  # noqa: E402
from repro.launch import hlo_analysis as H  # noqa: E402
from repro.launch import report as rreport  # noqa: E402
from repro.launch import specs as rspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import cost, dryrun, hillclimb, report, specs  # noqa
from repro_torch.launch.analytic import cell_flops  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
SMOKE_TRAIN = ShapeConfig("t", "train", 32, 4)


@pytest.mark.parametrize("group", [1, 2, 4, 16])
@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_match_repro(op, group):
    for b in (1000, 4096, 12345):
        got = cost.Collective(op, b, group, 1, "x").wire_bytes_per_device
        want = H.Collective(op=op, tensor_bytes=b, group_size=group,
                            multiplier=1,
                            computation="x").wire_bytes_per_device
        assert got == want, (op, group, b)


def test_collective_summary_keeps_the_reference_keys():
    cases = [("all-reduce", 1000, 4, 3), ("all-gather", 800, 16, 1),
             ("reduce-scatter", 250, 2, 2), ("collective-permute", 64, 2, 1)]
    got = cost.collective_summary([
        cost.Collective(op, b, g, m, "x",
                        tuple(range(g)) if op != "all-gather"
                        else tuple(range(0, 32, 2)))
        for op, b, g, m in cases])
    want = H.collective_summary([H.Collective(op, b, g, m, "x")
                                 for op, b, g, m in cases])
    assert set(want) <= set(got)
    assert all(got[k] == pytest.approx(want[k]) for k in want)
    # the all-gather's 16 ranks span four nodes of 8: the network
    ag = H.Collective("all-gather", 800, 16, 1, "x").wire_bytes_per_device
    assert got["network_wire_bytes"] == pytest.approx(ag)
    assert got["nvlink_wire_bytes"] + got["network_wire_bytes"] == \
        pytest.approx(got["total_wire_bytes"])


def test_links_follow_the_nodes():
    assert cost.within_node(range(8)) and cost.within_node((8, 15))
    assert not cost.within_node((7, 8))
    assert cost.Collective("all-reduce", 1, 2, 1, "x", (0, 1)).link == \
        "nvlink"
    assert cost.Collective("all-reduce", 1, 16, 1, "x",
                           tuple(range(16))).link == "network"


def test_roofline_terms_dominance_at_h100_rates():
    t = cost.roofline_terms(cost.PEAK_FLOPS, 100e9, 1e9)
    assert t["dominant"] == "compute"
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(100e9 / 3.35e12)
    assert t["nvlink_s"] == pytest.approx(1e9 / 450e9)
    t = cost.roofline_terms(1e12, cost.HBM_BW, 0.0)
    assert t["dominant"] == "memory" and t["memory_s"] == pytest.approx(1)
    # 10 GB over the network (50 GB/s) outweighs it over NVLink
    t = cost.roofline_terms(1e12, 1e9, 10e9, 10e9)
    assert t["dominant"] == "collective"
    assert t["collective_s"] == pytest.approx(10e9 / 450e9 + 10e9 / 50e9)
    assert cost.PEAK_FLOPS == 989.4e12 and cost.NETWORK_BW == 50e9


def _ref_local_bytes(cell, mesh) -> int:
    """`repro.launch.dryrun`'s `_local_bytes` over a cell's arguments."""
    total = 0
    for args, shard in zip(cell.args, cell.in_shardings):
        for s, sh in zip(jax.tree_util.tree_leaves(args),
                         jax.tree_util.tree_leaves(
                             shard, is_leaf=lambda x: hasattr(x, "spec"))):
            n = 1
            parts = list(sh.spec) + [None] * (len(s.shape) - len(sh.spec))
            for dim, ax in zip(s.shape, parts):
                if ax is None:
                    n *= dim
                else:
                    axes = (ax,) if isinstance(ax, str) else tuple(ax)
                    k = 1
                    for a in axes:
                        k *= mesh.shape[a]
                    n *= -(-dim // k)
            total += n * s.dtype.itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", rconfigs.ARCH_NAMES)
def test_arg_bytes_match_repro_at_published_widths(arch, shape, multi_pod):
    rmesh = AbstractMesh(*MESHES[multi_pod])
    cell = specs.build_cell(arch, shape,
                            make_production_mesh(multi_pod=multi_pod))
    got = dryrun.local_bytes(cell.args, cell.in_shardings)
    assert got == _ref_local_bytes(rspecs.build_cell(arch, shape, rmesh),
                                   rmesh)


@pytest.fixture(scope="module")
def smoke_train_record():
    cfg = configs.get_smoke("qwen3-32b")
    return dryrun.run_cell("qwen3-32b", "train_4k", False, cfg=cfg,
                           shape=SMOKE_TRAIN, mesh_shape=(1, 1))


def test_counted_flops_match_analytic_and_repro_dots(smoke_train_record):
    """The reference's bar (tests/test_hlo_analysis.py): the dots within
    0.5-2x of the analytic forward x 3; and within 35% of `repro`'s
    parse_dot_flops of the same loss and gradient compiled on one CPU
    device (both count remat's recomputed forward)."""
    from repro.models import LM as RLM
    flops = smoke_train_record["hlo_flops_per_dev"]
    expect = cell_flops(configs.get_smoke("qwen3-32b"),
                        SMOKE_TRAIN)["fwd_flops"] * 3
    assert 0.5 * expect < flops < 2.0 * expect, (flops, expect)

    cfg = dataclasses.replace(rconfigs.get_smoke("qwen3-32b"),
                              scan_layers=True)
    model = RLM(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    batch = {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32)}
    comp = jax.jit(jax.grad(model.loss)).lower(params, batch).compile()
    ref = H.parse_dot_flops(comp.as_text())
    assert abs(flops - ref) <= 0.35 * ref, (flops, ref)


def test_smoke_record_keys_and_memory(smoke_train_record):
    r = smoke_train_record
    for k in ("arch", "shape", "mesh", "n_devices", "status", "trace_s",
              "arg_bytes_analytic", "peak_bytes_per_dev",
              "temp_bytes_per_dev", "hlo_flops_per_dev",
              "hbm_bytes_per_dev_est", "collectives", "analytic",
              "model_flops_ratio", "roofline", "policy", "fits_80gb"):
        assert k in r, k
    assert r["status"] == "ok" and r["mesh"] == "1x1" and r["policy"] == "dp"
    # one device: no collective; the state's step is a host int (the
    # spec's 4-byte int32)
    assert r["n_hlo_collectives"] == 0 and r["comm_calls"] == 0
    assert r["arg_bytes_analytic"] == r["arg_bytes_per_dev"] + 4
    assert r["peak_bytes_per_dev"] == r["resident_bytes_per_dev"] + \
        r["temp_bytes_per_dev"]
    assert r["hbm_bytes_per_dev_est"] == 2.0 * r["arg_bytes_analytic"] + \
        r["temp_bytes_per_dev"]
    assert r["fits_80gb"] and r["roofline"]["dominant"] in (
        "compute", "memory")


def test_variant_overrides_match_repro():
    names = ("baseline", "accum2", "accum4", "policy_tp", "policy_dp",
             "kv_chunk_2k", "q_chunk_1k", "q_chunk_2k", "q_chunk_4k",
             "bf16_reduce", "qkv_sp", "full_sp", "no_remat",
             "unroll_layers", "dense_expert")
    for arch in ("minicpm-2b", "mixtral-8x7b"):
        for name in names:
            cfg, kw = hillclimb.variant_overrides(name, configs.get(arch))
            rcfg, rkw = rhill.variant_overrides(name, rconfigs.get(arch))
            assert kw == rkw, name
            assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg), name
    for mod in (hillclimb, rhill):
        with pytest.raises(ValueError):
            mod.variant_overrides("nope", configs.get("minicpm-2b"))


def test_full_sp_is_recorded_as_an_error():
    rec = hillclimb.run("qwen2.5-14b", "decode_32k", "full_sp")
    assert rec["status"] == "error" and rec["variant"] == "full_sp"
    assert rec["error"].startswith("NotImplementedError: force_sp")


def test_report_helpers_and_tables(smoke_train_record):
    for x in (0.0, 1e-4, 0.05, 0.1, 3.25):
        assert report.fmt_s(x) == rreport.fmt_s(x)
    for x in (0, 2**30, 123456789):
        assert report.gib(x) == rreport.gib(x)
    dec = dryrun.run_cell("mixtral-8x7b", "decode_32k", False,
                          cfg=configs.get_smoke("mixtral-8x7b"),
                          shape=ShapeConfig("d", "decode", 32, 4),
                          mesh_shape=(2, 2))
    assert dec["n_hlo_collectives"] == len(dec["calls"]) > 0
    assert dec["comm_calls"] == dec["n_hlo_collectives"]
    records = [dict(smoke_train_record, mesh="16x16"),
               dict(dec, mesh="16x16"),
               {"arch": "qwen2.5-14b", "shape": "long_500k",
                "mesh": "16x16", "status": "skipped", "reason": "x"},
               {"arch": "xlstm-350m", "shape": "train_4k", "mesh": "16x16",
                "status": "error", "error": "x"}]
    table = report.dryrun_table(records).splitlines()
    assert len(table) == 6 and "peak GiB/dev (meta)" in table[0]
    assert "| qwen3-32b | train_4k | 16x16 | dp |" in table[2]
    assert "skip" in table[4] and "ERROR" in table[5]
    roof = report.roofline_table(records).splitlines()
    assert len(roof) == 4 and "mixtral-8x7b" in roof[3]
    t = report.recompute_terms(dec)
    assert t["dominant"] == dec["roofline"]["dominant"]
    assert all(t[k] == pytest.approx(dec["roofline"][k])
               for k in t if k != "dominant")


def test_the_fake_world_is_gone_after_a_run(smoke_train_record):
    import torch.distributed as dist
    from repro_torch.dist import comm
    assert not dist.is_initialized() and not comm._GROUPS
    with pytest.raises(RuntimeError, match="fake world"):
        with dryrun.fake_world(2):
            with dryrun.fake_world(2):
                pass
    assert not dist.is_initialized()


def test_cli_writes_records_and_report_renders(tmp_path, monkeypatch,
                                               capsys):
    """main() on a cell it skips (long_500k of a full-attention model)
    writes the skip record, exits 0, and the report renders it."""
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "qwen2.5-14b", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(out)]) == 0
    import json
    recs = json.loads(out.read_text())
    assert [(r["mesh"], r["status"]) for r in recs] == [
        ("16x16", "skipped"), ("2x16x16", "skipped")]
    monkeypatch.setattr("sys.argv", ["report", str(out)])
    report.main()
    assert "0 ok / 2 skipped-documented / 0 errors" in capsys.readouterr().out
    assert np.isfinite(cost.HBM_PER_CARD) and cost.HBM_PER_CARD > 80e9
