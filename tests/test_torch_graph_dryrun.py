"""The port's graph dry run (`repro_torch.launch.graph_dryrun`) against
`repro.launch.graph_dryrun`.

The reference sets XLA_FLAGS to 512 host devices when it is imported, so
it runs in one subprocess (`REF_SCRIPT`): its CLI's two published
records, the raw argument bytes XLA's memory analysis gave them, and its
`fused_superstep` on seeded numpy inputs.  Held against them: (a) the
port's `fused_superstep` at J=4, B_N=16, K=4, Vb=16 (q = B_N, so ties in
the summed priority cannot change the selected set: `torch.topk` does
not specify its order on ties, `jax.lax.top_k` picks the lower index);
(b) the port's records on both meshes (q, B_N, Vb; the reference's
argument bytes to the byte; FLOPs of the whole push and each rank's
share; the wire bytes under a thousandth of GSPMD's; the plain-only
route at Vb=512), and no host allocation of tile data at pod scale;
(c) the fleet graph's regular structure, the meta route of the view
build, and the CLI.  The fake world against a real gloo world, call for
call, rides in tests/test_torch_dist.py's world of 4.
"""

import json
import os
import subprocess
import sys
import tracemalloc
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import PageRank  # noqa: E402
from repro_torch.graph.structure import build_view_shard  # noqa: E402
from repro_torch.launch import graph_dryrun as G  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
J, BN, K, VB = 4, 16, 4, 16
VB_PUB = 512                       # the published fleet's block size
WORLD = {"16x16": 256, "2x16x16": 512}

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.stages
import repro.launch.graph_dryrun as G
from repro.algorithms import PageRank

out_dir, = sys.argv[1:]
arg_bytes = []
real = jax.stages.Compiled.memory_analysis


def memory_analysis(self):
    m = real(self)
    arg_bytes.append(int(m.argument_size_in_bytes))
    return m


jax.stages.Compiled.memory_analysis = memory_analysis
sys.argv = ["graph_dryrun", "--out", out_dir + "/ref.json"]
G.main()
json.dump(arg_bytes, open(out_dir + "/arg_bytes.json", "w"))

J, BN, K, VB = 4, 16, 4, 16
rng = np.random.default_rng(0)
values = rng.random((J, BN, VB), dtype=np.float32)
deltas = (rng.random((J, BN, VB), dtype=np.float32) * 0.1
          * (rng.random((J, BN, VB)) < 0.7)).astype(np.float32)
tiles = (rng.random((BN, K, VB, VB), dtype=np.float32)
         * (rng.random((BN, K, VB, VB)) < 0.2) / VB).astype(np.float32)
nbr_ids = rng.integers(0, BN, (BN, K)).astype(np.int32)
push_scale = rng.random(J, dtype=np.float32)
step = G.fused_superstep(PageRank(), BN, BN, K, VB)
v, d, un = jax.jit(step)(values, deltas, tiles, nbr_ids, push_scale)
np.savez(out_dir + "/step.npz", values=values, deltas=deltas, tiles=tiles,
         nbr_ids=nbr_ids, push_scale=push_scale, v=np.asarray(v),
         d=np.asarray(d), un=np.asarray(un))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("graph_dryrun_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    records = json.loads((out / "ref.json").read_text())
    return dict(records={r["mesh"]: r for r in records},
                arg_bytes=dict(zip(("16x16", "2x16x16"), json.loads(
                    (out / "arg_bytes.json").read_text()))),
                step=dict(np.load(out / "step.npz")))


@pytest.fixture(scope="module")
def port():
    """The port's two published records; the single-pod one under
    tracemalloc (its host peak)."""
    tracemalloc.start()
    try:
        single = G.run(multi_pod=False)
        host_peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return dict(records={"16x16": single, "2x16x16": G.run(multi_pod=True)},
                host_peak=host_peak)


def test_fused_superstep_matches_reference(ref):
    s = ref["step"]
    step = G.fused_superstep(PageRank(), BN, BN, K, VB)
    v, d, un = step(*(torch.from_numpy(s[k]) for k in (
        "values", "deltas", "tiles", "nbr_ids", "push_scale")))
    assert int(un) == int(s["un"])
    np.testing.assert_allclose(v.numpy(), s["v"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), s["d"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh,job_shards", [("16x16", 16),
                                             ("2x16x16", 32)])
def test_published_record_matches_reference(ref, port, mesh, job_shards):
    r, want = port["records"][mesh], ref["records"][mesh]
    got = (r["q"], r["num_blocks"], r["vb"])
    assert got == (want["q"], want["num_blocks"], want["vb"]) == (200, 2048,
                                                                  VB_PUB)
    assert r["arg_bytes_analytic"] == ref["arg_bytes"][mesh]
    assert r["flops_one_device"] == want["flops_per_dev"] * job_shards
    assert r["flops_per_dev"] * 16 == want["flops_per_dev"]
    assert r["wire_gib_per_dev"] < want["wire_gib_per_dev"] / 1000
    # B1/B2 take Vb = 512: the rank's jobs in one pass, 12 jobs a pass
    # where a thread carries JW jobs, one (job, lane) a thread where two
    # jobs fit 1024 threads
    want_pass = {4: 12, 2: 2}[r["local_jobs"]]
    assert (r["kernel_route"], r["kernel_pass_jobs"]) == ("B1/B2", want_pass)


@pytest.mark.parametrize("mesh,local_jobs", [("16x16", 4),
                                             ("2x16x16", 2)])
def test_published_record_holds_the_rank(port, mesh, local_jobs):
    """One rank's session: the pair shard (4 GiB) and no ELL rows, the
    three collectives of a superstep, the plain route's products of
    every pair of the shard, the kernel route's live pairs."""
    r = port["records"][mesh]
    tile = VB_PUB * VB_PUB * 4
    assert r["local_jobs"] == local_jobs
    assert r["pairs_per_dev"] == 2048 * 32 // 16
    assert r["live_pairs_per_dev"] == 200 * 32 // 16
    assert r["pairs_per_dev"] * tile < r["arg_bytes_per_dev"] \
        < r["pairs_per_dev"] * tile * 1.01
    assert [c[:5] for c in r["calls"]] == [
        ["all-reduce", "torch.float64", [64 + 2 * 2048], (64 + 4096) * 8,
         WORLD[mesh]],
        ["all-reduce", "torch.float32", [local_jobs, 200, VB_PUB],
         local_jobs * 200 * VB_PUB * 4, 16],
        ["all-reduce", "torch.float64", [1], 8, WORLD[mesh]]]
    assert all(c[5] == "network" for c in r["calls"])
    assert r["flops_plain_per_dev"] == 2.0 * local_jobs * \
        r["pairs_per_dev"] * VB_PUB * VB_PUB
    assert r["roofline"]["dominant"] in ("memory", "collective")


def test_pod_run_allocates_no_tile_data_on_host(port):
    assert port["host_peak"] < 2**30


def test_fleet_graph_is_regular():
    csr = G.fleet_graph(4096, 64, 8, seed=3)
    sb = np.repeat(np.arange(csr.n), csr.out_degree) // 64
    db = csr.indices // 64
    pairs = np.unique(sb * 64 + db)
    assert len(pairs) == csr.nnz == 64 * 8
    assert (np.bincount(pairs // 64, minlength=64) == 8).all()
    assert (np.bincount(pairs % 64, minlength=64) == 8).all()
    again = G.fleet_graph(4096, 64, 8, seed=3)
    np.testing.assert_array_equal(csr.indices, again.indices)


def test_meta_view_shard_has_the_cpu_shapes():
    """The meta route allocates the same tensors as the CPU build (the
    index tensors from the same host arrays), with no host tile fill."""
    csr = G.fleet_graph(4096, 64, 8, seed=1)
    kw = dict(fill=0.0, normalize="out_degree")
    cpu = build_view_shard(csr, 64, 4, 1, device="cpu", **kw)
    meta = build_view_shard(csr, 64, 4, 1, device="meta", **kw)
    assert cpu[2] == meta[2]
    for a, b in ((cpu[0], meta[0]), (cpu[1], meta[1])):
        for name, x in vars(a).items():
            if isinstance(x, torch.Tensor):
                y = getattr(b, name)
                assert y.is_meta and (y.shape, y.dtype) == (x.shape,
                                                            x.dtype), name


def test_kernel_route():
    assert G.kernel_route(64, 4) == "B1/B2"
    assert G.kernel_route(512, 4) == "B1/B2"
    assert G.kernel_route(512, 2) == "B1/B2"
    assert G.kernel_route(48, 4).startswith("plain only")


def test_cli_writes_both_records(tmp_path, capsys):
    out = tmp_path / "g.json"
    assert G.main(["--vertices", "16384", "--jobs", "32", "--vb", "64",
                   "--nbr-blocks", "8", "--out", str(out)]) == 0
    records = json.loads(out.read_text())
    assert [r["mesh"] for r in records] == ["16x16", "2x16x16"]
    assert all(r["kernel_route"] == "B1/B2" for r in records)
    assert "| 16x16 |" in capsys.readouterr().out
