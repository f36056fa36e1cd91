"""CUDA tests of the port's fused superstep kernels (marker `cuda`).

They need a CUDA device and skip without one; on the GPU machine run
`python -m pytest -q -m cuda tests/test_torch_cuda.py`.  Each kernel is
held against its plain PyTorch version on the same inputs: min-plus
bit-equal (values, deltas, node_un; p_sum at rtol 1e-6 since the lane
sum order differs), plus-times at rtol = atol = 1e-5 with node_un exact.
This file imports neither jax nor repro, so it runs where JAX is absent.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import (build_blocked, build_block_pairs,  # noqa: E402
                               rmat_graph, uniform_graph)
from repro_torch.kernels.fused_superstep import kernel as fk  # noqa: E402
from repro_torch.kernels.fused_superstep.ops import (  # noqa: E402
    _pick_job_block)
from repro_torch.kernels.fused_superstep.ref import (  # noqa: E402
    fused_superstep_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pairs(semiring, vb, device, n=None, seed=13):
    n = n or 10 * vb
    if semiring == "plus_times":
        csr = rmat_graph(n, 4, seed=seed)
        g = build_blocked(csr, vb, fill=0.0, normalize="out_degree",
                          device=device)
    else:
        csr = uniform_graph(n, 4, seed=seed, weighted=True, w_max=7.0)
        g = build_blocked(csr, vb, fill=float(np.inf), device=device)
    return g, build_block_pairs(g)


def _state(rng, j, bn_src, bn_loc, vb, semiring, device):
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    if semiring == "plus_times":
        return (t(rng.standard_normal((j, bn_src, vb))),
                t(rng.standard_normal((j, bn_loc, vb))), None)
    d = (rng.random((j, bn_src, vb)) * 10).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    vals = (rng.random((j, bn_loc, vb)) * 10).astype(np.float32)
    base = np.where(rng.random(vals.shape) < 0.5, vals, np.inf)
    return t(d), t(base), t(vals)


def _compare(semiring, got, want, rows):
    got = [x.cpu().numpy()[:, rows] for x in got]
    want = [x.cpu().numpy()[:, rows] for x in want]
    if semiring == "plus_times":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    else:
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("j", [1, 4, 13])
@pytest.mark.parametrize("vb", [16, 32, 64, 128])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_matches_plain(cuda, semiring, vb, j):
    g, bp = _pairs(semiring, vb, cuda)
    rng = np.random.default_rng(vb + j)
    bn = g.num_blocks
    d, base, vals = _state(rng, j, bn, bn, vb, semiring, cuda)
    before = fk.launches[semiring]
    got = fk.fused_superstep_call(
        bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles, values=vals,
        run_start=bp.run_start, semiring=semiring,
        job_block=_pick_job_block(j, vb, semiring))
    torch.cuda.synchronize()
    assert fk.launches[semiring] == before + 1
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    _compare(semiring, got, want, bp.dst_touched.cpu().numpy())


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_width_contract_and_job_chunks(cuda, semiring):
    """d at the global source width B_N, base/values/outputs at a local
    width B_loc < B_N: runs with a destination >= B_loc are dropped, the
    rest match; explicit job chunks (jb < J) give the same result."""
    vb = 32
    g, bp = _pairs(semiring, vb, cuda, n=1500)
    bn = g.num_blocks
    bn_loc = bn // 2
    rng = np.random.default_rng(5)
    d, base, vals = _state(rng, 6, bn, bn_loc, vb, semiring, cuda)
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    rows = bp.dst_touched.cpu().numpy()[:bn_loc]
    for jb in (None, 1, 2, 3):
        got = fk.fused_superstep_call(
            bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
            values=vals, semiring=semiring, job_block=jb)
        _compare(semiring, got, want, rows)


def test_cuda_tensor_never_reaches_plain_version(cuda, monkeypatch):
    """The dispatch rule: CUDA tensors launch the kernel or raise."""
    def boom(*a, **kw):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(fk, "fused_superstep_ref", boom)
    g, bp = _pairs("plus_times", 16, cuda)
    rng = np.random.default_rng(0)
    d, base, _ = _state(rng, 2, g.num_blocks, g.num_blocks, 16,
                        "plus_times", cuda)
    fk.fused_superstep_call(bp.src, bp.dst, bp.first, bp.last, d, base,
                            bp.tiles)
    torch.cuda.synchronize()
    # the Python mirror of the launcher's shared-memory size agrees
    for jb, vb in [(1, 16), (13, 16), (4, 64), (8, 128)]:
        assert fk._lib().fs_smem_bytes(jb, vb) == fk.smem_bytes(jb, vb)
    with pytest.raises(ValueError):      # Vb the kernels do not take
        fk.fused_superstep_call(bp.src, bp.dst, bp.first, bp.last,
                                d[..., :8].contiguous(),
                                base[..., :8].contiguous(),
                                bp.tiles[:, :8, :8].contiguous())
    with pytest.raises(ValueError):      # more than 1024 threads
        big = torch.zeros((128, g.num_blocks, 16), device=cuda)
        fk.fused_superstep_call(bp.src, bp.dst, bp.first, bp.last, big,
                                big, bp.tiles, job_block=128)


def test_session_on_cuda_goes_through_kernels(cuda):
    """A default CUDA session pushes through both kernels and matches a
    CPU session: min-plus bit-equal, plus-times within rtol 1e-4."""
    from repro_torch.algorithms import SSSP, PageRank
    from repro_torch.core import GraphSession, TwoLevel

    csr = rmat_graph(300, 4, seed=13)
    res = {}
    for dev in ("cpu", None):
        fk.reset_launches()
        sess = GraphSession(csr, 16, capacity=2, seed=5, device=dev)
        assert sess.use_pallas == (dev is None)
        h_pr = sess.submit(PageRank())
        h_ss = sess.submit(SSSP(source=3))
        assert sess.run(TwoLevel(), 20000).converged
        res[dev] = (sess.result(h_pr), sess.result(h_ss))
        if dev is None:
            assert fk.launches["plus_times"] > 0
            assert fk.launches["min_plus"] > 0
    np.testing.assert_array_equal(res[None][1], res["cpu"][1])
    np.testing.assert_allclose(res[None][0], res["cpu"][0], rtol=1e-4,
                               atol=1e-6)
