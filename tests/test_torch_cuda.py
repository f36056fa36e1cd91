"""CUDA tests of the port's kernels and device paths (marker `cuda`).

They need a CUDA device and skip without one; on the GPU machine run
`python -m pytest -q -m cuda tests/test_torch_cuda.py`.  Each kernel is
held against its plain PyTorch version on the same inputs: min-plus
bit-equal (values, deltas, node_un; p_sum at rtol 1e-6 since the lane
sum order differs), plus-times at rtol = atol = 1e-5 with node_un exact.
This file imports neither jax nor repro, so it runs where JAX is absent.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import (build_blocked, build_block_pairs,  # noqa: E402
                               rmat_graph, uniform_graph)
from repro_torch.kernels.fused_superstep import kernel as fk  # noqa: E402
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
@pytest.mark.parametrize("vb", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_matches_plain(cuda, semiring, vb, j):
    g, bp = _pairs(semiring, vb, cuda)
    rng = np.random.default_rng(vb + j)
    bn = g.num_blocks
    d, base, vals = _state(rng, j, bn, bn, vb, semiring, cuda)
    before = fk.launches[semiring]
    got = fk.fused_superstep_call(
        bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles, values=vals,
        run_start=bp.run_start, semiring=semiring)
    torch.cuda.synchronize()
    assert fk.launches[semiring] == before + 1
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    _compare(semiring, got, want, bp.dst_touched.cpu().numpy())


@pytest.mark.parametrize("vb", [32, 8, 256, 512])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_width_contract_and_job_chunks(cuda, semiring, vb):
    """d at the global source width B_N, base/values/outputs at a local
    width B_loc < B_N: runs with a destination >= B_loc are dropped, the
    rest match; with every job live, and with half of them dead (their
    rows the identity, flagged in `job_live`), J = 6 and J = 38."""
    g, bp = _pairs(semiring, vb, cuda, n=max(1500, 10 * vb))
    bn = g.num_blocks
    bn_loc = bn // 2
    rows = bp.dst_touched.cpu().numpy()[:bn_loc]
    ident = 0.0 if semiring == "plus_times" else float("inf")
    for j in (6, 38):
        rng = np.random.default_rng(5 + j)
        d, base, vals = _state(rng, j, bn, bn_loc, vb, semiring, cuda)
        for alive in (None, torch.arange(j, device=cuda) % 2 == 1):
            dj = d if alive is None else torch.where(alive[:, None, None], d,
                                                     ident)
            want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last,
                                       dj, base, bp.tiles, values=vals,
                                       semiring=semiring)
            got = fk.fused_superstep_call(
                bp.src, bp.dst, bp.first, bp.last, dj, base, bp.tiles,
                values=vals, job_live=alive, semiring=semiring)
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
    # the Python mirrors of the launcher's shared-memory size and of JW
    # agree, and every width's layout fits an SM (two blocks at the
    # many-jobs layout up to Vb = 128)
    for j, vb in [(1, 16), (13, 16), (4, 64), (8, 128), (4, 8), (64, 8),
                  (4, 256), (1, 256), (2, 512), (1, 512), (48, 64),
                  (38, 64), (16, 64), (10, 64), (38, 512), (7, 512),
                  (13, 128), (100, 16)]:
        geo = fk.kernel_geometry(vb, j)
        lay = fk.layout(j, vb)
        assert geo == {"wide_jobs": fk.wide_jobs(vb),
                       "smem_bytes": fk.smem_bytes(vb, j, lay)}, (j, vb)
        two = lay.jr > 1 and 2 * (fk.smem_bytes(vb, j, lay) + 1024) <= (
            fk.SMEM_PER_SM)
        for sr in ("plus_times", "min_plus"):
            n = fk.blocks_per_sm(vb, j, sr)
            assert n >= (2 if two else 1), (j, vb, sr)
    with pytest.raises(ValueError):      # Vb the kernels do not take
        fk.fused_superstep_call(bp.src, bp.dst, bp.first, bp.last,
                                d[..., :12].contiguous(),
                                base[..., :12].contiguous(),
                                bp.tiles[:, :12, :12].contiguous())
    with pytest.raises(ValueError):      # job ids past the shared memory
        big = torch.zeros((60000, g.num_blocks, 16), device=cuda)
        fk.fused_superstep_call(bp.src, bp.dst, bp.first, bp.last, big,
                                big, bp.tiles)


@pytest.mark.parametrize("vb,n", [(16, 300), (512, 3000)])
def test_session_on_cuda_goes_through_kernels(cuda, vb, n):
    """A default CUDA session pushes through both kernels and matches a
    CPU session: min-plus bit-equal, plus-times within rtol 1e-4; at Vb
    = 16 and at the paper's Vb = 512 (B_N = 6)."""
    from repro_torch.algorithms import SSSP, PageRank
    from repro_torch.core import GraphSession, TwoLevel

    csr = rmat_graph(n, 4, seed=13)
    res = {}
    for dev in ("cpu", None):
        fk.reset_launches()
        sess = GraphSession(csr, vb, capacity=2, seed=5, device=dev)
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


# --- B1/B2 redesign: split runs, live pairs, repeat calls, the gate ---------


def _split_pairs(semiring, device):
    """rmat_graph(2**14, 8) at Vb=32: 512 destination runs, the longest
    over 400 pairs, so it spans several chunks of `PAIR_CHUNK` = 64 and,
    taken whole, two passes of the kernel's 256-pair live list."""
    csr = rmat_graph(2**14, 8, seed=13, weighted=semiring == "min_plus",
                     w_max=7.0)
    if semiring == "plus_times":
        g = build_blocked(csr, 32, fill=0.0, normalize="out_degree",
                          device=device)
    else:
        g = build_blocked(csr, 32, fill=float(np.inf), device=device)
    return g, build_block_pairs(g)


def _masked_state(rng, j, bn, bn_loc, vb, semiring, device, frac):
    """Random state with the rows of d outside a random `frac` of the
    source blocks set to the semiring identity; returns (d, base, vals,
    live [bn] bool)."""
    d, base, vals = _state(rng, j, bn, bn_loc, vb, semiring, device)
    live = torch.as_tensor(rng.random(bn) < frac, device=device)
    ident = 0.0 if semiring == "plus_times" else float("inf")
    return torch.where(live[None, :, None], d, ident), base, vals, live


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("case", ["J4", "J7_jb1", "J4_Bloc_half"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_live_fraction_matches_plain(cuda, semiring, case, frac):
    """The kernel with `src_live` at live fractions 0, 0.3 and 1.0, on a
    graph whose longest run spans several chunks, against the plain
    version: J=4 (the main path's job axis), J=7 with jb=1 and
    B_loc = B_N/2.  Plus-times rtol = atol = 1e-5 with node_un exact;
    min-plus values, deltas and node_un bit-equal, p_sum rtol 1e-6."""
    g, bp = _split_pairs(semiring, cuda)
    assert int(np.diff(bp.run_start.cpu().numpy()).max()) > max(3 * 64, 256)
    bn, vb = g.num_blocks, g.block_size
    # J7_jb1: seven jobs, the first dead (its rows the identity)
    j, bn_loc = {"J4": (4, bn), "J7_jb1": (7, bn),
                 "J4_Bloc_half": (4, bn // 2)}[case]
    rng = np.random.default_rng(int(frac * 10) + j)
    d, base, vals, live = _masked_state(rng, j, bn, bn_loc, vb, semiring,
                                        cuda, frac)
    alive = None
    if case == "J7_jb1":
        alive = torch.arange(j, device=cuda) > 0
        d = torch.where(alive[:, None, None], d,
                        0.0 if semiring == "plus_times" else float("inf"))
    before = fk.launches[semiring]
    got = fk.fused_superstep_call(
        bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles, values=vals,
        run_start=bp.run_start, chunk_start=bp.chunk_start,
        chunk_run=bp.chunk_run, arrivals=bp.arrivals(), src_live=live,
        job_live=alive, semiring=semiring)
    torch.cuda.synchronize()
    assert fk.launches[semiring] == before + 1
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    _compare(semiring, got, want, bp.dst_touched.cpu().numpy()[:bn_loc])
    assert int(bp.arrivals().abs().sum()) == 0


@pytest.mark.parametrize("chunk", [1, 5, 64, None])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_repeated_calls_are_bit_identical(cuda, semiring, chunk):
    """Two consecutive calls on the same inputs give the same bits, at
    every chunk size (1 pair, 5, PAIR_CHUNK, whole runs): the arrival
    counters reset themselves and the last block's combine does not
    depend on which block arrives last."""
    from repro_torch.graph import chunk_table
    g, bp = _split_pairs(semiring, cuda)
    bn, vb = g.num_blocks, g.block_size
    cs, cr = (torch.as_tensor(a, device=cuda) for a in
              chunk_table(bp.run_start.cpu().numpy(), chunk))
    rng = np.random.default_rng(3)
    d, base, vals, live = _masked_state(rng, 4, bn, bn, vb, semiring, cuda,
                                        0.5)

    def call():
        return fk.fused_superstep_call(
            bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
            values=vals, run_start=bp.run_start, chunk_start=cs,
            chunk_run=cr, arrivals=bp.arrivals(), src_live=live,
            semiring=semiring)
    first, second = call(), call()
    torch.cuda.synchronize()
    rows = bp.dst_touched
    for a, b in zip(first, second):
        assert torch.equal(a[:, rows], b[:, rows])
    assert int(bp.arrivals().abs().sum()) == 0
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    _compare(semiring, first, want, rows.cpu().numpy())


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("vb", [8, 256, 512])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_wide_kernel_split_runs_match_plain(cuda, semiring, vb, chunk):
    """At the widths whose tiles stream in slices (256, 512: a thread
    carries the four jobs at 512) and at Vb = 8: every run cut into
    chunks of `chunk` pairs, half the sources live, against the plain
    version; a repeat call bit-identical and the arrival counters back at
    0."""
    from repro_torch.graph import chunk_table
    g, bp = _pairs(semiring, vb, cuda, n=12 * max(vb, 64))
    bn = g.num_blocks
    cs, cr = (torch.as_tensor(a, device=cuda) for a in
              chunk_table(bp.run_start.cpu().numpy(), chunk))
    j = 4
    rng = np.random.default_rng(vb + chunk)
    d, base, vals, live = _masked_state(rng, j, bn, bn, vb, semiring, cuda,
                                        0.5)

    def call():
        return fk.fused_superstep_call(
            bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
            values=vals, run_start=bp.run_start, chunk_start=cs,
            chunk_run=cr, arrivals=bp.arrivals(), src_live=live,
            semiring=semiring)
    first, second = call(), call()
    torch.cuda.synchronize()
    rows = bp.dst_touched
    for a, b in zip(first, second):
        assert torch.equal(a[:, rows], b[:, rows])
    assert int(bp.arrivals().abs().sum()) == 0
    want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d, base,
                               bp.tiles, values=vals, semiring=semiring)
    _compare(semiring, first, want, rows.cpu().numpy())


#: the benchmark cells' views: (Vb, slots, the live slots of each view's
#: jobs (the lowest free slot is taken), then a scattered layout and a
#: view whose jobs all converged inside a poll)
CELL_VIEWS = {(64, 48): {"plus_times": (38, "third", "none"),
                         "min_plus": (16, 10, "third", "none")},
              (512, 38): {"plus_times": (38, "third", "none"),
                          "min_plus": (16, 10, "third", "none")}}


def _cell_live(live, j, device):
    idx = torch.arange(j, device=device)
    if live == "third":
        return idx % 3 == 1
    if live == "none":
        return torch.zeros(j, dtype=torch.bool, device=device)
    return idx < live


@pytest.mark.parametrize("bn_loc_half", [False, True],
                         ids=["one_device", "mesh_width"])
@pytest.mark.parametrize("shape", sorted(CELL_VIEWS),
                         ids=lambda s: f"vb{s[0]}_j{s[1]}")
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_at_the_cells_shapes(cuda, semiring, shape, bn_loc_half):
    """B1/B2 at the benchmark cells' (Vb, J) with their slot layouts, half
    the sources live, d's dead rows the identity and flagged in
    `job_live`: against the plain version on the full computation, a
    repeat call bit-identical, and `b1b2_counts` adding what the flags and
    the live pairs imply.  With bn_loc < bn_src, the mesh's width."""
    vb, j = shape
    g, bp = _pairs(semiring, vb, cuda, n=max(4000, 12 * vb))
    bn = g.num_blocks
    bn_loc = bn // 2 if bn_loc_half else bn
    rows = bp.dst_touched.cpu().numpy()[:bn_loc]
    ident = 0.0 if semiring == "plus_times" else float("inf")
    for live in CELL_VIEWS[shape][semiring]:
        rng = np.random.default_rng(vb + j + (live if isinstance(live, int)
                                              else len(live)))
        d, base, vals, src_live = _masked_state(rng, j, bn, bn_loc, vb,
                                                semiring, cuda, 0.5)
        alive = _cell_live(live, j, cuda)
        d = torch.where(alive[:, None, None], d, ident)
        counts = fk.b1b2_counts(cuda)

        def call():
            return fk.fused_superstep_call(
                bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
                values=vals, run_start=bp.run_start,
                chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
                arrivals=bp.arrivals(), src_live=src_live, job_live=alive,
                semiring=semiring)
        before = counts.clone()
        first = call()
        added = (counts - before).tolist()
        second = call()
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a[:, :bn_loc][:, rows], b[:, :bn_loc][:, rows])
        assert int(bp.arrivals().abs().sum()) == 0
        assert added == fk.expected_counts(bp.src, bp.dst, src_live, alive,
                                           j, vb, bn, bn_loc).tolist()
        want = fused_superstep_ref(bp.src, bp.dst, bp.first, bp.last, d,
                                   base, bp.tiles, values=vals,
                                   semiring=semiring)
        _compare(semiring, first, want, rows)


def test_closed_gate_keeps_the_device_chunk_carry(cuda, monkeypatch):
    """A device chunk whose last slots are gated (the budget ends inside
    it) and whose converged group still launches: the carry equals, bit
    for bit, the same chunk with no gate passed to the kernels (every
    slot computed, then discarded, as before the gate existed)."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.policy import device_inputs
    from repro_torch.kernels.fused_superstep import ops as fops
    real = fops.fused_superstep_call
    seen = []

    def no_gate(*a, gate=None, **kw):
        seen.append(gate)
        return real(*a, **kw)

    carries = []
    for strip in (False, True):
        sess, _ = _device_session(None, rmat_graph(400, 4, seed=13))
        policy = TwoLevel(backend="device", steps_per_sync=8)
        step_fn = sess._device_step_fn(policy)
        state, *args = device_inputs(sess)
        if strip:
            monkeypatch.setattr(fops, "fused_superstep_call", no_gate)
        state, _ = step_fn(state, *args, 5, 5, 0)     # 3 gated slots
        torch.cuda.synchronize()
        carries.append(state)
    assert len(seen) == 16 and all(isinstance(g, torch.Tensor) for g in seen)
    assert not bool(seen[-1])                       # the last slot is gated
    a, b = carries
    assert int(a[0]) == int(b[0]) == 5
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


def test_fused_on_cuda_with_split_runs_reaches_the_cpu_fixpoint(cuda):
    """Fused() on the card with every destination run cut into chunks of
    3 pairs (so most runs combine partials across thread blocks) against
    the CPU run: SSSP bit-equal, PageRank/PPR within rtol 1e-4, atol
    1e-6."""
    from repro_torch.core import Fused
    from repro_torch.graph import chunk_table
    csr = rmat_graph(400, 4, seed=13)
    res = {}
    for dev in ("cpu", None):
        sess, hs = _device_session(dev, csr)
        for g in sess.view_groups():
            bp = sess._pair_data(g)
            cs, cr = chunk_table(bp.run_start.cpu().numpy(), 3)
            bp.chunk_start = torch.as_tensor(cs, device=bp.src.device)
            bp.chunk_run = torch.as_tensor(cr, device=bp.src.device)
        assert sess.run(Fused(), 20000).converged
        res[dev] = [sess.result(h) for h in hs]
    for k in (2, 3):
        np.testing.assert_array_equal(res[None][k], res["cpu"][k])
    for k in (0, 1):
        np.testing.assert_allclose(res[None][k], res["cpu"][k], rtol=1e-4,
                                   atol=1e-6)


# --- B3 (mj_spmm) and B4 (priority_pairs) -----------------------------------


def _mj_state(rng, q, k, j, vb, semiring, device, num_tiles=None):
    nt = q if num_tiles is None else num_tiles
    d = rng.random((q, j, vb)).astype(np.float32)
    t = rng.random((nt, k, vb, vb)).astype(np.float32)
    if semiring == "min_plus":
        d = d * 10
        d[rng.random(d.shape) < 0.5] = np.inf
        t = np.where(rng.random(t.shape) < 0.9, np.inf, t * 5)
    return (torch.as_tensor(d, device=device),
            torch.as_tensor(np.asarray(t, np.float32), device=device))


def _mj_compare(semiring, got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if semiring == "min_plus":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("j", [1, 4, 7, 11])
@pytest.mark.parametrize("vb", [8, 16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_mj_spmm_kernel_matches_plain(cuda, semiring, vb, j):
    """J = 11 is above the JR = 8 jobs a pass carries: two passes."""
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import mj_spmm
    from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref
    rng = np.random.default_rng(vb * 10 + j)
    q, k, bn = 9, 5, 13
    d, t = _mj_state(rng, q, k, j, vb, semiring, cuda)
    before = mk.launches[semiring]
    got = mj_spmm(d, t, semiring)
    torch.cuda.synchronize()
    assert mk.launches[semiring] == before + 1
    _mj_compare(semiring, got, mj_spmm_ref(d, t, semiring))
    # tile_index reads selected rows of a whole [B_N, K, Vb, Vb] array
    _, tiles = _mj_state(rng, q, k, j, vb, semiring, cuda, num_tiles=bn)
    idx = torch.as_tensor(rng.permutation(bn)[:q].astype(np.int32),
                          device=cuda)
    got = mj_spmm(d, tiles, semiring, tile_index=idx)
    _mj_compare(semiring, got, mj_spmm_ref(d, tiles[idx.long()], semiring))
    # explicit job blocks that divide J give the same result (one above
    # JR runs as passes of JR)
    for jb in {1, j}:
        got = mk.mj_spmm_call(d, t, semiring=semiring, job_block=jb)
        _mj_compare(semiring, got, mj_spmm_ref(d, t, semiring))


@pytest.mark.parametrize("vb,q,k,j", [
    (8, 3, 300, 13),      # K not a multiple of a stage (128) or a run
    (8, 1, 129, 4),       # q = 1, one tile past a stage
    (16, 2, 70, 9),
    (32, 1, 17, 16),      # two full passes
    (64, 1, 7, 4),        # q = 1, an odd K against 2 tiles a stage
    (128, 2, 3, 12),      # 8 + 4 jobs
    (256, 1, 2, 7),
    (512, 2, 3, 11),      # J above JR at the fleet's width
])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_mj_spmm_kernel_edge_shapes(cuda, semiring, vb, q, k, j):
    """Ragged K, q = 1, J above JR, and a tile_index with entries out of
    range (clamped, as the reference's gather clamps): a tile_index read
    is bit-equal to the gathered read, and both match the plain version;
    an explicit pass that divides J gives the same result."""
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import mj_spmm
    from repro_torch.kernels.mj_spmm.ref import mj_spmm_ref
    rng = np.random.default_rng(vb + q + k + j)
    bn = q + 3
    d, tiles = _mj_state(rng, q, k, j, vb, semiring, cuda, num_tiles=bn)
    raw = rng.integers(0, bn, q).astype(np.int32)
    raw[0] = -3                                  # clamped to 0
    if q > 1:
        raw[-1] = bn + 5                         # clamped to bn - 1
    idx = torch.as_tensor(raw, device=cuda)
    gathered = tiles[torch.as_tensor(np.clip(raw, 0, bn - 1),
                                     device=cuda).long()].contiguous()
    before = mk.launches[semiring]
    got_i = mj_spmm(d, tiles, semiring, tile_index=idx)
    got = mj_spmm(d, gathered, semiring)
    torch.cuda.synchronize()
    assert mk.launches[semiring] == before + 2
    assert torch.equal(got_i, got)
    want = mj_spmm_ref(d, tiles, semiring, tile_index=idx)
    _mj_compare(semiring, got, want)
    jb = max(x for x in range(1, j) if j % x == 0)   # a proper divisor
    _mj_compare(semiring, mk.mj_spmm_call(d, gathered, semiring=semiring,
                                          job_block=jb), want)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_push_shared_kernel_matches_ell_push(cuda, semiring):
    """The kernel-backed push on the card against the port's ELL push:
    min-plus bit-equal; plus-times values rtol 1e-6, deltas rtol 1e-5,
    atol 1e-6.  A padded slot aliases a selected block 0 and one
    neighbour id is the out-of-range sentinel B_N."""
    from repro_torch.core.push import shared_push_fn
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.mj_spmm import push_shared
    g, _ = _pairs(semiring, 32, cuda, n=700)
    bn, vb = g.num_blocks, g.block_size
    rng = np.random.default_rng(2)
    nbr = g.nbr_ids.clone()
    nbr[1, 0] = bn
    sel = torch.as_tensor([0, 3, 5, 1, 0], dtype=torch.int32, device=cuda)
    msk = torch.as_tensor([1, 1, 1, 1, 0], dtype=torch.float32, device=cuda)
    j = 4
    if semiring == "plus_times":
        v0 = torch.as_tensor(rng.random((j, bn, vb)), dtype=torch.float32,
                             device=cuda)
        d0 = torch.as_tensor(rng.random((j, bn, vb)), dtype=torch.float32,
                             device=cuda)
    else:
        v0 = torch.as_tensor(rng.random((j, bn, vb)) * 10,
                             dtype=torch.float32, device=cuda)
        d0 = torch.where(torch.as_tensor(rng.random((j, bn, vb)) < 0.5,
                                         device=cuda), v0, float("inf"))
    scale = torch.as_tensor(rng.random(j), dtype=torch.float32, device=cuda)
    before = mk.launches[semiring]
    v_k, d_k = push_shared(v0, d0, g.tiles, nbr, sel, msk, scale,
                           semiring=semiring)
    torch.cuda.synchronize()
    assert mk.launches[semiring] == before + 1
    ell = shared_push_fn(semiring, None, use_pallas=False)
    v_e, d_e = ell(v0, d0, g.tiles, nbr, sel, msk, scale, None, None)
    v_k, d_k, v_e, d_e = (x.cpu().numpy() for x in (v_k, d_k, v_e, d_e))
    if semiring == "min_plus":
        np.testing.assert_array_equal(v_k, v_e)
        np.testing.assert_array_equal(d_k, d_e)
    else:
        np.testing.assert_allclose(v_k, v_e, rtol=1e-6)
        np.testing.assert_allclose(d_k, d_e, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("j,bn,vb", [(1, 7, 8), (4, 1024, 64), (7, 33, 128),
                                     (4, 50, 16), (3, 9, 40)])
def test_priority_pairs_kernel_matches_plain(cuda, j, bn, vb):
    from repro_torch.core.priority import block_pairs
    from repro_torch.kernels.priority_pairs import kernel as pk
    from repro_torch.kernels.priority_pairs import priority_pairs
    rng = np.random.default_rng(j + bn + vb)
    p = rng.random((j, bn, vb)).astype(np.float32)
    p[rng.random(p.shape) < 0.5] = 0.0
    p = torch.as_tensor(p, device=cuda)
    before = pk.launches["priority_pairs"]
    n_k, m_k = priority_pairs(p)
    torch.cuda.synchronize()
    assert pk.launches["priority_pairs"] == before + 1
    n_p, m_p = block_pairs(p)
    np.testing.assert_array_equal(n_k.cpu().numpy(), n_p.cpu().numpy())
    np.testing.assert_allclose(m_k.cpu().numpy(), m_p.cpu().numpy(),
                               rtol=1e-6)


def _edge_priorities(rng, j, bn, vb):
    """Priorities with half the entries <= 0 plus NaN, -0.0 and +inf
    entries, a row of only non-positive values and a row holding +inf."""
    p = rng.standard_normal((j, bn, vb)).astype(np.float32)
    flat = p.reshape(-1)
    idx = rng.permutation(flat.size)
    n = max(1, flat.size // 16)
    flat[idx[:n]] = np.nan
    flat[idx[n:2 * n]] = -0.0
    flat[idx[2 * n:3 * n]] = np.inf
    p[0, 0] = -np.abs(p[0, 0])
    p[-1, -1, 0] = np.inf
    return p


def _hold_pairs(p, n_k, m_k):
    """node_un exact; p_mean at rtol 1e-6 against block_pairs, with the
    same inf and NaN positions."""
    from repro_torch.core.priority import block_pairs
    n_p, m_p = block_pairs(p)
    np.testing.assert_array_equal(n_k.cpu().numpy(), n_p.cpu().numpy())
    np.testing.assert_allclose(m_k.cpu().numpy(), m_p.cpu().numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("variant,vb", [
    ("vector", 4), ("vector", 8), ("vector", 16), ("vector", 40),
    ("vector", 64), ("vector", 128), ("vector", 256), ("scalar", 1),
    ("scalar", 3), ("misaligned", 64), ("forced-scalar", 64)])
def test_priority_pairs_variants_match_block_pairs(cuda, variant, vb):
    """Each kernel variant against block_pairs on NaN, -0.0, +inf and
    negative entries; a misaligned view (one float into its storage)
    takes the scalar variant, and `lanes=0` forces it on an aligned
    one."""
    from repro_torch.kernels.priority_pairs import kernel as pk
    rng = np.random.default_rng(vb)
    j, bn = 3, 301
    host = torch.as_tensor(_edge_priorities(rng, j, bn, vb))
    if variant == "misaligned":
        buf = torch.empty(host.numel() + 1, device=cuda)
        p = buf[1:].view(j, bn, vb)
        p.copy_(host)
    else:
        p = host.to(cuda)
    assert p.is_contiguous()
    lanes = pk.pick_variant(vb, p.data_ptr())
    assert (lanes > 0) == (variant in ("vector", "forced-scalar"))
    before = pk.launches["priority_pairs"]
    n_k, m_k = pk.priority_pairs_call(
        p, lanes=0 if variant == "forced-scalar" else None)
    torch.cuda.synchronize()
    assert pk.launches["priority_pairs"] == before + 1
    _hold_pairs(p, n_k, m_k)


@pytest.mark.parametrize("vb", [3, 64])
def test_priority_pairs_repeat_call_and_output_rows(cuda, vb):
    """A repeat call is bit-identical and counts one more launch; node_un
    and p_mean are two rows of one buffer, so writing into the returned
    node_un leaves p_mean as it was."""
    from repro_torch.kernels.priority_pairs import kernel as pk
    rng = np.random.default_rng(7)
    p = torch.as_tensor(_edge_priorities(rng, 4, 1024, vb), device=cuda)
    n1, m1 = pk.priority_pairs_call(p)
    before = pk.launches["priority_pairs"]
    n2, m2 = pk.priority_pairs_call(p)
    torch.cuda.synchronize()
    assert pk.launches["priority_pairs"] == before + 1
    for a, b in ((n1, n2), (m1, m2)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    m_before = m2.clone()
    n2.fill_(-7.0)
    torch.cuda.synchronize()
    assert torch.equal(m2, m_before)


def test_b3_b4_cuda_tensors_never_reach_plain_versions(cuda, monkeypatch):
    from repro_torch.kernels import common
    from repro_torch.kernels.mj_spmm import kernel as mk
    from repro_torch.kernels.priority_pairs import kernel as pk

    def boom(*a, **kw):
        raise AssertionError("plain version reached with CUDA tensors")
    monkeypatch.setattr(mk, "mj_spmm_ref", boom)
    monkeypatch.setattr(pk, "priority_pairs_ref", boom)
    rng = np.random.default_rng(0)
    d, t = _mj_state(rng, 3, 2, 4, 16, "plus_times", cuda)
    mk.mj_spmm_call(d, t)
    misaligned = torch.zeros(2 * 5 * 16 + 1, device=cuda)[1:].view(2, 5, 16)
    for p in (torch.zeros((2, 5, 16), device=cuda),      # vector
              torch.zeros((2, 5, 3), device=cuda),       # scalar
              misaligned):                               # scalar
        pk.priority_pairs_call(p)
    torch.cuda.synchronize()
    for vb in mk.SUPPORTED_VB:           # the .cu file's geometry
        for jb in (1, 4, 5, 8):
            assert mk.kernel_geometry(jb, vb) == mk.geometry(jb, vb)
            two = 2 * (mk.smem_bytes(jb, vb) + 1024) <= 228 * 1024
            assert mk.blocks_per_sm(jb, vb, "min_plus") >= (2 if two else 1)
    with pytest.raises(ValueError, match="more than JR"):
        mk.kernel_geometry(mk.JR + 1, 64)
    with pytest.raises(ValueError):      # Vb the kernel does not take
        mk.mj_spmm_call(d[..., :12].contiguous(),
                        t[..., :12, :12].contiguous())
    big = torch.zeros((3, 32, 64), device=cuda)
    with pytest.raises(ValueError):      # a job block that does not divide J
        mk.mj_spmm_call(big, torch.zeros((3, 2, 64, 64), device=cuda),
                        job_block=12)
    with pytest.raises(RuntimeError, match="more than JR"):
        common.launch(mk._lib().ms_mj_spmm, big.device,   # the C guard
                      mk._lib().ms_error_string, big.data_ptr(),
                      big.data_ptr(), None, big.data_ptr(), 1, 1, 32, 16,
                      1, 64, 0)


# --- the device scheduling backend on the card ------------------------------


def _device_session(device, csr, telemetry=None):
    from repro_torch.algorithms import SSSP, PageRank, PersonalizedPageRank
    from repro_torch.core import GraphSession
    sess = GraphSession(csr, 16, capacity=2, seed=5, device=device,
                        telemetry=telemetry)
    hs = [sess.submit(a) for a in (PageRank(), PersonalizedPageRank(source=3),
                                   SSSP(source=3), SSSP(source=40))]
    return sess, hs


def test_device_chunk_runs_without_an_implicit_sync(cuda):
    """One chunk of the device driver (pairs, DO sampling, global
    synthesis, both kernels, gating, counters) forces no host sync; the
    driver's one explicit read comes after it."""
    from repro_torch.core import TwoLevel
    from repro_torch.core.policy import device_inputs
    sess, _ = _device_session(None, rmat_graph(400, 4, seed=13))
    policy = TwoLevel(backend="device", steps_per_sync=4)
    step_fn = sess._device_step_fn(policy)
    state, *args = device_inputs(sess)
    state, un = step_fn(state, *args, 1000, 5, 0)      # warm-up
    torch.cuda.synchronize()
    launched = dict(fk.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, un = step_fn(state, *args, 1000, 5, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it_h, un_h = torch.stack([state[0], un.to(torch.int64)]).tolist()
    assert it_h == 8 and un_h > 0
    assert fk.launches["plus_times"] == launched["plus_times"] + 4
    assert fk.launches["min_plus"] == launched["min_plus"] + 4


def test_fused_on_cuda_reaches_the_cpu_fixpoint(cuda):
    """Fused() on the card through the kernels against the same run on
    the CPU: SSSP bit-equal, PageRank/PPR within rtol 1e-4, atol 1e-6."""
    from repro_torch.core import Fused, TwoLevel
    csr = rmat_graph(400, 4, seed=13)
    res, ms = {}, {}
    for dev in ("cpu", None):
        sess, hs = _device_session(dev, csr)
        fk.reset_launches()
        ms[dev] = sess.run(Fused(), 20000)
        assert ms[dev].converged
        res[dev] = [sess.result(h) for h in hs]
        if dev is None:
            assert fk.launches["plus_times"] > 0
            assert fk.launches["min_plus"] > 0
            sess2, _ = _device_session(dev, csr)
            m8 = sess2.run(TwoLevel(backend="device", steps_per_sync=8),
                           20000)
            assert (m8.supersteps, m8.tile_loads, m8.tile_pair_loads) == (
                ms[dev].supersteps, ms[dev].tile_loads,
                ms[dev].tile_pair_loads)
    for k in (2, 3):
        np.testing.assert_array_equal(res[None][k], res["cpu"][k])
    for k in (0, 1):
        np.testing.assert_allclose(res[None][k], res["cpu"][k], rtol=1e-4,
                                   atol=1e-6)


def test_scheduler_device_backend_runs_on_the_card(cuda, monkeypatch):
    """TwoLevelScheduler(backend="device") with device=None schedules on
    the card, and its queues equal a CPU scheduler's at each position."""
    from repro_torch.core import TwoLevelScheduler
    from repro_torch.core import scheduler as sch
    seen = []
    real = sch.group_queues_device

    def spy(nu, *a, **kw):
        seen.append(nu.device.type)
        return real(nu, *a, **kw)
    monkeypatch.setattr(sch, "group_queues_device", spy)
    rng = np.random.default_rng(6)
    nu = rng.integers(0, 10, (3, 300)).astype(np.float32)
    pm = rng.random((3, 300)).astype(np.float32)
    on_card = TwoLevelScheduler(300, 25, seed=4, samples=40,
                                backend="device")
    on_cpu = TwoLevelScheduler(300, 25, seed=4, samples=40,
                               backend="device", device="cpu")
    assert on_card.device.type == "cuda"
    for _ in range(3):
        (qa, ga), (qb, gb) = (s.select(nu, pm) for s in (on_card, on_cpu))
        for a, b in zip(qa, qb):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ga, gb)
    assert seen == ["cuda", "cpu"] * 3


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_con_processing_on_the_card_goes_through_mj_spmm(cuda, semiring):
    """The paper API's push on CUDA tensors launches the mj_spmm kernel
    (push_shared) and matches the CPU's over three supersteps: min-plus
    bit-equal, plus-times rtol 1e-5 (deltas with atol 1e-6)."""
    from repro_torch.algorithms import SSSP, PageRank
    from repro_torch.core import (Con_processing, De_Gl_Priority,
                                  De_In_Priority, make_run,
                                  optimal_queue_length)
    from repro_torch.kernels.mj_spmm import kernel as mk
    if semiring == "plus_times":
        csr, algs = rmat_graph(600, 4, seed=3), [PageRank(),
                                               PageRank(damping=0.7)]
    else:
        csr = uniform_graph(600, 4, seed=3, weighted=True, w_max=7.0)
        algs = [SSSP(source=0), SSSP(source=300)]
    runs = {dev: make_run(algs, csr, 32, device=dev) for dev in ("cpu", None)}
    g = runs["cpu"].graph
    q = optimal_queue_length(g.num_blocks, g.n_real)
    for _ in range(3):
        jq = De_In_Priority(algs[0], runs["cpu"].values, runs["cpu"].deltas,
                            q, np.random.default_rng(1))
        gq = De_Gl_Priority(jq, g.num_blocks, q)
        before = mk.launches[semiring]
        for run in runs.values():
            run.values, run.deltas = Con_processing(run, gq, q)
        torch.cuda.synchronize()
        assert mk.launches[semiring] == before + 1
    got = [x.cpu().numpy() for x in (runs[None].values, runs[None].deltas)]
    want = [x.numpy() for x in (runs["cpu"].values, runs["cpu"].deltas)]
    if semiring == "min_plus":
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


# --- evolving graphs: the overlay ride-along and compaction on the card -----


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_kernel_route_with_live_overlay_matches_cpu(cuda, semiring):
    """The kernel route (B1/B2 plus the overlay ride-along on the deltas
    gathered before the kernel consumes them) with a live overlay on the
    card against the CPU's plain route on the same inputs: min-plus
    bit-equal, plus-times at rtol 1e-5."""
    from repro_torch.core.push import shared_push_fn
    from repro_torch.graph import TileOverlay

    vb, j, cap = 32, 4, 6
    out = {}
    for dev in ("cpu", cuda):
        g, bp = _pairs(semiring, vb, dev)
        bn = g.num_blocks
        r = np.random.default_rng(29)
        arrs = (r.integers(0, vb, (bn, cap)).astype(np.int32),
                r.integers(0, 3 * vb, (bn, cap)).astype(np.int32),
                r.uniform(0.5, 4.0, (bn, cap)).astype(np.float32),
                (r.random((bn, cap)) < 0.7).astype(np.float32))
        ov = TileOverlay(cap, *(torch.as_tensor(a, device=dev)
                                for a in arrs))
        vals = r.uniform(0.0, 9.0, (j, bn, vb)).astype(np.float32)
        d = r.uniform(0.0, 1.0, (j, bn, vb)).astype(np.float32)
        if semiring == "min_plus":
            d[r.random(d.shape) < 0.5] = np.inf
        sel = np.array([0, 3, 5, 7, 0], np.int32)
        msk = np.array([1, 1, 1, 1, 0], np.float32)    # a padded slot
        t = functools.partial(torch.as_tensor, device=dev)
        fn = shared_push_fn(semiring, None, dev != "cpu")
        fk.reset_launches()
        v2, d2 = fn(t(vals), t(d), g.tiles, g.nbr_ids, t(sel), t(msk),
                    t(np.array([0.85, 0.5, 1.0, 0.7], np.float32)), ov, bp)
        if dev != "cpu":
            assert fk.launches[semiring] == 1
        out[str(dev)] = (v2.cpu().numpy(), d2.cpu().numpy())
    (vc, dc), (vg, dg) = out["cpu"], out[str(cuda)]
    if semiring == "min_plus":
        np.testing.assert_array_equal(vg, vc)
        np.testing.assert_array_equal(dg, dc)
    else:
        np.testing.assert_allclose(vg, vc, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(dg, dc, rtol=1e-5, atol=1e-6)


def test_structural_batch_then_compaction_under_fused_on_the_card(cuda):
    """A session on the card takes a structural batch (an overlay entry)
    under Fused(), then compacts: its fixpoint equals a fresh CUDA session
    on the final CSR (min-plus bit-equal, plus-times at rtol 1e-4) and
    its tiles and pair view a fresh build."""
    from repro_torch.algorithms import PageRank, SSSP
    from repro_torch.core import Fused, GraphSession
    from repro_torch.graph import chain_graph
    from repro_torch.stream import UpdateBatch, apply_to_csr

    csr = chain_graph(512)
    b = UpdateBatch.concat([UpdateBatch.inserts([5, 70], [400, 300]),
                            UpdateBatch.deletes([200], [201])])
    sess = GraphSession(csr, 32, capacity=2, seed=0, overlay_capacity=4)
    hs = [sess.submit(SSSP(source=0)), sess.submit(PageRank())]
    assert sess.run(Fused(), 20000).converged
    sess.apply_updates(b)
    assert all(int(g.overlay.mask.sum()) == 2 for g in sess.view_groups())
    fk.reset_launches()
    assert sess.run(Fused(), 20000).converged
    assert fk.launches["plus_times"] > 0 and fk.launches["min_plus"] > 0
    sess.compact()
    assert sess.run(Fused(), 20000).converged
    final = apply_to_csr(csr, b)
    fresh = GraphSession(final, 32, capacity=2, seed=0)
    fh = [fresh.submit(SSSP(source=0)), fresh.submit(PageRank())]
    assert fresh.run(Fused(), 20000).converged
    np.testing.assert_array_equal(sess.result(hs[0]), fresh.result(fh[0]))
    np.testing.assert_allclose(sess.result(hs[1]), fresh.result(fh[1]),
                               rtol=1e-4, atol=1e-6)
    for gs, gf in zip(sess.view_groups(), fresh.view_groups()):
        assert gs.overlay.capacity == 0
        for f in ("tiles", "nbr_ids", "nbr_mask"):
            assert torch.equal(getattr(gs.graph, f), getattr(gf.graph, f))
        ps, pf = sess._pair_data(gs), fresh._pair_data(gf)
        for f in ("src", "dst", "tiles", "run_start", "chunk_start",
                  "chunk_run"):
            assert torch.equal(getattr(ps, f), getattr(pf, f)), f


# --- telemetry and the serve front on the card ------------------------------


def test_fused_with_telemetry_on_the_card(cuda):
    """Fused() with telemetry through the kernels: the same schedule and
    bit-identical state as without it, the series sums equal the run
    totals, and one chunk with the series forces no host sync."""
    from repro_torch.core import Fused
    from repro_torch.core.policy import device_inputs
    csr = rmat_graph(400, 4, seed=13)
    ms, states = {}, {}
    for tel in (None, True):
        sess, _ = _device_session(None, csr, telemetry=tel)
        ms[tel] = sess.run(Fused(), 20000)
        states[tel] = [(g.values, g.deltas) for g in sess.view_groups()]
    m = ms[True]
    assert m.converged and len(m.telemetry) == m.supersteps
    for f in ("supersteps", "tile_loads", "tile_pair_loads", "host_syncs"):
        assert getattr(m, f) == getattr(ms[None], f), f
    for (v1, d1), (v0, d0) in zip(states[True], states[None]):
        assert torch.equal(v1, v0) and torch.equal(d1, d0)
    tel = m.telemetry
    assert int(tel.tile_loads.sum()) == m.tile_loads
    assert int(tel.job_block_pushes.sum()) == m.job_block_pushes
    assert int(tel.tile_pair_loads.sum()) == m.tile_pair_loads

    sess, _ = _device_session(None, csr, telemetry=True)
    step_fn = sess._device_step_fn(Fused())
    state, *args = device_inputs(sess)
    state, un = step_fn(state, *args, 1000, 5, 0)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, un = step_fn(state, *args, 1000, 5, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    it_h = int(state[0].item())
    rows = state[8][:, 1].cpu().numpy()                 # tile_loads
    assert it_h > 16 and (rows[:it_h] > 0).all() and (rows[it_h:] == 0).all()


def test_serve_harness_on_the_card_matches_the_cpu(cuda):
    """The open-loop harness (host TwoLevel, B1/B2 through the session)
    on the card admits and completes the same requests at the same ticks
    as the same harness on the CPU."""
    from repro_torch.core import GraphSession
    from repro_torch.obs import LoadgenConfig, OpenLoopHarness
    from repro_torch.serve import ConcurrentServeScheduler
    logs = {}
    for dev in ("cpu", None):
        csr = rmat_graph(192, 5, seed=9)
        sess = GraphSession(csr, 32, capacity=3, seed=3, device=dev)
        sched = ConcurrentServeScheduler(-(-csr.n // 32), batch_budget=3,
                                         seed=5)
        h = OpenLoopHarness(sess, sched, LoadgenConfig(
            seed=11, ticks=90, base_rate=0.25, n_tenants=30,
            update_every=30), max_running=3)
        fk.reset_launches()
        s = h.run()
        if dev is None:
            assert sess.use_pallas
            assert fk.launches["plus_times"] > 0
            assert fk.launches["min_plus"] > 0
        assert s["admitted"] == s["completed"] == s["arrivals"] > 0
        logs[dev] = (h.admission_log, h.completion_log)
    assert logs[None] == logs["cpu"]


# --- the multi-device engine: ranks sharing the card over gloo -------------


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    import test_torch_dist_ranks as ranks
    from repro_torch.dist.world import run_world
    return run_world(ranks.cuda_world, 2, device="cuda",
                     store_dir=str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("policy", ["Fused", "TwoLevel"])
def test_mesh_1x2_on_the_card_matches_one_device(cuda, mesh_world, policy):
    """A (1 x 2) blocks mesh of two ranks on the card against the card's
    one-device run: SSSP bit-equal, PageRank within rtol 1e-3, atol 1e-4;
    B1 and B2 launched on every rank."""
    import test_torch_dist_ranks as ranks
    import repro_torch.core as tc
    got = mesh_world["fused" if policy == "Fused" else "two_level"]
    sess, hs = ranks.build_core(device="cuda")
    m = sess.run(getattr(tc, policy)(), 20000)
    assert m.converged and got["metrics"]["converged"]
    want = [sess.result(h) for h in hs]
    for i in (2, 3):
        np.testing.assert_array_equal(got["results"][i], want[i])
    for i in (0, 1):
        np.testing.assert_allclose(got["results"][i], want[i], rtol=1e-3,
                                   atol=1e-4)
    assert got["metrics"]["halo_bytes"] > 0
    for per_rank in got["launches"]:
        assert per_rank["plus_times"] > 0 and per_rank["min_plus"] > 0


def test_mesh_closed_gate_keeps_the_chunk_carry(cuda, mesh_world):
    """A 2D device chunk whose last slots are gated: the carry equals,
    bit for bit, the same chunk with no gate passed to the kernels."""
    g = mesh_world["gate"]
    assert all(g["same"]) and g["gates"] == 16 and g["last_closed"]


@pytest.fixture(scope="module")
def mesh_stream_world(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU with "
                    "`python -m pytest -m cuda tests/test_torch_cuda.py`")
    import test_torch_dist_stream_ranks as ranks
    from repro_torch.dist.world import run_world
    return run_world(ranks.cuda_world, 2, device="cuda",
                     store_dir=str(tmp_path_factory.mktemp("mesh_stream")))


@pytest.mark.parametrize("tag", ["batch", "compacted"])
def test_mesh_stream_on_the_card(cuda, mesh_stream_world, tag):
    """A (1 x 2) mesh on the card takes a structural batch, then
    compact() and the jobs resubmitted: every rank's B1/B2 on its edited
    and its compacted pair shard match the plain version (checked in the
    rank), B1 and B2 run on every rank, and the runs equal the card's
    one-device run of the same sequence (SSSP bit-equal, PageRank/Katz within rtol 1e-3, atol
    1e-4)."""
    import test_torch_dist_stream_ranks as ranks
    import repro_torch.core as tc
    sess, hs = ranks.core_session(device="cuda")
    sess.run(tc.Fused(), 20000)
    sess.apply_updates(ranks.case_batch(sess._csr, "mutation"))
    m = sess.run(tc.Fused(), 20000)
    if tag == "compacted":
        ranks.compact_and_resubmit(sess, hs)
        m = sess.run(tc.TwoLevel(), 20000)
    got = mesh_stream_world[tag]
    assert m.converged and got["converged"]
    for per_rank in got["checked"]:
        assert len(per_rank) == 3 and all(p > 0 for p in per_rank.values())
    for per_rank in got["launches"]:
        assert per_rank["plus_times"] > 0 and per_rank["min_plus"] > 0
    for a, r, h in zip(ranks.core_algs(), got["results"], hs):
        if a.semiring == "min_plus":
            np.testing.assert_array_equal(r, sess.result(h))
        else:
            np.testing.assert_allclose(r, sess.result(h), rtol=1e-3,
                                       atol=1e-4)


# -- the LM serving path: the card against the CPU ----------------------------

def _lm_pair(name, dtype, device):
    """One seeded CPU init of the smoke config and its copy on `device`."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import LM
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype=dtype)
    cpu = LM(cfg, device="cpu", seed=0)
    gpu = LM(cfg, device="meta")
    gpu.load_state_dict({k: v.to(device) for k, v in
                         cpu.state_dict().items()}, assign=True)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(
        np.int32))
    return cfg, cpu, gpu, toks


def _lm_run(model, toks, s=20):
    out = []
    with torch.inference_mode():
        toks = toks.to(model.device)
        out.append(model.forward_train(toks)[0])
        cache = model.init_cache(toks.shape[0], 32)
        out.append(model.prefill(toks[:, :s], cache)[0])
        for j in range(toks.shape[1] - s):
            out.append(model.decode_step(toks[:, s + j:s + j + 1], cache)[0])
    return [o.float().cpu() for o in out], cache


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-9b"])
def test_lm_float32_card_matches_cpu(cuda, name):
    """float32 (TF32 off): forward_train, prefill and four decode steps,
    logits and the final cache at rtol = atol = 1e-4."""
    cfg, cpu, gpu, toks = _lm_pair(name, "float32", cuda)
    want, c_cpu = _lm_run(cpu, toks)
    got, c_gpu = _lm_run(gpu, toks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
    for lc, lg in zip(c_cpu["layers"], c_gpu["layers"]):
        for k in lc:
            np.testing.assert_allclose(lg[k].float().cpu().numpy(),
                                       lc[k].float().numpy(), rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-9b"])
def test_lm_bf16_card_matches_cpu(cuda, name):
    """bf16: every block on the card fed the CPU's own block input at the
    bf16 bar of 2e-2, and the whole model's logits at 2e-2 or, where the
    random smoke model amplifies last-bit differences past it, no further
    than the CPU's own logits move under a one-ulp change of one
    embedding weight."""
    from repro_torch.models import model as TM
    cfg, cpu, gpu, toks = _lm_pair(name, "bfloat16", cuda)
    with torch.inference_mode():
        x = cpu._embed(toks)
        pos = torch.arange(toks.shape[1], dtype=torch.int32).expand(2, -1)
        for bc, bg in zip(cpu.blocks, gpu.blocks):
            y = TM.apply_block(bc.kind, x, bc, cfg, None, pos, None)[0]
            yg = TM.apply_block(bg.kind, x.to(cuda), bg, cfg, None,
                                pos.to(cuda), None)[0]
            np.testing.assert_allclose(yg.float().cpu().numpy(),
                                       y.float().numpy(), rtol=2e-2,
                                       atol=2e-2)
            x = y
    want, _ = _lm_run(cpu, toks)
    got, _ = _lm_run(gpu, toks)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(bool(((g - w).abs() <= 2e-2 + 2e-2 * w.abs()).all())
               for g, w in zip(got, want)):
        row = cpu.embed.data
        tok = int(toks[0, 3])
        orig = row[tok, 5].clone()
        row[tok, 5] = (orig.view(torch.int16) + 1).view(torch.bfloat16)
        with torch.inference_mode():
            bumped = cpu.forward_train(toks)[0].float()
        row[tok, 5] = orig
        spread = float((bumped - want[0]).abs().max())
        assert err <= spread, (err, spread)


# -- LM training (phase 11's checks at smoke size) ------------------------------

def _train_pair(name, cuda):
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import LM
    cfg = dataclasses.replace(configs.get_smoke(name), param_dtype="float32")
    cpu = LM(cfg, device="cpu", seed=0)
    gpu = LM(cfg, device="meta")
    gpu.load_state_dict({k: v.to(cuda, copy=True) for k, v in
                         cpu.state_dict().items()}, assign=True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 20)).astype(np.int32))
    return cfg, cpu, gpu, {"tokens": toks}


def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = model.loss({k: v.to(model.device) for k, v in batch.items()})
    loss.backward()
    out = {n: p.grad.detach().float().cpu() for n, p in
           model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), out


@pytest.mark.parametrize("name", ["minicpm-2b", "xlstm-350m"])
def test_train_step_card_matches_cpu(cuda, name):
    """float32 (TF32 off), chip_smoke.py 11a's bars: the loss at 1e-5,
    each gradient leaf, and the step's accumulated gradient (in mu),
    within 1e-4 of its largest entry plus 1e-7 of the model's largest
    (about one float32 ulp of it: xLSTM's input-gate biases are rounding
    noise), and one make_train_step step (accum_steps=2) leaving each
    parameter within 1e-5 plus lr x the difference of the two sides'
    AdamW directions (mu/c1) / (sqrt(nu/c2) + eps): AdamW's first step
    moves a weight by lr x g/(|g| + eps), which gradients within their
    bar still move apart where |g| is near eps or of opposite sign."""
    from repro_torch.train import AdamWConfig, make_init_state, \
        make_train_step
    from repro_torch.tree import leaves, members
    cfg, cpu, gpu, batch = _train_pair(name, cuda)
    lc, gc_ = _grads(cpu, batch)
    lg, gg = _grads(gpu, batch)
    assert abs(lg - lc) <= 1e-5 + 1e-5 * abs(lc)

    def leaf_bars(tree):
        top = max(float(g.abs().max()) for g in tree.values())
        return {n: 1e-4 * float(g.abs().max()) + 1e-7 * top
                for n, g in tree.items()}
    for n, bar in leaf_bars(gc_).items():
        assert float((gg[n] - gc_[n]).abs().max()) <= bar, n
    opt = AdamWConfig(peak_lr=3e-4, warmup_steps=1, total_steps=10)
    mus, dirs, lrs = [], [], []
    for m in (cpu, gpu):
        step = make_train_step(m, opt, accum_steps=2)
        state, metrics = step(make_init_state(m, opt)(),
                              {k: v.to(m.device) for k, v in batch.items()})
        lrs.append(float(metrics["lr"]))
        names = {id(p): n for n, p in m.named_parameters()}
        mu_of, dir_of = {}, {}
        for lp, lm, ln in zip(leaves(state["params"]),
                              leaves(state["opt"]["mu"]),
                              leaves(state["opt"]["nu"])):
            for p, mu, nu in zip(members(lp), members(lm), members(ln)):
                mu, nu = mu.cpu(), nu.cpu()
                mu_of[names[id(p)]] = mu
                dir_of[names[id(p)]] = (mu / (1 - opt.b1)) / (
                    torch.sqrt(nu / (1 - opt.b2)) + opt.eps)
        mus.append(mu_of)
        dirs.append(dir_of)
    assert lrs[0] == lrs[1]
    lr = lrs[0]
    for n, bar in leaf_bars(mus[0]).items():
        assert float((mus[1][n] - mus[0][n]).abs().max()) <= bar, n
    for (n, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        want = pc.detach()
        d = (pg.detach().cpu() - want).abs()
        tol = 1e-5 * (1 + want.abs()) + lr * (dirs[1][n] - dirs[0][n]).abs()
        assert bool((d <= tol).all()), (n, float(d.max()))


RESTART_SCRIPT = r"""
import os, sys
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch
from repro_torch import configs
from repro_torch.launch import train as lt
from repro_torch.tree import leaves, members
torch.backends.cuda.matmul.allow_tf32 = False
torch.use_deterministic_algorithms(True)
cfg = configs.get_smoke("minicpm-2b")
def run(ckpt, fail):
    args = lt.build_parser().parse_args(
        ["--arch", "minicpm-2b", "--smoke", "--steps", "8", "--batch", "4",
         "--seq-len", "64", "--save-every", "4", "--ckpt-dir", ckpt,
         "--device", "cuda"])
    pending = {fail} if fail is not None else set()
    def hook(step):
        if step in pending:
            pending.remove(step)
            raise RuntimeError("injected")
    return lt.train(args, failure_hook=hook)
a = run(sys.argv[1] + "/a", 6)
b = run(sys.argv[1] + "/b", None)
assert a["restarts"] == 1 and b["restarts"] == 0, (a["restarts"], b["restarts"])
first = {}
replayed = 0
for s, loss in a["history"]:
    if s in first:
        assert loss == first[s], (s, loss, first[s])
        replayed += 1
    first[s] = loss
assert replayed == 2, a["history"]
assert first == dict(b["history"])
for la, lb in zip(leaves(a["state"]), leaves(b["state"])):
    for x, y in zip(members(la), members(lb)):
        assert (x == y) if isinstance(x, int) else torch.equal(x, y)
print("RESTART-OK")
"""


def test_train_restart_loop_on_the_card(cuda, tmp_path):
    """launch.train's loop at smoke size on the card, a failure injected at
    step 6 with checkpoints every 4 steps, under deterministic algorithms
    (in a subprocess: cuBLAS reads CUBLAS_WORKSPACE_CONFIG at its first
    use): one restart, the replayed losses bit-equal to their first pass,
    the final state equal to an uninterrupted run's."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", RESTART_SCRIPT,
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0 and "RESTART-OK" in res.stdout, \
        res.stderr[-3000:]


def test_fsdp_step_and_pipeline_on_the_card_match_the_cpu(cuda, tmp_path):
    """A (2, 1) gloo world of two ranks sharing the card: one FSDP-DP step
    of minicpm-2b's float32 smoke config held against the same world on
    CPU tensors (loss and grad norm at 1e-5; each moment mu at 1e-4 of its
    largest entry; each weight at 1e-5 plus lr x the difference of the two
    sides' AdamW directions, as tests/test_torch_cuda.py's one-device step
    test holds it), and a 2-stage pipeline of its blocks on the card
    against their sequential run at the reference's bars."""
    import torch_train_fsdp_ranks as ranks
    from repro_torch.dist.world import run_world
    from repro_torch.tree import leaves
    out = run_world(ranks.cuda_world, 2, device="cuda",
                    store_dir=str(tmp_path))
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(lg, lc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=1e-5)
    lr, b1, b2, eps = ranks.OPT["peak_lr"], 0.9, 0.95, 1e-8

    def direction(mu, nu):
        return (mu / (1 - b1)) / (np.sqrt(nu / (1 - b2)) + eps)
    for mc, mg in zip(leaves(sc["opt"]["mu"]), leaves(sg["opt"]["mu"])):
        assert np.abs(mg - mc).max() <= 1e-4 * np.abs(mc).max() + 1e-7
    for pc, pg, mc, nc, mg, ng in zip(
            leaves(sc["params"]), leaves(sg["params"]),
            leaves(sc["opt"]["mu"]), leaves(sc["opt"]["nu"]),
            leaves(sg["opt"]["mu"]), leaves(sg["opt"]["nu"])):
        spread = lr * np.abs(direction(mg, ng) - direction(mc, nc))
        assert (np.abs(pg - pc) <= 1e-5 * (1 + np.abs(pc)) + spread).all()
    p = out["pipeline"]
    assert abs(p["pipelined"] - p["sequential"]) < 1e-5
    for g, w in zip(p["grads"], p["want"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_tp_serving_on_the_card_matches_one_process(cuda, tmp_path):
    """A (1, 2) gloo world of two ranks sharing the card under the "tp"
    rules: qwen2.5-14b's float32 smoke config drawn on the card as each
    rank's slices of `LM(cfg, seed=0)`, prefill of 20 tokens and 2 decode
    steps, held at 1e-4 against `LM(cfg, seed=0)` in this process."""
    import dataclasses
    import torch_tp_ranks as ranks
    from repro_torch import configs
    from repro_torch.dist.world import run_world
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    from torch_multidev_ref import TP_S, tp_inputs
    out = run_world(ranks.cuda_world, 2, device="cuda",
                    store_dir=str(tmp_path))
    cfg = dataclasses.replace(configs.get_smoke("qwen2.5-14b"),
                              param_dtype="float32")
    engine = ServeEngine(LM(cfg, device="cuda", seed=0), max_len=32)
    t = torch.from_numpy(tp_inputs(cfg)[0]).cuda()
    cache = engine.new_cache(t.shape[0])
    want = [engine.prefill(t[:, :TP_S], cache)[0]]
    for j in range(2):
        want.append(engine.decode(t[:, TP_S + j:TP_S + j + 1], cache)[0])
    for got, w in zip(out["logits"], want):
        np.testing.assert_allclose(got, w.cpu().numpy(), rtol=1e-4,
                                   atol=1e-4)
    assert out["calls"] == 3 * (5 * cfg.n_layers + 2)


def test_tp_training_on_the_card_matches_one_process(cuda, tmp_path):
    """A (1, 2) gloo world of two ranks sharing the card under the "tp"
    train rules (phase 14a's smoke world): mixtral-8x7b (capacity factor
    1) and qwen2.5-14b at their float32 smoke configs from `LM(cfg,
    seed=0)`, TF32 off: the loss at 1e-4 and each gathered gradient leaf
    within 1e-4 of its largest entry, against one process on the card
    with the same weights and batch; one make_train_step step at accum
    2: its loss and grad norm at 1e-4, each first moment within 1e-4 of
    its largest entry."""
    import torch_tp_train_ranks as ranks
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.dist.world import run_world
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves
    out = run_world(ranks.cuda_world, 2, device="cuda",
                    store_dir=str(tmp_path))
    one = ShardingRules(make_host_mesh(device="cuda"), "tp")

    def scaled(got, want):
        for a, b in zip(leaves(got), leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max() + 1e-8
    for name, (loss, grads, (sl, sg, st)) in out.items():
        model = ranks.cuda_case(name)
        want_loss, want_grads = ranks.loss_grads(model, one, "cuda")
        wl, wg, wst = ranks.step(model, one, 2, "cuda")
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4, atol=1e-4)
        scaled(grads, want_grads)
        np.testing.assert_allclose(sl, wl, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(sg, wg, rtol=1e-4)
        assert st["opt"]["step"] == wst["opt"]["step"] == 1
        scaled(st["opt"]["mu"], wst["opt"]["mu"])


# --- views that hold their pair tiles alone, at the benchmark's scale 16 ----


def _g500_csr(scale=None):
    """The benchmark's Graph500 graph of `graphbench/configs/
    g500-s16-vb64.json` (or the same draw at `scale`) as the port's
    CSR."""
    import json
    import sys
    from pathlib import Path

    from repro_torch.graph import CSRGraph
    root = Path(__file__).resolve().parent.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from graphbench.graph import graph500
    cfg = json.loads(
        (root / "graphbench/configs/g500-s16-vb64.json").read_text())
    if scale is not None:
        cfg["scale"] = scale
    c = graph500(cfg, np.random.default_rng(cfg["graph_seed"]))
    return CSRGraph.from_edges(c.n, *c.edges())


def _tile_from_csr(csr, sb, db, vb, normalize):
    """Tile (sb, db) of the view, from the CSR's rows on the host."""
    fill = 0.0 if normalize else np.inf
    want = np.full((vb, vb), fill, np.float32)
    deg = np.maximum(csr.out_degree, 1).astype(np.float32)
    for u in range(vb):
        x = sb * vb + u
        if x >= csr.n:
            continue
        cols, w = csr.row(x)
        m = (cols >= db * vb) & (cols < db * vb + vb)
        want[u, cols[m] - db * vb] = w[m] / deg[x] if normalize else w[m]
    return want


def test_scale16_view_holds_pair_tiles_alone_past_2_31(cuda):
    """The benchmark's scale-16 views at Vb 64, built on the card, hold
    their pair tiles alone (past 2^31 floats; no ELL tensor, which would
    be 17 GB); pair tiles past element 2^31 hold the CSR's weights; one
    B1/B2 call over the whole view matches the plain version on 8
    sampled destination blocks whose pairs all lie past element 2^31,
    in both semirings."""
    from repro_torch.graph import build_view
    csr = _g500_csr()
    vb, j = 64, 16
    rng = np.random.default_rng(16)
    for semiring, fill, normalize in (("plus_times", 0.0, "out_degree"),
                                      ("min_plus", float("inf"), None)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        m0 = torch.cuda.memory_allocated()
        g, bp = build_view(csr, vb, fill=fill, normalize=normalize,
                           device=cuda)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - m0
        tile_bytes = bp.tiles.numel() * 4
        assert g.ell is None and g.ell_bytes == 0
        assert bp.tiles.numel() > 2 ** 31
        assert tile_bytes <= held < tile_bytes + 2 ** 28
        p0 = -(-2 ** 31 // (vb * vb))      # the first tile past 2^31
        rs = bp.run_start.cpu().numpy()
        dst, src = bp.dst.cpu().numpy(), bp.src.cpu().numpy()
        late = np.flatnonzero(rs[:-1] >= p0)
        runs = np.sort(rng.choice(late, size=8, replace=False))
        for r in runs[:3]:
            p = rs[r + 1] - 1
            np.testing.assert_array_equal(
                bp.tiles[p].cpu().numpy(),
                _tile_from_csr(csr, src[p], dst[p], vb, normalize))
        idx = torch.as_tensor(np.concatenate(
            [np.arange(rs[r], rs[r + 1]) for r in runs]), device=cuda)
        bn = g.num_blocks
        d, base, vals = _state(rng, j, bn, bn, vb, semiring, cuda)
        got = fk.fused_superstep_call(
            bp.src, bp.dst, bp.first, bp.last, d, base, bp.tiles,
            values=vals, run_start=bp.run_start,
            chunk_start=bp.chunk_start, chunk_run=bp.chunk_run,
            arrivals=bp.arrivals(), semiring=semiring)
        want = fused_superstep_ref(
            bp.src[idx], bp.dst[idx], bp.first[idx], bp.last[idx], d, base,
            bp.tiles[idx], values=vals, semiring=semiring)
        _compare(semiring, got, want, dst[rs[runs]])
        del g, bp, got, want


def test_fused_session_views_hold_the_bytes_the_counter_reports(cuda):
    """A Fused session on the card: its three views take their pair
    tiles as `view_bytes` reports them, their job state and a little
    metadata, and no ELL tiles; after a run to convergence still no
    view holds ELL tiles and no `view.ell` span was recorded."""
    from repro_torch.algorithms import (BFS, SSSP, PageRank,
                                        PersonalizedPageRank)
    from repro_torch.core import Fused, GraphSession
    from repro_torch.obs import TelemetryConfig
    csr = _g500_csr(scale=14)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_allocated()
    sess = GraphSession(csr, 64, capacity=16, seed=3,
                        telemetry=TelemetryConfig(capacity=0))
    keys = np.flatnonzero(csr.out_degree > 0)
    for a in (PageRank(), PersonalizedPageRank(source=int(keys[5])),
              SSSP(source=int(keys[9])), BFS(source=int(keys[9]))):
        sess.submit(a)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - m0
    vbytes = sess.view_bytes()
    groups = sess.view_groups()
    assert len(vbytes) == 3
    pair = sum(v["pair_bytes"] for v in vbytes)
    assert pair == sum(g.pairs.tiles.numel() * 4 for g in groups)
    state = sum((g.values.numel() + g.deltas.numel()
                 + g.push_scale.numel()) * 4 for g in groups)
    assert pair + state <= held < pair + state + 2 ** 26
    assert sess.run(Fused(), 50000).converged
    assert sess.view_bytes() == vbytes
    assert all(v["ell_bytes"] == 0 and v["ell_builds"] == 0
               for v in vbytes)
    assert "view.ell" not in sess.trace.totals()
