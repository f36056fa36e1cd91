"""CPU parity of the port's B3 (`mj_spmm`, `push_shared`) and B4
(`priority_pairs`) entry points with the reference's kernels.

The reference runs its Pallas kernels in interpret mode, as its own
tests do (tests/test_kernels.py).  Bars: min-plus bit-equal; plus-times
rtol = atol = 1e-5 for the product, values rtol 1e-6 and deltas rtol
1e-5, atol 1e-6 for the push (tests/test_kernels.py:107-109); node_un
exact and p_mean rtol 1e-6, atol 1e-7 (the lane sums add in another
order).  On the CPU the wrappers run their plain versions; the CUDA
kernels are held to these on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.mj_spmm.ops import mj_spmm as r_mj_spmm  # noqa: E402
from repro.kernels.mj_spmm.ops import push_shared as r_push  # noqa: E402
from repro.kernels.mj_spmm.ref import mj_spmm_ref as r_mj_ref  # noqa: E402
from repro.kernels.priority_pairs.ops import (  # noqa: E402
    priority_pairs as r_pairs)
from repro.kernels.priority_pairs.ref import (  # noqa: E402
    priority_pairs_ref as r_pairs_ref)
from repro_torch.core.push import shared_push_fn  # noqa: E402
from repro_torch.kernels.mj_spmm import (_pick_job_block, fold_min,  # noqa: E402
                                         mj_spmm, push_shared)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.mj_spmm import kernel as mk  # noqa: E402
from repro_torch.kernels.priority_pairs import priority_pairs  # noqa: E402
from repro_torch.kernels.priority_pairs import kernel as pk  # noqa: E402
from test_torch_cuda import _edge_priorities  # noqa: E402

SHAPES = [  # (q, K, J, Vb), tests/test_kernels.py:16-22
    (1, 1, 1, 8),
    (2, 3, 4, 16),
    (4, 2, 8, 32),
    (3, 5, 2, 64),
    (2, 2, 6, 128),
]


def _bf16_round(a):
    """Round float32 values through bfloat16 (as the reference's dtype
    sweep does), in numpy via the reference's own cast."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _mj_inputs(q, k, j, vb, semiring, rounded):
    rng = np.random.default_rng(q * 1000 + k * 100 + j * 10 + vb)
    d = rng.standard_normal((q, j, vb)).astype(np.float32)
    t = rng.standard_normal((q, k, vb, vb)).astype(np.float32)
    if semiring == "min_plus":
        mask = rng.random((q, k, vb, vb)) < 0.9
        t = np.where(mask, np.inf, np.abs(t)).astype(np.float32)
        d = np.abs(d)
        d[rng.random(d.shape) < 0.5] = np.inf
    if rounded:
        d, t = _bf16_round(d), _bf16_round(t)
    return d, t


@pytest.mark.parametrize("rounded", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("q,k,j,vb", SHAPES)
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_mj_spmm_matches_reference(semiring, q, k, j, vb, rounded):
    d, t = _mj_inputs(q, k, j, vb, semiring, rounded)
    ref_k = np.asarray(r_mj_spmm(jnp.asarray(d), jnp.asarray(t), semiring,
                                 interpret=True))
    ref_o = np.asarray(r_mj_ref(jnp.asarray(d), jnp.asarray(t), semiring))
    got = mj_spmm(torch.as_tensor(d), torch.as_tensor(t), semiring).numpy()
    assert got.shape == (q, k, j, vb) and got.dtype == np.float32
    for ref in (ref_k, ref_o):
        if semiring == "min_plus":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_mj_spmm_tile_index_reads_selected_rows(semiring):
    """tile_index reads tiles[idx[i]] from the whole array: the same
    function as the gathered form (bit-equal, the same arithmetic);
    out-of-range entries clamp, as the reference's gather does."""
    rng = np.random.default_rng(4)
    bn, k, j, vb, q = 9, 3, 4, 16, 5
    t = rng.standard_normal((bn, k, vb, vb)).astype(np.float32)
    if semiring == "min_plus":
        t = np.where(rng.random(t.shape) < 0.8, np.inf, np.abs(t))
    d = np.abs(rng.standard_normal((q, j, vb))).astype(np.float32)
    idx = np.array([3, 0, 8, 3, 12], np.int32)       # 12 clamps to 8
    got = mj_spmm(torch.as_tensor(d), torch.as_tensor(t), semiring,
                  tile_index=torch.as_tensor(idx)).numpy()
    gathered = np.array(jnp.asarray(t)[jnp.asarray(idx)])
    want = mj_spmm(torch.as_tensor(d), torch.as_tensor(gathered),
                   semiring).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(r_mj_ref(jnp.asarray(d), jnp.asarray(gathered),
                              semiring))
    if semiring == "min_plus":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_mj_spmm_min_plus_plain_version_chunks_over_q(monkeypatch):
    """The min-plus plain version walks q in chunks (its unchunked
    temporary would be [q, K, J, Vb, Vb]); chunking changes nothing."""
    from repro_torch.kernels.mj_spmm import ref as mref
    d, t = _mj_inputs(7, 3, 4, 16, "min_plus", False)
    whole = mj_spmm(torch.as_tensor(d), torch.as_tensor(t),
                    "min_plus").numpy()
    monkeypatch.setattr(mref, "MIN_PLUS_CHUNK_ELEMS", 3 * 4 * 16 * 16 * 2)
    chunked = mj_spmm(torch.as_tensor(d), torch.as_tensor(t),
                      "min_plus").numpy()
    np.testing.assert_array_equal(chunked, whole)


@pytest.mark.parametrize("j,bn,vb", [(1, 1, 8), (3, 7, 16), (8, 4, 64),
                                     (2, 16, 128)])
def test_priority_pairs_matches_reference(j, bn, vb):
    rng = np.random.default_rng(j * 100 + bn * 10 + vb)
    p = np.abs(rng.standard_normal((j, bn, vb))).astype(np.float32)
    p[rng.random(p.shape) < 0.5] = 0.0
    n_r, m_r = map(np.asarray, r_pairs(jnp.asarray(p), interpret=True))
    n_t, m_t = (x.numpy() for x in priority_pairs(torch.as_tensor(p)))
    assert n_t.dtype == m_t.dtype == np.float32
    np.testing.assert_array_equal(n_t, n_r)
    np.testing.assert_allclose(m_t, m_r, rtol=1e-6, atol=1e-7)


def test_priority_pairs_all_converged_block():
    n, m = priority_pairs(torch.zeros((2, 3, 16)))
    assert (n == 0).all() and (m == 0).all()
    n_r, m_r = r_pairs(jnp.zeros((2, 3, 16), jnp.float32), interpret=True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_r))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_r))


@pytest.mark.parametrize("vb", [1, 3, 64, 200])
def test_priority_pairs_edge_values_match_reference(vb):
    """NaN, -0.0 and -inf are not > 0 and are left out, +inf is counted:
    the plain version against the reference's kernel (interpret mode)
    and its oracle, node_un exact, p_mean at rtol 1e-6, NaN positions
    equal."""
    rng = np.random.default_rng(vb)
    p = _edge_priorities(rng, 3, 37, vb)
    n_t, m_t = (x.numpy() for x in priority_pairs(torch.as_tensor(p)))
    assert n_t[0, 0] == 0 and m_t[0, 0] == 0
    assert m_t[-1, -1] == np.inf
    for n_r, m_r in (r_pairs(jnp.asarray(p), interpret=True),
                     r_pairs_ref(jnp.asarray(p))):
        n_r, m_r = np.asarray(n_r), np.asarray(m_r)
        np.testing.assert_array_equal(n_t, n_r)
        np.testing.assert_array_equal(np.isnan(m_t), np.isnan(m_r))
        np.testing.assert_allclose(m_t, m_r, rtol=1e-6)


@pytest.mark.parametrize("vb,ptr,lanes", [
    (4, 0, 1), (8, 16, 2), (16, 32, 4), (40, 0, 16), (64, 4096, 16),
    (128, 0, 32), (200, 0, 32), (256, 16, 32),        # vector variant
    (1, 0, 0), (3, 0, 0), (6, 0, 0), (64, 4, 0), (64, 8, 0), (4, 12, 0)])
def test_priority_pairs_variant_choice(vb, ptr, lanes):
    """The vector variant (lanes per row: the next power of two >= Vb/4,
    at most 32) needs Vb % 4 == 0 and a 16-byte aligned input; anything
    else takes the scalar variant (0)."""
    assert pk.pick_variant(vb, ptr) == lanes


def _push_case(variant):
    """tests/test_kernels.py:86-119, plus a sentinel neighbour id == B_N
    (dropped) and a padded slot aliasing a selected block 0."""
    rng = np.random.default_rng(0)
    j, bn, vb, k = 3, 6, 16, 2
    tiles_p = np.where(rng.random((bn, k, vb, vb)) < 0.8, 0.0,
                       rng.random((bn, k, vb, vb))).astype(np.float32)
    tiles_m = np.where(tiles_p == 0.0, np.inf, tiles_p).astype(np.float32)
    nbr = rng.integers(0, bn, (bn, k)).astype(np.int32)
    sel = np.array([0, 2, 5], np.int32)
    msk = np.array([1.0, 1.0, 1.0], np.float32)
    if variant == "sentinel":
        nbr[2, 1] = bn
        nbr[5, 0] = bn
    elif variant == "padded":
        sel = np.array([0, 2, 5, 0], np.int32)
        msk = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    scale = rng.random(j).astype(np.float32)
    vals = rng.random((j, bn, vb)).astype(np.float32)
    dels = rng.random((j, bn, vb)).astype(np.float32)
    dist = (rng.random((j, bn, vb)) * 10).astype(np.float32)
    pend = np.where(rng.random((j, bn, vb)) < 0.5, dist, np.inf
                    ).astype(np.float32)
    return dict(tiles_p=tiles_p, tiles_m=tiles_m, nbr=nbr, sel=sel, msk=msk,
                scale=scale, plus=(vals, dels), mins=(dist, pend))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("variant", ["base", "sentinel", "padded"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_push_shared_matches_reference_and_ell_push(semiring, variant):
    c = _push_case(variant)
    tiles = c["tiles_p"] if semiring == "plus_times" else c["tiles_m"]
    v0, d0 = c["plus"] if semiring == "plus_times" else c["mins"]
    args = (tiles, c["nbr"], c["sel"], c["msk"], c["scale"])
    v_r, d_r = map(np.asarray, r_push(
        jnp.asarray(v0), jnp.asarray(d0), *map(jnp.asarray, args),
        semiring=semiring, interpret=True))
    v_t, d_t = (x.numpy() for x in push_shared(
        *_t(v0, d0, *args), semiring=semiring))
    ell = shared_push_fn(semiring, None, use_pallas=False)
    tv, td, tt, tn, ts, tm, tsc = _t(v0, d0, *args)
    v_e, d_e = (x.numpy() for x in ell(tv, td, tt, tn, ts, tm, tsc, None,
                                       None))
    for want_v, want_d in ((v_r, d_r), (v_e, d_e)):
        if semiring == "min_plus":
            np.testing.assert_array_equal(v_t, want_v)
            np.testing.assert_array_equal(d_t, want_d)
        else:
            np.testing.assert_allclose(v_t, want_v, rtol=1e-6)
            np.testing.assert_allclose(d_t, want_d, rtol=1e-5, atol=1e-6)


def _reference_scan_fold(values, deltas, contrib, nbr_sel):
    """The reference's min-plus bookkeeping (repro/kernels/mj_spmm/ops.py
    :83-97): a scan over K with one scatter-min per step."""
    def body(carry, inp):
        values, deltas = carry
        c_k, dst_k = inp
        c_k = jnp.swapaxes(c_k, 0, 1)
        old = values[:, dst_k, :]
        values = values.at[:, dst_k, :].min(c_k, mode="drop")
        new = values[:, dst_k, :]
        deltas = deltas.at[:, dst_k, :].min(
            jnp.where(new < old, new, jnp.inf), mode="drop")
        return (values, deltas), None

    (values, deltas), _ = jax.lax.scan(
        body, (jnp.asarray(values), jnp.asarray(deltas)),
        (jnp.swapaxes(jnp.asarray(contrib), 0, 1),
         jnp.swapaxes(jnp.asarray(nbr_sel), 0, 1)))
    return np.asarray(values), np.asarray(deltas)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_min_single_pass_bit_equal_to_reference_scan(seed):
    """Many slots hit one destination (only 4 blocks for q*K = 30
    slots), within a step and across steps, plus sentinel ids: the one
    scatter-min pass gives the scan's values and deltas bit for bit."""
    rng = np.random.default_rng(seed)
    j, bn, vb, q, k = 3, 4, 8, 6, 5
    values = (rng.random((j, bn, vb)) * 10).astype(np.float32)
    values[rng.random(values.shape) < 0.3] = np.inf
    deltas = np.where(rng.random(values.shape) < 0.5, values, np.inf
                      ).astype(np.float32)
    contrib = (rng.random((q, k, j, vb)) * 12).round(1).astype(np.float32)
    contrib[rng.random(contrib.shape) < 0.4] = np.inf
    nbr_sel = rng.integers(0, bn + 1, (q, k)).astype(np.int32)  # bn: drop
    v_r, d_r = _reference_scan_fold(values, deltas, contrib, nbr_sel)
    v_t, d_t = (x.numpy() for x in fold_min(*_t(values, deltas, contrib,
                                                nbr_sel)))
    np.testing.assert_array_equal(v_t, v_r)
    np.testing.assert_array_equal(d_t, d_r)


@pytest.mark.parametrize("j,vb,want", [
    (4, 64, 4), (7, 64, 7), (7, 128, 7), (13, 128, 1), (17, 64, 1),
    (16, 64, 16), (32, 64, 16), (24, 128, 8), (1, 8, 1), (4, 256, 4),
    (8, 256, 4), (4, 512, 2), (7, 512, 1)])
def test_pick_job_block(j, vb, want):
    """One thread per (job, lane) under 1024 threads, falling back
    through divisors of J: a prime J above the limit degrades to 1."""
    jb = _pick_job_block(j, vb)
    assert jb == want and j % jb == 0
    assert common.threads(jb, vb) <= 1024
    mk.check_shape(j, vb, jb)


@pytest.mark.parametrize("q,k,j,vb", [(2, 2, 4, 256), (1, 2, 3, 512),
                                       (3, 1, 2, 8)])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_mj_spmm_matches_reference_at_paper_widths(semiring, q, k, j, vb):
    """Vb 256 and 512 (tiles the CUDA kernel streams in slices) and 8,
    against the reference's interpreted Pallas kernel and its oracle.
    Plus-times takes non-negative operands here, as the main path's
    PageRank deltas and normalized tiles are: signed sums of 512 products
    cancel to near zero, and the fixed atol would then measure the two
    libraries' float32 summation orders, not the port."""
    d, t = _mj_inputs(q, k, j, vb, semiring, False)
    d, t = np.abs(d), np.abs(t)
    ref_k = np.asarray(r_mj_spmm(jnp.asarray(d), jnp.asarray(t), semiring,
                                 interpret=True))
    ref_o = np.asarray(r_mj_ref(jnp.asarray(d), jnp.asarray(t), semiring))
    got = mj_spmm(torch.as_tensor(d), torch.as_tensor(t), semiring).numpy()
    assert got.shape == (q, k, j, vb)
    for ref in (ref_k, ref_o):
        if semiring == "min_plus":
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_kernel_shape_checks():
    for vb in mk.SUPPORTED_VB:              # every power of two 8..512
        mk.check_shape(1, vb, 1)
    assert mk.SUPPORTED_VB == (8, 16, 32, 64, 128, 256, 512)
    with pytest.raises(ValueError, match="not 48"):
        mk.check_shape(4, 48, 4)            # Vb the kernel does not take
    with pytest.raises(ValueError):
        mk.check_shape(4, 64, 3)            # chunk must divide J
    with pytest.raises(ValueError):
        mk.check_shape(32, 64, 32)          # 2048 threads


def test_kernel_route_never_falls_back_to_plain(monkeypatch, tmp_path):
    """The dispatch rule without a card: when the inputs count as CUDA
    tensors the wrappers go to the kernel library (whose build needs
    nvcc, absent here, so they raise) and never to the plain versions."""
    from repro_torch.kernels.priority_pairs import kernel as pk

    def boom(*a, **kw):
        raise AssertionError("plain version reached on the kernel route")
    monkeypatch.setattr(common, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(mk, "mj_spmm_ref", boom)
    monkeypatch.setattr(pk, "priority_pairs_ref", boom)
    monkeypatch.setattr(common, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path)
    mk._lib.cache_clear()
    pk._lib.cache_clear()
    d = torch.zeros((2, 4, 16))
    t = torch.zeros((2, 3, 16, 16))
    with pytest.raises(RuntimeError, match="nvcc"):
        mj_spmm(d, t, "min_plus")
    with pytest.raises(RuntimeError, match="nvcc"):
        priority_pairs(torch.zeros((2, 5, 16)))
    assert mk.launches == {"plus_times": 0, "min_plus": 0}
    assert pk.launches == {"priority_pairs": 0}
