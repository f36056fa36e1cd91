"""Parity of the port's fused superstep (plain version, fused_push and the
push routes) with the reference's Pallas kernel and jnp oracle.

The same numpy-seeded inputs go through `repro`'s `fused_superstep_ref`
and `fused_superstep_call(..., interpret=True)` and through the port's
plain version (what the port runs on CPU tensors): min-plus bit-equal,
plus-times at rtol = atol = 1e-5 (tests/test_fused_superstep.py:83).
The CUDA kernels themselves are held against the plain version on the
card by tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.graph as rg  # noqa: E402
from repro.core.push import (push_min_one as r_push_min,  # noqa: E402
                             push_plus_one as r_push_plus,
                             shared_push_fn as r_shared)
from repro.kernels.fused_superstep.kernel import (  # noqa: E402
    fused_superstep_call as r_call)
from repro.kernels.fused_superstep.ops import fused_push as r_fused  # noqa: E402
from repro.kernels.fused_superstep.ref import (  # noqa: E402
    fused_superstep_ref as r_ref)

import repro_torch.graph as tg  # noqa: E402
from repro_torch.core import Fused  # noqa: E402
from repro_torch.core.push import (indep_push_fn, push_min_one,  # noqa: E402
                                   push_plus_one, shared_push_fn)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.fused_superstep import kernel as fk  # noqa: E402
from repro_torch.kernels.fused_superstep.ops import (  # noqa: E402
    fused_push, job_live)
from repro_torch.kernels.fused_superstep.ref import (  # noqa: E402
    fused_superstep_ref)


def T(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _graphs(semiring, n=150, deg=4, vb=16, seed=13):
    """(reference BlockedGraph, BlockPairs, port BlockedGraph, BlockPairs)
    on the graphs of tests/test_fused_superstep.py:39-46 (built once per
    process; no test writes to them)."""
    out = []
    for m, kw in ((rg, {}), (tg, {"device": "cpu"})):
        if semiring == "plus_times":
            csr = m.rmat_graph(n, deg, seed=seed)
            g = m.build_blocked(csr, vb, fill=0.0, normalize="out_degree",
                                **kw)
        else:
            csr = m.uniform_graph(n, deg, seed=seed, weighted=True,
                                  w_max=7.0)
            g = m.build_blocked(csr, vb, fill=float(np.inf), **kw)
        out += [g, m.build_block_pairs(g)]
    return out


def _rand_state(rng, j, bn_src, bn_loc, vb, semiring):
    if semiring == "plus_times":
        return (rng.standard_normal((j, bn_src, vb)).astype(np.float32),
                rng.standard_normal((j, bn_loc, vb)).astype(np.float32),
                None)
    d = (rng.random((j, bn_src, vb)) * 10).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    vals = (rng.random((j, bn_loc, vb)) * 10).astype(np.float32)
    base = np.where(rng.random(vals.shape) < 0.5, vals,
                    np.inf).astype(np.float32)
    return d, base, vals


def _check(semiring, got, want, rows):
    got = [N(x)[:, rows] for x in got]
    want = [N(x)[:, rows] for x in want]
    if semiring == "plus_times":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
    else:
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


# ---------------------------------------------------------------------------
# plain version vs the reference's oracle and interpreted Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["oracle", "interpret"])
@pytest.mark.parametrize("j", [1, 4, 6])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_plain_matches_reference(semiring, j, target):
    rg_g, rbp, _, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    d, base, vals = _rand_state(np.random.default_rng(j), j, bn, bn, vb,
                                semiring)
    jv = None if vals is None else jnp.asarray(vals)
    if target == "oracle":
        want = r_ref(rbp.src, rbp.dst, rbp.first, rbp.last, jnp.asarray(d),
                     jnp.asarray(base), rbp.tiles, values=jv,
                     semiring=semiring)
    else:
        want = r_call(rbp.src, rbp.dst, rbp.first, rbp.last, jnp.asarray(d),
                      jnp.asarray(base), rbp.tiles, values=jv,
                      semiring=semiring, interpret=True)
    got = fused_superstep_ref(tbp.src, tbp.dst, tbp.first, tbp.last, T(d),
                              T(base), tbp.tiles,
                              values=None if vals is None else T(vals),
                              semiring=semiring)
    _check(semiring, got, [np.asarray(x) for x in want],
           N(tbp.dst_touched))


@pytest.mark.parametrize("j", [1, 4])
@pytest.mark.parametrize("vb,n", [(8, 60), (256, 700), (512, 1400)])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_plain_matches_reference_at_paper_widths(semiring, vb, n, j):
    """The block widths outside the first slices' (Vb 8, 256 and the
    paper's 512), a few pairs each, against the interpreted Pallas kernel
    at the kernel oracle's bars."""
    rg_g, rbp, _, tbp = _graphs(semiring, n=n, vb=vb)
    bn = rg_g.num_blocks
    assert rg_g.block_size == vb and 0 < len(np.asarray(rbp.src)) <= 64
    d, base, vals = _rand_state(np.random.default_rng(vb + j), j, bn, bn, vb,
                                semiring)
    jv = None if vals is None else jnp.asarray(vals)
    want = r_call(rbp.src, rbp.dst, rbp.first, rbp.last, jnp.asarray(d),
                  jnp.asarray(base), rbp.tiles, values=jv,
                  semiring=semiring, interpret=True)
    got = fused_superstep_ref(tbp.src, tbp.dst, tbp.first, tbp.last, T(d),
                              T(base), tbp.tiles,
                              values=None if vals is None else T(vals),
                              semiring=semiring)
    _check(semiring, got, [np.asarray(x) for x in want],
           N(tbp.dst_touched))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_plain_width_contract_matches_reference(semiring):
    """d at the global source width B_N, base/values/outputs at a local
    width B_loc < B_N over the dst-sorted prefix of pairs with dst < B_loc
    (what a block shard passes), against the interpreted Pallas kernel."""
    rg_g, rbp, _, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    bn_loc = bn // 2
    k = int(np.searchsorted(np.asarray(rbp.dst), bn_loc))
    d, base, vals = _rand_state(np.random.default_rng(2), 3, bn, bn_loc, vb,
                                semiring)
    jv = None if vals is None else jnp.asarray(vals)
    want = r_call(rbp.src[:k], rbp.dst[:k], rbp.first[:k], rbp.last[:k],
                  jnp.asarray(d), jnp.asarray(base), rbp.tiles[:k],
                  values=jv, semiring=semiring, interpret=True)
    got = fused_superstep_ref(tbp.src[:k], tbp.dst[:k], tbp.first[:k],
                              tbp.last[:k], T(d), T(base), tbp.tiles[:k],
                              values=None if vals is None else T(vals),
                              semiring=semiring)
    _check(semiring, got, [np.asarray(x) for x in want],
           N(tbp.dst_touched)[:bn_loc])


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_plain_drops_out_of_range_destinations_like_reference(semiring):
    """Sentinel destination ids (>= B_loc) are dropped, as the reference
    oracle's mode="drop" scatters drop them."""
    rg_g, rbp, _, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    dst = np.asarray(rbp.dst).copy()
    dst[::5] = bn                              # sentinel destinations
    d, base, vals = _rand_state(np.random.default_rng(8), 2, bn, bn, vb,
                                semiring)
    jv = None if vals is None else jnp.asarray(vals)
    want = r_ref(rbp.src, jnp.asarray(dst), rbp.first, rbp.last,
                 jnp.asarray(d), jnp.asarray(base), rbp.tiles, values=jv,
                 semiring=semiring)
    got = fused_superstep_ref(tbp.src, T(dst), tbp.first, tbp.last, T(d),
                              T(base), tbp.tiles,
                              values=None if vals is None else T(vals),
                              semiring=semiring)
    _check(semiring, got, [np.asarray(x) for x in want],
           np.ones(bn, bool))


# ---------------------------------------------------------------------------
# fused_push and the push routes vs the reference's
# ---------------------------------------------------------------------------

def _push_state(rng, j, bn, vb, semiring):
    if semiring == "plus_times":
        return (rng.random((j, bn, vb)).astype(np.float32),
                rng.random((j, bn, vb)).astype(np.float32))
    vals = (rng.random((j, bn, vb)) * 10).astype(np.float32)
    dels = np.where(rng.random((j, bn, vb)) < 0.5, vals,
                    np.inf).astype(np.float32)
    return vals, dels


def _check_push(semiring, got, want):
    (v1, d1), (v2, d2) = [(N(a), N(b)) for a, b in (got, want)]
    if semiring == "min_plus":
        np.testing.assert_array_equal(v1, np.asarray(v2))
        np.testing.assert_array_equal(d1, np.asarray(d2))
    else:
        np.testing.assert_allclose(v1, np.asarray(v2), rtol=1e-6)
        np.testing.assert_allclose(d1, np.asarray(d2), rtol=1e-5, atol=1e-6)


SELECTIONS = {
    "plain": ([0, 2, 5, 7], [1, 1, 1, 1]),
    # a padded slot (mask 0) aliases block 0 while block 0 is selected:
    # it must not re-push block 0
    "padded_alias": ([0, 3, 0], [1, 1, 0]),
}


@pytest.mark.parametrize("sel_case", list(SELECTIONS))
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_fused_push_matches_reference(semiring, sel_case):
    rg_g, rbp, _, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    rng = np.random.default_rng(3)
    vals, dels = _push_state(rng, 4, bn, vb, semiring)
    sel, msk = SELECTIONS[sel_case]
    scales = rng.random(4).astype(np.float32)
    want = r_fused(jnp.asarray(vals), jnp.asarray(dels), rbp,
                   jnp.asarray(sel, jnp.int32), jnp.asarray(msk, jnp.float32),
                   jnp.asarray(scales), semiring=semiring, interpret=True,
                   with_pairs=True)
    got = fused_push(T(vals), T(dels), tbp, T(sel, torch.int32),
                     T(msk, torch.float32), T(scales), semiring=semiring,
                     with_pairs=True)
    _check_push(semiring, got[:2], want[:2])
    np.testing.assert_array_equal(N(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(N(got[3]), np.asarray(want[3]), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("route", ["pallas", "plain", "ell"])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_shared_push_fn_routes_match_reference(semiring, route):
    """All three routes of shared_push_fn (fused kernel, plain pair sweep /
    per-job ELL push, pairs=None ELL fallback) against the reference's
    same route on the same selection."""
    rg_g, rbp, tg_g, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    rng = np.random.default_rng(11)
    vals, dels = _push_state(rng, 3, bn, vb, semiring)
    sel, msk = [1, 4, 6, 0], [1, 1, 1, 0]
    scales = rng.random(3).astype(np.float32)
    use_pallas = route == "pallas"
    r_push = r_push_plus if semiring == "plus_times" else r_push_min
    t_push = push_plus_one if semiring == "plus_times" else push_min_one
    r_fn = r_shared(semiring, r_push, use_pallas)
    t_fn = shared_push_fn(semiring, t_push, use_pallas)
    want = r_fn(jnp.asarray(vals), jnp.asarray(dels), rg_g.tiles,
                rg_g.nbr_ids, jnp.asarray(sel, jnp.int32),
                jnp.asarray(msk, jnp.float32), jnp.asarray(scales),
                rg.empty_overlay(bn), None if route == "ell" else rbp)
    got = t_fn(T(vals), T(dels), tg_g.tiles, tg_g.nbr_ids,
               T(sel, torch.int32), T(msk, torch.float32), T(scales),
               tg.empty_overlay(bn, device="cpu"),
               None if route == "ell" else tbp)
    _check_push(semiring, got, want)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_indep_push_matches_reference(semiring):
    from repro.core.push import indep_push_fn as r_indep
    rg_g, _, tg_g, _ = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    rng = np.random.default_rng(12)
    vals, dels = _push_state(rng, 2, bn, vb, semiring)
    sel = np.array([[0, 2, 5], [7, 1, 0]], np.int32)
    msk = np.array([[1, 1, 1], [1, 1, 0]], np.float32)
    scales = rng.random(2).astype(np.float32)
    r_push = r_push_plus if semiring == "plus_times" else r_push_min
    t_push = push_plus_one if semiring == "plus_times" else push_min_one
    want = r_indep(r_push)(jnp.asarray(vals), jnp.asarray(dels), rg_g.tiles,
                           rg_g.nbr_ids, jnp.asarray(sel), jnp.asarray(msk),
                           jnp.asarray(scales), rg.empty_overlay(bn))
    got = indep_push_fn(t_push)(T(vals), T(dels), tg_g.tiles, tg_g.nbr_ids,
                                T(sel), T(msk), T(scales),
                                tg.empty_overlay(bn, device="cpu"))
    _check_push(semiring, got, want)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_push_one_drops_sentinel_neighbors_like_reference(semiring):
    """Out-of-range neighbour ids (sentinel B_N) are DROPPED by the port's
    ELL push exactly as by the reference's mode="drop" scatter — min-plus
    bitwise."""
    rng = np.random.default_rng(4)
    J, BN, VB, K = 3, 6, 16, 3
    tiles = np.where(rng.random((BN, K, VB, VB)) < 0.7, 0.0,
                     rng.random((BN, K, VB, VB))).astype(np.float32)
    nbr = rng.integers(0, BN, (BN, K)).astype(np.int32)
    nbr[:, -1] = BN                 # sentinel slot: out of range -> dropped
    if semiring == "min_plus":
        tiles = np.where(tiles == 0.0, np.inf, tiles).astype(np.float32)
    sel, msk = np.array([0, 2, 4], np.int32), np.ones(3, np.float32)
    vals, dels = _push_state(rng, J, BN, VB, semiring)
    scale = rng.random(J).astype(np.float32)
    r_push = r_push_plus if semiring == "plus_times" else r_push_min
    t_push = push_plus_one if semiring == "plus_times" else push_min_one
    want = jax.vmap(r_push, in_axes=(0, 0, None, None, None, None, 0))(
        jnp.asarray(vals), jnp.asarray(dels), jnp.asarray(tiles),
        jnp.asarray(nbr), jnp.asarray(sel), jnp.asarray(msk),
        jnp.asarray(scale))
    outs = [t_push(T(vals[j]), T(dels[j]), T(tiles), T(nbr), T(sel), T(msk),
                   float(scale[j])) for j in range(J)]
    got = (torch.stack([v for v, _ in outs]), torch.stack([d for _, d in outs]))
    _check_push(semiring, got, want)


# ---------------------------------------------------------------------------
# job chunks, edgeless graphs, dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_prime_job_count_degrades_chunk(monkeypatch, semiring):
    """J=13 (prime): the layout needs no divisor of J (a pass holds every
    job, one (job, lane) a thread at Vb=16, and at Vb=128 two groups of 8
    jobs a thread), it fits the thread and shared memory budgets, and the
    push still matches the reference."""
    vb = 16
    assert fk.layout(13, vb) == fk.Layout(1, 13, fk.stages(vb))
    assert fk.layout(13, 128) == fk.Layout(8, 2, 2)
    for v in (vb, 128):
        fk.check_shape(13, v)
    rg_g, rbp, _, tbp = _graphs(semiring, vb=vb)
    bn = rg_g.num_blocks
    rng = np.random.default_rng(9)
    vals, dels = _push_state(rng, 13, bn, vb, semiring)
    sel, msk = [0, 2, 5], [1.0, 1.0, 1.0]
    scales = np.ones(13, np.float32)
    want = r_fused(jnp.asarray(vals), jnp.asarray(dels), rbp,
                   jnp.asarray(sel, jnp.int32), jnp.asarray(msk),
                   jnp.asarray(scales), semiring=semiring, interpret=True)
    got = fused_push(T(vals), T(dels), tbp, T(sel, torch.int32),
                     T(msk, torch.float32), T(scales), semiring=semiring)
    _check_push(semiring, got, want)


@pytest.mark.parametrize("j,vb,jb", [(4, 64, 4), (6, 16, 6), (13, 128, 16),
                                     (16, 128, 16), (64, 16, 64),
                                     (100, 16, 104), (4, 8, 4), (64, 8, 64),
                                     (4, 256, 4), (8, 256, 12), (4, 512, 12),
                                     (2, 512, 2), (7, 512, 12)])
def test_pick_job_block_fits_threads_and_smem(j, vb, jb):
    """The layout table: one (job, lane) a thread where J x Vb fits 1024
    threads, else JW jobs a thread in as many groups of Vb threads as the
    jobs fill; `jb` is the jobs one pass holds.  Every layout fits the
    thread and shared memory budgets."""
    lay = fk.layout(j, vb)
    assert lay.pass_jobs == jb
    assert lay.jr == (1 if j * vb <= common.MAX_THREADS else fk.wide_jobs(vb))
    assert common.threads(lay.groups, vb) <= common.MAX_THREADS
    assert fk.smem_bytes(vb, j, lay) <= common.SMEM_BUDGET
    assert lay.passes(j) == -(-j // jb) and lay.passes(0) == 0
    fk.check_shape(j, vb)                        # raises if it would not fit


def test_kernel_shape_checks_raise():
    """A Vb that is not a power of two from 8 to 512 (ROADMAP C), no job,
    more job ids than shared memory holds."""
    for j, vb in [(4, 48), (4, 24), (4, 1024), (0, 64), (60000, 64)]:
        with pytest.raises(ValueError):
            fk.check_shape(j, vb)
    with pytest.raises(ValueError, match=r"takes Vb in \(8, 16, 32, 64, "
                       r"128, 256, 512\), not 48"):
        fk.check_shape(4, 48)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_edgeless_pad_pair_is_inert(semiring):
    fill = 0.0 if semiring == "plus_times" else float(np.inf)
    g = tg.build_blocked(tg.CSRGraph.from_edges(40, [], []), 16, fill=fill,
                         device="cpu")
    bp = tg.build_block_pairs(g)
    rng = np.random.default_rng(0)
    vals, dels = _push_state(rng, 2, g.num_blocks, 16, semiring)
    v, d = fused_push(T(vals), T(dels), bp, torch.zeros(1, dtype=torch.int32),
                      torch.zeros(1), torch.ones(2), semiring=semiring)
    np.testing.assert_array_equal(N(d), dels)
    np.testing.assert_array_equal(N(v), vals)


def test_dispatch_rule_cpu_runs_plain_and_counts_no_launch(monkeypatch):
    """CPU tensors go to the plain version and are not counted as kernel
    launches; mixed devices raise.  (The CUDA half of the rule is
    tests/test_torch_cuda.py::test_cuda_tensor_never_reaches_plain_version.)"""
    _, _, _, tbp = _graphs("plus_times")
    seen = []
    monkeypatch.setattr(fk, "fused_superstep_ref",
                        lambda *a, **k: seen.append(k) or ("plain",))
    before = dict(fk.launches)
    d = torch.zeros((1, tbp.num_blocks, 16))
    assert fk.fused_superstep_call(tbp.src, tbp.dst, tbp.first, tbp.last, d,
                                   d, tbp.tiles) == ("plain",)
    assert len(seen) == 1 and fk.launches == before
    assert common.on_cuda(d) is False
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError):
        common.on_cuda(d, meta)


def test_resolve_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        common.resolve_device(None)
    assert common.resolve_device("cpu").type == "cpu"


# ---------------------------------------------------------------------------
# the CUDA kernels' work items, live-source mask and gate (CPU side)
# ---------------------------------------------------------------------------

def _check_chunk_table(run_start, chunk, cs, cr, kept):
    """Every kept run is covered exactly once, in order, by consecutive
    chunks of at most `chunk` pairs; nothing else is covered."""
    rs = np.asarray(run_start)
    assert len(cs) == len(cr) + 1
    assert list(np.unique(cr)) == list(kept)
    assert np.all(np.diff(cr) >= 0)                  # runs in order
    for r in kept:
        idx = np.flatnonzero(cr == r)
        assert np.all(np.diff(idx) == 1)             # consecutive chunks
        starts, ends = cs[idx], cs[idx + 1]
        assert starts[0] == rs[r] and ends[-1] == rs[r + 1]
        assert np.all(starts[1:] == ends[:-1])       # no gap, no overlap
        assert np.all(ends > starts)
        if chunk is not None:
            assert np.all(ends - starts <= chunk)
        else:
            assert len(idx) == 1


@pytest.mark.parametrize("lens", [[2, 14, 1, 5, 3], [4, 12, 8, 1, 13]],
                         ids=["uneven", "multiples_of_4"])
@pytest.mark.parametrize("chunk", [1, 3, 4, None])
def test_chunk_table_covers_every_run_once_in_order(chunk, lens):
    """Synthetic runs, one of them longer than 3*C for C <= 4, and runs
    whose length is a multiple of C (no short last chunk)."""
    lens = np.array(lens)
    run_start = np.concatenate([[0], np.cumsum(lens)])
    cs, cr = tg.chunk_table(run_start, chunk)
    assert cs.dtype == cr.dtype == np.int32
    _check_chunk_table(run_start, chunk, cs, cr, range(len(lens)))
    if chunk is not None:
        assert lens.max() > 3 * chunk
        long_run = int(lens.argmax())
        assert int((cr == long_run).sum()) == -(-lens.max() // chunk)
        assert len(cr) == int(np.sum(-(-lens // chunk)))


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_block_pairs_carry_the_chunk_table(semiring):
    """build_block_pairs stores the table of its runs at PAIR_CHUNK, and
    the derivation from run_start in the kernel wrapper agrees."""
    from repro_torch.graph.structure import PAIR_CHUNK
    _, _, _, tbp = _graphs(semiring)
    rs = N(tbp.run_start)
    cs, cr = tg.chunk_table(rs, PAIR_CHUNK)
    np.testing.assert_array_equal(N(tbp.chunk_start), cs)
    np.testing.assert_array_equal(N(tbp.chunk_run), cr)
    _check_chunk_table(rs, PAIR_CHUNK, cs, cr, range(tbp.num_runs))
    dcs, dcr = fk._chunks(tbp.run_start)
    np.testing.assert_array_equal(N(dcs), cs)
    np.testing.assert_array_equal(N(dcr), cr)
    counters = tbp.arrivals()
    assert counters.shape == (tbp.num_runs,) and not counters.any()
    assert tbp.arrivals() is counters


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_src_live_on_masked_d_matches_reference(semiring, frac):
    """fused_superstep_call with `src_live` on identity-masked d equals
    the call without it and the reference's Pallas kernel in interpret
    mode (which has no such argument)."""
    rg_g, rbp, _, tbp = _graphs(semiring)
    bn, vb = rg_g.num_blocks, rg_g.block_size
    rng = np.random.default_rng(int(10 * frac) + 40)
    d, base, vals = _rand_state(rng, 4, bn, bn, vb, semiring)
    live = rng.random(bn) < frac
    d = np.where(live[None, :, None], d,
                 0.0 if semiring == "plus_times" else np.inf
                 ).astype(np.float32)
    jv = None if vals is None else jnp.asarray(vals)
    want = r_call(rbp.src, rbp.dst, rbp.first, rbp.last, jnp.asarray(d),
                  jnp.asarray(base), rbp.tiles, values=jv, semiring=semiring,
                  interpret=True)
    kw = dict(values=None if vals is None else T(vals), semiring=semiring)
    args = (tbp.src, tbp.dst, tbp.first, tbp.last, T(d), T(base), tbp.tiles)
    got = fk.fused_superstep_call(*args, src_live=T(live), **kw)
    rows = N(tbp.dst_touched)
    _check(semiring, got, [np.asarray(x) for x in want], rows)
    _check(semiring, got, fk.fused_superstep_call(*args, **kw), rows)


@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_fused_push_passes_selection_as_src_live(monkeypatch, semiring):
    """fused_push hands the kernel its selection mask `selb` as
    `src_live`, the view's chunk table and counters, and the gate."""
    from repro_torch.kernels.fused_superstep import ops
    _, _, _, tbp = _graphs(semiring)
    bn = tbp.num_blocks
    real = ops.fused_superstep_call
    seen = []

    a_seen = []

    def spy(*a, **kw):
        seen.append(kw)
        a_seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "fused_superstep_call", spy)
    rng = np.random.default_rng(5)
    vals, dels = _push_state(rng, 4, bn, 16, semiring)
    sel, msk = [0, 3, 0, 6], [1, 1, 0, 1]
    gate = torch.tensor(True)
    fused_push(T(vals), T(dels), tbp, T(sel, torch.int32),
               T(msk, torch.float32), torch.ones(4), semiring=semiring,
               gate=gate)
    (kw,) = seen
    want = np.zeros(bn, bool)
    want[[0, 3, 6]] = True
    assert kw["src_live"].dtype == torch.bool
    np.testing.assert_array_equal(N(kw["src_live"]), want)
    assert kw["gate"] is gate
    assert kw["chunk_start"] is tbp.chunk_start
    assert kw["chunk_run"] is tbp.chunk_run
    assert kw["arrivals"] is tbp.arrivals()
    # the jobs with a live row of the operand the kernel gets
    d_op = a_seen[0][4]
    np.testing.assert_array_equal(N(kw["job_live"]),
                                  N(job_live(d_op, semiring)))


def _kernel_route_session(csr):
    """A CPU session on the kernel route (use_pallas=True: fused_push and
    the plain version) with a plus-times and a min-plus job."""
    from repro_torch.algorithms import SSSP, PageRank
    from repro_torch.core import GraphSession
    sess = GraphSession(csr, 16, capacity=2, seed=5, device="cpu",
                        use_pallas=True)
    sess.submit(PageRank())
    sess.submit(SSSP(source=3))
    return sess


def test_device_run_with_gate_equals_run_without(monkeypatch):
    """A CPU device-backend run with the gate plumbed through to the
    kernel wrapper equals, bit for bit, the run in which the wrapper gets
    no gate: same values, deltas, supersteps and counters.  Every push
    gets a 0-dim bool gate, closed on the gated slots."""
    from repro_torch.kernels.fused_superstep import ops
    real = ops.fused_superstep_call
    gates = []

    def record(*a, **kw):
        gates.append(kw["gate"])
        return real(*a, **kw)

    def strip(*a, gate=None, **kw):
        return real(*a, **kw)

    csr = tg.rmat_graph(300, 4, seed=13)
    out = []
    for fn in (record, strip):
        monkeypatch.setattr(ops, "fused_superstep_call", fn)
        sess = _kernel_route_session(csr)
        m = sess.run(Fused(steps_per_sync=4), 20000)
        assert m.converged
        out.append((m, [(g.values.clone(), g.deltas.clone())
                        for g in sess.view_groups()]))
    (m1, s1), (m2, s2) = out
    assert m1.to_dict() | {"wall_time_s": 0} == m2.to_dict() | {
        "wall_time_s": 0}
    np.testing.assert_array_equal(m1.iterations_per_job,
                                  m2.iterations_per_job)
    for (v1, d1), (v2, d2) in zip(s1, s2):
        assert torch.equal(v1, v2) and torch.equal(d1, d2)
    assert gates and all(g.shape == () and g.dtype == torch.bool
                         for g in gates)
    assert not all(bool(g) for g in gates)      # some slots were gated


# ---------------------------------------------------------------------------
# live jobs: skipped exactly, and counted
# ---------------------------------------------------------------------------

#: (vb, vertices) of the live-job cases: a handful of blocks at each width
LIVE_GRAPHS = {8: 60, 64: 400, 512: 1400}


def _live_flags(pattern, j, semiring):
    """[J] bool of the jobs given a live row, by pattern."""
    idx = np.arange(j)
    if pattern == "all":
        return np.ones(j, bool)
    if pattern == "lowest":
        return idx < max(1, (2 * j) // 5)
    if pattern == "scattered":
        return idx % 3 == 1
    if pattern == "none":
        return np.zeros(j, bool)
    # "converged": job 0 has no live row (a min-plus job that converged
    # inside a poll: pend all inf, its values and base finite)
    return idx != 0


@pytest.mark.parametrize("flags", ["plain", "masked", "gated"])
@pytest.mark.parametrize("pattern", ["all", "lowest", "scattered", "none",
                                     "converged"])
@pytest.mark.parametrize("j", [1, 4, 7, 38, 48])
@pytest.mark.parametrize("vb", sorted(LIVE_GRAPHS))
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus"])
def test_job_live_skips_exactly_and_counts(semiring, vb, j, pattern, flags):
    """fused_superstep_call with `job_live` on d whose dead jobs' rows are
    the semiring identity equals the full computation (job_live None):
    every output and flush row, min-plus bit for bit and plus-times up to
    the sign of a zero; live jobs bit for bit.  `b1b2_counts` adds the
    live pairs (live source, destination in range) x the layout's passes
    of the live jobs, and the jobs without a live row; a closed gate adds
    nothing."""
    _, _, _, tbp = _graphs(semiring, n=LIVE_GRAPHS[vb], vb=vb)
    bn = tbp.num_blocks
    ident = 0.0 if semiring == "plus_times" else np.inf
    rng = np.random.default_rng(vb * 100 + j)
    d, base, vals = _rand_state(rng, j, bn, bn, vb, semiring)
    alive = _live_flags(pattern, j, semiring)
    d = np.where(alive[:, None, None], d, ident).astype(np.float32)
    src_live = None
    if flags != "plain":
        src_live = rng.random(bn) < 0.6
        d = np.where(src_live[None, :, None], d, ident).astype(np.float32)
    gate = None if flags != "gated" else torch.tensor(False)
    kw = dict(values=None if vals is None else T(vals), semiring=semiring,
              src_live=None if src_live is None else T(src_live))
    args = (tbp.src, tbp.dst, tbp.first, tbp.last, T(d), T(base), tbp.tiles)
    counts = fk.b1b2_counts("cpu")
    before = counts.clone()
    got = fk.fused_superstep_call(*args, job_live=T(alive), gate=gate, **kw)
    added = (counts - before).tolist()
    full = fk.fused_superstep_call(*args, **kw)
    rows = N(tbp.dst_touched)
    for a, b in zip(got, full):
        a, b = N(a)[:, rows], N(b)[:, rows]
        np.testing.assert_array_equal(a[alive], b[alive])
        # dead jobs: +0.0 folds a -0.0 to +0.0 (the sign of a zero)
        np.testing.assert_array_equal(a[~alive] + 0.0, b[~alive] + 0.0)
    np.testing.assert_array_equal(N(job_live(T(d), semiring)),
                                  alive & (src_live is None
                                           or src_live.any()))
    if flags == "gated":
        assert added == [0, 0]
        return
    src = N(tbp.src)
    live_pairs = int(np.sum(src_live[src])) if src_live is not None \
        else len(src)
    n_live = int(alive.sum())
    assert added == [live_pairs * fk.layout(j, vb).passes(n_live),
                     j - n_live]


@pytest.mark.parametrize("policy", ["two_level", "fused"])
def test_run_metrics_count_b1b2_work(monkeypatch, policy):
    """RunMetrics.b1b2_stagings / b1b2_jobs_skipped of a kernel-route run
    equal the sums, over the run's open calls, of the live pairs x passes
    and the jobs without a live row, read from each call's own flags;
    they stay out of to_dict.  A second run starts from zero."""
    from repro_torch.core import TwoLevel
    from repro_torch.kernels.fused_superstep import ops
    real = ops.fused_superstep_call
    want = np.zeros(2, np.int64)

    def spy(src, dst, first, last, d, base, tiles, **kw):
        gate = kw.get("gate")
        if gate is None or bool(gate):
            want[:] += N(fk.expected_counts(
                src, dst, kw["src_live"], kw["job_live"], d.shape[0],
                d.shape[2], d.shape[1], base.shape[1]))
        return real(src, dst, first, last, d, base, tiles, **kw)

    monkeypatch.setattr(ops, "fused_superstep_call", spy)
    sess = _kernel_route_session(tg.rmat_graph(300, 4, seed=13))
    pol = TwoLevel() if policy == "two_level" else Fused(steps_per_sync=4)
    for _ in range(2):
        want[:] = 0
        m = sess.run(pol, 40)
        assert m.supersteps > 0 and want[0] > 0
        assert (m.b1b2_stagings, m.b1b2_jobs_skipped) == tuple(want)
        assert "b1b2_stagings" not in m.to_dict()
