"""Parity of the port's device scheduler with the reference's.

* `do_select_device` fed the reference's own raw draw
  (`jax.random.gumbel(key, (B_N,))`) returns the reference's (sel, msk)
  exactly; with the port's own draw its selection frequencies track the
  host sampler's (tests/test_device_scheduler.py:52-68), and its
  degenerate cases match exactly (:71-88);
* `accumulate_priority`, `synthesize_topq` and `global_queue_device` are
  bit-identical to the reference on identical [J, q] inputs, ties
  included, and on every edge case of tests/test_device_scheduler.py
  :108-187;
* `TwoLevelScheduler(backend="device")` keeps the list interface,
  validation and `reset` (:189-216); its tensors live on its device,
  which `device=None` makes CUDA (raising without it).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as rc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
tds = importlib.import_module("repro_torch.core.do_select")


def _distinct_bucket_pairs(seed, b_n=64):
    """p_mean in distinct log-buckets (powers of two), so the scalar
    do_score is computed identically by both packages."""
    rng = np.random.default_rng(seed)
    node_un = rng.integers(0, 30, b_n).astype(np.float32)
    p_mean = np.where(node_un > 0, 2.0 ** rng.integers(-3, 9, b_n),
                      0.0).astype(np.float32)
    return node_un, p_mean


@pytest.mark.parametrize("q,s", [(6, 16), (20, 40), (3, 500), (80, 16)])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_do_select_device_identical_given_reference_draw(seed, q, s):
    node_un, p_mean = _distinct_bucket_pairs(seed)
    np.testing.assert_array_equal(
        tc.do_score(torch.as_tensor(node_un), torch.as_tensor(p_mean)
                    ).numpy(),
        np.asarray(rc.do_score(jnp.asarray(node_un), jnp.asarray(p_mean))))
    for k in range(5):
        key = jax.random.PRNGKey(100 * seed + k)
        r_sel, r_msk = map(np.asarray, rc.do_select_device(
            jnp.asarray(node_un), jnp.asarray(p_mean), q, key, s))
        noise = np.array(jax.random.gumbel(key, (len(node_un),)))
        t_sel, t_msk = (x.numpy() for x in tc.do_select_device(
            torch.as_tensor(node_un), torch.as_tensor(p_mean), q,
            torch.as_tensor(noise), s))
        assert t_sel.dtype == np.int32 and t_msk.dtype == np.float32
        np.testing.assert_array_equal(t_sel, r_sel)
        np.testing.assert_array_equal(t_msk, r_msk)


def test_do_select_device_batched_rows_equal_single_rows():
    """The port writes the reference's vmap out as a leading batch axis:
    each row of a batched call equals the single-job call."""
    rows = [_distinct_bucket_pairs(s) for s in range(4)]
    nu = torch.as_tensor(np.stack([r[0] for r in rows]))
    pm = torch.as_tensor(np.stack([r[1] for r in rows]))
    noise = tds.uniform_noise(torch.tensor(tds.seed_key(3)), 0,
                              tuple(nu.shape), "cpu")
    sel, msk = tc.do_select_device(nu, pm, 9, noise, 20)
    for i in range(4):
        s1, m1 = tc.do_select_device(nu[i], pm[i], 9, noise[i], 20)
        assert torch.equal(sel[i], s1) and torch.equal(msk[i], m1)


def test_device_sampler_matches_host_selection_frequencies():
    """tests/test_device_scheduler.py:52-68 with the port's own draw:
    >= 1k draws each, per-block marginal selection frequencies of the
    device sampler track the host sampler's."""
    rng = np.random.default_rng(3)
    b_n, q, s, draws = 64, 6, 16, 1200
    node_un = rng.integers(0, 30, b_n).astype(np.float64)
    p_mean = np.where(node_un > 0, 2.0 ** rng.integers(-3, 9, b_n),
                      0.0).astype(np.float64)
    freq_h = np.zeros(b_n)
    for i in range(draws):
        out = tc.do_select(node_un, p_mean, q,
                           np.random.default_rng(1000 + i), s)
        freq_h[out] += 1
    nu = torch.as_tensor(node_un, dtype=torch.float32).expand(draws, b_n)
    pm = torch.as_tensor(p_mean, dtype=torch.float32).expand(draws, b_n)
    noise = tds.uniform_noise(torch.tensor(tds.seed_key(0)), 0,
                              (draws, b_n), "cpu")
    sel, msk = (x.numpy() for x in tc.do_select_device(nu, pm, q, noise, s))
    freq_d = np.zeros(b_n)
    for i in range(draws):
        np.add.at(freq_d, sel[i][msk[i] > 0], 1)
    freq_h, freq_d = freq_h / draws, freq_d / draws
    assert np.abs(freq_h - freq_d).max() < 0.08
    assert abs(freq_h.sum() - freq_d.sum()) < 0.05 * max(freq_h.sum(), 1)
    np.testing.assert_array_equal(freq_h > 0.99, freq_d > 0.99)


def test_port_draw_is_uniform_and_keyed():
    """The counter-based draw: different keys, groups and jobs give
    different noise; the same counters give the same noise; its values
    spread uniformly over [0, 2^24)."""
    k = torch.tensor(tds.fold_in(tds.seed_key(5), 7))
    a = tds.uniform_noise(k, 0, (3, 4096), "cpu")
    assert torch.equal(a, tds.uniform_noise(k, 0, (3, 4096), "cpu"))
    assert not torch.equal(a, tds.uniform_noise(k, 1, (3, 4096), "cpu"))
    assert not torch.equal(a[0], a[1])
    k2 = torch.tensor(tds.fold_in(tds.seed_key(5), 8))
    assert not torch.equal(a, tds.uniform_noise(k2, 0, (3, 4096), "cpu"))
    u = a.numpy().ravel() / 2**24
    assert 0.0 <= u.min() and u.max() < 1.0
    hist = np.histogram(u, bins=8, range=(0, 1))[0] / u.size
    assert np.abs(hist - 1 / 8).max() < 0.02
    # a tensor counter and a python int counter give the same key
    assert tds.fold_in(tds.seed_key(5), torch.tensor(7)).item() == k.item()


def test_device_sampler_degenerate_cases_match_reference_exactly():
    key = jax.random.PRNGKey(0)
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, (10,))))
    sel, msk = tc.do_select_device(torch.zeros(10), torch.zeros(10), 3,
                                   noise)
    assert msk.sum() == 0
    node_un = np.zeros(20, np.float32)
    p_mean = np.zeros(20, np.float32)
    node_un[[3, 11, 17]] = [5.0, 2.0, 9.0]
    p_mean[[3, 11, 17]] = [1.0, 8.0, 64.0]
    noise = np.array(jax.random.gumbel(key, (20,)))
    r_sel, r_msk = map(np.asarray, rc.do_select_device(
        jnp.asarray(node_un), jnp.asarray(p_mean), 8, key))
    t_sel, t_msk = (x.numpy() for x in tc.do_select_device(
        torch.as_tensor(node_un), torch.as_tensor(p_mean), 8,
        torch.as_tensor(noise)))
    np.testing.assert_array_equal(t_sel, r_sel)
    np.testing.assert_array_equal(t_msk, r_msk)
    assert set(t_sel[t_msk > 0].tolist()) == {3, 11, 17}
    assert int(t_sel[0]) == 17
    # q beyond B_N pads to the fixed [q] layout
    t_sel, t_msk = tc.do_select_device(
        torch.as_tensor(node_un), torch.as_tensor(p_mean), 25,
        torch.as_tensor(noise))
    r_sel, r_msk = rc.do_select_device(
        jnp.asarray(node_un), jnp.asarray(p_mean), 25, key)
    np.testing.assert_array_equal(t_sel.numpy(), np.asarray(r_sel))
    np.testing.assert_array_equal(t_msk.numpy(), np.asarray(r_msk))


# --- Fig. 7: device synthesis, bit-identical to the reference ---------------


def _both_gq(sel, msk, num_blocks, q, alpha):
    r = rc.global_queue_device(jnp.asarray(sel), jnp.asarray(msk),
                               num_blocks, q, alpha)
    t = tc.global_queue_device(torch.as_tensor(sel), torch.as_tensor(msk),
                               num_blocks, q, alpha)
    return [np.asarray(x) for x in r], [x.numpy() for x in t]


def _pack(job_queues, q):
    j = max(1, len(job_queues))
    sel = np.zeros((j, q), np.int32)
    msk = np.zeros((j, q), np.float32)
    for i, jq in enumerate(job_queues):
        n = min(len(jq), q)
        sel[i, :n] = jq[:n]
        msk[i, :n] = 1.0
    return sel, msk


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("seed", range(6))
def test_global_queue_device_bit_identical_with_ties(seed, alpha):
    """Random [J, q] queues over few blocks: cumulative priorities tie
    all the time (sums of the integer weights q..1), so the top-k tie
    order decides the queue."""
    rng = np.random.default_rng(seed)
    for j, q, bn in ((5, 8, 12), (3, 20, 24), (8, 6, 40), (2, 30, 16)):
        sel = rng.integers(0, bn, (j, q)).astype(np.int32)
        msk = (rng.random((j, q)) < 0.7).astype(np.float32)
        (r_s, r_m), (t_s, t_m) = _both_gq(sel, msk, bn, q, alpha)
        assert t_s.dtype == np.int32 and t_m.dtype == np.float32
        np.testing.assert_array_equal(t_s, r_s)
        np.testing.assert_array_equal(t_m, r_m)


@pytest.mark.parametrize("seed", range(4))
def test_accumulate_priority_and_topq_bit_identical(seed):
    rng = np.random.default_rng(seed)
    bn, q = 30, 10
    pri_r, heads_r = jnp.zeros(bn, jnp.float32), jnp.zeros(bn, jnp.bool_)
    pri_t = torch.zeros(bn)
    heads_t = torch.zeros(bn, dtype=torch.bool)
    for _ in range(3):                   # one call per view group
        sel = rng.integers(0, bn, (4, q)).astype(np.int32)
        msk = (rng.random((4, q)) < 0.8).astype(np.float32)
        pri_r, heads_r = rc.accumulate_priority(
            pri_r, heads_r, jnp.asarray(sel), jnp.asarray(msk), q)
        pri_t, heads_t = tc.accumulate_priority(
            pri_t, heads_t, torch.as_tensor(sel), torch.as_tensor(msk), q)
        np.testing.assert_array_equal(pri_t.numpy(), np.asarray(pri_r))
        np.testing.assert_array_equal(heads_t.numpy(), np.asarray(heads_r))
    for k in (1, 7, 30, 45):
        r = rc.priority_topq(pri_r, k)
        t = tc.priority_topq(pri_t, k)
        for a, b in zip(t, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for alpha in (0.0, 0.3, 0.8, 1.0):
        r = rc.synthesize_topq(pri_r, heads_r, q, alpha)
        t = tc.synthesize_topq(pri_t, heads_t, q, alpha)
        for a, b in zip(t, r):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


EDGE_CASES = {   # tests/test_device_scheduler.py:108-187
    "reserved_heads": ([np.arange(1, 9), np.arange(1, 9), np.array([9])],
                       12, 8, 0.8),
    "many_heads": ([np.array([40 + j, 0, 1, 2, 3, 4, 5, 6, 7])
                    for j in range(16)], 64, 10, 0.8),
    "duplicate_heads": ([np.array([7, 1]), np.array([7, 2]),
                         np.array([7, 3])], 10, 4, 0.8),
    "alpha_one": ([np.array([1, 2, 3, 4]), np.array([1, 2, 3, 4]),
                   np.array([9])], 12, 4, 1.0),
    "alpha_zero": ([np.array([10 + j, 1, 2, 3]) for j in range(5)],
                   16, 2, 0.0),
    "short_queues": ([np.array([3]), np.array([5])], 8, 4, 1.0),
    "empty_queue": ([np.empty(0, np.int64)], 5, 3, 0.8),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_global_queue_device_edge_cases(case):
    queues, bn, q, alpha = EDGE_CASES[case]
    sel, msk = _pack(queues, q)
    (r_s, r_m), (t_s, t_m) = _both_gq(sel, msk, bn, q, alpha)
    np.testing.assert_array_equal(t_s, r_s)
    np.testing.assert_array_equal(t_m, r_m)
    dev = t_s[t_m > 0]
    host = tc.global_queue(queues, bn, q, alpha)
    assert len(set(dev.tolist())) == len(dev)         # no duplicates
    if case != "empty_queue":
        assert set(dev.tolist()) == set(host.tolist())
    if case == "many_heads":
        assert set(range(8)) <= set(dev.tolist())
        assert len([b for b in dev.tolist() if b >= 40]) == 2


# --- one scheduler core, pluggable backend ----------------------------------


def test_scheduler_backend_device_keeps_the_list_interface():
    node_un = np.zeros((2, 16))
    p_mean = np.zeros((2, 16))
    node_un[0, [1, 4]] = [3.0, 9.0]
    p_mean[0, [1, 4]] = [2.0, 16.0]
    node_un[1, [4, 9]] = [7.0, 2.0]
    p_mean[1, [4, 9]] = [16.0, 0.5]
    out = {}
    for pkg in (rc, tc):
        for backend in ("host", "device"):
            kw = {"device": "cpu"} if pkg is tc else {}
            sched = pkg.TwoLevelScheduler(16, 4, seed=0, backend=backend,
                                          **kw)
            queues, gq = sched.select(node_un, p_mean)
            assert len(queues) == 2
            assert all(len(set(jq.tolist())) == len(jq) for jq in queues)
            assert gq.dtype == np.int64
            out[pkg.__name__, backend] = gq.tolist()
    # no sampling here (the candidates fit), so the port's device queue
    # is the reference's, element for element
    assert out["repro_torch.core", "device"] == out["repro.core", "device"]
    assert {frozenset(v) for v in out.values()} == {frozenset({1, 4, 9})}


def test_scheduler_device_inactive_jobs_and_stream():
    """Inactive jobs get empty queues; each call advances the stream by
    one, and queues drawn at one stream position repeat after reset."""
    rng = np.random.default_rng(1)
    nu = rng.integers(0, 10, (3, 200)).astype(np.float32)
    pm = rng.random((3, 200)).astype(np.float32)
    sched = tc.TwoLevelScheduler(200, 20, seed=4, samples=30,
                                 backend="device", device="cpu")
    first = sched.job_queues(nu, pm, np.array([True, False, True]))
    assert len(first[1]) == 0 and len(first[0]) > 0
    assert sched._step == 1
    second = sched.job_queues(nu, pm)
    assert sched._step == 2
    assert any(not np.array_equal(a, b) for a, b in zip(first, second))
    sched.reset()
    assert sched._step == 0
    again = sched.job_queues(nu, pm, np.array([True, False, True]))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_scheduler_backend_validation_and_reset():
    with pytest.raises(ValueError):
        tc.TwoLevelScheduler(8, 2, backend="gpu")
    sched = tc.TwoLevelScheduler(8, 2, seed=3, backend="device",
                                 device="cpu")
    k0 = sched._next_key()
    assert sched._step == 1
    assert sched._next_key() != k0
    sched.reset()
    assert sched._step == 0 and sched._next_key() == k0
    sched.reset(9)
    assert sched.seed == 9 and sched._step == 0
    assert sched._next_key() != k0


def test_scheduler_device_backend_resolves_its_device(monkeypatch):
    """`device=None` is CUDA, as for a session: without a card the device
    backend raises and names the CPU escape; the host backend holds no
    device and constructs anywhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.TwoLevelScheduler(8, 2, backend="device")
    assert tc.TwoLevelScheduler(8, 2).device is None
    sched = tc.TwoLevelScheduler(8, 2, backend="device", device="cpu")
    assert sched.device.type == "cpu"


def test_scheduler_list_interface_draws_the_driver_stream():
    """At stream position p the list interface draws the key the device
    driver draws at superstep p, through the same group-0 queue function:
    the per-job queues and the global queue equal `TwoLevel`'s
    device_select there."""
    rng = np.random.default_rng(6)
    nu = rng.integers(0, 10, (3, 200)).astype(np.float32)
    pm = rng.random((3, 200)).astype(np.float32)
    sched = tc.TwoLevelScheduler(200, 20, seed=4, samples=30,
                                 backend="device", device="cpu")
    for p in range(3):
        queues, gq = sched.select(nu, pm)
        sel, msk = tds.group_queues_device(
            torch.as_tensor(nu), torch.as_tensor(pm),
            tds.step_key(4, torch.tensor(p)), 0, 20, 30)
        for jq, s_, m_ in zip(queues, sel.numpy(), msk.numpy()):
            np.testing.assert_array_equal(jq, s_[m_ > 0])
        selection = tc.TwoLevel(backend="device").device_select(
            [torch.as_tensor(nu)], [torch.as_tensor(pm)],
            [torch.ones(3, dtype=torch.bool)],
            tds.step_key(4, torch.tensor(p)),
            q=20, alpha=sched.alpha, samples=30, num_blocks=200)
        gmsk = selection.msk.numpy()
        np.testing.assert_array_equal(gq, selection.sel.numpy()[gmsk > 0])
