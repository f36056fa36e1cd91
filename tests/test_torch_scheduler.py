"""Parity of the port's scheduling core with repro's host backend.

* `block_pairs`: node_un is exact; p_mean is NOT bit-equal (torch and XLA
  sum the Vb lanes in different orders, a few ulp apart) and is held at
  rtol 1e-6.
* `do_select`, `global_queue` and `TwoLevelScheduler.select` give
  IDENTICAL queues from identical numpy inputs and an identically seeded
  `np.random.default_rng` stream, over several seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.algorithms as ra  # noqa: E402
import repro.core as rc  # noqa: E402
import repro_torch.algorithms as ta  # noqa: E402
import repro_torch.core as tc  # noqa: E402


def _pairs_input(seed, j=3, bn=40, vb=64):
    rng = np.random.default_rng(seed)
    p = rng.random((j, bn, vb)).astype(np.float32)
    p[rng.random(p.shape) < 0.6] = 0.0
    p[:, rng.random(bn) < 0.2] = 0.0            # whole converged blocks
    return p


@pytest.mark.parametrize("vb", [16, 64, 128])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pairs_node_un_exact_p_mean_close(seed, vb):
    p = _pairs_input(seed, vb=vb)
    r_nu, r_pm = map(np.asarray, rc.block_pairs(jnp.asarray(p)))
    t_nu, t_pm = (x.numpy() for x in tc.block_pairs(torch.as_tensor(p)))
    np.testing.assert_array_equal(t_nu, r_nu)
    assert t_pm.dtype == r_pm.dtype == np.float32
    np.testing.assert_allclose(t_pm, r_pm, rtol=1e-6, atol=0)


def test_block_pairs_p_mean_is_not_bit_equal():
    """The recorded finding: the lane sums differ in the last bits, so the
    p_mean bar is rtol 1e-6, not bit equality (if this ever holds, the
    stricter bar can be adopted)."""
    p = _pairs_input(7, j=4, bn=256, vb=64)
    r_pm = np.asarray(rc.block_pairs(jnp.asarray(p))[1])
    t_pm = tc.block_pairs(torch.as_tensor(p))[1].numpy()
    assert not np.array_equal(t_pm, r_pm)
    np.testing.assert_allclose(t_pm, r_pm, rtol=1e-6, atol=0)


@pytest.mark.parametrize("alg", ["pagerank", "ppr", "katz", "sssp", "wcc"])
def test_compute_pairs_from_algorithm_state(alg):
    """Vertex priorities (and so node_un) from each algorithm's state
    agree exactly; the initial states are bit-equal."""
    import repro.graph as rg
    import repro_torch.graph as tg
    mk = {"pagerank": "PageRank", "ppr": "PersonalizedPageRank",
          "katz": "Katz", "sssp": "SSSP", "wcc": "WCC"}[alg]
    kw = {"ppr": dict(source=5), "sssp": dict(source=9)}.get(alg, {})
    a_r, a_t = getattr(ra, mk)(**kw), getattr(ta, mk)(**kw)
    csr_r, csr_t = rg.rmat_graph(100, 4, seed=1), tg.rmat_graph(100, 4, seed=1)
    if a_r.graph_symmetrize:
        csr_r, csr_t = csr_r.symmetrized(), csr_t.symmetrized()
    g_r = rg.build_blocked(csr_r, 16, fill=a_r.graph_fill,
                           normalize=a_r.graph_normalize)
    g_t = tg.build_blocked(csr_t, 16, fill=a_t.graph_fill,
                           normalize=a_t.graph_normalize, device="cpu")
    (v_r, d_r), (v_t, d_t) = a_r.init(g_r), a_t.init(g_t)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_r))
    assert v_t.dtype == d_t.dtype == torch.float32
    # perturb the deltas so every priority branch is exercised
    rng = np.random.default_rng(3)
    d = np.asarray(d_r) + (rng.random(d_r.shape) * 1e-5).astype(np.float32)
    d[rng.random(d.shape) < 0.3] = np.inf if alg in ("sssp", "wcc") else 0.0
    pr_r = np.asarray(a_r.vertex_priority(v_r, jnp.asarray(d)))
    pr_t = a_t.vertex_priority(v_t, torch.as_tensor(d)).numpy()
    np.testing.assert_array_equal(pr_t, pr_r)
    np.testing.assert_array_equal(
        a_t.unconverged(v_t, torch.as_tensor(d)).numpy(),
        np.asarray(a_r.unconverged(v_r, jnp.asarray(d))))
    nu_r, _ = rc.compute_pairs(a_r, v_r[None], jnp.asarray(d)[None])
    nu_t, _ = tc.compute_pairs(a_t, v_t[None], torch.as_tensor(d)[None])
    np.testing.assert_array_equal(nu_t.numpy(), np.asarray(nu_r))
    np.testing.assert_array_equal(
        a_t.result(v_t, torch.as_tensor(d)).numpy(),
        np.asarray(a_r.result(v_r, jnp.asarray(d))))


def _host_pairs(seed, j=3, bn=300):
    rng = np.random.default_rng(seed)
    nu = rng.integers(0, 20, (j, bn)).astype(np.float32)
    pm = (rng.random((j, bn)) * (nu > 0)).astype(np.float32)
    # near-ties inside the CBP epsilon band
    pm[:, ::7] = pm[:, ::7].round(1)
    return nu, pm


@pytest.mark.parametrize("q", [5, 40, 290])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_do_select_identical(seed, q):
    nu, pm = _host_pairs(seed)
    for j in range(nu.shape[0]):
        a = rc.do_select(nu[j], pm[j], q, np.random.default_rng(seed), 50)
        b = tc.do_select(nu[j], pm[j], q, np.random.default_rng(seed), 50)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cbp_and_key_sort_identical():
    rng = np.random.default_rng(5)
    nu = rng.integers(0, 5, 60).astype(np.float32)
    pm = rng.random(60).astype(np.float32).round(2)
    for i in range(0, 60, 3):
        for k in range(1, 60, 5):
            pa, pb = (nu[i], pm[i]), (nu[k], pm[k])
            assert rc.cbp(pa, pb) == tc.cbp(pa, pb)
    np.testing.assert_array_equal(tc.cbp_key_sort(nu, pm),
                                  rc.priority.cbp_key_sort(nu, pm))
    np.testing.assert_allclose(
        tc.do_score(torch.as_tensor(nu), torch.as_tensor(pm)).numpy(),
        np.asarray(rc.do_score(jnp.asarray(nu), jnp.asarray(pm))),
        rtol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 0.8, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_queue_identical(seed, alpha):
    rng = np.random.default_rng(seed)
    queues = [rng.choice(80, size=int(rng.integers(0, 25)), replace=False)
              for _ in range(5)]
    for q in (1, 10, 30):
        a = rc.global_queue(queues, 80, q, alpha)
        b = tc.global_queue(queues, 80, q, alpha)
        np.testing.assert_array_equal(a, b)
        assert rc.reserved_slots(q, alpha) == tc.reserved_slots(q, alpha)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_two_level_scheduler_select_identical(seed):
    nu, pm = _host_pairs(seed, j=4, bn=500)
    active = np.array([True, False, True, True])
    q = rc.optimal_queue_length(500, 500 * 64)
    assert q == tc.optimal_queue_length(500, 500 * 64)
    s_r = rc.TwoLevelScheduler(500, q, seed=seed, samples=100)
    s_t = tc.TwoLevelScheduler(500, q, seed=seed, samples=100)
    for _ in range(3):                    # the stream advances identically
        (qa, ga), (qb, gb) = (s.select(nu, pm, active) for s in (s_r, s_t))
        assert len(qa) == len(qb)
        for x, y in zip(qa, qb):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ga, gb)
        assert s_r.last_occupancy == s_t.last_occupancy
    s_r.reset(9)
    s_t.reset(9)
    np.testing.assert_array_equal(s_r.select(nu, pm)[1],
                                  s_t.select(nu, pm)[1])


def test_scheduler_device_backend_not_ported():
    """The device backend constructs (tests/test_torch_device_scheduler.py
    holds it to the reference); an unknown backend and a host cadence
    other than 1 still raise, as in the reference."""
    assert tc.TwoLevelScheduler(10, 3, backend="device",
                                device="cpu").backend == "device"
    assert tc.TwoLevel(backend="device").backend == "device"
    assert tc.Fused().backend == "device"
    with pytest.raises(ValueError):
        tc.TwoLevelScheduler(10, 3, backend="gpu")
    with pytest.raises(ValueError):
        tc.TwoLevel(steps_per_sync=4)
