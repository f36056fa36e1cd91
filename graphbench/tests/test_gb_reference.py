"""The reference against exact answers on small graphs, and its
bfloat16 control."""

import numpy as np
import pytest

from graphbench import reference as ref
from graphbench.graph import csr_from_edges


def graph(n, edges, w=None):
    src, dst = np.array(edges, dtype=np.int64).T
    w = np.ones(len(src), np.float32) if w is None else np.asarray(w)
    return csr_from_edges(n, src, dst, w)


def test_pagerank_on_a_cycle_is_one_everywhere():
    # x = 0.15 + 0.85 x at every vertex of a directed cycle
    x = ref.plus_times(graph(5, [(i, (i + 1) % 5) for i in range(5)]),
                       0.85, [None])
    np.testing.assert_allclose(x[:, 0], 1.0, rtol=0, atol=1e-12)


def test_ppr_on_two_vertices_solves_by_hand():
    # 0 <-> 1: x0 = 0.15 + 0.85 x1, x1 = 0.85 x0
    x = ref.plus_times(graph(2, [(0, 1), (1, 0)]), 0.85, [0, 1])
    x0 = 0.15 / (1 - 0.85 ** 2)
    np.testing.assert_allclose(x[:, 0], [x0, 0.85 * x0], atol=1e-12)
    np.testing.assert_allclose(x[:, 1], [0.85 * x0, x0], atol=1e-12)


def test_pagerank_with_out_degree_splits_by_hand():
    # 0 -> 1, 0 -> 2, 1 -> 0, 2 -> 0: x1 = x2 = 0.15 + 0.425 x0,
    # x0 = 0.15 + 0.85 (x1 + x2)
    x = ref.plus_times(graph(3, [(0, 1), (0, 2), (1, 0), (2, 0)]), 0.85,
                       [None])[:, 0]
    x0 = (0.15 + 0.85 * 0.3) / (1 - 0.85 * 0.85)
    np.testing.assert_allclose(x, [x0, 0.15 + 0.425 * x0,
                                   0.15 + 0.425 * x0], atol=1e-12)


def test_dijkstra_by_hand():
    g = graph(5, [(0, 1), (1, 2), (0, 2), (2, 3)], [1.0, 1.0, 5.0, 2.0])
    d = ref.min_plus(g, [0, 3])
    np.testing.assert_array_equal(d[0], [0, 1, 2, 4, np.inf])
    np.testing.assert_array_equal(d[1], [np.inf, np.inf, np.inf, 0, np.inf])
    # over unit weights (BFS): hop counts
    np.testing.assert_array_equal(ref.min_plus(g, [0], unit=True)[0],
                                  [0, 1, 1, 2, np.inf])


def test_zero_weight_edge_is_an_edge():
    g = graph(3, [(0, 1), (1, 2)], [0.0, 0.5])
    np.testing.assert_array_equal(ref.min_plus(g, [0])[0], [0, 0, 0.5])


def test_solve_gives_each_view_its_answers():
    g = graph(3, [(0, 1), (1, 2), (2, 0)], [0.5, 0.25, 1.0])
    pt = ref.solve(ref.PLUS, g, 0.85, [None, 1])
    np.testing.assert_array_equal(pt[1], ref.plus_times(g, 0.85, [1])[:, 0])
    np.testing.assert_array_equal(ref.solve(ref.MIN, g, 0.85, [0])[0],
                                  [0, 0.5, 0.75])
    np.testing.assert_array_equal(ref.solve(ref.MIN_UNIT, g, 0.85, [0])[0],
                                  [0, 1, 2])


def test_to_bf16_rounds_to_nearest_even():
    assert ref.to_bf16(1.0) == 1.0
    assert ref.to_bf16(1.0 + 2 ** -9) == 1.0           # tie: to even
    assert ref.to_bf16(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7
    assert ref.to_bf16(np.inf) == np.inf
    assert ref.to_bf16(257.0) == 256.0


def test_bf16_bellman_ford_is_exact_on_unit_weights():
    rng = np.random.default_rng(0)
    g = csr_from_edges(200, rng.integers(0, 200, 800),
                       rng.integers(0, 200, 800), rng.random(800))
    np.testing.assert_array_equal(ref.min_plus_bf16(g, [0, 5], unit=True),
                                  ref.min_plus(g, [0, 5], unit=True))


def test_bf16_bellman_ford_departs_on_graph500_weights():
    rng = np.random.default_rng(0)
    g = csr_from_edges(200, rng.integers(0, 200, 800),
                       rng.integers(0, 200, 800), rng.random(800))
    got, want = ref.min_plus_bf16(g, [0, 5]), ref.min_plus(g, [0, 5])
    assert all(ref.gap(got[i], want[i]) > 1e-3 for i in range(2))


def test_bf16_power_iteration_departs_from_float64():
    rng = np.random.default_rng(1)
    g = csr_from_edges(300, rng.integers(0, 300, 2400),
                       rng.integers(0, 300, 2400),
                       np.ones(2400, np.float32))
    want = ref.plus_times(g, 0.85, [None, 4])
    got = ref.plus_times(g, 0.85, [None, 4], bf16=True)
    assert all(ref.gap(got[:, i], want[:, i]) > 1e-3 for i in range(2))


@pytest.mark.parametrize("got,gap", [([1.0, 2.0, 4.0], 0.0),
                                     ([1.0, 2.0, 4.4], 0.1),
                                     ([1.0, 2.2, 4.0], 0.05)])
def test_gap(got, gap):
    assert ref.gap(np.array(got), np.array([1.0, 2.0, 4.0])) == \
        pytest.approx(gap)


def test_gap_is_infinite_where_reach_differs():
    want = np.array([0.0, 1.0, np.inf, 3.0])
    assert ref.gap(np.array([0, 1, np.inf, 3], np.float32), want) == 0.0
    assert ref.gap(np.array([0, 1, 5, 3], np.float32), want) == np.inf
    assert ref.gap(np.array([0, np.inf, np.inf, 3], np.float32),
                   want) == np.inf
    assert ref.gap(np.array([0, 1.5, np.inf, 3]), want) == \
        pytest.approx(0.5 / 3)
