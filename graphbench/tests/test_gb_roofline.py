"""The B1/B2 roofline on hand-worked counts."""

import pytest

from graphbench import roofline


def test_bytes_by_hand():
    # Vb 2, 3 job slots, 4 blocks, one plus-times and one min-plus view;
    # 5 supersteps selecting 7 source blocks in all, 11 live pairs
    got = roofline.fused_bytes(2, 3, 4, ["plus_times", "min_plus"], 5, 7,
                               11)
    tiles = 4 * 2 * 2 * 11
    d_rows = 4 * 3 * 2 * 7 * 2
    state = 5 * ((4 * 3 * 4 * 2 * 2 + 8 * 3 * 4)
                 + (4 * 3 * 4 * 2 * 4 + 8 * 3 * 4))
    assert got == tiles + d_rows + state == 176 + 336 + 5 * (192 + 96 + 384
                                                             + 96)


def test_flops_by_hand():
    assert roofline.fused_flops(64, 16, 10) == 2 * 16 * 64 * 64 * 10


@pytest.mark.parametrize("nbytes,flops,by", [
    (3.35e12, 1.0, "bytes"), (1.0, 67e12, "operations")])
def test_bound_takes_the_larger(nbytes, flops, by):
    s, got = roofline.bound_s(nbytes, flops)
    assert s == pytest.approx(1.0)
    assert got == by


def test_a_vb64_superstep_is_bound_by_bytes():
    # 100K live pairs of 16 KB a superstep over two views at J = 16
    nbytes = roofline.fused_bytes(64, 16, 1024, ["plus_times", "min_plus"],
                                  1, 400, 100_000)
    s, by = roofline.bound_s(nbytes, roofline.fused_flops(64, 16, 100_000))
    assert by == "bytes"
    assert s == pytest.approx(nbytes / 3.35e12)
    assert 0.48e-3 < s < 0.52e-3
