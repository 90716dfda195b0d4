"""The roofline counts at small shapes, against counting by brute force,
and the least times of the cells' kernels against chip_smoke.py's bounds
(the numbers PERF.md's kernel table gives)."""

import itertools

import pytest

from harness import roofline


@pytest.mark.parametrize("n", [1, 2, 5, 17])
def test_k1_pairs_counts_each_distinct_pair_once(n):
    pairs = {tuple(sorted(p)) for p in itertools.product(range(n), repeat=2)}
    assert roofline.k1_pairs(n, n) == len(pairs)


@pytest.mark.parametrize("rows,n", [(1, 5), (3, 7), (7, 7)])
def test_k1_pairs_of_a_row_range(rows, n):
    pairs = {tuple(sorted((i, j))) for i in range(rows) for j in range(n)}
    assert roofline.k1_pairs(rows, n) == len(pairs)


def test_counts_at_small_shapes():
    ops, nbytes = roofline.k1_counts(4, 3, 2)
    assert ops == 2 * 10 * 3 and nbytes == 4 * 3 * 4 + 4 * 2 * 8
    ops, nbytes = roofline.k2_counts(2, 5, 3, 4)
    assert ops == 2 * 2 * 5 * 3
    assert nbytes == 5 * 3 * 4 + 5 * 4 + 2 * 3 * 4 + 2 * 4 + 2 * 4 * 8
    ops, nbytes = roofline.k3_counts(2, 128, 192, 3, 64)
    assert ops == 2 * 2 * 128 * 3
    assert nbytes == 192 * 3 * 2 + 192 * 4 + 2 * 3 * 2 + 2 * 4 + 2 * 3 * 4


def test_least_time_takes_the_larger_term():
    assert roofline.least_s(67e12, "fp32", 0.0) == pytest.approx(1.0)
    assert roofline.least_s(0.0, "fp32", 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(67e12, "fp32", 6.7e12) == pytest.approx(2.0)


@pytest.mark.parametrize("counts,kind,ms", [
    (roofline.k1_counts(313_841, 384, 25), "fp32", 564.5),
    (roofline.k1_counts(1_000_000, 768, 25), "fp32", 11_462.7),
    (roofline.k2_counts(4096, 313_841, 384, 15), "fp32", 14.73),
    (roofline.k3_counts(16_384, 1_000_000, 1_007_616, 768, 64), "bf16",
     25.45),
])
def test_the_cells_least_times(counts, kind, ms):
    assert roofline.least_s(counts[0], kind, counts[1]) * 1e3 == \
        pytest.approx(ms, rel=1e-3)
