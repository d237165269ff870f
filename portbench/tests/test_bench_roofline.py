"""The roofline counts at each cell's shapes, against hand counts."""

import pytest

from portbench import roofline as R


@pytest.mark.parametrize("B", [8192, 32768])
def test_sleeve_counts_by_hand(B):
    # kernels 1-2 on a sleeve book: B factors and solves of 65 (D + 1)
    words, ops = R.factor_counts(B, 65)
    assert words == B * 6435 and ops == pytest.approx(B * 2 * 65 ** 3 / 3)
    assert R.solve_counts(B, 65) == (B * 2275, B * 2 * 65 * 65)


def test_factor_counts_by_hand():
    # kernel 3 on the book: 1,024 panels of 128 (lower triangle of A read,
    # L and d written; 2n^3/3 operations a panel)
    words, ops = R.factor_counts(1024, 128)
    assert words == 1024 * (128 * 129 // 2 + 128 * 128 + 128)
    assert words == 1024 * 24768
    assert ops == pytest.approx(1024 * 2 * 128 ** 3 / 3)
    # kernel 1 on the sleeves: 32,768 factors of 65 (D + 1)
    words, ops = R.factor_counts(32768, 65)
    assert words == 32768 * (2145 + 4225 + 65)
    assert ops == pytest.approx(32768 * 2 * 65 ** 3 / 3)
    t, by = R.factor_bound(1024, 128, "float64")
    assert by == "bytes"
    assert t == pytest.approx(1024 * 24768 * 8 / 3.35e12)


def test_solve_counts_by_hand():
    words, ops = R.solve_counts(32768, 65)
    assert words == 32768 * (65 * 64 // 2 + 3 * 65)
    assert ops == 32768 * 2 * 65 * 65
    t, by = R.solve_bound(32768, 65, "float64")
    assert by == "bytes" and t == pytest.approx(32768 * 2275 * 8 / 3.35e12)


@pytest.mark.parametrize("w", [128, 1024, 4352, 5000])
def test_sweep_counts_the_strict_lower_triangle(w):
    # whatever the block width, the sweep needs the strict lower triangle
    # of the K x K factor, z and x: 4352 * 4351 / 2 + 2 * 4352 words
    K = 4352
    words, ops = R.sweep_counts(K, w)
    assert words == K * (K - 1) // 2 + 2 * K == 9_476_480
    assert ops == 2 * (K * (K - 1) // 2)
    t, by = R.sweep_bound(K, w, "float64")
    assert by == "bytes" and t == pytest.approx(9_476_480 * 8 / 3.35e12)


def test_peaks_and_words():
    assert R.word_peak("float64") == (8, 67e12)
    assert R.word_peak("float32") == (4, 67e12)
    with pytest.raises(ValueError):
        R.word_peak("bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_share_never_reads_above_100(dtype):
    # the share is the least time over the time taken: it reaches 100 only
    # where the device ran at the bound, and a time below the least time
    # reads above 100, the sign of counts too high
    least, _ = R.factor_bound(1024, 128, dtype)
    assert R.share_pct(least, least) == pytest.approx(100.0)
    assert R.share_pct(least, 4 * least) == pytest.approx(25.0)
    assert R.share_pct(least, 0.5 * least) > 100.0
    assert R.share_pct(least, 0.0) is None
    assert R.share_pct(0.0, 1.0) is None


def test_bound_takes_the_larger_time():
    assert R.bound(3.35e12, 1.0, 67e12) == (pytest.approx(1.0), "bytes")
    assert R.bound(1.0, 67e12, 67e12) == (pytest.approx(1.0), "operations")
