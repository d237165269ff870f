"""Roofline bounds: the least time the chip could take for a function's
mathematics at the shapes of its calls.

The counts are those of an LDL^T factor, solve or backward sweep of that
size, whatever kernel implements it: each input byte the function depends
on read once, each output byte written once, and the operations of the
plain algorithm.  Peaks are NVIDIA's published figures for one H100 SXM
at its 700 W limit; a run records the card's power limit beside them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12              # float32 outside the tensor cores
# float64 on the tensor cores (34e12 outside them): the higher of the
# card's two float64 rates, so a bound is the least time
F64_FLOPS = 67e12


def word_peak(dtype: str):
    """(bytes a word, peak operations a second) of ``'float32'`` or
    ``'float64'``."""
    if dtype == "float64":
        return 8, F64_FLOPS
    if dtype == "float32":
        return 4, F32_FLOPS
    raise ValueError(f"no peak for dtype {dtype!r}")


def bound(nbytes: float, flops: float, peak_flops: float):
    """(bound_s, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / peak_flops
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def factor_counts(B: int, n: int):
    """(words, operations) of B LDL^T factors of n x n matrices: the lower
    triangle of A read (all the function depends on), the full L (unit
    diagonal and zeros above it included) and d written; 2n^3/3
    operations each."""
    words = n * (n + 1) // 2 + n * n + n
    return B * words, B * 2 * n ** 3 / 3


def solve_counts(B: int, n: int):
    """(words, operations) of B solves L D L^T x = b: the strict lower
    triangle of the unit-lower L, d and b read, x written; 2n^2
    operations each."""
    words = n * (n - 1) // 2 + 3 * n
    return B * words, B * 2 * n * n


def sweep_counts(K: int, w: int):
    """(words, operations) of one backward sweep L^T x = z of a K-row
    system at block width w.  The recurrence needs, of each block column
    that holds real rows, the slab below it down to row K (grid padding
    past K is an identity tail) and the strict lower triangle of its
    diagonal block's unit-lower inverse; plus z and x.  Two operations an
    entry."""
    rows = [min(w, K - k0) for k0 in range(0, K, w)]
    slab = sum(r * (K - k0 - r) for k0, r in zip(range(0, K, w), rows))
    inv = sum(r * (r - 1) // 2 for r in rows)
    return slab + inv + 2 * K, 2 * (slab + inv)


def _bound_of(counts, dtype: str):
    words, flops = counts
    size, peak = word_peak(dtype)
    return bound(words * size, flops, peak)


def factor_bound(B: int, n: int, dtype: str = "float32"):
    return _bound_of(factor_counts(B, n), dtype)


def solve_bound(B: int, n: int, dtype: str = "float32"):
    return _bound_of(solve_counts(B, n), dtype)


def sweep_bound(K: int, w: int, dtype: str = "float32"):
    return _bound_of(sweep_counts(K, w), dtype)


def share_pct(bound_s: float, device_s: float):
    """A kernel's share of its roofline in %: the least time over the time
    it took.  None where the kernel took no device time (nothing to
    read)."""
    if device_s <= 0.0 or bound_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
