"""The SVM-dual family at the width of ``chip_smoke.py``'s phase 16 (96
points of 8 features) held to the JAX package on the CPU, instance by
instance, on rows 0-15 of ``sample_svm_arrays(42, 2048, 96, 8)`` in
float32 (``fleet_parity_common.hold_family``: every signal equal and in
{1, 2}, iteration counts equal on at least 15 of 16, x within 2e-3
(1 + |x|))."""

import pytest

torch = pytest.importorskip("torch")

import fleet_parity_common as fp  # noqa: E402


def test_svm_at_phase16_width_matches_jax():
    fp.hold_family("svm", fp.ROWS)
