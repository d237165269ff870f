"""Every example of the port (``pyipm_tpu_torch/examples``) runs in
process on the CPU at a small size; each asserts its own outcome."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from pyipm_tpu_torch.examples import (  # noqa: E402
    batched_fleet, block_lbfgs_and_ragged, heterogeneous_fleet,
    mpc_receding_horizon, quickstart,
)


def _quiet(fn, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = fn(device="cpu", **kw)
    return res, out.getvalue()


def test_quickstart():
    x, out = _quiet(quickstart.main)
    np.testing.assert_allclose(x, 1.0 / 3.0, atol=1e-3)
    assert "f(x)" in out


def test_batched_fleet():
    res, out = _quiet(batched_fleet.main, batch=64)
    assert res.x.shape == (64, 8) and "64 instances" in out


def test_heterogeneous_fleet():
    results, _ = _quiet(heterogeneous_fleet.main)
    assert [r.x.shape[0] for r in results] == [2] * 6 + [4] * 5 + [2]


def test_mpc_receding_horizon():
    (cold, warm), out = _quiet(mpc_receding_horizon.main, T=6, ticks=4)
    assert len(cold) == 5 and len(warm) == 4
    assert "warm starts save" in out


def test_block_lbfgs_and_ragged():
    (res, rres), out = _quiet(block_lbfgs_and_ragged.main, d=64)
    assert res.x.shape == (8, 64) and rres.x.shape == (8, 4)
    assert "OK" in out
