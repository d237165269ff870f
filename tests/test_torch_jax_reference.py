"""The JAX package's answers kept in ``jax_reference/`` (written by
``scripts/make_jax_reference.py``, held on the card by
``chip_smoke.hold_to_jax``):

(a) the manifest's files match their sha256s and shapes, and each cell's
    seed, sizes, configuration and path equal what ``chip_smoke.py``'s
    constants give now, so a changed constant without a regenerated
    reference fails here;
(b) rows 0-7 of ``qp_adaptive`` and ``mixed_maxent`` solved again in this
    process by the JAX package along the manifest's path give the stored
    signals and iteration counts, and x within 1e-6 (1 + |x|);
(c) the port's CPU path on rows 0-7 of every fleet cell passes
    ``chip_smoke.hold_to_jax``, the function the card's run calls;
(d) that hold raises on a stale or missing file and on each kind of miss
    (a signal, x, f, the mean iteration count)."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as cs  # noqa: E402
import make_jax_reference as mjr  # noqa: E402

ROWS = np.arange(8)
# the port's CPU path on eight portfolios of 500 assets takes ~1 min
FLEETS = [pytest.param(c, marks=pytest.mark.slow) if c == "wide_portfolio"
          else c for c in mjr.CELLS if not c.startswith("dense_")]


def _manifest():
    with open(os.path.join(cs.JAX_REFERENCE, "MANIFEST.json")) as fh:
        return json.load(fh)["cells"]


def test_manifest_names_every_cell_within_3_mb():
    cells = _manifest()
    assert list(cells) == list(mjr.CELLS)
    files = [os.path.join(cs.JAX_REFERENCE, e["file"])
             for e in cells.values()]
    total = sum(os.path.getsize(f) for f in files) + os.path.getsize(
        os.path.join(cs.JAX_REFERENCE, "MANIFEST.json"))
    assert total <= 3 * 2 ** 20, total


@pytest.mark.parametrize("cell", mjr.CELLS)
def test_reference_matches_manifest_and_constants(cell):
    entry, ref = cs.jax_reference(cell)            # raises on a stale sha256
    # JSON keeps lists where the spec has tuples
    assert {k: entry[k] for k in mjr.spec(cell)} == json.loads(
        json.dumps(mjr.spec(cell)))
    n = entry["instances"]
    assert ref["signal"].shape == (n,) and ref["signal"].dtype == np.int8
    assert ref["iter_count"].shape == (n,)
    assert ref["iter_count"].dtype == np.int16
    assert ref["f"].shape == (n,) and ref["f"].dtype == np.float64
    np.testing.assert_array_equal(ref["x_rows"], mjr.x_rows(cell))
    assert ref["x"].shape[0] == ref["x_rows"].size
    assert ref["x"].dtype == np.dtype(entry["dtype"])
    assert np.all(np.isfinite(ref["x"]))


@pytest.mark.parametrize("cell", ["qp_adaptive", "mixed_maxent"])
def test_jax_rows_recomputed_match_the_reference(cell):
    _, ref = cs.jax_reference(cell)
    out, _ = mjr.solve_rows(cell, ROWS)
    np.testing.assert_array_equal(out["signal"], ref["signal"][ROWS])
    np.testing.assert_array_equal(out["iter_count"],
                                  ref["iter_count"][ROWS])
    xr = ref["x"][ROWS].astype(np.float64)
    dx = np.abs(out["x"] - xr) / (1.0 + np.abs(xr))
    assert dx.max() <= 1e-6, dx.max()


def _port_rows(cell):
    """The port's CPU path on ROWS of ``cell``: the call its phase makes on
    the card."""
    from pyipm_tpu_torch import IPMConfig, solve_batch
    from pyipm_tpu_torch.core.linesearch import take

    cpu = torch.device("cpu")
    cfg = IPMConfig(**mjr.spec(cell)["config"])
    idx = torch.as_tensor(ROWS)
    if cell.startswith("qp_"):
        from pyipm_tpu_torch.models.random_nlp import (
            make_qp_problem, qp_data, sample_qp_arrays,
        )
        full = sample_qp_arrays(cs.SEED, cs.B, cs.D, cs.NLIN)
        data = qp_data({k: v[ROWS] for k, v in full.items()}, device=cpu)
        x0 = torch.as_tensor(cs.qp_x0()[ROWS])
        return solve_batch(make_qp_problem(cs.D, cs.NLIN), x0, cfg,
                           params=data)
    if cell == "wide_portfolio":
        from pyipm_tpu_torch.models import applications as app
        W = cs.WIDE_PORTFOLIO
        data = app.portfolio_data(_portfolio_rows(W["B"], W["D"]),
                                  device=cpu)
        return solve_batch(app.make_portfolio_problem(W["D"]),
                           app.portfolio_x0(len(ROWS), W["D"], device=cpu),
                           cfg, params=data)
    prob, data, x0 = cs.mixed_buckets(cpu)[cell.removeprefix("mixed_")]
    return cs.solve_bucket(prob, take(data, idx), x0[idx], cfg, cpu)


def _portfolio_rows(B, D):
    """ROWS of ``sample_portfolio_arrays(SEED, B, D)``: the same draws in
    the same order, without the (B, D, D) covariances of the other rows
    (~20 s at phase 26's B = 1,024 and D = 500)."""
    rng = np.random.default_rng(cs.SEED)
    F = rng.standard_normal((B, D, max(D // 4, 2)))[ROWS]
    S = np.einsum("bik,bjk->bij", F, F) / D + 0.05 * np.eye(D)[None]
    m = 0.1 * rng.standard_normal((B, D))[ROWS]
    gamma = 0.5 + np.abs(rng.standard_normal(B))[ROWS]
    arr = dict(S=S, m=m, gamma=gamma, cap=np.full((len(ROWS), D), 4.0 / D))
    return {k: v.astype(np.float32) for k, v in arr.items()}


def test_portfolio_rows_are_the_samplers():
    from pyipm_tpu_torch.models.applications import sample_portfolio_arrays
    full = sample_portfolio_arrays(cs.SEED, 40, cs.WIDE_PORTFOLIO["D"])
    rows = _portfolio_rows(40, cs.WIDE_PORTFOLIO["D"])
    for k, v in rows.items():
        np.testing.assert_array_equal(v, full[k][ROWS])


@pytest.mark.parametrize("cell", FLEETS)
def test_port_cpu_rows_pass_the_card_hold(cell):
    res = _port_rows(cell)
    out = cs.hold_to_jax(cell, res.signal, res.iter_count, res.fval, res.x,
                         rows=ROWS)
    assert out["signals_equal"] == len(ROWS)
    assert out["x_rows_held"] > 0


def test_hold_raises_on_a_stale_file(tmp_path, monkeypatch):
    import shutil
    shutil.copytree(cs.JAX_REFERENCE, tmp_path, dirs_exist_ok=True)
    with open(tmp_path / "mixed_box_qp.npz", "ab") as fh:
        fh.write(b"\0")
    monkeypatch.setattr(cs, "JAX_REFERENCE", str(tmp_path))
    with pytest.raises(AssertionError, match="sha256"):
        cs.jax_reference("mixed_box_qp")
    (tmp_path / "mixed_box_qp.npz").unlink()
    with pytest.raises(FileNotFoundError):
        cs.jax_reference("mixed_box_qp")


@pytest.mark.parametrize("miss", ["signal", "x", "f", "iters"])
def test_hold_raises_on_each_miss(miss):
    """The reference's own rows pass; each kind of miss raises."""
    _, ref = cs.jax_reference("qp_adaptive")
    rows = ref["x_rows"][:64]
    got = dict(signal=ref["signal"][rows].copy(),
               iters=ref["iter_count"][rows].astype(np.int64),
               f=ref["f"][rows].copy(), x=ref["x"][:64].copy())
    cs.hold_to_jax("qp_adaptive", rows=rows, **got)
    if miss == "signal":
        got["signal"][5] = -1
    elif miss == "x":
        got["x"][5, 0] += 3e-3 * (1 + abs(got["x"][5, 0]))
    elif miss == "f":
        got["f"][5] += 2e-3 * (1 + abs(got["f"][5]))
    else:
        got["iters"] += 1
    with pytest.raises(AssertionError):
        cs.hold_to_jax("qp_adaptive", rows=rows, **got)
