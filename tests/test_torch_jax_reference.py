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
    (a signal, x, f, the mean iteration count); on a float64 cell (phase
    27's F64_CELLS) it raises on a signal off (a classified float32 split
    too), an iteration count off by one, x or f off by 2e-8 (1 + |.|),
    offsets a float32 cell lets pass; the two QPs classified there
    (``JAX_F64_SPLITS``, ROADMAP Queue 3 D5) may stop apart, and their
    merit penalty is set by roundoff in both packages;
(e) each Schur cell of phases 21-25 (``make_jax_reference.BLOCK_CELLS``;
    their holds in tests/test_torch_schur_reference.py) has the layout
    ``chip_smoke.hold_block_to_jax`` reads: one solve's signal, iteration
    count, f, KKT norms and coupling multipliers, the x of
    ``chip_smoke.block_x_layout`` and a sha256 of every input array."""

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
FLEETS = [pytest.param(c, marks=pytest.mark.slow)
          if c.startswith("wide_portfolio") else c
          for c in mjr.FLEET_CELLS if not c.startswith("dense_")]


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


@pytest.mark.parametrize("cell", mjr.FLEET_CELLS)
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


@pytest.mark.parametrize("cell", mjr.BLOCK_CELLS)
def test_block_reference_matches_manifest_and_constants(cell):
    entry, ref = cs.jax_reference(cell)            # raises on a stale sha256
    assert {k: entry[k] for k in mjr.spec(cell)} == json.loads(
        json.dumps(mjr.spec(cell)))
    z = cs.BLOCK_CELLS[cell]["instance"]
    dt = np.dtype(entry["dtype"])
    assert entry["instances"] == 1
    assert entry["jax_path"] == (mjr.KERNEL if mjr.block_kernel_path(cell)
                                 else mjr.CPU)
    assert entry["pallas_interpret_reached"] == (entry["jax_path"]
                                                 == mjr.KERNEL)
    assert sorted(ref) == ["f", "iter_count", "kkt", "lc", "lci", "signal",
                           "x"]
    assert ref["signal"].shape == () and ref["signal"].dtype == np.int8
    assert ref["iter_count"].shape == () and ref["iter_count"].dtype == \
        np.int16
    assert ref["f"].dtype == ref["kkt"].dtype == np.float64
    assert ref["kkt"].shape == (4,)
    nb, nc = cs.block_x_layout(z["K"], z["d"])
    assert ref["x"].shape == (nb, nc) == (entry["x_blocks"],
                                          entry["x_entries"])
    assert nb * nc <= cs.BLOCK_X_VALUES
    assert ref["x"].dtype == ref["lc"].dtype == ref["lci"].dtype == dt
    mc = z.get("mc", z.get("p", z.get("nres")))
    assert ref["lc"].size + ref["lci"].size == mc
    assert all(np.all(np.isfinite(ref[k])) for k in ("x", "lc", "lci"))
    keys = sorted(entry["inputs"])
    if cs.BLOCK_CELLS[cell]["family"] == "separable":
        assert keys == ["A", "b", "lb", "theta/Q", "theta/c"]
    else:
        assert {k.split("/")[0] for k in keys} == {"theta", "ccdata"}
    assert all(len(v) == 64 for v in entry["inputs"].values())


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
    dt = np.dtype(cfg.float_dtype)
    base = cell.removesuffix("_f64")
    idx = torch.as_tensor(ROWS)
    if base.startswith("qp_"):
        from pyipm_tpu_torch.models.random_nlp import make_qp_problem, qp_data
        full = cs.twin_arrays(cell)
        data = qp_data({k: v[ROWS] for k, v in full.items()}, device=cpu)
        x0 = torch.as_tensor(cs.qp_x0()[ROWS])
        return solve_batch(make_qp_problem(cs.D, cs.NLIN), x0, cfg,
                           params=data)
    if base == "wide_portfolio":
        from pyipm_tpu_torch.models import applications as app
        W = cs.WIDE_PORTFOLIO
        data = app.portfolio_data(_portfolio_rows(W["B"], W["D"], dt),
                                  device=cpu)
        return solve_batch(app.make_portfolio_problem(W["D"]),
                           app.portfolio_x0(len(ROWS), W["D"], dt, cpu),
                           cfg, params=data)
    prob, data, x0 = cs.mixed_buckets(cpu, dt)[base.removeprefix("mixed_")]
    return cs.solve_bucket(prob, take(data, idx), x0[idx], cfg, cpu)


def _portfolio_rows(B, D, dtype=np.float32):
    """ROWS of ``sample_portfolio_arrays(SEED, B, D, dtype)``: the same
    draws in the same order, without the (B, D, D) covariances of the other
    rows (~20 s at phase 26's B = 1,024 and D = 500)."""
    rng = np.random.default_rng(cs.SEED)
    F = rng.standard_normal((B, D, max(D // 4, 2)))[ROWS]
    S = np.einsum("bik,bjk->bij", F, F) / D + 0.05 * np.eye(D)[None]
    m = 0.1 * rng.standard_normal((B, D))[ROWS]
    gamma = 0.5 + np.abs(rng.standard_normal(B))[ROWS]
    arr = dict(S=S, m=m, gamma=gamma, cap=np.full((len(ROWS), D), 4.0 / D))
    return {k: v.astype(dtype) for k, v in arr.items()}


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


@pytest.mark.parametrize("cell", cs.F64_CELLS)
def test_f64_cell_is_its_twin_in_float64(cell):
    """Each float64 cell is the float32 cell of the same name drawn and
    solved in float64 along the JAX package's CPU path, its inputs' sha256s
    those of ``chip_smoke.twin_arrays`` (the wide draw's keys only: it
    takes ~20 s)."""
    entry, ref = cs.jax_reference(cell)
    twin = mjr.spec(cell.removesuffix("_f64"))
    assert {k: v for k, v in mjr.spec(cell).items()
            if k not in ("phase", "config", "jax_path")} == {
        k: v for k, v in twin.items()
        if k not in ("phase", "config", "jax_path")}
    assert entry["config"] == dict(twin["config"], float_dtype="float64")
    assert (entry["phase"], entry["jax_path"], entry["dtype"]) == (
        27, mjr.CPU, "float64")
    assert entry["pallas_interpret_reached"] is False
    assert ref["x"].dtype == np.float64
    assert ref["x_rows"].size <= mjr.X_ROWS_F64 + len(
        mjr.NAMED_ROWS.get(cell.removesuffix("_f64"), ()))
    if cell.startswith("wide_"):
        assert sorted(entry["inputs"]) == ["S", "cap", "gamma", "m"]
    else:
        assert cs.input_digests(cs.twin_arrays(cell)) == entry["inputs"]


@pytest.mark.parametrize("cell", ["mixed_maxent", "mixed_maxent_f64"])
@pytest.mark.parametrize("miss", ["signal", "iters", "x", "f"])
def test_f64_hold_raises_where_the_f32_hold_passes(cell, miss):
    """The same offsets on the reference's own kept rows: the float32 hold
    lets them pass (maximum entropy 1415 is a classified split there), the
    float64 hold raises on each."""
    _, ref = cs.jax_reference(cell)
    rows = ref["x_rows"]
    got = dict(signal=ref["signal"][rows].copy(),
               iters=ref["iter_count"][rows].astype(np.int64),
               f=ref["f"][rows].copy(), x=ref["x"].astype(np.float64))
    out = cs.hold_to_jax(cell, rows=rows, **got)
    assert out["max_rel_dx"] == out["max_rel_df"] == 0.0
    k = int(np.flatnonzero(rows == 1415)[0]) if miss == "signal" else 5
    if miss == "signal":
        got["signal"][k] = -2
    elif miss == "iters":
        got["iters"][k] += 1
    elif miss == "x":
        got["x"][k, 0] += 2e-8 * (1 + abs(got["x"][k, 0]))
    else:
        got["f"][k] += 2e-8 * (1 + abs(got["f"][k]))
    if cell.endswith("_f64"):
        with pytest.raises(AssertionError):
            cs.hold_to_jax(cell, rows=rows, **got)
    else:
        cs.hold_to_jax(cell, rows=rows, **got)


def test_f64_hold_lets_only_a_classified_instance_stop_apart():
    """D5's instances of ``qp_mehrotra_f64`` may take another iteration
    count, their f held within JAX_FTOL; the same offsets on a neighbour
    raise."""
    cell = "qp_mehrotra_f64"
    _, ref = cs.jax_reference(cell)
    x = np.zeros((ref["signal"].size, cs.D))
    x[ref["x_rows"]] = ref["x"]
    for i in cs.JAX_F64_SPLITS[cell]:
        for k in (i, i - 1):
            iters = ref["iter_count"].astype(np.int64)
            f = ref["f"].copy()
            iters[k] += 1
            f[k] += 1e-6 * (1 + abs(f[k]))
            got = dict(signal=ref["signal"], iters=iters, f=f, x=x)
            if k == i:
                assert cs.hold_to_jax(cell, **got)["iters_differ"] == [k]
            else:
                with pytest.raises(AssertionError):
                    cs.hold_to_jax(cell, **got)


def test_qp_mehrotra_f64_splits_follow_a_roundoff_penalty():
    """D5 on the CPU: QPs 8248 and 8760 of the float64 'mehrotra' fleet,
    each solved alone by the port and by the JAX package, both converge,
    with a merit penalty nu past 1e11 on both sides (a positive barrier
    slope over an l1 infeasibility of ~1e-15) that differs between them,
    f within JAX_FTOL; their neighbours keep nu at its initial 10 and
    agree within JAX_F64_TOL."""
    import jax
    import jax.numpy as jnp

    from pyipm_tpu import IPMConfig as JCfg
    from pyipm_tpu.models.random_nlp import QPData, make_qp_batch_solver
    from pyipm_tpu_torch import IPMConfig, solve_batch
    from pyipm_tpu_torch.models.random_nlp import make_qp_problem, qp_data

    cell = "qp_mehrotra_f64"
    jax.config.update("jax_enable_x64", True)
    arr = cs.twin_arrays(cell)
    x0 = cs.qp_x0().astype(np.float64)
    cfg = dict(verbosity=0, Ktol=1e-4, mu_strategy="mehrotra")
    jfn = make_qp_batch_solver(JCfg(float_dtype="float64", **cfg), cs.D,
                               cs.NLIN)
    problem = make_qp_problem(cs.D, cs.NLIN)
    for i in cs.JAX_F64_SPLITS[cell]:
        for k, split in ((i, True), (i - 1, False)):
            rows = {f: v[k:k + 1] for f, v in arr.items()}
            port = solve_batch(problem, torch.as_tensor(x0[k:k + 1]),
                               IPMConfig(**cfg), params=qp_data(
                                   rows, device="cpu"))
            jres = jfn(jnp.asarray(x0[k:k + 1]), QPData(
                *(jnp.asarray(rows[f]) for f in QPData._fields)))
            assert int(port.signal[0]) == int(jres.signal[0]) == 1
            nu_p, nu_j = float(port.nu[0]), float(jres.nu[0])
            df = abs(float(port.fval[0]) - float(jres.fval[0])) / (
                1 + abs(float(jres.fval[0])))
            if split:
                assert min(nu_p, nu_j) > 1e11 and nu_p != nu_j, (nu_p, nu_j)
                assert df <= cs.JAX_FTOL
            else:
                assert nu_p == nu_j == 10.0
                assert int(port.iter_count[0]) == int(jres.iter_count[0])
                assert df <= cs.JAX_F64_TOL
