"""The numpy-drawn Schur cells of ``chip_smoke.py`` (phases 21-25) and
their JAX answers in ``jax_reference/``:

(a) each numpy sampler at small K gives the same bits on a second call,
    the shapes and dtypes of its torch sibling, and its family's
    invariants (b = A x_feas to roundoff, R >= 0, Q positive definite,
    the ragged junk rows outside the masks);
(b) for each family, on a numpy draw at small K in float64, the port's
    CPU solve against the JAX solve of the same arrays: signals and
    iterations equal, x and the coupling multipliers within 1e-8
    (1 + |.|), the rule of tests/test_torch_schur*.py;
(c) ``chip_smoke.hold_block_to_jax``, the hold of the card's run, passes
    the reference's own values and raises on a changed signal, x, f,
    coupling multiplier, iteration count (float64) or input digest, and
    on a stale file; a classified signal split passes with x still held;
(d) the input digests of the cheap cells, recomputed, match the
    manifest's."""

import copy
import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models import applications as JA  # noqa: E402
from pyipm_tpu.parallel import schur as JS  # noqa: E402
from pyipm_tpu_torch import interop  # noqa: E402
from pyipm_tpu_torch.config import IPMConfig as TCfg  # noqa: E402
from pyipm_tpu_torch.models import applications as TA  # noqa: E402
from pyipm_tpu_torch.parallel import schur as TS  # noqa: E402

RTOL = 1e-8
SEED = 3
FAMILIES = ("separable", "resource", "general", "ragged", "box_quadratic")


def _draw(family, dtype=np.float32):
    """A small numpy draw of ``family``: (theta, ccdata-or-None)."""
    if family == "separable":
        return TS.sample_separable_arrays(SEED, 6, 5, 2, dtype), None
    if family == "resource":
        return TA.sample_resource_alloc_arrays(SEED, 6, 5, 3, 1, dtype)
    if family == "general":
        return TS.sample_block_general_arrays(SEED, 6, 3, dtype=dtype)
    if family == "ragged":
        return TS.sample_block_ragged_arrays(SEED, 6, dtype=dtype)[:2]
    return TS.sample_block_box_quadratic_arrays(SEED, 6, 40, 3, dtype)


def _torch_sibling(family):
    """The torch sampler's draw at the same sizes, float32 on the CPU."""
    gen = torch.Generator().manual_seed(0)
    kw = dict(dtype=torch.float32, device="cpu")
    if family == "separable":
        _, data, _ = TS.sample_separable(gen, 6, 5, 2, **kw)
        return dict(theta=data.theta, A=data.A, b=data.b, lb=data.lb), None
    if family == "resource":
        data = TA.sample_resource_alloc(gen, 6, 5, 3, 1, **kw)
        return data.theta, data.ccdata
    if family == "general":
        return TS.sample_block_general(gen, 6, 3, **kw)[1:3]
    if family == "ragged":
        return TS.sample_block_ragged(gen, 6, **kw)[1:3]
    return TS.sample_block_box_quadratic(gen, 6, 40, 3, **kw)[1:3]


def _xfeas(family):
    """The sampler's feasible point, drawn again from its stream."""
    rng = np.random.default_rng(SEED)
    g = TS._grid_normal
    if family == "ragged":
        rng.integers(1, 3, size=6)
        rng.integers(2, 4, size=6)
    K, d = 6, dict(box_quadratic=40, general=3, ragged=4).get(family, 5)
    if family == "box_quadratic":
        rng.random((K, d))
    else:
        TS._spd_arrays(rng, K, d, np.float64)
    g(rng, (K, d))
    n_extra = dict(separable=[(K, 2, d)], resource=[(K, 1, d), (K, 3, d)],
                   general=[(K, 1, d), (K, 2, d), (K, 2, d)],
                   ragged=[(K, 2, d), (K, 3, d), (K, 2, d)],
                   box_quadratic=[(K, 3, d)])[family]
    for shape in n_extra:
        g(rng, shape)
    xf = g(rng, (K, d)) / TS._GRID
    return np.abs(xf) + 0.5 if family == "resource" else 0.1 * xf


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _roundoff(a, b, terms):
    """|a - b| within 1e-14 of the sum of the terms' magnitudes."""
    assert np.all(np.abs(a - b) <= 1e-14 * terms)


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_sampler_repeats_and_matches_its_torch_sibling(family):
    first, again = (_leaves(dict(zip("tc", _draw(family))))
                    for _ in range(2))
    sib = _leaves(dict(zip("tc", _torch_sibling(family))))
    assert first.keys() == again.keys() == sib.keys()
    for k, v in first.items():
        assert v.dtype == np.float32, k
        np.testing.assert_array_equal(v, again[k])
        assert v.shape == tuple(sib[k].shape), k
        assert str(sib[k].dtype) == f"torch.{v.dtype}", k
    th, cc = _draw(family, np.float64)
    xf = _xfeas(family)
    if family == "separable":
        th, cc = th["theta"], dict(b=th["b"], A=th["A"])
    if "Q" in th:
        np.testing.assert_array_equal(th["Q"], th["Q"].transpose(0, 2, 1))
        assert np.linalg.eigvalsh(th["Q"]).min() >= 1.0 - 1e-12
    ax = np.abs(xf)
    if family in ("separable", "box_quadratic"):
        A = cc["A"] if family == "separable" else th["A"]
        _roundoff(np.einsum("kcd,kd->c", A, xf), cc["b"],
                  np.einsum("kcd,kd->c", np.abs(A), ax))
    if family == "resource":
        assert np.all(th["R"] >= 0) and np.all(xf > 0.5)
        _roundoff(np.einsum("krd,kd->r", th["R"], xf), cc["budget"],
                  np.einsum("krd,kd->r", th["R"], ax))
        _roundoff(np.einsum("kmd,kd->km", th["Ce"], xf), th["e"],
                  np.einsum("kmd,kd->km", np.abs(th["Ce"]), ax))
    if family in ("general", "ragged"):
        e = np.einsum("kmd,kd->km", th["Ce"], xf)
        di = 1.0 - np.einsum("knd,kd->kn", th["Ci"], xf)
        base = np.einsum("kpd,kd->kp", th["G"], xf)
        me, mi = (th["ce_mask"] > 0, th["ci_mask"] > 0) if (
            family == "ragged") else (np.ones_like(e, bool),
                                      np.ones_like(di, bool))
        _roundoff(th["e"][me], e[me], np.einsum(
            "kmd,kd->km", np.abs(th["Ce"]), ax)[me])
        _roundoff(th["di"][mi], di[mi], 1.0 + np.einsum(
            "knd,kd->kn", np.abs(th["Ci"]), ax)[mi])
        ab = np.einsum("kpd,kd->kp", np.abs(th["G"]), ax)
        u0 = base.sum(0) + (0.05 * base ** 2).sum(0) * (family == "general")
        _roundoff(cc["u0"], u0, (ab + ab ** 2).sum(0))
    if family == "ragged":
        assert np.all(th["e"][~me] == 37.0) and np.all(th["di"][~mi] == -37.0)
        assert me[:, 0].all() and mi[:, :1].all() and not me.all()


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",),
                             axis_types=(jax.sharding.AxisType.Auto,))


def _pair(family):
    """(JAX result, port result) of one small float64 numpy draw."""
    cfg = dict(float_dtype="float64", verbosity=0)
    key = jax.random.key(0)
    if family == "separable":
        arr = TS.sample_separable_arrays(SEED, 16, 4, 2, np.float64)
        jspec = JS.sample_separable(key, 1, 4, 2, jnp.float64)[0]
        jres = JS.make_separable_solver(jspec, _mesh1(), JCfg(**cfg))(
            jnp.zeros((16, 4)), JS.SeparableData(**jax.tree.map(
                jnp.asarray, arr)))
        data = interop.separable_data_from_numpy(arr, device="cpu")
        tres = TS.make_block_solver(
            TS.separable_block_spec(TS.separable_spec(4, 2)), None,
            TCfg(**cfg), device="cpu")(
                torch.zeros((16, 4), dtype=torch.float64),
                {"user": data.theta, "A": data.A, "lb": data.lb},
                {"b": data.b})
        return jres, tres
    x0 = np.zeros((16, 3))
    if family == "resource":
        th, cc = TA.sample_resource_alloc_arrays(SEED, 16, 3, 2, 1,
                                                 np.float64)
        jspec = JA.make_resource_alloc_spec(3, 2, 1, cap="ineq")
        tspec = TA.make_resource_alloc_spec(3, 2, 1, cap="ineq")
        x0 = x0 + 1
    elif family == "general":
        th, cc = TS.sample_block_general_arrays(SEED, 16, 3)
        jspec = JS.sample_block_general(key, 1, 3)[0]
        tspec = TS.block_general_spec(3)
    elif family == "ragged":
        th, cc = TS.sample_block_ragged_arrays(SEED, 16, 3)[:2]
        jspec = JS.sample_block_ragged(key, 1, 3)[0]
        tspec = TS.block_ragged_spec(3)
    else:
        th, cc = TS.sample_block_box_quadratic_arrays(SEED, 4, 64, 2,
                                                      np.float64)
        jspec = JS.BlockNLP(
            f_blk=lambda xk, t: 0.5 * xk @ (t["q"] * xk) + t["c"] @ xk,
            d=64, ci_blk=JS.box_ci("lb"), ni=64, ci_identity=True,
            g_blk=lambda xk, t: t["A"] @ xk, cc=lambda u, c: u - c["b"],
            p=2, mc=2)
        tspec = TS.block_box_quadratic_spec(64, 2)
        x0 = np.zeros((4, 64))
        cfg.update(lbfgs=4, niter=20, miter=60)
    jres = JS.make_block_solver(jspec, _mesh1(), JCfg(**cfg))(
        jnp.asarray(x0), jax.tree.map(jnp.asarray, th),
        ccdata=jax.tree.map(jnp.asarray, cc))
    tth, tcc = interop.block_data_from_numpy(th, cc, device="cpu")
    tres = TS.make_block_solver(tspec, None, TCfg(**cfg), device="cpu")(
        torch.tensor(x0), tth, tcc)
    return jres, tres


@pytest.mark.parametrize("family", FAMILIES)
def test_port_cpu_matches_jax_on_a_numpy_draw(family):
    jres, tres = _pair(family)
    assert int(tres.signal) == int(jres.signal) == 1
    assert int(tres.iter_count) == int(jres.iter_count)
    for k in ("x", "lc", "lci"):
        a, b = getattr(tres, k).numpy(), np.asarray(getattr(jres, k, np.zeros(
            0)))
        assert a.shape == b.shape, k
        assert np.all(np.abs(a - b) <= RTOL * (1 + np.abs(b))), k


def _ref_result(cell):
    """The reference's own answer to ``cell`` as a result and the
    manifest's input digests."""
    entry, ref = cs.jax_reference(cell)
    z = cs.BLOCK_CELLS[cell]["instance"]
    x = np.zeros((z["K"], z["d"]), ref["x"].dtype)
    nb, nc = ref["x"].shape
    x[:nb, :nc] = ref["x"]
    res = types.SimpleNamespace(
        signal=int(ref["signal"]), iter_count=int(ref["iter_count"]),
        fval=float(ref["f"]), x=x, lc=ref["lc"].copy(),
        lci=ref["lci"].copy(), kkt=ref["kkt"])
    return res, dict(entry["inputs"])


@pytest.mark.parametrize("cell,miss", [
    ("schur_ranks", None), ("schur_ranks", "signal"), ("schur_ranks", "x"),
    ("schur_ranks", "f"), ("schur_ranks", "lc"), ("schur_ranks", "digest"),
    ("resource_ineq_adaptive", "lci"), ("lbfgs_block_f64", None),
    ("lbfgs_block_f64", "iters"), ("lbfgs_block_f64", "x")])
def test_block_hold_passes_the_reference_and_raises_on_each_miss(cell,
                                                                  miss):
    res, digests = _ref_result(cell)
    f64 = cs.BLOCK_CELLS[cell]["config"]["float_dtype"] == "float64"
    step = 2 * (cs.BLOCK_F64_TOL if f64 else cs.STOP_APART_XTOL)
    if miss is None:
        out = cs.hold_block_to_jax(cell, digests, res)
        assert out["max_rel_dx"] == out["max_rel_dlc"] == out["rel_df"] == 0
        assert out["x_values_held"] == cs.jax_reference(cell)[1]["x"].size
        return
    if miss == "signal":
        res.signal = -1
    elif miss == "x":
        res.x = res.x.astype(np.float64)
        res.x[0, 1] += step * (1 + abs(res.x[0, 1]))
    elif miss == "f":
        res.fval += 2 * cs.JAX_FTOL * (1 + abs(res.fval))
    elif miss in ("lc", "lci"):
        m = getattr(res, miss).astype(np.float64)
        m[0] += step * (1 + abs(m[0]))
        setattr(res, miss, m)
    elif miss == "iters":
        res.iter_count += 1
    else:
        digests["theta/Q"] = "0" * 64
    with pytest.raises(AssertionError):
        cs.hold_block_to_jax(cell, digests, res)


def test_block_hold_holds_a_classified_split_within_stop_apart_xtol():
    """``schur_large``'s split (ROADMAP Queue 3, D4): the reference ends at
    -1 after its iteration limit, the card at 1; the hold lets the signals
    differ and still holds x within STOP_APART_XTOL."""
    res, digests = _ref_result("schur_large")
    assert res.signal == -1 and cs.JAX_SIGNAL_SPLITS["schur_large"] == (0,)
    res.signal, res.iter_count = 1, 14
    assert cs.hold_block_to_jax("schur_large", digests, res)["xtol"] == \
        cs.STOP_APART_XTOL
    res.x = res.x.astype(np.float64)
    res.x[3, 7] += 2 * cs.STOP_APART_XTOL * (1 + abs(res.x[3, 7]))
    with pytest.raises(AssertionError):
        cs.hold_block_to_jax("schur_large", digests, res)


def test_block_hold_raises_on_a_stale_file(tmp_path, monkeypatch):
    shutil.copytree(cs.JAX_REFERENCE, tmp_path, dirs_exist_ok=True)
    res, digests = _ref_result("block_ragged")
    with open(tmp_path / "block_ragged.npz", "ab") as fh:
        fh.write(b"\0")
    monkeypatch.setattr(cs, "JAX_REFERENCE", str(tmp_path))
    with pytest.raises(AssertionError, match="sha256"):
        cs.hold_block_to_jax("block_ragged", digests, res)


CHEAP = ("resource_ineq_adaptive", "resource_ineq_mehrotra",
         "resource_eq_f64", "block_general_nonlinear", "block_general_linear",
         "block_ragged", "schur_ranks")


@pytest.mark.parametrize("cell", CHEAP)
def test_cheap_cell_inputs_match_the_manifest(cell):
    entry, _ = cs.jax_reference(cell)
    assert cs.input_digests(cs.draw_block(cell)) == entry["inputs"]


def test_digests_see_dtype_shape_and_bits():
    a = {"theta": {"Q": np.eye(3, dtype=np.float32)}}
    base = cs.input_digests(a)
    assert list(base) == ["theta/Q"]
    for b in (np.eye(3), np.eye(3, dtype=np.float32).reshape(1, 3, 3),
              np.eye(3, dtype=np.float32) + np.float32(2 ** -23)):
        assert cs.input_digests({"theta": {"Q": b}}) != base
    assert cs.input_digests(copy.deepcopy(a)) == base
