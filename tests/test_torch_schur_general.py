"""The port's block-separable Schur solver beyond the JAX parity of
tests/test_torch_schur.py: the remaining JAX configurations (coupling
inequality under Mehrotra, ragged masks, the overdetermined
least-squares init, a JAX state paused at 3 iterations finished in the
port, resource allocation with both caps), then the port against itself
where the JAX tests hold the JAX package against itself (test_schur.py
:317, :355, :383, :664, :860, :897), and the checkpoint of a block
state (the per-block L-BFGS mode: tests/test_torch_schur_lbfgs.py)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models import applications as JA  # noqa: E402
from pyipm_tpu.parallel import schur as JS  # noqa: E402
from pyipm_tpu_torch import interop  # noqa: E402
from pyipm_tpu_torch.config import IPMConfig as TCfg  # noqa: E402
from pyipm_tpu_torch.models import applications as TA  # noqa: E402
from pyipm_tpu_torch.parallel import schur as TS  # noqa: E402
from pyipm_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_state, save_state,
)

RTOL = 1e-8
F64 = dict(float_dtype="float64", verbosity=0, niter=10, miter=25)


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",),
                             axis_types=(jax.sharding.AxisType.Auto,))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if b.size:
        scale = max(1.0, float(np.max(np.abs(b))))
        assert np.max(np.abs(a - b)) <= rtol * scale, \
            f"max diff {np.max(np.abs(a - b))}"


def _held(jres, tres, signals=(1,)):
    assert int(tres.signal) == int(jres.signal) in signals, (
        int(tres.signal), int(jres.signal))
    assert int(tres.iter_count) == int(jres.iter_count)
    for k in ("x", "s", "le", "li", "lc", "sc", "lci"):
        _close(getattr(tres, k).numpy(), getattr(jres, k))


def _port(tspec, theta, ccdata, **kw):
    fn = TS.make_block_solver(tspec, None, TCfg(**dict(F64, **kw)),
                              device="cpu")
    th, cc = interop.block_data_from_numpy(theta, ccdata, device="cpu")
    return fn, th, cc


def _general(key, d=3, **kw):
    spec, theta, ccdata, x0 = JS.sample_block_general(
        jax.random.key(key), 8, d, me=1, ni=2, p=2, mc=1, **kw)
    th, cc = interop.block_data_from_numpy(theta, ccdata, device="cpu")
    return spec, th, cc, torch.tensor(np.asarray(x0))


# ----------------------------------------------------------------------
# against the JAX package
def test_coupling_inequality_mehrotra_matches_jax():
    """Box blocks (identity Jacobian) under a linear global cap, the
    Mehrotra centering over block and coupling slacks (test_schur.py
    :513)."""
    K, d, pdim, mci = 8, 3, 2, 1
    kq, kc, kg, kx = jax.random.split(jax.random.key(22), 4)
    Q0 = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, pdim, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": jnp.einsum("kij,klj->kil", Q0, Q0) + jnp.eye(d),
             "c": jax.random.normal(kc, (K, d), jnp.float64), "G": Gl,
             "lb": jnp.full((K, d), -2.0, jnp.float64)}
    ccdata = {"u0": jnp.einsum("kpd,kd->p", Gl, xfeas)}
    kw = dict(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ci_blk=lambda xk, th: xk - th["lb"], ni=d, ci_identity=True,
        g_blk=lambda xk, th: th["G"] @ xk,
        cci=lambda u, ccd: 1.0 - (u - ccd["u0"])[:mci], mci=mci, p=pdim)
    x0 = jnp.zeros((K, d), jnp.float64)
    jres = JS.make_block_solver(JS.BlockNLP(**kw), _mesh1(), JCfg(
        **F64, mu_strategy="mehrotra"))(x0, theta, ccdata=ccdata)
    fn, th, cc = _port(TS.BlockNLP(**kw), theta, ccdata,
                       mu_strategy="mehrotra")
    _held(jres, fn(torch.tensor(np.asarray(x0)), th, cc))


def test_ragged_masks_match_jax():
    """Ragged per-block counts under masks, junk in the inactive rows
    (test_schur.py:591)."""
    spec, theta, ccdata, x0, _, _ = JS.sample_block_ragged(
        jax.random.key(21), 8, 4, me=2, ni=3, p=2, mc=1)
    jres = JS.make_block_solver(spec, _mesh1(), JCfg(**F64))(
        x0, theta, ccdata=ccdata)
    fn, th, cc = _port(TS.block_ragged_spec(4, 2, 3, 2, 1), theta, ccdata)
    _held(jres, fn(torch.tensor(np.asarray(x0)), th, cc))


def test_overdetermined_ls_init_matches_jax():
    """Fewer multipliers than primal variables: the least-squares init's
    normal-equation branch (test_schur.py:696)."""
    K, d, me, p, mc = 8, 4, 1, 2, 1
    kq, kc, ke, kg, kx = jax.random.split(jax.random.key(31), 5)
    G = jax.random.normal(kq, (K, d, d)) / np.sqrt(d)
    Ce = jax.random.normal(ke, (K, me, d)) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, p, d)) / np.sqrt(K * d)
    xf = jax.random.normal(kx, (K, d)) * 0.1
    theta = {"Q": jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d)[None],
             "c": jax.random.normal(kc, (K, d)), "Ce": Ce,
             "e": jnp.einsum("kmd,kd->km", Ce, xf), "G": Gl}
    ccdata = {"u0": jnp.einsum("kpd,kd->p", Gl, xf)}
    kw = dict(f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk)
              + th["c"] @ xk, d=d,
              ce_blk=lambda xk, th: th["Ce"] @ xk - th["e"], me=me,
              g_blk=lambda xk, th: th["G"] @ xk,
              cc=lambda u, ccd: (u - ccd["u0"])[:mc], p=p, mc=mc)
    x0 = jnp.zeros((K, d))
    jres = JS.make_block_solver(JS.BlockNLP(**kw), _mesh1(), JCfg(**F64))(
        x0, theta, ccdata=ccdata)
    fn, th, cc = _port(TS.BlockNLP(**kw), theta, ccdata)
    _held(jres, fn(torch.tensor(np.asarray(x0)), th, cc), signals=(1, 2))


def test_jax_paused_block_state_finishes_in_the_port():
    """A JAX block state paused by ``run_budget`` at 3 iterations, carried
    across by ``interop.block_state_from_numpy``, finished by the port:
    the JAX straight solve's signal, iterations and solution."""
    spec, theta, ccdata, x0 = JS.sample_block_general(
        jax.random.key(14), 8, 3, me=1, ni=2, p=2, mc=1)
    jfn = JS.make_block_solver(spec, _mesh1(), JCfg(**F64))
    straight = jfn(x0, theta, ccdata=ccdata)
    paused = jfn.run_budget(jfn.init_state(x0, theta, ccdata=ccdata),
                            theta, ccdata=ccdata, max_new_iters=3)
    assert int(paused.signal) == 0 and int(paused.iter_count) == 3
    st = interop.block_state_from_numpy(
        jax.tree.map(np.asarray, paused), device="cpu")
    fn, th, cc = _port(TS.block_general_spec(3, 1, 2, 2, 1), theta, ccdata)
    _held(straight, fn.finalize(fn.run(st, th, cc), th, cc))


@pytest.mark.parametrize("cap", ["eq", "ineq"])
def test_resource_allocation_matches_jax(cap):
    """The resource-allocation family with a binding pool and with a cap
    (test_applications.py:100, :133)."""
    K, d, nres = 16, 6, 3
    data = JA.sample_resource_alloc(jax.random.key(0), K, d, nres=nres,
                                    dtype=jnp.float64)
    x0 = jnp.full((K, d), 1.0, jnp.float64)
    jres = JS.make_block_solver(
        JA.make_resource_alloc_spec(d, nres=nres, cap=cap), _mesh1(),
        JCfg(**F64))(x0, data.theta, ccdata=data.ccdata)
    tdata = interop.resource_alloc_from_numpy(data, device="cpu")
    tres = TS.make_block_solver(
        TA.make_resource_alloc_spec(d, nres=nres, cap=cap), None,
        TCfg(**F64), device="cpu")(torch.tensor(np.asarray(x0)),
                                   tdata.theta, tdata.ccdata)
    _held(jres, tres)
    pool = torch.einsum("krd,kd->r", tdata.theta["R"], tres.x)
    assert torch.all(tres.x >= -1e-8)
    assert torch.all(pool <= tdata.ccdata["budget"] + 1e-4)


# ----------------------------------------------------------------------
# the port against itself
def test_pause_checkpoint_resume_equals_straight(tmp_path):
    """run_budget(3), save, restore into a fresh state, run: bit for bit
    the straight solve (test_schur.py:317)."""
    spec, th, cc, x0 = _general(14)
    fn = TS.make_block_solver(TS.block_general_spec(3, 1, 2, 2, 1), None,
                              TCfg(**F64), device="cpu")
    straight = fn(x0, th, cc)
    st = fn.run_budget(fn.init_state(x0, th, cc), th, cc, max_new_iters=3)
    assert int(st.signal[0]) == 0
    save_state(str(tmp_path / "blk"), st)
    st2 = restore_state(str(tmp_path / "blk"), fn.init_state(x0, th, cc))
    res = fn.finalize(fn.run(st2, th, cc), th, cc)
    assert int(res.signal) == int(straight.signal) == 1
    assert int(res.iter_count) == int(straight.iter_count)
    assert torch.equal(res.x, straight.x) and torch.equal(res.lc,
                                                          straight.lc)


def test_trace_metrics_records_the_block_solve():
    spec, th, cc, x0 = _general(15)
    cfg = TCfg(float_dtype="float64", verbosity=0, niter=8, miter=20,
               trace_metrics=True)
    res = TS.make_block_solver(TS.block_general_spec(3, 1, 2, 2, 1), None,
                               cfg, device="cpu")(x0, th, cc)
    n = int(res.iter_count)
    kkt = res.hist.kkt.numpy()
    assert int(res.signal) == 1 and kkt.shape == (160, 4)
    assert np.all(kkt[:n].sum(axis=1) > 0) and np.all(kkt[n:] == 0)
    np.testing.assert_allclose(kkt[n - 1], res.kkt.numpy(), rtol=1e-12)
    assert np.all(res.hist.delta.numpy()[n:] == 0)
    untraced = TS.make_block_solver(
        TS.block_general_spec(3, 1, 2, 2, 1), None,
        cfg.replace(trace_metrics=False), device="cpu")(x0, th, cc)
    assert torch.equal(untraced.x, res.x)


def test_ci_identity_matches_general_jacobian():
    """Bounds declared as an identity Jacobian against the same bounds
    through the general path (test_schur.py:383)."""
    K, d, mc = 8, 4, 2
    g = torch.Generator().manual_seed(16)
    spec, data, x0 = TS.sample_separable(g, K, d, mc, dtype=torch.float64,
                                         device="cpu")
    theta = {"Q": data.theta["Q"], "c": data.theta["c"], "A": data.A,
             "lb": data.lb}
    kw = dict(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        d=d, ci_blk=lambda xk, th: xk - th["lb"], ni=d,
        g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], p=mc, mc=mc)
    cfg = TCfg(float_dtype="float64", verbosity=0, niter=8, miter=20)
    r = [TS.make_block_solver(TS.BlockNLP(ci_identity=f, **kw), None, cfg,
                              device="cpu")(x0, theta, {"b": data.b})
         for f in (True, False)]
    assert int(r[0].signal) == int(r[1].signal) == 1
    assert int(r[0].iter_count) == int(r[1].iter_count)
    np.testing.assert_allclose(r[0].x.numpy(), r[1].x.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_all_ones_masks_match_unmasked():
    """All-ones masks are the unmasked solver (test_schur.py:664)."""
    spec, th, cc, x0 = _general(23)
    tspec = TS.block_general_spec(3, 1, 2, 2, 1)
    cfg = TCfg(**F64)
    res_u = TS.make_block_solver(tspec, None, cfg, device="cpu")(x0, th, cc)
    th_m = dict(th, ce_mask=torch.ones((8, 1), dtype=torch.float64),
                ci_mask=torch.ones((8, 2), dtype=torch.float64))
    res_m = TS.make_block_solver(
        dataclasses.replace(tspec, ce_mask_key="ce_mask",
                            ci_mask_key="ci_mask"), None, cfg,
        device="cpu")(x0, th_m, cc)
    assert int(res_m.signal) == int(res_u.signal) == 1
    assert int(res_m.iter_count) == int(res_u.iter_count)
    np.testing.assert_allclose(res_m.x.numpy(), res_u.x.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("strategy", ["adaptive", "mehrotra"])
def test_linear_coupling_declared_matches_general(strategy):
    """Declaring an affine coupling fuses three all-reduces into one and
    solves the same problem (test_schur.py:860)."""
    spec, th, cc, x0 = _general(21, d=4, nonlinear_cc=False)
    lin = TS.block_general_spec(4, 1, 2, 2, 1, nonlinear_cc=False)
    cfg = TCfg(**F64, mu_strategy=strategy)
    fl = TS.make_block_solver(lin, None, cfg, device="cpu")
    fg = TS.make_block_solver(dataclasses.replace(lin, linear_coupling=False),
                              None, cfg, device="cpu")
    r_lin, r_gen = fl(x0, th, cc), fg(x0, th, cc)
    assert int(r_lin.signal) == int(r_gen.signal) == 1
    assert int(r_lin.iter_count) == int(r_gen.iter_count)
    np.testing.assert_allclose(r_lin.x.numpy(), r_gen.x.numpy(), rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(r_lin.lc.numpy(), r_gen.lc.numpy(),
                               rtol=1e-7, atol=1e-8)
    assert fl.reducer.total < fg.reducer.total


@pytest.mark.parametrize("knobs", [{"schur_refine_steps": 0},
                                   {"schur_refine_steps": 1,
                                    "schur_refine_guard": False},
                                   {"schur_refine_steps": 3}])
def test_refinement_knobs_solve(knobs):
    """The refinement knobs still solve, to the default's optimum
    (test_schur.py:897)."""
    spec, th, cc, x0 = _general(31)
    tspec = TS.block_general_spec(3, 1, 2, 2, 1)
    ref = TS.make_block_solver(tspec, None, TCfg(**F64), device="cpu")(
        x0, th, cc)
    r = TS.make_block_solver(tspec, None, TCfg(**F64, **knobs),
                             device="cpu")(x0, th, cc)
    assert int(ref.signal) == int(r.signal) == 1
    np.testing.assert_allclose(r.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=5e-4)


def test_samplers_draw_feasible_instances():
    """The port's own samplers (a torch.Generator on a device) give
    instances the solver converges on, in float32 as on the card."""
    g = torch.Generator().manual_seed(0)
    cfg = TCfg(float_dtype="float32", verbosity=0)
    spec, data, x0 = TS.sample_separable_eq(g, 8, 4, 2, me=1, device="cpu")
    res = TS.make_separable_solver(spec, None, cfg, device="cpu")(x0, data)
    assert int(res.signal) in (1, 2)
    spec, th, cc, x0, me_k, ni_k = TS.sample_block_ragged(
        g, 8, dtype=torch.float32, device="cpu")
    assert th["ce_mask"].sum() == me_k.sum()
    res = TS.make_block_solver(spec, None, cfg, device="cpu")(x0, th, cc)
    assert int(res.signal) in (1, 2)
    data = TA.sample_resource_alloc(g, 16, 4, nres=2, device="cpu")
    res = TS.make_block_solver(TA.make_resource_alloc_spec(4, 2), None, cfg,
                               device="cpu")(
        torch.ones((16, 4)), data.theta, data.ccdata)
    assert int(res.signal) in (1, 2)
