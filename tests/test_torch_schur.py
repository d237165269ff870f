"""The port's block-separable Schur solver (pyipm_tpu_torch/parallel/
schur.py) against the JAX package's ``make_block_solver`` /
``make_separable_solver`` on the same float64 instances: each instance is
drawn once by the JAX sampler, carried across by ``interop``, and solved
by both (the JAX side on a one-device ``model`` mesh, the port in one
process).  Held: the same signal and iteration count, x, s and the
multipliers within 1e-8 relative.  Configurations of tests/test_schur.py
(:21, :79, :142, :239, :272, :418)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.parallel import schur as JS  # noqa: E402
from pyipm_tpu_torch import interop  # noqa: E402
from pyipm_tpu_torch.config import IPMConfig as TCfg  # noqa: E402
from pyipm_tpu_torch.parallel import schur as TS  # noqa: E402

RTOL = 1e-8


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


def _held(jres, tres, fields=("x", "s", "le", "li", "lc", "sc", "lci")):
    assert int(tres.signal) == int(jres.signal) == 1, (
        int(tres.signal), int(jres.signal), np.asarray(jres.kkt))
    assert int(tres.iter_count) == int(jres.iter_count)
    for k in fields:
        _close(getattr(tres, k).numpy(), getattr(jres, k))
    _close(tres.kkt.numpy(), jres.kkt, rtol=1e-6)


def _block_pair(jspec, tspec, theta, ccdata, x0, **kw):
    cfg = dict(float_dtype="float64", verbosity=0, **kw)
    jres = JS.make_block_solver(jspec, _mesh1(), JCfg(**cfg))(
        x0, theta, ccdata=ccdata)
    th, cc = interop.block_data_from_numpy(theta, ccdata, device="cpu")
    tres = TS.make_block_solver(tspec, None, TCfg(**cfg), device="cpu")(
        torch.tensor(np.asarray(x0)), th, cc)
    return jres, tres


@pytest.mark.parametrize("eq", [False, True])
def test_separable_matches_jax(eq):
    """Box + linear coupling (test_schur.py:21), and with per-block
    equalities (:79)."""
    K, d, mc = 8, 4, (2 if eq else 3)
    if eq:
        spec, data, x0 = JS.sample_separable_eq(jax.random.key(3), K, d, mc,
                                                me=1, dtype=jnp.float64)
        tspec = TS.separable_spec(d, mc, me=1)
    else:
        spec, data, x0 = JS.sample_separable(jax.random.key(0), K, d, mc,
                                             dtype=jnp.float64)
        tspec = TS.separable_spec(d, mc)
    kw = dict(float_dtype="float64", verbosity=0, niter=8, miter=20)
    jres = JS.make_separable_solver(spec, _mesh1(), JCfg(**kw))(x0, data)
    tres = TS.make_separable_solver(tspec, None, TCfg(**kw), device="cpu")(
        torch.tensor(np.asarray(x0)),
        interop.separable_data_from_numpy(data, device="cpu"))
    _held(jres, tres, fields=("x", "s", "z", "le", "lc"))


@pytest.mark.parametrize("strategy", ["adaptive", "mehrotra"])
def test_block_general_nonlinear_coupling_matches_jax(strategy):
    """Per-block equalities and inequalities, nonlinear coupling
    (test_schur.py:142), and its Mehrotra form (:272)."""
    key = 10 if strategy == "adaptive" else 13
    spec, theta, ccdata, x0 = JS.sample_block_general(
        jax.random.key(key), 8, 3, me=1, ni=2, p=2, mc=1)
    jres, tres = _block_pair(spec, TS.block_general_spec(3, 1, 2, 2, 1),
                             theta, ccdata, x0, niter=10, miter=25,
                             mu_strategy=strategy)
    _held(jres, tres)


def test_block_upper_and_lower_bounds_match_jax():
    """Both bounds through the general inequality class, ci = [x - lb;
    ub - x] (test_schur.py:239)."""
    K, d, mc = 8, 3, 2
    kq, kc, ka, kx = jax.random.split(jax.random.key(12), 4)
    G = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", G, G) + jnp.eye(d, dtype=jnp.float64)
    c = 3.0 * jax.random.normal(kc, (K, d), jnp.float64)
    A = jax.random.normal(ka, (K, mc, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": c, "A": A,
             "lb": jnp.full((K, d), -0.5, jnp.float64),
             "ub": jnp.full((K, d), 0.5, jnp.float64)}
    ccdata = {"b": jnp.einsum("kcd,kd->c", A, xfeas)}
    common = dict(d=d, ni=2 * d, p=mc, mc=mc)
    jspec = JS.BlockNLP(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        ci_blk=JS.box_ci("lb", "ub"), g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], **common)
    tspec = TS.BlockNLP(
        f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
        ci_blk=TS.box_ci("lb", "ub"), g_blk=lambda xk, th: th["A"] @ xk,
        cc=lambda u, ccd: u - ccd["b"], **common)
    jres, tres = _block_pair(jspec, tspec, theta, ccdata,
                             jnp.zeros((K, d), jnp.float64), niter=10,
                             miter=25)
    _held(jres, tres)
    x = tres.x.numpy()
    assert np.all(x >= -0.5 - 1e-8) and np.all(x <= 0.5 + 1e-8)


def test_block_coupling_inequality_matches_jax():
    """Nonlinear global caps cci with replicated slacks through the
    bordered Schur complement (test_schur.py:418)."""
    K, d, me, ni, pdim, mc, mci = 8, 3, 1, 2, 2, 1, 2
    kq, kc, ke, ki, kg, kx = jax.random.split(jax.random.key(21), 6)
    Q0 = jax.random.normal(kq, (K, d, d), jnp.float64) / np.sqrt(d)
    Q = jnp.einsum("kij,klj->kil", Q0, Q0) + jnp.eye(d, dtype=jnp.float64)
    Ce = jax.random.normal(ke, (K, me, d), jnp.float64) / np.sqrt(d)
    Ci = jax.random.normal(ki, (K, ni, d), jnp.float64) / np.sqrt(d)
    Gl = jax.random.normal(kg, (K, pdim, d), jnp.float64) / np.sqrt(K * d)
    xfeas = jax.random.normal(kx, (K, d), jnp.float64) * 0.1
    theta = {"Q": Q, "c": jax.random.normal(kc, (K, d), jnp.float64),
             "Ce": Ce, "e": jnp.einsum("kmd,kd->km", Ce, xfeas), "Ci": Ci,
             "di": 1.0 - jnp.einsum("knd,kd->kn", Ci, xfeas), "G": Gl}
    ccdata = {"u0": jnp.einsum("kpd,kd->p", Gl, xfeas)}

    def spec_of(S, stack):
        def cci(u, ccd):
            v = u - ccd["u0"]
            return 0.5 - stack([v[0] + 0.1 * (v ** 2).sum(),
                                -v[1] + 0.05 * (v ** 2).sum()])
        return S.BlockNLP(
            f_blk=lambda xk, th: 0.5 * xk @ (th["Q"] @ xk) + th["c"] @ xk,
            d=d, ce_blk=lambda xk, th: th["Ce"] @ xk - th["e"], me=me,
            ci_blk=lambda xk, th: th["Ci"] @ xk + th["di"], ni=ni,
            g_blk=lambda xk, th: th["G"] @ xk,
            cc=lambda u, ccd: (u - ccd["u0"])[:mc], p=pdim, mc=mc,
            cci=cci, mci=mci)

    jres, tres = _block_pair(spec_of(JS, jnp.stack),
                             spec_of(TS, torch.stack), theta, ccdata,
                             jnp.zeros((K, d), jnp.float64), niter=10,
                             miter=25)
    _held(jres, tres)
