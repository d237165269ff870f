"""Shared pieces of ``tests/test_torch_fleet_parity*.py``: the application
families at the widths of ``chip_smoke.py``'s mixed fleet (phase 16: 64
assets, 96 points of 8 features, 64 states with 2 moments, MPC with nx 4,
nu 2 over 20 steps), drawn by the port's ``sample_*_arrays(42, 2048,
...)``, and both packages' batched solvers on the same numpy rows."""

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from pyipm_tpu import IPMConfig as JCfg
from pyipm_tpu.models import applications as japp
from pyipm_tpu.ops import pallas_ldlt as pk
from pyipm_tpu_torch import IPMConfig
from pyipm_tpu_torch import interop
from pyipm_tpu_torch.models import applications as app

KTOL = 1e-4
# rows 0-15 of every family, fixed before any run
ROWS = tuple(range(16))
# the MPC bucket's five instances at signal -1 on the JAX package's CPU path
# and the port's twelve slowest in the whole f32 bucket on the CPU (21-107
# iterations), classified in ROADMAP Queue 3
MPC_JAX_CPU_FAILS = (96, 297, 370, 607, 1793)
MPC_SLOW = (146, 196, 600, 724, 778, 993, 1181, 1253, 1594, 1695, 1846,
            1938)
# the maximum-entropy instance at signal -2 on the card only (phase 16;
# chip_smoke.CLASSIFIED_SIGNAL_SPLITS): both packages converge it here
MAXENT_CARD_SPLIT = (1415,)

# name: (sampler(dtype) of the whole bucket, port data, JAX data class,
#        port problem, JAX batch solver(cfg), x0 of the port's data)
FAMILIES = {
    "portfolio": (
        lambda dt: app.sample_portfolio_arrays(
            cs.SEED, cs.MIXED["portfolio"], cs.PORTFOLIO_D, dt),
        interop.portfolio_data_from_numpy, japp.PortfolioData,
        lambda: app.make_portfolio_problem(cs.PORTFOLIO_D),
        lambda c: japp.make_portfolio_batch_solver(c, cs.PORTFOLIO_D),
        lambda d, n, dt: app.portfolio_x0(n, cs.PORTFOLIO_D, dt, "cpu")),
    "svm": (
        lambda dt: app.sample_svm_arrays(
            cs.SEED, cs.MIXED["svm"], cs.SVM_N, cs.SVM_FEAT, dt),
        interop.svm_data_from_numpy, japp.SVMData,
        lambda: app.make_svm_problem(cs.SVM_N),
        lambda c: japp.make_svm_batch_solver(c, cs.SVM_N),
        lambda d, n, dt: app.svm_x0(d)),
    "maxent": (
        lambda dt: app.sample_maxent_arrays(
            cs.SEED, cs.MIXED["maxent"], cs.MAXENT_D, cs.MAXENT_M, dt),
        interop.maxent_data_from_numpy, japp.MaxEntData,
        lambda: app.make_maxent_problem(cs.MAXENT_D, cs.MAXENT_M),
        lambda c: japp.make_maxent_batch_solver(c, cs.MAXENT_D),
        lambda d, n, dt: app.maxent_x0(n, cs.MAXENT_D, dt, "cpu")),
    "mpc": (
        lambda dt: app.sample_mpc_arrays(
            cs.SEED, cs.MIXED["mpc"], cs.MPC_NX, cs.MPC_NU, dt),
        interop.mpc_data_from_numpy, japp.MPCData,
        lambda: app.make_mpc_problem(cs.MPC_T, cs.MPC_NU),
        lambda c: japp.make_mpc_batch_solver(c, cs.MPC_T),
        lambda d, n, dt: app.mpc_x0(n, cs.MPC_T, cs.MPC_NU, dt, "cpu")),
}


def rows_of(name, rows, dtype="float32"):
    """The numpy arrays of ``rows`` of the family's phase-16 bucket."""
    arr = FAMILIES[name][0](np.dtype(dtype))
    return {k: v[list(rows)] for k, v in arr.items()}


def _port_data(name, arr, dtype):
    _, to_port, _, _, _, x0 = FAMILIES[name]
    data = to_port(arr, device="cpu")
    n = len(next(iter(arr.values())))
    return data, x0(data, n, np.dtype(dtype))


def port_x0(name, arr, dtype="float32"):
    """The family's start for ``arr``'s rows, as numpy."""
    return _port_data(name, arr, dtype)[1].numpy()


def solve_port(name, arr, dtype="float32"):
    data, x0 = _port_data(name, arr, dtype)
    return app.BatchSolver(FAMILIES[name][3](), IPMConfig(
        float_dtype=dtype, verbosity=0, Ktol=KTOL))(x0, data)


def solve_jax(name, arr, x0, dtype="float32", tpu_path=False):
    """The JAX package's batched solve.  ``tpu_path``: the dispatch it
    takes on a TPU (the Pallas factor and solve kernels for f32 systems
    of n <= 64, pallas_ldlt.py:319-331), run in interpret mode as its own
    kernel tests run them on the CPU; otherwise its CPU path (the unrolled
    factor and ``ldlt_solve_inv``)."""
    _, _, jcls, _, jbatch, _ = FAMILIES[name]
    jdata = jcls(*(jnp.asarray(arr[k]) for k in jcls._fields))
    fn = jbatch(JCfg(float_dtype=dtype, verbosity=0, Ktol=KTOL))
    if not tpu_path:
        return fn(jnp.asarray(x0), jdata)
    from jax.experimental.pallas import tpu as pltpu
    dispatch = pk._lane_dispatch
    pk._lane_dispatch = (lambda n, batch, dt: dt == jnp.float32
                         and n <= pk.LANE_MAX_N)
    try:
        with pltpu.force_tpu_interpret_mode():
            return jax.block_until_ready(fn(jnp.asarray(x0), jdata))
    finally:
        pk._lane_dispatch = dispatch


def hold_family(name, rows):
    """The port against the JAX package on ``rows`` in float32: every
    signal equal and in {1, 2}, iteration counts equal on at least 15 of
    ``ROWS``, x within 2e-3 (1 + |x|)."""
    arr = rows_of(name, rows)
    port = solve_port(name, arr)
    jres = solve_jax(name, arr, port_x0(name, arr))
    sig = port.signal.numpy()
    np.testing.assert_array_equal(np.asarray(jres.signal), sig)
    assert np.all(np.isin(sig, (1, 2))), sig
    n = len(ROWS)
    same = int(np.sum(np.asarray(jres.iter_count)[:n]
                      == port.iter_count.numpy()[:n]))
    assert same >= 15, (port.iter_count, jres.iter_count)
    assert rel_dx(port.x.numpy(), jres.x).max() <= 2e-3


def rel_dx(x, xr):
    """Per-row max |x - xr| / (1 + |xr|)."""
    x, xr = np.asarray(x), np.asarray(xr)
    return (np.abs(x - xr) / (1.0 + np.abs(xr))).max(-1)
