"""The slice end to end: the port's ``solve_batch`` (pyipm_tpu_torch)
against the JAX package's vmapped fleet solver on the same numpy-seeded
QP instances, plus the example-7 transcript pin, batch-of-one parity, the
configuration carried across, and an import check that the port never
pulls in jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models.random_nlp import QPData as JQP  # noqa: E402
from pyipm_tpu.models.random_nlp import make_qp_batch_solver  # noqa: E402
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as J_REF,
)
from pyipm_tpu_torch import IPMConfig, solve, solve_batch  # noqa: E402
from pyipm_tpu_torch.interop import (  # noqa: E402
    config_from_dict, qpdata_from_numpy, result_to_numpy,
)
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem, sample_qp_arrays,
)
from pyipm_tpu_torch.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as T_REF,
)

B, D, NLIN = 8, 8, 4
FIELDS = ("x", "s", "lda", "fval", "signal", "iter_count")


def _fleet(dtype):
    """The same fleet through both packages, as numpy dicts."""
    arr = sample_qp_arrays(0, B, D, NLIN, np.dtype(dtype))
    x0 = np.zeros((B, D), dtype)
    jcfg = JCfg(float_dtype=dtype, verbosity=0)
    jdata = JQP(*(jnp.asarray(arr[k]) for k in JQP._fields))
    jr = make_qp_batch_solver(jcfg, D, NLIN)(jnp.asarray(x0), jdata)
    want = {k: np.asarray(getattr(jr, k)) for k in FIELDS}
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    tr = solve_batch(make_qp_problem(D, NLIN), torch.as_tensor(x0), cfg,
                     params=qpdata_from_numpy(jdata, device="cpu"))
    return result_to_numpy(tr), want, arr


@pytest.fixture(scope="module")
def fleet64():
    return _fleet("float64")


def test_fleet_f64_matches_jax_per_instance(fleet64):
    got, want, _ = fleet64
    np.testing.assert_array_equal(got["signal"], want["signal"])
    np.testing.assert_array_equal(got["iter_count"], want["iter_count"])
    assert np.all(np.isin(got["signal"], (1, 2)))
    for k in ("x", "s", "lda"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-8,
                                   err_msg=k)
    np.testing.assert_allclose(got["fval"], want["fval"], rtol=0, atol=1e-10)


def test_fleet_f32_matches_jax():
    got, want, _ = _fleet("float32")
    np.testing.assert_array_equal(got["signal"], want["signal"])
    np.testing.assert_allclose(got["x"], want["x"], rtol=0, atol=1e-3)


def test_batch_of_one_equals_instance_in_batch(fleet64):
    got, _, arr = fleet64
    problem = make_qp_problem(D, NLIN)
    cfg = IPMConfig(float_dtype="float64", verbosity=0)
    for i in (0, 5):
        data_i = qpdata_from_numpy({k: v[i] for k, v in arr.items()},
                                   device="cpu")
        r = solve(problem, torch.zeros(D, dtype=torch.float64), cfg,
                  params=data_i)
        assert int(r.signal) == int(got["signal"][i])
        assert int(r.iter_count) == int(got["iter_count"][i])
        np.testing.assert_allclose(r.x.numpy(), got["x"][i], rtol=0,
                                   atol=1e-12)


def test_example7_transcript_pin():
    """Example 7 from x0 = [0.2, 0.5, 0.3] at reference defaults + Ftol:
    Ktol convergence in <= 6 iterations (test_transcript_parity.py), and
    the same signal, iteration count and solution as the JAX solver."""
    x0 = np.array([0.2, 0.5, 0.3])
    spec = T_REF[7]
    r = solve(spec.make(), torch.as_tensor(x0),
              IPMConfig(Ftol=1e-8, verbosity=0))
    assert int(r.signal) == 1
    assert int(r.iter_count) <= 6
    assert spec.distance_to_truth(r.x.numpy()) <= 5e-6
    jr = j_make_solver(J_REF[7].make(), JCfg(Ftol=1e-8, verbosity=0))(
        jnp.asarray(x0))
    assert int(r.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("kw,match", [
    (dict(trace_metrics=True), "trace_metrics"),
])
def test_unported_options_raise(kw, match):
    """No IPMConfig option raises any more: ``trace_metrics``, the last
    that did, now returns the per-iteration history of every instance."""
    cfg = IPMConfig(verbosity=0, **kw)
    assert getattr(cfg, match)
    x0 = torch.as_tensor(np.array([[0.2, 0.5, 0.3], [0.3, 0.3, 0.4]]))
    res = solve_batch(T_REF[7].make(), x0, cfg)
    assert res.hist.kkt.shape == (2, cfg.niter * cfg.miter, 4)
    assert np.all(np.isin(res.signal.numpy(), (1, 2)))


def test_config_carries_across():
    jcfg = JCfg(float_dtype="float32", Ktol=1e-5, mu=0.3, verbosity=0)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    for name in ("eps", "reg_coef", "delta0", "mu_floor", "xtol"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert cfg.torch_dtype == torch.float32
    with pytest.raises(ValueError):
        IPMConfig(tau=1.5)


def test_port_never_imports_jax():
    root = Path(__file__).resolve().parent.parent
    code = ("import sys, pyipm_tpu_torch, pyipm_tpu_torch.interop, "
            "pyipm_tpu_torch.models.random_nlp, "
            "pyipm_tpu_torch.models.reference_problems, "
            "pyipm_tpu_torch.ops.small_ldlt, pyipm_tpu_torch.ops._build, "
            "pyipm_tpu_torch.ops.large_ldlt, pyipm_tpu_torch.api, "
            "pyipm_tpu_torch.cli, pyipm_tpu_torch.core.lbfgs, "
            "pyipm_tpu_torch.__main__, pyipm_tpu_torch.parallel.fleet, "
            "pyipm_tpu_torch.utils.profiling, "
            "pyipm_tpu_torch.utils.checkpoint, "
            "pyipm_tpu_torch.models.applications, "
            "pyipm_tpu_torch.examples.quickstart, "
            "pyipm_tpu_torch.examples.batched_fleet, "
            "pyipm_tpu_torch.examples.heterogeneous_fleet, "
            "pyipm_tpu_torch.examples.mpc_receding_horizon; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'pyipm_tpu.')) "
            "or m == 'pyipm_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_samplers_default_to_the_card(monkeypatch):
    """With no card, the data entry points raise unless the caller names
    the CPU; they never fall back to it quietly."""
    from pyipm_tpu_torch.interop import dense_from_numpy
    from pyipm_tpu_torch.models.random_nlp import (
        qp_data, sample_dense_arrays, sample_dense_nlp, sample_qp_batch,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = sample_qp_arrays(0, 2, 3)
    dense = sample_dense_arrays(0, 6, 2, hidden=4)
    for make in (lambda **kw: sample_qp_batch(0, 2, 3, **kw),
                 lambda **kw: qp_data(arr, **kw),
                 lambda **kw: qpdata_from_numpy(arr, **kw),
                 lambda **kw: sample_dense_nlp(0, 6, 2, hidden=4, **kw),
                 lambda **kw: dense_from_numpy(dense, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert all(t.device.type == "cpu" for t in make(device="cpu"))


def test_shifted_gradient_override_matches_jax():
    """A user gradient (shifted, so the optimum moves) is what both
    packages' solvers use: same signal, iteration count and solution."""
    import jax

    from pyipm_tpu import make_problem as j_make_problem
    from pyipm_tpu_torch import make_problem

    jspec, tspec = J_REF[7], T_REF[7]
    shift = np.array([0.01, -0.02, 0.0])
    jprob = j_make_problem(jspec.f, 3, ce=jspec.ce, ci=jspec.ci,
                           df=lambda x: jax.grad(jspec.f)(x) + shift)
    tprob = make_problem(
        tspec.f, 3, ce=tspec.ce, ci=tspec.ci,
        df=lambda x, p: torch.func.grad(tspec.f)(x, p)
        + torch.as_tensor(shift))
    x0 = np.array([0.2, 0.5, 0.3])
    jr = j_make_solver(jprob, JCfg(Ftol=1e-8, verbosity=0))(jnp.asarray(x0))
    tr = solve(tprob, torch.as_tensor(x0), IPMConfig(Ftol=1e-8, verbosity=0))
    assert int(tr.signal) == int(jr.signal) and int(tr.signal) in (1, 2)
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-10)
    assert jspec.distance_to_truth(np.asarray(jr.x)) > 1e-3


@pytest.mark.parametrize("num", [1, 3])
def test_unconstrained_and_equality_only_paths_match_jax(num):
    """The solver branches the QP fleet never takes (no constraints: the
    muTol exit is convergence; no inequalities: the per-iteration Ftol
    test) give the JAX package's signal, iteration count and solution, on
    reference problems 1 (unconstrained) and 3 (equality only)."""
    x0 = J_REF[num].sample_x0(np.random.default_rng(42))
    jr = j_make_solver(J_REF[num].make(), JCfg(Ftol=1e-8, verbosity=0))(
        jnp.asarray(x0))
    tr = solve(T_REF[num].make(), torch.as_tensor(x0),
               IPMConfig(Ftol=1e-8, verbosity=0))
    assert int(tr.signal) == int(jr.signal) and int(tr.signal) in (1, 2)
    assert int(tr.iter_count) == int(jr.iter_count)
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-10)
