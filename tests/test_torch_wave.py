"""Pause/resume (``BatchSolver.run_budget``) and the wave-compacted fleet
of the port (pyipm_tpu_torch) against the JAX package, on the CPU.

Tolerances: a budgeted solve against a straight one, and the JAX state
finished in the port, in float64: the same signal and iteration count, x
within 1e-12 (port against port) or 1e-10 (JAX pause, port finish).  The
wave fleet against the lockstep fleet and the JAX wave solver, float32:
the contract of the JAX package's own test (test_wave.py:70-86) -- the
same convergence set, iteration counts equal on >= 95%, converged x within
2e-3 -- and, per instance, whether the two agree bit for bit (asserted
where they do on the CPU: the port's wave against its lockstep)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models.random_nlp import QPData as JQP  # noqa: E402
from pyipm_tpu.models.random_nlp import (  # noqa: E402
    make_qp_problem as j_qp_problem,
)
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    get_problem as j_get_problem,
)
from pyipm_tpu.parallel.batch import (  # noqa: E402
    make_wave_batch_solver as j_wave,
)
from pyipm_tpu_torch import (  # noqa: E402
    IPMConfig, _sync, make_wave_batch_solver, solve_batch,
)
from pyipm_tpu_torch.core.solver import BatchSolver  # noqa: E402
from pyipm_tpu_torch.interop import (  # noqa: E402
    qpdata_from_numpy, reference_problem, solver_state_from_numpy,
)
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem, sample_qp_arrays,
)

CFG64 = IPMConfig(Ftol=1e-8, verbosity=0)


def _x0(num, seed=42):
    return torch.as_tensor(
        j_get_problem(num).sample_x0(np.random.default_rng(seed)))[None]


def _budget_matches_full(nums):
    """Chunks of 3 iterations to the end against one straight solve."""
    for num in nums:
        solver = BatchSolver(reference_problem(num).make(), CFG64)
        x0 = _x0(num)
        full = solver(x0)
        st = solver.init_state(x0)
        chunks = 0
        while int(st.signal[0]) == 0 and chunks < 1000:
            st = solver.run_budget(st, 3)
            chunks += 1
        res = solver.finalize(st)
        assert int(res.signal) == int(full.signal)
        assert int(res.signal) in (1, 2)
        assert int(res.iter_count) == int(full.iter_count)
        np.testing.assert_allclose(res.x.numpy(), full.x.numpy(), rtol=0,
                                   atol=1e-12)


def test_run_budget_pause_resume_matches_full():
    _budget_matches_full((5, 10))      # inequalities only; mixed


@pytest.mark.slow
def test_run_budget_pause_resume_all_classes():
    _budget_matches_full((1, 7))       # unconstrained; eq + ineq


def test_run_budget_limit_is_per_instance():
    """The limit is each instance's own iter_count plus the budget: an
    instance behind the others is not held back by them, and no instance
    runs past its limit."""
    solver = BatchSolver(reference_problem(5).make(), CFG64)
    x0 = torch.cat([_x0(5, s) for s in range(4)])
    st = solver.run_budget(solver.init_state(x0), 2)
    assert torch.all(st.iter_count <= 2)
    before = st.iter_count.clone()
    after = solver.run_budget(st, 1).iter_count
    assert torch.all(after <= before + 1) and torch.any(after > before)
    assert torch.equal(st.iter_count, before)     # the input is untouched


def _wave_against_lockstep_and_jax(**waves):
    """B = 48 random QPs, D = 8, L = 3, float32, from x0 = 0, through both
    packages' wave solvers with the wave settings ``waves``; returns the
    port's result and its number of waves."""
    B, D, L = 48, 8, 3
    arr = sample_qp_arrays(7, B, D, L, np.float32)
    x0 = np.zeros((B, D), np.float32)
    cfg = IPMConfig(float_dtype="float32", verbosity=0)
    data = qpdata_from_numpy(arr, device="cpu")
    problem = make_qp_problem(D, L)
    lock = solve_batch(problem, torch.as_tensor(x0), cfg, params=data)
    _sync.COUNTS["waves"] = 0
    wave = make_wave_batch_solver(problem, cfg, **waves)(
        torch.as_tensor(x0), data)
    n_waves = _sync.COUNTS["waves"]
    assert torch.equal(wave.signal, lock.signal)
    assert torch.equal(wave.iter_count, lock.iter_count)
    assert torch.equal(wave.x, lock.x)
    assert np.all(np.isin(wave.signal.numpy(), (1, 2)))

    jdata = JQP(*(jnp.asarray(arr[k]) for k in JQP._fields))
    jres = j_wave(config=JCfg(float_dtype="float32", verbosity=0),
                  family=lambda d: j_qp_problem(d, D, L), min_pad=B,
                  **waves)(jnp.asarray(x0), jdata)
    js, ts = np.asarray(jres.signal), wave.signal.numpy()
    np.testing.assert_array_equal(np.isin(ts, (1, 2)), np.isin(js, (1, 2)))
    same = np.mean(np.asarray(jres.iter_count) == wave.iter_count.numpy())
    assert same >= 0.95, same
    ok = np.isin(js, (1, 2))
    np.testing.assert_allclose(wave.x.numpy()[ok], np.asarray(jres.x)[ok],
                               rtol=2e-3, atol=2e-3)
    return wave, n_waves


def test_wave_matches_lockstep_and_jax_wave_qp_family():
    """The port's wave fleet against its lockstep fleet (bit for bit on
    the CPU) and against the JAX package's wave solver (the JAX contract
    above)."""
    _wave_against_lockstep_and_jax(first_wave=8, wave=16)


@pytest.mark.parametrize("waves", [
    dict(first_wave=1, wave=1, wave_growth=2.0, max_wave=2),
    dict(first_wave=2, wave=2, max_waves=3),
], ids=["growth", "max_waves"])
def test_wave_budget_schedule(waves):
    """``wave_growth`` and ``max_wave`` (budgets 1, 1, 2, 2, ...) and
    ``max_waves`` (after 3 waves the remainder runs unbudgeted): the
    results as above, and the waves the schedule implies for the longest
    solve.  Each active instance has run exactly the budgets summed, and
    one whose last iteration uses up a budget is paused before the step
    that sets its signal, so it takes one more wave: for the longest
    solve here, 10 iterations, seven waves with growth (eleven without
    it, five without the cap) and four with max_waves (six without it)."""
    wave, n_waves = _wave_against_lockstep_and_jax(**waves)
    longest = int(wave.iter_count.max())
    done, budget, expect = waves["first_wave"], float(waves["wave"]), 1
    while done <= longest and expect <= waves.get("max_waves", 1000):
        done += int(budget)
        expect += 1
        budget = min(budget * waves.get("wave_growth", 1.0),
                     float(max(waves.get("max_wave", 512), waves["wave"])))
    assert n_waves == expect, (n_waves, expect, longest)


def test_wave_fixed_problem_matches_single_solves():
    """No per-instance data (JAX test_wave.py:89): the wave results of
    problem 7 from six starts equal each start's own solve."""
    problem = reference_problem(7).make()
    rng = np.random.default_rng(3)
    spec = j_get_problem(7)
    x0s = torch.as_tensor(np.stack([spec.sample_x0(rng) for _ in range(6)]))
    res = make_wave_batch_solver(problem, CFG64, first_wave=4, wave=8)(x0s)
    single = BatchSolver(problem, CFG64)
    for i in range(6):
        ri = single(x0s[i:i + 1])
        assert int(res.signal[i]) == int(ri.signal)
        assert int(res.iter_count[i]) == int(ri.iter_count)
        np.testing.assert_allclose(res.x[i].numpy(), ri.x[0].numpy(),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("num", [5, 10])
def test_jax_paused_state_finishes_in_the_port(num):
    """A solve paused by the JAX package's run_budget(3), carried across by
    ``solver_state_from_numpy`` and finished by the port's ``run``, gives
    the JAX straight solve's signal and iteration count, x within 1e-10."""
    spec = j_get_problem(num)
    jcfg = JCfg(Ftol=1e-8, verbosity=0)
    fn = j_make_solver(spec.make(dtype=np.float64), jcfg, jit=False)
    x0 = jnp.asarray(spec.sample_x0(np.random.default_rng(42)))
    full = jax.jit(fn)(x0)
    paused = jax.jit(fn.run_budget)(fn.init_state(x0), 3)
    assert int(paused.signal) == 0 and int(paused.iter_count) == 3
    st = solver_state_from_numpy(paused, device="cpu")
    assert st.lbfgs is None and st.hist is None
    solver = BatchSolver(reference_problem(num).make(), CFG64)
    res = solver.finalize(solver.run(st))
    assert int(res.signal) == int(full.signal) and int(res.signal) in (1, 2)
    assert int(res.iter_count) == int(full.iter_count)
    np.testing.assert_allclose(res.x[0].numpy(), np.asarray(full.x), rtol=0,
                               atol=1e-10)
