"""Checkpoint and resume of the port's solver state
(``pyipm_tpu_torch.utils.checkpoint``), the counterparts of the JAX
package's test_checkpoint.py, on the CPU, float64.

Tolerances: a round trip is bit for bit; a solve paused, saved, restored
and resumed equals the uninterrupted solve bit for bit, and the JAX
package's straight solve in signal and iteration count with x within
1e-10; a file that does not match raises ``CheckpointError`` with the JAX
package's messages."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core.solver import make_solver as j_make_solver  # noqa: E402
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    get_problem as j_get_problem,
)
from pyipm_tpu_torch import IPMConfig  # noqa: E402
from pyipm_tpu_torch.core.solver import BatchSolver  # noqa: E402
from pyipm_tpu_torch.interop import reference_problem  # noqa: E402
from pyipm_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointError, restore_state, save_state,
)


def _x0s(num, B, seed=0):
    rng = np.random.default_rng(seed)
    spec = j_get_problem(num)
    return torch.as_tensor(np.stack([spec.sample_x0(rng) for _ in range(B)]))


def _leaves(t):
    if t is None:
        return []
    if isinstance(t, tuple):
        return [u for v in t for u in _leaves(v)]
    return [t]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for u, v in zip(la, lb):
        assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.mark.parametrize("cfg", [
    dict(), dict(trace_metrics=True), dict(lbfgs=4)],
    ids=["exact", "trace_metrics", "lbfgs"])
def test_save_restore_roundtrip(tmp_path, cfg):
    """A batched state mid-solve (problem 7, two budgeted iterations) with
    its None fields (L-BFGS memory, history) round-trips bit for bit, and
    restores into a fresh init state's structure."""
    solver = BatchSolver(reference_problem(7).make(),
                         IPMConfig(verbosity=0, **cfg))
    x0 = _x0s(7, 3)
    st = solver.run_budget(solver.init_state(x0), 2)
    path = str(tmp_path / "ckpt")
    save_state(path, st)
    back = restore_state(path, solver.init_state(torch.zeros_like(x0)))
    _bit_equal(st, back)
    res = solver.finalize(st)
    save_state(path + "_res", res)
    _bit_equal(res, restore_state(path + "_res", res))


def test_restore_structure_mismatch_raises(tmp_path):
    """JAX test_checkpoint.py:85: another shape, a leaf-count mismatch
    (trace_metrics on against off; L-BFGS against exact Hessian), and a
    missing file."""
    cfg = IPMConfig(verbosity=0)
    s5 = BatchSolver(reference_problem(5).make(), cfg)
    s7 = BatchSolver(reference_problem(7).make(), cfg)
    st5 = s5.init_state(_x0s(5, 2))
    path = str(tmp_path / "p5")
    save_state(path, st5)
    with pytest.raises(CheckpointError, match="shape"):
        restore_state(path, s7.init_state(_x0s(7, 2)))
    with pytest.raises(CheckpointError, match="shape"):
        restore_state(path, s5.init_state(_x0s(5, 3)))
    for kw in (dict(trace_metrics=True), dict(lbfgs=4)):
        other = BatchSolver(reference_problem(5).make(),
                            IPMConfig(verbosity=0, **kw))
        with pytest.raises(CheckpointError, match="shape|leaves"):
            restore_state(path, other.init_state(_x0s(5, 2)))
        save_state(path + "_o", other.init_state(_x0s(5, 2)))
        with pytest.raises(CheckpointError, match="shape|leaves"):
            restore_state(path + "_o", st5)
    with pytest.raises(CheckpointError, match="no checkpoint"):
        restore_state(str(tmp_path / "missing"), st5)


def test_restore_casts_to_like(tmp_path):
    """Every leaf lands in ``like``'s dtype and device."""
    s64 = BatchSolver(reference_problem(5).make(), IPMConfig(verbosity=0))
    s32 = BatchSolver(reference_problem(5).make(),
                      IPMConfig(verbosity=0, float_dtype="float32"))
    st = s64.init_state(_x0s(5, 2))
    save_state(str(tmp_path / "s"), st)
    back = restore_state(str(tmp_path / "s"), s32.init_state(_x0s(5, 2)))
    assert back.x.dtype == torch.float32 and back.signal.dtype == torch.int32
    assert back.in_inner.dtype == torch.bool
    np.testing.assert_allclose(back.x.numpy(), st.x.numpy(), rtol=1e-7)


@pytest.mark.parametrize("cfg", [dict(), dict(trace_metrics=True)],
                         ids=["exact", "trace_metrics"])
def test_resume_from_checkpointed_state(tmp_path, cfg):
    """JAX test_checkpoint.py:111: a truncated run -> save -> restore ->
    resume completes to the uninterrupted run, bit for bit, on problem 5
    from four starts; the first against the JAX package's straight
    solve."""
    solver = BatchSolver(reference_problem(5).make(),
                         IPMConfig(verbosity=0, Ftol=1e-8, **cfg))
    x0 = _x0s(5, 4, seed=42)
    full = solver(x0)
    st = solver.run_budget(solver.init_state(x0), 3)
    assert torch.any(st.signal == 0)
    path = str(tmp_path / "mid")
    save_state(path, st)
    restored = restore_state(path, solver.init_state(torch.zeros_like(x0)))
    resumed = solver.finalize(solver.run(restored))
    _bit_equal(resumed, full)
    j = j_make_solver(j_get_problem(5).make(dtype=np.float64),
                      JCfg(verbosity=0, Ftol=1e-8))(jnp.asarray(x0[0]))
    assert int(resumed.signal[0]) == int(j.signal) in (1, 2)
    assert int(resumed.iter_count[0]) == int(j.iter_count)
    np.testing.assert_allclose(resumed.x[0].numpy(), np.asarray(j.x),
                               rtol=0, atol=1e-10)
    assert reference_problem(5).distance_to_truth(resumed.x[0]) <= 1e-3
