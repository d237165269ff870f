"""``solve_fleet`` of the port (pyipm_tpu_torch) against the JAX package's,
on the CPU, float64: a mixed fleet of box QPs of dimension 2 and 4 and
reference problem 5 (the fleet of the JAX package's heterogeneous-fleet
example).  In the JAX package each QP closes over its own (W, c); in the
port one Problem per dimension reads them from ``params``.

Tolerance: per instance the JAX package's signal and iteration count, x
within 1e-9."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.core.problem import Problem as JProblem  # noqa: E402
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    get_problem as j_get_problem,
)
from pyipm_tpu.parallel.fleet import (  # noqa: E402
    solve_fleet as j_solve_fleet,
)
from pyipm_tpu_torch import (  # noqa: E402
    IPMConfig, Problem, solve, solve_fleet,
)
from pyipm_tpu_torch.interop import reference_problem  # noqa: E402
from pyipm_tpu_torch.parallel.fleet import bucket_key  # noqa: E402

CFG = dict(Ftol=1e-8, verbosity=0)


def _box_qp_data(nvar, seed):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(nvar, nvar))
    return G @ G.T / nvar + np.eye(nvar), rng.normal(size=nvar)


def _j_box_qp(nvar, seed):
    W, c = (jnp.asarray(a) for a in _box_qp_data(nvar, seed))
    return JProblem(f=lambda x: 0.5 * x @ W @ x + c @ x,
                    ci=lambda x: jnp.concatenate([x + 1.0, 1.0 - x]),
                    nvar=nvar, nineq=2 * nvar)


def _box_qp(nvar):
    return Problem(f=lambda x, p: 0.5 * x @ (p[0] @ x) + p[1] @ x,
                   ci=lambda x, p: torch.cat([x + 1.0, 1.0 - x]),
                   nvar=nvar, nineq=2 * nvar)


def _fleet():
    """(JAX problems, port problems, port params, x0s)."""
    jp, tp, params, x0s = [], [], [], []
    qp = {2: _box_qp(2), 4: _box_qp(4)}
    for nvar, seeds in ((2, range(4)), (4, range(10, 13))):
        for seed in seeds:
            jp.append(_j_box_qp(nvar, seed))
            tp.append(qp[nvar])
            params.append(_box_qp_data(nvar, seed))
            x0s.append(np.full(nvar, 0.1 * seed % 0.7))
    jp.append(j_get_problem(5).make(dtype=np.float64))
    tp.append(reference_problem(5).make())
    params.append(())
    x0s.append(j_get_problem(5).sample_x0(np.random.default_rng(0)))
    return jp, tp, params, x0s


def test_fleet_matches_jax_solve_fleet():
    jp, tp, params, x0s = _fleet()
    want = j_solve_fleet(jp, x0s, JCfg(**CFG), first_wave=4, wave=8)
    got = solve_fleet(tp, x0s, IPMConfig(**CFG), params=params,
                      device="cpu", first_wave=4, wave=8)
    assert len(got) == len(want) == len(tp)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.x.shape == (tp[i].nvar,)
        assert int(g.signal) == int(w.signal) and int(g.signal) in (1, 2), i
        assert int(g.iter_count) == int(w.iter_count), i
        np.testing.assert_allclose(g.x.numpy(), np.asarray(w.x), rtol=0,
                                   atol=1e-9)
    np.testing.assert_allclose(got[-1].x.numpy(), [4.0, 3.0], atol=1e-3)


def test_fleet_bucketing_never_merges_distinct_problems():
    """Instances bucket by the Problem object, its shape and the shapes
    and dtypes of their data: two Problem objects of identical structure
    stay apart, and so do instances whose data differ in shape."""
    a, b = _box_qp(2), _box_qp(2)
    p2 = tuple(torch.as_tensor(v) for v in _box_qp_data(2, 0))
    p2b = tuple(torch.as_tensor(v) for v in _box_qp_data(2, 1))
    assert bucket_key(a, p2) == bucket_key(a, p2b)
    assert bucket_key(a, p2) != bucket_key(b, p2)
    assert bucket_key(a, p2) != bucket_key(a, (p2[0], p2[1].float()))
    assert bucket_key(a, p2) != bucket_key(_box_qp(4), p2)
    # and the results are those of separate solves all the same
    x0s = [np.zeros(2), np.zeros(2)]
    got = solve_fleet([a, b], x0s, IPMConfig(**CFG),
                      params=[p2, p2b], device="cpu")
    for g, p in zip(got, (p2, p2b)):
        r = solve(a, torch.zeros(2, dtype=torch.float64),
                  IPMConfig(**CFG), params=p)
        assert int(g.iter_count) == int(r.iter_count)
        assert torch.equal(g.x, r.x)


def test_fleet_single_instance():
    """A fleet of one is a solve (JAX test_fleet.py:158)."""
    x0 = j_get_problem(5).sample_x0(np.random.default_rng(0))
    prob = reference_problem(5).make()
    (res,) = solve_fleet([prob], [x0], IPMConfig(verbosity=0), device="cpu")
    single = solve(prob, torch.as_tensor(x0), IPMConfig(verbosity=0))
    assert int(res.signal) == int(single.signal) in (1, 2)
    assert int(res.iter_count) == int(single.iter_count)
    assert torch.equal(res.x, single.x)
    assert res.hist.kkt.shape == (0, 4)
