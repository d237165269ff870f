"""``rescue_failures`` and a mixed-convergence fleet of the port
(pyipm_tpu_torch) against the JAX package, on the CPU, float64.

Tolerances: the rescue fails and rescues exactly the instances the JAX
package's does, every one, and leaves each converged instance bit for bit
as it was; the mixed-convergence fleet gives the JAX package's signal and
iteration count per instance, with x within 1e-9."""

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
    rescue_failures as j_rescue, solve_batch as j_solve_batch,
)
from pyipm_tpu_torch import (  # noqa: E402
    IPMConfig, rescue_failures, solve_batch,
)
from pyipm_tpu_torch.interop import (  # noqa: E402
    qpdata_from_numpy, reference_problem,
)
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem, sample_qp_arrays,
)


@pytest.mark.parametrize("niter,miter", [(2, 3), (3, 5)])
def test_rescue_failures_matches_jax(niter, miter):
    """JAX test_batch.py:81's fixture: B = 32 QPs, D = 8, L = 2, niter 2,
    miter 3 (budget-outs: every instance), rescued under 'auto' with a 3x
    outer budget; and at niter 3, miter 5, where half the fleet converges
    and must come back untouched."""
    B, D, L = 32, 8, 2
    arr = sample_qp_arrays(5, B, D, L, np.float64)
    x0 = np.zeros((B, D))
    jcfg = JCfg(float_dtype="float64", verbosity=0, niter=niter,
                miter=miter)
    cfg = IPMConfig(float_dtype="float64", verbosity=0, niter=niter,
                    miter=miter)

    def family(d_):
        return j_qp_problem(d_, D, L)

    jdata = JQP(*(jnp.asarray(arr[k]) for k in JQP._fields))
    jres = jax.jit(jax.vmap(lambda x_, d_: j_make_solver(
        family(d_), jcfg, jit=False)(x_)))(jnp.asarray(x0), jdata)
    jm, jnf, jnr = j_rescue(jres, jnp.asarray(x0), jcfg, family, jdata)

    data = qpdata_from_numpy(arr, device="cpu")
    problem = make_qp_problem(D, L)
    res = solve_batch(problem, torch.as_tensor(x0), cfg, params=data)
    merged, n_failed, n_rescued = rescue_failures(
        res, torch.as_tensor(x0), cfg, problem, data)

    sig0 = res.signal.numpy()
    np.testing.assert_array_equal(sig0, np.asarray(jres.signal))
    assert n_failed == jnf > 0
    assert n_rescued == n_failed == jnr
    np.testing.assert_array_equal(merged.signal.numpy(),
                                  np.asarray(jm.signal))
    np.testing.assert_array_equal(merged.iter_count.numpy(),
                                  np.asarray(jm.iter_count))
    np.testing.assert_allclose(merged.x.numpy(), np.asarray(jm.x), rtol=0,
                               atol=1e-8)
    keep = torch.as_tensor(np.isin(sig0, (1, 2)))
    assert bool(keep.any()) == (niter == 3)
    for a, b in zip(merged[:-1], res[:-1]):
        assert torch.equal(a[keep], b[keep])


def test_rescue_keeps_failed_rescues_and_converged_instances():
    """A rescue that itself fails (a rescue budget too small) keeps the
    original result; nothing converged moves; no failure -> (result, 0, 0)."""
    B, D, L = 8, 4, 2
    arr = sample_qp_arrays(1, B, D, L, np.float64)
    data = qpdata_from_numpy(arr, device="cpu")
    problem = make_qp_problem(D, L)
    x0 = torch.zeros(B, D, dtype=torch.float64)
    cfg = IPMConfig(verbosity=0, niter=1, miter=2)
    res = solve_batch(problem, x0, cfg, params=data)
    merged, nf, nr = rescue_failures(res, x0, cfg, problem, data,
                                     rescue_config=cfg)
    assert nf == int((res.signal != 1).sum()) > 0 and nr == 0
    for a, b in zip(merged[:-1], res[:-1]):
        assert torch.equal(a, b)
    full = solve_batch(problem, x0, IPMConfig(verbosity=0), params=data)
    same, nf, nr = rescue_failures(full, x0, cfg, problem, data)
    assert same is full and nf == nr == 0


def test_batch_mixed_convergence_matches_jax():
    """JAX test_batch.py:37: problem 5 from 16 starts scaled up to 6x;
    instances converge independently, per instance as in the JAX package's
    fleet."""
    spec = j_get_problem(5)
    rng = np.random.default_rng(1)
    B = 16
    x0s = np.stack([spec.sample_x0(rng) * (1 + 5 * i / B) for i in range(B)])
    jcfg = JCfg(Ftol=1e-8, verbosity=0)
    jr = j_solve_batch(spec.make(dtype=np.float64), jnp.asarray(x0s), jcfg)
    tr = solve_batch(reference_problem(5).make(), torch.as_tensor(x0s),
                     IPMConfig(Ftol=1e-8, verbosity=0))
    sigs = tr.signal.numpy()
    np.testing.assert_array_equal(sigs, np.asarray(jr.signal))
    np.testing.assert_array_equal(tr.iter_count.numpy(),
                                  np.asarray(jr.iter_count))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-9)
    assert np.all(np.isin(sigs, [1, 2, -1, -2]))
    assert np.mean(np.isin(sigs, [1, 2])) >= 0.9
    for i in np.flatnonzero(np.isin(sigs, (1, 2))):
        assert spec.distance_to_truth(tr.x[i].numpy()) <= 1e-3
