"""The port's condensed KKT direction (pyipm_tpu_torch/ops/condensed.py)
against the JAX package's ``condensed_direction`` on identical iterates, in
float64: 8 random QP instances (inequalities only) and reference example 7
(equality + inequalities, nonconvex, so some iterates escalate delta)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models.random_nlp import QPData as JQP  # noqa: E402
from pyipm_tpu.models.random_nlp import make_qp_problem as j_qp  # noqa: E402
from pyipm_tpu.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as J_REF,
)
from pyipm_tpu.ops.condensed import condensed_direction as j_cd  # noqa: E402
from pyipm_tpu_torch.config import IPMConfig as TCfg  # noqa: E402
from pyipm_tpu_torch.models.random_nlp import (  # noqa: E402
    make_qp_problem as t_qp, qp_data, sample_qp_arrays,
)
from pyipm_tpu_torch.models.reference_problems import (  # noqa: E402
    REFERENCE_PROBLEMS as T_REF,
)
from pyipm_tpu_torch.ops.condensed import condensed_direction as t_cd  # noqa: E402

# both sides factor the 8x8 / 4x4 condensed systems in different orders;
# the directions agree to roundoff times the systems' conditioning
RTOL = 1e-9


def _iterates(rng, B, D, M, N):
    x = rng.standard_normal((B, D)) * 0.3
    s = np.abs(rng.standard_normal((B, N))) + 0.1
    lda = rng.standard_normal((B, M + N))
    lda[:, M:] = np.abs(lda[:, M:]) + 0.05
    mu = np.abs(rng.standard_normal(B)) * 0.2 + 1e-3
    delta = np.where(np.arange(B) % 3 == 0, 0.0, 1e-3)
    return x, s, lda, mu, delta


def _compare(got, want):
    dz, dn, rt = (t.numpy() for t in got)
    wdz, wdn, wrt = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(rt, wrt)
    np.testing.assert_allclose(dn, wdn, rtol=1e-12)
    scale = np.abs(wdz).max(axis=-1, keepdims=True)
    np.testing.assert_allclose(dz, wdz, rtol=RTOL, atol=0)
    assert np.all(np.abs(dz - wdz) <= RTOL * scale)


def test_qp_instances_match_jax():
    B, D, NLIN = 8, 8, 4
    N = 2 * D + NLIN
    arr = sample_qp_arrays(3, B, D, NLIN, np.float64)
    args = _iterates(np.random.default_rng(1), B, D, 0, N)
    jcfg = JCfg(float_dtype="float64", verbosity=0)
    jdata = JQP(*(jnp.asarray(arr[k]) for k in JQP._fields))

    def one(data, x, s, lda, mu, delta):
        return j_cd(j_qp(data, D, NLIN), jcfg, x, s, lda, mu, delta)

    want = jax.jit(jax.vmap(one))(jdata, *(jnp.asarray(a) for a in args))
    got = t_cd(t_qp(D, NLIN), TCfg(float_dtype="float64", verbosity=0),
               *(torch.as_tensor(a) for a in args),
               qp_data(arr, device="cpu"))
    _compare(got, want)


def test_example7_matches_jax():
    B = 8
    args = _iterates(np.random.default_rng(2), B, 3, 1, 3)
    jprob = J_REF[7].make()
    jcfg = JCfg(float_dtype="float64", verbosity=0)
    want = jax.jit(jax.vmap(lambda *a: j_cd(jprob, jcfg, *a)))(
        *(jnp.asarray(a) for a in args))
    assert int(np.sum(np.asarray(want[2]))) + int(
        np.sum(np.asarray(want[1]) > 0)) > 0, "no iterate escalated"
    got = t_cd(T_REF[7].make(), TCfg(float_dtype="float64", verbosity=0),
               *(torch.as_tensor(a) for a in args), ())
    _compare(got, want)
