"""The block-separable Schur solver's per-block L-BFGS mode
(``IPMConfig(lbfgs=m)``) of the port against the JAX package's on a
one-device mesh, float64 on the CPU: the general coupled instance
(test_schur.py:763) to the end and in its early states field by field,
the memory included; the box-identity fast path (test_schur.py:805);
ragged blocks (test_schur.py:842); a JAX state paused mid-solve finished
in the port; then the port against itself (pause, checkpoint, resume bit
for bit) and the mode's promise: no (d, d) matrix is formed."""

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
from pyipm_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_state, save_state,
)
from torch_shapes import Shapes  # noqa: E402

RTOL, STATE_RTOL = 1e-8, 1e-10
LBFGS = dict(float_dtype="float64", verbosity=0, lbfgs=6, niter=20,
             miter=40)
EARLY = (1, 2, 4, 5)          # run_budget stops; 4 is the crossing point


def _mesh1():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",),
                             axis_types=(jax.sharding.AxisType.Auto,))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
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


def _leaves(tree, prefix=""):
    """(path, tensor) of a nested (Named)tuple of tensors; None skipped."""
    items = (tree._asdict().items() if hasattr(tree, "_asdict")
             else enumerate(tree))
    out = []
    for k, v in items:
        if isinstance(v, tuple):
            out += _leaves(v, f"{prefix}{k}.")
        elif v is not None:
            out.append((f"{prefix}{k}", v))
    return out


@pytest.fixture(scope="module")
def general():
    """The instance of test_schur.py:763 through the JAX package once:
    the straight solve and the states after 1, 2, 4 and 5 iterations."""
    spec, theta, ccdata, x0 = JS.sample_block_general(
        jax.random.key(11), 8, 6, me=1, ni=2, p=2, mc=1)
    jfn = JS.make_block_solver(spec, _mesh1(), JCfg(**LBFGS))
    jres = jfn(x0, theta, ccdata=ccdata)
    st, states, done = jfn.init_state(x0, theta, ccdata=ccdata), {}, 0
    for k in EARLY:
        st = jfn.run_budget(st, theta, ccdata=ccdata, max_new_iters=k - done)
        states[k], done = jax.tree.map(np.asarray, st), k
    th, cc = interop.block_data_from_numpy(theta, ccdata, device="cpu")
    fn = TS.make_block_solver(TS.block_general_spec(6, 1, 2, 2, 1), None,
                              TCfg(**LBFGS), device="cpu")
    return dict(jres=jres, states=states, fn=fn, th=th, cc=cc,
                x0=torch.tensor(np.asarray(x0)))


def test_general_coupled_matches_jax(general):
    """Signal, iterations, x, s and every multiplier of the JAX package;
    x within 1e-3 of the port's exact-Hessian solve."""
    g = general
    tres = g["fn"](g["x0"], g["th"], g["cc"])
    _held(g["jres"], tres)
    exact = TS.make_block_solver(
        TS.block_general_spec(6, 1, 2, 2, 1), None,
        TCfg(float_dtype="float64", verbosity=0, niter=10, miter=25),
        device="cpu")(g["x0"], g["th"], g["cc"])
    assert int(exact.signal) == 1
    np.testing.assert_allclose(tres.x.numpy(), exact.x.numpy(), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("iters", [1, 2, 5])
def test_early_states_match_jax(general, iters):
    """The state after ``run_budget`` of 1, 2 and 5 iterations equals the
    JAX package's field by field within 1e-10, the per-block memory (S,
    Y, zeta, count, fail) and x_old included."""
    g = general
    fn = g["fn"]
    st = fn.run_budget(fn.init_state(g["x0"], g["th"], g["cc"]), g["th"],
                       g["cc"], max_new_iters=iters)
    ref = interop.block_state_from_numpy(g["states"][iters], device="cpu")
    assert ref.lbfgs is not None
    if iters > 1:
        assert int(ref.lbfgs.count.max()) > 0       # a pair was taken
    got, want = _leaves(st), _leaves(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        if a.is_floating_point():
            _close(a.numpy(), b.numpy(), STATE_RTOL)
        else:
            assert torch.equal(a, b.to(a.dtype)), k


def test_box_identity_fast_path_matches_jax():
    """Box bounds through the identity Jacobian: Sigma folds into the
    diagonal Woodbury base (test_schur.py:805), through
    ``make_separable_solver``."""
    spec, data, x0 = JS.sample_separable(jax.random.key(1), 8, 8, 3,
                                         dtype=jnp.float64)
    jres = JS.make_separable_solver(spec, _mesh1(), JCfg(**LBFGS))(x0, data)
    tres = TS.make_separable_solver(
        TS.separable_spec(8, 3), None, TCfg(**LBFGS), device="cpu")(
            torch.tensor(np.asarray(x0)),
            interop.separable_data_from_numpy(data, device="cpu"))
    assert int(tres.signal) == int(jres.signal) == 1
    assert int(tres.iter_count) == int(jres.iter_count)
    for k in ("x", "s", "z", "le", "lc"):
        _close(getattr(tres, k).numpy(), getattr(jres, k))


def test_ragged_blocks_match_jax():
    """Ragged per-block counts under masks (test_schur.py:842): the JAX
    package's result, and the inactive multipliers exactly 0."""
    spec, theta, ccdata, x0, _, _ = JS.sample_block_ragged(
        jax.random.key(21), 8, d=4, me=2, ni=3, p=2, mc=1)
    jres = JS.make_block_solver(spec, _mesh1(), JCfg(**LBFGS))(
        x0, theta, ccdata=ccdata)
    th, cc = interop.block_data_from_numpy(theta, ccdata, device="cpu")
    tres = TS.make_block_solver(TS.block_ragged_spec(4, 2, 3, 2, 1), None,
                                TCfg(**LBFGS), device="cpu")(
        torch.tensor(np.asarray(x0)), th, cc)
    _held(jres, tres, signals=(1, 2))
    assert torch.all(tres.le[th["ce_mask"] == 0] == 0.0)
    assert torch.all(tres.li[th["ci_mask"] == 0] == 0.0)


def test_jax_paused_lbfgs_state_finishes_in_the_port(general):
    """A JAX L-BFGS state paused at 4 iterations, carried across by
    ``interop.block_state_from_numpy`` with its memory, finished in the
    port: the JAX package's straight solve."""
    g = general
    st = interop.block_state_from_numpy(g["states"][4], device="cpu")
    assert int(st.signal[0]) == 0 and int(st.iter_count[0]) == 4
    assert st.lbfgs.S.shape == (8, 6, 7)
    fn = g["fn"]
    _held(g["jres"], fn.finalize(fn.run(st, g["th"], g["cc"]), g["th"],
                                 g["cc"]))


def test_pause_checkpoint_resume_equals_straight(general, tmp_path):
    """run_budget(4), save, restore into a fresh state, run: bit for bit
    the straight solve, the per-block memory carried in the file."""
    g = general
    fn, th, cc, x0 = g["fn"], g["th"], g["cc"], g["x0"]
    straight = fn(x0, th, cc)
    st = fn.run_budget(fn.init_state(x0, th, cc), th, cc, max_new_iters=4)
    assert int(st.signal[0]) == 0 and int(st.lbfgs.count.max()) > 0
    save_state(str(tmp_path / "blk"), st)
    st2 = restore_state(str(tmp_path / "blk"), fn.init_state(x0, th, cc))
    assert torch.equal(st2.lbfgs.S, st.lbfgs.S)
    res = fn.finalize(fn.run(st2, th, cc), th, cc)
    assert int(res.signal) == int(straight.signal) == 1
    assert int(res.iter_count) == int(straight.iter_count)
    for k in ("x", "s", "le", "li", "lc"):
        assert torch.equal(getattr(res, k), getattr(straight, k)), k


def test_lbfgs_mode_forms_no_dense_block_matrix():
    """A K = 2, d = 512 box-bounded L-BFGS(8) solve, its initial state
    included, returns no tensor whose two trailing dimensions are both d
    or more: no per-block Hessian, condensed matrix or identity
    Jacobian."""
    K, d, p = 2, 512, 4
    gen = torch.Generator().manual_seed(5)
    spec, theta, ccdata, x0 = TS.sample_block_box_quadratic(
        gen, K, d, p, dtype=torch.float64, device="cpu")
    fn = TS.make_block_solver(spec, None, TCfg(float_dtype="float64",
                                               verbosity=0, lbfgs=8,
                                               niter=20, miter=60),
                              device="cpu")
    with Shapes() as rec:
        res = fn(x0, theta, ccdata)
    assert int(res.signal) in (1, 2)
    assert (K, d, 18) in rec.shapes          # the memory's [zeta S, Y]
    big = [s for s in rec.shapes if len(s) >= 2 and min(s[-2:]) >= d]
    assert not big, big
