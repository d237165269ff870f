"""The maximum-entropy and portfolio families at the widths of
``chip_smoke.py``'s phase 16 (64 states with 2 moments; 64 assets) held
to the JAX package on the CPU, instance by instance: rows 0-15 of each
``sample_*_arrays(42, 2048, ...)``, and for maximum entropy also the
instance that ends at signal -2 on the card only (``MAXENT_CARD_SPLIT``,
ROADMAP Queue 3), through the port's ``BatchSolver`` and the JAX
package's ``make_*_batch_solver`` on the same numpy rows in float32.  The
SVM and MPC families are held in ``test_torch_fleet_parity_{svm,mpc,
mpc64}.py``.

Tolerances: every signal equal and in {1, 2}; iteration counts equal on
at least 15 of rows 0-15; x within 2e-3 (1 + |x|)."""

import pytest

torch = pytest.importorskip("torch")

import fleet_parity_common as fp  # noqa: E402


def test_maxent_at_phase16_width_matches_jax():
    fp.hold_family("maxent", fp.ROWS + fp.MAXENT_CARD_SPLIT)


def test_portfolio_at_phase16_width_matches_jax():
    fp.hold_family("portfolio", fp.ROWS)


def test_merit_penalty_update_at_exact_feasibility_matches_jax():
    """The mechanism of the maximum-entropy instance at signal -2 on the
    card only: where the l1 infeasibility comes out exactly 0, both
    packages' penalty threshold is the barrier slope over the tiny guard
    alone (~1e31 in float32 for the card's slope of ~2e-7), and it equals
    the JAX package's bit for bit, as at the CPU's nonzero infeasibility."""
    import jax.numpy as jnp
    import numpy as np
    from pyipm_tpu.core.updates import nu_threshold as jnu
    from pyipm_tpu_torch.core.updates import nu_threshold

    tiny = float(np.finfo(np.float32).tiny)
    slope = np.array([2.1606e-7, 2.1606e-7, -1.5575e-6, 3.4495e-7],
                     np.float32)
    con_l1 = np.array([0.0, 7.4506e-8, 0.0, 1.4901e-7], np.float32)
    port = nu_threshold(torch.as_tensor(slope), torch.as_tensor(con_l1),
                        0.1, tiny).numpy()
    ref = np.asarray(jnu(jnp.asarray(slope), jnp.asarray(con_l1), 0.1, tiny))
    np.testing.assert_array_equal(port, ref)
    assert port[0] > 1e31 and port[1] < 10.0 and port[2] < 0
