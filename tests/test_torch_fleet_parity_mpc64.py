"""The MPC rows of ``test_torch_fleet_parity_mpc.py`` (rows 0-15 of
``sample_mpc_arrays(42, 2048)`` at phase 16's width, the JAX package's
five CPU-path failures and the port's twelve slowest float32 instances)
in float64 against the JAX package on the CPU: there the float32
divergences are gone.  Tolerances: signals and iteration counts equal,
every instance at signal 1, x within 1e-8 (1 + |x|)."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import fleet_parity_common as fp  # noqa: E402

ROWS = fp.ROWS + fp.MPC_JAX_CPU_FAILS + fp.MPC_SLOW


def test_mpc_float64_matches_jax():
    arr = fp.rows_of("mpc", ROWS, "float64")
    port = fp.solve_port("mpc", arr, "float64")
    jres = fp.solve_jax("mpc", arr, fp.port_x0("mpc", arr, "float64"),
                        "float64")
    np.testing.assert_array_equal(np.asarray(jres.signal),
                                  port.signal.numpy())
    assert np.all(port.signal.numpy() == 1)
    np.testing.assert_array_equal(np.asarray(jres.iter_count),
                                  port.iter_count.numpy())
    assert fp.rel_dx(port.x.numpy(), jres.x).max() <= 1e-8
