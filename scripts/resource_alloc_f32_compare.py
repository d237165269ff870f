"""Resource allocation with a binding pool against a cap, in both
packages on the CPU: the same instance (the JAX sampler's, carried across
by ``interop``) through the JAX ``make_block_solver`` on a one-device mesh
and through the port, printing each solve's signal, iterations and KKT
norms.

    JAX_PLATFORMS=cpu python scripts/resource_alloc_f32_compare.py \\
        [--agents 128] [--dtype float32]

In float32 both packages stall on ``cap='eq'`` (ROADMAP Queue 3)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pyipm_tpu.config import IPMConfig as JCfg  # noqa: E402
from pyipm_tpu.models import applications as JA  # noqa: E402
from pyipm_tpu.parallel import schur as JS  # noqa: E402
from pyipm_tpu_torch import interop  # noqa: E402
from pyipm_tpu_torch.config import IPMConfig as TCfg  # noqa: E402
from pyipm_tpu_torch.models import applications as TA  # noqa: E402
from pyipm_tpu_torch.parallel import schur as TS  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=128)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    a = ap.parse_args()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("model",))
    jdt = jnp.float32 if a.dtype == "float32" else jnp.float64
    for cap in ("eq", "ineq"):
        data = JA.sample_resource_alloc(jax.random.key(0), a.agents, 16,
                                        nres=4, dtype=jdt)
        x0 = jnp.ones((a.agents, 16), jdt)
        rj = JS.make_block_solver(
            JA.make_resource_alloc_spec(16, 4, cap=cap), mesh,
            JCfg(float_dtype=a.dtype, verbosity=0))(
            x0, data.theta, ccdata=data.ccdata)
        td = interop.resource_alloc_from_numpy(data, device="cpu")
        rt = TS.make_block_solver(
            TA.make_resource_alloc_spec(16, 4, cap=cap), None,
            TCfg(float_dtype=a.dtype, verbosity=0), device="cpu")(
            torch.tensor(np.asarray(x0)), td.theta, td.ccdata)
        print(f"cap={cap} {a.dtype} K={a.agents}: JAX signal "
              f"{int(rj.signal)} iterations {int(rj.iter_count)} kkt "
              f"{np.asarray(rj.kkt)}; port signal {int(rt.signal)} "
              f"iterations {int(rt.iter_count)} kkt {rt.kkt.numpy()}",
              flush=True)


if __name__ == "__main__":
    main()
