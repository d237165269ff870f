"""Kernel ``bwd_sweep_panels`` (``ops/large_ldlt``,
``csrc/bwd_sweep_panels.cu``):
the least time of one backward sweep L^T x = z of the K-row KKT system at
the call's block width (its inverses (npad/w, w, w)), over the device
time of the kernels ``sweep_panels_kernel*``.  K is the unpadded system the
solve factors (the padding past it is an identity tail)."""

from portbench import roofline
from portbench.metrics._kernel_share import share

CALLS = {"bwd_sweep_panels": "pyipm_tpu_torch.ops.large_ldlt:bwd_sweep_panels"}
KERNELS = ("sweep_panels_kernel",)
UNIT = "%"


def read(ctx):
    def bound(shapes, dtype):
        npad = shapes[0][0]
        w = shapes[2][-1]
        return roofline.sweep_bound(min(ctx.kkt_size, npad), w, dtype)[0]

    return share(ctx, "bwd_sweep_panels", KERNELS, bound)
