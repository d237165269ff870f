"""Kernel ``panel_ldlt`` (``ops/large_ldlt``, ``csrc/panel_ldlt.cu``):
the least time of the LDL^T factors of each call's panels, (B, n, n) or
one (n, n), over the device time of the kernels ``panel_ldlt_kernel*``."""

from portbench import roofline
from portbench.metrics._kernel_share import share

CALLS = {"panel_ldlt": "pyipm_tpu_torch.ops.large_ldlt:panel_ldlt"}
KERNELS = ("panel_ldlt_kernel",)
UNIT = "%"


def _bound(shapes, dtype):
    A = shapes[0]
    B = A[0] if len(A) == 3 else 1
    return roofline.factor_bound(B, A[-1], dtype)[0]


def read(ctx):
    return share(ctx, "panel_ldlt", KERNELS, _bound)
