"""What the ``k*_roofline`` readers share: a kernel's share of its
roofline, the least time of the recorded calls' mathematics over the
device time of the kernels named for it."""

from portbench import roofline


def share(ctx, label, kernels, bound_of):
    """``bound_of(shapes, dtype)`` -> least seconds of one recorded call
    of ``label``; None where the kernel or the calls left nothing to
    read."""
    tr = ctx.window.trace
    if tr is None:
        return None
    dev_s, n = tr.kernel_s(kernels)
    calls = [(shapes, dt) for lab, shapes, dt in ctx.window.calls
             if lab == label]
    if not n or not calls:
        return None
    least = sum(bound_of(shapes, dt) for shapes, dt in calls)
    return roofline.share_pct(least, dev_s)
