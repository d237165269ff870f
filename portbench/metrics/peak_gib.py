"""End to end: the device memory peak over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at
its start; the pool's instances are resident and count)."""

KIND = "end_to_end"
UNIT = "GiB"


def read(ctx):
    b = ctx.window.peak_bytes
    return b / 2 ** 30 if b > 0 else None
