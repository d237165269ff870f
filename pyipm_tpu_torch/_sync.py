"""The solver's host synchronisation points, counted.

The batch-first solver decides on the host which instances take a branch
or stay in a loop.  Each such decision copies a mask from the device and
waits for it; every one goes through this module, so ``COUNTS`` says how
many a solve made, beside the number of flat solver steps (counted by
``core.solver``) and of waves (``parallel.batch``'s wave solver).  A caller
resets the counts before the run it measures.
"""

from __future__ import annotations

import torch

COUNTS = {"host_syncs": 0, "flat_steps": 0, "waves": 0}


def indices(mask):
    """Indices (1-D int64) of the True entries of a (B,) bool mask."""
    COUNTS["host_syncs"] += 1
    return torch.nonzero(mask).squeeze(1)


def any_true(mask) -> bool:
    COUNTS["host_syncs"] += 1
    return bool(mask.any())
