"""The Schur solver's reductions over the ``model`` group.

:class:`Reducer` is the port of the JAX package's ``lax.psum`` /
``lax.pmin`` / ``lax.pmax`` over the ``model`` mesh axis and of its
``_psum_pack`` fusion (pyipm_tpu/parallel/schur.py:311-330): several
small reductions flattened into ONE all-reduce.  With no group (one
process) every reduction is the identity and no ``torch.distributed``
call is made.  ``calls`` counts the all-reduces the solver asks for,
by operation, in both cases, so a one-process run counts what a
multi-process run pays.
"""

from __future__ import annotations

import torch


class Reducer:
    """Sum, min and max all-reduce over ``group`` (None: one process)."""

    def __init__(self, group=None):
        self.group = group
        self.calls = {"sum": 0, "min": 0, "max": 0}

    @property
    def size(self) -> int:
        """Number of ranks the reductions run over."""
        if self.group is None:
            return 1
        import torch.distributed as dist
        return dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank(self.group)

    @property
    def total(self) -> int:
        """All-reduce calls so far, every operation."""
        return sum(self.calls.values())

    def _reduce(self, t, op: str):
        self.calls[op] += 1
        if self.group is None:
            return t
        import torch.distributed as dist
        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
        out = t.reshape(-1).clone()
        dist.all_reduce(out, op=ops[op], group=self.group)
        return out.reshape(t.shape)

    def sum(self, t):
        return self._reduce(t, "sum")

    def min(self, t):
        return self._reduce(t, "min")

    def max(self, t):
        return self._reduce(t, "max")

    def sum_pack(self, *vals):
        """Several sums in ONE all-reduce: flatten, concatenate, reduce,
        split back to the input shapes (an all-reduce is elementwise, so
        the values are those of separate reductions)."""
        flat = [torch.reshape(v, (-1,)) for v in vals]
        tot = self.sum(torch.cat(flat) if len(flat) > 1 else flat[0])
        out, off = [], 0
        for v, f in zip(vals, flat):
            out.append(tot[off:off + f.shape[0]].reshape(v.shape))
            off += f.shape[0]
        return out

    def gather(self, t):
        """Concatenate every rank's ``t`` along dim 0 (equal shapes); not
        an all-reduce and not counted."""
        if self.group is None:
            return t
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=0)

