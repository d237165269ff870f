"""A dispatch mode that records the shape of every tensor an operator
returns, for the port's tests that hold a solve to never forming a
large matrix (tests/test_torch_lbfgs.py, tests/test_torch_schur_lbfgs.py)."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out
