"""The Markowitz family's mathematics as a user writes it for the port:
per-instance callables ``(x, p)``, with ``p`` one book row (S, m, gamma,
cap)."""

import torch


def callables(sizes: dict) -> dict:
    D = int(sizes["nassets"])

    def f(x, p):
        return x @ (p.S @ x) - p.gamma * (p.m @ x)

    def ce(x, p):
        return torch.sum(x) - 1.0

    def ci(x, p):
        return torch.cat([x, p.cap - x])

    return dict(f=f, nvar=D, neq=1, nineq=2 * D, ce=ce, ci=ci)


def start(batch: int, sizes: dict, constants: dict, dtype, device):
    """Uniform weights 1/D, (batch, D)."""
    D = int(sizes["nassets"])
    return torch.full((batch, D), 1.0 / D, dtype=dtype, device=device)
