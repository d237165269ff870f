"""The dense NLP family's mathematics as a user writes it for the port:
per-instance callables ``(x, p)``, with ``p`` one instance (P, c, W, Aeq,
beq, alpha)."""

import math

import torch


def callables(sizes: dict) -> dict:
    D, M = int(sizes["nvar"]), int(sizes["neq"])
    sqrtD = math.sqrt(D)

    def f(x, p):
        feat = torch.tanh(p.W @ x / sqrtD)
        return 0.5 * x @ (p.P @ x) + p.c @ x + p.alpha * torch.sum(feat)

    def ce(x, p):
        return p.Aeq @ x - p.beq

    return dict(f=f, nvar=D, neq=M, nineq=0, ce=ce)


def start(batch: int, sizes: dict, constants: dict, dtype, device):
    """x0 = ``constants["start"]`` in every coordinate, (batch, D)."""
    return torch.full((batch, int(sizes["nvar"])), float(constants["start"]),
                      dtype=dtype, device=device)
