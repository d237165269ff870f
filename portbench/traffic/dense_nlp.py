"""The dense NLP family's sampler, on the device from a
``torch.Generator``: P = G G'/D + 0.5 I, c ~ N(0, I), W ~ N(0, I)
(hidden x D), Aeq ~ N(0, I)/sqrt(D), beq = Aeq (0.1 N(0, I)), alpha =
0.5 (the upstream dense NLP's distributions)."""

import math
from typing import NamedTuple

import torch


class Instance(NamedTuple):
    P: torch.Tensor       # (B, D, D) symmetric positive definite
    c: torch.Tensor       # (B, D)
    W: torch.Tensor       # (B, H, D) feature weights
    Aeq: torch.Tensor     # (B, M, D)
    beq: torch.Tensor     # (B, M)
    alpha: torch.Tensor   # (B,)


def sample(gen, batch: int, sizes: dict, constants: dict, dtype,
           device) -> Instance:
    D, M, H = int(sizes["nvar"]), int(sizes["neq"]), int(sizes["hidden"])

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    G = randn(batch, D, D)
    P = torch.baddbmm(
        torch.eye(D, dtype=dtype, device=device).expand(batch, D, D),
        G, G.transpose(1, 2), beta=constants["ridge"], alpha=1.0 / D)
    del G
    P = 0.5 * (P + P.transpose(1, 2))
    c = randn(batch, D)
    W = randn(batch, H, D)
    Aeq = randn(batch, M, D) / math.sqrt(D)
    xfeas = constants["feasible_scale"] * randn(batch, D)
    beq = torch.einsum("bmd,bd->bm", Aeq, xfeas)
    alpha = torch.full((batch,), constants["alpha"], dtype=dtype,
                       device=device)
    return Instance(P, c, W, Aeq, beq, alpha)
