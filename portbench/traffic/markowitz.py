"""The Markowitz family's sampler, on the device from a
``torch.Generator``: the upstream portfolio family's distributions
(factor-model covariance F F'/D + ridge I with D/4 factors, returns
0.1 N(0, 1), risk tolerance 0.5 + |N(0, 1)|, cap 4/D)."""

from typing import NamedTuple

import torch


class Book(NamedTuple):
    S: torch.Tensor        # (B, D, D) covariance, symmetric positive definite
    m: torch.Tensor        # (B, D) expected returns
    gamma: torch.Tensor    # (B,) risk tolerance
    cap: torch.Tensor      # (B, D) per-asset weight cap


def sample(gen, batch: int, sizes: dict, constants: dict, dtype,
           device) -> Book:
    D = int(sizes["nassets"])
    k = max(int(D * constants["factors_per_asset"]),
            int(constants["min_factors"]))

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    F = randn(batch, D, k)
    S = torch.baddbmm(
        torch.eye(D, dtype=dtype, device=device).expand(batch, D, D),
        F, F.transpose(1, 2), beta=constants["ridge"], alpha=1.0 / D)
    del F
    S = 0.5 * (S + S.transpose(1, 2))
    m = constants["return_scale"] * randn(batch, D)
    gamma = constants["gamma_base"] + torch.abs(randn(batch))
    cap = torch.full((batch, D), constants["cap_assets"] / D, dtype=dtype,
                     device=device)
    return Book(S, m, gamma, cap)
