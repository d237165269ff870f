"""Scalar update formulas of the interior-point iteration, batch first
(counterpart of ``pyipm_tpu/core/updates.py``)."""

from __future__ import annotations

import torch


def nu_threshold(barrier_dot, con_l1, rho, tiny):
    """Merit-penalty threshold (reference pyipm.py:1727-1735):
    (grad(phi_barrier) . dz) / ((1 - rho) * ||c||_1 + tiny)."""
    return barrier_dot / ((1.0 - rho) * con_l1 + tiny)


def centrality_mu(sl, smin, ntot, eps, mu_floor):
    """Adaptive centrality barrier update (reference pyipm.py:1804-1814),
    floored at ``mu_floor``:

        xi = N * min(s o lambda_i) / (s . lambda_i)
        mu = 0.1 * min(0.05 (1 - xi)/xi, 2)^3 * (s . lambda_i) / N
    """
    xi = ntot * smin / (sl + eps)
    mu_new = (0.1 * torch.clamp(0.05 * (1.0 - xi) / (xi + eps), max=2.0) ** 3
              * sl / ntot)
    return torch.clamp(mu_new, min=mu_floor)
