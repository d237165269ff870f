"""Batched small LDL^T factorization and solve: the Hopper kernels of
``csrc/small_ldlt.cu`` and their plain PyTorch versions.

Counterpart of ``ldlt_factor_small`` / ``ldlt_solve_small`` in
``pyipm_tpu/ops/pallas_ldlt.py`` (the Pallas ``_factor_kernel`` and
``_solve_kernel``), batch first: A is (B, n, n), row-major, n <= 128.

The wrappers dispatch on where the tensor lies: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.  ``LAUNCHES``
counts kernel launches per kernel, and ``LAUNCHES_BY_N`` the same launches
by (kernel, n); nothing else adds to them.
"""

from __future__ import annotations

import collections

import torch

from pyipm_tpu_torch.ops import _build

MAX_N = 128
LAUNCHES = {"factor": 0, "solve": 0}
LAUNCHES_BY_N = collections.Counter()


# ----------------------------------------------------------------------
# plain versions: same column order and zero-pivot guard as the kernels
def ldlt_factor_small_ref(A):
    """Right-looking unpivoted LDL^T of (B, n, n) -> (L (B, n, n) unit
    lower, d (B, n)).  A zero pivot divides by 1 (pallas_ldlt.py:73-75)."""
    B, n, _ = A.shape
    W = A.clone()
    L = torch.zeros_like(A)
    d = A.new_zeros((B, n))
    for j in range(n):
        dj = W[:, j, j].clone()
        safe = torch.where(torch.abs(dj) > 0, dj, torch.ones_like(dj))
        col = W[:, j + 1:, j] / safe[:, None]
        L[:, j + 1:, j] = col
        L[:, j, j] = 1
        d[:, j] = dj
        W[:, j + 1:, j + 1:] -= ((col[:, :, None] * col[:, None, :])
                                 * dj[:, None, None])
    return L, d


def ldlt_solve_small_ref(L, d, b, scale=None):
    """x = L^-T diag(d)^-1 L^-1 b for (B, n, n), (B, n), (B, n): forward
    substitution, zero-guarded diagonal scale, backward substitution.  With
    ``scale`` (B, n): scale * solve(scale * b), each product on its own."""
    if scale is not None:
        b = scale * b
    n = b.shape[-1]
    y = torch.zeros_like(b)
    for j in range(n):
        y[:, j] = b[:, j] - torch.sum(L[:, j, :j] * y[:, :j], dim=-1)
    z = y / torch.where(torch.abs(d) > 0, d, torch.ones_like(d))
    x = torch.zeros_like(b)
    for j in reversed(range(n)):
        x[:, j] = z[:, j] - torch.sum(L[:, j + 1:, j] * x[:, j + 1:], dim=-1)
    return x if scale is None else scale * x


# ----------------------------------------------------------------------
def ldlt_factor_small(A):
    """(B, n, n) -> (L, d).  CUDA: the hand-written kernel; CPU: plain."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be (B, n, n), got {tuple(A.shape)}")
    B, n, _ = A.shape
    if n > MAX_N:
        raise ValueError(f"n = {n} > {MAX_N}: not a small system")
    _build.check_operand("A", A, (B, n, n), A.dtype, A.device)
    if A.device.type == "cpu":
        return ldlt_factor_small_ref(A)
    if A.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {A.device}")
    L = torch.empty_like(A)
    d = A.new_empty((B, n))
    if B == 0:
        return L, d
    _build.launch("pyipm_ldlt_factor", "ldlt_factor_small", A.dtype,
                  A.device, A.data_ptr(), L.data_ptr(), d.data_ptr(), B, n)
    LAUNCHES["factor"] += 1
    LAUNCHES_BY_N["factor", n] += 1
    return L, d


def ldlt_solve_small(L, d, b, scale=None):
    """(B, n, n), (B, n), (B, n) -> x (B, n); with a row scale ``scale``
    (B, n), scale * solve(scale * b) in the same launch.  CUDA: the
    hand-written kernel; CPU: plain."""
    if L.dim() != 3 or L.shape[1] != L.shape[2]:
        raise ValueError(f"L must be (B, n, n), got {tuple(L.shape)}")
    B, n, _ = L.shape
    if n > MAX_N:
        raise ValueError(f"n = {n} > {MAX_N}: not a small system")
    _build.check_operand("L", L, (B, n, n), L.dtype, L.device)
    _build.check_operand("d", d, (B, n), L.dtype, L.device)
    _build.check_operand("b", b, (B, n), L.dtype, L.device)
    if scale is not None:
        _build.check_operand("scale", scale, (B, n), L.dtype, L.device)
    if L.device.type == "cpu":
        return ldlt_solve_small_ref(L, d, b, scale)
    if L.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {L.device}")
    x = torch.empty_like(b)
    if B == 0:
        return x
    _build.launch("pyipm_ldlt_solve", "ldlt_solve_small", L.dtype,
                  L.device, L.data_ptr(), d.data_ptr(), b.data_ptr(),
                  None if scale is None else scale.data_ptr(),
                  x.data_ptr(), B, n)
    LAUNCHES["solve"] += 1
    LAUNCHES_BY_N["solve", n] += 1
    return x
