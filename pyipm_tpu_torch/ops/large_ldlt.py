"""Kernels of the large-K factorization and solve: the Hopper kernels of
``csrc/panel_ldlt.cu``, ``csrc/bwd_sweep_panels.cu`` and
``csrc/bwd_sweep_blocks.cu`` and their plain PyTorch versions.

  - :func:`panel_ldlt` — LDL^T of one n x n diagonal panel (n <= 128), or
    of a batch of them in one launch, counterpart of the Pallas
    ``_panel_kernel`` / ``panel_ldlt`` (pyipm_tpu/ops/pallas_ldlt.py:198-245;
    the JAX package batches it under ``vmap``); one kernel code in two
    variants, one panel an SM or two (:func:`panels_per_sm` picks by the
    batch and the card's SM count);
  - :func:`bwd_sweep_panels` / :func:`bwd_sweep_blocks` — the backward
    substitution L^T x = z from the padded factor and the inverses of its
    128-wide panels or of its superblocks, counterparts of the Pallas
    ``_bwd_sweep_panels_kernel`` and ``_bwd_sweep_kernel``
    (pallas_ldlt.py:386-670).

The wrappers dispatch on where the tensor lies: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.  Each runs whole
in a profiling scope (``ipm-k3-panel``, ``ipm-k4-sweep-panels``,
``ipm-k5-sweep-blocks``).  ``LAUNCHES``
counts kernel launches per wrapper, and ``LAUNCHES_BY_B`` the panel
kernel's launches by (kernel, number of panels); nothing else adds to
them.  Each sweep is
one kernel launch whose CTAs chain the block steps by flags or counters in
device memory (``csrc/bwd_sweep_panels.cu``, ``csrc/bwd_sweep_blocks.cu``).
Both cut their work into 128 x 128 tiles, so on the card a block width that
is no multiple of 128 raises.
"""

from __future__ import annotations

import collections
import functools

import torch

from pyipm_tpu_torch.ops import _build
from pyipm_tpu_torch.utils import profiling

MAX_PANEL = 128
SWEEP_MAX_W = 4096
LAUNCHES = {"panel_ldlt": 0, "bwd_sweep_panels": 0, "bwd_sweep_blocks": 0}
LAUNCHES_BY_B = collections.Counter()


# ----------------------------------------------------------------------
# plain versions
def panel_ldlt_ref(A):
    """Unpivoted right-looking LDL^T of one (n, n) panel -> (L unit lower,
    d), in the Pallas panel kernel's arithmetic: l = a_j / safe, trailing
    update a -= (l * safe) l^T, a zero pivot divides (and multiplies) by 1
    (pallas_ldlt.py:205-221).  A batch (B, n, n) is mapped panel by panel
    (``torch.vmap`` of the single form)."""
    if A.dim() == 3:
        return torch.vmap(panel_ldlt_ref)(A)
    n = A.shape[0]
    W = A.clone()
    L = torch.zeros_like(A)
    d = A.new_zeros((n,))
    for j in range(n):
        dj = W[j, j].clone()
        safe = torch.where(torch.abs(dj) > 0, dj, torch.ones_like(dj))
        col = W[j + 1:, j] / safe
        L[j + 1:, j] = col
        L[j, j] = 1
        d[j] = dj
        W[j + 1:, j + 1:] -= (col * safe)[:, None] * col[None, :]
    return L, d


def bwd_sweep_ref(Lp, z, inv):
    """x with L^T x = z by block backward substitution at the block width
    w of ``inv`` (nsteps, w, w), the inverses of Lp's diagonal blocks:
    x_k = inv_k^T (z_k - Lp[(k+1)w:, kw:(k+1)w]^T x[(k+1)w:]), k descending
    (linalg.py:579-622)."""
    nsteps, w, _ = inv.shape
    x = torch.zeros_like(z)
    for k in reversed(range(nsteps)):
        j0, j1 = k * w, (k + 1) * w
        acc = Lp[j1:, j0:j1].T @ x[j1:]
        x[j0:j1] = inv[k].T @ (z[j0:j1] - acc)
    return x


# ----------------------------------------------------------------------
def panels_per_sm(B: int, sm_count: int, dtype) -> int:
    """The panel kernel's variant for a batch of B panels: 2 (two panels an
    SM, 8 warps each) when the batch has more panels than the card has SMs,
    so that it runs in half the waves; else 1 (one panel an SM in 16 warps:
    a single panel is bound by its 128-step chain).  Only float32 has the
    two-panel variant (float64's shared memory fits one)."""
    return 2 if dtype == torch.float32 and B > sm_count else 1


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def panel_residency(per_sm: int, dtype, device) -> int:
    """CTAs of the ``per_sm`` variant resident an SM at n = 128, by the
    occupancy calculator on ``device`` (a card)."""
    return _build.query("pyipm_panel_ldlt_residency", "panel_ldlt", dtype,
                        device, per_sm)[0]


def panel_ldlt(A):
    """(n, n) -> (L, d), or a batch (B, n, n) -> (L (B, n, n), d (B, n)) in
    one launch, n <= 128.  CUDA: the hand-written kernel, the variant by
    :func:`panels_per_sm`; CPU: plain."""
    with profiling.annotate("ipm-k3-panel", A.device):
        if A.dim() not in (2, 3) or A.shape[-1] != A.shape[-2]:
            raise ValueError(f"A must be (n, n) or (B, n, n), got "
                             f"{tuple(A.shape)}")
        n = A.shape[-1]
        B = A.shape[0] if A.dim() == 3 else 1
        if not 0 < n <= MAX_PANEL:
            raise ValueError(f"panel size {n} not in 1..{MAX_PANEL}")
        _build.check_operand("A", A, A.shape, A.dtype, A.device)
        if A.device.type == "cpu":
            return panel_ldlt_ref(A)
        if A.device.type != "cuda":
            raise RuntimeError(f"no kernel for device {A.device}")
        L = torch.empty_like(A)
        d = A.new_empty(A.shape[:-1])
        if B == 0:
            return L, d
        per_sm = panels_per_sm(B, sm_count(A.device), A.dtype)
        _build.launch("pyipm_panel_ldlt", "panel_ldlt", A.dtype, A.device,
                      A.data_ptr(), L.data_ptr(), d.data_ptr(), n, B, per_sm)
        LAUNCHES["panel_ldlt"] += 1
        LAUNCHES_BY_B["panel_ldlt", B] += 1
        return L, d


def _check_sweep(name, Lp, z, inv, max_w):
    """Raise unless (Lp, z, inv) are a sweep's operands with block width
    w <= ``max_w``; returns (npad, nsteps, w)."""
    if Lp.dim() != 2 or inv.dim() != 3:
        raise ValueError(f"{name}: Lp must be (npad, npad) and the inverses "
                         f"(nsteps, w, w), got {tuple(Lp.shape)}, "
                         f"{tuple(inv.shape)}")
    npad = Lp.shape[0]
    nsteps, w, _ = inv.shape
    if nsteps * w != npad or not 0 < w <= max_w:
        raise ValueError(f"{name}: {nsteps} blocks of {w} do not tile "
                         f"npad = {npad} (w <= {max_w})")
    dt, dev = Lp.dtype, Lp.device
    _build.check_operand("Lp", Lp, (npad, npad), dt, dev)
    _build.check_operand("z", z, (npad,), dt, dev)
    _build.check_operand("inv", inv, (nsteps, w, w), dt, dev)
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {dev}")
    return npad, nsteps, w


def _check_aligned(name, **tensors):
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned (the "
                             f"kernel reads it in 16-byte words)")


def panel_sweep_flags(npad: int, device):
    """The panel sweep's scratch: one int32 ready flag per 128-block of
    x, zeroed (the kernel sets flag k once x_k is written).  Fresh per
    call from the caching allocator, so concurrent sweeps on other streams
    never share flags."""
    if npad <= 0 or npad % MAX_PANEL:
        raise ValueError(f"npad = {npad} is not a positive multiple of "
                         f"{MAX_PANEL}")
    return torch.zeros((npad // MAX_PANEL,), dtype=torch.int32,
                       device=device)


def bwd_sweep_panels(Lp, z, invp):
    """x with L^T x = z from the grid-padded factor Lp (npad, npad), the
    diagonal-scaled forward-substituted z (npad,) and the 128-panel
    inverses invp (npad/128, 128, 128).  CUDA: the hand-written one-launch
    sweep; CPU: plain."""
    with profiling.annotate("ipm-k4-sweep-panels", Lp.device):
        name = "bwd_sweep_panels"
        npad, _, w = _check_sweep(name, Lp, z, invp, MAX_PANEL)
        if w != MAX_PANEL:
            raise ValueError(f"{name}: the inverses must be "
                             f"{MAX_PANEL}-wide panels, got w = {w}")
        if Lp.device.type == "cpu":
            return bwd_sweep_ref(Lp, z, invp)
        _check_aligned(name, Lp=Lp, invp=invp)
        x = torch.empty_like(z)
        ready = panel_sweep_flags(npad, Lp.device)
        _build.launch("pyipm_bwd_sweep_panels", name, Lp.dtype, Lp.device,
                      Lp.data_ptr(), z.data_ptr(), invp.data_ptr(),
                      x.data_ptr(), ready.data_ptr(), npad)
        LAUNCHES[name] += 1
        return x


def blocks_sweep_scratch(npad: int, w: int, dtype, device):
    """The one-launch superblock sweep's scratch, (counts, partials), for
    n = npad/w superblocks of g = w/128 sub-blocks: 2 n g int32 counters,
    zeroed (partials written per 128-group of x and of the slab sums), and
    room for the partial 128-vectors themselves, n g g of x and
    n g (n - 1) g of the slab sums, each written once before it is read.
    Fresh per call from the caching allocator, so concurrent sweeps on
    other streams never share them."""
    if w <= 0 or w % MAX_PANEL or npad <= 0 or npad % w:
        raise ValueError(f"npad = {npad}, w = {w}: the one-launch sweep "
                         f"needs w a multiple of {MAX_PANEL} dividing npad")
    n, g = npad // w, w // MAX_PANEL
    counts = torch.zeros((2 * n * g,), dtype=torch.int32, device=device)
    partials = torch.empty((n * g * (g + (n - 1) * g) * MAX_PANEL,),
                           dtype=dtype, device=device)
    return counts, partials


def bwd_sweep_blocks(Lp, z, invb):
    """The same x from the superblock inverses invb (npad/w, w, w).  CUDA:
    the hand-written one-launch sweep (w a multiple of 128, else it
    raises); CPU: plain."""
    with profiling.annotate("ipm-k5-sweep-blocks", Lp.device):
        name = "bwd_sweep_blocks"
        npad, _, w = _check_sweep(name, Lp, z, invb, SWEEP_MAX_W)
        if Lp.device.type == "cpu":
            return bwd_sweep_ref(Lp, z, invb)
        _check_aligned(name, Lp=Lp, invb=invb)
        counts, partials = blocks_sweep_scratch(npad, w, Lp.dtype,
                                                Lp.device)
        x = torch.empty_like(z)
        _build.launch("pyipm_bwd_sweep_blocks", name, Lp.dtype, Lp.device,
                      Lp.data_ptr(), z.data_ptr(), invb.data_ptr(),
                      x.data_ptr(), partials.data_ptr(), counts.data_ptr(),
                      npad, w)
        LAUNCHES[name] += 1
        return x
