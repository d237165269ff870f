"""Joining the ranks (counterpart of ``pyipm_tpu/parallel/distributed.py``).

Each rank runs the same program.  :func:`initialize` joins them into one
``torch.distributed`` process group; the meshes of
``parallel/mesh.py`` are built over it::

    from pyipm_tpu_torch.parallel import distributed as dist
    dist.initialize()                  # the launcher's environment
    mesh = dist.global_solver_mesh(batch=1, model=dist.world_size())
    fn = make_block_solver(spec, mesh, cfg)

The backend is NCCL for a ``cuda`` device and gloo for ``cpu``, unless
the caller names one; nothing switches from one to the other.  The JAX
package's virtual-CPU-device flag (``PYIPM_LOCAL_DEVICES``) is an XLA
device-count mechanism and has no counterpart: here a rank is a process.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from pyipm_tpu_torch.parallel import launch as _launch
from pyipm_tpu_torch.parallel import mesh as _mesh


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None,
               timeout_s: float = 600.0) -> bool:
    """Join the process group; returns whether one was joined.

    Rendezvous, in order: the explicit arguments; the ``PYIPM_*`` block
    that ``parallel/launch.py`` sets (all three variables, or an error);
    otherwise one process (nothing is joined, and ``mesh=None`` runs
    everywhere).  ``device`` (the card when None) picks the backend: NCCL
    for ``cuda``, gloo for ``cpu``; ``backend`` names one instead.  A
    second call is a no-op."""
    dist = _dist()
    if dist.is_initialized():
        return True
    if coordinator_address is None and num_processes is None:
        coordinator_address = os.environ.get(_launch.ENV_COORD)
        if coordinator_address is not None:
            nproc = os.environ.get(_launch.ENV_NPROC)
            pid = os.environ.get(_launch.ENV_PROC_ID)
            if nproc is None or pid is None:
                raise RuntimeError(
                    f"incomplete launcher rendezvous environment: "
                    f"{_launch.ENV_COORD} is set but {_launch.ENV_NPROC}/"
                    f"{_launch.ENV_PROC_ID} "
                    f"{'are' if nproc is None and pid is None else 'is'} "
                    f"missing; all three must be set together (see "
                    f"pyipm_tpu_torch.parallel.launch.rendezvous_env)")
            num_processes, process_id = int(nproc), int(pid)
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError("num_processes > 1 needs a coordinator_address")
        return False
    if num_processes is None or process_id is None:
        raise ValueError("coordinator_address needs num_processes and "
                         "process_id")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for gloo "
                               "on the CPU")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    import datetime
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world_size() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch_mesh(device=None):
    """1-D ``batch`` mesh over every rank."""
    return _mesh.make_batch_mesh(device=device)


def global_solver_mesh(batch: int, model: int, device=None):
    """2-D (batch, model) mesh over every rank; batch * model ranks."""
    return _mesh.make_solver_mesh(batch, model, device=device)


def host_local_slice(global_batch: int, mesh=None,
                     axis: str = "batch") -> slice:
    """This rank's [start, stop) of a leading global batch axis: of the
    ``axis`` dimension of ``mesh``, or of the world when None (all of it
    in one process).  The batch must divide evenly."""
    if mesh is not None:
        g = mesh.get_group(axis)
        n, i = _dist().get_world_size(g), _dist().get_rank(g)
    else:
        n, i = world_size(), rank()
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {n} ranks")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()
