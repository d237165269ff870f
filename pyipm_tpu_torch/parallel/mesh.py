"""Process meshes (counterpart of ``pyipm_tpu/parallel/mesh.py``).

A rank is a process.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, with the JAX package's two logical dimensions:

  - ``batch``: independent NLP instances, no collective;
  - ``model``: the blocks of one block-separable NLP, reduced over the
    group of this dimension (``parallel/schur.py``).

``mesh=None`` everywhere means one process.  Build a mesh after
``parallel.distributed.initialize`` has joined the ranks.
"""

from __future__ import annotations

import torch


def _world(device) -> tuple:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call pyipm_tpu_torch.parallel."
                           "distributed.initialize() first (mesh=None runs "
                           "one process)")
    dev = torch.device("cuda" if device is None else device)
    return dist.get_world_size(), dev.type


def make_batch_mesh(device=None):
    """1-D mesh with a ``batch`` dimension over every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    world, dev_type = _world(device)
    return init_device_mesh(dev_type, (world,), mesh_dim_names=("batch",))


def make_solver_mesh(batch: int, model: int, device=None):
    """2-D (batch, model) mesh: instances x blocks of one instance;
    batch * model must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    world, dev_type = _world(device)
    if batch * model != world:
        raise ValueError(f"mesh {batch} x {model} != {world} ranks")
    return init_device_mesh(dev_type, (batch, model),
                            mesh_dim_names=("batch", "model"))
