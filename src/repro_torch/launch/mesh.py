"""Mesh builders, as ``repro.launch.mesh``: the production meshes of the
dry run and the local mesh.  Functions, so importing this module touches
no process group.

The caller initialises the process group (``torch.distributed
.init_process_group`` with its backend, address, world size and rank);
the mesh folds its ranks into named dims.  The dry run
(``launch/dryrun.py``) gives the production meshes a fake process group
of 256 or 512 ranks, which holds no memory and moves no bytes.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """Single pod: 16 x 16 = 256 ranks, dims (data, model).  Multi-pod:
    2 pods x 256 = 512 ranks, dims (pod, data, model).  The initialised
    process group must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = shape[0] * shape[1] * (shape[2] if multi_pod else 1)
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """Every rank of the initialised process group, folded into (data,
    model) = (world / model_parallel, model_parallel)."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not fold into model parallel "
                         f"{model_parallel}")
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=("data", "model"))
