"""Local mesh builder, as ``repro.launch.mesh``'s ``make_local_mesh``.  A
function, so importing this module touches no process group.

The caller initialises the process group (``torch.distributed
.init_process_group`` with its backend, address, world size and rank);
the mesh folds its ranks into (data, model).  The 256- and 512-chip
production meshes belong to the dry run (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


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
