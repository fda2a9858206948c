"""Production meshes (counterpart of ``repro.launch.mesh``), as
functions: importing this module touches no process-group state.

The shapes are the reference's, so that dry runs on either side compare:
one pod is 16 x 16 = 256 ranks ``("data", "model")``, two pods are
2 x 16 x 16 = 512 ranks ``("pod", "data", "model")``.  Both need an
initialised ``torch.distributed`` process group of that world size (the
dry run's ``"fake"`` group, or a real one).  A mesh lives on the card
under an NCCL group and on the CPU under any other (``"gloo"``,
``"fake"``).
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_device_type",
           "PRODUCTION_SHAPES"]

#: multi_pod -> (shape, axis names)
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def _world(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no torch.distributed process group is "
                           "initialised")
    return dist.get_world_size()


def mesh_device_type() -> str:
    """``"cuda"`` under an NCCL group, ``"cpu"`` under any other."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks with a 'pod' axis.
    The process group's world size must be the mesh's size."""
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    n = _world("make_production_mesh")
    size = 1
    for s in shape:
        size *= s
    if n != size:
        raise ValueError(f"make_production_mesh: a {'x'.join(map(str, shape))}"
                         f" mesh needs {size} ranks, the group has {n}")
    return init_device_mesh(mesh_device_type(), shape, mesh_dim_names=names)


def make_local_mesh(n_data: Optional[int] = None,
                    n_model: int = 1) -> DeviceMesh:
    """A ``("data", "model")`` mesh over the ranks of the initialised
    group (one card: 1 x 1).  ``n_data`` defaults to
    ``world_size // n_model``."""
    n = _world("make_local_mesh")
    n_data = n // n_model if n_data is None else n_data
    if n_data * n_model != n:
        raise ValueError(f"make_local_mesh: {n_data} x {n_model} is not the "
                         f"group's {n} ranks")
    return init_device_mesh(mesh_device_type(), (n_data, n_model),
                            mesh_dim_names=("data", "model"))
