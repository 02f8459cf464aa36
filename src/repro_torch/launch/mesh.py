"""Mesh construction.

FUNCTIONS, not module-level constants: importing this module touches no
device and no process group.  A mesh is a ``torch.distributed``
``DeviceMesh`` over an initialised process group (nothing on the machine
tells a program of a cluster: the caller calls
``init_process_group`` with its address, world size and rank).  One
device has no mesh (``None``), as the reference on one device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MeshPlan, MULTI_POD, SINGLE_POD


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over a process group of 256
    (512) ranks.  Any other world raises: the sharded step that would use
    it is ROADMAP A8's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = _world_size()
    if world != want:
        raise NotImplementedError(
            f"the production mesh {shape} needs a process group of {want} "
            f"ranks, this one has {world}: multi-device runs port with "
            "ROADMAP A8")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def plan_for(*, multi_pod: bool = False) -> MeshPlan:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_host_mesh(n: int = 0):
    """Small ``("data", "model")`` mesh over ``n`` ranks of the initialised
    process group (all of them for 0); ``None`` for one device."""
    n = n or _world_size()
    if n == 1:
        return None
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_host_mesh({n}) needs an initialised "
                           f"process group of {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    d = 2 if n % 2 == 0 else 1
    return init_device_mesh(_device_type(), (d, n // d),
                            mesh_dim_names=("data", "model"))
