"""Mesh construction.

FUNCTIONS, not module-level constants: importing this module touches no
device and no process group.  A mesh is a ``torch.distributed``
``DeviceMesh`` over an initialised process group: nothing on the machine
tells a program of a cluster, so the caller calls ``init_process_group``
with its address, world size and rank, or :func:`init_distributed` reads
them from ``torchrun``'s environment.  One device has no mesh
(``None``), as the reference on one device.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import MeshPlan, MULTI_POD, SINGLE_POD

#: how long a collective may wait for its peers before it fails
TIMEOUT_S = 600


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type() -> str:
    """The mesh's device type: the group's backend decides (a gloo group
    is a CPU mesh even where its ranks compute on a card)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_backend() != "nccl":
        return "cpu"
    return "cuda" if torch.cuda.is_available() else "cpu"


def init_distributed(backend: str = "", device: str = "cuda",
                     timeout_s: int = TIMEOUT_S
                     ) -> Tuple[int, int, torch.device, str]:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) with ``timeout_s`` on every
    collective.  ``backend``: nccl or gloo, by default nccl for a card
    and gloo for the CPU.  Returns ``(rank, world, device, backend)``:
    the device is ``cuda:LOCAL_RANK``, or ``cuda:0`` for every rank when
    the node's ranks outnumber its cards (ranks sharing one card, which
    NCCL refuses: gloo only), the CPU for ``device="cpu"``.  A process
    that has joined already keeps its group (a second run in one
    process)."""
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available (pass --device cpu)")
        shared = torch.cuda.device_count() < local_world
        if shared and backend == "nccl":
            raise RuntimeError(
                f"{local_world} ranks share {torch.cuda.device_count()} "
                "card(s): NCCL refuses two ranks on one device; use "
                "--dist-backend gloo")
        dev = torch.device("cuda", 0 if shared else local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError("this process joined another process group")
        return rank, world, dev, dist.get_backend()
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, dev, backend


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) ``("pod",
    "data", "model")`` with ``multi_pod``, over a process group of 256
    (512) ranks.  Any other world raises: runs at the production mesh's
    size are ROADMAP A8b's."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = _world_size()
    if world != want:
        raise NotImplementedError(
            f"the production mesh {shape} needs a process group of {want} "
            f"ranks, this one has {world}: runs on the production mesh "
            "port with ROADMAP A8b")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def plan_for(*, multi_pod: bool = False) -> MeshPlan:
    return MULTI_POD if multi_pod else SINGLE_POD


def host_plan(n: int) -> Optional[MeshPlan]:
    """The plan of :func:`make_host_mesh`'s mesh over ``n`` ranks (the
    reference's ``MeshPlan((2, n // 2), ("data", "model"))``); None for
    one."""
    if n == 1:
        return None
    d = 2 if n % 2 == 0 else 1
    return MeshPlan((d, n // d), ("data", "model"))


def make_host_mesh(n: int = 0):
    """Small ``("data", "model")`` mesh over ``n`` ranks of the initialised
    process group (all of them for 0); ``None`` for one device."""
    n = n or _world_size()
    plan = host_plan(n)
    if plan is None:
        return None
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_host_mesh({n}) needs an initialised "
                           f"process group of {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), plan.shape,
                            mesh_dim_names=plan.axes)
