"""Divisibility-aware sharding planner.

DTensor, like GSPMD, shards a dim evenly only when the dim divides by the
mesh axes it is split over, so every spec is produced through
:class:`ShardingPlanner`, which drops an axis assignment when the dim is
not divisible and records the fallback.  That is what lets one code path
serve all 10 architectures (36-head starcoder2 and 9-head smollm simply
fall back to sequence-parallel activations).

A spec is a :class:`PartitionSpec` of the port's own: a tuple with one
entry a tensor dim (``None``, an axis name or a tuple of names), trailing
``None`` dropped.  :meth:`ShardingPlanner.named` turns it into the DTensor
placements (``Shard(d)`` / ``Replicate()``) of each dimension of a
``DeviceMesh``.  The port runs on one device so far: the sharded step,
and with it :func:`constrain` on a larger mesh, is ROADMAP A8's.

Logical axes used throughout the codebase:
  "batch"  -> physical ("pod", "data")        DP / FSDP batch shard
  "fsdp"   -> physical ("data",)              weight pooling (ZeRO-3)
  "tensor" -> physical ("model",)             Megatron TP
  "expert" -> physical ("model",)             expert parallelism
  "pool"   -> paper's memory-node striping (see core/pool.py)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import MeshPlan

AxisAssignment = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name or
    a tuple of names (the dim split over their product, in order)."""

    def __new__(cls, *parts: AxisAssignment) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical→physical axis translation for a mesh plan."""

    plan: MeshPlan

    @property
    def batch(self) -> Tuple[str, ...]:
        return self.plan.batch_axes            # ("pod","data") or ("data",)

    @property
    def fsdp(self) -> Tuple[str, ...]:
        return ("data",) if "data" in self.plan.axes else ()

    @property
    def tensor(self) -> Tuple[str, ...]:
        return ("model",) if "model" in self.plan.axes else ()

    expert = tensor

    def size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.plan.axis_size(a)
        return n


def _flatten(assignment: AxisAssignment) -> Tuple[str, ...]:
    if assignment is None:
        return ()
    if isinstance(assignment, str):
        return (assignment,)
    return tuple(assignment)


class ShardingPlanner:
    """Builds PartitionSpecs, silently dropping non-divisible assignments."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan
        self.axes = Axes(plan)
        self.fallbacks: Dict[str, str] = {}

    def spec(self, shape: Sequence[int], assignment: Sequence[AxisAssignment],
             name: str = "?") -> PartitionSpec:
        assert len(shape) == len(assignment), (name, shape, assignment)
        parts = []
        for dim, want in zip(shape, assignment):
            ax = _flatten(want)
            # keep the largest prefix of axes whose product divides dim
            kept: Tuple[str, ...] = ()
            size = 1
            for a in ax:
                if a not in self.plan.axes:
                    continue
                nxt = size * self.plan.axis_size(a)
                if dim % nxt == 0:
                    kept = kept + (a,)
                    size = nxt
                else:
                    self.fallbacks[f"{name}[{dim}]"] = (
                        f"dropped axis {a!r} (dim {dim} % {nxt} != 0)")
            if not kept:
                parts.append(None)
            elif len(kept) == 1:
                parts.append(kept[0])
            else:
                parts.append(kept)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def named(self, mesh, shape: Sequence[int],
              assignment: Sequence[AxisAssignment], name: str = "?"
              ) -> tuple:
        """The DTensor placements of :meth:`spec` on ``mesh`` (a
        ``DeviceMesh`` whose dimension names are the plan's axes): one
        per mesh dimension, ``Shard(d)`` where tensor dim ``d`` is split
        over it, else ``Replicate()``."""
        return placements(mesh, self.spec(shape, assignment, name))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per dimension."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names or ()
    out = [Replicate() for _ in range(mesh.ndim)]
    for d, part in enumerate(spec):
        for a in _flatten(part):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_to_spec(planner: ShardingPlanner, shape: Sequence[int],
                    logical: Sequence[Optional[str]], name: str = "?"
                    ) -> PartitionSpec:
    """Translate logical dim roles into a PartitionSpec.

    Roles: "batch", "fsdp", "tensor", "expert", "seq", None.
    "seq" is unsharded by default (sequence parallelism is applied explicitly
    through constraint helpers in the model code / core.pool).
    """
    ax = planner.axes
    table: Dict[Optional[str], AxisAssignment] = {
        None: None,
        "batch": ax.batch,
        "fsdp": ax.fsdp,
        "tensor": ax.tensor,
        "expert": ax.expert,
        "seq": None,
    }
    return planner.spec(shape, [table[r] for r in logical], name)


def constrain(x: torch.Tensor, mesh, spec: PartitionSpec) -> torch.Tensor:
    """The sharding constraint: a no-op off-mesh (no mesh, or a mesh of one
    device).  A larger mesh raises: the sharded step is ROADMAP A8's."""
    if mesh is None or mesh.size() == 1:
        return x
    raise NotImplementedError(
        f"constrain({spec}) on a mesh of {mesh.size()} devices: the "
        "sharded (DTensor) step ports with ROADMAP A8")
