"""The pooled-memory tier's layout and capacity (the paper's memory-nodes,
§III-A).

The pool is the aggregate HBM of the mesh: a tensor stashed to the pool
is re-sharded so that each device keeps only 1/pool_size of it, and is
fetched back (all-gathered over the device links) right before its
backward use (``core/tiers.PooledHbmTier``).  :func:`pool_spec` is that
layout; :class:`PoolAxes` says which mesh axes a placement stripes a
stash across, :class:`PoolAccountant` keeps a device's memory map against
its HBM budget and the pooled capacity it can address.

Placement policies (paper Fig. 10):

* ``bw_aware`` — the stash is striped over **all** mesh axes, so the
  fetch collective moves traffic over both mesh dimensions' links.
* ``local`` — the stash is sharded over the 'model' axis only; the fetch
  all-gathers over a single mesh dimension (one neighbour's links).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.parallel.sharding import PartitionSpec, ShardingPlanner


@dataclasses.dataclass(frozen=True)
class PoolAxes:
    """Which mesh axes form the pool for each placement policy."""

    plan: MeshPlan

    @property
    def bw_aware(self) -> Tuple[str, ...]:
        # stripe across every device-side axis (paper: left+right nodes).
        return tuple(a for a in self.plan.axes)

    @property
    def local(self) -> Tuple[str, ...]:
        # a single mesh dimension (paper: one neighbour memory-node).
        return ("model",) if "model" in self.plan.axes else self.plan.axes[-1:]

    def axes_for(self, placement: str) -> Tuple[str, ...]:
        return self.bw_aware if placement == "bw_aware" else self.local

    def pool_size(self, placement: str) -> int:
        return math.prod(self.plan.axis_size(a) for a in self.axes_for(placement))


def pool_spec(shape: Sequence[int], planner: ShardingPlanner,
              placement: str = "bw_aware",
              batch_dim: Optional[int] = None,
              name: str = "stash") -> PartitionSpec:
    """PartitionSpec of a stashed tensor of global ``shape`` (the
    reference's layouts and fallbacks):

    * ``local``    — batch keeps its data-parallel axes; the first
      divisible non-batch dim (dim 1, the sequence of a (B, S, D)
      residual, else the largest) is sharded over 'model'.
    * ``bw_aware`` — the batch dim extended over the model axis when
      divisible (P(('pod', 'data', 'model'), ...)), so every device of
      the pool holds a distinct block of rows; otherwise the ``local``
      layout.
    """
    plan = planner.plan
    model_axes = ("model",) if "model" in plan.axes else plan.axes[-1:]
    model_size = math.prod(plan.axis_size(a) for a in model_axes)
    batch_axes = planner.axes.batch
    batch_size = math.prod(plan.axis_size(a) for a in batch_axes)

    assignment: list = [None] * len(shape)
    if batch_dim is not None and batch_dim < len(shape):
        assignment[batch_dim] = batch_axes

    if placement == "bw_aware" and batch_dim is not None and \
            batch_dim < len(shape) and \
            shape[batch_dim] % (batch_size * model_size) == 0:
        assignment[batch_dim] = tuple(batch_axes) + tuple(model_axes)
        return planner.spec(shape, assignment, name=name)

    order = [i for i in range(len(shape)) if i != batch_dim]
    order.sort(key=lambda i: (i != 1, -shape[i]))      # prefer dim 1, then size
    for i in order:
        if shape[i] > 0 and shape[i] % model_size == 0:
            assignment[i] = model_axes
            break
    return planner.spec(shape, assignment, name=name)


@dataclasses.dataclass
class PoolAccountant:
    """Boot-time memory map of one device: device-local vs pooled bytes
    against its HBM budget, and the pool it can address (paper Fig. 10).
    The KEEP / POOL / RECOMPUTE planner (core/policy.py) charges its
    decisions here."""

    plan: MeshPlan
    memory: MemoryPlan
    local_bytes: float = 0.0          # resident per-device bytes
    pooled_bytes: float = 0.0         # per-device share of pooled tensors
    host_bytes: float = 0.0           # per-device share parked in host DRAM
                                      # (no HBM cost)

    @property
    def pool_devices(self) -> int:
        return PoolAxes(self.plan).pool_size(self.memory.placement)

    @property
    def budget(self) -> float:
        return self.memory.hbm_budget_gb * 1e9

    def alloc_local(self, nbytes: float) -> None:
        self.local_bytes += nbytes

    def alloc_pooled(self, nbytes: float) -> None:
        # a pooled tensor of `nbytes` costs nbytes/pool_size per device
        self.pooled_bytes += nbytes / max(self.pool_devices, 1)

    def alloc_host(self, nbytes: float) -> None:
        # host-tier stash: occupies DRAM, not HBM (DC-DLA baseline)
        self.host_bytes += nbytes

    @property
    def per_device(self) -> float:
        return self.local_bytes + self.pooled_bytes

    @property
    def fits(self) -> bool:
        return self.per_device <= self.budget

    @property
    def headroom(self) -> float:
        return self.budget - self.per_device

    def system_capacity(self) -> float:
        """Total pooled capacity exposed to one device: its own HBM plus
        its share of every other device's."""
        return self.budget * self.pool_devices
