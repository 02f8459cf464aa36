"""Capacity accounting for the pooled-memory tier (the paper's memory-nodes).

The reference realises the pool as the aggregate HBM of a device mesh; the
port runs on one card, so only the capacity side is needed:
:class:`PoolAccountant` keeps a device's memory map against its HBM budget
and the pooled capacity it can address, and :class:`PoolAxes` says how
many devices a placement stripes a stash across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.configs.base import MemoryPlan, MeshPlan


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
