"""Capacity accounting for the pooled-memory tier (the paper's memory-nodes).

The reference realises the pool as the aggregate HBM of a device mesh; this
slice of the port runs on one card, so only the capacity side is needed:
:class:`PoolAccountant` gives a device's HBM budget and the pooled capacity
it can address, and :class:`PoolAxes` says how many devices a placement
stripes a stash across.
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
    """Boot-time memory map of one device: its HBM budget and the pool it
    can address (paper Fig. 10)."""

    plan: MeshPlan
    memory: MemoryPlan

    @property
    def pool_devices(self) -> int:
        return PoolAxes(self.plan).pool_size(self.memory.placement)

    @property
    def budget(self) -> float:
        return self.memory.hbm_budget_gb * 1e9

    def system_capacity(self) -> float:
        """Total pooled capacity exposed to one device: its own HBM plus
        its share of every other device's."""
        return self.budget * self.pool_devices
