"""``MemoryRuntime`` — the single facade over the memory-tier machinery.

Built once from ``(MeshPlan, MemoryPlan)`` and a device, it owns the
:class:`~repro_torch.core.tiers.MemoryTier` stack and meters every
stash/fetch: :meth:`traffic_report` gives per-direction logical and wire
bytes plus an estimated transfer time against the tier's bandwidth
contract.  The serving stack spills cold KV through one
(``kv_stash``/``kv_fetch``).  The training wrapper (``wrap_layer``) comes
with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import hw
from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.core.tiers import (MemoryTier, SpillTier, TransferHints,
                                    build_tier)


@dataclasses.dataclass
class TierTraffic:
    """Transfer meter for one direction through the tier."""

    calls: int = 0
    raw_bytes: float = 0.0        # tensor bytes before compression
    wire_bytes: float = 0.0       # bytes that actually cross the interconnect

    def add(self, raw: float, wire: float) -> None:
        self.calls += 1
        self.raw_bytes += raw
        self.wire_bytes += wire


class MemoryRuntime:
    """Facade: tier + per-call accounting for one device."""

    def __init__(self, plan: MeshPlan, memory: MemoryPlan,
                 device: torch.device = "cuda",
                 chip: hw.Chip = hw.H100,
                 tier: Optional[MemoryTier] = None):
        self.plan = plan
        self.memory = memory
        self.device = torch.device(device)
        self.chip = chip
        self.tier: MemoryTier = tier if tier is not None \
            else build_tier(memory, plan, self.device)
        self._traffic: Dict[str, TierTraffic] = {}

    @property
    def offloads(self) -> bool:
        """Whether stashes actually move tensors."""
        return self.tier.offloads

    # ------------------------------------------------------------------
    def _meter(self, direction: str, x: torch.Tensor,
               hints: Optional[TransferHints] = None) -> None:
        raw = float(x.numel()) * x.element_size()
        wire = raw * self.tier.wire_ratio(x, hints or TransferHints())
        self._traffic.setdefault(direction, TierTraffic()).add(raw, wire)

    def traffic_report(self) -> Dict[str, Any]:
        """Per-tier byte/stall accounting of every metered stash/fetch."""
        bw = self.tier.bandwidth(self.plan, self.chip)
        n_dev = max(self.plan.num_devices, 1)
        report: Dict[str, Any] = {
            "tier": self.tier.describe(),
            "bandwidth_per_dev": bw,
        }
        total_wire = 0.0
        for direction, t in sorted(self._traffic.items()):
            report[direction] = {
                "calls": t.calls, "raw_bytes": t.raw_bytes,
                "wire_bytes": t.wire_bytes,
            }
            total_wire += t.wire_bytes
        report["wire_bytes_total"] = total_wire
        report["est_transfer_s"] = (total_wire / (bw * n_dev)
                                    if bw > 0 and total_wire else 0.0)
        return report

    # ------------------------------------------------------------------
    # data path (metered tier passthrough); ``direction`` labels the
    # traffic-report bucket
    def stash(self, x: torch.Tensor, hints: Optional[TransferHints] = None,
              direction: str = "stash"):
        hints = hints or TransferHints()
        if self.offloads:
            self._meter(direction, x, hints)
        return self.tier.stash(x, hints)

    def fetch(self, payload, hints: Optional[TransferHints] = None,
              direction: str = "fetch") -> torch.Tensor:
        hints = hints or TransferHints()
        x = self.tier.fetch(payload, hints)
        if self.offloads:
            self._meter(direction, x, hints)
        return x

    def discard(self, payload) -> None:
        """Release a parked payload's capacity-contract charge (a
        :class:`~repro_torch.core.tiers.SpillTier` in the stack gets its
        budget back).  No-op for tiers without a byte ledger."""
        if isinstance(self.tier, SpillTier):
            self.tier.discard(payload)


def fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n/div:.2f}{unit}"
    return f"{n:.0f}B"
