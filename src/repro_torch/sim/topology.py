"""System design points of the paper's evaluation (§IV-§V).

Each :class:`SystemConfig` captures how one architecture partitions the
N=6 x B=25 GB/s high-bandwidth links between inter-device communication and
memory virtualization, plus the virtualization backing store's own limits:

  DC-DLA      all 6 links -> 3x8-node rings; virt over PCIe gen3 to host
  HC-DLA      3 links to CPU (75 GB/s virt), 3 links -> 1.5 rings; host
              socket overprovisioned to 300 GB/s for 4 devices (paper §IV)
  MC-DLA(S)   Fig 7(a/b): 2 links to a dedicated memory-node (50 GB/s
              virt), 4 links -> 2 rings; rings unbalanced (20-hop max)
  MC-DLA(L)   Fig 7(c) rings, LOCAL placement: one neighbour memory-node
              -> 3 links = 75 GB/s virt; 3x16-node rings for comm
  MC-DLA(B)   Fig 7(c) rings, BW_AWARE striping: left+right nodes
              -> 6 links = 150 GB/s virt; same 3x16-node rings
  DC-DLA(O)   oracle: infinite device memory, no virtualization traffic
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch import hw
from repro_torch.core.tiers import TierSpec


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    name: str
    n_devices: int = 8
    device: hw.Chip = hw.PAPER_DEVICE

    # collective communication
    n_rings: float = 3.0            # concurrent rings
    ring_nodes: int = 8             # nodes per ring (hop count driver)
    ring_link_bw: float = 25e9      # per-direction GB/s of one ring link

    # memory virtualization — the backing store is a tier configuration:
    # "device" (oracle, nothing leaves HBM), "host" (DC/HC: PCIe or
    # dedicated links into host DRAM), "pooled" (MC: memory-nodes on the
    # device-side interconnect).  The TierSpec carries the same
    # bandwidth/capacity contract the executable tiers expose.
    tier_kind: str = "pooled"              # device | host | pooled
    virt_bw_per_device: float = 16e9       # stash/fetch bandwidth per device
    virt_shared_bw: float = 0.0            # host-side cap (0 = uncapped)
    cpu_socket_bw: float = hw.XEON_SOCKET_BW
    n_sockets: int = 2

    hop_latency_s: float = 0.5e-6          # per-hop ring latency
    msg_size: float = 4096.0               # ring message granularity (Fig 9)

    # serving wire: a KV handoff leg is carried by ``wire_streams``
    # parallel connections of ``wire_stream_bw`` each (single-socket TCP
    # tops out well below the link; striping aggregates narrow streams —
    # the TensorDIMM argument applied to the serving fabric), capped by
    # the backing tier and the DCN link in the simulator
    wire_streams: int = 1
    wire_stream_bw: float = 2.5e9

    @property
    def backing_tier(self) -> TierSpec:
        """The virtualization backing store as a tier contract."""
        return TierSpec(
            kind=self.tier_kind,
            bw_per_device=self.virt_bw_per_device,
            shared_bw=self.virt_shared_bw,
            uses_cpu=(self.tier_kind == "host"),
        )

    # legacy accessors (pre-tier API)
    @property
    def oracle(self) -> bool:
        return self.backing_tier.is_oracle

    @property
    def virt_uses_cpu(self) -> bool:
        return self.backing_tier.uses_cpu

    @property
    def comm_bw_per_device(self) -> float:
        """Aggregate ring-injection bandwidth per device."""
        return self.n_rings * self.ring_link_bw

    def effective_virt_bw(self, n_devices: int = 0) -> float:
        """Per-device virtualization bandwidth when ``n_devices`` stream
        concurrently — the paper's §I observation: the host-side bandwidth
        divides across the intra-node devices."""
        return self.backing_tier.effective_bw(n_devices or self.n_devices,
                                              self.n_sockets)

    def allreduce_time(self, nbytes: float) -> float:
        """Ring all-reduce of nbytes (per device) over the ring set."""
        n = self.ring_nodes
        if n <= 1 or self.comm_bw_per_device == 0:
            return 0.0
        steps = 2 * (n - 1)
        chunk = nbytes / n
        per_step = chunk / self.comm_bw_per_device + self.hop_latency_s
        return steps * per_step

    def allgather_time(self, nbytes: float) -> float:
        n = self.ring_nodes
        if n <= 1 or self.comm_bw_per_device == 0:
            return 0.0
        steps = n - 1
        chunk = nbytes / n
        return steps * (chunk / self.comm_bw_per_device + self.hop_latency_s)


PCIE = hw.PCIE_GEN3_BW
# DGX-1-style PCIe tree — see hw.PCIE_ROOT_PER_SOCKET: 8 GPUs streaming
# concurrently see ~8 GB/s each, not 16 (paper §I).
PCIE_ROOT_PER_SOCKET = hw.PCIE_ROOT_PER_SOCKET

DC_DLA = SystemConfig(
    name="DC-DLA", n_rings=3, ring_nodes=8, tier_kind="host",
    virt_bw_per_device=PCIE, virt_shared_bw=PCIE_ROOT_PER_SOCKET)

DC_DLA_GEN4 = dataclasses.replace(
    DC_DLA, name="DC-DLA(pcie4)", virt_bw_per_device=hw.PCIE_GEN4_BW,
    virt_shared_bw=2 * PCIE_ROOT_PER_SOCKET)

HC_DLA = SystemConfig(
    name="HC-DLA", n_rings=1.5, ring_nodes=8, tier_kind="host",
    virt_bw_per_device=3 * 25e9, virt_shared_bw=hw.HCDLA_SOCKET_BW,
    cpu_socket_bw=hw.HCDLA_SOCKET_BW)

MC_DLA_S = SystemConfig(
    name="MC-DLA(S)", n_rings=2, ring_nodes=14,   # unbalanced longest ring
    tier_kind="pooled", virt_bw_per_device=2 * 25e9)

MC_DLA_L = SystemConfig(
    name="MC-DLA(L)", n_rings=3, ring_nodes=16,
    tier_kind="pooled", virt_bw_per_device=3 * 25e9)

MC_DLA_B = SystemConfig(
    name="MC-DLA(B)", n_rings=3, ring_nodes=16,
    tier_kind="pooled", virt_bw_per_device=6 * 25e9)

DC_DLA_O = SystemConfig(
    name="DC-DLA(O)", n_rings=3, ring_nodes=8, tier_kind="device",
    virt_bw_per_device=float("inf"))

ALL_SYSTEMS = (DC_DLA, HC_DLA, MC_DLA_S, MC_DLA_L, MC_DLA_B, DC_DLA_O)
SYSTEMS_BY_NAME = {s.name: s for s in ALL_SYSTEMS}
