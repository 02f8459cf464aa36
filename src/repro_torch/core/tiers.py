"""Pluggable ``MemoryTier`` backing stores — the paper's memory hierarchy as
a first-class API (one card: no mesh).

Each backing store is a :class:`MemoryTier` with a uniform contract:

  ``stash(x, hints)``      copy-out to the tier; returns an opaque payload
  ``fetch(payload, hints)`` copy back onto the compute device
  ``bandwidth(plan, chip)`` per-device stash/fetch bandwidth (cost model)
  ``capacity(accountant)``  bytes one device can address through the tier

Tiers ported so far:

* :class:`DeviceTier`     — KEEP / the oracle DC-DLA(O): nothing leaves HBM.
* :class:`PooledHbmTier`  — MC-DLA's pooled HBM.  On one device the pool is
  the card's own HBM: a stash stays where it is (the reference with
  ``mesh=None``).
* :class:`HostTier`       — DC-DLA: pinned host memory over PCIe.  Unlike
  the reference's CPU backend, which no-ops the transfer, a CUDA tensor
  really is copied to pinned host memory and back.
* :class:`SpillTier`      — decorator: primary tier until its capacity
  contract is spent, then overflow to a cheaper store.
* :class:`CompressedTier` — decorator: quantise-and-pack through a stash
  codec's kernels before the inner tier's stash.
* :class:`CheckpointTier` — decorator: the durable snapshot leg
  (:func:`build_ckpt_tier` stacks the snapshot codec on top).

Policies map to tiers through :func:`build_tier` — the one place that
branches on ``MemoryPlan.policy`` strings.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.core.compress import decode_tensor, encode_tensor, get_codec
from repro_torch.core.pool import PoolAccountant, PoolAxes

# (data, optional codec scale) — the opaque unit a tier hands back from stash
Payload = Tuple[object, Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransferHints:
    """Per-call context a tier may consult when placing a tensor.

    batch_dim: index of the global-batch dim.
    dtype: dtype to restore on fetch.
    allow_compress: False for tensors that must round-trip bit-exactly.
    name: label for traffic accounting.
    """

    batch_dim: int = 0
    dtype: Optional[torch.dtype] = None
    allow_compress: bool = True
    name: str = "stash"


# ---------------------------------------------------------------------------
class MemoryTier(abc.ABC):
    """One backing store of the memory hierarchy, serving ``device``."""

    #: short id used in reports and the registry
    kind: str = "abstract"

    def __init__(self, plan: MeshPlan, memory: MemoryPlan,
                 device: torch.device):
        self.plan = plan
        self.memory = memory
        self.device = torch.device(device)

    @abc.abstractmethod
    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        """Copy-out ``x`` to the tier; returns an opaque payload."""

    @abc.abstractmethod
    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        """Bring a payload back onto the compute device."""

    @abc.abstractmethod
    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        """Per-device stash/fetch bandwidth in bytes/s (cost-model input)."""

    @abc.abstractmethod
    def capacity(self, accountant: PoolAccountant) -> float:
        """Bytes one device can address through this tier."""

    @property
    def offloads(self) -> bool:
        """False when stashing is a no-op (tensors stay resident)."""
        return True

    def payload_ratio(self) -> float:
        """Stashed bytes per raw byte (codecs shrink this below 1)."""
        return 1.0

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        """Actual bytes-per-raw-byte for THIS transfer."""
        return 1.0

    def describe(self) -> str:
        return self.kind


# ---------------------------------------------------------------------------
class DeviceTier(MemoryTier):
    """KEEP / oracle tier: the tensor never leaves device HBM."""

    kind = "device"

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        return (x, None)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        return payload[0]

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        return chip.hbm_bw

    def capacity(self, accountant: PoolAccountant) -> float:
        return accountant.budget

    @property
    def offloads(self) -> bool:
        return False


# ---------------------------------------------------------------------------
class PooledHbmTier(MemoryTier):
    """MC-DLA: the aggregate HBM of the devices as the backing store.

    One card is a pool of one: the stash keeps the tensor in place on the
    device (callers hand over a tensor they no longer mutate)."""

    kind = "pooled_hbm"

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        return (x, None)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        return payload[0]

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        """bw_aware engages the links of every mesh dimension the pool
        spans, local one dimension's; 2 links per dimension."""
        dims = len(PoolAxes(plan).axes_for(self.memory.placement))
        links = min(2 * dims, chip.num_links)
        return links * chip.link_bw

    def capacity(self, accountant: PoolAccountant) -> float:
        return accountant.system_capacity()

    def describe(self) -> str:
        return f"{self.kind}[{self.memory.placement}]"


# ---------------------------------------------------------------------------
class HostTier(MemoryTier):
    """DC-DLA baseline: park the tensor in host DRAM, fetch it back.

    A CUDA tensor is copied into pinned host memory (asynchronously, on the
    current stream; the fetch is stream-ordered after it) and copied back
    onto ``device``.  A CPU tensor is copied in host memory."""

    kind = "host"

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        if x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        else:
            host = x.clone()
        return (host, None)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        return payload[0].to(self.device, non_blocking=True, copy=True)

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        """PCIe path, root complex shared across the host's devices."""
        local_devices = max(1, min(plan.num_devices, hw.DEVICES_PER_HOST))
        shared = 2 * hw.PCIE_ROOT_PER_SOCKET / local_devices
        return min(hw.PCIE_GEN3_BW, shared)

    def capacity(self, accountant: PoolAccountant) -> float:
        return hw.HOST_DRAM_BYTES


# ---------------------------------------------------------------------------
class CompressedTier(MemoryTier):
    """Decorator: quantise-and-pack before any tier's stash.

    Halves (fp8, int8, blocksparse) the bytes that cross the wire AND that
    occupy the inner tier.  A stash encodes the whole tensor with one
    per-tensor scale through the codec's pack kernel (one row block) and
    hands the packed bytes to the inner tier; a fetch brings them back
    through the inner tier and decodes them with the unpack kernel.
    Tensors the hints mark ``allow_compress=False`` (and non-float ones)
    pass through uncompressed.
    """

    kind = "compressed"

    def __init__(self, inner: MemoryTier, codec: str = "fp8"):
        super().__init__(inner.plan, inner.memory, inner.device)
        self.inner = inner
        self.codec = get_codec(codec)

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        if not hints.allow_compress or not self.codec.applies_to(x):
            return self.inner.stash(x, hints)
        q, scale = encode_tensor(self.codec, x)
        payload, _ = self.inner.stash(q, hints)
        return (payload, scale)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        q, scale = payload
        if scale is None:
            return self.inner.fetch(payload, hints)
        raw = self.inner.fetch((q, None), hints)
        return decode_tensor(self.codec, raw, scale,
                             hints.dtype or torch.bfloat16)

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        return self.inner.bandwidth(plan, chip)

    def capacity(self, accountant: PoolAccountant) -> float:
        return self.inner.capacity(accountant)

    @property
    def offloads(self) -> bool:
        return self.inner.offloads

    def payload_ratio(self) -> float:
        return self.codec.ratio * self.inner.payload_ratio()

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        if hints.allow_compress and self.codec.applies_to(x):
            return self.codec.ratio * self.inner.wire_ratio(x, hints)
        return self.inner.wire_ratio(x, hints)

    def describe(self) -> str:
        return f"{self.inner.describe()}+{self.codec.name}"


# ---------------------------------------------------------------------------
class SpillPayload:
    """Payload of a :class:`SpillTier` stash: the inner leg's payload plus
    which leg took it and how many bytes it charged."""

    __slots__ = ("leg", "nbytes", "inner")

    def __init__(self, leg: str, nbytes: float, inner: Payload):
        self.leg = leg              # "primary" | "overflow"
        self.nbytes = nbytes        # bytes charged against the primary budget
        self.inner = inner

    def __repr__(self) -> str:
        return f"SpillPayload(leg={self.leg!r}, nbytes={self.nbytes:.0f})"


class SpillTier(MemoryTier):
    """Decorator: primary tier until its capacity contract is exhausted,
    then overflow to a cheaper backing store (the Buddy-Compression cold-page
    demotion pattern, arXiv:1903.02596).  :meth:`discard` returns a dropped
    payload's budget."""

    kind = "spill"

    def __init__(self, primary: MemoryTier, overflow: MemoryTier,
                 primary_budget: Optional[float] = None):
        super().__init__(primary.plan, primary.memory, primary.device)
        self.primary = primary
        self.overflow = overflow
        if primary_budget is None:
            acct = PoolAccountant(primary.plan, primary.memory)
            primary_budget = primary.capacity(acct)
        self.primary_budget = float(primary_budget)
        self._primary_used = 0.0
        self._overflow_used = 0.0

    def _charge_bytes(self, x: torch.Tensor) -> float:
        raw = float(x.numel()) * x.element_size()
        return raw * self.primary.payload_ratio()

    def primary_headroom(self) -> float:
        return self.primary_budget - self._primary_used

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        nbytes = self._charge_bytes(x)
        if nbytes <= self.primary_headroom():
            self._primary_used += nbytes
            return (SpillPayload("primary", nbytes,
                                 self.primary.stash(x, hints)), None)
        self._overflow_used += nbytes
        return (SpillPayload("overflow", nbytes,
                             self.overflow.stash(x, hints)), None)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        sp = payload[0]
        leg = self.primary if sp.leg == "primary" else self.overflow
        return leg.fetch(sp.inner, hints)

    def discard(self, payload: Payload) -> None:
        """Release a stashed payload's budget charge (serving churn)."""
        sp = payload[0]
        if sp.leg == "primary":
            self._primary_used = max(0.0, self._primary_used - sp.nbytes)
        else:
            self._overflow_used = max(0.0, self._overflow_used - sp.nbytes)

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        """Occupancy-blended: all-primary while nothing has overflowed,
        then the harmonic mean weighted by the routed byte fractions."""
        bw_p = self.primary.bandwidth(plan, chip)
        if self._overflow_used <= 0.0:
            return bw_p
        bw_o = self.overflow.bandwidth(plan, chip)
        total = self._primary_used + self._overflow_used
        f_over = self._overflow_used / total
        return 1.0 / ((1.0 - f_over) / bw_p + f_over / bw_o)

    def capacity(self, accountant: PoolAccountant) -> float:
        return self.primary_budget + self.overflow.capacity(accountant)

    def payload_ratio(self) -> float:
        return self.primary.payload_ratio()

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        if self._charge_bytes(x) <= self.primary_headroom():
            return self.primary.wire_ratio(x, hints)
        return self.overflow.wire_ratio(x, hints)

    def describe(self) -> str:
        return (f"{self.kind}[{self.primary.describe()}"
                f"->{self.overflow.describe()}]")


# ---------------------------------------------------------------------------
class CheckpointTier(MemoryTier):
    """Decorator: the durable snapshot leg of the memory hierarchy.

    A checkpoint is the coldest tensor class of all (touched once per
    cadence, read only after a failure), so it goes through the tier API
    like any other stash.  The data path is the backing store's; the
    decorator prices durability:

    * ``bandwidth`` — a snapshot is only fault-tolerant once it leaves the
      failure domain, so the drain is the DCN hop in series with the
      backing store.
    * ``capacity`` — ``keep`` live snapshots must fit at once: each
      addresses 1/keep of the backing store.

    A snapshot read back from disk is host memory whatever leg stashed it:
    over a :class:`SpillTier` backing it comes back by the overflow (host)
    leg.
    """

    kind = "ckpt"

    def __init__(self, inner: MemoryTier, keep: int = 1):
        super().__init__(inner.plan, inner.memory, inner.device)
        self.inner = inner
        self.keep = max(1, keep)

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        return self.inner.stash(x, hints)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        if isinstance(self.inner, SpillTier) and \
                not isinstance(payload[0], SpillPayload):
            return self.inner.overflow.fetch(payload, hints)
        return self.inner.fetch(payload, hints)

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        inner_bw = self.inner.bandwidth(plan, chip)
        if inner_bw <= 0:
            return hw.DCN_BW
        return 1.0 / (1.0 / hw.DCN_BW + 1.0 / inner_bw)

    def capacity(self, accountant: PoolAccountant) -> float:
        return self.inner.capacity(accountant) / self.keep

    @property
    def offloads(self) -> bool:
        # a checkpoint always leaves the device, even over a DeviceTier
        # backing (the drain hop is the point)
        return True

    def payload_ratio(self) -> float:
        return self.inner.payload_ratio()

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        return self.inner.wire_ratio(x, hints)

    def describe(self) -> str:
        return f"{self.kind}[{self.inner.describe()}]"


def build_ckpt_tier(memory: MemoryPlan, plan: MeshPlan, device: torch.device,
                    backing: str = "host", codec: str = "none",
                    keep: int = 1) -> MemoryTier:
    """The snapshot tier for a run: the requested backing store (through
    the registry; ``none`` / ``pipeline`` / ``checkpoint`` resolve to
    ``host``) behind the durability drain, the snapshot codec on top."""
    if backing in ("none", "pipeline", "checkpoint"):
        backing = "host"
    if backing not in _TIER_REGISTRY:
        raise KeyError(f"unknown checkpoint backing {backing!r}; "
                       f"registered: {registered_policies()}")
    tier: MemoryTier = CheckpointTier(
        _TIER_REGISTRY[backing](memory, plan, device), keep=keep)
    if codec != "none":
        tier = CompressedTier(tier, codec)
    return tier


# ---------------------------------------------------------------------------
# tier registry: MemoryPlan.policy -> tier
TierFactory = Callable[[MemoryPlan, MeshPlan, torch.device], MemoryTier]
_TIER_REGISTRY: Dict[str, TierFactory] = {}


def register_tier(policy: str, factory: TierFactory) -> None:
    _TIER_REGISTRY[policy] = factory


def registered_policies() -> Tuple[str, ...]:
    return tuple(sorted(_TIER_REGISTRY))


def build_tier(memory: MemoryPlan, plan: MeshPlan,
               device: torch.device) -> MemoryTier:
    """Resolve a :class:`MemoryPlan` to its tier stack.

    ``compress != 'none'`` wraps the tier in a :class:`CompressedTier` (a
    no-op stack on the device tier, which never moves bytes)."""
    if memory.policy not in _TIER_REGISTRY:
        hint = (" ('auto' needs the KEEP/POOL/RECOMPUTE planner, "
                "core/dag.py and core/policy.py, which port with slice 5)"
                if memory.policy == "auto" else "")
        raise KeyError(f"unknown memory policy {memory.policy!r}; "
                       f"registered: {registered_policies()}{hint}")
    tier = _TIER_REGISTRY[memory.policy](memory, plan, device)
    if memory.compress != "none" and tier.offloads:
        tier = CompressedTier(tier, memory.compress)
    return tier


register_tier("none", lambda m, p, d: DeviceTier(p, m, d))
register_tier("host", lambda m, p, d: HostTier(p, m, d))
register_tier("mcdla", lambda m, p, d: PooledHbmTier(p, m, d))
# "spill": pooled HBM until the pool's capacity contract is spent, host
# DRAM past it
register_tier("spill", lambda m, p, d: SpillTier(PooledHbmTier(p, m, d),
                                                 HostTier(p, m, d)))
# "checkpoint": the durable snapshot leg over host DRAM (build_ckpt_tier
# builds it with another backing and the snapshot codec)
register_tier("checkpoint",
              lambda m, p, d: CheckpointTier(HostTier(p, m, d)))
