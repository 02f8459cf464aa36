"""Pluggable ``MemoryTier`` backing stores — the paper's memory hierarchy as
a first-class API.

Each backing store is a :class:`MemoryTier` with a uniform contract:

  ``stash(x, hints)``      copy-out to the tier; returns an opaque payload
  ``fetch(payload, hints)`` copy back onto the compute device
  ``bandwidth(plan, chip)`` per-device stash/fetch bandwidth (cost model)
  ``capacity(accountant)``  bytes one device can address through the tier
  ``account(acct, nbytes)`` charge a stashed tensor to the boot-time map

Tiers ported so far:

* :class:`DeviceTier`     — KEEP / the oracle DC-DLA(O): nothing leaves HBM.
* :class:`PooledHbmTier`  — MC-DLA's pooled HBM.  On a mesh each rank keeps
  only its ``1/pool_size`` slice of a stash (``core/pool.pool_spec``) and
  a fetch all-gathers the slices back; on one device the pool is the
  card's own HBM and a stash stays where it is (the reference with
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

On a mesh (``tier.mesh``, set by :func:`build_tier`) a tier sees each
rank's local shard of a tensor (``TransferHints.compute_spec`` its
layout): :meth:`MemoryTier.split` gives the part of it the rank keeps and
:meth:`MemoryTier.join` the whole local shard back, so a codec packs and
unpacks each rank's part (with the whole tensor's scale), and
:meth:`MemoryTier.held` says what share of the local shard one rank
holds, for the runtime's meter.

Policies map to tiers through :func:`build_tier` — the one place that
branches on ``MemoryPlan.policy`` strings.  Each registered policy also
says whether its tier stashes every layer (``stash_all``: host, mcdla,
spill) or lets the KEEP / POOL / RECOMPUTE planner choose (``auto``, over
the pooled tier).  :class:`TierSpec` is the tiers' analytic twin for the
simulator (sim/topology.py).
"""
from __future__ import annotations

import abc
import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import hw
from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.core.compress import decode_tensor, encode_tensor, get_codec
from repro_torch.core.pool import PoolAccountant, PoolAxes, pool_spec
from repro_torch.parallel.sharding import (PartitionSpec, ShardingPlanner,
                                           constrain, global_shape,
                                           local_shape)

# (data, optional codec scale) — the opaque unit a tier hands back from stash
Payload = Tuple[object, Optional[torch.Tensor]]


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TransferHints:
    """Per-call context a tier may consult when placing a tensor.

    compute_spec: on a mesh, the layout of the local shard handed over
      (and wanted back on fetch); None off a mesh.
    batch_dim: index of the global-batch dim.
    dtype: dtype to restore on fetch.
    allow_compress: False for tensors that must round-trip bit-exactly.
    name: label for traffic accounting.
    """

    compute_spec: Optional[PartitionSpec] = None
    batch_dim: int = 0
    dtype: Optional[torch.dtype] = None
    allow_compress: bool = True
    name: str = "stash"


# ---------------------------------------------------------------------------
class MemoryTier(abc.ABC):
    """One backing store of the memory hierarchy, serving ``device``."""

    #: short id used in reports and the registry
    kind: str = "abstract"
    #: the run's MeshGroups (parallel/sharding.py); None off a mesh
    mesh = None

    def __init__(self, plan: MeshPlan, memory: MemoryPlan,
                 device: torch.device, *, stash_all: bool = True):
        self.plan = plan
        self.memory = memory
        self.device = torch.device(device)
        # policy trait: stash every layer (paper's stress-test mode) vs let
        # the KEEP/POOL/RECOMPUTE planner choose a stash fraction
        self.stash_all = stash_all

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

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        """Charge a stashed tensor of global ``nbytes`` to the memory map."""
        accountant.alloc_pooled(nbytes)

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

    # -- a rank's part of a local shard (a mesh) ---------------------------
    def split(self, x: torch.Tensor, hints: TransferHints):
        """``(part, layout)``: the part of the local shard ``x`` this rank
        keeps, and what :meth:`join` needs to rebuild ``x`` (None: the
        part is ``x``)."""
        return x, None

    def join(self, part: torch.Tensor, layout, hints: TransferHints
             ) -> torch.Tensor:
        """The local shard that :meth:`split` took ``part`` from."""
        return part

    def stash_part(self, part: torch.Tensor, layout,
                   hints: TransferHints) -> Payload:
        """Stash a part :meth:`split` gave (a codec's codes of it)."""
        return self.stash(part, hints)

    def fetch_part(self, payload: Payload, hints: TransferHints):
        """``(part, layout)`` of a :meth:`stash_part` payload."""
        return self.fetch(payload, hints), None

    def held(self, x: torch.Tensor, hints: TransferHints) -> float:
        """The share of the local shard ``x`` one rank holds once stashed."""
        return 1.0


# ---------------------------------------------------------------------------
class PoolSlice:
    """A pooled stash on a mesh: this rank's slice and its layout
    (``(pool spec, compute spec)``)."""

    __slots__ = ("data", "layout")

    def __init__(self, data: torch.Tensor, layout):
        self.data = data
        self.layout = layout


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

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        # global bytes stay resident, batch-sharded across the devices
        accountant.alloc_local(nbytes / max(accountant.plan.num_devices, 1))

    @property
    def offloads(self) -> bool:
        return False


# ---------------------------------------------------------------------------
class PooledHbmTier(MemoryTier):
    """MC-DLA: the aggregate HBM of the devices as the backing store.

    On a mesh a stashed local shard is cut to this rank's block of the
    pool layout (``core/pool.pool_spec``: each device of the pool keeps
    1/pool_size of the global tensor) and the block kept; a fetch
    all-gathers the blocks over the pool's axes (paper Fig. 10).  One card
    is a pool of one: the stash keeps the tensor in place on the device
    (callers hand over a tensor they no longer mutate)."""

    kind = "pooled_hbm"

    def _layout(self, shape, hints: TransferHints):
        """``(pool spec, compute spec)`` of a local shard of ``shape``, or
        None where the rank keeps all of it."""
        if self.mesh is None or hints.compute_spec is None:
            return None
        src = hints.compute_spec
        spec = pool_spec(global_shape(shape, src, self.mesh),
                         ShardingPlanner(self.plan), self.memory.placement,
                         hints.batch_dim, name=hints.name)
        return None if tuple(spec) == tuple(src) else (spec, src)

    def split(self, x: torch.Tensor, hints: TransferHints):
        layout = self._layout(x.shape, hints)
        if layout is None:
            return x, None
        spec, src = layout
        return constrain(x, self.mesh, spec, src), layout

    def join(self, part: torch.Tensor, layout, hints: TransferHints
             ) -> torch.Tensor:
        if layout is None:
            return part
        spec, src = layout
        return constrain(part, self.mesh, src, spec)

    def stash_part(self, part: torch.Tensor, layout,
                   hints: TransferHints) -> Payload:
        return (part if layout is None else PoolSlice(part, layout), None)

    def fetch_part(self, payload: Payload, hints: TransferHints):
        data = payload[0]
        if isinstance(data, PoolSlice):
            return data.data, data.layout
        return data, None

    def held(self, x: torch.Tensor, hints: TransferHints) -> float:
        layout = self._layout(x.shape, hints)
        if layout is None:
            return 1.0
        spec, src = layout
        full = global_shape(x.shape, src, self.mesh)
        return math.prod(local_shape(full, spec, self.mesh)) / max(
            x.numel(), 1)

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        part, layout = self.split(x, hints)
        # a slice is copied, so the rest of x is freed
        return self.stash_part(part if layout is None else part.clone(),
                               layout, hints)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        return self.join(*self.fetch_part(payload, hints), hints)

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

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        # each device parks its own shard in host DRAM
        accountant.alloc_host(nbytes / max(accountant.plan.num_devices, 1))


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

    On a mesh the kernels run on the part of the local shard this rank
    keeps (the inner tier's :meth:`~MemoryTier.split`), scaled by the
    absmax of the whole global tensor (an all-reduce of the max over the
    mesh), as the reference's per-tensor scale is; so each rank's codes
    are those of the one-device stash, and its unpacked part is joined
    after decoding.
    """

    kind = "compressed"

    def __init__(self, inner: MemoryTier, codec: str = "fp8"):
        super().__init__(inner.plan, inner.memory, inner.device,
                         stash_all=inner.stash_all)
        self.inner = inner
        self.codec = get_codec(codec)

    def stash(self, x: torch.Tensor, hints: TransferHints) -> Payload:
        if not hints.allow_compress or not self.codec.applies_to(x):
            return self.inner.stash(x, hints)
        part, layout = self.inner.split(x, hints)
        absmax = None
        if self.mesh is not None:
            from repro_torch.parallel import collectives as coll
            absmax = coll.all_reduce(
                part.abs().amax().float(),
                self.mesh.group(self.mesh.names), op="max").to(x.dtype)
        q, scale = encode_tensor(self.codec, part, absmax)
        payload, _ = self.inner.stash_part(q, layout, hints)
        return (payload, scale)

    def fetch(self, payload: Payload, hints: TransferHints) -> torch.Tensor:
        q, scale = payload
        if scale is None:
            return self.inner.fetch(payload, hints)
        raw, layout = self.inner.fetch_part((q, None), hints)
        return self.inner.join(decode_tensor(self.codec, raw, scale,
                                             hints.dtype or torch.bfloat16),
                               layout, hints)

    def held(self, x: torch.Tensor, hints: TransferHints) -> float:
        return self.inner.held(x, hints)

    def bandwidth(self, plan: MeshPlan, chip: hw.Chip = hw.H100) -> float:
        return self.inner.bandwidth(plan, chip)

    def capacity(self, accountant: PoolAccountant) -> float:
        return self.inner.capacity(accountant)

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        self.inner.account(accountant, nbytes * self.codec.ratio)

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
        super().__init__(primary.plan, primary.memory, primary.device,
                         stash_all=primary.stash_all)
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

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        if nbytes <= self.primary_headroom():
            self.primary.account(accountant, nbytes)
        else:
            self.overflow.account(accountant, nbytes)

    def payload_ratio(self) -> float:
        return self.primary.payload_ratio()

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        if self._charge_bytes(x) <= self.primary_headroom():
            return self.primary.wire_ratio(x, hints)
        return self.overflow.wire_ratio(x, hints)

    def held(self, x: torch.Tensor, hints: TransferHints) -> float:
        if self._charge_bytes(x) <= self.primary_headroom():
            return self.primary.held(x, hints)
        return self.overflow.held(x, hints)

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
        super().__init__(inner.plan, inner.memory, inner.device,
                         stash_all=inner.stash_all)
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

    def account(self, accountant: PoolAccountant, nbytes: float) -> None:
        self.inner.account(accountant, nbytes)

    @property
    def offloads(self) -> bool:
        # a checkpoint always leaves the device, even over a DeviceTier
        # backing (the drain hop is the point)
        return True

    def payload_ratio(self) -> float:
        return self.inner.payload_ratio()

    def wire_ratio(self, x: torch.Tensor, hints: TransferHints) -> float:
        return self.inner.wire_ratio(x, hints)

    def held(self, x: torch.Tensor, hints: TransferHints) -> float:
        return self.inner.held(x, hints)

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
    tier: MemoryTier = CheckpointTier(_bind(backing, memory, plan, device),
                                      keep=keep)
    if codec != "none":
        tier = CompressedTier(tier, codec)
    return tier


# ---------------------------------------------------------------------------
# tier registry: MemoryPlan.policy -> tier
TierFactory = Callable[[MemoryPlan, MeshPlan, torch.device], MemoryTier]


@dataclasses.dataclass(frozen=True)
class TierBinding:
    factory: TierFactory
    stash_all: bool          # stash every layer vs planner-chosen fraction


_TIER_REGISTRY: Dict[str, TierBinding] = {}


def register_tier(policy: str, factory: TierFactory,
                  stash_all: bool = True) -> None:
    _TIER_REGISTRY[policy] = TierBinding(factory, stash_all)


def _bind(policy: str, memory: MemoryPlan, plan: MeshPlan,
          device: torch.device) -> MemoryTier:
    binding = _TIER_REGISTRY[policy]
    tier = binding.factory(memory, plan, device)
    tier.stash_all = binding.stash_all
    return tier


def registered_policies() -> Tuple[str, ...]:
    return tuple(sorted(_TIER_REGISTRY))


def build_tier(memory: MemoryPlan, plan: MeshPlan,
               device: torch.device, mesh=None) -> MemoryTier:
    """Resolve a :class:`MemoryPlan` to its tier stack, every tier of it
    on ``mesh`` (a MeshGroups; None off a mesh).

    ``compress != 'none'`` wraps the tier in a :class:`CompressedTier` (a
    no-op stack on the device tier, which never moves bytes)."""
    if memory.policy not in _TIER_REGISTRY:
        raise KeyError(f"unknown memory policy {memory.policy!r}; "
                       f"registered: {registered_policies()}")
    tier = _bind(memory.policy, memory, plan, device)
    if memory.compress != "none" and tier.offloads:
        tier = CompressedTier(tier, memory.compress)
    stack = [tier]
    while stack:
        t = stack.pop()
        t.mesh = mesh
        stack += [getattr(t, k) for k in ("inner", "primary", "overflow")
                  if getattr(t, k, None) is not None]
    return tier


register_tier("none", lambda m, p, d: DeviceTier(p, m, d), stash_all=False)
register_tier("host", lambda m, p, d: HostTier(p, m, d))
register_tier("mcdla", lambda m, p, d: PooledHbmTier(p, m, d))
# "auto" uses the same pooled tier; the KEEP/POOL/RECOMPUTE planner
# (core/policy.py) decides the stash fraction instead of stashing all
register_tier("auto", lambda m, p, d: PooledHbmTier(p, m, d),
              stash_all=False)
# "spill": pooled HBM until the pool's capacity contract is spent, host
# DRAM past it
register_tier("spill", lambda m, p, d: SpillTier(PooledHbmTier(p, m, d),
                                                 HostTier(p, m, d)))
# "checkpoint": the durable snapshot leg over host DRAM (build_ckpt_tier
# builds it with another backing and the snapshot codec)
register_tier("checkpoint",
              lambda m, p, d: CheckpointTier(HostTier(p, m, d)))


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Hardware-model-level bandwidth/capacity contract of a backing store.

    The executable tiers above move real tensors; this spec is their
    analytic twin used by ``sim/`` to model the paper's DC/HC/MC design
    points as tier configurations (same contract, no tensors).
    """

    kind: str                          # device | host | pooled
    bw_per_device: float               # stash/fetch bytes/s per device
    shared_bw: float = 0.0             # host-side cap (0 = uncapped)
    uses_cpu: bool = False             # traffic counts against CPU memory BW
    capacity_bytes: float = float("inf")

    @property
    def is_oracle(self) -> bool:
        return self.kind == "device"

    def effective_bw(self, n_devices: int, n_sockets: int = 2) -> float:
        """Per-device bandwidth when ``n_devices`` stream concurrently —
        the paper's §I observation that shared host links divide."""
        if self.is_oracle:
            return float("inf")
        bw = self.bw_per_device
        if self.shared_bw > 0:
            bw = min(bw, self.shared_bw * n_sockets / max(n_devices, 1))
        return bw
