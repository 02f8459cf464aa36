"""``MemoryRuntime`` — the single facade over the memory-tier machinery.

Built once from ``(MeshPlan, MemoryPlan)`` and a device, it owns the
:class:`~repro_torch.core.tiers.MemoryTier` stack and meters every
stash/fetch: :meth:`traffic_report` gives per-direction logical and wire
bytes plus an estimated transfer time against the tier's bandwidth
contract.  The serving stack spills cold KV through one
(``kv_stash``/``kv_fetch``); training wraps each sub-layer with
:meth:`MemoryRuntime.wrap_layer`:

  forward:  y = layer(params, x)            (no graph kept)
            payload = tier.stash(x)         (copy-out to the backing store)
  saved:    params by reference, payload    (x itself is NOT saved)
  backward: x' = tier.fetch(payload)        (then the payload is discarded)
            recompute the layer from x' under autograd, take its gradient

Unlike the reference, which meters per *trace* (one stash and one fetch
per wrapped kind under ``scan`` + ``jit``), the port runs eagerly and
meters every executed call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import hw, tree
from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.core.tiers import (MemoryTier, SpillPayload, SpillTier,
                                    TransferHints, build_tier)

# big float aux (e.g. encoder states feeding cross-attention) stash too
AUX_STASH_NDIM = 3


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

    def reset_traffic(self) -> None:
        self._traffic = {}

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

    def traffic_summary(self) -> str:
        r = self.traffic_report()
        per = {d: f"{fmt_bytes(v['wire_bytes'])}/{v['calls']}x of "
                  f"{fmt_bytes(v['raw_bytes'])} raw"
               for d, v in r.items() if isinstance(v, dict)}
        return (f"tier={r['tier']} wire={fmt_bytes(r['wire_bytes_total'])} "
                f"est_transfer={r['est_transfer_s']*1e3:.2f}ms {per}")

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

    # ------------------------------------------------------------------
    # snapshots (checkpoint-as-a-tier).  Unlike stash/fetch these meter the
    # *actual* payload bytes: the manifest the CheckpointManager commits
    # accounts the same bytes, so ``traffic_report()["ckpt_save"]`` is
    # checkable against the files for any codec stack
    def snapshot(self, x: torch.Tensor, hints: Optional[TransferHints] = None,
                 direction: str = "ckpt_save"):
        """Stash one snapshot leaf through the tier, metered ``ckpt_save``."""
        payload = self.tier.stash(x, hints or TransferHints())
        raw = float(x.numel()) * x.element_size()
        self._traffic.setdefault(direction, TierTraffic()).add(
            raw, payload_bytes(payload))
        return payload

    def restore_snapshot(self, payload,
                         hints: Optional[TransferHints] = None,
                         direction: str = "ckpt_load") -> torch.Tensor:
        """Fetch one snapshot leaf back, metered ``ckpt_load``."""
        wire = payload_bytes(payload)
        x = self.tier.fetch(payload, hints or TransferHints())
        raw = float(x.numel()) * x.element_size()
        self._traffic.setdefault(direction, TierTraffic()).add(raw, wire)
        return x

    def discard(self, payload) -> None:
        """Release a parked payload's capacity-contract charge: the first
        :class:`~repro_torch.core.tiers.SpillTier` down the stack's
        ``.inner`` chain gets its budget back.  No-op for tiers without a
        byte ledger."""
        tier = self.tier
        while tier is not None:
            if isinstance(tier, SpillTier):
                tier.discard(payload)
                return
            tier = getattr(tier, "inner", None)

    # ------------------------------------------------------------------
    # the one training wrapper
    def wrap_layer(self, layer_fn: Callable, name: str = "layer"
                   ) -> Callable:
        """Wrap ``layer_fn(params, x, *aux) -> y`` (``y`` a tensor or a
        tuple of tensors) so the saved-for-backward copy of ``x`` lives in
        this runtime's tier.

        ``params`` (a nested dict of tensors) and small aux are saved by
        reference; float aux with ndim >= 3 are stashed too, uncompressed
        (they must round-trip bit-exactly).  When no input needs a gradient
        the layer runs bare: no stash, no payload left behind (JAX's primal
        path).  Returns ``layer_fn`` itself when the tier does not offload.
        """
        if not self.offloads:
            return layer_fn
        runtime = self

        def wrapped(params, x, *aux):
            leaves, paths = tree.flatten(params)
            if not torch.is_grad_enabled() or not any(
                    t.requires_grad for t in [x, *leaves, *aux]
                    if isinstance(t, torch.Tensor)):
                return layer_fn(params, x, *aux)
            spec = _WrapSpec(runtime, layer_fn, name, paths, len(leaves),
                             aux)
            outs = _StashedLayer.apply(spec, x, *leaves,
                                       *[a for a in aux
                                         if isinstance(a, torch.Tensor)])
            return outs[0] if spec.single else outs

        return wrapped


class _WrapSpec:
    """What one wrapped call's backward needs besides its saved tensors:
    the runtime, the layer, the parameter paths and which aux to stash."""

    def __init__(self, runtime: MemoryRuntime, layer_fn: Callable, name: str,
                 paths, n_params: int, aux):
        self.runtime, self.layer_fn, self.name = runtime, layer_fn, name
        self.paths, self.n_params = paths, n_params
        # aux entries that are tensors travel through apply(); the others
        # are rebuilt from their slot
        self.aux_template = [None if isinstance(a, torch.Tensor) else a
                             for a in aux]
        self.single = True

    def hints(self, dtype=None, allow_compress=True) -> TransferHints:
        return TransferHints(dtype=dtype, allow_compress=allow_compress,
                             name=self.name)

    def call(self, x, leaves, aux_tensors):
        it = iter(aux_tensors)
        aux = [next(it) if a is None else a for a in self.aux_template]
        return self.layer_fn(tree.unflatten(self.paths, list(leaves)), x,
                             *aux)


class _StashedLayer(torch.autograd.Function):
    """The vDNN offload of one layer input (paper §III-B, footnote 4).

    Forward runs the layer without a graph and stashes ``x`` through the
    tier; backward fetches it (then discards the payload, so a
    :class:`~repro_torch.core.tiers.SpillTier` gets its budget back for
    the next step), recomputes the layer under autograd and returns the
    gradients of the parameters, ``x`` and the float aux."""

    @staticmethod
    def forward(ctx, spec: _WrapSpec, x, *rest):
        leaves = rest[:spec.n_params]
        aux = rest[spec.n_params:]
        out = spec.call(x, leaves, aux)
        spec.single = isinstance(out, torch.Tensor)
        outs = (out,) if spec.single else tuple(out)
        rt = spec.runtime
        ctx.spec = spec
        ctx.x_dtype = x.dtype
        ctx.payload = rt.stash(x.detach(), spec.hints())
        ctx.aux_payloads = {}
        kept_aux = []
        for i, a in enumerate(aux):
            if (rt.memory.stash_aux and a.is_floating_point()
                    and a.ndim >= AUX_STASH_NDIM):
                ctx.aux_payloads[i] = (rt.stash(
                    a.detach(), spec.hints(allow_compress=False)), a.dtype)
                kept_aux.append(None)
            else:
                kept_aux.append(a)
        ctx.kept_aux = kept_aux
        ctx.save_for_backward(*leaves)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        spec, rt = ctx.spec, ctx.spec.runtime
        x = rt.fetch(ctx.payload, spec.hints(dtype=ctx.x_dtype))
        rt.discard(ctx.payload)
        ctx.payload = None
        aux = list(ctx.kept_aux)
        for i, (payload, dtype) in ctx.aux_payloads.items():
            aux[i] = rt.fetch(payload, TransferHints(
                dtype=dtype, allow_compress=False, name=f"{spec.name}_aux"))
            rt.discard(payload)
        leaves = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(ctx.needs_input_grad[1])
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip(leaves, ctx.needs_input_grad[2:])]
            aux = [a.detach().requires_grad_(need)
                   if a.is_floating_point() else a for a, need in
                   zip(aux, ctx.needs_input_grad[2 + spec.n_params:])]
            out = spec.call(x, leaves, aux)
            outs = (out,) if spec.single else tuple(out)
            inputs = [x, *leaves, *aux]
            wanted = [t for t in inputs
                      if isinstance(t, torch.Tensor) and t.requires_grad]
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else \
                [None] * len(wanted)
        it = iter(got)
        return (None,) + tuple(
            next(it) if isinstance(t, torch.Tensor) and t.requires_grad
            else None for t in inputs)


def payload_bytes(payload) -> float:
    """Bytes of every tensor in a tier payload (a tuple of data and codec
    scale, the data possibly inside a :class:`SpillPayload`)."""
    if isinstance(payload, torch.Tensor):
        return float(payload.numel()) * payload.element_size()
    if isinstance(payload, SpillPayload):
        return payload_bytes(payload.inner)
    if isinstance(payload, (tuple, list)):
        return sum(payload_bytes(p) for p in payload)
    return 0.0


def fmt_bytes(n: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n/div:.2f}{unit}"
    return f"{n:.0f}B"
