"""stash/fetch — deprecated shims over the MemoryTier / MemoryRuntime API.

The memory-overlaying machinery (the autograd surgery around each layer,
§III-B) lives in :class:`repro_torch.core.runtime.MemoryRuntime`, and the
per-backing-store data paths in :mod:`repro_torch.core.tiers`.  These
wrappers keep the reference's historical signatures alive for examples
and external callers; new code should build a ``MemoryRuntime`` once and
call ``wrap_layer`` on it.

``planner`` is a :class:`~repro_torch.parallel.sharding.ShardingPlanner`
and ``mesh`` a ``DeviceMesh`` or ``None``.  The port runs on one device:
``compute_spec`` and ``batch_dim`` are accepted and not used (the sharded
placement of a fetch: ROADMAP A8b).  ``device`` names the device a
fetch lands on (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import MemoryPlan
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.core.tiers import TransferHints, build_tier
from repro_torch.parallel.sharding import PartitionSpec, ShardingPlanner


def _runtime(planner: ShardingPlanner, mesh, memory: MemoryPlan,
             device) -> MemoryRuntime:
    return MemoryRuntime(planner.plan, memory, device)


# one tier per (memory, planner, mesh) triple — a paired stash/fetch must
# see the same tier instance, and per-call construction is waste
_TIER_CACHE: dict = {}


def _tier(planner: ShardingPlanner, mesh, memory: MemoryPlan, device):
    key = (memory, id(planner), id(mesh))
    if key not in _TIER_CACHE:
        _TIER_CACHE[key] = build_tier(memory, planner.plan,
                                      torch.device(device))
    return _TIER_CACHE[key]


# ---------------------------------------------------------------------------
def stash(x: torch.Tensor, planner: ShardingPlanner, mesh,
          memory: MemoryPlan, batch_dim: int = 0, allow_compress: bool = True):
    """Deprecated: copy-out to the configured tier (built on ``x``'s
    device).  Returns an opaque payload.  Use ``MemoryRuntime.stash`` /
    ``tier.stash`` instead."""
    return _tier(planner, mesh, memory, x.device).stash(
        x, TransferHints(batch_dim=batch_dim, allow_compress=allow_compress))


def fetch(payload: Tuple[object, Optional[torch.Tensor]],
          planner: ShardingPlanner, mesh, memory: MemoryPlan,
          compute_spec, dtype, device="cuda") -> torch.Tensor:
    """Deprecated: prefetch back from the configured tier (``device``
    builds it when no stash did).  Use ``MemoryRuntime.fetch`` /
    ``tier.fetch`` instead."""
    return _tier(planner, mesh, memory, device).fetch(
        payload, TransferHints(dtype=dtype))


# ---------------------------------------------------------------------------
def offload_layer(layer_fn: Callable, planner: ShardingPlanner, mesh,
                  memory: MemoryPlan,
                  compute_spec: Optional[PartitionSpec] = None,
                  batch_dim: int = 0, device="cuda") -> Callable:
    """Deprecated: wrap ``layer_fn(params, x, *aux) -> y`` so the
    saved-for-backward copy of ``x`` lives in the configured tier.
    Delegates to ``MemoryRuntime.wrap_layer``."""
    return _runtime(planner, mesh, memory, device).wrap_layer(layer_fn)


def maybe_offload(layer_fn: Callable, planner: ShardingPlanner, mesh,
                  memory: MemoryPlan,
                  compute_spec: Optional[PartitionSpec] = None,
                  batch_dim: int = 0, device="cuda") -> Callable:
    """Deprecated: policy dispatch lives in the tier registry — a
    non-offloading tier (``policy='none'``) returns the plain layer."""
    return _runtime(planner, mesh, memory, device).wrap_layer(layer_fn)
