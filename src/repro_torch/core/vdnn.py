"""vdnn — legacy wrapper entry point, a thin veneer over MemoryRuntime.

Historically this module was one of three divergent wrapper entry points
(``core.offload.maybe_offload``, ``VdnnContext.wrap_layer``,
``models.layers.ModelContext.wrap``).  All three delegate to
:class:`repro_torch.core.runtime.MemoryRuntime` — the single facade that
owns the tier stack.  Prefer constructing a ``MemoryRuntime`` directly in
new code.

``auto`` is realised with a *stash fraction*: the planner returns r =
pooled/(pooled+kept) and ``split_layers`` partitions the layer stack
into a kept prefix and a pooled suffix (early layers have the largest
reuse distance — they are stashed first, exactly the planner's eviction
order).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch import hw
from repro_torch.configs.base import MemoryPlan, MeshPlan
from repro_torch.core.dag import LayerDAG
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.parallel.sharding import PartitionSpec, ShardingPlanner


@dataclasses.dataclass
class VdnnContext:
    """Deprecated shim — use :class:`repro_torch.core.runtime.MemoryRuntime`.
    ``mesh`` is a ``DeviceMesh`` or ``None``; ``device`` the device the
    runtime's fetches land on."""

    planner: ShardingPlanner
    mesh: Any
    memory: MemoryPlan
    device: Any = "cuda"

    def __post_init__(self):
        self.runtime = MemoryRuntime(self.planner.plan, self.memory,
                                     self.device)

    def wrap_layer(self, layer_fn: Callable,
                   compute_spec: Optional[PartitionSpec] = None,
                   batch_dim: int = 0) -> Callable:
        """Offload-wrap a layer according to the memory policy; off-mesh
        (``mesh is None``) the plain layer, as in the reference."""
        if self.mesh is None:
            return layer_fn
        return self.runtime.wrap_layer(layer_fn)


def stash_fraction(dag: LayerDAG, plan: MeshPlan, memory: MemoryPlan,
                   model_state_bytes: float = 0.0,
                   chip: hw.Chip = hw.H100) -> float:
    """Fraction of layers the policy stashes (1.0 for stash-all tiers;
    cost-model-derived for auto, priced on ``chip``; 0.0 when nothing
    offloads).  Arithmetic only: the runtime is built on the meta
    device."""
    return MemoryRuntime(plan, memory, "meta", chip=chip).stash_fraction(
        dag, model_state_bytes=model_state_bytes)


def split_layers(num_layers: int, fraction: float) -> int:
    """Number of *stashed* layers: the first k of L (largest reuse
    distance first, matching the planner's eviction order)."""
    k = int(round(num_layers * fraction))
    return max(0, min(num_layers, k))
