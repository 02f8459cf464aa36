"""Divisibility-aware sharding planner.

DTensor, like GSPMD, shards a dim evenly only when the dim divides by the
mesh axes it is split over, so every spec is produced through
:class:`ShardingPlanner`, which drops an axis assignment when the dim is
not divisible and records the fallback.  That is what lets one code path
serve all 10 architectures (36-head starcoder2 and 9-head smollm simply
fall back to sequence-parallel activations).

A spec is a :class:`PartitionSpec` of the port's own: a tuple with one
entry a tensor dim (``None``, an axis name or a tuple of names), trailing
``None`` dropped.  :meth:`ShardingPlanner.named` turns it into the DTensor
placements (``Shard(d)`` / ``Replicate()``) of each dimension of a
``DeviceMesh``.  The sharded step keeps each tensor as this rank's
block of it (its *local shard*) beside its spec: :class:`MeshGroups`
gives a rank its coordinates and the process group of every set of mesh
axes, :func:`shard` cuts a rank's block out of a whole tensor,
:func:`constrain` moves a local shard from one spec to another (a slice
or an all-gather over the axes that differ), and :func:`gather_params`
gathers parameter shards under autograd, FSDP style: its backward
reduces the full gradient back to the shard over the batch axes.

Logical axes used throughout the codebase:
  "batch"  -> physical ("pod", "data")        DP / FSDP batch shard
  "fsdp"   -> physical ("data",)              weight pooling (ZeRO-3)
  "tensor" -> physical ("model",)             Megatron TP
  "expert" -> physical ("model",)             expert parallelism
  "pool"   -> paper's memory-node striping (see core/pool.py)
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import tree
from repro_torch.configs.base import MeshPlan

AxisAssignment = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None`` (replicated), a mesh axis name or
    a tuple of names (the dim split over their product, in order)."""

    def __new__(cls, *parts: AxisAssignment) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical→physical axis translation for a mesh plan."""

    plan: MeshPlan

    @property
    def batch(self) -> Tuple[str, ...]:
        return self.plan.batch_axes            # ("pod","data") or ("data",)

    @property
    def fsdp(self) -> Tuple[str, ...]:
        return ("data",) if "data" in self.plan.axes else ()

    @property
    def tensor(self) -> Tuple[str, ...]:
        return ("model",) if "model" in self.plan.axes else ()

    expert = tensor

    def size(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.plan.axis_size(a)
        return n


def _flatten(assignment: AxisAssignment) -> Tuple[str, ...]:
    if assignment is None:
        return ()
    if isinstance(assignment, str):
        return (assignment,)
    return tuple(assignment)


class ShardingPlanner:
    """Builds PartitionSpecs, silently dropping non-divisible assignments."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan
        self.axes = Axes(plan)
        self.fallbacks: Dict[str, str] = {}

    def spec(self, shape: Sequence[int], assignment: Sequence[AxisAssignment],
             name: str = "?") -> PartitionSpec:
        assert len(shape) == len(assignment), (name, shape, assignment)
        parts = []
        for dim, want in zip(shape, assignment):
            ax = _flatten(want)
            # keep the largest prefix of axes whose product divides dim
            kept: Tuple[str, ...] = ()
            size = 1
            for a in ax:
                if a not in self.plan.axes:
                    continue
                nxt = size * self.plan.axis_size(a)
                if dim % nxt == 0:
                    kept = kept + (a,)
                    size = nxt
                else:
                    self.fallbacks[f"{name}[{dim}]"] = (
                        f"dropped axis {a!r} (dim {dim} % {nxt} != 0)")
            if not kept:
                parts.append(None)
            elif len(kept) == 1:
                parts.append(kept[0])
            else:
                parts.append(kept)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def named(self, mesh, shape: Sequence[int],
              assignment: Sequence[AxisAssignment], name: str = "?"
              ) -> tuple:
        """The DTensor placements of :meth:`spec` on ``mesh`` (a
        ``DeviceMesh`` whose dimension names are the plan's axes): one
        per mesh dimension, ``Shard(d)`` where tensor dim ``d`` is split
        over it, else ``Replicate()``."""
        return placements(mesh, self.spec(shape, assignment, name))


def placements(mesh, spec: PartitionSpec) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per dimension."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names or ()
    out = [Replicate() for _ in range(mesh.ndim)]
    for d, part in enumerate(spec):
        for a in _flatten(part):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_to_spec(planner: ShardingPlanner, shape: Sequence[int],
                    logical: Sequence[Optional[str]], name: str = "?"
                    ) -> PartitionSpec:
    """Translate logical dim roles into a PartitionSpec.

    Roles: "batch", "fsdp", "tensor", "expert", "seq", None.
    "seq" is unsharded by default (sequence parallelism is applied explicitly
    through constraint helpers in the model code / core.pool).
    """
    ax = planner.axes
    table: Dict[Optional[str], AxisAssignment] = {
        None: None,
        "batch": ax.batch,
        "fsdp": ax.fsdp,
        "tensor": ax.tensor,
        "expert": ax.expert,
        "seq": None,
    }
    return planner.spec(shape, [table[r] for r in logical], name)


def dim_axes(spec: PartitionSpec, ndim: int) -> List[Tuple[str, ...]]:
    """The axes each of ``ndim`` dims is split over (trailing dims the
    spec leaves out are whole)."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [_flatten(p) for p in spec] + [()] * (ndim - len(spec))


class MeshGroups:
    """What the sharded step needs of a ``DeviceMesh``: this rank's
    coordinate on each axis and the process group of every set of axes
    (its members the ranks that differ only on those axes).  The groups
    of more than one axis are made here, in one order on every rank, as
    ``new_group`` needs."""

    def __init__(self, mesh):
        import torch.distributed as dist
        self.mesh = mesh
        self.names: Tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.shape: Tuple[int, ...] = tuple(mesh.shape)
        grid = mesh.mesh.reshape(self.shape)
        self.coords: Dict[int, Dict[str, int]] = {
            int(grid[idx]): dict(zip(self.names, idx))
            for idx in itertools.product(*map(range, self.shape))}
        self.rank = dist.get_rank()
        self.coord = self.coords[self.rank]
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(self.names) + 1):
            for axes in itertools.combinations(self.names, k):
                if k == 1:
                    self._groups[axes] = mesh.get_group(axes[0])
                    continue
                mine = None
                fixed = [a for a in self.names if a not in axes]
                for key in itertools.product(
                        *[range(self.axis_size(a)) for a in fixed]):
                    ranks = sorted(r for r, c in self.coords.items() if all(
                        c[a] == v for a, v in zip(fixed, key)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[axes] = mine

    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.names.index(axis)] if axis in self.names \
            else 1

    def axes(self, axes: Sequence[str]) -> Tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 (or not on the mesh)
        left out."""
        return tuple(a for a in self.names if a in axes
                     and self.axis_size(a) > 1)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (this rank's); None for no
        axis."""
        axes = self.axes(axes)
        return self._groups[axes] if axes else None

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index along a dim split over ``axes`` in that
        order (the first the major one)."""
        i = 0
        for a in axes:
            i = i * self.axis_size(a) + self.coord.get(a, 0)
        return i


_MESH_GROUPS: Dict[int, MeshGroups] = {}


def mesh_groups(mesh) -> Optional[MeshGroups]:
    """The :class:`MeshGroups` of a ``DeviceMesh`` (made on first use, the
    same object after), the argument itself if it is one, None for no
    mesh or a mesh of one device."""
    if mesh is None or isinstance(mesh, MeshGroups):
        return mesh
    if mesh.size() == 1:
        return None
    key = id(mesh)
    if key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = MeshGroups(mesh)
    return _MESH_GROUPS[key]


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                ) -> Tuple[int, ...]:
    """A rank's block shape of a tensor of global ``shape`` under
    ``spec``."""
    mg = mesh_groups(mesh)
    if mg is None:
        return tuple(shape)
    return tuple(n // math.prod(mg.axis_size(a) for a in axes)
                 for n, axes in zip(shape, dim_axes(spec, len(shape))))


def global_shape(shape: Sequence[int], spec: PartitionSpec, mesh
                 ) -> Tuple[int, ...]:
    """The global shape of which a local shard of ``shape`` under
    ``spec`` is one block."""
    mg = mesh_groups(mesh)
    if mg is None:
        return tuple(shape)
    return tuple(n * math.prod(mg.axis_size(a) for a in axes)
                 for n, axes in zip(shape, dim_axes(spec, len(shape))))


def shard(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec`` (a copy
    of its own)."""
    return constrain(x, mesh, spec).clone()


def _ordered_group(mg: MeshGroups, axes: Sequence[str]):
    """The group over ``axes``, whose group ranks are the block indices
    along a dim split over them only when they come in mesh order."""
    axes = tuple(a for a in axes if mg.axis_size(a) > 1)
    if axes != mg.axes(axes):
        raise NotImplementedError(f"a dim split over {axes}, not in the "
                                  f"mesh's order {mg.names}")
    return mg.group(axes)


def constrain(x: torch.Tensor, mesh, spec: PartitionSpec,
              src: PartitionSpec = PartitionSpec()) -> torch.Tensor:
    """The sharding constraint on a local shard: ``x``, this rank's block
    under ``src`` (the whole tensor by default), becomes its block under
    ``spec``.  Off-mesh (no mesh, or a mesh of one device) it is ``x``.

    Dim by dim, where ``spec`` splits over more axes than ``src`` (``src``'s
    axes a prefix of ``spec``'s) the block is a slice of ``x`` (a view);
    where it splits over fewer, the blocks of the ranks that differ on the
    dropped axes are all-gathered.  Any other change (moving an axis
    between dims) raises."""
    mg = mesh_groups(mesh)
    if mg is None:
        return x
    from repro_torch.parallel import collectives as coll
    for d, (have, want) in enumerate(zip(dim_axes(src, x.ndim),
                                         dim_axes(spec, x.ndim))):
        if have == want:
            continue
        if want[:len(have)] == have:
            extra = want[len(have):]
            n = math.prod(mg.axis_size(a) for a in extra)
            if x.shape[d] % n:
                raise ValueError(f"constrain: dim {d} of {tuple(x.shape)} "
                                 f"does not split over {extra}")
            x = x.chunk(n, dim=d)[mg.index(extra)] if n > 1 else x
        elif have[:len(want)] == want:
            extra = have[len(want):]
            if math.prod(mg.axis_size(a) for a in extra) == 1:
                continue
            x = coll.all_gather(x, d, _ordered_group(mg, extra))
        else:
            raise ValueError(f"constrain: dim {d} moves from {have} to "
                             f"{want}; only a slice or a gather is "
                             "supported")
    return x


def reduce_to_shard(g: torch.Tensor, spec: PartitionSpec, mesh,
                    batch_axes: Sequence[str]) -> torch.Tensor:
    """This rank's block under ``spec`` of the sum over ``batch_axes`` of
    the ranks' full gradients ``g``: the ranks of one batch group saw
    other rows, those that differ on the other axes the same ones.  A dim
    split over batch axes is reduce-scattered over them, a dim split over
    the others sliced; batch axes that split no dim are all-reduced."""
    mg = mesh_groups(mesh)
    if mg is None:
        return g
    from repro_torch.parallel import collectives as coll
    batch = set(mg.axes(batch_axes))
    used = set()
    for d, axes in enumerate(dim_axes(spec, g.ndim)):
        axes = tuple(a for a in axes if mg.axis_size(a) > 1)
        if not axes:
            continue
        on_batch = [a in batch for a in axes]
        if all(on_batch):
            g = coll.reduce_scatter(g, d, _ordered_group(mg, axes))
            used.update(axes)
        elif not any(on_batch):
            g = g.chunk(math.prod(mg.axis_size(a) for a in axes),
                        dim=d)[mg.index(axes)]
        else:
            raise NotImplementedError(
                f"reduce_to_shard: dim {d} splits over batch and other "
                f"axes {axes}")
    rest = mg.axes(batch - used)
    if rest:
        g = coll.all_reduce(g, mg.group(rest))
    return g.contiguous()


class _GatherParam(torch.autograd.Function):
    """A parameter shard gathered whole; backward reduces the whole
    gradient back to the shard (:func:`reduce_to_shard`)."""

    @staticmethod
    def forward(ctx, x, spec, mg, batch_axes):
        ctx.spec, ctx.mg, ctx.batch_axes = spec, mg, batch_axes
        return constrain(x, mg, PartitionSpec(), src=spec)

    @staticmethod
    def backward(ctx, g):
        return (reduce_to_shard(g, ctx.spec, ctx.mg, ctx.batch_axes), None,
                None, None)


def gather_params(params: Any, specs: Any, mesh, batch_axes: Sequence[str]
                  ) -> Any:
    """The whole tensors of a tree of parameter shards (``specs`` the
    matching tree of specs), under autograd: a leaf that requires a
    gradient gets its shard's gradient reduced over ``batch_axes``."""
    mg = mesh_groups(mesh)
    if mg is None or specs is None:
        return params

    def one(x, spec):
        if not x.requires_grad or not torch.is_grad_enabled():
            return constrain(x, mg, PartitionSpec(), src=spec)
        return _GatherParam.apply(x, spec, mg, tuple(batch_axes))

    return tree.map(one, params, specs)
