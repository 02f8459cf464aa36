"""AdamW with optional 8-bit moment quantization (beyond-paper).

The reference's optimizer, in plain torch (it has no kernel there).  The
8-bit mode stores both Adam moments as int8 with a per-row fp32 scale
(row = leading dims, blocked over the last axis), shrinking optimizer state
from 8 bytes/param to ~2.  Parameters are updated in place (the reference
returns new arrays; in place keeps one copy of the weights on the card),
and the function returns them all the same.

On a mesh the parameters, gradients and moments are this rank's shards
(``opt_state_specs``: the moments shard as their parameters, an 8-bit
moment's per-row scale drops the last dim's axes).  The update is
elementwise; the clip's global norm sums each element once (a shard's
squares all-reduced over the axes that split it, not over those that
replicate it), and an 8-bit row split over ranks takes its absmax (its
log range) over the whole row, so every rank's codes are the one-device
run's.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.ref import true_div
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import PartitionSpec as P

Pytree = Any
INT8_MAX = 127.0


# ---------------------------------------------------------------------------
# 8-bit moment quantization.
#   m (signed, zero-centred): per-row absmax linear int8.
#   v (non-negative, huge dynamic range): per-row *log-domain* int8 — linear
#   quantization underflows small v entries to 0 and Adam's m/(sqrt(v)+eps)
#   explodes; quantizing log(v) bounds the relative error instead.
_V_FLOOR = 1e-16


def _whole_row(t: torch.Tensor, op: str, row=None) -> torch.Tensor:
    """``t`` (a per-row statistic) reduced with ``op`` over the ranks of
    ``row``, the group a sharded last dim is split over (None: whole)."""
    if row is None:
        return t
    from repro_torch.parallel import collectives as coll
    return coll.all_reduce(t, row, op)


def _q8(x: torch.Tensor, row=None) -> Dict[str, torch.Tensor]:
    scale = true_div(torch.clamp(_whole_row(
        x.abs().amax(dim=-1, keepdim=True), "max", row), min=1e-30),
        INT8_MAX)
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return {"q": q.to(torch.int8), "scale": scale.float()}


def _dq8(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    return s["q"].float() * s["scale"]


def _q8_log(x: torch.Tensor, row=None) -> Dict[str, torch.Tensor]:
    lx = torch.log(torch.clamp(x, min=_V_FLOOR))
    lo = _whole_row(lx.amin(dim=-1, keepdim=True), "min", row)
    hi = _whole_row(lx.amax(dim=-1, keepdim=True), "max", row)
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp(torch.round((lx - lo) / span * 254.0 - 127.0),
                    -INT8_MAX, INT8_MAX)
    return {"q": q.to(torch.int8), "lo": lo.float(), "hi": hi.float()}


def _dq8_log(s: Dict[str, torch.Tensor]) -> torch.Tensor:
    span = torch.clamp(s["hi"] - s["lo"], min=1e-6)
    lx = s["lo"] + true_div(s["q"].float() + 127.0, 254.0) * span
    v = torch.exp(lx)
    return torch.where(v <= _V_FLOOR * 1.01, 0.0, v)


def _is_q8(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) in ({"q", "scale"},
                                                    {"q", "lo", "hi"})


def _dq_any(leaf) -> torch.Tensor:
    return _dq8_log(leaf) if "lo" in leaf else _dq8(leaf)


# ---------------------------------------------------------------------------
def init_opt_state(params: Pytree, bits: int = 32) -> Pytree:
    def zero_m(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8(z) if (bits == 8 and p.ndim >= 1) else z

    def zero_v(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8_log(z) if (bits == 8 and p.ndim >= 1) else z

    device = tree.leaves(params)[0].device
    return {"m": tree.map(zero_m, params), "v": tree.map(zero_v, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs: Pytree, bits: int = 32) -> Pytree:
    """Moment sharding mirrors the parameter sharding (per-row scales drop
    the last dim's axis): the reference's table."""

    def row(sp: P) -> P:
        parts = tuple(sp)
        return P(*(parts[:-1] + (None,))) if parts else P()

    def like_m(sp: P):
        return sp if bits != 8 else {"q": sp, "scale": row(sp)}

    def like_v(sp: P):
        return sp if bits != 8 else {"q": sp, "lo": row(sp), "hi": row(sp)}

    return {"m": tree.map(like_m, param_specs),
            "v": tree.map(like_v, param_specs), "count": P()}


# ---------------------------------------------------------------------------
def lr_schedule(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to 10% (float32, as the reference)."""
    step = step.float()
    warm = torch.clamp(true_div(step, max(tc.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(true_div(step - tc.warmup_steps,
                                max(tc.total_steps - tc.warmup_steps, 1)),
                       0, 1)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * cos


def global_norm(grads: Pytree, mesh=None, specs: Pytree = None
                ) -> torch.Tensor:
    """The gradients' global L2 norm; on a mesh (``specs`` the shards'
    specs) the shards' squares summed over the axes that split them."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree.leaves(grads)))
    by_axes: Dict[tuple, torch.Tensor] = {}
    for g, sp in zip(tree.leaves(grads), tree.leaves(specs)):
        axes = mesh.axes([a for d in sharding.dim_axes(sp, g.ndim)
                          for a in d])
        sq = torch.sum(torch.square(g.float()))
        by_axes[axes] = by_axes[axes] + sq if axes in by_axes else sq
    from repro_torch.parallel import collectives as coll
    total = sum(coll.all_reduce(by_axes[axes], mesh.group(axes)) if axes
                else by_axes[axes] for axes in sorted(by_axes))
    return torch.sqrt(total)


def _row_group(p: torch.Tensor, spec: P, mesh):
    """The process group a sharded last dim of ``p`` is split over (None
    when the rows are whole on this rank)."""
    if mesh is None or p.ndim == 0:
        return None
    return mesh.group(sharding.dim_axes(spec, p.ndim)[-1])


def _adamw_f32(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, clip, lr, bc1, bc2, tc: TrainConfig,
               decay: bool) -> None:
    """The AdamW update of one leaf with float32 moments, ``p``, ``m`` and
    ``v`` in place, the same roundings as the out-of-place form."""
    b1, b2, eps = tc.beta1, tc.beta2, tc.eps
    g = g.float() * clip
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * torch.square(g))
    upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if decay:
        upd = upd + tc.weight_decay * p.float()
    p.copy_((p.float() - lr * upd).to(p.dtype))


@torch.no_grad()
def apply_adamw(params: Pytree, grads: Pytree, state: Pytree,
                tc: TrainConfig, mesh=None, specs: Pytree = None
                ) -> Tuple[Pytree, Pytree, Dict[str, Any]]:
    """One AdamW step with global-norm clipping.  Returns (params, state,
    metrics); ``params`` are the same tensors, updated in place, and so
    are float32 moments (8-bit ones are requantised into new leaves).  A
    stacked leaf with float32 moments is updated a layer at a time, so
    the float32 temporaries are one layer's (a mixtral expert leaf is
    1.9 GB of float32 a layer).  On a mesh (a MeshGroups) every leaf is a
    shard and ``specs`` the parameters' specs."""
    count = state["count"] + 1
    gnorm = global_norm(grads, mesh, specs)
    clip = torch.clamp(torch.full_like(gnorm, tc.grad_clip)
                       / torch.clamp(gnorm, min=1e-9),
                       max=1.0) if tc.grad_clip > 0 else 1.0
    lr = lr_schedule(tc, count)
    b1, b2 = tc.beta1, tc.beta2
    cf = count.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=cf.device), cf)

    flat_p, paths = tree.flatten(params)
    flat_g = tree.leaves(grads)
    # moments: one entry per parameter path (a q8 dict is one moment)
    flat_m = [_at(state["m"], p) for p in paths]
    flat_v = [_at(state["v"], p) for p in paths]
    flat_s = [None] * len(paths) if mesh is None else \
        [_at(specs, p) for p in paths]
    new_m, new_v = [], []
    for p, g, m, v, sp in zip(flat_p, flat_g, flat_m, flat_v, flat_s):
        if _is_q8(m):               # 8-bit moments (never on a scalar)
            m_f, v_f = _dq_any(m), _dq_any(v)
            _adamw_f32(p, g, m_f, v_f, clip, lr, bc1, bc2, tc, True)
            row = _row_group(p, sp, mesh)
            new_m.append(_q8(m_f, row))
            new_v.append(_q8_log(v_f, row))
            continue
        # decoupled weight decay on every leaf but scalars
        for sl in ([(p, g, m, v)] if p.ndim < 3 else
                   zip(p.unbind(0), g.unbind(0), m.unbind(0), v.unbind(0))):
            _adamw_f32(*sl, clip, lr, bc1, bc2, tc, p.ndim >= 1)
        new_m.append(m)
        new_v.append(v)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return (params,
            {"m": tree.unflatten(paths, new_m),
             "v": tree.unflatten(paths, new_v), "count": count},
            metrics)


def _at(t: Pytree, path) -> Any:
    for k in path:
        t = t[k]
    return t
