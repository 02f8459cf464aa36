"""Mixture-of-Experts, the single-device path: capacity-based top-k routing,
gated-SiLU experts as batched products, and the Switch load-balance loss.

The reference's ``repro/models/moe.py`` without a mesh: ``moe_init``,
``_route``, ``_expert_ffn``, ``_moe_local`` (no expert-parallel branch)
and the ``mesh is None`` branch of ``moe_block``.  Expert parallelism
(``use_ep``, ``moe_specs``) comes with the sharding slice.  The reference
runs the expert products as XLA einsums (no Pallas kernel), so they are
batched matmuls here.

Routing is the reference's, order for order: the router in float32, top-k
with ties to the lower expert id, assignments sorted stably by expert,
each one's rank within its expert from the first occurrence, and ranks at
or past the capacity dropped.  A dropped slot gathers the zero row ``T``
and carries weight 0; the combine adds the weighted expert outputs back in
the activation dtype (bf16 in a bf16 model), the sentinel row ``T``
absorbing the empty slots.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ModelContext, dense_init


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a block of ``tokens`` rows (the reference's
    expression, to the float)."""
    return _round_up(
        int(cfg.capacity_factor * tokens * cfg.top_k / cfg.num_experts) or 1,
        8)


# ---------------------------------------------------------------------------
def _expert_init(gen: torch.Generator, shape, scale: float, dtype, device,
                 stack: int) -> torch.Tensor:
    """``normal * scale`` of ``shape`` per layer, (stack, ...) if set, drawn
    a layer at a time: one layer's float32 draw is the largest temporary
    (a mixtral expert leaf is 1.88 GB of float32 a layer)."""
    out = torch.empty(((stack,) if stack else ()) + tuple(shape), dtype=dtype,
                      device=device)
    for layer in (out.unbind(0) if stack else (out,)):
        layer.copy_(torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device) * scale)
    return out


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             stack: int = 0) -> dict:
    """The reference's leaves: ``router`` (D, E) in float32 whatever the
    model dtype, experts ``w1`` / ``w3`` (E, D, F) and ``w2`` (E, F, D), and
    with ``shared_experts`` the always-on ``shared_w1/w3/w2``."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": dense_init(gen, D, E, torch.float32, device, stack=stack)}
    for name, shape in (("w1", (E, D, Fd)), ("w3", (E, D, Fd)),
                        ("w2", (E, Fd, D))):
        p[name] = _expert_init(gen, shape, shape[1] ** -0.5, dtype, device,
                               stack)
    if cfg.shared_experts:
        Fs = Fd * cfg.shared_experts
        p["shared_w1"] = dense_init(gen, D, Fs, dtype, device, stack=stack)
        p["shared_w3"] = dense_init(gen, D, Fs, dtype, device, stack=stack)
        p["shared_w2"] = dense_init(gen, Fs, D, dtype, device, stack=stack)
    return p


# ---------------------------------------------------------------------------
def route(x2d: torch.Tensor, router: torch.Tensor, top_k: int, cap: int,
          num_experts: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Capacity-based top-k routing of x2d (T, D).

    Returns ``gather_idx`` (E, C) into [0, T] (T: a dropped or empty
    slot), ``combine_w`` (E, C) float32 and the router probabilities
    (T, E) for the aux loss."""
    T = x2d.shape[0]
    dev = x2d.device
    probs = torch.softmax(x2d.float() @ router, dim=-1)        # (T, E)
    # lax.top_k: ties to the lower index, as a stable descending sort
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :top_k], top_i[:, :top_k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_i.reshape(-1)                                  # (T*k,)
    flat_w = top_p.reshape(-1)
    n = T * top_k
    tok = torch.arange(n, device=dev) // top_k
    order = torch.argsort(flat_e, stable=True)
    e_sorted, t_sorted, w_sorted = flat_e[order], tok[order], flat_w[order]
    # rank within each expert's group
    first = torch.searchsorted(e_sorted, e_sorted, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = rank < cap                                           # overflow drops
    at = (e_sorted[keep], rank[keep])
    gather_idx = torch.full((num_experts, cap), T, dtype=torch.long,
                            device=dev).index_put(at, t_sorted[keep])
    combine_w = torch.zeros((num_experts, cap), dtype=torch.float32,
                            device=dev).index_put(at, w_sorted[keep])
    return gather_idx, combine_w, probs


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """xe (E, C, D) -> (E, C, D), gated-SiLU experts."""
    return torch.bmm(F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3), w2)


def moe_local(params: dict, x2d: torch.Tensor, cfg: ModelConfig, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE body over T local tokens x2d (T, D) -> (out (T, D), aux
    load-balance loss)."""
    T, D = x2d.shape
    E = cfg.num_experts
    gather_idx, combine_w, probs = route(x2d, params["router"], cfg.top_k,
                                         cap, E)
    x_pad = torch.cat([x2d, x2d.new_zeros((1, D))], dim=0)
    ye = expert_ffn(x_pad[gather_idx], params["w1"], params["w3"],
                    params["w2"])
    ye = ye * combine_w[..., None].to(ye.dtype)
    out = torch.zeros((T + 1, D), dtype=ye.dtype, device=x2d.device
                      ).index_add(0, gather_idx.reshape(-1),
                                  ye.reshape(-1, D))[:T]
    if cfg.shared_experts:
        h = F.silu(x2d @ params["shared_w1"]) * (x2d @ params["shared_w3"])
        out = out + h @ params["shared_w2"]
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = F.one_hot(probs.argmax(-1), E).float().mean(0)
    aux = E * torch.sum(f * probs.mean(0))
    return out, aux


def moe_block(params: dict, ctx: ModelContext, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> ((B, S, D), aux loss): every row of the batch that
    enters the block routes and takes capacity (padding and the decode
    slots outside a length group included, as in the reference)."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    out, aux = moe_local(params, x2d, ctx.cfg, capacity(ctx.cfg, B * S))
    return out.reshape(B, S, D).to(x.dtype), aux
