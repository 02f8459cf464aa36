"""Layer stacks: the dense decoder, Mamba2 (SSM) and hybrid paths and the
paged-KV helpers.

The parameter tree is the reference's: ``embed``, ``final_norm`` and
``groups/sub_j/...`` with every group leaf stacked on a leading layer axis
and weights stored ``(d_in, d_out)``; a dense sub-layer holds ``{ln1,
attn/{wq,wk,wv,wo}, ln2, mlp/{w1,w2,w3}}``, an SSM sub-layer ``{ln1,
ssm/{in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale, out_proj}}``.
The hybrid (zamba2) keeps its one shared-weight transformer block
unstacked in ``shared`` and applies it at every site; its caches stack
that block's k/v over the sites as any group's.  A Python loop over the
stacked layer axis replaces the reference's ``lax.scan``.  Ported so far:
the dense family (smollm, h2o-danube, command-r, starcoder2), the pure
SSM family (mamba2) and the hybrid's serving path (zamba2); hybrid
training, MoE and the encoder-decoder branches come with later slices.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_block, attn_init,
                                          init_kv_cache)
from repro_torch.models.layers import (ModelContext, activation_fn,
                                       apply_norm, dense_init, embed_init,
                                       norm_init)

Params = Dict[str, Any]


def arch_group(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(group kinds, n_groups)."""
    if cfg.is_hybrid:
        k = cfg.hybrid_attn_every
        assert cfg.num_layers % k == 0
        return ("ssm",) * k + ("shared",), cfg.num_layers // k
    if cfg.is_ssm:
        return ("ssm",), cfg.num_layers
    if cfg.is_moe:
        if cfg.moe_every > 1:
            assert cfg.num_layers % cfg.moe_every == 0
            return ("dense",) * (cfg.moe_every - 1) + ("moe",), \
                cfg.num_layers // cfg.moe_every
        return ("moe",), cfg.num_layers
    return ("dense",), cfg.num_layers


def _require_ported(cfg: ModelConfig) -> None:
    """Admit the families ported so far (dense decoders, pure SSM, the
    SSM + shared-attention hybrid); name the slice that ports each of the
    others."""
    group, _ = arch_group(cfg)
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        later = "the encoder-decoder / VLM slice 3d"
    elif cfg.is_moe:
        later = "the MoE slice 3c"
    elif cfg.is_hybrid or group in (("dense",), ("ssm",)):
        return
    else:
        later = "a later slice"
    raise NotImplementedError(
        f"{cfg.name} ({cfg.family}): not ported yet; it comes with {later} "
        "(ROADMAP A)")


# ---------------------------------------------------------------------------
def mlp_init(gen, cfg: ModelConfig, dtype, device, stack: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, D, F, dtype, device, stack=stack),
         "w2": dense_init(gen, F, D, dtype, device, stack=stack)}
    if cfg.act == "silu":                 # gated (SwiGLU)
        p["w3"] = dense_init(gen, D, F, dtype, device, stack=stack)
    return p


def mlp_block(params: dict, ctx: ModelContext, x: torch.Tensor
              ) -> torch.Tensor:
    h = activation_fn(ctx.cfg.act)(x @ params["w1"])
    if "w3" in params:
        h = h * (x @ params["w3"])
    return h @ params["w2"]


def run_sublayer(kind: str, params: dict, ctx: ModelContext,
                 x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[dict] = None,
                 cache_index: Optional[int] = None,
                 paged: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One dense, shared (the hybrid's transformer block: the dense code
    on the unstacked ``shared`` weights) or SSM sub-layer; returns
    ``(x_out, cache)``.  An SSM sub-layer writes its new conv / ssm state
    into ``cache`` in place."""
    cfg = ctx.cfg
    if kind == "ssm":
        h = apply_norm(cfg, params["ln1"], x)
        y, new = ssm_mod.mamba_block(params["ssm"], ctx, h, cache)
        if cache is not None:
            for k, v in new.items():
                cache[k].copy_(v)
        return x + y, cache
    if kind not in ("dense", "shared"):
        raise NotImplementedError(f"sub-layer kind {kind!r} is not ported")
    h = apply_norm(cfg, params["ln1"], x)
    a, cache = attention_block(params["attn"], ctx, h, positions,
                               cache=cache, cache_index=cache_index,
                               paged=paged)
    if cfg.parallel_block:
        return x + a + mlp_block(params["mlp"], ctx, h), cache  # cohere
    x = x + a
    h = apply_norm(cfg, params["ln2"], x)
    return x + mlp_block(params["mlp"], ctx, h), cache


# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """Random parameters with the reference's shapes and init scales."""
    _require_ported(cfg)
    group, L = arch_group(cfg)
    D = cfg.d_model

    def stacked_norm(n):
        return tree.map(lambda t: t.expand(n, -1).clone(),
                        norm_init(cfg, D, device))

    def sublayer(kind, stack=L):
        if kind == "ssm":
            return {"ln1": stacked_norm(stack),
                    "ssm": ssm_mod.mamba_init(gen, cfg, dtype, device,
                                              stack=stack)}
        sub = {"ln1": stacked_norm(stack),
               "attn": attn_init(gen, cfg, dtype, device, stack=stack),
               "mlp": mlp_init(gen, cfg, dtype, device, stack=stack)}
        if not cfg.parallel_block:
            sub["ln2"] = stacked_norm(stack)
        return sub

    p: Params = {"embed": embed_init(gen, cfg.padded_vocab, D, dtype, device),
                 "final_norm": norm_init(cfg, D, device),
                 "groups": {f"sub_{j}": sublayer(kind)
                            for j, kind in enumerate(group)
                            if kind != "shared"}}
    if not cfg.tie_embeddings:
        p["unembed"] = embed_init(gen, cfg.padded_vocab, D, dtype, device)
    if "shared" in group:
        # one block's weights, applied at every site: a stack of one,
        # unstacked
        p["shared"] = tree.map(lambda t: t[0], sublayer("shared", stack=1))
    return p


def embed_tokens(params: Params, ctx: ModelContext, tokens: torch.Tensor
                 ) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params: Params, ctx: ModelContext, h: torch.Tensor
            ) -> torch.Tensor:
    table = params["embed"] if ctx.cfg.tie_embeddings else params["unembed"]
    return h @ table.T


def _train_sublayer(ctx: ModelContext, kind: str, params: dict,
                    x: torch.Tensor, positions: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sub-layer of the training stack -> (x_out, aux loss)."""
    y, _ = run_sublayer(kind, params, ctx, x, positions)
    return y, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_train(params: Params, ctx: ModelContext, tokens: torch.Tensor,
                  positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, D), aux_loss).

    Every layer group runs wrapped by the memory runtime (``ctx.wrap``:
    input stashed to the tier, layer recomputed in backward; the bare
    layer when the tier does not offload).  The reference's split into a
    stashed and an unstashed scan serves the ``auto`` planner, which ports
    with slice 5."""
    _require_ported(ctx.cfg)
    cfg = ctx.cfg
    if cfg.is_hybrid:
        raise NotImplementedError(
            f"{cfg.name}: hybrid training is not ported yet (the rest of "
            "slice 3b): forward_train over the shared attention block is "
            "missing; the flash forward already takes head_dim "
            f"{cfg.resolved_head_dim} (ROADMAP A1)")
    group, n_groups = arch_group(cfg)
    x = embed_tokens(params, ctx, tokens)

    def bare(kind):
        return functools.partial(_train_sublayer, ctx, kind)

    wrapped = {k: ctx.wrap(f"{k}_layer", bare(k)) for k in set(group)}
    # one unbind per stacked leaf: backward stacks the per-layer gradients
    # once, instead of a full-size zero tensor per layer and leaf
    stacks = []
    for j in range(len(group)):
        leaves, paths = tree.flatten(params["groups"][f"sub_{j}"])
        stacks.append((paths, [t.unbind(0) for t in leaves]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_groups):
        for j, kind in enumerate(group):
            paths, unbound = stacks[j]
            p = tree.unflatten(paths, [u[layer] for u in unbound])
            x, a = wrapped[kind](p, x, positions)
            aux = aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


def forward_serve(params: Params, ctx: ModelContext, tokens: torch.Tensor,
                  positions: torch.Tensor, caches: Params, cache_index: int,
                  paged: Optional[dict] = None) -> Tuple[torch.Tensor, Params]:
    """Prefill (S > 1) / decode (S == 1) against stacked caches.

    ``caches``: ``{"sub_j": {leaf: (n_groups, ...)}}``; layer ``l`` works
    on the views ``leaf[l]`` and writes them in place.  With ``paged`` the
    leaves are the page pool (see ``attention_block``).  Returns the final
    hidden state and ``caches``."""
    cfg = ctx.cfg
    group, n_groups = arch_group(cfg)
    x = embed_tokens(params, ctx, tokens)
    for layer in range(n_groups):
        for j, kind in enumerate(group):
            p = (params["shared"] if kind == "shared" else
                 tree.map(lambda t: t[layer], params["groups"][f"sub_{j}"]))
            c = caches.get(f"sub_{j}")
            c = {k: v[layer] for k, v in c.items()} if c is not None else None
            x, _ = run_sublayer(kind, p, ctx, x, positions, cache=c,
                                cache_index=cache_index, paged=paged)
    return apply_norm(cfg, params["final_norm"], x), caches


# ---------------------------------------------------------------------------
# caches
def init_caches(cfg: ModelConfig, batch: int, seq: int, dtype, device
                ) -> Params:
    """Stacked caches matching forward_serve: (n_groups, B, S, K, hd) k/v
    for a dense group and for the hybrid's shared block (one row of the
    stack per site), (n_groups, B, W-1, conv_dim) conv and (n_groups, B,
    H, P, N) ssm state for an SSM group."""
    _require_ported(cfg)
    group, n_groups = arch_group(cfg)

    def one(kind):
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        return init_kv_cache(cfg, batch, seq, dtype, device)

    return {f"sub_{j}": {k: v[None].repeat(n_groups, *([1] * v.ndim))
                         for k, v in one(kind).items()}
            for j, kind in enumerate(group)}


def slot_cache(caches: Params, slot: int) -> Params:
    """A copy of one batch slot of the stacked caches (batch dim kept)."""
    return tree.map(lambda c: c[:, slot:slot + 1].clone(), caches)


def merge_slot_cache(caches: Params, one_cache: Params, slot: int) -> None:
    """Write a single-slot cache back into batch position ``slot``."""
    tree.map(lambda c, n: c[:, slot:slot + 1].copy_(n), caches, one_cache)


# ---------------------------------------------------------------------------
# paged KV: the contiguous per-slot sequence axis becomes a pool of
# fixed-size pages — the paper's unit of pool placement applied to serving.
PAGED_KEYS = ("k", "v")


def split_paged(caches: Params) -> Tuple[Params, Params]:
    """Split a stacked cache tree into (paged kv leaves, slot-shaped rest)."""
    paged = {g: {k: v for k, v in sub.items() if k in PAGED_KEYS}
             for g, sub in caches.items()}
    rest = {g: {k: v for k, v in sub.items() if k not in PAGED_KEYS}
            for g, sub in caches.items()}
    return paged, rest


def paged_pool(cfg: ModelConfig, num_pages: int, page_size: int, dtype,
               device, batch: int = 1) -> Tuple[Params, Params]:
    """A zeroed page pool and the slot-shaped rest of the cache, as the
    reference's ``paged_pool``: every group with k/v leaves is paged —
    each leaf (n_groups, num_pages + 1, page, K, hd), ``num_pages`` real
    frames plus ONE trailing scratch frame (id ``num_pages``) that absorbs
    writes routed away by the slot mask — and every other leaf (the SSM
    groups' conv / ssm state) stays one row per decode slot in
    ``slot_tree`` ((n_groups, batch, ...), as :func:`init_caches`).
    Raises ``ValueError`` for an architecture with no k/v cache (pure SSM
    state is O(1) a session and gains nothing from paging)."""
    _require_ported(cfg)
    group, n_groups = arch_group(cfg)
    shape = (n_groups, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    pool, slot_tree = {}, {}
    for j, kind in enumerate(group):
        if kind == "ssm":
            slot_tree[f"sub_{j}"] = {
                k: v[None].repeat(n_groups, *([1] * v.ndim)) for k, v in
                ssm_mod.init_ssm_cache(cfg, batch, dtype, device).items()}
        else:
            pool[f"sub_{j}"] = {k: torch.zeros(shape, dtype=dtype,
                                               device=device)
                                for k in PAGED_KEYS}
    if not pool:
        raise ValueError("paged KV needs attention k/v caches; this "
                         f"architecture's cache ({cfg.name}) has none")
    return pool, slot_tree


def gather_pages(pool: Params, slot_tree: Params, page_map: torch.Tensor
                 ) -> Params:
    """The contiguous decode view: each paged leaf's (G, B, pp*page, K, hd)
    rows materialised from the pool (a copy; unowned positions read the
    scratch frame), merged with the slot-shaped leaves of ``slot_tree``
    (the storage itself, not a copy) into the tree ``forward_serve``
    takes."""
    B, pp = page_map.shape
    flat = page_map.reshape(-1).long()

    def one(c):
        g = c[:, flat]                             # (G, B*pp, page, K, hd)
        G, _, page, K, hd = g.shape
        return g.reshape(G, B, pp * page, K, hd)

    gathered = tree.map(one, pool)
    return {g: {**slot_tree.get(g, {}), **gathered.get(g, {})}
            for g in set(pool) | set(slot_tree)}


def scatter_pages(pool: Params, caches: Params, page_map: torch.Tensor
                  ) -> None:
    """Write the paged leaves of a (G, B, pp*page, K, hd) view into the
    pool at ``page_map`` (in place; non-writable positions route to
    scratch), group by group of the pool."""
    B, pp = page_map.shape
    flat = page_map.reshape(-1).long()
    for g, leaves in pool.items():
        for k, p in leaves.items():
            c = caches[g][k]
            G, B_, S, K, hd = c.shape
            p[:, flat] = c.reshape(G, B_ * pp, S // pp, K, hd).to(p.dtype)


def scatter_one_page(pool: Params, caches: Params, target: torch.Tensor,
                     row_start: int, page_size: int) -> None:
    """Write back only the page a decode step touched: ``target`` is its
    (B,) pool ids (scratch for slots outside the decode group)."""
    tgt = target.long()
    for g, leaves in pool.items():
        for k, p in leaves.items():
            p[:, tgt] = caches[g][k][:, :, row_start:row_start + page_size
                                     ].to(p.dtype)


def slot_pages(one_cache: Params, page_size: int, num_pages: int
               ) -> Tuple[List[Params], Params]:
    """Chop a single-slot cache into page-shaped (G, page, K, hd) chunks of
    the groups with k/v leaves, returning ``(pages, rest)`` with the
    slot-shaped leaves in ``rest``."""
    if page_size < 1 or num_pages < 1:
        raise ValueError(f"bad page chunking: {num_pages}x{page_size}")
    paged, rest = split_paged(one_cache)
    paged = {g: sub for g, sub in paged.items() if sub}
    leaves = tree.leaves(paged)
    if leaves and num_pages * page_size > leaves[0].shape[2]:
        raise ValueError(f"{num_pages} pages of {page_size} rows exceed the "
                         f"slot's {leaves[0].shape[2]} cache rows")
    pages = [tree.map(lambda c: c[:, 0, p * page_size:(p + 1) * page_size]
                      .clone(), paged) for p in range(num_pages)]
    return pages, rest


def page_slice(pool: Params, pid: int) -> Params:
    """A copy of one page (all groups) of the pool — the spill unit.  A
    copy, so a later in-place write to the frame cannot reach a payload."""
    return tree.map(lambda c: c[:, pid].clone(), pool)


def page_insert(pool: Params, page: Params, pid: int) -> None:
    """Write a fetched page into pool position ``pid`` (in place)."""
    tree.map(lambda c, n: c[:, pid].copy_(n), pool, page)
