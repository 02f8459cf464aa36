"""Layer stacks: the dense decoder, Mamba2 (SSM) and hybrid paths and the
paged-KV helpers.

The parameter tree is the reference's: ``embed``, ``final_norm`` and
``groups/sub_j/...`` with every group leaf stacked on a leading layer axis
and weights stored ``(d_in, d_out)``; a dense sub-layer holds ``{ln1,
attn/{wq,wk,wv,wo}, ln2, mlp/{w1,w2,w3}}``, an SSM sub-layer ``{ln1,
ssm/{in_proj, conv_w, conv_b, A_log, D, dt_bias, norm_scale, out_proj}}``,
an MoE sub-layer ``{ln1, attn, ln2, moe/{router, w1, w3, w2[, shared_w1,
shared_w3, shared_w2]}}``.  The hybrid (zamba2) keeps its one
shared-weight transformer block unstacked in ``shared`` and applies it
at every site; its caches stack
that block's k/v over the sites as any group's.  The encoder-decoder
(whisper) adds ``frontend/{proj, pos}`` and ``encoder/{layers,
final_norm}`` (its ``"enc"`` layers are dense sub-layers, bidirectional
and without RoPE) and its decoder group is ``"dec"``: ``{ln1, attn,
ln_x, cross, ln2, mlp}``, causal self-attention, cross-attention over the
encoder's states, an MLP; the VLM (qwen2-vl) is a dense decoder with a
patch frontend and M-RoPE.  A Python loop over the stacked layer axis
replaces the reference's ``lax.scan``.  Every configuration of the
registry builds: the dense family (smollm, h2o-danube, command-r,
starcoder2), the pure SSM family (mamba2), the hybrid (zamba2), the MoE
family on one device (mixtral: every layer MoE; llama4: a ``("dense",
"moe")`` group), the encoder-decoder (whisper) and the VLM (qwen2-vl).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontends
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (attention_block, attn_init,
                                          cross_attention_block,
                                          encode_cross_kv, init_kv_cache)
from repro_torch.models.layers import (ModelContext, activation_fn,
                                       apply_norm, dense_init, embed_init,
                                       norm_init, sinusoidal_pos)

Params = Dict[str, Any]


def arch_group(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int]:
    """(group kinds, n_groups) of the decoder stack (whisper's encoder
    layers are ``params["encoder"]``, outside the groups)."""
    if cfg.is_encoder_decoder:
        return ("dec",), cfg.num_layers
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
                 x: torch.Tensor, positions: Optional[torch.Tensor],
                 cache: Optional[dict] = None,
                 cache_index: Optional[int] = None,
                 prefix_attend: bool = False,
                 paged: Optional[dict] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 causal: bool = True, use_rope: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[dict]]:
    """One dense, shared (the hybrid's transformer block: the dense code
    on the unstacked ``shared`` weights), MoE, SSM, encoder (``"enc"``:
    the dense code, called with ``causal`` and ``use_rope`` off) or
    whisper decoder (``"dec"``) sub-layer; returns ``(x_out, aux loss,
    cache)`` (the aux loss is the MoE block's, None for the other kinds).
    An SSM sub-layer writes its new conv / ssm state into ``cache`` in
    place.  A ``"dec"`` layer cross-attends over the cache's ``ck`` /
    ``cv`` when the cache has them, as the reference does (zeros until
    something writes them: no serving path does), else over ``enc_out``
    projected by its ``cross`` weights."""
    cfg = ctx.cfg
    if kind == "ssm":
        h = apply_norm(cfg, params["ln1"], x)
        y, new = ssm_mod.mamba_block(params["ssm"], ctx, h, cache)
        if cache is not None:
            for k, v in new.items():
                cache[k].copy_(v)
        return x + y, None, cache
    if kind == "dec":
        h = apply_norm(cfg, params["ln1"], x)
        a, cache = attention_block(params["attn"], ctx, h, positions,
                                   cache=cache, cache_index=cache_index,
                                   use_rope=False, paged=paged)
        x = x + a
        h = apply_norm(cfg, params["ln_x"], x)
        kv = ({"k": cache["ck"], "v": cache["cv"]}
              if cache is not None and "ck" in cache
              else encode_cross_kv(params["cross"], cfg, enc_out))
        x = x + cross_attention_block(params["cross"], ctx, h, enc_kv=kv)
        h = apply_norm(cfg, params["ln2"], x)
        return x + mlp_block(params["mlp"], ctx, h), None, cache
    if kind not in ("dense", "shared", "moe", "enc"):
        raise NotImplementedError(f"sub-layer kind {kind!r} is not ported")
    h = apply_norm(cfg, params["ln1"], x)
    a, cache = attention_block(params["attn"], ctx, h, positions,
                               causal=causal, cache=cache,
                               cache_index=cache_index, use_rope=use_rope,
                               prefix_attend=prefix_attend, paged=paged)
    if kind == "moe":
        x = x + a
        m, aux = moe_mod.moe_block(params["moe"], ctx,
                                   apply_norm(cfg, params["ln2"], x))
        return x + m, aux, cache
    if cfg.parallel_block and kind != "enc":
        return x + a + mlp_block(params["mlp"], ctx, h), None, cache  # cohere
    x = x + a
    h = apply_norm(cfg, params["ln2"], x)
    return x + mlp_block(params["mlp"], ctx, h), None, cache


# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """Random parameters with the reference's shapes and init scales."""
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
               "attn": attn_init(gen, cfg, dtype, device, stack=stack)}
        if kind == "dec":
            sub["ln_x"] = stacked_norm(stack)
            sub["cross"] = attn_init(gen, cfg, dtype, device, stack=stack)
            sub["ln2"] = stacked_norm(stack)
            sub["mlp"] = mlp_init(gen, cfg, dtype, device, stack=stack)
            return sub
        if kind == "moe":
            sub["ln2"] = stacked_norm(stack)
            sub["moe"] = moe_mod.moe_init(gen, cfg, dtype, device,
                                          stack=stack)
            return sub
        sub["mlp"] = mlp_init(gen, cfg, dtype, device, stack=stack)
        if not cfg.parallel_block or kind == "enc":
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
    if cfg.frontend != "none":
        p["frontend"] = frontends.frontend_init(gen, cfg, dtype, device)
    if cfg.is_encoder_decoder:
        p["encoder"] = {"layers": sublayer("enc", stack=cfg.encoder_layers),
                        "final_norm": norm_init(cfg, D, device)}
    return p


def embed_tokens(params: Params, ctx: ModelContext, tokens: torch.Tensor,
                 patches: Optional[torch.Tensor] = None, offset: int = 0
                 ) -> torch.Tensor:
    """Token embeddings; a VLM's first positions carry ``patches``; an
    encoder-decoder adds sinusoidal positions from ``offset`` (a decode
    step's cache index)."""
    cfg = ctx.cfg
    x = params["embed"][tokens]
    if cfg.frontend == "vision_stub" and patches is not None:
        x = frontends.merge_patches(params["frontend"], cfg, x, patches)
    if cfg.is_encoder_decoder:
        x = x + sinusoidal_pos(x.shape[1], cfg.d_model, x.device,
                               offset).to(x.dtype)[None]
    return x


def unembed(params: Params, ctx: ModelContext, h: torch.Tensor
            ) -> torch.Tensor:
    table = params["embed"] if ctx.cfg.tie_embeddings else params["unembed"]
    return h @ table.T


def _train_sublayer(ctx: ModelContext, kind: str, params: dict,
                    x: torch.Tensor, positions: torch.Tensor,
                    enc_out: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sub-layer of the training stack -> (x_out, aux loss)."""
    y, aux, _ = run_sublayer(kind, params, ctx, x, positions,
                             enc_out=enc_out)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, aux


def _enc_layer(ctx: ModelContext, params: dict, x: torch.Tensor
               ) -> torch.Tensor:
    """One whisper encoder layer: bidirectional, no RoPE."""
    y, _, _ = run_sublayer("enc", params, ctx, x, None, causal=False,
                           use_rope=False)
    return y


def _layer_views(stacked: Params):
    """A function of the layer index giving that layer's parameter tree
    out of the stacked ``stacked``: one unbind per stacked leaf, so
    backward stacks the per-layer gradients once, instead of a full-size
    zero tensor per layer and leaf."""
    leaves, paths = tree.flatten(stacked)
    unbound = [t.unbind(0) for t in leaves]
    return lambda layer: tree.unflatten(paths, [u[layer] for u in unbound])


def encode(params: Params, ctx: ModelContext, frames: torch.Tensor
           ) -> torch.Tensor:
    """The projected frames through every encoder layer: in training each
    layer wrapped by the memory runtime under ``enc_layer`` (the
    reference's ``encode``), in serving bare (its ``encode_infer``:
    ``ctx.wrap`` returns the layer itself outside training)."""
    cfg = ctx.cfg
    enc = params["encoder"]
    x = frontends.embed_frames(params["frontend"], cfg, frames)
    wrapped = ctx.wrap("enc_layer", functools.partial(_enc_layer, ctx))
    layer = _layer_views(enc["layers"])
    for i in range(cfg.encoder_layers):
        x = wrapped(layer(i), x)
    return apply_norm(cfg, enc["final_norm"], x)


def forward_train(params: Params, ctx: ModelContext, tokens: torch.Tensor,
                  positions: torch.Tensor,
                  frames: Optional[torch.Tensor] = None,
                  patches: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (hidden (B, S, D), aux_loss).

    Every sub-layer runs wrapped by the memory runtime (``ctx.wrap``:
    input stashed to the tier, layer recomputed in backward; the bare
    layer when the tier does not offload), the hybrid's shared block at
    each of its sites too: every site takes the one unstacked
    ``params["shared"]``, so autograd sums the sites' gradients of those
    leaves, as ``jax.grad`` sums over the reference's closed-over
    ``params["shared"]``.  The reference's split into a stashed and an
    unstashed scan serves the ``auto`` planner, which ports with slice 5.

    An encoder-decoder first encodes ``frames`` (each encoder layer
    wrapped too) and hands the encoder's states to every decoder layer as
    float aux: the runtime stashes them uncompressed beside the layer's
    input and returns their gradient, which autograd sums over the
    layers into the encoder.  A VLM's ``patches`` fill the first
    positions of the embedded sequence."""
    cfg = ctx.cfg
    group, n_groups = arch_group(cfg)
    extra = ()
    if cfg.is_encoder_decoder:
        extra = (encode(params, ctx, frames),)
    x = embed_tokens(params, ctx, tokens, patches)

    def bare(kind):
        return functools.partial(_train_sublayer, ctx, kind)

    wrapped = {k: ctx.wrap(f"{k}_layer", bare(k)) for k in set(group)}
    views = {j: _layer_views(params["groups"][f"sub_{j}"])
             for j, kind in enumerate(group) if kind != "shared"}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_groups):
        for j, kind in enumerate(group):
            p = params["shared"] if kind == "shared" else views[j](layer)
            x, a = wrapped[kind](p, x, positions, *extra)
            aux = aux + a
    return apply_norm(cfg, params["final_norm"], x), aux


def forward_serve(params: Params, ctx: ModelContext, tokens: torch.Tensor,
                  positions: torch.Tensor, caches: Params, cache_index: int,
                  prefix_attend: bool = False,
                  paged: Optional[dict] = None,
                  frames: Optional[torch.Tensor] = None,
                  patches: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Params]:
    """Prefill (S > 1) / decode (S == 1) against stacked caches.

    ``caches``: ``{"sub_j": {leaf: (n_groups, ...)}}``; layer ``l`` works
    on the views ``leaf[l]`` and writes them in place.  With ``paged`` the
    leaves are the page pool (see ``attention_block``).
    ``prefix_attend`` runs a prefix-sharing suffix prefill: the S > 1
    tokens are the prompt's tail, written at ``cache_index`` and attending
    over the cache rows below it too.  Returns the final hidden state and
    ``caches``.

    An encoder-decoder encodes ``frames`` when given; a decode step's
    sinusoidal position is ``cache_index``.  Its ``"dec"`` layers
    cross-attend over the cache's ``ck`` / ``cv`` when the cache has them
    (every cache ``init_caches`` builds does), as the reference's do, so
    there the encoder's states go unread.  A VLM's ``patches`` fill the
    first positions."""
    cfg = ctx.cfg
    group, n_groups = arch_group(cfg)
    enc_out = None
    if cfg.is_encoder_decoder and frames is not None:
        enc_out = encode(params, ctx, frames)
    x = embed_tokens(params, ctx, tokens, patches,
                     offset=cache_index if tokens.shape[1] == 1 else 0)
    for layer in range(n_groups):
        for j, kind in enumerate(group):
            p = (params["shared"] if kind == "shared" else
                 tree.map(lambda t: t[layer], params["groups"][f"sub_{j}"]))
            c = caches.get(f"sub_{j}")
            c = {k: v[layer] for k, v in c.items()} if c is not None else None
            x, _, _ = run_sublayer(kind, p, ctx, x, positions, cache=c,
                                   cache_index=cache_index,
                                   prefix_attend=prefix_attend, paged=paged,
                                   enc_out=enc_out)
    return apply_norm(cfg, params["final_norm"], x), caches


# ---------------------------------------------------------------------------
# caches
def init_caches(cfg: ModelConfig, batch: int, seq: int, dtype, device
                ) -> Params:
    """Stacked caches matching forward_serve: (n_groups, B, S, K, hd) k/v
    for a dense group and for the hybrid's shared block (one row of the
    stack per site), (n_groups, B, W-1, conv_dim) conv and (n_groups, B,
    H, P, N) ssm state for an SSM group, and beside a ``"dec"`` group's
    k/v its cross-attention ``ck`` / ``cv`` (n_groups, B,
    frontend_tokens, K, hd), zeros."""
    group, n_groups = arch_group(cfg)

    def one(kind):
        if kind == "ssm":
            return ssm_mod.init_ssm_cache(cfg, batch, dtype, device)
        c = init_kv_cache(cfg, batch, seq, dtype, device)
        if kind == "dec":
            c.update(cross_cache(cfg, batch, dtype, device))
        return c

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
def cross_cache(cfg: ModelConfig, batch: int, dtype, device) -> Params:
    """A ``"dec"`` layer's zeroed cross-attention cache: ``ck`` / ``cv``
    (batch, frontend_tokens, K, hd)."""
    shape = (batch, cfg.frontend_tokens, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k in CROSS_KEYS}


# ---------------------------------------------------------------------------
# paged KV: the contiguous per-slot sequence axis becomes a pool of
# fixed-size pages — the paper's unit of pool placement applied to serving.
# Self-attention k/v leaves are paged; SSM state and cross-attention caches
# have no growing sequence axis and stay slot-shaped (one row per decode
# slot, parked whole on preemption).
PAGED_KEYS = ("k", "v")
#: the cross-attention cache of a ``"dec"`` group: written by no serving
#: path (see ``forward_serve``), so a decode step never changes it
CROSS_KEYS = ("ck", "cv")


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
    ``slot_tree`` ((n_groups, batch, ...), as :func:`init_caches`), and
    so does a ``"dec"`` group's cross-attention ``ck`` / ``cv``.
    Raises ``ValueError`` for an architecture with no k/v cache (pure SSM
    state is O(1) a session and gains nothing from paging)."""
    group, n_groups = arch_group(cfg)
    shape = (n_groups, num_pages + 1, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)

    def stacked(leaves):
        return {k: v[None].repeat(n_groups, *([1] * v.ndim))
                for k, v in leaves.items()}

    pool, slot_tree = {}, {}
    for j, kind in enumerate(group):
        if kind == "ssm":
            slot_tree[f"sub_{j}"] = stacked(
                ssm_mod.init_ssm_cache(cfg, batch, dtype, device))
            continue
        pool[f"sub_{j}"] = {k: torch.zeros(shape, dtype=dtype,
                                           device=device)
                            for k in PAGED_KEYS}
        if kind == "dec":
            slot_tree[f"sub_{j}"] = stacked(
                cross_cache(cfg, batch, dtype, device))
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
