"""Attention: dense GQA/MHA/SWA for training and serving.

* :func:`blockwise_attention` — prefill: query chunks, each over its static
  causal / sliding-window KV span, plain torch.  Training attention runs
  the flash kernel instead (``kernels/ops.flash_attention``), whose plain
  twin and backward are this function.
* :func:`decode_attention` — single-token decode against a KV cache.
* :func:`attention_block` — projections + RoPE + attend + output
  projection, with the serving cache branches: prefill writes the prompt's
  rows, decode writes one row, and the paged branch writes the step's row
  straight into its page frame and attends over the page pool through the
  paged-attention kernel (``kernels/ops.paged_attention``).

Cache writes are in place: the cache tensors handed in are the storage
(where the reference returns updated arrays from donated buffers).  Masks
use a finite ``-1e30`` so a fully-masked row stays finite.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ModelContext, apply_rope, dense_init

Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30
Q_CHUNK = 1024


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
              stack: int) -> dict:
    H, K, hd, D = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    p = {"wq": dense_init(gen, D, H * hd, dtype, device, stack=stack),
         "wk": dense_init(gen, D, K * hd, dtype, device, stack=stack),
         "wv": dense_init(gen, D, K * hd, dtype, device, stack=stack),
         "wo": dense_init(gen, H * hd, D, dtype, device, stack=stack)}
    if cfg.use_qkv_bias:
        for name, width in (("bq", H * hd), ("bk", K * hd), ("bv", K * hd)):
            p[name] = torch.zeros((stack, width), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, q_chunk: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, K, hd) with H = K*G (GQA).

    Each query chunk attends only to its static KV span, so a long prompt
    never materialises S x T scores."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qq = q.reshape(B, S, K, G, hd)
    q_chunk = min(q_chunk or Q_CHUNK, S)
    outs = []
    for q0 in range(0, S, q_chunk):
        q1 = min(q0 + q_chunk, S)
        end = min(T, q1) if causal else T
        start = max(0, q0 - window) if causal and window > 0 else 0
        s = torch.einsum("bqkgd,btkd->bkgqt", qq[:, q0:q1].float(),
                         k[:, start:end].float()) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(start, end, device=q.device)[None, :]
        mask = torch.ones((q1 - q0, end - start), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_pos >= k_pos
            if window > 0:
                mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, NEG_INF)
        # unnormalised p cast to the value dtype, then one division: the
        # reference's online-softmax arithmetic over a single kv chunk
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1).clamp(min=1e-30)
        o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype).float(),
                         v[:, start:end].float()) / l[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_index: int, *,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention over a KV cache.

    q: (B, 1, H, hd); caches: (B, S, K, hd); cache_index: number of valid
    cache positions before this token (it attends to [0, cache_index]).
    A row with nothing visible (cache_index < 0) stays finite."""
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qq = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgd,btkd->bkgt", qq.float(), k_cache.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    mask = pos <= cache_index
    if window > 0:
        mask &= pos > cache_index - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
def attention_block(params: dict, ctx: ModelContext, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    cache: Optional[Cache] = None,
                    cache_index: Optional[int] = None,
                    paged: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Full attention sub-block; returns ``(out, cache)`` (cache mutated in
    place).

    ``paged``: in-place paged decode — the cache leaves ARE the layer's page
    pool (P, page, K, hd) plus the int8 side pool (``kq``/``vq``/``ks``/
    ``vs``), and ``paged`` carries ``page_map`` (B, pp), ``write_pid`` (B,)
    and ``row_off``: the step's K/V row lands in frame ``write_pid`` at row
    ``row_off`` (masked slots are routed to the scratch frame)."""
    cfg = ctx.cfg
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, D = x.shape
    window = cfg.window if cfg.attention == "swa" else 0

    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and paged is not None:
        assert S == 1, "paged decode is single-token"
        from repro_torch.kernels import ops as kops
        kc, vc = cache["k"], cache["v"]
        wp, row = paged["write_pid"], paged["row_off"]
        kc[wp, row] = k[:, 0].to(kc.dtype)
        vc[wp, row] = v[:, 0].to(vc.dtype)
        o = kops.paged_attention(
            q, kc, vc, paged["page_map"], cache_index, window=window,
            softcap=cfg.logit_softcap, kq_pool=cache.get("kq"),
            vq_pool=cache.get("vq"), k_scale=cache.get("ks"),
            v_scale=cache.get("vs"))
    elif cache is not None:
        # decode (S == 1) writes row cache_index; prefill the prompt at 0
        kc, vc = cache["k"], cache["v"]
        idx = cache_index if (cache_index is not None and S == 1) else 0
        kc[:, idx:idx + S] = k.to(kc.dtype)
        vc[:, idx:idx + S] = v.to(vc.dtype)
        if S == 1:
            o = decode_attention(q, kc, vc, cache_index, window=window,
                                 softcap=cfg.logit_softcap)
        else:
            o = blockwise_attention(q, k, v, causal=causal, window=window,
                                    softcap=cfg.logit_softcap)
    elif cfg.logit_softcap > 0:
        raise NotImplementedError(
            "training attention runs the flash kernel, which has no "
            "softcap (nor has the reference's); no configuration sets one")
    else:
        # training: the flash forward on (B, H, S, d) views of the
        # projections (no transpose copy), backward through the blockwise
        # twin
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal,
                                 window).transpose(1, 2)

    out = o.reshape(B, S, H * hd) @ params["wo"]
    return out, cache


def init_kv_cache(cfg: ModelConfig, batch: int, seq: int, dtype, device
                  ) -> Cache:
    K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, seq, K, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, seq, K, hd), dtype=dtype, device=device)}
