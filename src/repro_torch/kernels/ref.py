"""Plain PyTorch versions of every ported kernel.

The CPU path of each kernel wrapper, the ground truth the CUDA kernels are
held against on the card, and the twins the parity tests hold against the
JAX reference's kernels.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
def gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype: the product in
    float32 (float32 inputs, float32 sums), cast back once, as the
    reference's ``kernels/ref.gemm_ref``."""
    return (x.float() @ w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
def inflate_pages_ref(pool: torch.Tensor, page_map: torch.Tensor,
                      qpool: Optional[torch.Tensor] = None,
                      scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gather the contiguous (B, pp*page, K, hd) view a page map describes.

    pool: (P, page, K, hd); page_map: (B, pp) int.  Ids ``>= P`` address
    frame ``id - P`` of the int8 side pool ``qpool`` (C, page, K, hd) with
    per-frame ``scales`` (C, 1), decoded as ``q*scale`` cast to the pool
    dtype.  Out-of-range ids clamp, as in the reference.
    """
    P, page, K, hd = pool.shape
    B, pp = page_map.shape
    flat = page_map.reshape(-1).long()
    out = pool[flat.clamp(0, P - 1)]
    if qpool is not None:
        C = qpool.shape[0]
        ci = (flat - P).clamp(0, C - 1)
        dec = (qpool[ci].float()
               * scales.reshape(-1)[ci][:, None, None, None]).to(pool.dtype)
        out = torch.where((flat >= P)[:, None, None, None], dec, out)
    return out.reshape(B, pp * page, K, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_map: torch.Tensor,
                               cache_index: int, *, window: int = 0,
                               softcap: float = 0.0,
                               kq_pool: Optional[torch.Tensor] = None,
                               vq_pool: Optional[torch.Tensor] = None,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain twin of the paged decode kernel: inflate+gather the page map,
    then the ``decode_attention`` math of the gather-then-attend path."""
    from repro_torch.models.attention import decode_attention
    k = inflate_pages_ref(k_pool, page_map, kq_pool, k_scale)
    v = inflate_pages_ref(v_pool, page_map, vq_pool, v_scale)
    return decode_attention(q, k, v, cache_index, window=window,
                            softcap=softcap)


# ---------------------------------------------------------------------------
def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """IEEE ``x / divisor``, as XLA and the CUDA kernels compute it.  On a
    CUDA tensor, PyTorch divides by a Python scalar as a multiplication by
    its rounded reciprocal, which can differ in the last bit; a tensor
    divisor keeps the true division."""
    return x / torch.full_like(x, divisor)


# codec constants, shared with core/compress.py (the reference keeps them in
# kernels/offload_pack.py and mirrors them in core/compress.py)
FP8_MAX = 448.0                 # float8_e4m3fn dynamic range
INT8_MAX = 127.0
BLOCKSPARSE_TAU = 32.0          # prune |x| < block_absmax / TAU to exact zero


def _blocks(x: torch.Tensor, block_rows: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, C) as f32 row blocks (nb, block_rows, C) and their absmax."""
    R, C = x.shape
    xb = x.reshape(R // block_rows, block_rows, C).float()
    return xb, xb.abs().amax(dim=(1, 2))


def fp8_pack_ref(x: torch.Tensor, block_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise fp8 quantize: x (R, C) -> (q fp8 (R, C), scales (R/br,))."""
    xb, absmax = _blocks(x, block_rows)
    scale = torch.clamp(true_div(absmax, FP8_MAX), min=1e-12)
    q = (xb / scale[:, None, None]).to(torch.float8_e4m3fn)
    return q.reshape(x.shape), scale


def int8_pack_ref(x: torch.Tensor, block_rows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantize: x (R, C) -> (q int8 (R, C), scales (R/br,))."""
    xb, absmax = _blocks(x, block_rows)
    scale = torch.clamp(true_div(absmax, INT8_MAX), min=1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None, None]), -INT8_MAX,
                    INT8_MAX)
    return q.to(torch.int8).reshape(x.shape), scale


def blocksparse_pack_ref(x: torch.Tensor, block_rows: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantize + in-block magnitude pruning: entries with
    |x| < block_absmax / BLOCKSPARSE_TAU become exact zeros."""
    xb, absmax = _blocks(x, block_rows)
    scale = torch.clamp(true_div(absmax, INT8_MAX), min=1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None, None]), -INT8_MAX,
                    INT8_MAX)
    keep = xb.abs() >= true_div(absmax, BLOCKSPARSE_TAU)[:, None, None]
    q = torch.where(keep, q, 0.0)
    return q.to(torch.int8).reshape(x.shape), scale


def fp8_unpack_ref(q: torch.Tensor, scale: torch.Tensor, block_rows: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """The shared unpack: (q * scale) cast to ``dtype``, for int8 and fp8
    payloads alike."""
    R, C = q.shape
    xb = q.reshape(R // block_rows, block_rows, C).float() \
        * scale[:, None, None]
    return xb.reshape(R, C).to(dtype)


int8_unpack_ref = fp8_unpack_ref


def int8_pack_leaves_ref(xs: Sequence[torch.Tensor]
                         ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The batched int8 pack, leaf by leaf: each leaf's flattened
    ``(-1, cols)`` view as one row block -> ``[(q shaped like x, 0-d
    scale)]``."""
    out = []
    for x in xs:
        x2 = x.reshape(-1, x.shape[-1])
        q, s = int8_pack_ref(x2, x2.shape[0])
        out.append((q.reshape(x.shape), s[0]))
    return out


def unpack_leaves_ref(qs: Sequence[torch.Tensor],
                      scales: Sequence[torch.Tensor],
                      outs: Sequence[torch.Tensor]) -> None:
    """The batched unpack, leaf by leaf: each payload as one row block,
    decoded in ``outs[i]``'s dtype and copied into it."""
    for q, s, o in zip(qs, scales, outs):
        q2 = q.reshape(-1, q.shape[-1])
        o.copy_(fp8_unpack_ref(q2, s.reshape(1), q2.shape[0], o.dtype)
                .reshape(o.shape))


# ---------------------------------------------------------------------------
def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """Plain twin of the flash forward: q (B, H, S, d), k/v (B, Hkv, T, d)
    -> (B, H, S, d), through ``models/attention.blockwise_attention`` in its
    (B, S, H, d) layout (the reference's ``kernels/ops._fa_ref``)."""
    from repro_torch.models.attention import blockwise_attention
    o = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


# ---------------------------------------------------------------------------
def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int,
                    init_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the SSD scan kernel: ``models/ssm.ssd_chunked`` (what
    the reference's model runs in place of its Pallas scan)."""
    from repro_torch.models.ssm import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk, init_state=init_state)


def ssd_ref(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-(batch, head) SSD recurrence oracle (the reference's
    ``kernels/ref.ssd_ref``).

    x: (S, P) inputs (already dt-scaled), a: (S,) log-decay per step,
    B / C: (S, N).  Returns (y (S, P) in x's dtype, final state (P, N)
    float32)."""
    S, P = x.shape
    state = torch.zeros((P, B.shape[1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(S):
        state = state * torch.exp(a[t].float()) \
            + torch.outer(x[t].float(), B[t].float())
        ys.append(state @ C[t].float())
    return torch.stack(ys).to(x.dtype), state
