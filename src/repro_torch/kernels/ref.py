"""Plain PyTorch versions of every ported kernel.

The CPU path of each kernel wrapper, the ground truth the CUDA kernels are
held against on the card, and the twins the parity tests hold against the
JAX reference's kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def int8_pack_ref(x: torch.Tensor, block_rows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 quantize: x (R, C) -> (q int8 (R, C), scales (R/br,))."""
    R, C = x.shape
    nb = R // block_rows
    xb = x.reshape(nb, block_rows, C).float()
    absmax = xb.abs().amax(dim=(1, 2))
    scale = torch.clamp(true_div(absmax, 127.0), min=1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None, None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(R, C), scale


def int8_unpack_ref(q: torch.Tensor, scale: torch.Tensor, block_rows: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    R, C = q.shape
    nb = R // block_rows
    xb = q.reshape(nb, block_rows, C).float() * scale[:, None, None]
    return xb.reshape(R, C).to(dtype)
