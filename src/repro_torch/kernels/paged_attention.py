"""Paged-attention decode: one-token attention straight over the page pool.

Wrapper of ``csrc/paged_attention.cu``, the CUDA twin of the reference's
Pallas ``paged_decode_attention``: the block table is dereferenced inside
the kernel, pages a query cannot see (beyond ``cache_index`` or below the
sliding window) are skipped, and page ids ``>= P`` address an int8 side
pool dequantised in the K/V load.  The page map's columns are split over
thread blocks (:func:`split_plan`); the last block of a (session, kv
head) to finish merges the splits' partials.  A tensor on the CPU takes
the plain version (``kernels/ref.paged_decode_attention_ref``); a CUDA
tensor launches the kernel or raises.  Launches are counted in
``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, ctypes.c_float, _P)
MAX_GROUP_WIDTH = 1024            # G * hd accumulators per thread block
PAGE_SIZES = (4, 8, 16, 32)       # page rows the kernel takes
BLOCKS_PER_SM = 8                 # the split plan's aim
MIN_PAGES_PER_SPLIT = 4           # one page for each warp of a block


def split_plan(pp: int, B: int, K: int, G: int, hd: int, sm_count: int
               ) -> Tuple[int, int, Tuple[int]]:
    """``(splits, pages a split, scratch shape)`` for a page map of ``pp``
    columns over ``B`` sessions of ``K`` kv heads of ``G`` query heads of
    width ``hd``.  Split s holds columns ``[s * per, (s + 1) * per)``, so
    every column lies in exactly one split: enough splits for
    ``BLOCKS_PER_SM`` blocks a SM, at least ``MIN_PAGES_PER_SPLIT``
    columns each.  The float32 scratch holds, per (session, kv head,
    split) and query head, the running max and denominator (``2 * G``
    floats, first for all) and the ``hd`` accumulators.  The plan
    depends on the pool and batch and the card, never on
    ``cache_index``, so a decode step launches the same grid at every
    length."""
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * K))
    n = max(1, min(want, -(-pp // MIN_PAGES_PER_SPLIT)))
    per = max(1, -(-pp // n))
    n = max(1, -(-pp // per))
    return n, per, (B * K * n * G * (hd + 2),)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_COUNTERS = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """Per-device int32 counters of finished splits, one per (session, kv
    head): zeroed once, and left at 0 by every launch (the last split to
    finish resets its counter), so calls on one stream share them."""
    t = _COUNTERS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = t
    return t


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_map: torch.Tensor,
                           cache_index: int, *, window: int = 0,
                           softcap: float = 0.0,
                           kq_pool: Optional[torch.Tensor] = None,
                           vq_pool: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, 1, H, hd); pools: (P, page, K, hd) — ``P`` frames including
    the trailing scratch frame; page_map: (B, pages_per_slot) frame ids in
    logical page order (unowned entries -> scratch); cache_index: the new
    token attends to rows [0, cache_index].

    ``kq_pool``/``vq_pool`` (C, page, K, hd) int8 + ``k_scale``/``v_scale``
    (C, 1) f32: the compressed side pool; ids ``>= P`` address frame
    ``id - P`` there.  Semantics match ``models/attention.decode_attention``
    over the gathered view, except that a row with no visible position
    (``cache_index < 0``) comes out as zeros where the plain version
    averages the masked rows: both are finite, and the engine discards it.
    """
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, page_map, cache_index, window=window,
            softcap=softcap, kq_pool=kq_pool, vq_pool=vq_pool,
            k_scale=k_scale, v_scale=v_scale)
    B, one, H, hd = q.shape
    P, page, K, hd_k = k_pool.shape
    G = H // K
    pp = page_map.shape[1]
    if one != 1 or hd_k != hd or H % K or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: q {q.dtype}, pools "
                        f"{k_pool.dtype}/{v_pool.dtype}; the kernel takes one "
                        f"of {list(_DTYPE_CODE)} for all three")
    if G * hd > MAX_GROUP_WIDTH:
        raise ValueError(f"paged_decode_attention: G*hd={G * hd} exceeds "
                         f"{MAX_GROUP_WIDTH}")
    if page not in PAGE_SIZES or hd % 16:
        raise ValueError(f"paged_decode_attention: page {page} (one of "
                         f"{PAGE_SIZES}) and head_dim {hd} (a multiple of "
                         "16): not a shape the kernel takes")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("paged_decode_attention: pools must be contiguous "
                         "(the layer slice of a stacked pool is)")
    tensors = [q, k_pool, v_pool, page_map]
    C = 0
    if kq_pool is not None:
        C = kq_pool.shape[0]
        if kq_pool.dtype != torch.int8 or vq_pool.dtype != torch.int8 \
                or kq_pool.shape != (C, page, K, hd) \
                or vq_pool.shape != kq_pool.shape \
                or k_scale.numel() != C or v_scale.numel() != C:
            raise ValueError("paged_decode_attention: side pool must be "
                             f"int8 (C, {page}, {K}, {hd}) with C scales")
        kq_pool, vq_pool = kq_pool.contiguous(), vq_pool.contiguous()
        k_scale = k_scale.contiguous().float()
        v_scale = v_scale.contiguous().float()
        tensors += [kq_pool, vq_pool, k_scale, v_scale]
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("paged_decode_attention: every input must be on "
                         f"{q.device}")
    if any(t.data_ptr() % 16 for t in (k_pool, v_pool)
           + ((kq_pool, vq_pool) if C else ())):
        raise ValueError("paged_decode_attention: pools must start on 16 "
                         "bytes (the kernel copies 16 bytes at a time)")
    q = q.contiguous()
    pm = page_map.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if B == 0:
        return out
    dev = (q.device.index if q.device.index is not None
           else torch.cuda.current_device())
    n_split, per, scratch = split_plan(pp, B, K, G, hd, _sm_count(dev))
    part = torch.empty(scratch, dtype=torch.float32, device=q.device)
    counters = _counters(q.device, B * K)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = build.function("paged_attention", "paged_decode_attention", _ARGS)
    rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), ptr(kq_pool), ptr(vq_pool), ptr(k_scale),
            ptr(v_scale), pm.data_ptr(), out.data_ptr(), part.data_ptr(),
            counters.data_ptr(), B, K, G, hd, page, pp, P, C, n_split, per,
            int(cache_index), int(window), 1.0 / math.sqrt(hd),
            float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("paged_decode_attention: CUDA kernel launch "
                           f"failed (error {rc})")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
