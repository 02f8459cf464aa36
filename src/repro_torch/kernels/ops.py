"""Dispatch of the paged-attention decode between its implementations.

A registry flag (not a bool) so backends stay pluggable: the serving stack
routes through :func:`paged_attention`, and the active implementation is
swapped without touching the call sites.

* ``"cuda"``  — the hand-written kernel (``kernels/paged_attention.py``);
  a CPU tensor takes the kernel's plain version there, a CUDA tensor the
  kernel.
* ``"torch"`` — the plain version on any device (the yardstick the kernel
  is held against on the card).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref

PAGED_IMPLS = ("cuda", "torch")
_PAGED_IMPL = {"default": "cuda"}


def set_paged_impl(name: str) -> None:
    """Select the paged-attention backend ('cuda' kernel / 'torch' plain)."""
    if name not in PAGED_IMPLS:
        raise ValueError(f"unknown paged-attention impl {name!r}; "
                         f"registered: {PAGED_IMPLS}")
    _PAGED_IMPL["default"] = name


def paged_attention(q, k_pool, v_pool, page_map, cache_index, *,
                    window: int = 0, softcap: float = 0.0,
                    kq_pool=None, vq_pool=None, k_scale=None, v_scale=None,
                    impl: Optional[str] = None):
    """q: (B, 1, H, d) over a (P, page, K, d) pool via a (B, pp) page map.

    Ids >= P address the compressed side pool (decoded in the K/V load).
    Semantics match ``models/attention.decode_attention`` on the gathered
    view — the plain version IS that path."""
    name = impl or _PAGED_IMPL["default"]
    if name == "cuda":
        fn = pa.paged_decode_attention
    elif name == "torch":
        fn = kref.paged_decode_attention_ref
    else:
        raise ValueError(f"unknown paged-attention impl {name!r}")
    return fn(q, k_pool, v_pool, page_map, cache_index, window=window,
              softcap=softcap, kq_pool=kq_pool, vq_pool=vq_pool,
              k_scale=k_scale, v_scale=v_scale)
