"""Dispatch of the model's kernels between their implementations.

Registry flags (not bools) so backends stay pluggable: the serving stack
routes through :func:`paged_attention`, training attention through
:func:`flash_attention` and the Mamba2 blocks through :func:`ssd`, and the
active implementation is swapped without touching the call sites.
:func:`gemm` is the output-stationary product's entry point (the
reference's ``kernels/ops.gemm``), on no model path.

* ``"cuda"``  — the hand-written kernel (``kernels/paged_attention.py``,
  ``kernels/flash_attention.py``, ``kernels/ssd_scan.py``,
  ``kernels/gemm_os.py``); a CPU tensor takes the kernel's plain version
  there, a CUDA tensor the kernel.
* ``"torch"`` — the plain version on any device (the yardstick the kernel
  is held against on the card).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gemm_os as gos
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as kref
from repro_torch.kernels import ssd_scan as ss

GEMM_IMPLS = ("cuda", "torch")
_GEMM_IMPL = {"default": "cuda"}


def set_gemm_impl(name: str) -> None:
    """Select the GEMM ('cuda' output-stationary kernel / 'torch' plain)."""
    if name not in GEMM_IMPLS:
        raise ValueError(f"unknown GEMM impl {name!r}; "
                         f"registered: {GEMM_IMPLS}")
    _GEMM_IMPL["default"] = name


def gemm(x: torch.Tensor, w: torch.Tensor, **kw) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N), float32 accumulation, in x's
    dtype.  ``bm``/``bn``/``bk`` go to the kernel (``kernels/gemm_os.
    gemm_os``); the plain version has no blocks and takes none."""
    if _GEMM_IMPL["default"] == "torch":
        if kw:
            raise ValueError(f"the plain GEMM takes no blocks: {kw}")
        return kref.gemm_ref(x, w)
    return gos.gemm_os(x, w, **kw)


# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
FLASH_IMPLS = ("cuda", "torch")
_FLASH_IMPL = {"default": "cuda"}


def set_flash_impl(name: str) -> None:
    """Select the flash-attention forward ('cuda' kernel / 'torch' plain)."""
    if name not in FLASH_IMPLS:
        raise ValueError(f"unknown flash-attention impl {name!r}; "
                         f"registered: {FLASH_IMPLS}")
    _FLASH_IMPL["default"] = name


class _FlashAttention(torch.autograd.Function):
    """Kernel forward, backward recomputed through the blockwise twin.

    The reference pairs its Pallas forward with a backward that recomputes
    through XLA's ``blockwise_attention`` (``kernels/ops.py:92-119``): the
    backward runs outside any Pallas kernel there, so here it is plain
    PyTorch autograd through ``models/attention.blockwise_attention`` by
    design.  It holds a (B, K, G, S_chunk, T) f32 score tensor per query
    chunk while it runs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        fwd = (kref.flash_attention_ref if _FLASH_IMPL["default"] == "torch"
               else fa.flash_attention_fwd)
        return fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_(need) for t, need in
                       zip((q, k, v), ctx.needs_input_grad[:3]))
            o = kref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                         window=ctx.window)
            wanted = [t for t in (q, k, v) if t.requires_grad]
            got = iter(torch.autograd.grad(o, wanted, g))
        return tuple(next(got) if t.requires_grad else None
                     for t in (q, k, v)) + (None, None)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, H, S, d); k/v: (B, Hkv, T, d) -> (B, H, S, d).  The active
    forward (kernel or plain); backward recomputes through the blockwise
    twin (the same math)."""
    return _FlashAttention.apply(q, k, v, causal, window)


# ---------------------------------------------------------------------------
SSD_IMPLS = ("cuda", "torch")
_SSD_IMPL = {"default": "cuda"}


def set_ssd_impl(name: str) -> None:
    """Select the SSD chunked scan ('cuda' kernel / 'torch' plain)."""
    if name not in SSD_IMPLS:
        raise ValueError(f"unknown SSD scan impl {name!r}; "
                         f"registered: {SSD_IMPLS}")
    _SSD_IMPL["default"] = name


class _SSDScan(torch.autograd.Function):
    """Kernel forward, backward recomputed through the plain version.

    The reference's model runs the scan as plain XLA (``ssd_chunked``) and
    its Pallas scan has no backward, so the gradient here is plain
    PyTorch autograd through ``models/ssm.ssd_chunked`` by design."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk: int):
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        scan = (kref.ssd_chunked_ref if _SSD_IMPL["default"] == "torch"
                else ss.ssd_scan)
        return scan(x, dt, A, B, C, chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, gy, gfin):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [None if t is None else
                      t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad)]
            y, fin = kref.ssd_chunked_ref(*inputs[:5], ctx.chunk,
                                          init_state=inputs[5])
            wanted = [t for t in inputs if t is not None and t.requires_grad]
            outs, grads = [y], [gy]
            if gfin is not None:
                outs.append(fin)
                grads.append(gfin)
            got = iter(torch.autograd.grad(outs, wanted, grads,
                                           allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad
                     else None for t in inputs) + (None,)


def ssd(x, dt, A, B, C, chunk: int, init_state=None):
    """The SSD chunked scan of ``models/ssm.ssd_chunked`` on the active
    implementation: (y (b, S, H, P) float32, final state (b, H, P, N)).
    Views are made contiguous for the kernel; backward recomputes through
    the plain version."""
    x, B, C, dt = (t.contiguous() for t in (x, B, C, dt))
    if init_state is not None:
        init_state = init_state.contiguous()
    return _SSDScan.apply(x, dt, A, B, C, init_state, chunk)
