"""Flash attention forward: causal / sliding-window GQA, online softmax.

Wrapper of ``csrc/flash_attention.cu``, the CUDA twin of the reference's
Pallas ``flash_attention_fwd`` (``kernels/flash_attention.py``).  A tensor
on the CPU takes the plain version (``kernels/ref.flash_attention_ref``);
a CUDA tensor launches the kernel or raises.  Launches are counted in
``.launches``.  bfloat16 runs on the tensor cores (warp-level
``mma.sync``), float32 on the CUDA cores (no TF32, which keeps about 3
decimal digits).  The gradient pairing (forward here, backward recomputed
through the blockwise twin) is ``kernels/ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is compiled for (the configs' 32, 64, 80 and 128):
#: its tiles are fixed per head dim, a multiple of 16 up to 128
HEAD_DIMS = (32, 64, 80, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _P)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, Hkv, T, d) -> (B, H, S, d) in q's dtype.

    The inputs may be strided views (e.g. the model's (B, S, H, d)
    projections transposed); only the last dimension must be contiguous.
    On the card the output is a (B, H, S, d) view of (B, S, H, d) storage,
    so the model's ``transpose(1, 2).reshape(B, S, H*d)`` is free.  The
    kernel copies rows 16 bytes at a time: a base pointer or a batch, head
    or row stride that is not a multiple of 16 bytes raises."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    B, H, S, d = q.shape
    Bk, K, T, dk = k.shape
    if Bk != B or dk != d or v.shape != k.shape or H % K:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}; the kernel takes one of "
                        f"{list(_DTYPE_CODE)} for all three")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} not in "
                         f"{HEAD_DIMS}, the head dims the kernel is "
                         "compiled for (its tiles are fixed per head dim)")
    if any(not t.is_cuda or t.device != q.device for t in (k, v)):
        raise ValueError(f"flash_attention_fwd: every input must be on "
                         f"{q.device}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    e = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(st * e % 16 for st, n in zip(
                t.stride()[:3], t.shape[:3]) if n > 1):
            raise ValueError(f"flash_attention_fwd: {name} starts at "
                             f"{t.data_ptr() % 16} bytes past 16 or has "
                             f"strides {tuple(t.stride())}: every row must "
                             "start on 16 bytes")
    out = torch.empty((B, S, H, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if B == 0 or S == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGS)
    rc = fn(_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), ctypes.addressof(strides), B, H, K,
            S, T, int(causal), int(window), 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("flash_attention_fwd: CUDA kernel launch failed "
                           f"(error {rc})")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
