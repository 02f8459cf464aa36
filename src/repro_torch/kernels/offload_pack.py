"""int8 spill codec kernels: blockwise pack and the shared unpack.

Wrappers of ``csrc/offload_pack.cu`` (the CUDA twins of the Pallas
``int8_pack`` / ``int8_unpack`` in the reference's
``kernels/offload_pack.py``).  A tensor on the CPU takes the plain version
in ``kernels/ref.py``; a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I64, _PTR = ctypes.c_longlong, ctypes.c_void_p
_ARGS = (ctypes.c_int, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")


def _dtype_code(dtype: torch.dtype, name: str) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {dtype} "
                        f"(kernel takes {list(_DTYPE_CODE)})")
    return _DTYPE_CODE[dtype]


def int8_pack(x: torch.Tensor, *, block_rows: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: int8 (R, C), scales: f32 (R // block_rows,))."""
    R, C = x.shape
    if R % block_rows:
        raise ValueError(f"int8_pack: {R} rows are not a multiple of "
                         f"block_rows {block_rows}")
    if not x.is_cuda:
        return ref.int8_pack_ref(x, block_rows)
    code = _dtype_code(x.dtype, "int8_pack")
    x = x.contiguous()
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scales = torch.empty((R // block_rows,), dtype=torch.float32,
                         device=x.device)
    if x.numel():
        fn = build.function("offload_pack", "int8_pack", _ARGS)
        _check(fn(code, x.data_ptr(), q.data_ptr(), scales.data_ptr(), R, C,
                  block_rows, torch.cuda.current_stream(x.device).cuda_stream),
               "int8_pack")
        int8_pack.launches += 1
    return q, scales


def int8_unpack(q: torch.Tensor, scales: torch.Tensor, *,
                block_rows: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """q: int8 (R, C), scales: f32 (R // block_rows,) -> (q*scale) as dtype."""
    R, C = q.shape
    if R % block_rows or scales.numel() != R // block_rows:
        raise ValueError(f"int8_unpack: {R} rows, block_rows {block_rows}, "
                         f"{scales.numel()} scales do not tile")
    if not q.is_cuda:
        return ref.int8_unpack_ref(q, scales, block_rows, dtype)
    if q.dtype != torch.int8 or scales.dtype != torch.float32 \
            or not scales.is_cuda:
        raise TypeError("int8_unpack: needs int8 q and f32 scales on the card")
    code = _dtype_code(dtype, "int8_unpack")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((R, C), dtype=dtype, device=q.device)
    if q.numel():
        fn = build.function("offload_pack", "int8_unpack", _ARGS)
        _check(fn(code, q.data_ptr(), scales.data_ptr(), out.data_ptr(), R, C,
                  block_rows, torch.cuda.current_stream(q.device).cuda_stream),
               "int8_unpack")
        int8_unpack.launches += 1
    return out


int8_pack.launches = 0
int8_unpack.launches = 0
