"""Stash / spill codec kernels: blockwise fp8, int8 and blocksparse packs
and the shared unpack.

Wrappers of ``csrc/offload_pack.cu`` (the CUDA twins of the Pallas
``fp8_pack`` / ``int8_pack`` / ``blocksparse_pack`` / ``fp8_unpack`` in the
reference's ``kernels/offload_pack.py``).  A tensor on the CPU takes the
plain version in ``kernels/ref.py``; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in ``.launches``; the unpack is
one kernel for every payload type (``int8_unpack`` and
``blocksparse_unpack`` are ``fp8_unpack``, as in the reference), so its
count covers every codec's fetch.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOAD_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_I64, _PTR, _INT = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_PACK_ARGS = (_INT, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR)
_UNPACK_ARGS = (_INT, _INT, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")


def _dtype_code(dtype: torch.dtype, name: str) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {dtype} "
                        f"(kernel takes {list(_DTYPE_CODE)})")
    return _DTYPE_CODE[dtype]


def _pack(wrapper: Callable, payload: torch.dtype, plain: Callable,
          x: torch.Tensor, block_rows: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    name = wrapper.__name__
    R, C = x.shape
    if R % block_rows:
        raise ValueError(f"{name}: {R} rows are not a multiple of "
                         f"block_rows {block_rows}")
    if not x.is_cuda:
        return plain(x, block_rows)
    code = _dtype_code(x.dtype, name)
    x = x.contiguous()
    nb = R // block_rows
    q = torch.empty((R, C), dtype=payload, device=x.device)
    scales = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if x.numel():
        amax = torch.empty((nb,), dtype=torch.int32, device=x.device)
        fn = build.function("offload_pack", name, _PACK_ARGS)
        _check(fn(code, x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                  amax.data_ptr(), R, C, block_rows,
                  torch.cuda.current_stream(x.device).cuda_stream), name)
        wrapper.launches += 1
    return q, scales


def fp8_pack(x: torch.Tensor, *, block_rows: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: float8_e4m3fn (R, C), scales: f32
    (R // block_rows,))."""
    return _pack(fp8_pack, torch.float8_e4m3fn, ref.fp8_pack_ref, x,
                 block_rows)


def int8_pack(x: torch.Tensor, *, block_rows: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: int8 (R, C), scales: f32 (R // block_rows,))."""
    return _pack(int8_pack, torch.int8, ref.int8_pack_ref, x, block_rows)


def blocksparse_pack(x: torch.Tensor, *, block_rows: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: int8 (R, C) with |x| < absmax / 32 pruned to exact
    zeros, scales: f32 (R // block_rows,))."""
    return _pack(blocksparse_pack, torch.int8, ref.blocksparse_pack_ref, x,
                 block_rows)


def fp8_unpack(q: torch.Tensor, scales: torch.Tensor, *,
               block_rows: int = 128, dtype=torch.bfloat16) -> torch.Tensor:
    """q: int8 or float8_e4m3fn (R, C), scales: f32 (R // block_rows,) ->
    (q * scale) as dtype."""
    R, C = q.shape
    if R % block_rows or scales.numel() != R // block_rows:
        raise ValueError(f"fp8_unpack: {R} rows, block_rows {block_rows}, "
                         f"{scales.numel()} scales do not tile")
    if not q.is_cuda:
        return ref.fp8_unpack_ref(q, scales, block_rows, dtype)
    if q.dtype not in _PAYLOAD_CODE or scales.dtype != torch.float32 \
            or not scales.is_cuda:
        raise TypeError("fp8_unpack: needs an int8 or float8_e4m3fn q and "
                        f"f32 scales on the card (got {q.dtype}, "
                        f"{scales.dtype})")
    code = _dtype_code(dtype, "fp8_unpack")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((R, C), dtype=dtype, device=q.device)
    if q.numel():
        fn = build.function("offload_pack", "unpack", _UNPACK_ARGS)
        _check(fn(_PAYLOAD_CODE[q.dtype], code, q.data_ptr(),
                  scales.data_ptr(), out.data_ptr(), R, C, block_rows,
                  torch.cuda.current_stream(q.device).cuda_stream),
               "fp8_unpack")
        fp8_unpack.launches += 1
    return out


#: dequantize-by-scale has no payload-specific logic: the int8 and
#: blocksparse unpacks ARE the fp8 one (pruned zeros dequantise to zero)
int8_unpack = fp8_unpack
blocksparse_unpack = fp8_unpack

fp8_pack.launches = 0
int8_pack.launches = 0
blocksparse_pack.launches = 0
fp8_unpack.launches = 0
