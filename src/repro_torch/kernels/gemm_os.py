"""Output-stationary GEMM: (M, K) @ (K, N) with a float32 accumulator.

Wrapper of ``csrc/gemm_os.cu``, the CUDA twin of the reference's Pallas
``gemm_os`` (``kernels/gemm_os.py``): one thread block owns one (bm x bn)
output tile whose float32 accumulator stays in registers while K streams
through shared memory in bk-deep slabs; the output is cast to the input
type and written once.  bfloat16 runs on the tensor cores (``wgmma`` fed
by TMA through a ring of stages); float32 runs FMAs on the CUDA cores (no
TF32, which keeps about 3 decimal digits).  A tensor on the CPU takes the
plain version (``kernels/ref.gemm_ref``); a CUDA tensor launches the kernel
or raises.  Launches are counted in ``.launches``.

The reference's contract stands: blocks the caller names are used as
named, dims they do not divide raise.  What differs is the set of blocks:
the TPU kernel sizes them for 12 MiB of VMEM, Hopper gives a block at
most 227 KB of shared memory and 64K registers a SM, so each path has its
own tiles, ``pick_blocks`` is re-derived here, and a tile the path does
not instantiate raises instead of being swapped for another (a bfloat16
call never falls back to the CUDA-core path).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
SMEM_PER_BLOCK = 232448       # dynamic shared memory a block may use

#: float32, CUDA cores: (bm, bn) output tiles of bm/8 x bn/8 threads of
#: 8 x 8 float32 accumulators.  256 x 256 (256 KB of accumulators) cannot
#: stay resident in a SM's 256 KB register file.
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
BK_ALIGN = 16                 # slab depth: whole 16-byte copies of a row
PAD_BYTES = 16                # row padding of each shared slab
#: pick_blocks keeps the double-buffered slabs of a block within half a
#: SM's shared memory, so two blocks share a SM and one's copies overlap
#: the other's products
PICK_BUDGET = SMEM_PER_BLOCK // 2

#: bfloat16, tensor cores: bm/64 consumer warpgroups, each a 64 x bn slice
#: of the tile (bn/2 float32 accumulators a thread, at most 128)
TC_TILES = ((128, 256), (128, 128), (128, 64), (64, 256), (64, 128), (64, 64))
TC_BOX = 64                   # bk granule: one swizzled 128-byte row of x
TC_MAX_STAGES = 8
TC_RESERVED = 2048            # barriers and alignment slack


def slab_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory of one (bm x bk) x slab and one (bk x bn) w slab
    (the float32 path: rows padded by 16 bytes)."""
    pad = PAD_BYTES // itemsize
    return (bm * (bk + pad) + bk * (bn + pad)) * itemsize


def tc_stage_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of one stage of the bfloat16 ring: bk/64 sub-slabs of
    one (bm x 64) x box and bn/64 (64 x 64) w boxes, unpadded (swizzled)."""
    return (bk // TC_BOX) * (bm + bn) * TC_BOX * 2


def stages_for(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Slabs in flight.  float32: 2 (double-buffered) when two fit a
    block's shared memory, 1 when only one does, 0 when not even one does.
    bfloat16: as many stages as fit, at most ``TC_MAX_STAGES``."""
    if itemsize == 2:
        free = SMEM_PER_BLOCK - TC_RESERVED
        return min(TC_MAX_STAGES, free // tc_stage_bytes(bm, bn, bk))
    one = slab_bytes(bm, bn, bk, itemsize)
    return 2 if 2 * one <= SMEM_PER_BLOCK else int(one <= SMEM_PER_BLOCK)


def supported(bm: int, bn: int, bk: int, itemsize: int) -> bool:
    """Whether the path of ``itemsize`` (2: bfloat16 on the tensor cores,
    4: float32 on the CUDA cores) instantiates the (bm, bn, bk) tile."""
    if itemsize == 2:
        return ((bm, bn) in TC_TILES and bk > 0 and bk % TC_BOX == 0
                and stages_for(bm, bn, bk, 2) > 0)
    return (itemsize == 4 and (bm, bn) in TILES and bk > 0
            and bk % BK_ALIGN == 0 and stages_for(bm, bn, bk, itemsize) > 0)


def _tiles_text(itemsize: int) -> str:
    if itemsize == 2:
        return (f"(bm, bn) in {list(TC_TILES)}, bk a multiple of {TC_BOX} "
                f"with one stage within {SMEM_PER_BLOCK - TC_RESERVED} "
                f"bytes of shared memory (bfloat16, tensor cores: bk <= "
                f"{max_bk(128, 256, 2)} at 128 x 256)")
    return (f"(bm, bn) in {list(TILES)}, bk a multiple of {BK_ALIGN} whose "
            f"slabs fit {SMEM_PER_BLOCK} bytes of shared memory "
            f"(float32, CUDA cores: bk <= {max_bk(128, 128, 4)} at "
            "128 x 128)")


def max_bk(bm: int, bn: int, itemsize: int) -> int:
    step = TC_BOX if itemsize == 2 else BK_ALIGN
    bk = step
    while stages_for(bm, bn, bk + step, itemsize):
        bk += step
    return bk


def pick_blocks(M: int, K: int, N: int, itemsize: int = 2
                ) -> Tuple[int, int, int]:
    """The largest tile the path instantiates that divides the dims.
    bfloat16: bm 128 or 64, bn 256, 128 or 64, bk 64 (depth comes from the
    ring's stages, not from deeper slabs).  float32: bm and bn 128 where
    they divide M and N, else 64; bk the deepest power of two from 256
    down to 16 that divides K with its double-buffered slabs within
    ``PICK_BUDGET``.  Raises ``ValueError`` when no such tile divides the
    dims."""
    def first(dim, cands):
        return next((c for c in cands if dim % c == 0), None)

    bm = first(M, (128, 64))
    if itemsize == 2:
        bn, bk = first(N, (256, 128, 64)), first(K, (TC_BOX,))
    else:
        bn, bk = first(N, (128, 64)), None
        if bm and bn:
            bk = first(K, [c for c in (256, 128, 64, 32, 16)
                           if 2 * slab_bytes(bm, bn, c, itemsize)
                           <= PICK_BUDGET])
    if not (bm and bn and bk):
        raise ValueError(f"gemm_os: no tile the kernel instantiates divides "
                         f"(M, K, N) = ({M}, {K}, {N}); it takes "
                         f"{_tiles_text(itemsize)}")
    return bm, bn, bk


def gemm_os(x: torch.Tensor, w: torch.Tensor, *, bm: int = 0, bn: int = 0,
            bk: int = 0) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype, float32 accumulation.

    Blocks are taken as named when all three are given, else from
    :func:`pick_blocks`.  ``ValueError`` when they do not divide the dims
    or name a tile the kernel does not instantiate (on any device: the
    contract does not depend on where the tensors lie).  On the card x and
    w share one dtype (bfloat16: tensor cores; float32: CUDA cores), are
    contiguous and start on 16 bytes."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gemm_os: x {tuple(x.shape)} @ w {tuple(w.shape)} "
                         "is not an (M, K) @ (K, N) product")
    (M, K), N = x.shape, w.shape[1]
    if min(M, K, N) <= 0:
        raise ValueError(f"gemm_os: empty product ({M}, {K}) @ ({K}, {N})")
    itemsize = x.element_size()
    if not (bm and bn and bk):
        bm, bn, bk = pick_blocks(M, K, N, itemsize)
    if M % bm or N % bn or K % bk:
        raise ValueError(f"gemm_os: blocks ({bm}, {bn}, {bk}) do not divide "
                         f"(M, N, K) = ({M}, {N}, {K})")
    if not supported(bm, bn, bk, itemsize):
        raise ValueError(f"gemm_os: the kernel has no ({bm}, {bn}, {bk}) "
                         f"tile; it takes {_tiles_text(itemsize)}")
    if not x.is_cuda:
        return ref.gemm_ref(x, w)
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise TypeError(f"gemm_os: x {x.dtype}, w {w.dtype}; the kernel "
                        f"takes one of {list(_DTYPE_CODE)} for both")
    if not w.is_cuda or w.device != x.device:
        raise ValueError(f"gemm_os: w on {w.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gemm_os: x and w must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gemm_os: x and w must start on 16 bytes (the "
                         "kernel copies 16 bytes at a time)")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = build.function("gemm_os", "gemm_os", _ARGS)
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            M, N, K, bm, bn, bk, stages_for(bm, bn, bk, itemsize),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm_os: CUDA kernel launch failed (error {rc})")
    gemm_os.launches += 1
    return out


gemm_os.launches = 0
