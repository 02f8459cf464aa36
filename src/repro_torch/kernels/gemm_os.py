"""Output-stationary GEMM: (M, K) @ (K, N) with a float32 accumulator.

Wrapper of ``csrc/gemm_os.cu``, the CUDA twin of the reference's Pallas
``gemm_os`` (``kernels/gemm_os.py``): one thread block owns one (bm x bn)
output tile whose float32 accumulator stays in registers while K streams
through shared memory in bk-deep slabs; the output is cast to the input
type and written once.  A tensor on the CPU takes the plain version
(``kernels/ref.gemm_ref``); a CUDA tensor launches the kernel or raises.
Launches are counted in ``.launches``.

The reference's contract stands: blocks the caller names are used as
named, dims they do not divide raise.  What differs is the set of blocks:
the TPU kernel sizes them for 12 MiB of VMEM, Hopper gives a block at
most 227 KB of shared memory and 64K registers a SM, so ``pick_blocks``
is re-derived here and a tile the kernel does not instantiate raises
instead of being swapped for another.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)
#: (bm, bn) output tiles the kernel instantiates: bm/8 x bn/8 threads of
#: 8 x 8 float32 accumulators.  256 x 256 (256 KB of accumulators) cannot
#: stay resident in a SM's 256 KB register file.
TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
BK_ALIGN = 16                 # slab depth: whole 16-byte copies of a row
SMEM_PER_BLOCK = 232448       # dynamic shared memory a block may use
PAD_BYTES = 16                # row padding of each shared slab
#: pick_blocks keeps the double-buffered slabs of a block within half a
#: SM's shared memory, so two blocks share a SM and one's copies overlap
#: the other's products
PICK_BUDGET = SMEM_PER_BLOCK // 2


def slab_bytes(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Shared memory of one (bm x bk) x slab and one (bk x bn) w slab."""
    pad = PAD_BYTES // itemsize
    return (bm * (bk + pad) + bk * (bn + pad)) * itemsize


def stages_for(bm: int, bn: int, bk: int, itemsize: int) -> int:
    """Slabs in flight: 2 (double-buffered) when two fit a block's shared
    memory, 1 when only one does, 0 when not even one does."""
    one = slab_bytes(bm, bn, bk, itemsize)
    return 2 if 2 * one <= SMEM_PER_BLOCK else int(one <= SMEM_PER_BLOCK)


def supported(bm: int, bn: int, bk: int, itemsize: int) -> bool:
    """Whether the kernel instantiates the (bm, bn, bk) tile."""
    return ((bm, bn) in TILES and bk > 0 and bk % BK_ALIGN == 0
            and stages_for(bm, bn, bk, itemsize) > 0)


def _tiles_text(itemsize: int) -> str:
    return (f"(bm, bn) in {list(TILES)}, bk a multiple of {BK_ALIGN} whose "
            f"slabs fit {SMEM_PER_BLOCK} bytes of shared memory "
            f"({itemsize}-byte elements: bk <= "
            f"{max_bk(128, 128, itemsize)} at 128 x 128)")


def max_bk(bm: int, bn: int, itemsize: int) -> int:
    bk = BK_ALIGN
    while stages_for(bm, bn, bk + BK_ALIGN, itemsize):
        bk += BK_ALIGN
    return bk


def pick_blocks(M: int, K: int, N: int, itemsize: int = 2
                ) -> Tuple[int, int, int]:
    """The largest tile the kernel instantiates that divides the dims: bm
    and bn 128 where they divide M and N, else 64; bk the deepest power of
    two from 256 down to 16 that divides K with its double-buffered slabs
    within ``PICK_BUDGET``.  Raises ``ValueError`` when no such tile
    divides the dims."""
    def first(dim, cands):
        return next((c for c in cands if dim % c == 0), None)

    bm, bn = first(M, (128, 64)), first(N, (128, 64))
    bk = None
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
    w share one dtype (float32 or bfloat16), are contiguous and start on
    16 bytes."""
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
