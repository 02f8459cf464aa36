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

The int8 pack and the unpack also take the leaves of one spilled page in
one launch (:func:`int8_pack_leaves`, :func:`unpack_leaves`), read from or
written into their pool frames in place; those launches count on
``int8_pack.launches`` and ``fp8_unpack.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOAD_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_I64, _PTR, _INT = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
_PACK_ARGS = (_INT, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR)
_PACK_LEAVES_ARGS = (_INT, _INT, _PTR, _INT, _INT, _PTR, _PTR)
_UNPACK_LEAVES_ARGS = (_INT, _INT, _INT, _PTR, _PTR)

#: the kernels' constants (csrc/offload_pack.cu): elements a chunk (16
#: codes: one 16-byte store), leaves a launch; the int8 pack's threads a
#: cluster block and chunks each holds in registers, threads a two-pass
#: block and chunks each takes
VEC, MAX_LEAVES = 16, 16
CLUSTER_THREADS, REG_CHUNKS = 512, 4
PASS_THREADS, BATCH = 256, 2
CLUSTER_MAX = 16                  # blocks a cluster (above 8: non-portable)
CLUSTER_TARGET_BYTES = 12 * 1024  # a cluster block's slice, aimed for


class _Leaf(ctypes.Structure):
    """``LeafArg`` of csrc/offload_pack.cu."""
    _fields_ = [("src", _PTR), ("dst", _PTR), ("scales", _PTR),
                ("src_stride", _I64), ("dst_stride", _I64), ("numel", _I64),
                ("run_len", _I64), ("block_elems", _I64)]


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (error {rc})")


def _dtype_code(dtype: torch.dtype, name: str) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: unsupported dtype {dtype} "
                        f"(kernel takes {list(_DTYPE_CODE)})")
    return _DTYPE_CODE[dtype]


def pack_plan(block_elems: int, itemsize: int) -> Tuple[int, int]:
    """How the int8 pack covers row blocks of ``block_elems`` elements of
    ``itemsize`` bytes: ``(cluster, 0)`` when a row block fits in the
    registers of one cluster (the fewest blocks, up to 16, that keep a
    block's slice near 12 KB), else ``(0, slices)``: two passes of
    ``slices`` blocks a row block."""
    chunks = -(-block_elems // VEC)
    cluster = 1
    while cluster < CLUSTER_MAX \
            and chunks * VEC * itemsize > cluster * CLUSTER_TARGET_BYTES:
        cluster *= 2
    if -(-chunks // cluster) <= CLUSTER_THREADS * REG_CHUNKS:
        return cluster, 0
    return 0, -(-chunks // (PASS_THREADS * BATCH))


def runs(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """``(run_len, stride)`` when ``t``'s elements, in logical order, are
    runs of ``run_len`` contiguous elements, one run every ``stride``
    elements (a pool frame ``pool[:, pid]``: one run a group); None for a
    layout that is not."""
    dims = [(n, s) for n, s in zip(t.shape, t.stride()) if n != 1]
    run, k = 1, len(dims)
    while k and dims[k - 1][1] == run:          # the contiguous tail
        run *= dims[k - 1][0]
        k -= 1
    if k == 0:
        return run, run
    for i in range(k - 1, 0, -1):               # the rest: one stride
        if dims[i - 1][1] != dims[i][1] * dims[i][0]:
            return None
    return run, dims[k - 1][1]


@functools.lru_cache(maxsize=256)
def _layout(name: str, n: int, src: torch.Size, src_stride: Tuple[int, ...],
            dst: torch.Size, dst_stride: Tuple[int, ...]
            ) -> Tuple[int, int, int]:
    """``(run_len, src_stride, dst_stride)`` of a leaf of ``n`` elements:
    both sides hold them in the same logical order, each as runs (a
    contiguous side takes the other side's run length)."""
    rs, rd = (runs(torch.empty_strided(shape, stride, device="meta"))
              for shape, stride in ((src, src_stride), (dst, dst_stride)))
    if rs is None or rd is None:
        raise ValueError(f"{name}: a leaf of shape {tuple(src)} / strides "
                         f"{src_stride} -> {dst_stride} is not runs of "
                         "contiguous elements at one stride")
    (ls, ss), (ld, sd) = rs, rd
    if ls == n:
        ls = ss = ld
    elif ld == n:
        ld = sd = ls
    if ls != ld:
        raise ValueError(f"{name}: source runs of {ls} elements, "
                         f"destination runs of {ld}")
    return ls, ss, sd


def _leaf(name: str, src: torch.Tensor, dst: torch.Tensor, scales: int,
          block_elems: int) -> _Leaf:
    """One leaf's descriptor (``scales``: the address of its first scale)."""
    n = src.numel()
    if dst.numel() != n or n % block_elems or n >= 2 ** 31:
        raise ValueError(f"{name}: a leaf of {n} elements into "
                         f"{dst.numel()}, row blocks of {block_elems}")
    run, ss, sd = _layout(name, n, src.shape, src.stride(), dst.shape,
                          dst.stride())
    return _Leaf(src.data_ptr(), dst.data_ptr(), scales, ss, sd, n, run,
                 block_elems)



def _on_card(tensors: Sequence[torch.Tensor], name: str) -> bool:
    """True when every tensor lies on the card, False when every one lies
    on the CPU; raises for a mix."""
    cuda = {t.is_cuda for t in tensors}
    if len(cuda) > 1:
        raise ValueError(f"{name}: tensors on the card and on the CPU")
    return cuda == {True}


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


def _int8_pack_launch(leaves: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                             int, int]]) -> None:
    """One launch of the int8 pack over ``(x, q, scales address,
    block_elems)`` leaves on the card (the regime from the largest row
    block's bytes)."""
    xs = [x for x, _, _, _ in leaves]
    dtypes = {x.dtype for x in xs}
    if len(dtypes) != 1:
        raise TypeError(f"int8_pack: leaves of mixed dtypes {dtypes}")
    dtype = dtypes.pop()
    code = _dtype_code(dtype, "int8_pack")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"int8_pack: {len(leaves)} leaves, at most "
                         f"{MAX_LEAVES} a launch")
    descs = (_Leaf * len(leaves))(*[_leaf("int8_pack", *lf)
                                    for lf in leaves])
    cluster, slices = pack_plan(max(b for _, _, _, b in leaves),
                                xs[0].element_size())
    partials = None
    if not cluster:
        n_rb = sum(x.numel() // b for x, _, _, b in leaves)
        partials = torch.empty((n_rb * slices,), dtype=torch.float32,
                               device=xs[0].device)
    fn = build.function("offload_pack", "int8_pack_leaves",
                        _PACK_LEAVES_ARGS)
    _check(fn(code, len(leaves), ctypes.addressof(descs), cluster, slices,
              None if partials is None else partials.data_ptr(),
              torch.cuda.current_stream(xs[0].device).cuda_stream),
           "int8_pack")
    int8_pack.launches += 1


def int8_pack(x: torch.Tensor, *, block_rows: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: int8 (R, C), scales: f32 (R // block_rows,))."""
    R, C = x.shape
    if R % block_rows:
        raise ValueError(f"int8_pack: {R} rows are not a multiple of "
                         f"block_rows {block_rows}")
    if not x.is_cuda:
        return ref.int8_pack_ref(x, block_rows)
    x = x.contiguous()
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scales = torch.empty((R // block_rows,), dtype=torch.float32,
                         device=x.device)
    if x.numel():
        _int8_pack_launch([(x, q, scales.data_ptr(), block_rows * C)])
    return q, scales


def int8_pack_leaves(xs: Sequence[torch.Tensor]
                     ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Each leaf (a view: e.g. a page's frame ``pool[:, pid]``, read in
    place) as ONE row block, all in one launch: ``[(q int8 shaped like x,
    0-d f32 scale)]``, what :func:`int8_pack` gives on each leaf's
    flattened ``(-1, cols)`` copy with ``block_rows`` its rows."""
    if not _on_card(xs, "int8_pack_leaves"):
        return ref.int8_pack_leaves_ref(xs)
    scales = torch.empty((len(xs),), dtype=torch.float32,
                         device=xs[0].device)
    qs = [torch.empty(x.shape, dtype=torch.int8, device=x.device)
          for x in xs]
    at = scales.data_ptr()
    leaves = [(x, q, at + 4 * i, x.numel())
              for i, (x, q) in enumerate(zip(xs, qs)) if x.numel()]
    if leaves:
        _int8_pack_launch(leaves)
    return list(zip(qs, scales.unbind()))


def blocksparse_pack(x: torch.Tensor, *, block_rows: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, C) -> (q: int8 (R, C) with |x| < absmax / 32 pruned to exact
    zeros, scales: f32 (R // block_rows,))."""
    return _pack(blocksparse_pack, torch.int8, ref.blocksparse_pack_ref, x,
                 block_rows)


def _unpack_launch(leaves: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, int]]) -> None:
    """One launch of the shared unpack over ``(q, scales, out,
    block_elems)`` leaves on the card."""
    payloads = {q.dtype for q, _, _, _ in leaves}
    outs = {o.dtype for _, _, o, _ in leaves}
    if len(payloads) != 1 or payloads - set(_PAYLOAD_CODE) or any(
            s.dtype != torch.float32 or not s.is_cuda
            for _, s, _, _ in leaves):
        raise TypeError("fp8_unpack: needs int8 or float8_e4m3fn payloads "
                        f"of one type and f32 scales on the card (got "
                        f"{payloads}, {[s.dtype for _, s, _, _ in leaves]})")
    if len(outs) != 1:
        raise TypeError(f"fp8_unpack: outputs of mixed dtypes {outs}")
    code = _dtype_code(outs.pop(), "fp8_unpack")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"fp8_unpack: {len(leaves)} leaves, at most "
                         f"{MAX_LEAVES} a launch")
    descs = (_Leaf * len(leaves))(*[_leaf("fp8_unpack", q, o, s.data_ptr(),
                                          b) for q, s, o, b in leaves])
    q0 = leaves[0][0]
    fn = build.function("offload_pack", "unpack_leaves", _UNPACK_LEAVES_ARGS)
    _check(fn(_PAYLOAD_CODE[q0.dtype], code, len(leaves),
              ctypes.addressof(descs),
              torch.cuda.current_stream(q0.device).cuda_stream),
           "fp8_unpack")
    fp8_unpack.launches += 1


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
    _dtype_code(dtype, "fp8_unpack")
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty((R, C), dtype=dtype, device=q.device)
    if q.numel():
        _unpack_launch([(q, scales, out, block_rows * C)])
    return out


def unpack_leaves(qs: Sequence[torch.Tensor], scales: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor]) -> None:
    """Decode each payload (one row block, a 0-d or 1-element scale) into
    ``outs[i]`` in place (a view: e.g. a page's frame ``pool[:, pid]``), in
    its dtype, all in one launch: what :func:`fp8_unpack` gives on each
    leaf, copied in."""
    if len(qs) != len(scales) or len(qs) != len(outs):
        raise ValueError(f"unpack_leaves: {len(qs)} payloads, "
                         f"{len(scales)} scales, {len(outs)} outputs")
    if not _on_card([*qs, *scales, *outs], "unpack_leaves"):
        ref.unpack_leaves_ref(qs, scales, outs)
        return
    for s in scales:
        if s.numel() != 1:
            raise ValueError(f"unpack_leaves: a leaf is one row block (one "
                             f"scale), got {s.numel()} scales")
    leaves = [(q, s, o, q.numel()) for q, s, o in zip(qs, scales, outs)
              if q.numel()]
    if leaves:
        _unpack_launch(leaves)


#: dequantize-by-scale has no payload-specific logic: the int8 and
#: blocksparse unpacks ARE the fp8 one (pruned zeros dequantise to zero)
int8_unpack = fp8_unpack
blocksparse_unpack = fp8_unpack

fp8_pack.launches = 0
int8_pack.launches = 0
blocksparse_pack.launches = 0
fp8_unpack.launches = 0
