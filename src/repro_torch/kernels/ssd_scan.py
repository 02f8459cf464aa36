"""Mamba2 SSD chunked scan.

Wrapper of ``csrc/ssd_scan.cu``, the CUDA twin of the reference's Pallas
``ssd_scan`` (``kernels/ssd_scan.py``), which takes what the reference's
model runs instead (``models/ssm.ssd_chunked``): the initial state in and
the final state out, B / C per group, dt x and dt A formed in the kernel.
A tensor on the CPU takes the plain version (``kernels/ref.
ssd_chunked_ref``); a CUDA tensor launches the kernel or raises.  Launches
are counted in ``.launches``.  The gradient pairing (kernel forward,
backward recomputed through the plain version) is ``kernels/ops.ssd``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
P_TILE = 32           # P columns per thread block
MAX_CHUNK = 128       # chunk rows the score tile holds
MAX_STATE = 128       # state size N the shared memory holds
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, S, H, P); dt: (b, S, H) float32 (softplus'd); A: (H,) float32;
    B / C: (b, S, G, N); init_state: (b, H, P, N) or None.  Returns (y (b,
    S, H, P) float32, final state (b, H, P, N) in x's dtype), as
    ``models/ssm.ssd_chunked``.

    On the card x, B, C and init_state share one dtype (float32 or
    bfloat16), every input is contiguous, ``S`` is a multiple of the chunk
    ``min(chunk, S)``, which is at most 128 and a multiple of 8, P is a
    multiple of 32 and N at most 128 and a multiple of 8; x, B and C start
    on 16 bytes (the kernel loads 16 bytes at a time)."""
    if not x.is_cuda:
        return ref.ssd_chunked_ref(x, dt, A, B, C, chunk,
                                   init_state=init_state)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} and B "
                         f"{tuple(B.shape)} must be 4-d")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    c = min(chunk, S)
    want = {"dt": (b, S, H), "A": (H,), "B": (b, S, G, N),
            "C": (b, S, G, N), "init_state": (b, H, P, N)}
    got = {"dt": dt, "A": A, "B": B, "C": C, "init_state": init_state}
    for name, t in got.items():
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: {name} {tuple(t.shape)}, want "
                             f"{want[name]} for x {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or any(
            t is not None and t.dtype != x.dtype
            for t in (B, C, init_state)):
        raise TypeError(f"ssd_scan: x {x.dtype}, B {B.dtype}, C {C.dtype}, "
                        f"init_state "
                        f"{None if init_state is None else init_state.dtype}"
                        f"; the kernel takes one of {list(_DTYPE_CODE)} "
                        "for all of them")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt {dt.dtype} and A {A.dtype} must be "
                        "float32")
    for name, t in got.items():
        if t is None:
            continue
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} is not contiguous")
    if not x.is_contiguous():
        raise ValueError("ssd_scan: x is not contiguous")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: x, B and C must start on 16 bytes")
    if S == 0 or c == 0 or S % c or c > MAX_CHUNK or c % 8:
        raise ValueError(f"ssd_scan: S {S} must be a positive multiple of "
                         f"the chunk {c} (<= {MAX_CHUNK}, a multiple of 8)")
    if P % P_TILE or N > MAX_STATE or N % 8 or G == 0 or H % G:
        raise ValueError(f"ssd_scan: P {P} (a multiple of {P_TILE}), N {N} "
                         f"(<= {MAX_STATE}, a multiple of 8), H {H} over G "
                         f"{G} groups: not a shape the kernel takes")
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    if b == 0 or H == 0 or P == 0:
        return y, fin
    fn = build.function("ssd_scan", "ssd_scan_fwd", _ARGS)
    rc = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), fin.data_ptr(), b, S, H, G, N, P, c,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan: CUDA kernel launch failed (error {rc})")
    ssd_scan.launches += 1
    return y, fin


ssd_scan.launches = 0
