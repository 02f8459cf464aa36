"""Mamba2 SSD chunked scan.

Wrapper of ``csrc/ssd_scan.cu``, the CUDA twin of the reference's Pallas
``ssd_scan`` (``kernels/ssd_scan.py``), which takes what the reference's
model runs instead (``models/ssm.ssd_chunked``): the initial state in and
the final state out, B / C per group, dt x and dt A formed in the kernel.
A tensor on the CPU takes the plain version (``kernels/ref.
ssd_chunked_ref``); a CUDA tensor launches the kernel or raises; a FakeTensor on the
card allocates the outputs and reports the kernel's work
(``kernels/fake.py``).  Launches are counted in ``.launches``.  The gradient pairing (kernel forward,
backward recomputed through the plain version) is ``kernels/ops.ssd``.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import build, fake, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128       # chunk rows the score tile holds
# float32 (CUDA cores): P a multiple of P_TILE, N at most MAX_STATE and a
# multiple of 8, the chunk a multiple of 8
P_TILE = 32           # P columns per thread block
MAX_STATE = 128       # state size N the shared memory holds
# bfloat16 (tensor cores): the chunk and P multiples of 16, P at most
# MAX_HEAD_BF16, N one of STATES_BF16
MAX_HEAD_BF16 = 64
STATES_BF16 = (16, 32, 64, 128)
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

    On the card x, B, C and init_state share one dtype, every input is
    contiguous, ``S`` is a multiple of the chunk ``min(chunk, S)`` (at
    most 128), and x, B and C start on 16 bytes (the kernel loads 16 bytes
    at a time).  float32 runs on the CUDA cores: the chunk a multiple of
    8, P of 32, N at most 128 and a multiple of 8.  bfloat16 runs on the
    tensor cores: the chunk and P multiples of 16, P at most 64, N one of
    16, 32, 64, 128; any other bfloat16 shape raises (it never runs the
    float32 kernel)."""
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
    if not fake.is_fake(x) and any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan: x, B and C must start on 16 bytes")
    step = 16 if x.dtype == torch.bfloat16 else 8
    if S == 0 or c == 0 or S % c or c > MAX_CHUNK or c % step:
        raise ValueError(f"ssd_scan: S {S} must be a positive multiple of "
                         f"the chunk {c} (<= {MAX_CHUNK}, a multiple of "
                         f"{step} in {x.dtype})")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: H {H} over G {G} groups")
    if x.dtype == torch.bfloat16:
        if P % 16 or P > MAX_HEAD_BF16 or N not in STATES_BF16:
            raise ValueError(f"ssd_scan: P {P} (a multiple of 16, <= "
                             f"{MAX_HEAD_BF16}), N {N} (one of "
                             f"{STATES_BF16}): not a shape the bfloat16 "
                             "kernel takes")
    elif P % P_TILE or N > MAX_STATE or N % 8:
        raise ValueError(f"ssd_scan: P {P} (a multiple of {P_TILE}), N {N} "
                         f"(<= {MAX_STATE}, a multiple of 8): not a shape "
                         "the float32 kernel takes")
    y = torch.empty((b, S, H, P), dtype=torch.float32, device=x.device)
    fin = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    if b == 0 or H == 0 or P == 0:
        return y, fin
    if fake.is_fake(x):
        fake.account("ssd_scan", *fake.ssd_work(x, dt, B, init_state, c))
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


def rounding_probe(chunk: int = 128, N: int = 128, P: int = 64,
                   device=None) -> List[torch.Tensor]:
    """Inputs of one scan (bfloat16; batch 1, two chunks, three heads in
    three groups) whose output shows each of the reference's five
    roundings and the float32 ``dt x``.  Under those roundings y (float32)
    and the final state (bfloat16) are exact, so a kernel that rounds
    where the reference does reproduces them bit for bit whatever order
    it sums in; column p of x is ``2^-(p % 4)`` (rows and columns stay
    apart), c is the chunk, and |d| below is for column 0.

    - head 0 (A = 0: no decay): dt = 1 + 2^-12 (``dt x`` is not a bf16
      value), B = (1, 2^-8), C = (1, 1), so every score is 1 + 2^-8, a
      tie that rounds to 1; the state where it meets C is c and c 2^-8
      (from c (1 + 2^-12)), and y_inter = c (1 + 2^-8), a tie that rounds
      to c.  The scores unrounded move y by about c 2^-8 (last row), the
      state unrounded by c 2^-7, y_inter unrounded by c 2^-8, ``dt x``
      rounded to bf16 by c 2^-12 (last row).
    - head 1: one row of x in the first chunk, dt 1.5 there, and the decay
      e^A = 1 - 3 2^-10 once after it; B = 1.25: the decayed B rounds to
      1.25, and the final state is 1.875; unrounded it reads 1.8671875.
    - head 2: a state of 1.5 from the first chunk, read in the second
      through C = 1.25 decayed by e^A: C rounds back to 1.25 and y to
      1.875; unrounded it reads 1.8671875.
    Returns [x, dt, A, B, C] (x, B, C bfloat16; dt, A float32)."""
    c, H = chunk, 3
    S = 2 * c
    xp = 2.0 ** -(torch.arange(P) % 4).float()
    x = torch.zeros((1, S, H, P))
    dt = torch.zeros((1, S, H))
    A = torch.zeros(H)
    B = torch.zeros((1, S, H, N))
    C = torch.zeros((1, S, H, N))
    x[0, :, 0] = xp
    dt[0, :, 0] = 1.0 + 2.0 ** -12
    B[0, :, 0, 0], B[0, :, 0, 1] = 1.0, 2.0 ** -8
    C[0, :, 0, :2] = 1.0
    A[1:] = math.log(1.0 - 3 * 2.0 ** -10)
    x[0, 0, 1], dt[0, 0, 1], dt[0, c - 1, 1] = xp, 1.5, 1.0
    B[0, 0, 1, 0] = 1.25
    x[0, 0, 2], dt[0, 0, 2], B[0, 0, 2, 0] = xp, 1.5, 1.0
    dt[0, c, 2] = 1.0
    C[0, c:, 2, 0] = 1.25
    bf = [t.to(device, torch.bfloat16) for t in (x, B, C)]
    return [bf[0], dt.to(device), A.to(device), bf[1], bf[2]]
