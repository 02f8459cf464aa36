"""The hand-written kernels under ``FakeTensorMode``: what a launch would
allocate, compute and move, without launching.

A kernel wrapper given FakeTensors on the card (the dry-run's fake
``cuda`` device, ``launch/dryrun.py``), and only then, allocates its
outputs as the kernel would, reports the kernel's work to every active
dispatch mode that records kernels (the dry-run's tracker, through its
``record_kernel(name, flops, nbytes)``) and returns: it does not launch,
count a launch or run the plain version.  A FakeTensor has no storage
for ``data_ptr()``.  A CPU tensor, fake or real, still takes the plain
version; a real CUDA tensor still launches the kernel or raises.

The work is counted as PERF.md §6's bounds count it: every input read
once and every output written once; operations over what the call's
shapes need (the visible pairs of a causal or windowed attention).  A
fake page map has no values, so the paged decode counts every mapped
page up to ``cache_index`` as a raw page.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


def is_fake(t) -> bool:
    return isinstance(t, FakeTensor)


def account(kernel: str, flops: float, nbytes: float) -> None:
    """Report one would-be launch of ``kernel`` to the recording modes."""
    for mode in _get_current_dispatch_mode_stack():
        record = getattr(mode, "record_kernel", None)
        if record is not None:
            record(kernel, flops, nbytes)


def _bytes(t: torch.Tensor) -> float:
    return float(t.numel()) * t.element_size()


@functools.lru_cache(maxsize=256)
def visible_pairs(S: int, T: int, causal: bool, window: int) -> int:
    """(query, key) pairs a causal / windowed attention computes: key j
    visible to query i when j <= i and, with a window, i - j < window
    (both counted from 0, as the kernel counts them)."""
    if not causal:
        return S * T
    total = 0
    for i in range(S):
        hi = min(i, T - 1)
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def flash_work(q, k, causal: bool, window: int) -> Tuple[float, float]:
    """(operations, bytes) of the flash forward: QK and PV over the
    visible pairs; q, k, v read and out written once."""
    B, H, S, d = q.shape
    T = k.shape[2]
    return (4.0 * d * B * H * visible_pairs(S, T, causal, window),
            2 * _bytes(q) + 2 * _bytes(k))


def ssd_work(x, dt, B, init_state, chunk: int) -> Tuple[float, float]:
    """(operations, bytes) of the SSD scan: per (b, h) and chunk c(c+1)
    (N+P) for the scores and the intra-chunk product, 4cPN for the
    inter-chunk product and the state update; x, dt, A, B, C and the
    initial state read once, y float32 and the final state written
    once."""
    b, S, H, P = x.shape
    N = B.shape[3]
    c = min(chunk, S)
    e = x.element_size()
    nbytes = (_bytes(x) + dt.numel() * 4 + H * 4 + 2 * _bytes(B)
              + (_bytes(init_state) if init_state is not None else 0)
              + x.numel() * 4 + b * H * P * N * e)
    ops = b * H * (S // c) * (c * (c + 1) * (N + P) + 4.0 * c * P * N)
    return ops, nbytes


def paged_work(q, k_pool, page_map, cache_index: int, window: int
               ) -> Tuple[float, float]:
    """(operations, bytes) of the paged decode: q read and out written,
    the page map, and the K / V of every page a query can see."""
    B, _, H, hd = q.shape
    _, page, K, _ = k_pool.shape
    first = max(0, cache_index - window + 1) if window > 0 else 0
    pages = max(0, cache_index // page - first // page + 1)
    per_page = page * K * hd
    nbytes = (2 * _bytes(q) + page_map.numel() * 4
              + 2 * B * pages * per_page * k_pool.element_size())
    return 4.0 * B * H * hd * max(0, cache_index + 1 - first), nbytes


def gemm_work(x, w) -> Tuple[float, float]:
    """(operations, bytes) of (M, K) @ (K, N): 2MNK; x, w, out once."""
    (M, K), N = x.shape, w.shape[1]
    return 2.0 * M * N * K, (M * K + K * N + M * N) * x.element_size()


def codec_work(src, dst, n_scales: int) -> Tuple[float, float]:
    """(operations, bytes) of a pack or unpack: 3 float32 operations an
    element; the source read, the destination and the scales (4 bytes
    each) written or read once."""
    return 3.0 * src.numel(), _bytes(src) + _bytes(dst) + 4 * n_scales
