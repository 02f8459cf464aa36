"""Stash compression — the memory-node's "optional compression ASIC" (§III-A).

This module owns the **codec registry**: every stash codec is a
:class:`Codec` carrying either its hand-written blockwise ``pack``/``unpack``
kernels (``kernels/offload_pack.py``; their plain twins are in
``kernels/ref.py``) or, until those are ported, a per-tensor ``compress``
transform in plain torch, decoded by :func:`dequantize`.

Ported kernels so far: int8 pack and the shared unpack.  The fp8 and
blocksparse codecs keep ``pack=None`` until their kernels are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.ref import true_div

FP8_MAX = 448.0                 # float8_e4m3fn dynamic range
INT8_MAX = 127.0
# entries below absmax / BLOCKSPARSE_TAU become exact zeros (blocksparse)
BLOCKSPARSE_TAU = 32.0


# ---------------------------------------------------------------------------
def fp8_compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (fp8 payload, fp32 scale).  Halves stash bytes vs bf16."""
    xf = x.float()
    scale = torch.clamp(true_div(xf.abs().amax(), FP8_MAX), min=1e-12)
    return (xf / scale).to(torch.float8_e4m3fn), scale


def blocksparse_compress(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (magnitude-pruned int8 payload, fp32 scale)."""
    xf = x.float()
    absmax = xf.abs().amax()
    scale = torch.clamp(true_div(absmax, INT8_MAX), min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -INT8_MAX, INT8_MAX)
    keep = xf.abs() >= true_div(absmax, BLOCKSPARSE_TAU)
    return torch.where(keep, q, 0.0).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """``(q·scale)`` cast to ``dtype`` — the decode of every codec here."""
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Codec:
    """One stash codec: its kernels, or its per-tensor transform.

    ``pack``/``unpack`` take ``(x_2d, *, block_rows)`` /
    ``(q_2d, scales, *, block_rows, dtype)``.  A codec without kernels
    leaves them ``None`` and carries ``compress`` instead.
    """

    name: str
    ratio: float                                   # stashed bytes per raw byte
    compress: Optional[Callable[[torch.Tensor],
                                Tuple[torch.Tensor, torch.Tensor]]] = None
    pack: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None
    unpack: Optional[Callable[..., torch.Tensor]] = None

    def applies_to(self, x: torch.Tensor) -> bool:
        return x.is_floating_point()

    @property
    def has_kernel(self) -> bool:
        return self.pack is not None and self.unpack is not None


_CODECS: Dict[str, Codec] = {}


def register_codec(codec: Codec) -> None:
    _CODECS[codec.name] = codec


def get_codec(name: str) -> Codec:
    if name not in _CODECS:
        raise KeyError(f"unknown stash codec {name!r}; "
                       f"registered: {sorted(_CODECS)}")
    return _CODECS[name]


def registered_codecs() -> Tuple[str, ...]:
    return tuple(sorted(_CODECS))


def _register_builtin_codecs() -> None:
    # the kernel modules import no CUDA toolchain at import time: a kernel
    # is built on its first launch
    from repro_torch.kernels import offload_pack as kp
    register_codec(Codec("fp8", 0.5, compress=fp8_compress))
    register_codec(Codec("int8", 0.5, pack=kp.int8_pack,
                         unpack=kp.int8_unpack))
    register_codec(Codec("blocksparse", 0.5, compress=blocksparse_compress))


_register_builtin_codecs()


# ---------------------------------------------------------------------------
# whole-tensor encode/decode through a codec — the per-page spill path.  A
# codec's kernels run on the flattened 2D view as ONE row block: a
# page-granular scale, as the per-tensor transforms give.
def encode_tensor(codec: Codec, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` (any shape) with one per-tensor scale.

    Returns ``(q, scale)`` with ``q.shape == x.shape`` and a 0-d scale.
    """
    if codec.has_kernel:
        x2 = x.reshape(-1, x.shape[-1])
        q2, scales = codec.pack(x2, block_rows=x2.shape[0])
        return q2.reshape(x.shape), scales[0]
    return codec.compress(x)


def decode_tensor(codec: Codec, q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    if codec.has_kernel:
        q2 = q.reshape(-1, q.shape[-1])
        x2 = codec.unpack(q2, scale.reshape(1), block_rows=q2.shape[0],
                          dtype=dtype)
        return x2.reshape(q.shape)
    return dequantize(q, scale, dtype)
