"""Stash compression — the memory-node's "optional compression ASIC" (§III-A).

This module owns the **codec registry**: every stash codec is a
:class:`Codec` carrying its hand-written blockwise ``pack``/``unpack``
kernels (``kernels/offload_pack.py``; their plain twins are in
``kernels/ref.py``).  :func:`encode_tensor` / :func:`decode_tensor` run a
whole tensor through them as one row block — the per-tensor scale of the
reference's ``compress``/``decompress`` transforms, bit for bit — for the
training stash (``core/tiers.CompressedTier``) and the serving spill alike;
:func:`encode_leaves` / :func:`decode_leaves` do the same for the leaves of
one spilled page in one launch, read from and written into the pool's
frames in place.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Codec:
    """One stash codec: its pack / unpack kernels.

    ``pack``/``unpack`` take ``(x_2d, *, block_rows)`` /
    ``(q_2d, scales, *, block_rows, dtype)``; ``pack_leaves`` (None: the
    codec packs leaf by leaf) / ``unpack_leaves`` take ``(xs)`` /
    ``(qs, scales, outs)``, each leaf one row block, in one launch.
    """

    name: str
    ratio: float                                   # stashed bytes per raw byte
    pack: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    unpack: Callable[..., torch.Tensor]
    unpack_leaves: Callable[..., None]
    pack_leaves: Optional[Callable[..., List[Tuple[torch.Tensor,
                                                   torch.Tensor]]]] = None

    def applies_to(self, x: torch.Tensor) -> bool:
        return x.is_floating_point()


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
    register_codec(Codec("fp8", 0.5, kp.fp8_pack, kp.fp8_unpack,
                         kp.unpack_leaves))
    register_codec(Codec("int8", 0.5, kp.int8_pack, kp.int8_unpack,
                         kp.unpack_leaves, kp.int8_pack_leaves))
    register_codec(Codec("blocksparse", 0.5, kp.blocksparse_pack,
                         kp.blocksparse_unpack, kp.unpack_leaves))


_register_builtin_codecs()


# ---------------------------------------------------------------------------
# whole-tensor encode/decode through a codec: its kernels run on the
# flattened 2D view as ONE row block, so the scale is per tensor
def encode_tensor(codec: Codec, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` (any shape) with one per-tensor scale.

    Returns ``(q, scale)`` with ``q.shape == x.shape`` and a 0-d scale.
    """
    x2 = x.reshape(-1, x.shape[-1])
    q2, scales = codec.pack(x2, block_rows=x2.shape[0])
    return q2.reshape(x.shape), scales[0]


def decode_tensor(codec: Codec, q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    q2 = q.reshape(-1, q.shape[-1])
    x2 = codec.unpack(q2, scale.reshape(1), block_rows=q2.shape[0],
                      dtype=dtype)
    return x2.reshape(q.shape)


def encode_leaves(codec: Codec, xs: Sequence[torch.Tensor]
                  ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """:func:`encode_tensor` of every leaf of ``xs`` (views, e.g. a page's
    frames ``pool[:, pid]``, read in place) in one launch of the codec's
    batched pack; the codec must have one (``codec.pack_leaves``)."""
    if codec.pack_leaves is None:
        raise ValueError(f"codec {codec.name!r} packs leaf by leaf")
    return codec.pack_leaves(xs)


def decode_leaves(codec: Codec, qs: Sequence[torch.Tensor],
                  scales: Sequence[torch.Tensor],
                  outs: Sequence[torch.Tensor]) -> None:
    """:func:`decode_tensor` of every payload into ``outs[i]`` (views, e.g.
    a page's frames, written in place, in their dtype) in one launch."""
    codec.unpack_leaves(qs, scales, outs)
