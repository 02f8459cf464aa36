"""Carry parameters over from the JAX reference's tree.

The port keeps the reference's parameter tree as its own layout (``embed``,
``final_norm``, ``groups/sub_j/...`` stacked on a leading layer axis, the
hybrid's ``shared`` block unstacked, the frontend's ``frontend`` and the
encoder-decoder's ``encoder`` trees, weights ``(d_in, d_out)``), so
conversion is leaf-wise: the caller hands
the tree over as nested dicts of numpy arrays (``np.asarray`` of each JAX
leaf) and gets torch tensors back.  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

#: subtrees and leaves that stay float32 whatever the model dtype, as the
#: reference initialises them: the norms (``ln_x`` the decoder's before
#: cross-attention, ``final_norm`` the encoder's too), the Mamba2 block's
#: decay, skip,
#: step bias and gated-norm scale (``repro/models/ssm.mamba_init``) and the
#: MoE router (``repro/models/moe.moe_init``)
F32_KEYS = ("ln1", "ln2", "ln_x", "final_norm",
            "A_log", "D", "dt_bias", "norm_scale", "router")


def _to_tensor(a: Any, device, dtype: Optional[torch.dtype],
               keep_f32: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: no numpy bridge
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point() and not keep_f32:
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree: Any, device: Union[str, torch.device],
                    dtype: Optional[torch.dtype] = None,
                    _keep_f32: bool = False) -> Any:
    """The port's parameters from the reference's tree of numpy arrays, on
    ``device`` (``"cuda"`` or ``"cpu"``: no default, no fallback).

    ``dtype`` (None: keep each leaf's) casts the floating leaves outside
    ``F32_KEYS``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype,
                                   _keep_f32 or k in F32_KEYS)
                for k, v in tree.items()}
    return _to_tensor(tree, device, dtype, _keep_f32)
