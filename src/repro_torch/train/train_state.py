"""Train state: params + optimizer moments + step."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.train.optimizer import init_opt_state

Pytree = Any


def init_state(model: Model, tc: TrainConfig,
               params: Optional[Pytree] = None) -> Pytree:
    """Params (random from ``tc.seed`` unless given), moments and step.
    The float parameters require gradients.  The int8 error-feedback
    residual of ``grad_compress="int8"`` belongs to the compressed
    all-reduce, which ports with slice 4."""
    if tc.grad_compress != "none":
        raise NotImplementedError(
            f"grad_compress={tc.grad_compress!r}: the compressed all-reduce "
            "and its error feedback port with slice 4")
    if params is None:
        params = model.init(tc.seed)
    for t in tree.leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return {"params": params,
            "opt": init_opt_state(params, model.memory.opt_state_bits),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree.leaves(params)[0].device)}


def state_template(model: Model, tc: TrainConfig) -> Pytree:
    """The state's shapes, dtypes and gradient flags on the meta device:
    what a restore rebuilds (``train.checkpoint.to_device``) without
    allocating a second state."""
    params = tfm.init_params(torch.Generator().manual_seed(tc.seed),
                             model.cfg, model.dtype, "meta")
    return init_state(model, tc, params=params)
