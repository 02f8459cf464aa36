"""Train state: params + optimizer moments + step (+ the int8
error-feedback residual), and its sharding specs."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.train.optimizer import init_opt_state, opt_state_specs

Pytree = Any


def init_state(model: Model, tc: TrainConfig,
               params: Optional[Pytree] = None) -> Pytree:
    """Params (random from ``tc.seed`` unless given; on a mesh this
    rank's shards), moments and step.  The float parameters require
    gradients.  ``grad_compress="int8"`` adds ``ef_err``, the
    error-feedback residual of ``parallel/collectives.
    compressed_tree_all_reduce``: float32 zeros shaped as the
    parameters, which the step carries unchanged, as the reference's does
    (no training code calls the compressed all-reduce: ROADMAP C16)."""
    if tc.grad_compress not in ("none", "int8"):
        raise ValueError(f"unknown grad_compress {tc.grad_compress!r}")
    if params is None:
        params = model.init(tc.seed)
    for t in tree.leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    state = {"params": params,
             "opt": init_opt_state(params, model.memory.opt_state_bits),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=tree.leaves(params)[0].device)}
    if tc.grad_compress == "int8":
        state["ef_err"] = tree.map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def state_specs(model: Model, tc: TrainConfig) -> Pytree:
    """The state's sharding specs (the reference's table)."""
    pspecs = model.param_specs()
    s = {"params": pspecs,
         "opt": opt_state_specs(pspecs, model.memory.opt_state_bits),
         "step": P()}
    if tc.grad_compress == "int8":
        s["ef_err"] = pspecs
    return s


def state_template(model: Model, tc: TrainConfig) -> Pytree:
    """The state's shapes, dtypes and gradient flags on the meta device:
    what a restore rebuilds (``train.checkpoint.to_device``) without
    allocating a second state."""
    params = tfm.init_params(torch.Generator().manual_seed(tc.seed),
                             model.cfg, model.dtype, "meta")
    return init_state(model, tc, params=params)
