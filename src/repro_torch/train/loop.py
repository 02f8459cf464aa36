"""Training loop: the train-step builder and the driver.

The reference's loop also checkpoints, injects chaos, recovers elastically
and pipelines (``repro/train/loop.py``); those port with slice 4, so this
loop takes no checkpoint manager and saves nothing.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import Model
from repro_torch.parallel.pipeline import (accumulate_microbatches,
                                           value_and_grad)
from repro_torch.train.optimizer import apply_adamw
from repro_torch.train.train_state import init_state

log = logging.getLogger(__name__)
Pytree = Any


def grads_of(model: Model, tc: TrainConfig, params: Pytree,
             batch: Dict[str, torch.Tensor]):
    """``(grads, loss, metrics)`` of one batch; ``tc.grad_accum > 1``
    accumulates over that many microbatches."""
    if tc.grad_accum <= 1:
        loss, metrics, grads = value_and_grad(model.loss_fn, params, batch)
        return grads, loss, metrics
    return accumulate_microbatches(model.loss_fn, params, batch,
                                   tc.grad_accum)


def make_train_step(model: Model, tc: TrainConfig
                    ) -> Callable[[Pytree, Dict[str, torch.Tensor]],
                                  Tuple[Pytree, Dict[str, torch.Tensor]]]:
    """(state, batch) -> (state, metrics).  The parameters are updated in
    place; the state's moments and step are replaced."""

    def train_step(state, batch):
        g, _, metrics = grads_of(model, tc, state["params"], batch)
        params, opt, opt_metrics = apply_adamw(state["params"], g,
                                               state["opt"], tc)
        new_state = dict(state, params=params, opt=opt,
                         step=state["step"] + 1)
        return new_state, dict(metrics, **opt_metrics)

    return train_step


def train(model: Model, tc: TrainConfig, data_iter, *,
          state: Optional[Pytree] = None,
          hooks: Optional[Dict[str, Callable]] = None
          ) -> Tuple[Pytree, Dict[str, float]]:
    """The end-to-end driver.

    ``data_iter`` yields ``(step_idx, batch)`` with the batch on the model's
    device.  Each step's time is taken on the host clock around work that
    ends in a device synchronisation.  Every ``tc.log_every`` steps it logs
    ``step N loss=... grad_norm=... lr=... (... ms)`` and calls
    ``hooks["on_log"](step, metrics)``; on exit it logs the memory-tier
    traffic summary.  Returns the final state and the last step's metrics.
    """
    hooks = hooks or {}
    step_fn = make_train_step(model, tc)
    if state is None:
        state = init_state(model, tc)
    metrics: Dict[str, float] = {}
    for step_idx, batch in data_iter:
        if step_idx >= tc.total_steps:
            break
        t0 = time.perf_counter()
        state, out = step_fn(state, batch)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        ms = 1e3 * (time.perf_counter() - t0)
        done = step_idx + 1
        if done % tc.log_every == 0:
            metrics = {k: float(v) for k, v in out.items()}
            metrics["ms"] = ms
            log.info("step %d loss=%.4f grad_norm=%.3f lr=%.2e (%.1f ms)",
                     done, metrics.get("loss", -1),
                     metrics.get("grad_norm", -1), metrics.get("lr", 0), ms)
            if "on_log" in hooks:
                hooks["on_log"](done, metrics)
    if model.runtime.offloads:
        log.info("memory traffic: %s", model.runtime.traffic_summary())
    return state, metrics
