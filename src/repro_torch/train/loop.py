"""Training loop: the train-step builder and the driver with gradient
accumulation, checkpointing, fault handling and metrics (the reference's
``repro/train/loop.py``; its pipelined schedules are not ported yet)."""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import Model
from repro_torch.parallel.pipeline import (accumulate_microbatches,
                                           value_and_grad)
from repro_torch.train import chaos as chaos_mod
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import fault as fault_mod
from repro_torch.train.optimizer import apply_adamw
from repro_torch.train.train_state import init_state, state_template

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


def make_manager(model: Model, tc: TrainConfig, ckpt=None, chaos=None
                 ) -> ckpt_mod.CheckpointManager:
    """The run's CheckpointManager in ``tc.checkpoint_dir``: tier-backed
    and metered when a :class:`~repro_torch.configs.base.CheckpointPlan` is
    enabled, the legacy direct writer otherwise.  The chaos harness's shard
    corruptor rides on the manager's post-commit hook."""
    on_commit = chaos.after_save if chaos is not None else None
    if ckpt is None or not ckpt.enabled:
        return ckpt_mod.CheckpointManager(tc.checkpoint_dir,
                                          keep=tc.keep_checkpoints,
                                          on_commit=on_commit)
    runtime = ckpt_mod.make_ckpt_runtime(ckpt, model.plan, model.memory,
                                         model.device,
                                         keep=tc.keep_checkpoints)
    return ckpt_mod.CheckpointManager(tc.checkpoint_dir,
                                      keep=tc.keep_checkpoints,
                                      runtime=runtime, shards=ckpt.shards,
                                      async_saves=ckpt.async_saves,
                                      on_commit=on_commit)


def train(model: Model, tc: TrainConfig, data_iter, *,
          state: Optional[Pytree] = None,
          fault_handler=None,
          hooks: Optional[Dict[str, Callable]] = None,
          ckpt=None, chaos=None, elastic=None, mgr=None
          ) -> Tuple[Pytree, Dict[str, float]]:
    """The end-to-end driver.

    ``data_iter`` yields ``(step_idx, batch)``, the batch's tensors on the
    model's device (a :class:`~repro_torch.data.pipeline.Prefetcher`);
    with ``get_state`` / ``set_state`` its position rides in every
    snapshot, and a resume or a recovery rewinds it.  Without ``state``
    the run resumes from the newest valid snapshot in
    ``tc.checkpoint_dir`` (through ``mgr``, by default
    :func:`make_manager`'s), else starts from ``init_state``; batches
    before the resumed step are skipped.  It saves every ``ckpt.every``
    steps (``tc.checkpoint_every`` without a plan), and at the step
    boundary after ``fault_handler`` saw SIGTERM, then stops.

    fault_handler: :class:`~repro_torch.train.fault.FaultHandler`.
    ckpt: optional :class:`~repro_torch.configs.base.CheckpointPlan`.
    chaos: optional :class:`~repro_torch.train.chaos.ChaosMonkey`: kills
      (absorbed by ``retry_step``), preemptions, shard corruptions and
      stage losses.
    elastic: optional :class:`~repro_torch.train.elastic.ElasticController`
      (without it a stage loss is fatal).

    Each step's time is taken on the host clock around work that ends in
    a device synchronisation.  Every ``tc.log_every`` steps it logs ``step
    N loss=... grad_norm=... lr=... (... ms)`` and calls
    ``hooks["on_log"](step, metrics)`` (``metrics["ckpt_in_flight"]`` is
    1 when an async save was writing as the step ran).  On exit it logs
    the memory-tier, checkpoint-tier and chaos summaries.  Returns the
    final state and the last logged step's metrics.
    """
    hooks = hooks or {}
    step_fn = make_train_step(model, tc)
    if mgr is None:
        mgr = make_manager(model, tc, ckpt, chaos)
    ckpt_every = (ckpt.every if ckpt is not None and ckpt.every > 0
                  else tc.checkpoint_every)

    start_step = 0
    if state is None:
        restored = mgr.restore_latest()
        if restored is not None:
            start_step, payload = restored
            state = ckpt_mod.to_device(payload["state"],
                                       state_template(model, tc),
                                       model.device)
            if hasattr(data_iter, "set_state") and payload.get("data"):
                data_iter.set_state(payload["data"])
            log.info("resumed from step %d", start_step)
        else:
            state = init_state(model, tc)

    metrics: Dict[str, float] = {}
    for step_idx, batch in data_iter:
        if step_idx < start_step:
            continue
        if step_idx >= tc.total_steps:
            break
        if chaos is not None:
            try:
                chaos.before_step(step_idx, fault_handler)
            except chaos_mod.StageLostError as err:
                if elastic is None:
                    raise
                model, state, start_step = elastic.recover(
                    tc, data_iter, err.stage)
                step_fn = make_train_step(model, tc)
                continue
        in_flight = mgr.in_flight
        t0 = time.perf_counter()
        if chaos is not None:
            state, out = fault_mod.retry_step(
                chaos.wrap_step(step_fn, step_idx), state, batch,
                retries=chaos.retries, backoff=chaos.backoff)
        else:
            state, out = step_fn(state, batch)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        seconds = time.perf_counter() - t0
        if fault_handler is not None:
            fault_handler.observe_step(seconds)
        done = step_idx + 1
        if done % tc.log_every == 0:
            metrics = {k: float(v) for k, v in out.items()}
            metrics["ms"] = 1e3 * seconds
            metrics["ckpt_in_flight"] = float(in_flight)
            log.info("step %d loss=%.4f grad_norm=%.3f lr=%.2e (%.1f ms)",
                     done, metrics.get("loss", -1),
                     metrics.get("grad_norm", -1), metrics.get("lr", 0),
                     1e3 * seconds)
            if "on_log" in hooks:
                hooks["on_log"](done, metrics)
        stop = fault_handler is not None and fault_handler.should_stop
        if done % ckpt_every == 0 or stop:
            data_state = (data_iter.get_state()
                          if hasattr(data_iter, "get_state") else None)
            mgr.save(done, {"state": state, "data": data_state})
        if stop:
            mgr.wait()      # the preemption checkpoint must land on disk
            log.warning("preemption requested — checkpoint written, exiting")
            break
    mgr.wait()
    if model.runtime.offloads:
        log.info("memory traffic: %s", model.runtime.traffic_summary())
    if mgr.runtime is not None:
        log.info("checkpoint traffic: %s", mgr.runtime.traffic_summary())
    if chaos is not None:
        log.info("chaos events fired: %s", chaos.summary())
    return state, metrics
