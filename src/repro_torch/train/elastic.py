"""Elastic recovery: rebuild and resume after losing a stage.

The restart primitive everything in ``train/fault.py`` reduces to, made
available *mid-run*: when the chaos harness (or a real failure surfaced as
:class:`~repro_torch.train.chaos.StageLostError`) drops a stage, the
:class:`ElasticController`

  1. waits out any in-flight async snapshot,
  2. rebuilds the model through :func:`~repro_torch.models.model.build_model`
     on the same device (an unpipelined run has one stage: it survives
     as itself),
  3. restores the newest validating snapshot from the checkpoint tier
     (corrupt snapshots are CRC-skipped) and rewinds the data stream to
     the restored step,
  4. hands ``(model, state, start_step)`` back to the loop, which rebuilds
     its step function and replays forward.

Steps replayed after a restore recompute the same batches (the stream is
a pure function of ``(seed, step)``), so the resumed curve is
bit-identical.  The reference's pipelined branch (shrink the stage mesh,
replan ``n_micro`` through ``plan_memory``) waits for the pipeline's port
(ROADMAP A9) and raises ``NotImplementedError`` here.
"""
from __future__ import annotations

import logging
from typing import Tuple

log = logging.getLogger(__name__)


class ElasticController:
    """Owns the run description + checkpoint manager needed to rebuild.

    run: the :class:`~repro_torch.configs.base.RunConfig` of the model.
    mgr: the :class:`~repro_torch.train.checkpoint.CheckpointManager` to
    restore through (its runtime meters the ``ckpt_load`` traffic).
    device: where the rebuilt model lives.
    """

    def __init__(self, run, mgr, device="cuda"):
        self.run = run
        self.mgr = mgr
        self.device = device
        self.recoveries = 0

    # ------------------------------------------------------------------
    def surviving_stages(self, lost_stage: int) -> int:
        pipe = self.run.pipeline
        s_old = pipe.n_stages if pipe.enabled else 1
        return max(1, s_old - 1)

    def _shrink_pipe_mesh(self, s_new: int, lost_stage: int):
        raise NotImplementedError(
            "elastic recovery of a pipelined run (shrinking the stage mesh "
            "and replanning n_micro) waits for the pipeline's port "
            "(ROADMAP A9)")

    def recover(self, tc, data_iter, lost_stage: int
                ) -> Tuple[object, object, int]:
        """Rebuild and restore from the checkpoint tier.  Returns
        ``(model, state, start_step)``; the caller rebuilds its step
        function against the new model."""
        from repro_torch.models.model import build_model
        from repro_torch.train.checkpoint import to_device
        from repro_torch.train.train_state import init_state, state_template

        self.mgr.wait()
        if self.run.pipeline.enabled:
            self._shrink_pipe_mesh(self.surviving_stages(lost_stage),
                                   lost_stage)
        log.warning("elastic: lost stage %d -> rebuilding the unpipelined "
                    "model", lost_stage)
        model = build_model(self.run, device=self.device)
        restored = self.mgr.restore_latest()
        if restored is None:
            log.warning("elastic: no validating checkpoint — restarting "
                        "from initialization")
            state, start_step = init_state(model, tc), 0
        else:
            start_step, payload = restored
            state = to_device(payload["state"], state_template(model, tc),
                              model.device)
            log.info("elastic: restored step %d from %s", start_step,
                     self.mgr.runtime.tier.describe()
                     if self.mgr.runtime else "local files")
        if hasattr(data_iter, "set_state"):
            if restored is not None and (restored[1].get("data") or None):
                data_iter.set_state(restored[1]["data"])
            elif hasattr(data_iter, "get_state"):
                ds = dict(data_iter.get_state())
                ds["step"] = start_step
                data_iter.set_state(ds)
        self.recoveries += 1
        return model, state, start_step
