"""Deterministic fault-injection harness for the elastic training stack.

A chaos schedule is a seeded, declarative list of fault events that drive
``train/fault.py``'s retry/SIGTERM paths and ``train/elastic.py``'s
replan-on-stage-loss **in-process** — no containers to kill, every failure
reproducible from ``(spec, seed)``:

  ``kill@K``         the train step at step K raises a
                     :class:`TransientCollectiveError` on its first
                     ``arg`` attempts (default 1) — exercised by
                     ``retry_step``; the retry recomputes the same
                     functional step, so the loss curve is unchanged.
  ``preempt@K``      SIGTERM before step K: delivered as a real signal
                     when the ``FaultHandler`` installed handlers (the
                     launch path), else via its handler directly (tests).
                     The loop checkpoints at the boundary and exits 0.
  ``corrupt@K``      after the first checkpoint committed at/after step
                     K, flip bytes in one snapshot shard (seeded choice
                     unless ``arg`` pins the shard index).  The next
                     ``restore_latest`` must CRC-reject it and fall back.
  ``stage_loss@K``   before step K, raise :class:`StageLostError` (stage
                     index ``arg``): the loop hands it to the
                     ``ElasticController``, which rebuilds the model and
                     restores from the checkpoint tier.

Spec grammar: ``"kill@3,corrupt@5,stage_loss@7:1,preempt@9"`` — comma
separated ``kind@step[:arg]``.  :meth:`ChaosSchedule.random` draws a
schedule from per-kind rates with a seeded RNG instead.

Injected failures raise *before* the step runs, so the parameters and
moments it updates in place are untouched and a retry recomputes the same
step exactly (a real fault mid-update would instead surface through the
restart-from-checkpoint path, which ``preempt`` + ``corrupt`` cover).
On one device a ``stage_loss`` rebuilds the same unpipelined model and
restores (``train/elastic.py``); dropping a pipeline stage waits for the
pipeline's port.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import random
import signal
from typing import Dict, List, Optional

log = logging.getLogger(__name__)


class TransientCollectiveError(RuntimeError):
    """An injected transient step failure (a failed collective's
    analogue); ``retry_step`` absorbs it."""


class StageLostError(RuntimeError):
    """A pipeline stage dropped out mid-run."""

    def __init__(self, stage: int):
        super().__init__(f"pipeline stage {stage} lost")
        self.stage = stage


@dataclasses.dataclass
class ChaosEvent:
    step: int
    kind: str                    # kill | preempt | corrupt | stage_loss
    arg: int = -1                # kill: failed attempts (-1 -> 1);
    #                              stage_loss: stage idx (-1 -> last);
    #                              corrupt: shard idx (-1 -> seeded)
    fired: bool = False


KINDS = ("kill", "preempt", "corrupt", "stage_loss")


@dataclasses.dataclass
class ChaosSchedule:
    events: List[ChaosEvent]

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """``"kill@3,corrupt@5,stage_loss@7:1"`` -> schedule."""
        events = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            kind, _, rest = part.partition("@")
            if kind not in KINDS:
                raise ValueError(f"unknown chaos kind {kind!r} "
                                 f"(one of {KINDS}) in {spec!r}")
            step_s, _, arg_s = rest.partition(":")
            try:
                step = int(step_s)
                arg = int(arg_s) if arg_s else -1
            except ValueError:
                raise ValueError(f"bad chaos event {part!r} in {spec!r}")
            events.append(ChaosEvent(step=step, kind=kind, arg=arg))
        return cls(sorted(events, key=lambda e: e.step))

    @classmethod
    def random(cls, seed: int, n_steps: int,
               rates: Optional[Dict[str, float]] = None) -> "ChaosSchedule":
        """Draw a schedule from per-kind per-step probabilities with a
        seeded RNG — same ``(seed, n_steps, rates)`` -> same schedule."""
        rng = random.Random(seed)
        rates = rates or {"kill": 0.05, "preempt": 0.0,
                          "corrupt": 0.02, "stage_loss": 0.01}
        events = []
        for step in range(n_steps):
            for kind in KINDS:
                if rng.random() < rates.get(kind, 0.0):
                    events.append(ChaosEvent(step=step, kind=kind))
        return cls(events)

    def spec(self) -> str:
        return ",".join(f"{e.kind}@{e.step}" +
                        (f":{e.arg}" if e.arg >= 0 else "")
                        for e in self.events)


class ChaosMonkey:
    """Executes a :class:`ChaosSchedule` against the training loop.

    The loop calls three hooks: :meth:`before_step` (may raise
    :class:`StageLostError` or request preemption), :meth:`wrap_step`
    (arms kill events against the step), and :meth:`after_save`
    (corrupts a committed snapshot shard).  ``fired`` records every event
    actually delivered, for tests and the exit log.
    """

    def __init__(self, schedule: ChaosSchedule, seed: int = 0,
                 retries: int = 2, backoff: float = 0.0):
        self.schedule = schedule
        self.rng = random.Random(seed)
        self.retries = retries          # loop-side retry_step budget
        self.backoff = backoff
        self.fired: List[str] = []
        self._kill_remaining: Dict[int, int] = {}
        for e in schedule.events:
            if e.kind == "kill":
                self._kill_remaining[e.step] = max(1, e.arg)

    # ------------------------------------------------------------------
    def before_step(self, step_idx: int, fault_handler=None) -> None:
        for e in self.schedule.events:
            if e.fired or e.step != step_idx:
                continue
            if e.kind == "stage_loss":
                e.fired = True
                stage = e.arg   # -1 -> resolved by the elastic controller
                self.fired.append(f"stage_loss@{step_idx}")
                log.warning("chaos: dropping pipeline stage %d before "
                            "step %d", stage, step_idx)
                raise StageLostError(stage)
            if e.kind == "preempt":
                e.fired = True
                self.fired.append(f"preempt@{step_idx}")
                log.warning("chaos: preempting before step %d", step_idx)
                if fault_handler is not None and \
                        getattr(fault_handler, "_prev", None):
                    os.kill(os.getpid(), signal.SIGTERM)
                elif fault_handler is not None:
                    fault_handler._handle(signal.SIGTERM, None)

    def wrap_step(self, step_fn, step_idx: int):
        """Arm the kill events for this step: the wrapped step raises a
        :class:`TransientCollectiveError` on its first ``arg`` attempts
        (before the step runs, so nothing is updated), then passes
        through."""
        if self._kill_remaining.get(step_idx, 0) <= 0:
            return step_fn

        def wrapped(state, batch):
            if self._kill_remaining.get(step_idx, 0) > 0:
                self._kill_remaining[step_idx] -= 1
                self.fired.append(f"kill@{step_idx}")
                raise TransientCollectiveError(
                    f"injected collective failure at step {step_idx}")
            return step_fn(state, batch)
        return wrapped

    def after_save(self, step: int, path: str) -> None:
        """Corrupt one shard of the checkpoint just committed at ``path``
        when a pending ``corrupt`` event is due (event step <= saved
        step).  Usable directly as ``CheckpointManager.on_commit``."""
        for e in self.schedule.events:
            if e.fired or e.kind != "corrupt" or e.step > step:
                continue
            e.fired = True
            def shard_index(name):      # arrays.npz is shard 0, arrays.N.npz is N
                parts = name.split(".")
                return int(parts[1]) if len(parts) == 3 else 0
            shards = sorted((n for n in os.listdir(path)
                             if n.startswith("arrays") and n.endswith(".npz")),
                            key=shard_index)
            if not shards:
                continue
            target = shards[e.arg % len(shards)] if e.arg >= 0 \
                else self.rng.choice(shards)
            fpath = os.path.join(path, target)
            size = os.path.getsize(fpath)
            offset = self.rng.randrange(max(1, size))
            with open(fpath, "r+b") as f:
                f.seek(offset)
                b = f.read(1)
                f.seek(offset)
                f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
            self.fired.append(f"corrupt@{step}:{target}")
            log.warning("chaos: corrupted %s byte %d of checkpoint %s",
                        target, offset, path)

    def summary(self) -> str:
        return ",".join(self.fired) or "none"
