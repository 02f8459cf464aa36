"""Fault tolerance: preemption handling, auto-resume, straggler mitigation.

The reference's ``repro/train/fault.py``, framework-free (DESIGN.md §5):

* **Preemption / node failure**: SIGTERM (the cloud preemption signal) sets
  a stop flag; the training loop checkpoints at the next step boundary and
  exits 0.  On restart, ``CheckpointManager.restore_latest`` + reshard-on-
  load resume bit-exact (data-pipeline state is in the checkpoint), on the
  *same or a different* mesh — losing a pod means restarting on the
  remaining ones with the identical checkpoint (elastic scaling).

* **Straggler mitigation**: ``StragglerMonitor`` keeps a rolling step-time
  median; a step slower than ``threshold x median`` is flagged.  In a
  multi-pod deployment the flag feeds the synchronous-with-backup policy:
  the launcher (launch/train.py) holds hot-spare hosts, and a persistently
  flagged host is replaced at the next checkpoint boundary — this is a
  *coordination* policy, so the in-process component is detection + the
  decision callback; the replace itself is the restart path above (which is
  why restart-with-reshard is the primitive everything reduces to).

* **In-step retries**: ``retry_step`` re-executes the step function.  The
  port's step updates parameters and moments in place, so a retry is exact
  for a failure raised before the step writes anything (the chaos
  harness's ``kill`` raises before it runs); one raised mid-update goes
  through the restart-from-checkpoint path instead.
"""
from __future__ import annotations

import logging
import signal
import statistics
import time
from typing import Callable, List, Optional

log = logging.getLogger(__name__)


class FaultHandler:
    """SIGTERM/SIGINT-safe stop flag + straggler detection."""

    def __init__(self, straggler_threshold: float = 3.0,
                 window: int = 50,
                 on_straggler: Optional[Callable[[float, float], None]] = None,
                 install_signals: bool = True):
        self.should_stop = False
        self.monitor = StragglerMonitor(straggler_threshold, window,
                                        on_straggler)
        self._prev = {}
        if install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except ValueError:      # non-main thread (tests)
                    pass

    def _handle(self, signum, frame):
        log.warning("signal %s received — requesting clean stop", signum)
        self.should_stop = True

    def observe_step(self, seconds: float) -> bool:
        return self.monitor.observe(seconds)

    def uninstall(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 50,
                 on_straggler: Optional[Callable[[float, float], None]] = None):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.times: List[float] = []
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 10:
            med = statistics.median(self.times[-self.window:])
            if seconds > self.threshold * med:
                is_straggler = True
                self.flagged += 1
                log.warning("straggler step: %.1f ms vs median %.1f ms",
                            1e3 * seconds, 1e3 * med)
                if self.on_straggler:
                    self.on_straggler(seconds, med)
        self.times.append(seconds)
        if len(self.times) > 4 * self.window:
            self.times = self.times[-2 * self.window:]
        return is_straggler


def retry_step(step_fn, state, batch, retries: int = 2, backoff: float = 0.5,
               sleep=time.sleep):
    """Execute a train step with retry: ``state`` is replaced only by the
    successful result (exact for failures raised before the step writes).

    The terminal failure raises immediately: no backoff sleep after the
    last attempt (it used to waste ``backoff * 2**retries`` seconds on
    every step that was going to raise anyway).  ``sleep`` is injectable
    for tests with a fake clock.
    """
    err = None
    for attempt in range(retries + 1):
        try:
            return step_fn(state, batch)
        except Exception as e:          # noqa: BLE001 — surface after retries
            err = e
            log.warning("step failed (attempt %d/%d): %s",
                        attempt + 1, retries + 1, e)
            if attempt < retries:
                sleep(backoff * (2 ** attempt))
    raise err
