"""The checkpoint cadence planner — the part of the reference's
KEEP / POOL / RECOMPUTE cost model (``repro/core/policy.py``) that the
checkpoint tier needs.

:func:`plan_checkpoint` costs a save cadence through the
:class:`~repro_torch.core.tiers.MemoryTier` contract: ``tier.bandwidth()``
prices the drain and ``tier.payload_ratio()`` the snapshot's bytes, so a
new backing store or codec is priced without touching this module.  The
chip is an argument (the H100 by default; the reference's is the TPU v5e).
``plan_memory``, which gives ``--policy auto`` and the planner-chosen
cadence from its analytic step time, needs ``core/dag.py`` and is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch import hw
from repro_torch.configs.base import MeshPlan
from repro_torch.core.tiers import MemoryTier


@dataclasses.dataclass(frozen=True)
class CheckpointDecision:
    """The planner's cadence verdict for the checkpoint tier.

    Per-step cost = ``overhead_s`` (unhidden save time amortized over the
    cadence) + ``lost_s`` (expected replay: a failure loses every/2 steps
    on average, paid at rate 1/mtbf_steps).  ``every = 0`` sweeps
    candidates and keeps the minimizer — the discrete Young–Daly optimum
    ``sqrt(2 · MTBF · save_time)`` against the actual step time.
    """

    tier: str
    every: int                   # chosen save cadence (steps)
    snapshot_bytes: float        # wire bytes of one snapshot
    save_s: float                # one snapshot through the tier
    overhead_s: float            # amortized unhidden save time per step
    lost_s: float                # expected replay time per step
    async_saves: bool = False

    @property
    def total_s(self) -> float:
        return self.overhead_s + self.lost_s


# checkpoint cadence sweep when CheckpointPlan.every == 0: a coarse
# logarithmic grid — the Young–Daly optimum is flat around its minimum, so
# a grid hit within ~2x of sqrt(2·MTBF·save_s) costs almost nothing extra.
CADENCE_CANDIDATES: Sequence[int] = (1, 2, 5, 10, 25, 50, 100, 250, 500,
                                     1000)


def plan_checkpoint(state_bytes: float, step_time_s: float,
                    tier: MemoryTier, plan: MeshPlan,
                    chip: hw.Chip = hw.H100, *,
                    every: int = 0, async_saves: bool = False,
                    mtbf_steps: int = 10_000,
                    candidates: Optional[Sequence[int]] = None
                    ) -> CheckpointDecision:
    """Cost a checkpoint cadence against step time through the tier contract.

    state_bytes: global params+optimizer bytes of one snapshot (raw).
    every: force a cadence, or 0 to sweep ``candidates`` and keep the
    minimizer of amortized-save + expected-replay — the discrete form of
    Young–Daly ``sqrt(2 · MTBF · save_time)``.  Async saves hide up to
    ``every · step_time`` of the drain behind the next steps.
    """
    bw = tier.bandwidth(plan, chip)
    n_dev = max(plan.num_devices, 1)
    snap = state_bytes * tier.payload_ratio()
    save_s = snap / (bw * n_dev) if bw > 0 else 0.0
    cands = [every] if every > 0 else list(candidates or CADENCE_CANDIDATES)
    best = None
    for k in cands:
        unhidden = max(0.0, save_s - k * step_time_s) if async_saves \
            else save_s
        overhead = unhidden / k
        lost = (k / 2.0) * step_time_s / max(mtbf_steps, 1)
        if best is None or overhead + lost < best[1] + best[2]:
            best = (k, overhead, lost)
    k, overhead, lost = best
    return CheckpointDecision(tier.describe(), k, snap, save_s, overhead,
                              lost, async_saves)
