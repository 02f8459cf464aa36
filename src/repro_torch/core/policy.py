"""KEEP / POOL / RECOMPUTE planner — the cost model behind `policy="auto"`.

The paper stashes *every* layer's feature maps (to maximally stress the
interconnect, §IV) and recomputes only cheap layers (footnote 4).  That is
the faithful `policy="mcdla"` mode.  `policy="auto"` is the beyond-paper
mode: a per-layer cost model decides, under the per-device HBM budget,

  KEEP      — leave the saved tensor resident (zero traffic) while the
              budget allows;
  POOL      — stash to the backing tier; predicted stall is
              max(0, stash_time + fetch_time - overlap_window);
  RECOMPUTE — if re-running the layer forward is cheaper than the fetch
              (footnote 4 generalized by the cost model).

Decisions are taken largest-reuse-distance-first: the tensor that stays idle
longest is the best candidate to evict, and its transfer has the widest
overlap window — the same intuition the paper's memory-overlaying scheduler
uses.

The planner costs candidate placements through the
:class:`~repro_torch.core.tiers.MemoryTier` contract — ``tier.bandwidth()``
prices the transfer, ``tier.account()``/``tier.capacity()`` maintain the
boot-time memory map — so a new tier (host+pool spill, zstd codec, ...)
is priced without touching this module.

Pipeline training extends the same cost model: given a
:class:`~repro_torch.configs.base.PipelinePlan`, the reference's
:func:`plan_memory` jointly chooses ``n_micro`` and the per-stage split
against the schedule's bubble; that branch needs the pipeline schedules,
which port with ROADMAP A9, and raises until then.

The arithmetic is the reference's, line for line: given the same
:class:`~repro_torch.hw.Chip` figures and budget, a plan here equals the
reference's.  The chip defaults to the H100 (the reference's to the TPU
v5e) and the budget to ``MemoryPlan.hbm_budget_gb`` (80 GB here).  The
figures are modelled from data-sheet rates, not measured.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch import hw
from repro_torch.configs.base import MemoryPlan, MeshPlan, PipelinePlan
from repro_torch.core.dag import LayerDAG
from repro_torch.core.pool import PoolAccountant
from repro_torch.core.tiers import MemoryTier, build_ckpt_tier, build_tier

#: the device a tier is built on when it is built only to be priced
_PRICE_DEVICE = "cpu"


@dataclasses.dataclass(frozen=True)
class Decision:
    layer: int
    action: str                  # keep | pool | recompute
    saved_bytes: float           # global bytes affected
    est_stall_s: float           # predicted unhidden transfer time


@dataclasses.dataclass(frozen=True)
class PipelineDecision:
    """The planner's bubble-vs-stall verdict for one pipeline run."""

    schedule: str
    n_stages: int
    n_micro: int                 # chosen (or forced) microbatch count
    bubble_s: float              # (S-1)/(M+S-1) * step_time
    stall_s: float               # predicted unhidden stage stash/fetch time
    act_wire_bytes: float = 0.0  # stash+fetch bytes through the stage tier

    @property
    def total_s(self) -> float:
        return self.bubble_s + self.stall_s


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


@dataclasses.dataclass
class MemoryPlanReport:
    decisions: List[Decision]
    resident_bytes_per_dev: float
    pooled_bytes_per_dev: float
    budget_bytes: float
    tier: str = "pooled_hbm"
    host_bytes: float = 0.0
    pipeline: Optional[PipelineDecision] = None
    checkpoint: Optional[CheckpointDecision] = None

    @property
    def fits(self) -> bool:
        return (self.resident_bytes_per_dev + self.pooled_bytes_per_dev
                <= self.budget_bytes)

    def count(self, action: str) -> int:
        return sum(1 for d in self.decisions if d.action == action)

    def total_stall(self) -> float:
        return sum(d.est_stall_s for d in self.decisions)


def fetch_bandwidth(plan: MeshPlan, memory: MemoryPlan,
                    chip: hw.Chip = hw.H100) -> float:
    """Per-device stash/fetch bandwidth of the configured backing tier
    (through the tier registry: ``tier.bandwidth(plan, chip)``)."""
    return build_tier(memory, plan, _PRICE_DEVICE).bandwidth(plan, chip)


def micro_candidates(global_batch: int, n_stages: int,
                     cap: int = 16) -> List[int]:
    """Feasible n_micro values: divisors of the global batch (a microbatch
    must tile the batch dim) of at least ``n_stages`` — fewer microbatches
    than stages leaves stages idle most of the schedule — largest ``cap``
    of them.  Falls back to all divisors when none reach the stage count."""
    divs = [m for m in range(1, max(1, global_batch) + 1)
            if global_batch % m == 0]
    divs = [m for m in divs if m >= max(1, n_stages)] or divs
    return divs[-cap:] if len(divs) > cap else divs


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


def plan_memory(dag: LayerDAG, plan: MeshPlan, memory: MemoryPlan,
                chip: hw.Chip = hw.H100,
                model_state_bytes: float = 0.0,
                tier: Optional[MemoryTier] = None,
                pipeline: Optional[PipelinePlan] = None,
                n_micro_candidates: Optional[Sequence[int]] = None,
                checkpoint=None,
                ckpt_tier: Optional[MemoryTier] = None
                ) -> MemoryPlanReport:
    """Run the planner over a layer DAG.

    model_state_bytes: global bytes of params+optimizer state (FSDP-sharded
    over the pool, so they cost /pool_size per device).
    tier: the backing store to cost POOL decisions against; resolved from
    ``memory`` via the tier registry when not provided.  Pipeline runs pass
    the reference's ``PipelineStageTier`` here.
    pipeline: when given and enabled, the reference sweeps
    ``n_micro_candidates`` against the schedule's bubble; here that raises
    ``NotImplementedError`` until the pipeline ports (ROADMAP A9).
    checkpoint: a :class:`~repro_torch.configs.base.CheckpointPlan` — when
    given (and enabled), cost the save cadence against the planned step time
    (compute + pipeline penalty + stash stalls) through ``ckpt_tier`` (or
    the plan's :func:`~repro_torch.core.tiers.build_ckpt_tier` stack); the
    verdict lands in ``report.checkpoint``.
    """
    if tier is None:
        tier = build_tier(memory, plan, _PRICE_DEVICE)
    n_dev = plan.num_devices
    bw = tier.bandwidth(plan, chip)
    ratio = tier.payload_ratio()
    eff_flops = n_dev * chip.peak_flops

    sched = dag.schedule()
    # largest reuse distance first — best eviction victims
    order = sorted(range(len(sched)), key=lambda j: -sched[j][2])
    stash_all = tier.stash_all and tier.offloads
    per_dev_saved = [b / n_dev for (_, b, _) in sched]

    def run_pass(n_micro: int = 1, inflight_frac: float = 0.0,
                 hop_lat: float = 0.0, force_keep: bool = False):
        """One KEEP/POOL/RECOMPUTE pass.

        Non-pipelined (the defaults): one transfer per layer, hidden
        inside the reuse-distance window — exactly the original model.
        Pipelined (``n_micro > 1`` or ``hop_lat > 0``): M per-microbatch
        transfers, each paying ``hop_lat`` twice (stash+fetch over the
        stage hop) and each hiding only behind the layer's own
        per-microbatch compute — the steady-state 1F1B tick, where the
        full-step reuse window no longer exists.  ``inflight_frac`` of a
        pooled activation stays device-resident (the schedule's in-flight
        window).
        """
        acct = PoolAccountant(plan, memory)
        # state (params + moments) is pooled via FSDP
        acct.alloc_local(model_state_bytes / (acct.pool_devices
                                              if memory.pool_params else 1))
        decisions: List[Decision] = []
        # Pass 1: keep everything resident, then evict until it fits
        # (auto), or stash everything (mcdla/host — the paper's
        # stress-test policies).
        for b in per_dev_saved:
            acct.alloc_local(b)
        M = max(1, n_micro)
        pipelined = n_micro > 1 or hop_lat > 0.0
        for j in order:
            i, bytes_g, window_flops = sched[j]
            if force_keep or (not stash_all and acct.fits):
                decisions.append(Decision(i, "keep", bytes_g, 0.0))
                continue
            layer = dag.layers[i]
            # stash + fetch, per microbatch (latency paid per transfer)
            xfer_micro = (2.0 * (bytes_g * ratio) / (M * bw * n_dev)
                          + 2.0 * hop_lat)
            if pipelined:
                # steady-state tick: the transfer hides behind the layer's
                # own fwd+bwd compute for one microbatch
                window_micro = 3.0 * layer.flops_fwd / (M * eff_flops)
            else:
                window_micro = window_flops / (M * eff_flops)
            recomp = layer.flops_fwd / eff_flops
            if memory.recompute_cheap and recomp < M * xfer_micro:
                decisions.append(Decision(i, "recompute", bytes_g, 0.0))
                acct.alloc_local(-per_dev_saved[j])
            else:
                stall = M * max(0.0, xfer_micro - window_micro)
                decisions.append(Decision(i, "pool", bytes_g, stall))
                acct.alloc_local(-per_dev_saved[j] * (1.0 - inflight_frac))
                tier.account(acct, bytes_g)
        decisions.sort(key=lambda d: d.layer)
        return decisions, acct

    def attach_checkpoint(report: MemoryPlanReport) -> MemoryPlanReport:
        if checkpoint is None or not getattr(checkpoint, "enabled", False):
            return report
        ct = ckpt_tier or build_ckpt_tier(
            memory, plan, _PRICE_DEVICE, backing=checkpoint.tier,
            codec=checkpoint.codec)
        step_time = dag.total_flops() / eff_flops + report.total_stall()
        if report.pipeline is not None:
            step_time += report.pipeline.total_s
        report.checkpoint = plan_checkpoint(
            model_state_bytes, step_time, ct, plan, chip,
            every=checkpoint.every, async_saves=checkpoint.async_saves,
            mtbf_steps=checkpoint.mtbf_steps)
        return report

    if pipeline is None or not pipeline.enabled:
        decisions, acct = run_pass()
        return attach_checkpoint(
            MemoryPlanReport(decisions, acct.local_bytes,
                             acct.pooled_bytes, acct.budget,
                             tier=tier.describe(),
                             host_bytes=acct.host_bytes))

    # ---- joint n_micro x placement sweep (bubble vs stash stalls): the
    # schedules' bubble and in-flight terms are parallel/pipeline.py's
    raise NotImplementedError(
        "planning a pipelined run (the n_micro sweep over the schedule's "
        "bubble) waits for the pipeline's port (ROADMAP A9)")


def summarize(report: MemoryPlanReport) -> str:
    s = (f"tier={report.tier} "
         f"keep={report.count('keep')} pool={report.count('pool')} "
         f"recompute={report.count('recompute')} "
         f"resident={report.resident_bytes_per_dev/1e9:.2f}GB "
         f"pooled={report.pooled_bytes_per_dev/1e9:.2f}GB "
         f"budget={report.budget_bytes/1e9:.0f}GB fits={report.fits} "
         f"stall={report.total_stall()*1e3:.2f}ms")
    if report.pipeline is not None:
        p = report.pipeline
        s += (f" pipeline[{p.schedule} S={p.n_stages}] n_micro={p.n_micro} "
              f"bubble={p.bubble_s*1e3:.2f}ms stall={p.stall_s*1e3:.2f}ms "
              f"act_wire={p.act_wire_bytes/1e9:.2f}GB")
    if report.checkpoint is not None:
        c = report.checkpoint
        s += (f" ckpt[{c.tier}] every={c.every} "
              f"snap={c.snapshot_bytes/1e9:.2f}GB save={c.save_s:.2f}s "
              f"overhead={c.overhead_s*1e3:.2f}ms/step "
              f"lost={c.lost_s*1e3:.2f}ms/step"
              f"{' async' if c.async_saves else ''}")
    return s
