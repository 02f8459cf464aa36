"""Event-driven timeline simulator — the paper's evaluation methodology
(§IV): fixed-bandwidth memory channels, coarse-grained bulk DMA transfers,
double-buffered overlap of compute / synchronization / virtualization.

Three concurrent engines per device, as in the paper's system model:
  * the compute engine (PE array; time = max(FLOP-limited, HBM-limited)),
  * the DMA engine driving stash/prefetch to the backing store
    (host over PCIe for DC/HC, memory-nodes over the ring for MC),
  * the communication engine running ring collectives for DP/MP sync.

The forward pass stashes each layer's input feature map after its last use
(double-buffered: compute may run ahead of the DMA queue by one layer —
vDNN's memory-overlaying window); the backward pass prefetches one layer
ahead.  Cheap layers are recomputed, not stashed (footnote 4 — already
folded into the workload DAGs).

Outputs reproduce the paper's figures: the Fig. 11 latency breakdown (raw
per-category sums), Fig. 12 CPU-bandwidth usage, Fig. 13 speedups, Fig. 14
batch sensitivity, and §V-D scalability.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch import hw
from repro_torch.core.dag import LayerDAG
from repro_torch.sim.topology import SystemConfig

PE_EFFICIENCY = 0.5          # achievable fraction of peak on dense GEMM/conv


@dataclasses.dataclass
class StepResult:
    total: float                 # end-to-end iteration time (s)
    compute: float               # raw compute latency (Fig 11 category a)
    sync: float                  # raw synchronization latency (b)
    virt: float                  # raw virtualization latency (c)
    virt_bytes: float            # bytes moved to/from backing store
    cpu_bw_frac: float           # fraction of host memory BW consumed

    @property
    def breakdown(self) -> Tuple[float, float, float]:
        return (self.compute, self.sync, self.virt)


def _compute_time(flops: float, bytes_touched: float,
                  sys: SystemConfig) -> float:
    dev = sys.device
    return max(flops / (dev.peak_flops * PE_EFFICIENCY),
               bytes_touched / dev.hbm_bw)


def simulate(dag: LayerDAG, sys: SystemConfig, parallel: str = "dp",
             n_devices: int = None, virtualize: bool = True) -> StepResult:
    """One training iteration of `dag` on `sys` under dp/mp parallelism."""
    n = n_devices or sys.n_devices
    tier = sys.backing_tier          # DC/HC/MC as tier configurations
    virt_bw = tier.effective_bw(n, sys.n_sockets)
    L = dag.num_layers
    layers = dag.layers

    # per-device shares
    def c_fwd(i):
        f = layers[i].flops_fwd / n
        by = (layers[i].saved_bytes + layers[i].weight_bytes) / n * 2
        return _compute_time(f, by, sys)

    def c_bwd(i):
        return 2.0 * c_fwd(i)

    def stash_bytes(i):
        return layers[i].saved_bytes / n if virtualize and not tier.is_oracle \
            else 0.0

    # ---------------- forward ----------------
    t = 0.0                      # compute engine clock
    dma = 0.0                    # DMA engine clock
    comm = 0.0                   # comm engine clock
    stash_done = [0.0] * L
    raw_virt = 0.0
    raw_sync = 0.0
    raw_compute = 0.0

    for i in range(L):
        # vDNN window: layer i's compute waits for layer i-2's stash
        if i >= 2 and stash_bytes(i - 2) > 0:
            t = max(t, stash_done[i - 2])
        ct = c_fwd(i)
        raw_compute += ct
        t += ct
        if parallel == "mp" and layers[i].fc and n > 1:
            # Krizhevsky one-weird-trick MP: only FC/recurrent layers are
            # feature-split; all-gather the FULL feature map before the
            # next layer (blocking data dependency)
            ag = sys.allgather_time(layers[i].saved_bytes)
            raw_sync += ag
            t += ag
        sb = stash_bytes(i)
        if sb > 0:
            dma = max(dma, t) + sb / virt_bw
            stash_done[i] = dma
            raw_virt += sb / virt_bw

    # ---------------- backward ----------------
    fetch_done = [0.0] * L
    # prefetch pipeline primed with the last layer's X
    if stash_bytes(L - 1) > 0:
        dma = max(dma, t)
        dma += stash_bytes(L - 1) / virt_bw
        fetch_done[L - 1] = dma
        raw_virt += stash_bytes(L - 1) / virt_bw

    for i in range(L - 1, -1, -1):
        # prefetch one ahead (layer i-1) as soon as bwd of layer i starts
        if i >= 1 and stash_bytes(i - 1) > 0:
            dma = max(dma, t) + stash_bytes(i - 1) / virt_bw
            fetch_done[i - 1] = dma
            raw_virt += stash_bytes(i - 1) / virt_bw
        if stash_bytes(i) > 0:
            t = max(t, fetch_done[i])
        ct = c_bwd(i)
        raw_compute += ct
        t += ct
        if n == 1:
            pass                                  # single device: no sync
        elif parallel == "mp" and layers[i].fc:
            # dX partial sums (each device holds dX of the FULL input of its
            # feature shard) must reduce before layer i-1's backward; the
            # split weights need no dW sync.
            ar = sys.allreduce_time(layers[i].saved_bytes)
            raw_sync += ar
            t += ar
        elif layers[i].weight_bytes > 0:
            # data-parallel layers (all of DP mode; conv layers of MP mode):
            # dW all-reduce, overlapped with the remaining backward
            ar = sys.allreduce_time(layers[i].weight_bytes)
            raw_sync += ar
            comm = max(comm, t) + ar

    total = max(t, comm, dma)
    cpu_frac = 0.0
    if tier.uses_cpu and total > 0:
        moved = sum(stash_bytes(i) for i in range(L)) * 2 * n
        cpu_frac = (moved / total) / (sys.cpu_socket_bw * sys.n_sockets)
    return StepResult(total=total, compute=raw_compute, sync=raw_sync,
                      virt=raw_virt, virt_bytes=sum(
                          stash_bytes(i) for i in range(L)) * 2 * n,
                      cpu_bw_frac=cpu_frac)


# ---------------------------------------------------------------------------
def simulate_pipeline(dag: LayerDAG, sys: SystemConfig, n_stages: int,
                      n_micro: int, schedule: str = "1f1b",
                      virtualize: bool = True) -> StepResult:
    """Pipeline-parallel iteration over the paper's system design points.

    The layer DAG splits into ``n_stages`` contiguous stages over device
    groups of ``n_devices / n_stages``; ``n_micro`` microbatches stream
    through in T = M + S - 1 ticks (tick = the slowest stage's
    fwd + bwd per microbatch, bubble = (S-1) ticks).  Under ``1f1b`` each
    stage's saved microbatch inputs stream through the system's
    virtualization backing store — the pipeline-stage tier expressed in
    the DC/HC/MC ``TierSpec`` vocabulary — and a stage stalls when its
    per-microbatch DMA exceeds the tick; ``gpipe`` keeps activations
    resident (zero virtualization traffic, the whole cost is the bubble).
    """
    S, M = max(1, n_stages), max(1, n_micro)
    tier = sys.backing_tier
    stash = schedule == "1f1b" and virtualize and not tier.is_oracle
    per_stage = max(1, sys.n_devices // S)
    virt_bw = tier.effective_bw(per_stage, sys.n_sockets)
    L = dag.num_layers
    bounds = [round(s * L / S) for s in range(S + 1)]

    def stage_time(s: int) -> float:
        t = 0.0
        for l in dag.layers[bounds[s]:bounds[s + 1]]:
            f = l.flops_fwd / (M * per_stage)
            by = (l.saved_bytes + l.weight_bytes) / (M * per_stage) * 2
            t += 3.0 * _compute_time(f, by, sys)       # fwd + 2x bwd
        return t

    def stage_bytes(s: int) -> float:
        return sum(l.saved_bytes for l in dag.layers[bounds[s]:bounds[s + 1]]
                   if not l.cheap) / (M * per_stage)

    tick = max(stage_time(s) for s in range(S))
    bubble = (S - 1) * tick
    compute = M * sum(stage_time(s) for s in range(S))
    virt = 0.0
    stall = 0.0
    moved = 0.0
    if stash:
        for s in range(S):
            dma = 2.0 * stage_bytes(s) / virt_bw       # stash + fetch
            virt += M * dma
            stall += M * max(0.0, dma - tick)
            moved += 2.0 * stage_bytes(s) * M * per_stage
    total = (M + S - 1) * tick + stall
    cpu_frac = 0.0
    if tier.uses_cpu and total > 0 and moved > 0:
        cpu_frac = (moved / total) / (sys.cpu_socket_bw * sys.n_sockets)
    return StepResult(total=total, compute=compute, sync=bubble, virt=virt,
                      virt_bytes=moved, cpu_bw_frac=cpu_frac)


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CheckpointCost:
    system: str
    tier_kind: str               # device | host | pooled
    every: int                   # cadence (steps between snapshots)
    snapshot_bytes: float        # global bytes of one snapshot
    step_s: float                # simulated iteration time
    save_s: float                # one snapshot drain through the tier
    overhead_s: float            # amortized unhidden save, per step
    lost_s: float                # expected replay loss, per step
    async_saves: bool

    @property
    def total_s(self) -> float:
        return self.overhead_s + self.lost_s

    @property
    def overhead_frac(self) -> float:
        return self.total_s / self.step_s if self.step_s > 0 else 0.0


def simulate_checkpoint(dag: LayerDAG, sys: SystemConfig,
                        state_bytes: float, *,
                        every: int = 0, async_saves: bool = False,
                        mtbf_steps: int = 10_000,
                        parallel: str = "dp") -> CheckpointCost:
    """Snapshot-cost model over a system design point's backing tier.

    The snapshot (params + optimizer moments, sharded over the devices)
    drains through the same DC/HC/MC ``TierSpec`` the virtualization
    traffic uses — a checkpoint is cold pooled state riding the identical
    channel, so its cost obeys the same bandwidth-contention law
    (``effective_bw`` divides the host/pool bandwidth across concurrent
    devices).  ``every=0`` sweeps the Young-Daly cadence grid against the
    *simulated* step time and keeps the minimizer of amortized unhidden
    save + expected replay; async saves hide up to ``every . step`` of
    the drain behind the next steps.  The oracle design point snapshots
    HBM-to-HBM (nothing crosses a wire).
    """
    from repro_torch.core.policy import CADENCE_CANDIDATES
    step = simulate(dag, sys, parallel).total
    tier = sys.backing_tier
    n = max(1, sys.n_devices)
    if tier.is_oracle:
        bw = sys.device.hbm_bw
    else:
        bw = tier.effective_bw(n, sys.n_sockets)
    save_s = (state_bytes / n) / bw if bw > 0 else 0.0
    cands = [every] if every > 0 else list(CADENCE_CANDIDATES)
    best = None
    for k in cands:
        unhidden = max(0.0, save_s - k * step) if async_saves else save_s
        overhead = unhidden / k
        lost = (k / 2.0) * step / max(mtbf_steps, 1)
        if best is None or overhead + lost < best[1] + best[2]:
            best = (k, overhead, lost)
    k, overhead, lost = best
    return CheckpointCost(system=sys.name, tier_kind=tier.kind, every=k,
                          snapshot_bytes=state_bytes, step_s=step,
                          save_s=save_s, overhead_s=overhead, lost_s=lost,
                          async_saves=async_saves)


def checkpoint_table(workloads: Dict[str, LayerDAG], systems,
                     state_bytes_of, *, mtbf_steps: int = 10_000,
                     async_saves: bool = True
                     ) -> Dict[str, Dict[str, CheckpointCost]]:
    """Per-workload checkpoint overhead across the system design points
    (the fault-tolerance analogue of :func:`speedup_table`).
    ``state_bytes_of``: workload name -> snapshot bytes."""
    out: Dict[str, Dict[str, CheckpointCost]] = {}
    for wname, dag in workloads.items():
        out[wname] = {}
        for s in systems:
            out[wname][s.name] = simulate_checkpoint(
                dag, s, state_bytes_of(wname), mtbf_steps=mtbf_steps,
                async_saves=async_saves)
    return out


# ---------------------------------------------------------------------------
def speedup_table(workloads: Dict[str, LayerDAG], systems,
                  parallel: str = "dp", baseline: str = "DC-DLA"
                  ) -> Dict[str, Dict[str, float]]:
    """Fig 13: per-workload speedup of every system over the baseline."""
    out: Dict[str, Dict[str, float]] = {}
    for wname, dag in workloads.items():
        base = simulate(dag, [s for s in systems
                              if s.name == baseline][0], parallel).total
        out[wname] = {}
        for s in systems:
            r = simulate(dag, s, parallel)
            out[wname][s.name] = base / r.total
    return out


def harmonic_mean(xs: List[float]) -> float:
    return len(xs) / sum(1.0 / x for x in xs)


# ---------------------------------------------------------------------------
# Cluster serving model: the synthetic traffic of
# sim/workloads.generate_traffic evaluated analytically against DC/HC/MC
# tier configurations — the same placement policies the real Router runs,
# at a session count no single host can replay.


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Per-token costs of the served model (decoder-only defaults sized
    like a 7B at bf16)."""

    flops_per_token: float = 2.0 * 7e9       # 2 * params per token
    weight_bytes: float = 14e9               # resident weights (bf16)
    kv_bytes_per_token: float = 524_288.0    # 32 layers x 2 x 4096 x bf16

    def kv_bytes(self, tokens: int) -> float:
        return self.kv_bytes_per_token * tokens


@dataclasses.dataclass
class ServingReport:
    """What one (trace, system, policy) evaluation produced."""

    policy: str
    system: str
    engines: int
    sessions: int
    finished: int
    tok_per_s: float
    ttft_mean_s: float
    ttft_p99_s: float
    slo_miss_rate: float
    mean_engine_util: float

    def rows(self):
        """Benchmark rows (name, value, note) for BENCH_router.json."""
        tag = f"{self.system}/{self.policy}"
        return [
            (f"{tag}/tok_per_s", self.tok_per_s,
             f"{self.engines} engines, {self.sessions} sessions"),
            (f"{tag}/ttft_mean_ms", self.ttft_mean_s * 1e3, "analytic"),
            (f"{tag}/ttft_p99_ms", self.ttft_p99_s * 1e3, "analytic"),
            (f"{tag}/slo_miss_rate", self.slo_miss_rate,
             "deadline classes only"),
            (f"{tag}/engine_util", self.mean_engine_util, "busy fraction"),
        ]


def simulate_serving(trace, sys: SystemConfig, *,
                     engines: int = 8,
                     placement: str = "least_loaded",
                     model: ModelProfile = ModelProfile(),
                     decode_slots: int = 16,
                     prefix_len: int = 8,
                     wire_streams: Optional[int] = None) -> ServingReport:
    """Session-level analytic replay of a synthetic trace.

    Each engine is a disaggregated pair abstracted to three resources,
    priced exactly as the step simulator prices layers: a serial prefill
    server (``max(FLOP-limited, HBM-limited)`` over the prompt), the KV
    handoff over the system's backing tier (``effective_bw`` under
    concurrent streamers, plus one DCN hop of latency — the wire), and
    ``decode_slots`` decode lanes whose per-token time is HBM-bound with
    the weight read amortized across resident lanes.  Placement reuses
    the REAL registry from serve/router.py (EngineView duck-typing), so
    the policy evaluated here is the policy the live cluster runs.

    O(N log N) in sessions: one pass in arrival order with per-engine
    finish-time heaps — a million-session day evaluates in seconds.
    """
    import heapq

    from repro_torch.serve.router import EngineView, build_placement

    dev = sys.device
    tier = sys.backing_tier
    # every engine's handoff leg streams concurrently in the worst case;
    # the leg itself is wire_streams parallel connections, so the stripe
    # count is a third cap alongside the tier and the DCN link
    streams = sys.wire_streams if wire_streams is None else wire_streams
    handoff_bw = min(tier.effective_bw(engines, sys.n_sockets), hw.DCN_BW,
                     max(1, streams) * sys.wire_stream_bw)

    policy = build_placement(placement, **(
        {"prefix_len": prefix_len} if placement == "prefix_affinity" else {}))

    class _Probe:
        """Duck-types the Session surface placement policies touch."""

        class _Req:
            __slots__ = ("prompt",)

        def __init__(self, s):
            self.request = _Probe._Req()
            self.request.prompt = list(range(
                s.prefix_id * 1000, s.prefix_id * 1000 + prefix_len)) \
                if s.prefix_id is not None else [s.uid]

    prefill_free = [0.0] * engines
    decode_free = [[0.0] * decode_slots for _ in range(engines)]
    busy_s = [0.0] * engines
    inflight = [[] for _ in range(engines)]     # finish-time heaps
    window = decode_slots * 4                   # router-style backlog bound

    ttfts: List[float] = []
    missed = met = 0
    total_tokens = 0
    t_end = 0.0

    for s in sorted(trace, key=lambda x: (x.arrival, x.uid)):
        now = s.arrival
        for h in inflight:
            while h and h[0] <= now:
                heapq.heappop(h)
        views = [EngineView(i, len(inflight[i]),
                            window - len(inflight[i]))
                 for i in range(engines)]
        idx = policy.choose(views, _Probe(s))

        p_time = _compute_time(s.prompt_len * model.flops_per_token,
                               model.weight_bytes +
                               model.kv_bytes(s.prompt_len), sys)
        p_start = max(now, prefill_free[idx])
        p_end = p_start + p_time
        prefill_free[idx] = p_end

        handoff = model.kv_bytes(s.prompt_len) / handoff_bw \
            + hw.DCN_LATENCY_S

        lanes = decode_free[idx]
        lane = min(range(decode_slots), key=lanes.__getitem__)
        mid_len = s.prompt_len + s.decode_len / 2.0
        tok_time = max(
            model.flops_per_token / (dev.peak_flops * PE_EFFICIENCY),
            (model.weight_bytes / decode_slots +
             model.kv_bytes(int(mid_len))) / dev.hbm_bw)
        d_start = max(p_end + handoff, lanes[lane])
        first_tok = d_start + tok_time
        d_end = d_start + s.decode_len * tok_time
        lanes[lane] = d_end

        ttfts.append(first_tok - now)
        busy_s[idx] += p_time + s.decode_len * tok_time
        heapq.heappush(inflight[idx], d_end)
        total_tokens += s.decode_len
        t_end = max(t_end, d_end)

        if math.isfinite(s.slack_steps):
            deadline = now + s.slack_steps * tok_time
            if d_end <= deadline:
                met += 1
            else:
                missed += 1

    ttfts.sort()
    n = len(ttfts)
    span = max(t_end - min(s.arrival for s in trace), 1e-9) if trace else 1.0
    return ServingReport(
        policy=getattr(policy, "name", str(placement)),
        system=sys.name,
        engines=engines,
        sessions=len(trace),
        finished=n,
        tok_per_s=total_tokens / span,
        ttft_mean_s=sum(ttfts) / n if n else 0.0,
        ttft_p99_s=ttfts[min(n - 1, int(0.99 * n))] if n else 0.0,
        slo_miss_rate=missed / (met + missed) if (met + missed) else 0.0,
        mean_engine_util=sum(busy_s) / (engines * span),
    )


def serving_table(trace, systems, *, policies=("least_loaded",
                                               "prefix_affinity",
                                               "round_robin"),
                  engines: int = 8, **kwargs) -> List[ServingReport]:
    """The policy x system sweep behind BENCH_router.json."""
    return [simulate_serving(trace, sys, engines=engines,
                             placement=pol, **kwargs)
            for sys in systems for pol in policies]
