"""The paper's 8 benchmarks (Table III) as per-layer FLOPs/bytes DAGs, and
synthetic LLM serving traffic: the router's session feed.

4 ImageNet CNNs (AlexNet, GoogLeNet, VGG-E=VGG-19, ResNet-34) with the
published layer shapes, and 4 DeepBench-style RNNs (vanilla GEMV, 2 LSTMs,
1 GRU) with DeepBench-suite hidden sizes.  Batch 512 (paper §IV), fp32
(paper-era training precision).  Cheap layers (ReLU/pool/norm) are folded —
they are re-computed rather than stashed (paper footnote 4), as the
executable runtime recomputes a wrapped layer's intermediates.

The traffic generator draws session arrivals with the structure real
serving traffic has and uniform Poisson lacks: a diurnal intensity cycle,
bursts (correlated arrival clumps), a shared-prefix mixture (many sessions
reuse a few system prompts, which prefix-affinity placement exploits),
mixed SLO classes and a tenant mix.  A trace replays scaled down against
the real router (serve/router.py ``replay_trace``) and analytically at
full scale against DC/HC/MC TierSpecs (sim/simulator.py
``simulate_serving``).  One PRNG stream drives everything, so a spec gives
the same sessions in this package and in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.dag import LayerDAG, LayerNode

BATCH = 512
F32 = 4


def _conv(name: str, cin: int, cout: int, k: int, hout: int,
          batch: int = BATCH) -> LayerNode:
    flops = 2.0 * batch * cout * hout * hout * cin * k * k
    act = batch * cout * hout * hout * F32
    w = cout * cin * k * k * F32
    return LayerNode(name, flops_fwd=flops, saved_bytes=act, weight_bytes=w)


def _fc(name: str, din: int, dout: int, batch: int = BATCH) -> LayerNode:
    return LayerNode(name, flops_fwd=2.0 * batch * din * dout,
                     saved_bytes=batch * dout * F32,
                     weight_bytes=din * dout * F32, fc=True)


# ---------------------------------------------------------------------------
def alexnet(batch: int = BATCH) -> LayerDAG:
    return LayerDAG([
        _conv("conv1", 3, 96, 11, 55, batch),
        _conv("conv2", 96, 256, 5, 27, batch),
        _conv("conv3", 256, 384, 3, 13, batch),
        _conv("conv4", 384, 384, 3, 13, batch),
        _conv("conv5", 384, 256, 3, 13, batch),
        _fc("fc6", 9216, 4096, batch),
        _fc("fc7", 4096, 4096, batch),
        _fc("fc8", 4096, 1000, batch),
    ])


def vgg_e(batch: int = BATCH) -> LayerDAG:
    layers: List[LayerNode] = []
    spec = [(3, 64, 224), (64, 64, 224), (64, 128, 112), (128, 128, 112),
            (128, 256, 56), (256, 256, 56), (256, 256, 56), (256, 256, 56),
            (256, 512, 28), (512, 512, 28), (512, 512, 28), (512, 512, 28),
            (512, 512, 14), (512, 512, 14), (512, 512, 14), (512, 512, 14)]
    for i, (cin, cout, h) in enumerate(spec):
        layers.append(_conv(f"conv{i}", cin, cout, 3, h, batch))
    layers += [_fc("fc6", 25088, 4096, batch), _fc("fc7", 4096, 4096, batch),
               _fc("fc8", 4096, 1000, batch)]
    return LayerDAG(layers)


_INCEPTION = [
    # (cin, 1x1, 3red, 3x3, 5red, 5x5, pool, spatial)
    ("3a", 192, 64, 96, 128, 16, 32, 32, 28),
    ("3b", 256, 128, 128, 192, 32, 96, 64, 28),
    ("4a", 480, 192, 96, 208, 16, 48, 64, 14),
    ("4b", 512, 160, 112, 224, 24, 64, 64, 14),
    ("4c", 512, 128, 128, 256, 24, 64, 64, 14),
    ("4d", 512, 112, 144, 288, 32, 64, 64, 14),
    ("4e", 528, 256, 160, 320, 32, 128, 128, 14),
    ("5a", 832, 256, 160, 320, 32, 128, 128, 7),
    ("5b", 832, 384, 192, 384, 48, 128, 128, 7),
]


def googlenet(batch: int = BATCH) -> LayerDAG:
    layers: List[LayerNode] = [
        _conv("stem7x7", 3, 64, 7, 112, batch),
        _conv("stem1x1", 64, 64, 1, 56, batch),
        _conv("stem3x3", 64, 192, 3, 56, batch),
    ]
    for (tag, cin, c1, c3r, c3, c5r, c5, cp, h) in _INCEPTION:
        layers += [
            _conv(f"{tag}_1x1", cin, c1, 1, h, batch),
            _conv(f"{tag}_3red", cin, c3r, 1, h, batch),
            _conv(f"{tag}_3x3", c3r, c3, 3, h, batch),
            _conv(f"{tag}_5red", cin, c5r, 1, h, batch),
            _conv(f"{tag}_5x5", c5r, c5, 5, h, batch),
            _conv(f"{tag}_pool", cin, cp, 1, h, batch),
        ]
    layers.append(_fc("fc", 1024, 1000, batch))
    return LayerDAG(layers)       # 3 + 9*6 + 1 = 58 layers (Table III)


def resnet34(batch: int = BATCH) -> LayerDAG:
    layers: List[LayerNode] = [_conv("stem", 3, 64, 7, 112, batch)]
    plan = [(64, 64, 56, 6), (64, 128, 28, 8), (128, 256, 14, 12),
            (256, 512, 7, 6)]
    for cin, cout, h, n in plan:
        for i in range(n):
            c_in = cin if i == 0 else cout
            layers.append(_conv(f"c{cout}_{i}", c_in, cout, 3, h, batch))
    layers.append(_fc("fc", 512, 1000, batch))
    return LayerDAG(layers)       # 1 + 32 + 1 = 34 layers


# ---------------------------------------------------------------------------
# DeepBench-style RNNs.  Per-timestep GEMMs; each timestep's hidden state is
# a saved feature map.  gates: vanilla=1, GRU=3, LSTM=4.
def _rnn(name: str, hidden: int, steps: int, gates: int,
         batch: int = BATCH) -> LayerDAG:
    layers = []
    flops = 2.0 * batch * (hidden * hidden * gates * 2)   # x-GEMM + h-GEMM
    act = batch * hidden * gates * F32
    w = 2 * hidden * hidden * gates * F32
    for t in range(steps):
        layers.append(LayerNode(f"{name}_t{t}", flops_fwd=flops,
                                saved_bytes=act,
                                weight_bytes=w if t == 0 else 0.0, fc=True))
    return LayerDAG(layers)


def rnn_gemv(batch: int = BATCH) -> LayerDAG:
    return _rnn("rnn", 2560, 50, 1, batch)        # speech recognition


def rnn_lstm1(batch: int = BATCH) -> LayerDAG:
    return _rnn("lstm1", 2048, 25, 4, batch)      # machine translation


def rnn_lstm2(batch: int = BATCH) -> LayerDAG:
    return _rnn("lstm2", 4096, 25, 4, batch)      # language modelling


def rnn_gru(batch: int = BATCH) -> LayerDAG:
    return _rnn("gru", 2816, 187, 3, batch)       # speech recognition


WORKLOADS = {
    "AlexNet": alexnet,
    "GoogLeNet": googlenet,
    "VGG-E": vgg_e,
    "ResNet": resnet34,
    "RNN-GEMV": rnn_gemv,
    "RNN-LSTM-1": rnn_lstm1,
    "RNN-LSTM-2": rnn_lstm2,
    "RNN-GRU": rnn_gru,
}

CNNS = ("AlexNet", "GoogLeNet", "VGG-E", "ResNet")
RNNS = ("RNN-GEMV", "RNN-LSTM-1", "RNN-LSTM-2", "RNN-GRU")


# ---------------------------------------------------------------------------
# synthetic LLM serving traffic
@dataclasses.dataclass(frozen=True)
class SyntheticSession:
    """One generated session: everything the router or the analytic
    model needs to admit, place, and score it."""

    uid: int
    arrival: float              # seconds from trace start
    tenant: str
    prompt_len: int
    decode_len: int
    prefix_id: int | None       # shared system-prompt id (None: unique)
    prefix_len: int             # tokens shared when prefix_id is set
    slo: str                    # interactive | standard | batch
    slack_steps: float          # deadline slack on the router step clock


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs for :func:`generate_traffic` (all rates are per the whole
    trace horizon unless noted)."""

    sessions: int = 10_000
    horizon_s: float = 86_400.0        # one day
    diurnal_amplitude: float = 0.6     # 0: flat, 1: midnight trough ~ 0
    peak_hour: float = 14.0            # local-time intensity peak
    burst_rate_per_hour: float = 2.0   # Poisson rate of burst events
    burst_size: int = 50               # mean sessions per burst (geometric)
    burst_spread_s: float = 30.0       # arrival jitter inside a burst
    shared_prefix_frac: float = 0.6    # sessions drawn from the prefix pool
    prefix_pool: int = 16              # distinct shared system prompts
    prefix_len: int = 32
    prompt_mean: float = 96.0          # lognormal body lengths
    prompt_sigma: float = 0.7
    prompt_max: int = 1024
    decode_mean: float = 64.0
    decode_sigma: float = 0.8
    decode_max: int = 512
    # SLO class -> (mix weight, deadline slack as a multiple of the ideal
    # decode duration); None slack = no deadline (batch)
    slo_classes: tuple = (("interactive", 0.3, 2.0),
                          ("standard", 0.5, 4.0),
                          ("batch", 0.2, None))
    tenants: tuple = ("default", "burst", "batch")
    tenant_weights: tuple = (0.6, 0.25, 0.15)
    seed: int = 0


def _diurnal_arrivals(n: int, spec: TrafficSpec,
                      rng: np.random.Generator) -> np.ndarray:
    """Inverse-CDF sample n arrival times from the diurnal intensity
    lambda(t) = 1 + A*cos(2*pi*(t - peak)/day), on a fine grid."""
    grid = np.linspace(0.0, spec.horizon_s, 4096)
    day = 86_400.0
    lam = 1.0 + spec.diurnal_amplitude * np.cos(
        2.0 * math.pi * (grid - spec.peak_hour * 3600.0) / day)
    lam = np.maximum(lam, 1e-6)
    cdf = np.cumsum(lam)
    cdf = cdf / cdf[-1]
    return np.interp(rng.random(n), cdf, grid)


def _lognormal_lengths(n: int, mean: float, sigma: float, cap: int,
                       rng: np.random.Generator) -> np.ndarray:
    mu = math.log(mean) - sigma * sigma / 2.0
    x = rng.lognormal(mu, sigma, size=n)
    return np.clip(np.round(x), 1, cap).astype(int)


def generate_traffic(spec: TrafficSpec) -> List["SyntheticSession"]:
    """A seeded synthetic trace, sorted by arrival time.

    Deterministic for a given spec (one PRNG stream drives everything),
    so the router replay, the analytic sweep, and the benches all see the
    same sessions."""
    rng = np.random.default_rng(spec.seed)

    # arrivals: diurnal base + Poisson bursts of geometric size
    n_bursts = rng.poisson(spec.burst_rate_per_hour *
                           spec.horizon_s / 3600.0)
    burst_sizes = (1 + rng.geometric(1.0 / max(spec.burst_size, 1),
                                     size=n_bursts)
                   if n_bursts else np.zeros(0, int))
    n_burst = int(min(burst_sizes.sum(), spec.sessions // 2))
    n_base = spec.sessions - n_burst
    arrivals = [_diurnal_arrivals(n_base, spec, rng)]
    remaining = n_burst
    for size in burst_sizes:
        take = int(min(size, remaining))
        if take <= 0:
            break
        center = rng.random() * spec.horizon_s
        arrivals.append(np.clip(
            center + rng.exponential(spec.burst_spread_s, size=take),
            0.0, spec.horizon_s))
        remaining -= take
    arrival = np.sort(np.concatenate(arrivals))[:spec.sessions]

    n = len(arrival)
    prompt_len = _lognormal_lengths(n, spec.prompt_mean, spec.prompt_sigma,
                                    spec.prompt_max, rng)
    decode_len = _lognormal_lengths(n, spec.decode_mean, spec.decode_sigma,
                                    spec.decode_max, rng)

    shared = rng.random(n) < spec.shared_prefix_frac
    # Zipf-ish popularity over the prefix pool: a few prompts dominate
    pop = 1.0 / np.arange(1, spec.prefix_pool + 1)
    prefix_ids = rng.choice(spec.prefix_pool, size=n, p=pop / pop.sum())

    names, weights, slacks = zip(*[(c[0], c[1], c[2])
                                   for c in spec.slo_classes])
    w = np.asarray(weights, float)
    slo_idx = rng.choice(len(names), size=n, p=w / w.sum())
    tw = np.asarray(spec.tenant_weights, float)
    tenant_idx = rng.choice(len(spec.tenants), size=n, p=tw / tw.sum())

    out: List[SyntheticSession] = []
    for i in range(n):
        slo = names[slo_idx[i]]
        slack = slacks[slo_idx[i]]
        has_prefix = bool(shared[i]) and prompt_len[i] > spec.prefix_len
        out.append(SyntheticSession(
            uid=i,
            arrival=float(arrival[i]),
            tenant=spec.tenants[tenant_idx[i]],
            prompt_len=int(prompt_len[i]),
            decode_len=int(decode_len[i]),
            prefix_id=int(prefix_ids[i]) if has_prefix else None,
            prefix_len=spec.prefix_len if has_prefix else 0,
            slo=slo,
            slack_steps=(float("inf") if slack is None
                         else float(slack) * float(decode_len[i])),
        ))
    return out


def traffic_summary(trace: List[SyntheticSession]) -> dict:
    """Shape of a trace at a glance (the bench embeds this in its JSON)."""
    by_slo: Dict[str, int] = {}
    by_tenant: Dict[str, int] = {}
    shared = 0
    for s in trace:
        by_slo[s.slo] = by_slo.get(s.slo, 0) + 1
        by_tenant[s.tenant] = by_tenant.get(s.tenant, 0) + 1
        shared += s.prefix_id is not None
    return {
        "sessions": len(trace),
        "horizon_s": max((s.arrival for s in trace), default=0.0),
        "shared_prefix_frac": shared / len(trace) if trace else 0.0,
        "mean_prompt": (sum(s.prompt_len for s in trace) / len(trace)
                        if trace else 0.0),
        "mean_decode": (sum(s.decode_len for s in trace) / len(trace)
                        if trace else 0.0),
        "by_slo": by_slo,
        "by_tenant": by_tenant,
    }
