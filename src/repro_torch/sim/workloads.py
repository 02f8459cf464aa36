"""Synthetic LLM serving traffic: the router's session feed.

A seeded generator for session arrivals with the structure real serving
traffic has and uniform Poisson lacks: a diurnal intensity cycle, bursts
(correlated arrival clumps), a shared-prefix mixture (many sessions reuse
a few system prompts, which prefix-affinity placement exploits), mixed SLO
classes and a tenant mix.  A trace replays scaled down against the real
router (serve/router.py ``replay_trace``).  One PRNG stream drives
everything, so a spec gives the same sessions in this package and in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


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
