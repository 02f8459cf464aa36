"""Pooled KV-cache utilities: capacity accounting.

This module answers the sizing questions: does a cache fit one card?  the
pool?  what does pooling buy?  Sizing is queried per-tier:
:func:`cache_tier_report` prices the cache against the serving runtime's
:class:`~repro_torch.core.tiers.MemoryTier` capacity contract, against the
H100's HBM by default.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch import hw
from repro_torch.configs.base import MeshPlan, ModelConfig


@dataclasses.dataclass(frozen=True)
class CacheFootprint:
    total_bytes: float           # global cache bytes
    per_device_unpooled: float   # if each chip held its batch shard fully
    per_device_pooled: float     # with the sequence dim striped over 'model'

    def fits(self, chip: hw.Chip = hw.H100) -> bool:
        return self.per_device_pooled <= chip.hbm_bytes


def kv_cache_footprint(cfg: ModelConfig, plan: MeshPlan, batch: int,
                       seq: int, dtype_bytes: int = 2) -> CacheFootprint:
    if cfg.is_ssm:
        conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        per_layer = batch * ((cfg.ssm_conv_width - 1) * conv_dim +
                             cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state)
        total = cfg.num_layers * per_layer * dtype_bytes
    else:
        K, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        n_sites = cfg.num_layers
        if cfg.is_hybrid:
            n_sites = cfg.num_layers // cfg.hybrid_attn_every  # shared sites
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            ssm_bytes = cfg.num_layers * batch * (
                (cfg.ssm_conv_width - 1) * conv_dim +
                cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state) * dtype_bytes
        else:
            ssm_bytes = 0.0
        total = n_sites * 2 * batch * seq * K * hd * dtype_bytes + \
            (ssm_bytes if cfg.is_hybrid else 0)
    dp = plan.axis_size("data") * plan.axis_size("pod")
    tp = plan.axis_size("model")
    b_shard = dp if batch % dp == 0 else 1
    s_shard = tp if seq % tp == 0 else 1
    return CacheFootprint(
        total_bytes=total,
        per_device_unpooled=total / b_shard,
        per_device_pooled=total / (b_shard * s_shard),
    )


# ---------------------------------------------------------------------------
def cache_tier_report(cfg: ModelConfig, runtime, batch: int, seq: int,
                      dtype_bytes: int = 2,
                      chip: hw.Chip = None) -> Dict[str, Any]:
    """Price a serving cache against the runtime's memory tier.

    ``runtime``: a :class:`repro_torch.core.runtime.MemoryRuntime`.  The
    cache occupies ``per_device_pooled`` bytes of local HBM regardless of
    the training policy; ``fits`` is that number against the chip's HBM.  The
    tier contract supplies the context around it: what one device could
    address through the backing store (``capacity_bytes``) and what a
    decode step's cache read costs against the tier bandwidth.
    """
    from repro_torch.core.pool import PoolAccountant

    chip = chip if chip is not None else runtime.chip
    fp = kv_cache_footprint(cfg, runtime.plan, batch, seq, dtype_bytes)
    acct = PoolAccountant(runtime.plan, runtime.memory)
    tier = runtime.tier
    per_dev = fp.per_device_pooled
    # one decode step touches the whole cache shard once (attention reads)
    bw = tier.bandwidth(runtime.plan, chip)
    return {
        "tier": tier.describe(),
        "total_bytes": fp.total_bytes,
        "per_device_bytes": per_dev,
        "capacity_bytes": tier.capacity(acct),
        "fits": per_dev <= chip.hbm_bytes,
        "pooling_gain": (fp.per_device_unpooled / per_dev) if per_dev else 1.0,
        "decode_read_s": per_dev / bw if bw > 0 else 0.0,
    }


# ---------------------------------------------------------------------------
#: auto-sizing defaults (KVCacheManager): bounded so a CPU smoke run stays
#: cheap; production callers raise them or pass sizes explicitly
DEFAULT_MAX_LEN = 512
DEFAULT_MAX_BATCH = 8
DEFAULT_HBM_FRAC = 0.5          # fraction of addressable bytes given to KV


def derive_cache_shape(cfg: ModelConfig, runtime, batch: int = None,
                       max_len: int = None, *,
                       page_size: int = None,
                       hbm_frac: float = DEFAULT_HBM_FRAC,
                       max_batch: int = DEFAULT_MAX_BATCH,
                       default_max_len: int = DEFAULT_MAX_LEN,
                       dtype_bytes: int = 2,
                       chip: hw.Chip = None) -> Dict[str, Any]:
    """Auto-size the decode batch / cache length from the tier report.

    Fills in whichever of ``batch`` / ``max_len`` the caller left
    unspecified — ``None`` and ``0`` both mean "solve for it", so an
    explicit 0 can no longer leak through the ``max_len`` halving loop as
    a phantom one-slot cache while the returned batch stays 0.  The
    serving tier's ``capacity_bytes`` (clamped to chip HBM — resident
    slots still occupy device memory) funds ``hbm_frac`` worth of cache;
    ``max_len`` halves from ``default_max_len`` until one slot fits, then
    ``batch`` packs as many slots as the budget holds (capped so the
    decode batch stays bounded).

    With ``page_size`` the cache is sized in **pages** instead of slots:
    ``max_len`` is rounded to a multiple of the page size (explicit values
    round up — the caller asked to fit that many rows; derived values
    round down into the budget, floored at ONE page: a sub-page cache is
    unusable, so a starvation budget combined with a large ``page_size``
    can exceed the budget — visible as ``fits=False`` in the report) and
    the report gains ``page_size``, ``pages_per_slot`` and ``num_pages``
    (= batch x pages_per_slot, the page-pool population before
    overcommit).

    Returns ``{"batch", "max_len", "report"}`` with the
    :func:`cache_tier_report` priced at the final shape.
    """
    chip = chip if chip is not None else runtime.chip
    batch = batch or None           # explicit 0 == None == solve for it
    max_len = max_len or None
    if page_size is not None and page_size < 1:
        raise ValueError(f"page_size must be >= 1: {page_size}")
    from repro_torch.core.pool import PoolAccountant
    acct = PoolAccountant(runtime.plan, runtime.memory)
    capacity = runtime.tier.capacity(acct)
    budget = hbm_frac * min(capacity, chip.hbm_bytes)

    def slot_bytes(n_slots: int, L: int) -> float:
        return kv_cache_footprint(cfg, runtime.plan, n_slots, L,
                                  dtype_bytes).total_bytes

    def round_pages(L: int, up: bool) -> int:
        if page_size is None:
            return L
        if up:
            return page_size * -(-L // page_size)
        return max(page_size, page_size * (L // page_size))

    if max_len is None:
        L = default_max_len
        while L > 16 and slot_bytes(batch or 1, L) > budget:
            L //= 2
        max_len = round_pages(L, up=False)
    else:
        max_len = round_pages(max_len, up=True)
    if batch is None:
        one = max(slot_bytes(1, max_len), 1.0)
        batch = int(max(1, min(max_batch, budget // one)))
    report = cache_tier_report(cfg, runtime, batch, max_len, dtype_bytes,
                               chip)
    if page_size is not None:
        pages_per_slot = max_len // page_size
        report.update(page_size=page_size, pages_per_slot=pages_per_slot,
                      num_pages=batch * pages_per_slot)
    return {"batch": batch, "max_len": max_len, "report": report}
