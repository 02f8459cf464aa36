"""Layer DAG + reuse-distance analysis (paper §II-B).

The paper's runtime leverages "the user-level DNN topology graph as means to
extract compile-time data dependency information ... to derive the DNN data
reuse distance to schedule performance-aware data copy operations".  This
module is that graph: a sequence of :class:`LayerNode` with analytic
FLOP/byte costs, from which we derive

* the **reuse distance** of each saved feature map (forward position i is
  re-used at backward position 2L-i, so the stash->prefetch window spans the
  compute of layers i+1..L plus the backward of L..i+1), and
* the stash/prefetch **schedule** with available overlap per transfer —
  consumed by ``core.policy`` (KEEP/POOL/RECOMPUTE) and by ``sim/`` (the
  paper's Fig. 11 latency breakdown).

Builders exist for the 10 assigned architectures (from ``ModelConfig``) and
the paper's own 8 workloads (``sim/workloads.py``).  Framework-free: the
same arithmetic as the reference package's ``core/dag.py``, line for line,
so a plan made here equals the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One forward layer.  Sizes are *global* (whole batch), in elements or
    FLOPs; bytes are derived with the training dtype width."""

    name: str
    flops_fwd: float                 # forward FLOPs for the global batch
    saved_bytes: float               # feature maps saved for backward (X)
    weight_bytes: float              # parameter bytes (for sync sizing: dW)
    cheap: bool = False              # paper footnote 4: recompute, don't stash
    fc: bool = False                 # FC/recurrent layer (model-parallelizable
                                     # under Krizhevsky's one-weird-trick)

    @property
    def flops_bwd(self) -> float:
        # dX and dW each cost ~one forward's FLOPs (standard 2x)
        return 2.0 * self.flops_fwd


@dataclasses.dataclass
class LayerDAG:
    layers: List[LayerNode]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def total_flops(self) -> float:
        return sum(l.flops_fwd + l.flops_bwd for l in self.layers)

    def total_saved_bytes(self) -> float:
        return sum(l.saved_bytes for l in self.layers)

    def total_weight_bytes(self) -> float:
        return sum(l.weight_bytes for l in self.layers)

    def reuse_distance(self, i: int) -> float:
        """FLOPs executed between layer i's last forward use and its
        backward use — the window available to hide the stash+prefetch."""
        fwd_after = sum(l.flops_fwd for l in self.layers[i + 1:])
        bwd_before = sum(l.flops_bwd for l in self.layers[i + 1:])
        return fwd_after + bwd_before

    def schedule(self) -> List[Tuple[int, float, float]]:
        """[(layer, stash_bytes, overlap_flops)] for non-cheap layers, the
        paper's memory-overlaying schedule."""
        out = []
        for i, l in enumerate(self.layers):
            if l.cheap or l.saved_bytes == 0:
                continue
            out.append((i, l.saved_bytes, self.reuse_distance(i)))
        return out


# ---------------------------------------------------------------------------
def build_dag(cfg: ModelConfig, shape: ShapeConfig,
              dtype_bytes: int = 2) -> LayerDAG:
    """Analytic per-layer DAG for an assigned architecture x shape cell.

    Saved bytes per transformer layer = the residual-stream input (B,S,D) —
    the unit the offload runtime stashes; intermediates are recomputed
    (footnote-4 behaviour is built into the vjp recompute).
    """
    B, S = shape.global_batch, shape.seq_len
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    T = B * S
    layers: List[LayerNode] = []

    # embedding
    layers.append(LayerNode(
        "embed", flops_fwd=0.0, saved_bytes=0.0,
        weight_bytes=cfg.padded_vocab * D * dtype_bytes, cheap=True))

    def attn_flops(seq: int) -> float:
        proj = 2.0 * T * D * (H * hd + 2 * KV * hd) + 2.0 * T * H * hd * D
        if cfg.attention == "none":
            return 0.0
        span = min(seq, cfg.window) if cfg.attention == "swa" and cfg.window else seq
        # causal: average attended span is ~span/2 for full, ~window for swa
        eff = span / 2 if cfg.attention == "full" else span
        score = 2.0 * B * H * seq * eff * hd * 2  # qk^T and pv
        return proj + score

    def ffn_flops(f: int) -> float:
        mults = 3 if cfg.act == "silu" else 2
        return 2.0 * T * D * f * mults

    def ssm_flops() -> float:
        di, N = cfg.d_inner, cfg.ssm_state
        G = cfg.ssm_groups
        proj = 2.0 * T * D * (2 * di + 2 * G * N + cfg.ssm_heads) + 2.0 * T * di * D
        # SSD chunked: intra-chunk quadratic + state update, per head
        c = cfg.ssm_chunk
        nh, p = cfg.ssm_heads, cfg.ssm_head_dim
        intra = 2.0 * B * (S * c) * nh * p          # (c x c) scores x values
        state = 4.0 * B * S * nh * p * N            # B^T x + C state reads
        return proj + intra + state

    resid_bytes = T * D * dtype_bytes

    for i in range(L):
        if cfg.is_ssm or (cfg.is_hybrid and
                          (cfg.hybrid_attn_every == 0 or
                           (i + 1) % cfg.hybrid_attn_every != 0)):
            layers.append(LayerNode(
                f"ssm_{i}", flops_fwd=ssm_flops(), saved_bytes=resid_bytes,
                weight_bytes=(cfg.param_count() / max(L, 1)) * dtype_bytes))
            if cfg.is_hybrid and cfg.hybrid_attn_every and \
                    (i + 1) % cfg.hybrid_attn_every == 0:
                layers.append(LayerNode(
                    f"shared_attn_{i}",
                    flops_fwd=attn_flops(S) + ffn_flops(F),
                    saved_bytes=resid_bytes,
                    weight_bytes=0.0))  # shared weights counted once
            continue
        if cfg.is_hybrid:
            continue
        a = attn_flops(S)
        if cfg.is_moe and (i % cfg.moe_every == cfg.moe_every - 1):
            f = ffn_flops(F) * (cfg.top_k + cfg.shared_experts)
            w = (2 * D * (H + 2 * KV) * hd +
                 cfg.num_experts * 3 * D * F) * dtype_bytes
        else:
            f = ffn_flops(F) if F else 0.0
            w = (2 * D * (H + 2 * KV) * hd + 3 * D * F) * dtype_bytes
        layers.append(LayerNode(
            f"layer_{i}", flops_fwd=a + f, saved_bytes=resid_bytes,
            weight_bytes=w))

    if cfg.encoder_layers:
        Te = B * cfg.frontend_tokens
        enc_resid = Te * D * dtype_bytes
        for i in range(cfg.encoder_layers):
            proj = 2.0 * Te * D * (H * hd + 2 * KV * hd) + 2.0 * Te * H * hd * D
            score = 2.0 * B * H * cfg.frontend_tokens ** 2 * hd * 2
            layers.append(LayerNode(
                f"enc_{i}", flops_fwd=proj + score + 2.0 * Te * D * F * 2,
                saved_bytes=enc_resid,
                weight_bytes=(2 * D * (H + 2 * KV) * hd + 2 * D * F) * dtype_bytes))

    # lm head (chunked CE keeps logits out of live memory; cheap to recompute)
    layers.append(LayerNode(
        "lm_head", flops_fwd=2.0 * T * D * cfg.padded_vocab,
        saved_bytes=0.0,
        weight_bytes=0.0 if cfg.tie_embeddings else
        cfg.padded_vocab * D * dtype_bytes))
    return LayerDAG(layers)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D tokens (dense) / 6*N_active*D (MoE) — the §Roofline
    'useful compute' yardstick."""
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    if shape.mode == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens          # inference: forward only
