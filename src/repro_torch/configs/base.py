"""Configuration dataclasses for the repro framework.

Every architecture in ``repro_torch.configs`` is described by a ``ModelConfig``;
runtime behaviour (parallelism, the paper's memory technique, training and
serving) is described by the companion dataclasses below.  Configs are plain
frozen dataclasses so they can be hashed, printed, and diffed in logs.
"""
from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from typing import Optional, Sequence, Tuple

from repro_torch import hw


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """First-class configuration of the paper's technique (MC-DLA).

    policy:
      - "none":   oracle DC-DLA(O) — keep everything resident (infinite-memory
                  baseline of the paper, only valid for small models).
      - "host":   DC-DLA — virtualize against host memory (PCIe path).  Uses
                  ``memory_kind='pinned_host'`` when the backend supports it.
      - "mcdla":  paper-faithful MC-DLA — stash every layer's input feature map
                  (the residual stream) to the pooled memory tier after its
                  last forward use; recompute cheap intermediates (footnote 4).
      - "auto":   beyond-paper — cost-model driven: stash only what is needed
                  to fit the per-device HBM budget, prefer recompute when the
                  recompute time is below the fetch time.
      - "spill":  pooled HBM until the pool's capacity contract is spent,
                  host DRAM past it (core.tiers.SpillTier; the serving
                  stack's default secondary store for cold KV slots).
      - "pipeline": the pipeline-stage tier (core.tiers.PipelineStageTier
                  over pooled HBM): per-stage activation stash for 1F1B
                  schedules, priced as the DCN stage hop in series with the
                  backing store.  Training with ``--pipeline`` builds this
                  tier implicitly over whatever backing policy is set.
    placement: "bw_aware" stripes a stash across *both* mesh axes (paper
      Fig. 10 BW_AWARE, maximum link utilization); "local" stripes across the
      model axis only (LOCAL: one neighbour, half the links).
    compress: optional stash compression — the memory-node's "optional
      encryption/compression ASIC" of §III-A ("fp8"/"int8" halve stash
      bytes; codecs are registry-extensible via core.tiers.register_codec).
    """

    policy: str = "mcdla"            # none | host | mcdla | auto | spill
    placement: str = "bw_aware"      # bw_aware | local
    compress: str = "none"           # none | fp8 | int8
    recompute_cheap: bool = True     # paper footnote 4
    seq_parallel: bool = True        # sequence-parallel residual stream
    stash_aux: bool = True           # pool big float aux (enc states) too
    hbm_budget_gb: float = hw.H100.hbm_bytes / 1e9   # per-card HBM
    pool_params: bool = True         # FSDP-style weight pooling (ZeRO-3)
    opt_state_bits: int = 32         # 32 | 8  (8-bit Adam moments, beyond-paper)

    def validate(self) -> None:
        # policies and codecs are extensible (core.tiers registries) — the
        # registry, not a frozen list here, is the source of truth
        from repro_torch.core.compress import registered_codecs
        from repro_torch.core.tiers import registered_policies
        assert self.policy in registered_policies(), (
            self.policy, registered_policies())
        assert self.placement in ("bw_aware", "local"), self.placement
        assert self.compress in ("none",) + registered_codecs(), (
            self.compress, registered_codecs())
        assert self.opt_state_bits in (32, 8), self.opt_state_bits


PIPELINE_SCHEDULES = ("1f1b", "gpipe")


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """Pipeline-parallel training over the pod axis (parallel/pipeline.py).

    schedule: a registered pipeline schedule — "gpipe" (all microbatch
      activations implicitly live per stage) or "1f1b" (in-flight bounded
      by the stage count; stage inputs stashed through the
      PipelineStageTier).  Registry-extensible via
      parallel.pipeline.register_schedule.
    n_micro: microbatches per step; 0 lets the planner pick it by trading
      the bubble term (S-1)/(M+S-1) against predicted stash stalls
      (core.policy.plan_memory).
    n_stages: pipeline stages; 0 resolves to the pipe mesh's axis size.
    """

    enabled: bool = False
    schedule: str = "1f1b"           # gpipe | 1f1b (registry-extensible)
    n_micro: int = 0                 # 0 -> planner-chosen
    n_stages: int = 0                # 0 -> pipe mesh axis size
    axis_name: str = "pod"

    def validate(self) -> None:
        # the port has no pipeline schedules yet: these are the reference's
        assert self.schedule in PIPELINE_SCHEDULES, (
            self.schedule, PIPELINE_SCHEDULES)
        assert self.n_micro >= 0 and self.n_stages >= 0


@dataclasses.dataclass(frozen=True)
class CheckpointPlan:
    """Checkpoint-as-a-tier: snapshots flow through the same metered
    backing stores as KV spill and activation stash (train/checkpoint.py).

    tier: backing policy for the snapshot leg — "host" (DC-DLA: pinned
      host DRAM), "mcdla" (the pooled-HBM tier), or "spill" (pool until
      the capacity contract is spent, host past it).  Resolved through
      the tier registry and wrapped in a ``CheckpointTier``
      (core.tiers.build_ckpt_tier), so snapshots are metered as
      ``ckpt_save``/``ckpt_load`` in the runtime's ``traffic_report``.
    codec: stash codec for the snapshot payload ("fp8"/"int8" halve the
      bytes; lossy — bit-identical resume requires "none", the default).
    every: save cadence in steps; 0 lets the planner pick it by the
      Young–Daly trade (core.policy.plan_checkpoint): amortized unhidden
      save time against expected replay at the assumed MTBF.
    async_saves: double-buffered background writes — the device→host
      gather is synchronous (donated buffers), the encode+write+commit
      overlaps the next train steps.
    shards: snapshot shard files per checkpoint (manifest carries a CRC
      per shard; the chaos harness corrupts exactly one).
    mtbf_steps: assumed mean steps between failures for the cadence
      model and the dryrun/sim overhead reports.
    """

    enabled: bool = False
    tier: str = "host"               # host | mcdla | spill
    codec: str = "none"              # none | fp8 | int8
    every: int = 0                   # 0 -> planner-chosen (Young–Daly)
    async_saves: bool = False
    shards: int = 1
    mtbf_steps: int = 10_000

    def validate(self) -> None:
        from repro_torch.core.compress import registered_codecs
        from repro_torch.core.tiers import registered_policies
        assert self.tier in registered_policies(), (
            self.tier, registered_policies())
        assert self.codec in ("none",) + registered_codecs(), (
            self.codec, registered_codecs())
        assert self.every >= 0 and self.shards >= 1 and self.mtbf_steps >= 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description.  Dims are the *full* published config; use
    ``reduced()`` for CPU smoke twins."""

    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # --- attention ---
    attention: str = "full"          # full | swa | none
    window: int = 4096               # sliding-window size when attention == "swa"
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim sections
    use_qkv_bias: bool = False
    logit_softcap: float = 0.0
    parallel_block: bool = False     # cohere-style parallel attn+FFN

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # every k-th layer is MoE (1 → all layers)
    shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # --- hybrid (zamba2): one *shared* attention block every k SSM blocks ---
    hybrid_attn_every: int = 0

    # --- encoder/decoder (whisper) ---
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    max_target_positions: int = 448

    # --- frontends (stubs per assignment: precomputed embeddings) ---
    frontend: str = "none"           # none | audio_stub | vision_stub
    frontend_tokens: int = 256       # patches / frames provided by the stub

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    vocab_pad_to: int = 256
    sub_quadratic: bool = False      # eligible for long_500k decode

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_to)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.attention == "none" and self.ssm_state > 0

    @property
    def is_hybrid(self) -> bool:
        return self.hybrid_attn_every > 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (analytic), used for 6·N·D roofline terms."""
        V, D, F, L = self.padded_vocab, self.d_model, self.d_ff, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = V * D                                   # embedding
        if not self.tie_embeddings:
            n += V * D
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        ffn_dense = 3 * D * F if self.act in ("silu",) else 2 * D * F
        if self.is_ssm or self.is_hybrid:
            di, N = self.d_inner, self.ssm_state
            G = self.ssm_groups
            ssm = (D * (2 * di + 2 * G * N + self.ssm_heads)   # in_proj
                   + self.ssm_conv_width * (di + 2 * G * N)    # conv
                   + di * D + di                               # out_proj + norm
                   + 2 * self.ssm_heads)                       # A, D
            if self.is_hybrid:
                shared = attn + ffn_dense + 2 * D
                n += L * ssm + shared
            else:
                n += L * ssm
            return n
        per_layer = attn + 2 * D
        if self.is_moe:
            n_moe = L // self.moe_every
            n_dense = L - n_moe
            moe_ffn = self.num_experts * 3 * D * F + D * self.num_experts
            moe_ffn += self.shared_experts * 3 * D * F
            n += n_moe * (per_layer + moe_ffn) + n_dense * (per_layer + ffn_dense)
        else:
            total_layers = L + self.encoder_layers
            n += total_layers * (per_layer + ffn_dense)
            if self.is_encoder_decoder:   # cross-attention in decoder layers
                n += L * attn
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE uses top_k of num_experts)."""
        if not self.is_moe:
            return self.param_count()
        V, D, F, L = self.padded_vocab, self.d_model, self.d_ff, self.num_layers
        H, KV, hd = self.num_heads, self.num_kv_heads, self.resolved_head_dim
        n = V * D * (1 if self.tie_embeddings else 2)
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        ffn_dense = 3 * D * F
        n_moe = L // self.moe_every
        n_dense = L - n_moe
        active_ffn = (self.top_k + self.shared_experts) * 3 * D * F
        n += n_moe * (attn + 2 * D + active_ffn) + n_dense * (attn + 2 * D + ffn_dense)
        return n

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family twin for CPU smoke tests."""
        small = dict(
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            vocab_pad_to=64,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            shared_experts=min(self.shared_experts, 1),
            encoder_layers=min(self.encoder_layers, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            window=min(self.window, 64),
            frontend_tokens=min(self.frontend_tokens, 8),
            mrope_sections=(8, 4, 4) if self.mrope_sections else (),
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assignment: 4 per architecture)."""

    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}

# the reference's /tmp/repro_ckpt, under $TMPDIR where that is set
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_ckpt")

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    grad_accum: int = 1
    seed: int = 0
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    checkpoint_dir: str = DEFAULT_CKPT_DIR
    log_every: int = 10
    grad_compress: str = "none"      # none | int8  (error-feedback all-reduce)
    remat: bool = True


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Logical mesh description; physical mesh is built in launch/mesh.py."""

    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes

    def axis_size(self, name: str) -> int:
        if name not in self.axes:
            return 1
        return self.shape[self.axes.index(name)]

    @property
    def num_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axes)


SINGLE_POD = MeshPlan((16, 16), ("data", "model"))
MULTI_POD = MeshPlan((2, 16, 16), ("pod", "data", "model"))
HOST_TEST = MeshPlan((2, 2), ("data", "model"))     # for CPU multi-device tests


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshPlan = SINGLE_POD
    memory: MemoryPlan = MemoryPlan()
    train: TrainConfig = TrainConfig()
    pipeline: PipelinePlan = PipelinePlan()
    ckpt: CheckpointPlan = CheckpointPlan()
