"""Model facade — one object per (architecture x memory plan x device).

Wraps the transformer stack with parameter init, the training loss
(chunked CE over the tied table, every sub-layer wrapped by the memory
runtime), cache construction and the serving entry points (prefill /
decode).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import (MemoryPlan, MeshPlan, ModelConfig,
                                      RunConfig)
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ModelContext, chunked_cross_entropy,
                                       torch_dtype)

Params = Dict[str, Any]
SINGLE_DEVICE = MeshPlan((1,), ("data",))
AUX_WEIGHT = 0.01


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; asking for CUDA without it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    return device


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    plan: MeshPlan = SINGLE_DEVICE
    memory: MemoryPlan = MemoryPlan(policy="none")
    device: Any = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.dtype = torch_dtype(self.cfg.dtype)
        self.runtime = MemoryRuntime(self.plan, self.memory, self.device)

    def ctx(self, mode: str = "decode") -> ModelContext:
        return ModelContext(cfg=self.cfg, mode=mode, runtime=self.runtime)

    def init(self, seed: int = 0) -> Params:
        """Random parameters from a seeded generator on the model device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return tfm.init_params(gen, self.cfg, self.dtype, self.device)

    def init_cache(self, batch: int, seq: int) -> Params:
        return tfm.init_caches(self.cfg, batch, seq, self.dtype, self.device)

    # ------------------------------------------------------------------
    # training
    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics): chunked CE over the tied table, labels
        < 0 masked, plus ``AUX_WEIGHT`` x the layers' aux loss."""
        cfg = self.cfg
        ctx = self.ctx("train")
        h, aux = tfm.forward_train(params, ctx, batch["tokens"],
                                   batch["positions"])
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        labels = batch["labels"]
        mask = (labels >= 0).float()
        loss, n_tok = chunked_cross_entropy(h, table, labels.clamp(min=0),
                                            mask)
        total = loss + AUX_WEIGHT * aux
        return total, {"loss": loss, "aux_loss": aux, "tokens": n_tok}

    # ------------------------------------------------------------------
    # serving
    @torch.no_grad()
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                caches: Params) -> Tuple[torch.Tensor, Params]:
        """Process the prompt into ``caches`` (in place); returns
        (last-token logits (B, V), caches)."""
        ctx = self.ctx("prefill")
        h, caches = tfm.forward_serve(params, ctx, batch["tokens"],
                                      batch["positions"], caches,
                                      cache_index=0)
        return tfm.unembed(params, ctx, h[:, -1:, :])[:, 0, :], caches

    @torch.no_grad()
    def decode_step(self, params: Params, token: torch.Tensor,
                    positions: torch.Tensor, caches: Params, index: int,
                    paged: Optional[dict] = None
                    ) -> Tuple[torch.Tensor, Params]:
        """One decode step: token (B, 1); ``index`` tokens already cached.
        ``paged``: decode in place over a page pool (see
        ``models/attention.attention_block``)."""
        ctx = self.ctx()
        h, caches = tfm.forward_serve(params, ctx, token, positions, caches,
                                      cache_index=index, paged=paged)
        return tfm.unembed(params, ctx, h[:, 0:1, :])[:, 0, :], caches


def build_model(run: RunConfig, device="cuda") -> Model:
    """The Model for a run on one device (``run.mesh`` is not used: this
    slice has no mesh).  Every policy ported so far stashes all layer
    groups when its tier offloads (host, mcdla, spill) and none otherwise;
    the planner-chosen split of ``auto`` ports with slice 5."""
    return Model(cfg=run.model, memory=run.memory, device=device)
