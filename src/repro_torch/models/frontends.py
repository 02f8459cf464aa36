"""Modality frontends, stubbed as the reference's are.

The audio and vision configurations specify the transformer backbone
only: the batch carries *precomputed* frame / patch embeddings of a fixed
raw width, and these functions project them to ``d_model``, add learned
positions and (vision) merge them into the token stream.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

# raw embedding widths delivered by the (stubbed) frontends
AUDIO_FRAME_DIM = 128          # log-mel x conv-stub output per frame
VISION_PATCH_DIM = 1176        # 14x14x3x2 qwen2-vl patch (2-frame merge)


def frontend_dim(cfg: ModelConfig) -> int:
    return {"audio_stub": AUDIO_FRAME_DIM,
            "vision_stub": VISION_PATCH_DIM}.get(cfg.frontend, 0)


def frontend_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                  device) -> dict:
    """``proj`` (raw width, d_model) and learned ``pos`` (frontend_tokens,
    d_model) at the reference's scales; ``{}`` without a frontend."""
    d_in = frontend_dim(cfg)
    if not d_in:
        return {}
    pos = torch.randn((cfg.frontend_tokens, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=device) * 0.02
    return {"proj": dense_init(gen, d_in, cfg.d_model, dtype, device),
            "pos": pos.to(dtype)}


def frontend_specs(cfg: ModelConfig, planner) -> dict:
    """The sharding specs of ``frontend_init``'s leaves (the
    reference's)."""
    d_in = frontend_dim(cfg)
    if not d_in:
        return {}
    fs = planner.axes.fsdp
    return {
        "proj": planner.spec((d_in, cfg.d_model), [None, fs], "fe_proj"),
        "pos": planner.spec((cfg.frontend_tokens, cfg.d_model), [None, fs],
                            "fe_pos"),
    }


def _project(params: dict, raw: torch.Tensor) -> torch.Tensor:
    """(B, T, raw width) -> (B, T, D): the projection plus the first T
    learned positions."""
    x = raw.to(params["proj"].dtype) @ params["proj"]
    return x + params["pos"][None, :x.shape[1], :]


def embed_frames(params: dict, cfg: ModelConfig, frames: torch.Tensor
                 ) -> torch.Tensor:
    """frames: (B, T, AUDIO_FRAME_DIM) precomputed embeddings -> (B, T, D)."""
    return _project(params, frames)


def merge_patches(params: dict, cfg: ModelConfig, tok_emb: torch.Tensor,
                  patches: torch.Tensor) -> torch.Tensor:
    """VLM early fusion: the first P positions of the sequence carry the
    projected image patches, the rest the text embeddings.

    tok_emb: (B, S, D); patches: (B, P, VISION_PATCH_DIM) with P <= S."""
    pe = _project(params, patches)
    return torch.cat([pe, tok_emb[:, pe.shape[1]:, :]], dim=1)
