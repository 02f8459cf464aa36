"""Shared layer primitives: norms, activations, RoPE, embeddings, chunked
cross-entropy.

Plain functions over explicit parameter dicts (the reference's layout:
weights stored ``(d_in, d_out)``, norm scales in float32).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class ModelContext:
    """Everything the model functions need besides params/inputs.  One
    device and no mesh: the reference's layout hooks (``act``/``resid``
    sharding constraints) have nothing to do here and are left out."""

    cfg: ModelConfig
    mode: str = "train"                  # train | prefill | decode
    runtime: Optional[Any] = None        # core.runtime.MemoryRuntime

    def wrap(self, name: str, fn: Callable) -> Callable:
        """vDNN-wrap a sub-layer for training (``MemoryRuntime.wrap_layer``):
        the layer's input is stashed to the configured memory tier and the
        layer recomputed in backward.  No-op for serving or a tier that
        does not offload.  The reference also returns the bare layer
        without a mesh; here the card is the one-device mesh, so the port
        wraps whenever the tier offloads."""
        if self.mode != "train" or self.runtime is None:
            return fn
        return self.runtime.wrap_layer(fn, name=name)


# ---------------------------------------------------------------------------
def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def activation_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# norms (computed in float32, cast back)
def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def norm_init(cfg: ModelConfig, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, params: dict, x: torch.Tensor
               ) -> torch.Tensor:
    return layernorm(params, x) if cfg.norm == "layernorm" \
        else rmsnorm(params, x)


# ---------------------------------------------------------------------------
# dense / embedding init (the reference's shapes and scales)
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None, stack: int = 0
               ) -> torch.Tensor:
    """``normal * d_in**-0.5`` of shape (d_in, d_out), (stack, ...) if set."""
    scale = scale if scale is not None else d_in ** -0.5
    shape = ((stack,) if stack else ()) + (d_in, d_out)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device
               ) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RoPE (M-RoPE comes with the VLM family)
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    ang = positions[..., None].float() * rope_freqs(x.shape[-1], theta,
                                                    x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# chunked cross-entropy (keeps (B, S, V) logits out of live memory)
def _chunk_nll(hh: torch.Tensor, ll: torch.Tensor, mm: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    logits = (hh @ table.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, ll[..., None])[..., 0]
    return ((lse - picked) * mm).sum()


def chunked_cross_entropy(h: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 512
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B, S, D); table: (V, D) (tied head) -> (mean loss, n_tokens).

    Walks S in at most 8 chunks; each chunk's (B, chunk, V) logits are
    recomputed in backward (``torch.utils.checkpoint``), never saved."""
    B, S, _ = h.shape
    chunk = max(chunk, -(-S // 8))     # <= 8 chunks, as the reference
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        tot = tot + checkpoint(_chunk_nll, h[:, sl], labels[:, sl],
                               mask[:, sl], table, use_reentrant=False)
    cnt = mask.sum()
    return tot / torch.clamp(cnt, min=1.0), cnt
