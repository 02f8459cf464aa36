"""Mamba2 / SSD (state-space duality) blocks — mamba2-370m.

The chunked SSD algorithm splits the sequence into chunks of length ``c``:
a quadratic *intra-chunk* term (a (c x c) masked matmul) plus a linear
*inter-chunk* state recurrence.  ``ssd_chunked`` is the plain PyTorch
version — what the reference's model runs (``repro/models/ssm.py``) and
the ground truth the CUDA scan (``kernels/csrc/ssd_scan.cu``) is held
against; the model reaches the scan through ``kernels/ops.ssd``.
``ssd_recurrent`` is the step-by-step recurrence used for decode and as
the tests' ground truth.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ModelContext, dense_init, rmsnorm

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# SSD core
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x: (b, S, H, P) per-head inputs; dt: (b, S, H) positive step sizes
    (softplus'd, float32); A: (H,) negative per-head decay (float32); B/C:
    (b, S, G, N) input / output projections (G groups broadcast over H);
    init_state: (b, H, P, N) or None.  Returns (y (b, S, H, P) float32,
    final state (b, H, P, N) in x's dtype).

    The casts are the reference's, written out (jnp promotes mixed
    operands silently): ``dt * x`` is float32, the masked scores and the
    decayed B / C are rounded to x's dtype, the state is carried in
    float32 and rounded to x's dtype where it meets C, and that product
    is rounded once more."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    assert H % G == 0
    c = min(chunk, S)
    assert S % c == 0, (S, c)
    n = S // c
    rep = H // G
    dtype = x.dtype

    def rnd(t):                      # round to x's dtype, compute in f32
        return t.to(dtype).float()

    a = dt * A[None, None, :]
    xc = x.reshape(b, n, c, H, P)
    ac = a.reshape(b, n, c, H)
    dtc = dt.reshape(b, n, c, H)
    Bc = B.reshape(b, n, c, G, N).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, n, c, G, N).repeat_interleave(rep, dim=3).float()

    cum = torch.cumsum(ac, dim=2)                        # (b,n,c,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,n,ci,cj,H)
    idx = torch.arange(c, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    # mask BEFORE the exp: the anti-causal entries are positive and
    # unbounded, and 0 * inf is NaN in the backward pass
    L = torch.exp(torch.where(causal, seg, float("-inf")))

    scores = torch.einsum("bnihd,bnjhd->bnijh", Cc, Bc) * L
    xdt = xc.float() * dtc[..., None]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", rnd(scores), xdt)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (b,n,c,H)
    states = torch.einsum("bnchd,bnchp->bnhpd",
                          rnd(Bc * decay_to_end[..., None]), xdt)

    # inter-chunk recurrence in float32: S <- exp(sum a) S + states_n
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (b,n,H)
    st = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    prev = []
    for k in range(n):
        prev.append(st)                                  # state BEFORE k
        st = st * chunk_decay[:, k, :, None, None] + states[:, k]
    prev_states = rnd(torch.stack(prev, dim=1))          # (b,n,H,P,N)

    in_decay = torch.exp(cum)                            # (b,n,c,H)
    y_inter = torch.einsum("bnchd,bnhpd->bnchp",
                           rnd(Cc * in_decay[..., None]), prev_states)
    y = y_intra + rnd(y_inter)
    return y.reshape(b, S, H, P), st.to(dtype)


def ssd_recurrent(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ground-truth stepwise recurrence (tests + decode), float32 inside.
    Same shapes as :func:`ssd_chunked`; returns y and the final state in
    x's dtype."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bf = B.repeat_interleave(rep, dim=2).float()
    Cf = C.repeat_interleave(rep, dim=2).float()
    st = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        xt, dtt = x[:, t].float(), dt[:, t].float()
        decay = torch.exp(dtt * A[None, :])                      # (b,H)
        upd = torch.einsum("bhn,bhp->bhpn", Bf[:, t], xt * dtt[..., None])
        st = st * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), st.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block
def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
               stack: int) -> dict:
    """One block's parameters (the reference's shapes and init scales),
    stacked on a leading axis of ``stack`` layers."""
    D, di = cfg.d_model, cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    W = cfg.ssm_conv_width
    conv_dim = di + 2 * G * N

    def f32(t):
        return t.to(device).expand(stack, -1).clone()

    conv_w = torch.randn((stack, W, conv_dim), generator=gen,
                         dtype=torch.float32, device=device) * W ** -0.5
    return {
        "in_proj": dense_init(gen, D, 2 * di + 2 * G * N + H, dtype, device,
                              stack=stack),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((stack, conv_dim), dtype=dtype, device=device),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H,
                                              dtype=torch.float32))),
        "D": f32(torch.ones((H,), dtype=torch.float32)),
        "dt_bias": f32(torch.zeros((H,), dtype=torch.float32)),
        "norm_scale": f32(torch.ones((di,), dtype=torch.float32)),
        "out_proj": dense_init(gen, di, D, dtype, device, stack=stack),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (b, S, C); w: (W, C).  Returns (y, new
    state (b, W-1, C)) for incremental decode."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(W))
    return y + b[None, None, :], new_state


def mamba_block(params: dict, ctx: ModelContext, x: torch.Tensor,
                cache: Optional[Cache] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """x: (B, S, D) -> (B, S, D).  ``cache``: {"conv": (B, W-1, conv_dim),
    "ssm": (B, H, P, N)}, read here; the new state is returned (the caller
    writes it back).  S == 1 with a cache decodes through the recurrence,
    anything else runs the chunked scan (``kernels/ops.ssd``) with S padded
    to a multiple of ``ssm_chunk``."""
    from repro_torch.kernels import ops as kops
    cfg = ctx.cfg
    di, H, N, G = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups
    P = cfg.ssm_head_dim
    Bsz, S, _ = x.shape

    zxbcdt = x @ params["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * G * N, H], dim=-1)
    conv_state = cache["conv"] if cache else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    B_ = B_.reshape(Bsz, S, G, N)
    C_ = C_.reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])

    ssm_state = cache["ssm"] if cache else None
    if S == 1 and cache is not None:
        y, new_state = ssd_recurrent(xs, dt, A, B_, C_, init_state=ssm_state)
    else:
        pad = (-S) % cfg.ssm_chunk
        if pad:
            xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
            C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
        y, new_state = kops.ssd(xs, dt, A, B_, C_, cfg.ssm_chunk,
                                init_state=ssm_state)
        if pad:
            y = y[:, :S]
    y = y + xs[:, :S] * params["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rmsnorm({"scale": params["norm_scale"]}, y * F.silu(z))
    out = y.to(x.dtype) @ params["out_proj"]
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "ssm": new_state}
    return out.to(x.dtype), new_cache


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> Cache:
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state), dtype=dtype, device=device),
    }
