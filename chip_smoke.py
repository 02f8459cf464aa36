#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (each failure exits non-zero; nothing is caught and carried on):

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels  — holds each kernel against its plain PyTorch version on the
              card at the main paths' shapes (zamba2-2.7b's too: the paged
              decode at head_dim 80 without GQA, the scan at 80 heads of
              state 64, the int8 codec on 80-column page rows, the flash
              forward at head_dim 80) and times kernel, plain version, the
              least time the card could take (bound) and, for the paged
              decode, the flash forward and the GEMM, one PyTorch library
              call as a yardstick.  The flash forward, the GEMM, the scan
              and the paged decode run bfloat16 on the tensor cores and
              float32 on the CUDA cores; both paths are held to their
              plain versions.  The paged decode, the flash forward and
              the scan each have a rounding probe: inputs whose bfloat16
              reference output is exact and moves when one of the
              reference's roundings is skipped (limit 0).  The GEMM
              (``ops.gemm``, on no model path) is held to its plain
              version over the reference's sweep, the microbench's shape,
              every tile of both paths and zamba2's MLP at 4096 tokens
              (blocks a path lacks must be refused), then driven once,
              counted, through its entry point: that MLP's two products.
              The int8 pack and the shared unpack run a spilled page's
              leaves in one launch each way, straight from and into a
              full-width pool's frames (smollm's and zamba2's pages), and
              are held bit-exact there, on half-way ties, ragged tails
              and straddling row blocks, in both of the pack's regimes.
4. serve    — serves full-width smollm-135m (bf16, random weights from a
              seed) through ``repro_torch.launch.serve``: paged KV, in-place
              kernel decode, int8 spill codec through its kernels, an
              overcommitted pool with host spill, so pages are evicted,
              refetched and resumed compressed.  First the whole path runs
              twice, the paged decode on its plain version and then on the
              kernel, the second run emitting the first run's tokens: the
              logits of every decode step, those after compressed
              adoptions included, must agree.  Then the path runs once
              more with the launch counts set to 0, and checks every
              request finished, every kernel launched, and the codec one
              launch a page: an int8 pack a page evicted, an unpack a
              page decoded into the pool.
5. train    — trains full-width smollm-135m (bf16, random weights from a
              seed) for 20 steps of 8 x 1024 tokens through
              ``repro_torch.launch.train``, every layer's input stashed to
              pinned host memory through the fp8 codec's kernels and the
              layer recomputed in backward, training attention through the
              flash kernel.  Checks finite, falling losses, the tier's
              stash / fetch bytes and each kernel's launches a step; then
              profiles two more steps; then runs 3 steps twice from the
              same weights and batches, the flash forward on its plain
              version and on the kernel, and compares every loss and every
              step-1 gradient leaf; then 3 steps with the stash in pooled
              HBM through the blocksparse codec.
6. serve    — serves full-width mamba2-370m (bf16, random weights from a
   mamba2     seed) through ``repro_torch.launch.serve`` over monolithic
              slots, fair preemption parking sessions' conv / ssm state
              to pinned host memory: prompts of 320 tokens pad to three
              scan chunks, decode runs at mixed lengths.  The whole path
              runs twice, the SSD scan on its plain version and then on
              the kernel, the second run emitting the first run's tokens,
              and every sampled step's logits must agree; then once more
              counted: every request finished, the scan launched once per
              layer per admission, the spill's stash and fetch bytes equal.
7. train    — trains full-width mamba2-370m for 10 steps of 8 x 1024
   mamba2     tokens, every layer's input stashed through the fp8 codec to
              pinned host memory: finite losses, the tier's bytes, the
              launches a step (the scan twice a layer: forward and
              recompute); profiles two more steps; then 3 steps twice,
              scan plain against scan kernel, every loss and every step-1
              gradient leaf compared.
8. serve    — serves full-width zamba2-2.7b (bf16, random weights from a
   zamba2     seed) through ``repro_torch.launch.serve``: the shared
              attention block's k/v in an overcommitted page pool (96
              pages of 16 for 6 slots of 512 rows) with int8 spill to
              pinned host memory and in-place kernel decode, each slot's
              Mamba2 conv / ssm state beside the pool, parked whole under
              fair preemption; prompts of 128, 256 and 384 tokens.  The
              path runs four times — paged decode and scan plain, then on
              their kernels, in bfloat16 and with the weights in float32,
              every run after the first on the first's tokens — and every
              sampling call's logits must agree; then once more, counted:
              every
              request finished, the scan launched once per
              Mamba2 block per admission, the paged decode once per site
              per decode call, the codec once a page, stash and fetch
              bytes equal, the parked state 37 MB a park.

The line before the last is a JSON object with one entry per kernel (its
launches summed over the counted runs of phases 3 to 8, and per run); the
last line is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor cores
PEAK_F32_FLOPS = 67e12            # H100 SXM float32 outside tensor cores

# main path: full-width smollm-135m, 16 requests of 128 prompt + 64 new
# tokens over 8 decode slots of 256 rows, a 64-page pool (96 pages' worth
# of slots: overcommitted), pages of 16 rows, fair preemption every 16
# tokens, int8 spill to pinned host memory
MAIN_ARGS = ["--arch", "smollm", "--device", "cuda", "--seed", "0",
             "--batch", "8", "--max-len", "256", "--page-size", "16",
             "--pages", "64", "--requests", "16", "--prompt-len", "128",
             "--new-tokens", "64", "--scheduler", "fair", "--quantum", "16",
             "--spill", "host", "--page-codec", "int8", "--decode-kernel"]
# every decode step's logits, kernel run against plain run on the same
# token streams, both bf16: attention outputs may differ by a bf16 ulp
# per layer (different summation order) and the caches drift apart by as
# much.  On an H100 (700 W), through all 30 layers, the 622 calls read
# 0.051 max and 0.0088 worst-call mean with |logits| up to 2.7; a kernel
# reading its side pool with K and V scales swapped reads 0.60 and 0.087.
LOGIT_ATOL = 0.15
LOGIT_MEAN_ATOL = 0.02

# training main path: full-width smollm-135m (30 layers), batch 8 x 1024
# tokens, 20 steps, every layer input stashed to pinned host memory
# through the fp8 codec's kernels; then 3 steps with the stash in pooled
# HBM through the blocksparse codec.  lr 3e-4: at the CLI's default 3e-3
# the full-depth loss ends higher than it starts on the card, so that run
# could not show a falling loss.  At 4 of the 30 layers, from one set of
# weights at this batch, the reference's and the port's 3e-3 curves climb
# and fall back together (tests/torch_train_curves.py); the reference was
# not run at full depth
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 30, 8, 1024, 20
TRAIN_ARGS = ["--arch", "smollm", "--device", "cuda", "--seed", "0",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", str(TRAIN_STEPS), "--lr", "3e-4",
              "--policy", "host", "--compress", "fp8", "--log-every", "1"]
BLOCKSPARSE_ARGS = ["--arch", "smollm", "--device", "cuda", "--seed", "0",
                    "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                    "--steps", "3", "--lr", "3e-4", "--policy", "mcdla",
                    "--compress", "blocksparse", "--log-every", "1"]
# 3 training steps, flash kernel against its plain version from the same
# weights and batches, bf16 through 30 layers.  On an H100 (700 W) the
# correct kernel read 1.7e-4 on the losses and 0.052 on the worst step-1
# gradient leaf (max |d| over the leaf's max |g|); kv head h % K read
# 0.018 / 1.84 and the causal mask shifted by one 0.0063 / 12.6
TRAIN_LOSS_ATOL = 1e-3
TRAIN_GRAD_RTOL = 0.15

# SSD scan, kernel against plain version on the same inputs, as max |d| over
# max |want| of each output (y float32, final state in the input type):
# float32 sums the same products in other orders; bfloat16 rounds the
# scores, the decayed B / C and the state at the same places, so a sum
# that lands on the other side of a rounding boundary moves by one ulp of
# that value: the limit is one bf16 ulp of the largest output (2^-8).  On
# an H100 (700 W) the worst of 7 cases read 4.5e-5 (f32, CUDA cores) and
# 1.4e-3 (bf16, tensor cores); the group index h % G reads 1.22, the
# missing chunk decay 0.27 and dt x rounded to bf16 0.0061 (bf16).
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -8}

# mamba2 serving main path: full-width mamba2-370m, 16 requests of 320
# prompt tokens (three 128-row scan chunks after padding) + 64 new over 6
# monolithic slots of 512 rows, fair preemption every 16 tokens, cold
# sessions' state to pinned host memory
SSM_LAYERS = 48
SSM_SERVE_ARGS = ["--arch", "mamba2-370m", "--device", "cuda", "--seed", "0",
                  "--batch", "6",
                  "--max-len", "512", "--requests", "16",
                  "--prompt-len", "320", "--new-tokens", "64",
                  "--scheduler", "fair", "--quantum", "16", "--spill", "host"]
# every sampling call's logits of the scan kernel run against the plain
# run, all runs on the first (plain, bfloat16) run's token streams.  In
# float32 the two agree closely: on an H100 (700 W) 0.0025 max and 1.6e-4
# worst-call mean over the 349 calls, |logits| up to 3.6, through all 48
# layers.  In bfloat16 the random model amplifies rounding (0.98 / 0.125
# at 48 layers; the plain
# version's bfloat16 run lies 2.80 / 0.417 from its float32 run), so the
# bfloat16 kernel run is held to the distance bfloat16 itself puts between
# the plain version's run and its float32 run on the same streams
SSM_LOGIT_F32_TOL = (1e-2, 1e-3)
# mamba2 training main path: 48 layers, 8 x 1024 tokens, host tier with the
# fp8 stash codec
SSM_TRAIN_STEPS = 10
SSM_TRAIN_ARGS = ["--arch", "mamba2-370m", "--device", "cuda", "--seed", "0",
                  "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                  "--steps", str(SSM_TRAIN_STEPS), "--lr", "3e-4",
                  "--policy", "host", "--compress", "fp8", "--log-every", "1"]
# 3 training steps, scan kernel against its plain version from the same
# weights and batches.  With the weights in float32, limits on every loss
# and on every step-1 gradient leaf's |d| / |g| (2-norm; max / max reads
# heads whose gradient cancels to near zero); on an H100 (700 W) they read
# 0.0014 (losses after step 1, which reads 1e-6) and 0.035 (`dt_bias`);
# the state carried without its chunk decay reads 0.012 and 0.68.  In
# bfloat16 the gradients of this random model are rounding noise (the
# plain version's bfloat16 and float32 runs lie 1.25 apart over all
# leaves), so the kernel run is held to that distance: step 1's loss and
# all gradient leaves at once
SSM_TRAIN_F32_TOL = {"loss": 5e-3, "leaf_norm": 5e-2}

# GEMM, kernel against plain version (the float32 product rounded once) on
# the same inputs, as max |d| over the largest |want|: float32 sums the
# same products in other orders (limit 1e-5); bfloat16 rounds two float32
# sums that differ in their last bits, so one rounding can tip by one bf16
# ulp of the output (limit: one ulp of the largest output).  On an H100
# (700 W) the worst case read 0.46 (f32, 16 cases, CUDA cores) and 0.50
# (bf16, 17, tensor cores) of its limit; the last K slab dropped reads 24.0
# (f32) and the last K stage 33.6 (bf16) on 128^3 against 4.6e-4 and 0.25
GEMM_F32_RTOL = 1e-5
# zamba2's MLP at a 4096-token batch: d_model 2560, d_ff 10240
GEMM_MLP = ((4096, 2560, 10240), (4096, 10240, 2560))

# zamba2 serving main path: full-width zamba2-2.7b (54 Mamba2 blocks, the
# shared attention block at 9 sites), 16 requests of 128 / 256 / 384
# prompt tokens (whole scan chunks) + 64 new over 6 slots of 512 rows, a
# pool of 96 pages of 16 (192 pages' worth of slots: overcommitted; peak
# demand ~6 x 28 pages), int8 spill to pinned host memory, in-place kernel
# decode, fair preemption every 16 tokens
ZAMBA_LAYERS, ZAMBA_SITES = 54, 9
ZAMBA_ARGS = ["--arch", "zamba2-2.7b", "--device", "cuda", "--seed", "0",
              "--batch", "6", "--max-len", "512", "--page-size", "16",
              "--pages", "96", "--requests", "16",
              "--prompt-len", "128,256,384", "--new-tokens", "64",
              "--scheduler", "fair", "--quantum", "16", "--spill", "host",
              "--page-codec", "int8", "--decode-kernel"]
# one session's conv and ssm state in bf16: 54 x (80 heads x 64 x 64 +
# 3 x 5248 conv channels) x 2 bytes
ZAMBA_STATE_BYTES = ZAMBA_LAYERS * (80 * 64 * 64 + 3 * 5248) * 2
# every sampling call's logits, kernels (paged decode and scan) against
# their plain versions on the first run's token streams, both held to the
# distance bfloat16 itself puts between the plain version's run and its
# float32 run: bfloat16 to all of it (as phase 6), float32 to 1/50 of it.
# Mamba2's absolute float32 limits (1e-2 max, 1e-3 worst-call mean), the
# first ones set here, read 0.0101 / 0.00188 on an H100 (700 W) with the
# argmax equal on 1024 of 1024 rows: the random 63-layer stack amplifies
# rounding further than mamba2's (bf16 vs f32 4.08 / 0.675 against 2.80 /
# 0.417), so the limit follows that amplification (0.082 / 0.0135 there).
# Planted kernel faults read far beyond it in float32: side-pool frames
# dequantised with frame 0's scales 4.11 / 0.671, the scan's state carried
# without its chunk decay 5.26 / 0.996
ZAMBA_LOGIT_F32_SHARE = 0.02


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch overhead is not in the number (inputs
    stay in the 50 MB L2 between calls)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def eager_ms(fn, iters: int = 200) -> float:
    """Wall time per call launched eagerly, host overhead included (what
    one call costs the serving loop)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bf16_ulps(x: torch.Tensor, n: int) -> float:
    """``n`` bf16 ulps at the largest magnitude in ``x``."""
    top = x.abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
def paged_case(dev, dtype, *, B, H, K, hd, page, pp, P, C, seed):
    """Inputs of one paged decode: q, raw pools of P frames (last is
    scratch), a page map of distinct frames per slot with one scratch entry,
    and C int8 side-pool frames (packed by the codec kernel) mapped in."""
    from repro_torch.kernels.offload_pack import int8_pack
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, H, hd), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, page, K, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, page, K, hd), generator=g, device=dev).to(dtype)
    ids = torch.randperm(P - 1 + C, generator=g, device=dev)
    ids = torch.where(ids >= P - 1, ids + 1, ids)       # skip scratch id
    pm = ids[:B * pp].reshape(B, pp).to(torch.int32)
    pm[0, -1] = P - 1
    kq = torch.empty((C, page, K, hd), dtype=torch.int8, device=dev)
    vq = torch.empty_like(kq)
    ks = torch.empty((C, 1), dtype=torch.float32, device=dev)
    vs = torch.empty_like(ks)
    for ci in range(C):
        for src, qd, sd in ((kp, kq, ks), (vp, vq, vs)):
            x = torch.randn((page * K, hd), generator=g, device=dev) * 2
            qq, sc = int8_pack(x.to(dtype), block_rows=page * K)
            qd[ci] = qq.reshape(page, K, hd)
            sd[ci] = sc
    return (q, kp, vp, pm), dict(kq_pool=kq, vq_pool=vq, k_scale=ks,
                                 v_scale=vs)


def paged_bytes_ops(args, idx):
    """Bytes the decode must move (q, page map, the live pages' K/V — int8
    plus a scale for side-pool pages —, out) and its QK/PV operations."""
    q, kp, _, pm = args
    B, _, H, hd = q.shape
    P, page, K, _ = kp.shape
    live = pm[:, : idx // page + 1].reshape(-1)
    n_comp = int((live >= P).sum())
    n_raw = live.numel() - n_comp
    per_page = page * K * hd
    nbytes = (2 * q.numel() * q.element_size() + pm.numel() * 4
              + 2 * n_raw * per_page * kp.element_size()
              + 2 * n_comp * (per_page + 4))
    ops = 4.0 * B * H * hd * (idx + 1)
    return nbytes, ops


def paged_rounding_probe(dev, dtype):
    """One paged decode whose output shows whether p and the dequantised
    side-pool values are rounded to the pool's dtype before the PV product
    (the reference's casts): one sequence of 8 pages of 16 rows, one head
    of 64, all 128 rows visible.  Pages 0-3: keys score 0 or -2^-10
    alternately, values +1 and -1 alternately; pages 4-7 score 0, pages
    4-5 in the int8 side pool with values 100 x 0.0131 (1.31; 1.3125 in
    bfloat16 to nearest, 1.3046875 cut to 8 bits), pages 6-7 raw at
    -1.3125.  In bfloat16 the reference's p (~2^-7 on every row) and
    values cancel exactly: its output is 0; p or the values left
    unrounded or cut to 8 bits read 1e-4 to 1e-3.  Every page's
    scores peak at 0, so every split's maximum is 0 and a split kernel's
    merge scales by e^0 = 1: exact.  Returns (args, side pool,
    cache_index)."""
    page, hd, P = 16, 64, 7                  # frame 6: the scratch frame
    q = torch.zeros((1, 1, 1, hd), device=dev)
    q[..., 0] = 1.0
    kp = torch.zeros((P, page, 1, hd), device=dev)
    kp[:4, 1::2, :, 0] = -(2.0 ** -7)       # times the scale 1/8: -2^-10
    vp = torch.ones((P, page, 1, hd), device=dev)
    vp[:4, 1::2] = -1.0
    vp[4:6] = -1.3125
    pm = torch.tensor([[0, 1, 2, 3, P, P + 1, 4, 5]], dtype=torch.int32,
                      device=dev)
    kq = torch.zeros((2, page, 1, hd), dtype=torch.int8, device=dev)
    side = dict(kq_pool=kq, vq_pool=torch.full_like(kq, 100),
                k_scale=torch.ones((2, 1), device=dev),
                v_scale=torch.full((2, 1), 0.0131, device=dev))
    return [t.to(dtype) for t in (q, kp, vp)] + [pm], side, 8 * page - 1


def paged_library(args, side, idx):
    """Yardstick of the paged decode (not used by the port): inflate the
    page map, int8 side frames included, and one SDPA call over the rows
    up to ``idx``."""
    from repro_torch.kernels import ref
    q, kp, vp, pm = args
    k = ref.inflate_pages_ref(kp, pm, side["kq_pool"], side["k_scale"])
    v = ref.inflate_pages_ref(vp, pm, side["vq_pool"], side["v_scale"])
    mask = (torch.arange(k.shape[1], device=q.device) <= idx)[None, None,
                                                                 None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def check_paged(dev, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    # comparison at the checked shape: several fills incl. -1 (nothing
    # visible), page boundaries, the last row; a scratch-routed entry and
    # int8 side-pool frames.  f32 to float32 rounding, bf16 to two bf16
    # ulps of each fill's largest output (the two sum in different orders,
    # then round once to bf16).
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        args, side = paged_case(dev, dtype, B=8, H=9, K=3, hd=64,
                                page=16, pp=32, P=8 * 32 + 1, C=32, seed=1)
        err, share = 0.0, 0.0      # largest error, largest error / tol
        for idx in (-1, 0, 15, 16, 100, 255, 256, 511):
            for extra in ({}, side):
                got = paged_decode_attention(*args, idx, **extra)
                torch.cuda.synchronize()
                if not torch.isfinite(got.float()).all():
                    fail(f"paged decode not finite at cache_index {idx}")
                if idx < 0:
                    continue   # kernel: zeros, plain: mean of masked rows
                want = ref.paged_decode_attention_ref(*args, idx, **extra)
                tol = 2e-5 if dtype == torch.float32 else bf16_ulps(want, 2)
                e = (got.float() - want.float()).abs().max().item()
                if e > tol:
                    fail(f"paged decode {dtype} cache_index {idx}: max abs "
                         f"err {e} > {tol}")
                err, share = max(err, e), max(share, e / tol)
        args, side, idx = paged_rounding_probe(dev, dtype)
        got = paged_decode_attention(*args, idx, **side)
        want = ref.paged_decode_attention_ref(*args, idx, **side)
        tol = 2e-5 if dtype == torch.float32 else bf16_ulps(want, 2)
        e = (got.float() - want.float()).abs().max().item()
        if e > tol:
            fail(f"paged decode {dtype} rounding probe: max abs err {e} > "
                 f"{tol}")
        err = max(err, e)
        max_err[dtype] = err
        limit = "2e-5" if dtype == torch.float32 else "2 bf16 ulps of |out|"
        print(f"  paged_decode_attention {str(dtype)[6:]}: max abs err "
              f"{err:.3g}, at most {share:.2f} of the limit ({limit}); "
              f"the rounding probe {e:.3g}", flush=True)
    # timing at the main path's pool: 8 slots x 16 pages of 16 rows, 64
    # frames + scratch, a 64-frame side pool, 192 rows visible (the
    # longest session: 128 prompt + 64 new)
    args, side = paged_case(dev, torch.bfloat16, B=8, H=9, K=3,
                            hd=64, page=16, pp=16, P=65, C=64, seed=2)
    idx = 191
    def kernel():
        return paged_decode_attention(*args, idx, **side)

    ms, host = device_ms(kernel), eager_ms(kernel)
    plain = device_ms(lambda: ref.paged_decode_attention_ref(
        *args, idx, **side))

    lib = device_ms(lambda: paged_library(args, side, idx))
    nbytes, ops = paged_bytes_ops(args, idx)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    results["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:189",
        max_abs_err=max_err[torch.bfloat16], ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib, eager_ms=host)


def codec_case(dev, dtype, R, C, seed):
    """(R, C) values spread over magnitudes, with, in the first row, the
    block's absmax (448: the fp8 scale comes out 1.0 exactly), its
    negative, fp8 rounding ties (1.0625, -3.375), e4m3 subnormals and
    their ties (2^-9; 1.5, -2.5 and -0.5 x 2^-9) and zeros; the lower
    half of the rows is scaled into the subnormal range."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, C), generator=g, device=dev) * 60
    x[R // 2:] *= 1e-3                      # small values: subnormal range
    special = torch.tensor([448.0, -448.0, 1.0625, -3.375, 2.0 ** -9,
                            1.5 * 2.0 ** -9, -2.5 * 2.0 ** -9,
                            -(2.0 ** -10), 0.0, 447.9], device=dev)
    x[0, :special.numel()] = special
    return x.clamp(-448.0, 448.0).to(dtype)


def check_codec(dev, results, others):
    """fp8, int8 and blocksparse packs and the shared unpack (int8 and fp8
    payloads), bit-exact against their plain versions: at the training
    shape as one row block (a whole stashed layer input), at the serving
    page-leaf shape as 1, 9 and 90 row blocks, and at 4 value spreads.
    Times go to ``results`` at each kernel's main-path shape and to
    ``others`` at its other shape."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    packs = {"fp8_pack": (kp.fp8_pack, ref.fp8_pack_ref),
             "int8_pack": (kp.int8_pack, ref.int8_pack_ref),
             "blocksparse_pack": (kp.blocksparse_pack,
                                  ref.blocksparse_pack_ref)}
    train_rc = (8 * 1024, 576)       # one stashed layer input, full width
    leaf_rc = (30 * 16 * 3, 64)      # one spilled page leaf, full width
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(codec_case(dev, dtype, *train_rc, seed=4), (train_rc[0],))]
        g = torch.Generator(device=dev).manual_seed(3)
        for spread in (0.01, 3.0, 7.0, 1e4):
            x = (torch.randn(leaf_rc, generator=g, device=dev) * spread)
            cases.append((x.to(dtype), (leaf_rc[0], leaf_rc[0] // 9,
                                        leaf_rc[0] // 90)))
        cases.append((torch.zeros(leaf_rc, device=dev, dtype=dtype),
                      (leaf_rc[0],)))
        for x, brs in cases:
            for br in brs:
                for name, (kern, plain) in packs.items():
                    q, s = kern(x, block_rows=br)
                    qr, sr = plain(x, br)
                    if not (torch.equal(q.view(torch.uint8),
                                        qr.view(torch.uint8))
                            and torch.equal(s, sr)):
                        bad = (q.view(torch.uint8) != qr.view(torch.uint8))
                        fail(f"{name} {dtype} {tuple(x.shape)} block_rows "
                             f"{br}: not bit-exact ({int(bad.sum())} "
                             f"payload bytes, {int((s != sr).sum())} scales "
                             "differ)")
                    for out in (torch.float32, torch.bfloat16):
                        y = kp.fp8_unpack(q, s, block_rows=br, dtype=out)
                        if not torch.equal(y, ref.fp8_unpack_ref(q, s, br,
                                                                 out)):
                            fail(f"unpack of {name} {dtype}->{out} block_rows "
                                 f"{br}: not bit-exact")
                    n_cases += 1
    torch.cuda.synchronize()
    print(f"  fp8_pack / int8_pack / blocksparse_pack and the shared unpack: "
          f"bit-exact over {n_cases} (tensor, row block, codec) cases "
          "(f32 and bf16; 8192 x 576 as one row block with fp8 ties and "
          "subnormals; 1440 x 64 as 1, 9 and 90 row blocks at 4 spreads; "
          "all zeros)", flush=True)

    # times: each pack at its main path's shape (int8: the serving page
    # leaf; fp8 and blocksparse: the training stash), the unpack at the
    # training stash (fp8 payload), plus the other shape of each for the
    # log
    def timed(fn, plain, nbytes, ops, replaces, key, main):
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_F32_FLOPS)
        if main:
            key = key.split("@")[0]
        (results if main else others)[key] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/offload_pack.cu",
            replaces=replaces, max_abs_err=0.0, ms=device_ms(fn),
            plain_ms=device_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=None, eager_ms=eager_ms(fn))

    xt = codec_case(dev, torch.bfloat16, *train_rc, seed=5)
    xl = (torch.randn(leaf_rc, device=dev) * 3).to(torch.bfloat16)
    sites = {"fp8_pack": "src/repro/kernels/offload_pack.py:63",
             "int8_pack": "src/repro/kernels/offload_pack.py:110",
             "blocksparse_pack": "src/repro/kernels/offload_pack.py:143"}
    for name, (kern, plain) in packs.items():
        for x, tag in ((xt, "train"), (xl, "leaf")):
            n, R = x.numel(), x.shape[0]
            # the bound reads x once and writes a byte an element and a
            # scale; fp8 and blocksparse read x twice (absmax, then
            # quantise), the int8 pack once from HBM (a cluster's shared
            # memory holds the row block) or, at 8192 x 576, twice with the
            # second read in L2.  int8's main-path shape is the page
            # (check_int8_pages)
            timed(lambda: kern(x, block_rows=R), lambda: plain(x, R),
                  n * 2 + n + 4, 3.0 * n, sites[name], f"{name}@{tag}",
                  tag == "train" and name != "int8_pack")
    for x, tag in ((xt, "train"), (xl, "leaf")):
        n, R = x.numel(), x.shape[0]
        pack = kp.fp8_pack if tag == "train" else kp.int8_pack
        q, s = pack(x, block_rows=R)
        timed(lambda: kp.fp8_unpack(q, s, block_rows=R),
              lambda: ref.fp8_unpack_ref(q, s, R, torch.bfloat16),
              n + 4 + 2 * n, 1.0 * n, "src/repro/kernels/offload_pack.py:86",
              f"fp8_unpack@{tag}", tag == "train")


def int8_page(dev, arch, num_pages, dtype, seed):
    """A full-width page pool of ``arch`` as the serving path allocates it
    (``transformer.paged_pool``: leaves (n_groups, num_pages + 1, 16, K,
    hd)), k 10^4 times smaller than v, random; returns the pool's leaves
    and the frame views (one a leaf) of pages 5 and 9."""
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tfm
    pool, _ = tfm.paged_pool(ARCHS[arch], num_pages, 16, dtype, dev)
    leaves, _ = tree.flatten(pool)
    g = torch.Generator(device=dev).manual_seed(seed)
    for c, mag in zip(leaves, (1e-2, 1e2)):        # k, v
        c.copy_(torch.randn(c.shape, generator=g, device=dev) * mag)
    return leaves, [c[:, 5] for c in leaves], [c[:, 9] for c in leaves]


def check_int8_pages(dev, results, others):
    """The int8 pack and the shared unpack on the serving page path: the
    leaves of one page packed in one launch straight from a full-width
    pool's frame and decoded in one launch straight into another frame
    (smollm's page: 2 leaves of (30, 16, 3, 64); zamba2's: 2 of (9, 16,
    32, 80)), bit-exact against the plain versions leaf by leaf, float32
    and bfloat16 pools; then half-way ties, ragged tails, row blocks whose
    16-code chunks straddle two scales, all zeros, in both regimes (a row
    block on one cluster, or two passes).  Times the page pack and unpack
    (the int8 pack's main-path row) and 8192 x 576 in bfloat16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    pages = {"smollm-135m": 64, "zamba2-2.7b": 96}
    for dtype in (torch.float32, torch.bfloat16):
        for arch, num in pages.items():
            leaves, src, dst = int8_page(dev, arch, num, dtype, seed=num)
            got = kp.int8_pack_leaves(src)
            want = ref.int8_pack_leaves_ref(src)
            if not all(torch.equal(q, qr) and torch.equal(s, sr)
                       for (q, s), (qr, sr) in zip(got, want)):
                fail(f"int8 pack of a {arch} page ({dtype}) from the pool "
                     "not bit-exact")
            if not float(got[1][1]) > 1e3 * float(got[0][1]):
                fail(f"int8 pack of a {arch} page: one scale for both leaves")
            before = [c.clone() for c in leaves]
            kp.unpack_leaves([q for q, _ in got], [s for _, s in got], dst)
            for c, old, (q, s) in zip(leaves, before, got):
                hd = q.shape[-1]
                R = q.numel() // hd
                if not torch.equal(c[:, 9], ref.fp8_unpack_ref(
                        q.reshape(R, hd), s.reshape(1), R, dtype)
                        .reshape(q.shape)):
                    fail(f"unpack of a {arch} page into the pool ({dtype}) "
                         "not bit-exact")
                c[:, 9] = old[:, 9]
                if not torch.equal(c, old):
                    fail(f"unpack of a {arch} page wrote outside its frame")
            del leaves, src, dst, before
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = []
        for rows, cols in ((1440, 64), (8192, 576)):          # both regimes
            x = torch.zeros((rows, cols), device=dev, dtype=dtype)
            x[0, :5] = torch.tensor([127.0, 0.5, -0.5, 2.5, -3.5])
            x[-1, -4:] = torch.tensor([0.5, -0.5, 2.5, -3.5])
            cases.append((x, rows, [127, 0, 0, 2, -4]))
            cases.append((torch.zeros_like(x), rows, None))
        for rows, cols, br in ((1601, 63, 1601), (1600, 63, 16),
                               (1440, 63, 9), (8193, 577, 8193)):
            cases.append((codec_case(dev, dtype, rows, cols, seed=rows + br),
                          br, None))
        for x, br, ties in cases:
            q, s = kp.int8_pack(x, block_rows=br)
            qr, sr = ref.int8_pack_ref(x, br)
            ok = torch.equal(q, qr) and torch.equal(s, sr)
            for out in (torch.float32, torch.bfloat16):
                ok = ok and torch.equal(
                    kp.fp8_unpack(q, s, block_rows=br, dtype=out),
                    ref.fp8_unpack_ref(q, s, br, out))
            if ties is not None:
                ok = ok and q[0, :5].tolist() == ties \
                    and q[-1, -4:].tolist() == ties[1:]
            if not ok:
                fail(f"int8 pack / unpack {dtype} {tuple(x.shape)} block_rows "
                     f"{br}: not bit-exact")
            n_cases += 1
    torch.cuda.synchronize()
    print("  int8 pack and unpack of a full-width page, one launch each, from "
          "and into the pool (smollm, zamba2; f32, bf16; leaves 1e4 apart): "
          f"bit-exact; and over {n_cases} more cases (ties at absmax 127, "
          "all zeros, both regimes; 1601 x 63, 100 row blocks of 16 x 63, "
          "row blocks of 9 x 63, 8193 x 577): bit-exact", flush=True)

    site_pack = "src/repro/kernels/offload_pack.py:110"
    site_unpack = "src/repro/kernels/offload_pack.py:86"
    for arch, num in pages.items():
        leaves, src, dst = int8_page(dev, arch, num, torch.bfloat16, seed=1)
        n = sum(x.numel() for x in src)
        got = kp.int8_pack_leaves(src)
        qs, ss = [q for q, _ in got], [s for _, s in got]
        tag = "page" if arch == "smollm-135m" else "zamba2_page"
        for key, fn, plain, nbytes, site in (
                (f"int8_pack@{tag}", lambda: kp.int8_pack_leaves(src),
                 lambda: ref.int8_pack_leaves_ref(src),
                 2 * n + n + 4 * len(src), site_pack),
                (f"fp8_unpack@{tag}", lambda: kp.unpack_leaves(qs, ss, dst),
                 lambda: ref.unpack_leaves_ref(qs, ss, dst),
                 n + 4 * len(src) + 2 * n, site_unpack)):
            b_ms, b_by = bound_ms(nbytes, 3.0 * n, PEAK_F32_FLOPS)
            row = dict(
                route="cuda",
                source="src/repro_torch/kernels/csrc/offload_pack.cu",
                replaces=site, max_abs_err=0.0, ms=device_ms(fn),
                plain_ms=device_ms(plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=None, eager_ms=eager_ms(fn))
            if key == "int8_pack@page":       # the serving path's call
                results["int8_pack"] = row
            else:
                others[key] = row
        del leaves, src, dst


def flash_bytes_ops(q, k, causal, window):
    """Bytes the forward must move (q, k, v, out once) and its QK / PV
    operations over the visible (causal / window) pairs only."""
    B, H, S, d = q.shape
    T = k.shape[2]
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    qp = torch.arange(S)[:, None]
    kp = torch.arange(T)[None, :]
    vis = torch.ones((S, T), dtype=torch.bool)
    if causal:
        vis &= qp >= kp
        if window > 0:
            vis &= (qp - kp) < window
    return nbytes, 4.0 * d * B * H * int(vis.sum())


def flash_rounding_probe(dev, dtype):
    """q, k, v whose output shows whether p is rounded to v's dtype before
    the PV product: every key scores 0 or -2^-10 (p = 1 or 0.99902),
    values +1 and -1 alternately.  bfloat16 rounds 0.99902 to 1.0, so the
    reference's output is exactly 0; p left unrounded (or cut to bf16
    rather than rounded) gives 4.9e-4 (0.002).  In float32 p is not
    rounded: 4.9e-4 on both sides."""
    B, H, S, T, d = 1, 2, 64, 128, 64
    q = torch.zeros((B, H, S, d), device=dev)
    q[..., 0] = 1.0
    k = torch.zeros((B, 1, T, d), device=dev)
    k[:, :, 1::2, 0] = -(2.0 ** -7)       # times the scale 1/8: -2^-10
    v = torch.ones((B, 1, T, d), device=dev)
    v[:, :, 1::2] = -1.0
    return tuple(t.to(dtype) for t in (q, k, v))


# flash forward cases (B, H, K, S, T, d, causal, window): smollm's
# training shape, a window, ragged S; head_dim 80 (zamba2-2.7b) at its
# attention shape (H = K = 32), ragged with a window, non-causal with S !=
# T, a short window; head dims 32 and 128
FLASH_CASES = [(8, 9, 3, 1024, 1024, 64, True, 0),
               (8, 9, 3, 1024, 1024, 64, True, 256),
               (8, 9, 3, 1000, 1000, 64, True, 0),
               (2, 32, 32, 1024, 1024, 80, True, 0),
               (2, 8, 2, 1000, 1000, 80, True, 256),
               (2, 9, 3, 200, 330, 80, False, 0),
               (1, 4, 4, 77, 77, 80, True, 16),
               (2, 9, 3, 200, 330, 32, False, 0),
               (2, 9, 3, 256, 256, 128, True, 0)]


def check_flash(dev, results, others):
    """The flash forward against its plain twin over ``FLASH_CASES`` and
    the rounding probe, in f32 (2e-5) and bf16 (2 bf16 ulps of each case's
    largest |out|); timed in bf16 beside SDPA at the training shape (B 8,
    H 9, K 3, S = T = 1024, d 64, causal) and at zamba2's (B 8, H = K =
    32, d 80)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    g = torch.Generator(device=dev).manual_seed(6)
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        err, share = 0.0, 0.0
        for case in FLASH_CASES + ["probe"]:
            if case == "probe":
                q, k, v = flash_rounding_probe(dev, dtype)
                causal, window = False, 0
            else:
                B, H, K, S, T, d, causal, window = case
                q = torch.randn((B, H, S, d), generator=g, device=dev)
                k = torch.randn((B, K, T, d), generator=g, device=dev)
                v = torch.randn((B, K, T, d), generator=g, device=dev)
                q, k, v = (t.to(dtype) for t in (q, k, v))
            got = flash_attention_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)
            if not torch.isfinite(got.float()).all():
                fail(f"flash forward not finite ({case})")
            tol = 2e-5 if dtype == torch.float32 else bf16_ulps(want, 2)
            e = (got.float() - want.float()).abs().max().item()
            if e > tol:
                fail(f"flash_attention_fwd {dtype} {case}: max abs err {e} "
                     f"> {tol}")
            err = max(err, e)
            share = max(share, e / tol if tol else 0.0)
        max_err[dtype] = err
        limit = "2e-5" if dtype == torch.float32 else "2 bf16 ulps of |out|"
        print(f"  flash_attention_fwd {str(dtype)[6:]}: max abs err "
              f"{err:.3g}, at most {share:.2f} of the limit ({limit}) over "
              f"{len(FLASH_CASES)} cases (d 32, 64, 80, 128; causal, "
              "windowed, ragged, non-causal) and the p-rounding probe",
              flush=True)

    import ctypes
    from repro_torch.kernels import build
    per_sm = build.function("flash_attention", "flash_attention_blocks_per_sm",
                            (ctypes.c_int,))
    print("  flash_attention_fwd bfloat16: thread blocks resident a SM by "
          f"head dim {({d: per_sm(d) for d in (32, 64, 80, 128)})}",
          flush=True)
    for key, (B, H, K, S, d) in (("train", (8, 9, 3, 1024, 64)),
                                 ("zamba2", (8, 32, 32, 1024, 80))):
        q = torch.randn((B, H, S, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, K, S, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, K, S, d), generator=g, device=dev).bfloat16()

        def kernel():
            return flash_attention_fwd(q, k, v, causal=True)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)

        nbytes, ops = flash_bytes_ops(q, k, True, 0)
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
        row = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:109",
            max_abs_err=max_err[torch.bfloat16],
            ms=device_ms(kernel, iters=20),
            plain_ms=device_ms(lambda: ref.flash_attention_ref(q, k, v),
                               iters=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(library, iters=20),
            eager_ms=eager_ms(kernel, iters=20))
        if key == "train":
            results["flash_attention_fwd"] = row
        else:
            others["flash_attention_fwd@zamba2"] = row


def ssd_case(dev, dtype, b, S, H, G, seed, P=64, N=128, init=False):
    """Inputs of the scan as ``mamba_block`` hands them over: x, B, C of
    unit scale, dt = softplus(normal) in float32, A = -linspace(1, 16) (the
    init's decays), an optional initial state."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x, B, C = rnd(b, S, H, P), rnd(b, S, G, N), rnd(b, S, G, N)
    dt = torch.nn.functional.softplus(rnd(b, S, H))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    s0 = (rnd(b, H, P, N) * 0.5).to(dtype) if init else None
    return [t.to(dtype) for t in (x,)] + [dt, A] + \
        [t.to(dtype) for t in (B, C)] + [s0]


def ssd_bytes_ops(x, dt, B, init, chunk):
    """Bytes the scan must move (x, dt, A, B, C and the initial state read
    once, y float32 and the final state written once) and its operations
    over the causal pairs only: per (b, h) and chunk c(c+1)(N+P) for the
    scores and the intra-chunk product, 4cPN for the inter-chunk product
    and the state update."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    c = min(chunk, S)
    e = x.element_size()
    nbytes = (x.numel() * e + dt.numel() * 4 + H * 4 + 2 * B.numel() * e
              + (init.numel() * e if init is not None else 0)
              + x.numel() * 4 + b * H * P * N * e)
    ops = b * H * (S // c) * (c * (c + 1) * (N + P) + 4.0 * c * P * N)
    return nbytes, ops


def ssd_rounding_probe(dev) -> float:
    """The scan's rounding probe (``kernels/ssd_scan.rounding_probe``) at
    the main paths' chunk and widths (N 128 and 64, P 64): the plain
    version's y and final state are exact under the reference's five
    roundings, and the kernel must reproduce them bit for bit (limit 0).
    Skipping any one rounding, or rounding dt x to bfloat16, moves them by
    2^-12 to 1 at chunk 128.  Returns the largest |d| over y and the
    final state."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import rounding_probe, ssd_scan
    worst = 0.0
    for N in (128, 64):
        args = rounding_probe(128, N, 64, device=dev)
        y, fin = ssd_scan(*args, 128)
        wy, wfin = ref.ssd_chunked_ref(*args, 128)
        torch.cuda.synchronize()
        d = max((y - wy).abs().max().item(),
                (fin.float() - wfin.float()).abs().max().item())
        if not (torch.isfinite(y).all() and d == 0.0):
            fail(f"ssd_scan rounding probe (N {N}): max |d| {d} > 0")
        worst = max(worst, d)
    return worst


def check_ssd(dev, results, others):
    """The SSD scan against its plain version (``models/ssm.ssd_chunked``)
    at both main-path shapes — training (8 x 1024 tokens, 32 heads, no
    initial state) and serving prefill (one 320-token prompt padded to 384,
    a zeroed state from the cache) — in float32 and bfloat16, with and
    without an initial state, one and two groups, and a 1000-token batch
    padded to 1024 as ``mamba_block`` pads it.  y and the final state,
    each to ``SSD_RTOL`` of its largest magnitude.  Timed at both shapes in
    bfloat16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    F = torch.nn.functional
    cases = [(8, 1024, 1, False), (8, 1024, 1, True), (8, 1024, 2, True),
             (1, 384, 1, False), (1, 384, 1, True), (1, 384, 2, False),
             (2, 1000, 1, True)]
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = worst_abs = 0.0
        for i, (b, S, G, init) in enumerate(cases):
            x, dt, A, B, C, s0 = ssd_case(dev, dtype, b, S, 32, G, 20 + i,
                                          init=init)
            pad = (-S) % 128
            if pad:           # zero rows, as mamba_block pads its inputs
                x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
                dt = F.pad(dt, (0, 0, 0, pad))
            y, fin = ssd_scan(x, dt, A, B, C, 128, init_state=s0)
            torch.cuda.synchronize()
            wy, wfin = ref.ssd_chunked_ref(x, dt, A, B, C, 128,
                                           init_state=s0)
            for name, got, want in (("y", y, wy), ("final state", fin,
                                                   wfin)):
                if got.dtype != want.dtype or got.shape != want.shape:
                    fail(f"ssd_scan {name}: {got.dtype} {tuple(got.shape)}, "
                         f"plain {want.dtype} {tuple(want.shape)}")
                if not torch.isfinite(got.float()).all():
                    fail(f"ssd_scan {name} not finite ({b} x {S}, G {G})")
                d = (got.float() - want.float()).abs().max().item()
                e = d / want.float().abs().max().item()
                print(f"    ssd_scan {str(dtype)[6:]} {b} x {S} G {G} init "
                      f"{init}: {name} max |d| / max |want| {e:.3g}",
                      flush=True)
                if e > SSD_RTOL[dtype]:
                    fail(f"ssd_scan {dtype} {b} x {S} G {G} init {init}: "
                         f"{name} off by {e:.3g} of its scale > "
                         f"{SSD_RTOL[dtype]}")
                worst, worst_abs = max(worst, e), max(worst_abs, d)
        max_err[dtype] = worst_abs
        print(f"  ssd_scan {str(dtype)[6:]}: worst max |d| / max |want| "
              f"{worst:.3g} (limit {SSD_RTOL[dtype]}) over {len(cases)} "
              "cases, y and final state", flush=True)
    probe = ssd_rounding_probe(dev)
    print(f"  ssd_scan rounding probe: max |d| {probe:.3g} (limit 0), "
          "N 128 and 64", flush=True)
    for tag, (b, S) in (("train", (8, 1024)), ("prefill", (1, 384))):
        x, dt, A, B, C, _ = ssd_case(dev, torch.bfloat16, b, S, 32, 1, 40)

        def kernel():
            return ssd_scan(x, dt, A, B, C, 128)

        nbytes, ops = ssd_bytes_ops(x, dt, B, None, 128)
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
        row = dict(
            route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
            replaces="src/repro/kernels/ssd_scan.py:85",
            max_abs_err=max_err[torch.bfloat16],
            ms=device_ms(kernel, iters=20),
            plain_ms=device_ms(lambda: ref.ssd_chunked_ref(x, dt, A, B, C,
                                                           128), iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            eager_ms=eager_ms(kernel, iters=20))
        if tag == "train":
            results["ssd_scan"] = row
        else:
            others["ssd_scan@prefill"] = row


def gemm_bytes_ops(x, w):
    """Bytes the product must move (x and w read once, out written once)
    and its 2MNK operations."""
    (M, K), N = x.shape, w.shape[1]
    e = x.element_size()
    return (M * K + K * N + M * N) * e, 2.0 * M * N * K


def gemm_tol(want: torch.Tensor) -> float:
    if want.dtype == torch.float32:
        return GEMM_F32_RTOL * want.abs().max().item()
    return bf16_ulps(want.float(), 1)


def check_gemm(dev, results, others):
    """The output-stationary GEMM against its plain version: the
    reference's sweep (tests/test_kernels.py) with the port's own blocks
    and with the reference's, the microbench's 256 x 512 x 256 with 128
    blocks, non-square shapes over every tile of both paths (so w read as
    (n, k), or B read in the other major mode, cannot pass) and zamba2's
    MLP at 4096 tokens; float32 (CUDA cores) and bfloat16 (tensor cores).
    Blocks a path lacks must be refused (``ValueError``, no launch).
    Timed at the MLP shapes in bfloat16 beside torch.matmul (cuBLAS) and
    at the microbench's in float32."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.gemm_os import gemm_os, supported
    cases = [(128, 128, 128, None), (128, 128, 128, (128, 128, 128)),
             (256, 512, 384, None), (256, 512, 384, (128, 128, 128)),
             (256, 1024, 256, None), (256, 1024, 256, (128, 128, 256)),
             (512, 256, 512, None), (256, 512, 256, (128, 128, 128)),
             (192, 320, 448, (64, 64, 32)), (384, 96, 640, (128, 64, 48)),
             (256, 1024, 128, (64, 128, 64)),
             (256, 640, 512, (128, 256, 64)), (192, 384, 768, (64, 256, 128)),
             (384, 768, 192, (128, 64, 192)), (320, 448, 640, (64, 128, 64)),
             (128, 192, 320, (64, 64, 64)), (256, 512, 768, (128, 128, 64))] \
        + [(m, k, n, None) for m, k, n in GEMM_MLP]
    g = torch.Generator(device=dev).manual_seed(50)
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst = share = 0.0
        n_cases = n_refused = 0
        for m, k, n, blocks in cases:
            kw = {} if blocks is None else dict(zip(("bm", "bn", "bk"),
                                                    blocks))
            x = torch.randn((m, k), generator=g, device=dev).to(dtype)
            w = torch.randn((k, n), generator=g, device=dev).to(dtype)
            if blocks and not supported(*blocks, x.element_size()):
                before = gemm_os.launches
                try:
                    gemm_os(x, w, **kw)
                except ValueError:
                    n_refused += 1
                else:
                    fail(f"gemm_os {dtype} took blocks {blocks} its path "
                         "lacks")
                if gemm_os.launches != before:
                    fail(f"gemm_os {dtype} launched on refused blocks")
                continue
            got = gemm_os(x, w, **kw)
            torch.cuda.synchronize()
            want = ref.gemm_ref(x, w)
            if not torch.isfinite(got.float()).all():
                fail(f"gemm_os {dtype} {m}x{k}x{n} not finite")
            e = (got.float() - want.float()).abs().max().item()
            tol = gemm_tol(want)
            if e > tol:
                fail(f"gemm_os {dtype} {m} x {k} x {n} blocks {blocks}: max "
                     f"abs err {e} > {tol}")
            worst, share = max(worst, e), max(share, e / tol)
            n_cases += 1
        max_err[dtype] = worst
        limit = (f"{GEMM_F32_RTOL} of |out|" if dtype == torch.float32
                 else "1 bf16 ulp of |out|")
        print(f"  gemm_os {str(dtype)[6:]}: {n_cases} cases, max abs err "
              f"{worst:.3g}, at most {share:.2f} of the limit ({limit}); "
              f"{n_refused} blocks the path lacks refused", flush=True)

    def timed(x, w, kw, peak, iters):
        nbytes, ops = gemm_bytes_ops(x, w)
        b_ms, b_by = bound_ms(nbytes, ops, peak)
        return dict(
            route="cuda", source="src/repro_torch/kernels/csrc/gemm_os.cu",
            replaces="src/repro/kernels/gemm_os.py:71",
            max_abs_err=max_err[x.dtype],
            ms=device_ms(lambda: gemm_os(x, w, **kw), iters=iters),
            plain_ms=device_ms(lambda: ref.gemm_ref(x, w), iters=iters),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda: torch.matmul(x, w), iters=iters),
            eager_ms=eager_ms(lambda: gemm_os(x, w, **kw),
                              iters=2 * iters))

    for i, (m, k, n) in enumerate(GEMM_MLP):
        x = (torch.randn((m, k), generator=g, device=dev)).bfloat16()
        w = (torch.randn((k, n), generator=g, device=dev)).bfloat16()
        row = timed(x, w, {}, PEAK_BF16_FLOPS, 5)
        if i == 0:
            results["gemm_os"] = row
        else:
            others["gemm_os@mlp_down"] = row
    x = torch.randn((256, 512), generator=g, device=dev)
    w = torch.randn((512, 256), generator=g, device=dev)
    others["gemm_os@microbench_f32"] = timed(
        x, w, dict(bm=128, bn=128, bk=128), PEAK_F32_FLOPS, 100)


def check_gemm_path():
    """The GEMM's main path, counted: zamba2's MLP over a 4096-token batch
    through the ``ops.gemm`` entry point, gelu(x @ w1) @ w2 in bfloat16
    with weights at the model's init scale, against the same chain through
    the same entry point on its plain version (``set_gemm_impl("torch")``;
    limit: 4 bf16 ulps of the largest output — the
    first product may differ by one ulp per element and the second sums
    those differences)."""
    from repro_torch.kernels import ops
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(51)
    (M, D, Fd), _ = GEMM_MLP
    x = torch.randn((M, D), generator=g, device=dev).bfloat16()
    w1 = (torch.randn((D, Fd), generator=g, device=dev) * D ** -0.5
          ).bfloat16()
    w2 = (torch.randn((Fd, D), generator=g, device=dev) * Fd ** -0.5
          ).bfloat16()

    def mlp(mm):
        return mm(F.gelu(mm(x, w1), approximate="tanh"), w2)

    y, launches = counted(lambda: mlp(ops.gemm))
    ops.set_gemm_impl("torch")
    try:
        want = mlp(ops.gemm)
    finally:
        ops.set_gemm_impl("cuda")
    e = (y.float() - want.float()).abs().max().item()
    tol = bf16_ulps(want.float(), 4)
    print(f"  gemm path (zamba2 MLP, {M} tokens, through ops.gemm): max abs "
          f"err {e:.3g} (limit {tol:.3g}), launches {launches['gemm_os']}",
          flush=True)
    if not torch.isfinite(y.float()).all() or e > tol:
        fail("the GEMM path disagrees with its plain version")
    if launches["gemm_os"] != 2:
        fail(f"gemm_os launched {launches['gemm_os']} times on its path; "
             "want 2")
    return launches


def check_zamba2_kernels(dev, others):
    """The serving kernels at zamba2-2.7b's shapes, new to them: the paged
    decode at B 6, H = K = 32 (no GQA), head_dim 80, 448 rows visible,
    with int8 side-pool frames (f32 2e-5, bf16 two bf16 ulps of |out|, as
    ``check_paged``); the scan at (1, 384, 80 heads, P 64), N 64, with and
    without an initial state (``SSD_RTOL``); the int8 pack and the unpack
    of one spilled page leaf, 9 sites x 16 rows x 32 heads = 4608 rows of
    80, bit-exact.  Each timed in bfloat16."""
    from repro_torch.kernels import offload_pack as kp
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    shape = dict(B=6, H=32, K=32, hd=80, page=16, pp=32, P=193, C=32)
    for dtype in (torch.float32, torch.bfloat16):
        args, side = paged_case(dev, dtype, seed=7, **shape)
        share = 0.0
        for idx in (0, 15, 127, 383, 447):
            for extra in ({}, side):
                got = paged_decode_attention(*args, idx, **extra)
                torch.cuda.synchronize()
                want = ref.paged_decode_attention_ref(*args, idx, **extra)
                tol = 2e-5 if dtype == torch.float32 else bf16_ulps(want, 2)
                e = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got.float()).all() or e > tol:
                    fail(f"paged decode at zamba2's shape {dtype} cache_index "
                         f"{idx}: max abs err {e} > {tol}")
                share = max(share, e / tol)
        print(f"  paged_decode_attention at hd 80, H = K = 32, "
              f"{str(dtype)[6:]}: at most {share:.2f} of the limit",
              flush=True)
        worst = 0.0
        for init in (False, True):
            x, dt, A, B, C, s0 = ssd_case(dev, dtype, 1, 384, 80, 1, 60,
                                          P=64, N=64, init=init)
            y, fin = ssd_scan(x, dt, A, B, C, 128, init_state=s0)
            torch.cuda.synchronize()
            wy, wfin = ref.ssd_chunked_ref(x, dt, A, B, C, 128,
                                           init_state=s0)
            for got, want in ((y, wy), (fin, wfin)):
                if not torch.isfinite(got.float()).all():
                    fail("ssd_scan at zamba2's shape not finite")
                worst = max(worst, (got.float() - want.float()).abs().max()
                            .item() / want.float().abs().max().item())
        print(f"  ssd_scan at 80 heads, N 64, {str(dtype)[6:]}: max |d| / "
              f"max |want| {worst:.3g} (limit {SSD_RTOL[dtype]})",
              flush=True)
        if worst > SSD_RTOL[dtype]:
            fail(f"ssd_scan at zamba2's shape {dtype}: off by {worst:.3g}")
        leaf = (torch.randn((9 * 16 * 32, 80), device=dev) * 3).to(dtype)
        R = leaf.shape[0]
        q, sc = kp.int8_pack(leaf, block_rows=R)
        qr, sr = ref.int8_pack_ref(leaf, R)
        if not (torch.equal(q, qr) and torch.equal(sc, sr) and torch.equal(
                kp.fp8_unpack(q, sc, block_rows=R, dtype=dtype),
                ref.fp8_unpack_ref(q, sc, R, dtype))):
            fail(f"int8 pack / unpack of a zamba2 page leaf ({dtype}) not "
                 "bit-exact")
    print("  int8_pack and unpack of a zamba2 page leaf (4608 x 80): "
          "bit-exact", flush=True)

    args, side = paged_case(dev, torch.bfloat16, seed=8, **shape)
    idx = 447

    def paged():
        return paged_decode_attention(*args, idx, **side)

    nbytes, ops = paged_bytes_ops(args, idx)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    others["paged_decode_attention@zamba2"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:189",
        max_abs_err=None, ms=device_ms(paged), plain_ms=device_ms(
            lambda: ref.paged_decode_attention_ref(*args, idx, **side)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: paged_library(args, side, idx)),
        eager_ms=eager_ms(paged))
    x, dt, A, B, C, _ = ssd_case(dev, torch.bfloat16, 1, 384, 80, 1, 61,
                                 P=64, N=64)
    nbytes, ops = ssd_bytes_ops(x, dt, B, None, 128)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    others["ssd_scan@zamba2"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:85", max_abs_err=None,
        ms=device_ms(lambda: ssd_scan(x, dt, A, B, C, 128), iters=20),
        plain_ms=device_ms(lambda: ref.ssd_chunked_ref(x, dt, A, B, C, 128),
                           iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        eager_ms=eager_ms(lambda: ssd_scan(x, dt, A, B, C, 128), iters=20))
    leaf = (torch.randn((9 * 16 * 32, 80), device=dev) * 3).bfloat16()
    n, R = leaf.numel(), leaf.shape[0]
    q, sc = kp.int8_pack(leaf, block_rows=R)
    for key, fn, plain, nbytes, site in (
            ("int8_pack@zamba2", lambda: kp.int8_pack(leaf, block_rows=R),
             lambda: ref.int8_pack_ref(leaf, R), n * 2 + n + 4,
             "src/repro/kernels/offload_pack.py:110"),
            ("fp8_unpack@zamba2", lambda: kp.fp8_unpack(q, sc, block_rows=R),
             lambda: ref.fp8_unpack_ref(q, sc, R, torch.bfloat16),
             n + 4 + 2 * n, "src/repro/kernels/offload_pack.py:86")):
        b_ms, b_by = bound_ms(nbytes, 3.0 * n, PEAK_F32_FLOPS)
        others[key] = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/offload_pack.cu",
            replaces=site, max_abs_err=0.0, ms=device_ms(fn),
            plain_ms=device_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=None, eager_ms=eager_ms(fn))


# ---------------------------------------------------------------------------
def main_path_logits(impl: str, forced=None):
    """Drive the main path's engine (fresh model from the same seed) with
    the paged decode on ``impl``.  Returns per decode call the logits of the
    decoding slots, the tokens they emitted and whether one of their live
    pages sat compressed in the int8 side pool.  With ``forced`` (another
    run's tokens, per call) the engine emits those instead of its own
    argmax: both runs then hold the same sequences on the same schedule,
    and their caches differ only by arithmetic."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(MAIN_ARGS)
    calls, compressed = [], []
    ops.set_paged_impl(impl)
    try:
        eng = serve.build_engine(args)
        cache, decode, sample = eng.cache, eng._decode, eng._sample

        def spy_decode(tok, length, mask):
            live = cache.page_map_host()[mask, : length // cache.page_size + 1]
            compressed.append(bool((live > cache.scratch_id).any()))
            return decode(tok, length, mask)

        def spy_sample(logits):
            toks = sample(logits) if forced is None else forced[len(calls)]
            if len(toks) != logits.shape[0]:
                fail("the forced run left the first run's schedule")
            calls.append((logits.float(), toks))
            return toks

        eng._decode, eng._sample = spy_decode, spy_sample
        serve.submit_requests(eng, args, {})
        eng.run()
    finally:
        ops.set_paged_impl("cuda")
    torch.cuda.synchronize()
    return calls, compressed


def check_main_path_logits() -> None:
    """The main path on the kernel against the main path on the plain
    version, every decode step, the second run forced onto the first's
    tokens."""
    want, _ = main_path_logits("torch")
    got, compressed = main_path_logits("cuda", [t for _, t in want])
    if len(got) != len(want):
        fail(f"kernel run made {len(got)} decode calls, plain run "
             f"{len(want)}")
    err_all = err_comp = mean = top = 0.0
    agree = rows = 0
    for (g, _), (w, toks), comp in zip(got, want, compressed):
        if not torch.isfinite(g).all():
            fail("main path logits are not finite")
        d = (g - w).abs()
        err_all = max(err_all, d.max().item())
        if comp:
            err_comp = max(err_comp, d.max().item())
        mean = max(mean, d.mean().item())
        top = max(top, w.abs().max().item())
        agree += sum(a == t for a, t in zip(g.argmax(-1).tolist(), toks))
        rows += len(toks)
    n_comp = sum(compressed)
    print(f"  main path logits, kernel vs plain over {len(got)} decode calls "
          f"({n_comp} with compressed pages mapped): max abs err "
          f"{err_all:.4g} (tol {LOGIT_ATOL}), {err_comp:.4g} on the "
          f"compressed calls, worst call's mean {mean:.3g} (tol "
          f"{LOGIT_MEAN_ATOL}), |logits| max {top:.3g}; kernel argmax = "
          f"plain token on {agree}/{rows} rows", flush=True)
    if n_comp == 0:
        fail("no decode call read a compressed page: the comparison "
             "missed the side pool")
    if err_all > LOGIT_ATOL or mean > LOGIT_MEAN_ATOL:
        fail("main path logits disagree with the plain version")


# ---------------------------------------------------------------------------
def kernel_counters():
    """Every ported kernel's wrapper (each counts its own launches)."""
    from repro_torch.kernels import offload_pack as kp
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.gemm_os import gemm_os
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"paged_decode_attention": paged_decode_attention,
            "int8_pack": kp.int8_pack, "fp8_unpack": kp.fp8_unpack,
            "fp8_pack": kp.fp8_pack, "blocksparse_pack": kp.blocksparse_pack,
            "flash_attention_fwd": flash_attention_fwd, "ssd_scan": ssd_scan,
            "gemm_os": gemm_os}


def counted(run):
    """Run ``run()`` with every launch count set to 0 just before it;
    returns (its result, the counts read just after)."""
    kernels = kernel_counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in kernels.items()}


def check_serve_main_path():
    """Phase 4's counted run: every request finishes, pages are evicted
    and resumed compressed, and the serving kernels launched."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(MAIN_ARGS))
    print(f"  launches on the serving path: {launches}", flush=True)
    report = eng.traffic_report()
    sessions = eng.sessions
    if len(sessions) != 16 or any(s.finish_reason != "length"
                                  or len(s.result()) != 64
                                  for s in sessions):
        fail("not every request finished with 64 tokens: " + str(
            [(s.uid, s.finish_reason, len(s.result())) for s in sessions]))
    vocab = eng.model.cfg.vocab_size
    if any(not 0 <= t < vocab for s in sessions for t in s.result()):
        fail("a generated token lies outside the vocabulary")
    if report["pages"]["evictions"] <= 0 or \
            report["decode_io"]["compressed_adopts"] <= 0:
        fail(f"the main path evicted {report['pages']['evictions']} pages "
             f"and adopted {report['decode_io']['compressed_adopts']} "
             "compressed: it must do both")
    if launches["paged_decode_attention"] <= 0:
        fail("kernel paged_decode_attention was not launched on the serving "
             "path")
    check_page_launches("smollm", report, launches)
    return launches


def check_page_launches(label, report, launches):
    """The spill's page path launches its codec kernels once a page: every
    tenant spills through int8, so one int8 pack a page evicted, and one
    unpack a page decoded into the pool (refetched and not adopted
    compressed, or a side-pool frame inflated)."""
    pages, dec = report["pages"], report["page_decodes"]
    adopts = report["decode_io"]["compressed_adopts"]
    print(f"  {label} page codec: {pages['evictions']} pages evicted, "
          f"int8_pack launched {launches['int8_pack']}x; {pages['refetches']}"
          f" refetched ({adopts} adopted compressed, {dec['refetched']} "
          f"decoded) + {dec['inflated']} side frames inflated, unpack "
          f"launched {launches['fp8_unpack']}x", flush=True)
    if dec["refetched"] != pages["refetches"] - adopts:
        fail(f"{label}: {dec['refetched']} refetched pages decoded; want "
             f"{pages['refetches']} refetched less {adopts} adopted")
    if launches["int8_pack"] != pages["evictions"]:
        fail(f"{label}: int8_pack launched {launches['int8_pack']} times for "
             f"{pages['evictions']} pages evicted; want one a page")
    if launches["fp8_unpack"] != dec["refetched"] + dec["inflated"]:
        fail(f"{label}: the unpack launched {launches['fp8_unpack']} times "
             f"for {dec['refetched'] + dec['inflated']} pages decoded; want "
             "one a page")


def check_train_path(label, argv, layers, steps, per_step,
                     require_fall=True):
    """A counted training run through ``repro_torch.launch.train``:
    ``steps`` full-width steps, host tier, fp8 stash codec.  Losses
    finite (and falling with ``require_fall``), the tier's traffic exact,
    each kernel of ``per_step`` launched that many times a step."""
    from repro_torch.launch import train as train_cli
    out, launches = counted(lambda: train_cli.main(argv))
    print(f"  launches on the {label} path: {launches}", flush=True)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        fail(f"{label} losses not finite or missing: {losses}")
    k = min(5, steps // 2)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"  losses: first {k} mean {first:.4f}, last {k} mean {last:.4f} "
          f"({losses[0]:.4f} -> {losses[-1]:.4f}): "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if require_fall and not last < first:
        fail(f"{label} loss did not fall: {losses}")
    report = out["model"].runtime.traffic_report()
    d_model = out["model"].cfg.d_model
    raw = layers * TRAIN_BATCH * TRAIN_SEQ * d_model * 2 * steps
    for d in ("stash", "fetch"):
        r = report.get(d, {})
        if r.get("raw_bytes") != raw or r.get("wire_bytes") != raw / 2 \
                or r.get("calls") != layers * steps:
            fail(f"memory traffic {d}: {r}; want {raw} raw bytes, half of "
                 f"them on the wire, {layers * steps} calls")
    print(f"  memory traffic: {out['model'].runtime.traffic_summary()}; "
          f"stash and fetch raw {raw} B each, wire half", flush=True)
    for name, n in per_step.items():
        if launches[name] != n * steps:
            fail(f"kernel {name} launched {launches[name]} times in "
                 f"{steps} steps; want {n} a step")
    ms = sorted(h["ms"] for h in hist[1:])
    step_ms = ms[len(ms) // 2]
    print(f"  step time: median {step_ms:.1f} ms over steps 2-{steps} "
          f"(first step {hist[0]['ms']:.1f} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.0f} tokens/s",
          flush=True)
    return out, launches


def profile_train_steps(out, start: int, n: int = 2):
    """Device time of ``n`` more steps of the trained state (batches from
    ``start`` on) under torch.profiler: busy and idle share, the
    stash/fetch copies' share, and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import to_device
    from repro_torch.train.loop import make_train_step
    model, tc, source, state = (out[k] for k in ("model", "tc", "source",
                                                 "state"))
    step = make_train_step(model, tc)
    batches = [to_device(source.batch_at(start + t), model.device)
               for t in range(n + 1)]
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[1:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets on the one stream
    # the step runs on); the CPU ops that launched them are not counted
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    copies = sum(ms for name, (ms, _) in by_name.items()
                 if name.startswith(("Memcpy DtoH", "Memcpy HtoD")))
    if busy <= 0:
        print("  profile: no device time recorded (not measured)",
              flush=True)
        return
    print(f"  profile of {n} steps: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
          f"stash/fetch copies {copies:.1f} ms ({copies / wall:.1%} of the "
          "wall time)", flush=True)
    for kind in ("flash", "ssd"):
        ms = sum(t for name, (t, _) in by_name.items() if kind in name)
        if ms:
            print(f"  {kind} kernels: {ms:.2f} ms of {n} steps "
                  f"({ms / busy:.1%} of the device time)", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (ms, count) in top:
        print(f"    {ms:9.2f} ms {ms / busy:6.1%} x{count:<5d} {name[:90]}",
              flush=True)


def train_steps_with(argv, kind: str, impl: str, n: int = 3, dtype=None):
    """``n`` full-width training steps of the run ``argv`` describes (its
    weights in ``dtype`` if given), from its weights and batches, with the
    ``kind`` kernel ("flash" or "ssd") on ``impl``; returns the losses and
    the first step's gradients."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import grads_of
    from repro_torch.train.optimizer import apply_adamw
    from repro_torch.train.train_state import init_state
    select = getattr(ops, f"set_{kind}_impl")
    select(impl)
    try:
        model, tc, source = train_cli.build_run(train_cli.parse_args(argv),
                                                dtype=dtype)
        state = init_state(model, tc)
        losses, first = [], None
        for t in range(n):
            batch = to_device(source.batch_at(t), model.device)
            g, _, m = grads_of(model, tc, state["params"], batch)
            if t == 0:
                first = g
            _, state["opt"], _ = apply_adamw(state["params"], g, state["opt"],
                                             tc)
            losses.append(float(m["loss"]))
    finally:
        select("cuda")
    torch.cuda.synchronize()
    return losses, first


def train_gap(got, want, label):
    """How far two ``train_steps_with`` results lie apart; prints it.
    Returns ``loss`` (max |d loss| over the steps), ``loss1`` (step 1's,
    from identical weights), ``leaf`` (the worst step-1 gradient leaf's
    max |d| / max |g|), ``leaf_norm`` (the worst leaf's |d| / |g| in the
    2-norm) and ``norm`` (|d| / |g| over all leaves at once)."""
    from repro_torch import tree
    (got_l, got_g), (want_l, want_g) = got, want
    gap = {"loss": max(abs(a - b) for a, b in zip(got_l, want_l)),
           "loss1": abs(got_l[0] - want_l[0]), "leaf": 0.0,
           "leaf_norm": 0.0}
    where = {}
    d2 = g2 = 0.0
    leaves_w, paths = tree.flatten(want_g)
    for w, g, path in zip(leaves_w, tree.leaves(got_g), paths):
        if not torch.isfinite(g.float()).all():
            fail(f"gradient {'/'.join(path)} not finite")
        w, d = w.float(), (g.float() - w.float())
        dn, wn = d.norm().item(), w.norm().item()
        d2, g2 = d2 + dn ** 2, g2 + wn ** 2
        for key, val in (("leaf", d.abs().max().item()
                          / (w.abs().max().item() or 1.0)),
                         ("leaf_norm", dn / (wn or 1.0))):
            if val > gap[key]:
                gap[key], where[key] = val, "/".join(path)
    gap["norm"] = (d2 / g2) ** 0.5 if g2 else 0.0
    print(f"  training, {label}, 3 steps: losses "
          f"{[round(x, 5) for x in got_l]} vs {[round(x, 5) for x in want_l]}"
          f", max |d loss| {gap['loss']:.3g} (step 1 {gap['loss1']:.3g}); "
          f"step 1 gradients: worst leaf {where.get('leaf')} max |d| / max "
          f"|g| {gap['leaf']:.3g}, worst leaf {where.get('leaf_norm')} |d| / "
          f"|g| {gap['leaf_norm']:.3g}, all leaves |d| / |g| "
          f"{gap['norm']:.3g}", flush=True)
    return gap


def check_train_kernel_vs_plain(argv, kind, label, loss_tol, grad_tol):
    """The training path with the ``kind`` kernel on its plain version,
    then on the kernel, from the same weights and batches: each step's
    loss and every gradient leaf of step 1."""
    gap = train_gap(train_steps_with(argv, kind, "cuda"),
                    train_steps_with(argv, kind, "torch"),
                    f"{label} kernel vs plain")
    print(f"    limits: {loss_tol} on the losses, {grad_tol} on the worst "
          "leaf's max |d| / max |g|", flush=True)
    if gap["loss"] > loss_tol or gap["leaf"] > grad_tol:
        fail(f"training with the {label} kernel disagrees with the plain "
             "version")


def check_train_flash_vs_plain() -> None:
    check_train_kernel_vs_plain(TRAIN_ARGS, "flash", "flash",
                                TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL)


def check_train_ssd_vs_plain() -> None:
    """Phase 7's comparison: 3 mamba2 steps from the same weights and
    batches, scan kernel against plain version, with the weights in
    float32 (limits ``SSM_TRAIN_F32_TOL``) and in bfloat16 (held to the
    distance between the plain version's bfloat16 and float32 runs)."""
    runs = {(dtype, impl): train_steps_with(SSM_TRAIN_ARGS, "ssd", impl,
                                            dtype=dtype)
            for dtype in ("float32", "bfloat16") for impl in ("torch", "cuda")}
    f32 = train_gap(runs["float32", "cuda"], runs["float32", "torch"],
                    "SSD scan kernel vs plain, float32")
    bf16 = train_gap(runs["bfloat16", "cuda"], runs["bfloat16", "torch"],
                     "SSD scan kernel vs plain, bfloat16")
    rounding = train_gap(runs["bfloat16", "torch"], runs["float32", "torch"],
                         "plain bf16 vs plain f32")
    print(f"    limits: float32 {SSM_TRAIN_F32_TOL}; bfloat16 step-1 loss "
          f"<= {rounding['loss1']:.3g} and all leaves <= "
          f"{rounding['norm']:.3g} (plain bf16 vs plain f32)", flush=True)
    if any(f32[k] > tol for k, tol in SSM_TRAIN_F32_TOL.items()):
        fail("training with the SSD scan kernel (float32) disagrees with "
             "the plain version")
    if bf16["loss1"] > rounding["loss1"] or bf16["norm"] > rounding["norm"]:
        fail("training with the SSD scan kernel (bfloat16): the kernel "
             "moves it further than bfloat16 rounding moves the plain "
             "version")


def check_blocksparse_path():
    """Three steps with the stash in pooled HBM through the blocksparse
    codec: finite losses, blocksparse_pack once per layer a step."""
    from repro_torch.launch import train as train_cli
    out, launches = counted(lambda: train_cli.main(BLOCKSPARSE_ARGS))
    losses = [h["loss"] for h in out["history"]]
    print(f"  mcdla + blocksparse: losses {[round(x, 4) for x in losses]}, "
          f"launches {launches}", flush=True)
    if len(losses) != 3 or not all(map(math.isfinite, losses)):
        fail(f"mcdla + blocksparse losses not finite: {losses}")
    for name, per_step in (("blocksparse_pack", TRAIN_LAYERS),
                           ("fp8_unpack", TRAIN_LAYERS),
                           ("flash_attention_fwd", 2 * TRAIN_LAYERS)):
        if launches[name] != 3 * per_step:
            fail(f"mcdla + blocksparse: {name} launched {launches[name]} "
                 f"times in 3 steps; want {per_step} a step")
    return launches


# ---------------------------------------------------------------------------
def serve_logits(argv, kinds, impl: str, dtype: str, forced=None):
    """Drive the serving path ``argv`` describes (fresh model from the same
    seed, its weights in ``dtype``) with the kernels of ``kinds`` ("paged",
    "ssd") on ``impl``.  Returns the logits and tokens of every sampling
    call (after each admission's prefill and each decode step) and how
    many engine steps decoded at more than one length.  With ``forced``
    (another run's tokens, per call) the engine emits those.  Every
    decode call is also checked to leave the recurrent (conv / ssm) state
    of the slots outside its length group bit for bit as it was
    (``stats["state_moved"]`` counts the calls that did not)."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import PAGED_KEYS
    args = serve.parse_args(argv)
    calls = []
    stats = {"steps": 0, "mixed": 0, "decodes": 0, "state_moved": 0}
    setters = [getattr(ops, f"set_{kind}_impl") for kind in kinds]
    for select in setters:
        select(impl)
    try:
        eng = serve.build_engine(args, dtype=dtype)
        decode, sample, step = eng._decode, eng._sample, eng.step

        def spy_sample(logits):
            toks = sample(logits) if forced is None else forced[len(calls)]
            if len(toks) != logits.shape[0]:
                fail("the forced run left the first run's schedule")
            calls.append((logits.float(), toks))
            return toks

        cache = eng.cache
        leaves, paths = tree.flatten(cache.slot_tree if cache.paged
                                     else cache.caches)
        state = [c for c, p in zip(leaves, paths) if p[-1] not in PAGED_KEYS]

        def spy_decode(tok, length, mask):
            stats["decodes"] += 1
            keep = torch.as_tensor(np.flatnonzero(~mask), device=tok.device)
            before = [c[:, keep].clone() for c in state]
            out = decode(tok, length, mask)
            stats["state_moved"] += any(not torch.equal(c[:, keep], b)
                                        for c, b in zip(state, before))
            return out

        def spy_step():
            before = stats["decodes"]
            n = step()
            stats["steps"] += 1
            stats["mixed"] += stats["decodes"] - before > 1
            return n

        eng._decode, eng._sample, eng.step = spy_decode, spy_sample, spy_step
        serve.submit_requests(eng, args, {})
        eng.run()
    finally:
        for select in setters:
            select("cuda")
    torch.cuda.synchronize()
    return calls, stats


def logit_gap(got, want, label):
    """(max |d|, worst call's mean |d|, rows whose argmax agrees) of two
    runs' sampling calls."""
    err = mean = 0.0
    agree = rows = 0
    for (g, _), (w, toks) in zip(got, want):
        if not torch.isfinite(g).all():
            fail(f"{label} serving logits are not finite")
        d = (g - w).abs()
        err, mean = max(err, d.max().item()), max(mean, d.mean().item())
        agree += int((g.argmax(-1) == w.argmax(-1)).sum())
        rows += len(toks)
    return err, mean, f"{agree}/{rows}"


def check_serve_kernels_vs_plain(label, argv, kinds, what, f32_tol=None,
                                 f32_share=None):
    """A serving path with the kernels of ``kinds`` against the same path
    with their plain versions, every sampling call, in bfloat16 (the main
    path) and with the weights in float32; every run after the first is
    forced onto the first's tokens.  float32 is held to ``f32_tol`` (max,
    worst call's mean) or to ``f32_share`` of the distance bfloat16
    rounding puts between the plain version's two runs, bfloat16 to all of
    that distance."""
    base, stats = serve_logits(argv, kinds, "torch", "bfloat16")
    print(f"  {label}: the conv / ssm state of the slots outside each "
          f"decode call's length group moved in {stats['state_moved']} of "
          f"{stats['decodes']} calls", flush=True)
    if stats["state_moved"]:
        fail(f"{label}: a decode call changed the recurrent state of slots "
             "it does not decode")
    forced = [t for _, t in base]
    runs = {("bfloat16", "torch"): base}
    for key in (("bfloat16", "cuda"), ("float32", "torch"),
                ("float32", "cuda")):
        runs[key] = serve_logits(argv, kinds, key[1], key[0], forced)[0]
        if len(runs[key]) != len(base):
            fail(f"run {key} made {len(runs[key])} sampling calls, the "
                 f"first {len(base)}")
    gaps = {"float32": logit_gap(runs["float32", "cuda"],
                                 runs["float32", "torch"], label),
            "bfloat16": logit_gap(runs["bfloat16", "cuda"], base, label),
            "bfloat16 rounding": logit_gap(base, runs["float32", "torch"],
                                           label)}
    top = max(w.abs().max().item() for w, _ in base)
    print(f"  {label} logits over {len(base)} sampling calls "
          f"({stats['decodes']} decode calls in {stats['steps']} engine "
          f"steps, {stats['mixed']} steps at mixed lengths), |logits| max "
          f"{top:.3g}:", flush=True)
    for name, (err, mean, agree) in gaps.items():
        line = ("plain bf16 vs plain f32" if name == "bfloat16 rounding"
                else f"{what} vs plain, {name}")
        print(f"    {line}: max abs err {err:.4g}, worst call's mean "
              f"{mean:.3g}, argmax agreement {agree}", flush=True)
    if stats["mixed"] == 0:
        fail("no engine step decoded at mixed lengths")
    err, mean, _ = gaps["float32"]
    if f32_tol is None:
        f32_tol = tuple(f32_share * g
                        for g in gaps["bfloat16 rounding"][:2])
    print(f"    limits: float32 {f32_tol[0]:.4g} max, {f32_tol[1]:.3g} "
          "worst call's mean; bfloat16 the plain bf16 vs f32 distance",
          flush=True)
    if err > f32_tol[0] or mean > f32_tol[1]:
        fail(f"{label} serving logits (float32) disagree with the plain "
             f"version beyond {f32_tol}")
    if any(a > b for a, b in zip(gaps["bfloat16"][:2],
                                 gaps["bfloat16 rounding"][:2])):
        fail(f"{label} serving logits (bfloat16): the kernels move them "
             "further than bfloat16 rounding moves the plain version")


def check_ssm_serve_logits() -> None:
    """Phase 6: mamba2 serving, the scan kernel against its plain
    version."""
    check_serve_kernels_vs_plain("mamba2", SSM_SERVE_ARGS, ("ssd",),
                                 "scan kernel", SSM_LOGIT_F32_TOL)


def check_zamba2_serve_logits() -> None:
    """Phase 8: zamba2 serving, the paged decode and the scan on their
    kernels against both on their plain versions (the int8 codec runs its
    kernels in every run)."""
    check_serve_kernels_vs_plain("zamba2", ZAMBA_ARGS,
                                 ("paged", "ssd"),
                                 "paged decode + scan kernels",
                                 f32_share=ZAMBA_LOGIT_F32_SHARE)


def check_ssm_serve_main_path():
    """Phase 6's counted run: every request finishes, the scan launches
    once per layer per admission, parked state comes back byte for byte."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(SSM_SERVE_ARGS))
    print(f"  launches on the mamba2 serving path: {launches}", flush=True)
    sessions = eng.sessions
    if len(sessions) != 16 or any(s.finish_reason != "length"
                                  or len(s.result()) != 64
                                  for s in sessions):
        fail("not every request finished with 64 tokens: " + str(
            [(s.uid, s.finish_reason, len(s.result())) for s in sessions]))
    # the reference samples greedily over the whole padded table (50432
    # rows for a 50280-token vocabulary), and so does the port
    vocab = eng.model.cfg.padded_vocab
    if any(not 0 <= t < vocab for s in sessions for t in s.result()):
        fail("a generated token lies outside the padded vocabulary")
    if launches["ssd_scan"] != SSM_LAYERS * len(sessions):
        fail(f"ssd_scan launched {launches['ssd_scan']} times for "
             f"{len(sessions)} admissions; want {SSM_LAYERS} each")
    report = eng.traffic_report()
    stash, fetch = report.get("kv_stash", {}), report.get("kv_fetch", {})
    print(f"  spill: stash {stash}, fetch {fetch}; preemptions "
          f"{sum(s.preemptions for s in sessions)}", flush=True)
    if not stash.get("calls") or any(stash.get(k) != fetch.get(k)
                                     for k in ("wire_bytes", "calls")):
        fail("the mamba2 spill did not move equal stash and fetch bytes")
    return launches


def check_zamba2_serve_main_path():
    """Phase 8's counted run: every request finishes; the scan launches
    once per Mamba2 block per admission and the paged decode once per site
    per decode call; pages are evicted and resumed compressed, slots
    parked; what was stashed comes back byte for byte; each park moves one
    session's state."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(ZAMBA_ARGS))
    print(f"  launches on the zamba2 serving path: {launches}", flush=True)
    sessions = eng.sessions
    if len(sessions) != 16 or any(s.finish_reason != "length"
                                  or len(s.result()) != 64
                                  for s in sessions):
        fail("not every request finished with 64 tokens: " + str(
            [(s.uid, s.finish_reason, len(s.result())) for s in sessions]))
    vocab = eng.model.cfg.padded_vocab
    if any(not 0 <= t < vocab for s in sessions for t in s.result()):
        fail("a generated token lies outside the padded vocabulary")
    report = eng.traffic_report()
    steps = report["decode_io"]["steps"]
    if launches["ssd_scan"] != ZAMBA_LAYERS * len(sessions):
        fail(f"ssd_scan launched {launches['ssd_scan']} times for "
             f"{len(sessions)} admissions; want {ZAMBA_LAYERS} each")
    if launches["paged_decode_attention"] != ZAMBA_SITES * steps:
        fail(f"paged_decode_attention launched "
             f"{launches['paged_decode_attention']} times in {steps} decode "
             f"calls; want {ZAMBA_SITES} each")
    check_page_launches("zamba2", report, launches)
    stash, fetch = report.get("kv_stash", {}), report.get("kv_fetch", {})
    slots = report["slots"]
    print(f"  spill: stash {stash}, fetch {fetch}; pages {report['pages']}; "
          f"slots parked {slots['parks']}x, {slots['park_bytes']} B; "
          f"compressed adoptions {report['decode_io']['compressed_adopts']};"
          f" preemptions {sum(s.preemptions for s in sessions)}", flush=True)
    if not stash.get("calls") or any(stash.get(k) != fetch.get(k)
                                     for k in ("wire_bytes", "calls")):
        fail("the zamba2 spill did not move equal stash and fetch bytes")
    if report["pages"]["evictions"] <= 0 or \
            report["decode_io"]["compressed_adopts"] <= 0 or \
            slots["parks"] <= 0:
        fail("the zamba2 path must evict pages, resume some compressed and "
             "park slots")
    if slots["park_bytes"] != slots["parks"] * ZAMBA_STATE_BYTES:
        fail(f"parked {slots['park_bytes']} B in {slots['parks']} parks; "
             f"want {ZAMBA_STATE_BYTES} B each")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port from {REPO}/src: {e}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def phase(title):
        print(f"== {title} (at {time.perf_counter() - t_start:.0f} s)",
              flush=True)

    phase("phase 1: device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind} ({card})",
          flush=True)

    phase("phase 2: build")
    t0 = time.perf_counter()
    built = build.build()
    for name, info in built.items():
        print(f"  {name}.cu: {info['seconds']:.1f}s", flush=True)
        for line in info["log"].splitlines():
            entry = line.split("Compiling entry function '")
            if len(entry) == 2:        # the mangled kernel name, shortened
                print(f"    {entry[1].split(chr(39))[0][:100]}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"  build: {time.perf_counter() - t0:.1f}s wall "
          f"({len(built)} libraries)", flush=True)

    phase("phase 3: kernels against their plain versions")
    results, others = {}, {}
    check_paged(dev, results)
    check_codec(dev, results, others)
    check_int8_pages(dev, results, others)
    check_flash(dev, results, others)
    check_ssd(dev, results, others)
    check_zamba2_kernels(dev, others)
    check_gemm(dev, results, others)
    by_path = {"gemm": check_gemm_path()}
    for name, r in list(results.items()) + list(others.items()):
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name}: {r['ms']:.4f} ms on the card (eager call "
              f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)

    phase("phase 4: serving main path (full-width smollm-135m, bf16)")
    check_main_path_logits()
    by_path["serve"] = check_serve_main_path()

    phase(f"phase 5: training main path (full-width smollm-135m, bf16, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, host tier, fp8 stash)")
    out, by_path["train"] = check_train_path(
        "training", TRAIN_ARGS, TRAIN_LAYERS, TRAIN_STEPS,
        {"fp8_pack": TRAIN_LAYERS, "fp8_unpack": TRAIN_LAYERS,
         "flash_attention_fwd": 2 * TRAIN_LAYERS})
    profile_train_steps(out, TRAIN_STEPS)
    del out
    check_train_flash_vs_plain()
    by_path["train_blocksparse"] = check_blocksparse_path()

    phase("phase 6: serving main path (full-width mamba2-370m, bf16, "
          "monolithic slots, host spill)")
    check_ssm_serve_logits()
    by_path["serve_mamba2"] = check_ssm_serve_main_path()

    phase(f"phase 7: training main path (full-width mamba2-370m, bf16, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, host tier, fp8 stash)")
    out, by_path["train_mamba2"] = check_train_path(
        "mamba2 training", SSM_TRAIN_ARGS, SSM_LAYERS, SSM_TRAIN_STEPS,
        {"fp8_pack": SSM_LAYERS, "fp8_unpack": SSM_LAYERS,
         "ssd_scan": 2 * SSM_LAYERS}, require_fall=False)
    profile_train_steps(out, SSM_TRAIN_STEPS)
    del out
    check_train_ssd_vs_plain()

    phase("phase 8: serving main path (full-width zamba2-2.7b, bf16, "
          "paged shared-block KV beside slot-shaped SSM state, int8 spill)")
    check_zamba2_serve_logits()
    by_path["serve_zamba2"] = check_zamba2_serve_main_path()
    phase("done")

    rows = []
    for name, r in results.items():
        paths = {p: c[name] for p, c in by_path.items() if c[name]}
        rows.append(dict(name=name, launches=sum(paths.values()),
                         launches_by_path=paths, **r))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
