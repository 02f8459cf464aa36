#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (each failure exits non-zero; nothing is caught and carried on):

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels  — holds each kernel against its plain PyTorch version on the
              card at the main paths' shapes (zamba2-2.7b's too: the paged
              decode at head_dim 80 without GQA, and h2o-danube-1.8b's
              at head_dim 80 with 32 heads over 8 kv heads, the scan at 80 heads of
              state 64 in a prefill and at 8 x 1024 tokens in training,
              the int8 codec on 80-column page rows, the fp8 codec on an
              8192 x 2560 stash, the flash forward at head_dim 80;
              mixtral-8x7b's: the paged decode at head_dim 128 with 32
              heads over 8, with and without a window that masks, the
              codecs on its 8-layer page, the fp8 codec on its
              8192 x 4096 stash, the flash forward at its training
              shape, d 128 over 8 kv heads; whisper-medium's: the paged
              decode at 16 heads of 64 over 16 (G 1), the flash forward
              non-causal over its 1500 frames (a ragged last kv tile)
              and with S != T (448 x 1500), causal at 448, the codecs on
              its page, the fp8 codec on its two stashes; qwen2-vl-2b's:
              the paged decode at 12 heads of 128 over 2 (G 6), the
              flash forward at 2048 rows, the codecs on its page) and
              times kernel, plain
              version, the
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
              Every pack (fp8, int8, blocksparse) and the shared unpack
              run a spilled page's leaves in one launch each way,
              straight from and into a full-width pool's frames
              (smollm's and zamba2's pages), and are held bit-exact
              there, on half-way ties, ragged tails and straddling row
              blocks, in each of the pack's regimes; the fp8 pack also on
              its reciprocal probe: values whose code from x times the
              rounded reciprocal of the scale is not that of x / scale
              (limit 0 bytes).
4. serve    — serves full-width smollm-135m (bf16, random weights from a
              seed) through ``repro_torch.launch.serve``: paged KV, in-place
              kernel decode, int8 spill codec through its kernels, an
              overcommitted pool with host spill, so pages are evicted,
              refetched and resumed compressed.  First the whole path runs
              twice, the paged decode on its plain version and then on the
              kernel, the second run emitting the first run's tokens: the
              logits of every decode step, those after compressed
              adoptions included, must agree.  Then the path runs once
              more, at 10 of the 30 layers, with the launch counts set to
              0, and checks every
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
              on 8 of the 16 requests, and every sampled step's logits
              must agree; then once more on all 16 at 16 of the 48
              layers, counted: every request finished, the scan launched
              once per layer per admission, the spill's stash and fetch
              bytes equal.
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
              path runs four times on 8 of the 16 requests at 18 of the
              54 Mamba2 blocks (3 of the 9 sites) — paged decode and scan
              plain, then on their kernels, in bfloat16 and with the
              weights in float32, every run after the first on the
              first's tokens; each still evicts pages, resumes some
              compressed and parks slots — and every sampling call's
              logits must agree; then once more on all 16 at those 18
              blocks, counted: every
              request finished, the scan launched once per
              Mamba2 block per admission, the paged decode once per site
              per decode call, the codec once a page, stash and fetch
              bytes equal, the parked state 37 MB a park.
9. train    — trains full-width zamba2-2.7b (bf16, random weights from a
   zamba2     seed) for 5 steps of 8 x 1024 tokens through
              ``repro_torch.launch.train``: all 63 sub-layers (54 Mamba2
              blocks, the shared block at its 9 sites, every site on the
              same weights) stash their input through the fp8 codec to
              pinned host memory and recompute in backward, the scan at
              80 heads and the flash forward at head_dim 80 on the
              training path.  Finite losses, the tier's bytes, the
              launches a step (fp8 pack and unpack 63, the scan 108, the
              flash forward 18); profiles two more steps; then 3 steps
              four times from the same weights and batches, the flash and
              scan kernels against their plain versions together, with
              the weights in float32 and in bfloat16, every loss and every
              step-1 gradient leaf compared.

10. serve   — serves full-width h2o-danube-1.8b (bf16, random weights
    danube     from a seed; GQA at head_dim 80) through
              ``repro_torch.launch.serve`` with prefix sharing: 16 requests
              of 384 / 448 tokens whose first 328 are shared, so later
              sessions bind 20 pages read-only, fork the 21st and prefill
              only their suffix; an overcommitted pool with int8 spill to
              pinned host memory and in-place kernel decode.  At 8 of the
              24 layers the path runs eight times, raw and int8 spill,
              sharing on and off, in bfloat16 and with the weights in
              float32, every run after the first on the first's tokens,
              and every sampled token's logits, keyed by (request, token
              index), must agree: sharing on against off (raw), and the
              int8 sharing-on run against its float32 twin and against
              the raw sharing-on run, both to a limit from the int8
              sharing-off pair; no run may write a shared frame.  Then
              once more at those 8 layers, counted: every request
              finished, prefix hits and forks, pages evicted and adopted
              compressed, the paged decode once per layer per decode call,
              the codec once a page.
11. MoE     — full-width mixtral-8x7b (bf16, random weights from a seed;
    mixtral    8 experts top-2, GQA at head_dim 128), cut in depth (32
              layers are ~93 GB).  Serves 8 layers through
              ``repro_torch.launch.serve``: an overcommitted pool with
              int8 spill and in-place kernel decode, prompts of 256 and
              384 tokens whose prefills drop tokens at expert capacity.
              Four runs on 8 of the 16 requests — the paged decode plain
              and on the kernel, in bfloat16 and with the weights in
              float32, every run after the first on the first's tokens
              and MoE routing — and every sampling call's logits must
              agree; then all 16, counted: 64 tokens a request, the paged
              decode once per layer per decode call, the codec once a
              page, equal stash and fetch bytes, pages evicted and
              resumed compressed, the prefill drops and each expert's
              tokens printed.  Trains 2 layers through
              ``repro_torch.launch.train`` for 5 steps of 8 x 1024 tokens
              (host tier, fp8 stash): finite losses, a finite aux loss
              above 0, the tier's bytes, the launches a step; profiles two
              more steps; then 3 steps twice in float32, the flash forward
              plain and on the kernel, every loss and every step-1
              gradient leaf (the router's included) compared.
12. enc-dec — (a) serves full-width qwen2-vl-2b (bf16, random weights
    and VLM     from a seed; 12 heads of 128 over 2, M-RoPE) as phase 11
              serves mixtral: four comparison runs at 8 of its 28
              layers on 8 requests, then all 16 at full depth, counted,
              with ``--prefix-share`` (the gate turns it off: 0 page
              hits).  (b) Trains full-width whisper-medium (24 encoder
              and 24 decoder layers) for 5 steps of 8 x 448 tokens over
              8 x 1500 frames (host tier, fp8 stash; the encoder's states
              stashed raw beside each decoder layer's input): the
              launches a step (fp8 pack and unpack 48, the flash forward
              144: encoder, causal self- and cross-attention, forward and
              recompute), the tier's bytes; profiles two more steps; then
              3 steps twice in float32 at 6 + 6 layers, the flash forward
              plain and on the kernel.  (c) Serves whisper through the
              in-place kernel decode: 8 requests of 128 / 192 tokens over
              6 slots of its 448 positions, an overcommitted pool with
              int8 spill, each preempted slot's cross-attention cache
              parked whole; the kernel path's logits are held to the
              paged-gather path's (the reference cannot run whisper's
              in-place decode: ROADMAP C10), bf16 and float32; then the
              counted run.  No engine path feeds frames or patches, in
              the reference either.
13. disagg  — serves full-width smollm-135m (bf16) disaggregated
              through ``repro_torch.launch.serve --role both``: a prefill
              engine of one monolithic slot prefills one prompt a step
              and publishes its KV pages to a transfer queue, a decode
              engine adopts them into phase 4's overcommitted pool and
              decodes on the paged decode kernel (passed through
              ``build_engine``, as the reference's build_disagg passes
              it; the command line refuses it beside ``--role``).  Six
              comparison runs of 8 requests, raw spill, every run on the
              first's tokens: the colocated engine and the pair over a
              host transfer tier on the gather path and on the kernel, in
              bfloat16 and float32; the streams each pair path shares
              with the colocated run are counted and every stream's
              logits held to a share of the colocated bf16 vs f32
              distance.  Then the counted run: 16 requests over a spill
              transfer tier with the int8 spill.  Every run fails on
              ``kv_publish`` bytes other than page bytes x shipped pages
              (368,640 B a page at 30 layers), a handoff lost or adopted
              twice, or a payload left in the transfer tier.

Each phase prints its wall time, and the script its whole.  The line
before the last is a JSON object with one entry per kernel (its launches
summed over the counted runs of phases 3 to 13, and per run); the last
line is ``{"ok": true, "device": {...}}``.
"""
import gc
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
# the counted run serves at 10 of the 30 layers (the script's budget; the
# two comparison runs keep all 30)
MAIN_COUNT_LAYERS = 10

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
# the counted run serves at 16 of the 48 layers (the script's budget; the
# comparison runs keep all 48)
SSM_COUNT_LAYERS = 16
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
# the plain version's run and its float32 run on the same streams.  The
# comparison runs take the first 8 of the 16 requests (more sessions than
# slots: preemption and decode at mixed lengths remain), to keep the
# script inside its time; the counted run serves all 16
SSM_LOGIT_F32_TOL = (1e-2, 1e-3)
SSM_CMP_ARGS = SSM_SERVE_ARGS + ["--requests", "8"]
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
# one Mamba2 block's conv and ssm state of a session in bf16: (80 heads x
# 64 x 64 + 3 x 5248 conv channels) x 2 bytes
ZAMBA_BLOCK_STATE_BYTES = (80 * 64 * 64 + 3 * 5248) * 2
# every sampling call's logits, kernels (paged decode and scan) against
# their plain versions on the first run's token streams, both held to the
# distance bfloat16 itself puts between the plain version's run and its
# float32 run: bfloat16 to all of it (as phase 6), float32 to 1/50 of it.
# Mamba2's absolute float32 limits (1e-2 max, 1e-3 worst-call mean), the
# first ones set here, read 0.0101 / 0.00188 on an H100 (700 W) over all
# 16 requests with the argmax equal on 1024 of 1024 rows: the random 63-layer stack amplifies
# rounding further than mamba2's (bf16 vs f32 4.08 / 0.675 against 2.80 /
# 0.417), so the limit follows that amplification (0.082 / 0.0135 there).
# The four comparison runs take the first 8 of the 16 requests (the three
# prompt lengths, more sessions than slots: 713 pages evicted, 697
# adopted compressed, 22 slots parked) and read, at this full depth, 0.0078
# / 0.00145 in float32 against a bf16 vs f32 distance of 3.48 / 0.592
# (limit 0.070 / 0.0118).  Planted kernel faults read far beyond it:
# side-pool frames dequantised with frame 0's scales 3.71 / 0.689
# (float32); the scan's state carried without its chunk decay (a bf16
# kernel fault) 5.35 / 1.0 in bfloat16 against 3.48 / 0.592.  The counted
# run serves all 16
ZAMBA_LOGIT_F32_SHARE = 0.02
ZAMBA_CMP_ARGS = ZAMBA_ARGS + ["--requests", "8"]
# the four comparison runs at 18 of the 54 Mamba2 blocks: the shared
# block's period of 6 kept, 3 of its 9 sites (the readings above are the
# full depth's; the counted run takes these 18 blocks too).  At 18 on an H100
# (700 W): bf16 vs f32 2.84 / 0.502, the kernels 0.0021 / 0.00036 in
# float32 (limit 0.057 / 0.010) and 0.88 / 0.149 in bfloat16; frame 0's
# scales read 2.46 / 0.439 in float32
ZAMBA_CMP_LAYERS = 18

# zamba2 training main path: 63 sub-layers (54 Mamba2 blocks and the
# shared block at 9 sites), 8 x 1024 tokens, host tier with the fp8 stash
# codec; 5 steps
ZAMBA_SUBLAYERS = ZAMBA_LAYERS + ZAMBA_SITES
ZAMBA_TRAIN_STEPS = 5
ZAMBA_TRAIN_ARGS = ["--arch", "zamba2-2.7b", "--device", "cuda", "--seed",
                    "0", "--batch", str(TRAIN_BATCH), "--seq",
                    str(TRAIN_SEQ), "--steps", str(ZAMBA_TRAIN_STEPS),
                    "--lr", "3e-4", "--policy", "host", "--compress", "fp8",
                    "--log-every", "1"]
# 3 training steps, flash and scan kernels together against their plain
# versions from the same weights and batches, as phase 7: float32 limits
# on every loss and on every step-1 gradient leaf's |d| / |g| (2-norm),
# phase 7's; on an H100 (700 W) they read 0.0020 (losses after step 1,
# which reads 5.7e-6) and 0.035 (a Mamba2 block's `A_log`).  bfloat16 is
# held to the distance between the plain version's bfloat16 and float32
# runs (1.29 over all leaves, 0.0011 on step 1's loss; the kernels read
# 1.02 and 7.3e-4).  Planted faults: the float32 causal mask shifted by
# one reads 0.0072 on the losses and 0.77 on `shared/attn/wq`; in
# bfloat16 the shifted mask reads 0.0021 and the scan's state carried
# without its chunk decay 0.0056 on step 1's loss (all leaves 1.04 and
# 1.05: at this depth bfloat16 rounding hides them in the gradients)
ZAMBA_TRAIN_F32_TOL = {"loss": 5e-3, "leaf_norm": 5e-2}

# h2o-danube-1.8b prefix-sharing serving main path: full-width (24 layers,
# d 2560, 32 query heads of 80 over 8 kv heads), 16 requests of 384 / 448
# prompt tokens whose first 328 are one shared head (20 whole pages of 16
# and 8 rows: later sessions bind 20 pages read-only and fork page 21) +
# 64 new, over 6 slots of 512 rows, a pool of 96 pages of 16 (192 pages'
# worth of slots: overcommitted), int8 spill to pinned host memory,
# in-place kernel decode, fair preemption every 16 tokens.  Its 4096-row
# window is longer than any session, so the window term masks nothing
# here (the CPU tests reach it on the reduced config's 64 rows)
DANUBE_PAGES = 96
DANUBE_ARGS = ["--arch", "h2o-danube-1.8b", "--device", "cuda", "--seed",
               "0", "--batch", "6", "--max-len", "512", "--page-size", "16",
               "--pages", str(DANUBE_PAGES), "--requests", "16",
               "--prompt-len", "384,448", "--new-tokens", "64",
               "--scheduler", "fair", "--quantum", "16", "--spill", "host",
               "--page-codec", "int8", "--decode-kernel",
               "--shared-prefix", "328", "--prefix-share"]
# every sampled token's logits, keyed by (request, token index), sharing
# on against sharing off on the first run's tokens.  Sharing changes the
# page pressure and so which pages go through the lossy int8 codec (on
# the smoke twin 368 pages evicted with sharing, 4061 without), so these
# runs spill raw pages: a suffix prefill over grafted rows then differs
# from a whole-prompt prefill by arithmetic only.  Both are held to
# shares of the distance bfloat16 itself puts between the sharing-off run
# and its float32 run (as phase 8).  On an H100 (700 W), over all 1024
# sampled tokens at full depth, that distance read 0.112 max / 0.017
# worst row's mean with |logits| up to 5.5; sharing on vs off read
# 1.23e-5 / 2.41e-6 in float32 (limit 1/50 of the distance) and 0.086 /
# 0.0146 in bfloat16.  In bfloat16 the two runs take two rounding paths
# (suffix prefill, whole-prompt prefill), each about one such distance
# from float32, so their own distance may come near twice it: the limit
# is 1.5 times it.  A suffix prefill that attends only to its in-flight
# tokens read 6.66 / 1.19 in both
_CODEC = DANUBE_ARGS.index("--page-codec")
DANUBE_CMP_ARGS = DANUBE_ARGS[:_CODEC] + DANUBE_ARGS[_CODEC + 2:]
DANUBE_CMP_UNSHARED_ARGS = DANUBE_CMP_ARGS[:-1]
DANUBE_F32_SHARE, DANUBE_BF16_SHARE = 0.02, 1.5
# The comparison runs take 8 of the 24 layers (the readings above are the
# full depth's), every limit from runs at that depth.  Besides the raw
# runs, the int8 spill's: sharing on and off, bfloat16 and float32, on one
# page schedule per sharing setting (the schedule depends only on
# lengths), so a bf16 run and its f32 twin quantise the same pages.  The
# int8 sharing-on run is held (a) to its float32 twin and (b), in
# float32, to the raw sharing-on run (the codec's own effect), both to
# DANUBE_INT8_SHARE times the int8 sharing-off pair's bf16 vs f32
# distance.  On an H100 (700 W) at 8 layers that distance read 0.156 /
# 0.0274 (max, worst row's mean), (a) 0.121 / 0.0207 and (b) 0.073 /
# 0.0131.  (a) alone cannot see a fault that both dtypes share: a
# side-pool frame read with its neighbour's scale moved (a) to 0.176 /
# 0.0319 (the limit grew with it, to 1.5 x 0.188 / 0.0347) and (b) to
# 1.75 / 0.315
DANUBE_CMP_LAYERS = 8
DANUBE_INT8_ARGS, DANUBE_INT8_UNSHARED_ARGS = DANUBE_ARGS, DANUBE_ARGS[:-1]
# Since phase 13 the comparison runs take the first 8 of the 16 requests
# (the readings above are from all 16; phase 13 is paid for here): on the
# smoke twin, whose page schedule depends only on lengths, sharing still
# hits 140 pages and forks 7, 6 pages are evicted (and adopted compressed,
# int8) with sharing and 1757 without.  The counted run serves all 16
DANUBE_CMP_ARGS, DANUBE_CMP_UNSHARED_ARGS, DANUBE_INT8_ARGS, \
    DANUBE_INT8_UNSHARED_ARGS = (
        argv + ["--requests", "8"] for argv in (
            DANUBE_CMP_ARGS, DANUBE_CMP_UNSHARED_ARGS, DANUBE_INT8_ARGS,
            DANUBE_INT8_UNSHARED_ARGS))
DANUBE_INT8_SHARE = 1.5

# mixtral-8x7b (phase 11): full width (d 4096, 32 query heads of 128 over 8
# kv heads, 8 experts top-2 of d_ff 14336, window 4096), cut in depth: its
# 32 layers are ~93 GB in bf16.  Serving at 8 layers (~23.7 GB; ~47 GB in
# float32): 16 requests of 256 / 384 prompt tokens + 64 new over 6 slots
# of 512 rows, an overcommitted pool of 96 pages of 16, int8 spill to
# pinned host memory, in-place kernel decode, fair preemption every 16
# tokens.  A 384-token prefill routes 768 assignments into 8 experts of
# capacity 120, so tokens drop
MIXTRAL_SERVE_LAYERS, MIXTRAL_PAGES = 8, 96
MIXTRAL_ARGS = ["--arch", "mixtral-8x7b", "--device", "cuda", "--seed", "0",
                "--batch", "6", "--max-len", "512", "--page-size", "16",
                "--pages", str(MIXTRAL_PAGES), "--requests", "16",
                "--prompt-len", "256,384", "--new-tokens", "64",
                "--scheduler", "fair", "--quantum", "16", "--spill", "host",
                "--page-codec", "int8", "--decode-kernel"]
# four comparison runs on 8 of the requests, as phase 8's: the paged
# decode plain and on the kernel, in bfloat16 and with the weights in
# float32, every run after the first forced onto the first's tokens and
# every MoE block onto the first's routing (a routing decision that flips
# between two runs moves the logits by about a logit's size, so unforced
# flips would swamp the limits).  float32 kernel vs plain is held to
# MIXTRAL_LOGIT_F32_SHARE of the plain bf16 vs f32 distance, bfloat16 to
# all of it
MIXTRAL_LOGIT_F32_SHARE = 0.02
MIXTRAL_CMP_ARGS = MIXTRAL_ARGS + ["--requests", "8"]
# training at 2 layers: bf16 params and grads and float32 AdamW moments
# come to ~38 GB; 5 steps of 8 x 1024 tokens, host tier, fp8 stash.  Then
# 3 steps twice in float32, the flash forward plain and on the kernel,
# every loss and every step-1 gradient leaf (the router's included) held
# to phase 7's float32 limits
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_STEPS = 2, 5
MIXTRAL_TRAIN_ARGS = ["--arch", "mixtral-8x7b", "--device", "cuda", "--seed",
                      "0", "--batch", str(TRAIN_BATCH), "--seq",
                      str(TRAIN_SEQ), "--steps", str(MIXTRAL_TRAIN_STEPS),
                      "--lr", "3e-4", "--policy", "host", "--compress",
                      "fp8", "--log-every", "1"]
MIXTRAL_TRAIN_F32_TOL = {"loss": 5e-3, "leaf_norm": 5e-2}

# qwen2-vl-2b (phase 12): full width (28 layers, d 1536, 12 query heads of
# 128 over 2 kv heads, M-RoPE, tied vocabulary of 151,936), as phase 11's
# serving: 16 requests of 256 / 384 prompt tokens + 64 new over 6 slots of
# 512 rows, an overcommitted pool of 96 pages of 16, int8 spill to pinned
# host memory, in-place kernel decode, fair preemption every 16 tokens;
# ``--prefix-share`` is passed and the gate turns it off (M-RoPE).  No
# engine path feeds patches (nor does the reference's): the prompts are
# text, on three equal M-RoPE axes.  Four comparison runs at 8 of the 28
# layers on 8 requests, as phase 11's (the paged decode plain and on the
# kernel, bf16 and float32; float32 held to 1/50 of the plain bf16 vs
# f32 distance, bf16 to all of it); the counted run at full depth
QWEN_LAYERS, QWEN_PAGES, QWEN_CMP_LAYERS = 28, 96, 8
QWEN_ARGS = ["--arch", "qwen2-vl-2b", "--device", "cuda", "--seed", "0",
             "--batch", "6", "--max-len", "512", "--page-size", "16",
             "--pages", str(QWEN_PAGES), "--requests", "16",
             "--prompt-len", "256,384", "--new-tokens", "64",
             "--scheduler", "fair", "--quantum", "16", "--spill", "host",
             "--page-codec", "int8", "--decode-kernel"]
QWEN_CMP_ARGS = QWEN_ARGS + ["--requests", "8"]
QWEN_LOGIT_F32_SHARE = 0.02

# whisper-medium (phase 12): full width (24 encoder and 24 decoder layers,
# d 1024, 16 heads of 64 without GQA, 1500 encoder frames).  Training: 5
# steps of 8 x 448 decoder tokens over 8 x 1500 frames, host tier, fp8
# stash: each of the 48 layers stashes its input through the fp8 codec
# and every decoder layer the encoder's states beside it, raw (as the
# reference stashes float aux); the flash forward runs 72 times in the
# forward (24 encoder layers non-causal at 1500 x 1500, 24 causal
# self-attentions at 448, 24 cross-attentions at 448 x 1500) and 72 in
# the recompute.  Then 3 steps twice in float32, the flash forward plain
# and on the kernel, at 6 encoder and 6 decoder layers, held to phase
# 7's float32 limits
WHISPER_LAYERS, WHISPER_FRAMES, WHISPER_SEQ = 24, 1500, 448
WHISPER_TRAIN_STEPS, WHISPER_TRAIN_CMP_LAYERS = 5, 6
WHISPER_TRAIN_ARGS = ["--arch", "whisper-medium", "--device", "cuda",
                      "--seed", "0", "--batch", str(TRAIN_BATCH), "--seq",
                      str(WHISPER_SEQ), "--steps", str(WHISPER_TRAIN_STEPS),
                      "--lr", "3e-4", "--policy", "host", "--compress",
                      "fp8", "--log-every", "1"]
WHISPER_TRAIN_F32_TOL = {"loss": 5e-3, "leaf_norm": 5e-2}
# serving: 8 requests of 128 / 192 prompt tokens + 64 new over 6 slots of
# its 448 decoder positions, an overcommitted pool of WHISPER_PAGES pages
# of 16, int8 spill, in-place kernel decode (24 paged decodes a decode
# call), fair preemption every 16 tokens: a preempted slot parks its
# cross-attention cache whole, 24 layers x 2 x 1500 x 16 x 64 bf16.  The
# reference cannot run whisper's in-place decode (ROADMAP C10), so the
# kernel path's logits are held to the paged-gather path's (the plain
# decode attention over the gathered pages), in bf16 and float32, all 8
# streams, every run after the first on the first's tokens: float32 to
# 1/50 of the gather path's bf16 vs f32 distance, bf16 to all of it.
# The four comparison runs take 8 of the 24 decoder layers (the script's
# time budget); the counted run serves all 24
WHISPER_PAGES, WHISPER_SERVE_CMP_LAYERS = 48, 8
WHISPER_ARGS = ["--arch", "whisper-medium", "--device", "cuda", "--seed",
                "0", "--batch", "6", "--max-len", str(WHISPER_SEQ),
                "--page-size", "16", "--pages", str(WHISPER_PAGES),
                "--requests", "8", "--prompt-len", "128,192",
                "--new-tokens", "64", "--scheduler", "fair", "--quantum",
                "16", "--spill", "host", "--page-codec", "int8",
                "--decode-kernel"]
WHISPER_GATHER_ARGS = WHISPER_ARGS[:-1]
WHISPER_CROSS_BYTES = WHISPER_LAYERS * 2 * WHISPER_FRAMES * 16 * 64 * 2
WHISPER_LOGIT_F32_SHARE = 0.02

# disaggregated serving (phase 13): phase 4's settings through a prefill /
# decode pair (``--role both``): prompts prefill one a step in a prefill
# engine's one monolithic slot, their KV pages ship through a transfer
# tier, and a decode engine adopts them into phase 4's overcommitted pool
# (int8 spill, fair preemption every 16 tokens).  The command line refuses
# --decode-kernel beside --role; the kernel path reaches the decode engine
# through ``build_engine``'s keyword, as the reference's build_disagg
# passes it.  The comparisons run 8 requests through the colocated engine
# (phase 4's, kernel decode) and the pair over a host transfer tier on the
# gather path and on the kernel, in bfloat16 and with the weights in
# float32, every run on the first's tokens.  The pair prefills one prompt
# a step, so its decode batches may form otherwise than the colocated
# engine's and cuBLAS may pick other kernels for them: streams are
# counted, not required equal, and every stream's logits are held to a
# share of the colocated pair's bf16 vs f32 distance (bfloat16 1.5 of it,
# as phase 10; float32 1/50, as phases 8 and 10).  The pair's adoptions
# also fill the pool on another schedule than the colocated admissions,
# so other pages are evicted: on the smoke twin through the int8 codec the
# float32 pair differed from the colocated run by 0.9 of the bf16 vs f32
# distance, codec error and not arithmetic.  So the comparison runs spill
# raw pages (as phase 10's); the counted run keeps the int8 spill.  On an
# H100 (700 W) at 30 layers the colocated bf16 vs f32 distance read
# 0.0544 / 0.0089; the pair on the kernel streamed bit for bit what the
# colocated engine did in both dtypes (8 of 8 streams, 0 apart); on the
# gather path 0 of 8 streams in bf16 (0.0469 / 0.0076: kernel against
# plain decode) and 8 of 8 in f32 (2.6e-6).  Adopted pages landing one
# frame late read 1.21 / 0.22, a handoff one page short 1.50 / 0.28
_KERNEL = MAIN_ARGS.index("--decode-kernel")
_CODEC = MAIN_ARGS.index("--page-codec")
DISAGG_GATHER_ARGS = MAIN_ARGS[:_KERNEL] + MAIN_ARGS[_KERNEL + 1:] + [
    "--role", "both"]
DISAGG_COLO_CMP_ARGS = MAIN_ARGS[:_CODEC] + MAIN_ARGS[_CODEC + 2:] + [
    "--requests", "8"]
DISAGG_CMP_ARGS = [a for i, a in enumerate(DISAGG_GATHER_ARGS)
                   if i not in (_CODEC, _CODEC + 1)] + [
    "--requests", "8", "--transfer-tier", "host"]
DISAGG_ARGS = DISAGG_GATHER_ARGS + ["--transfer-tier", "spill"]
# the comparisons took 111 s at 30 layers on an H100 (700 W), so the
# counted run serves at 10 of the 30 (as phase 4's)
DISAGG_CMP_LAYERS, DISAGG_COUNT_LAYERS = 30, 10
DISAGG_BF16_SHARE, DISAGG_F32_SHARE = 1.5, 0.02
# one smollm page a layer: k and v, 16 rows of 3 kv heads of 64 (x 2 B in
# bf16: 368,640 B a page at 30 layers)
SMOLLM_PAGE_LAYER_ELEMS = 2 * 16 * 3 * 64


def cut(arch: str, layers: int):
    """``arch``'s configuration at full width, cut to ``layers`` layers
    (an encoder-decoder's encoder too)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    cfg = ARCHS[arch]
    return dataclasses.replace(cfg, num_layers=layers, encoder_layers=(
        layers if cfg.is_encoder_decoder else 0))


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


def paged_bytes_ops(args, idx, window=0):
    """Bytes the decode must move (q, page map, the live pages' K/V — int8
    plus a scale for side-pool pages —, out) and its QK/PV operations;
    with ``window`` only the pages and rows inside it."""
    q, kp, _, pm = args
    B, _, H, hd = q.shape
    P, page, K, _ = kp.shape
    first = max(0, idx - window + 1) if window > 0 else 0
    live = pm[:, first // page: idx // page + 1].reshape(-1)
    n_comp = int((live >= P).sum())
    n_raw = live.numel() - n_comp
    per_page = page * K * hd
    nbytes = (2 * q.numel() * q.element_size() + pm.numel() * 4
              + 2 * n_raw * per_page * kp.element_size()
              + 2 * n_comp * (per_page + 4))
    ops = 4.0 * B * H * hd * (idx + 1 - first)
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


def paged_library(args, side, idx, window=0):
    """Yardstick of the paged decode (not used by the port): inflate the
    page map, int8 side frames included, and one SDPA call over the rows
    up to ``idx`` (inside ``window``)."""
    from repro_torch.kernels import ref
    q, kp, vp, pm = args
    k = ref.inflate_pages_ref(kp, pm, side["kq_pool"], side["k_scale"])
    v = ref.inflate_pages_ref(vp, pm, side["vq_pool"], side["v_scale"])
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos <= idx
    if window > 0:
        mask &= pos > idx - window
    mask = mask[None, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)


def check_paged(dev, results, others):
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
    # h2o-danube-1.8b's serving shape (phase 10): GQA at head_dim 80, 32
    # query heads over 8 kv heads (G 4), 6 slots of 32 pages, a pool and a
    # side pool of DANUBE_PAGES frames, up to 511 rows visible
    check_paged_at(dev, others, "danube", "hd 80, H 32 over K 8 (G 4)",
                   dict(B=6, H=32, K=8, hd=80, page=16, pp=32,
                        P=DANUBE_PAGES + 1, C=DANUBE_PAGES),
                   (0, 15, 16, 327, 328, 447, 510), seed=11)
    # mixtral-8x7b's serving shape (phase 11): head_dim 128, 32 query heads
    # over 8 kv heads (G 4), 6 slots of 32 pages, a pool and a side pool of
    # MIXTRAL_PAGES frames, up to 511 rows visible; then a 256-row window
    # that masks (mixtral's own 4096 masks nothing at 512 rows)
    mixtral = dict(B=6, H=32, K=8, hd=128, page=16, pp=32,
                   P=MIXTRAL_PAGES + 1, C=MIXTRAL_PAGES)
    check_paged_at(dev, others, "mixtral", "hd 128, H 32 over K 8 (G 4)",
                   mixtral, (0, 15, 16, 255, 256, 383, 510), seed=13)
    check_paged_at(dev, others, "mixtral_window",
                   "hd 128, H 32 over K 8, window 256", mixtral,
                   (0, 255, 256, 300, 383, 510), seed=15, window=256)
    # phase 12's serving shapes: whisper-medium's MHA (16 heads of 64 over
    # 16 kv heads, G 1) over 6 slots of its 448 decoder rows (28 pages),
    # up to 447 rows visible; qwen2-vl-2b's GQA (12 heads of 128 over 2,
    # G 6) over 6 slots of 32 pages, up to 510.  96 frames and 96 side
    # frames each (the page maps draw distinct frames from both)
    check_paged_at(dev, others, "whisper", "hd 64, H 16 over K 16 (G 1)",
                   dict(B=6, H=16, K=16, hd=64, page=16, pp=28, P=97, C=96),
                   (0, 15, 16, 127, 128, 255, 447), seed=17)
    check_paged_at(dev, others, "qwen2vl", "hd 128, H 12 over K 2 (G 6)",
                   dict(B=6, H=12, K=2, hd=128, page=16, pp=32,
                        P=QWEN_PAGES + 1, C=QWEN_PAGES),
                   (0, 15, 16, 255, 256, 383, 510), seed=19)


def codec_case(dev, dtype, R, C, seed):
    """(R, C) values spread over magnitudes, with, in the first row, the
    block's absmax (448: the fp8 scale comes out 1.0 exactly), its
    negative, fp8 rounding ties (1.0625, -3.375), e4m3 subnormals and
    their ties (2^-9; 1.5, -2.5 and -0.5 x 2^-9), zeros and the
    blocksparse threshold absmax / 32 (+-14 kept, 13.875 pruned); the
    lower half of the rows is scaled into the subnormal range."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((R, C), generator=g, device=dev) * 60
    x[R // 2:] *= 1e-3                      # small values: subnormal range
    special = torch.tensor([448.0, -448.0, 1.0625, -3.375, 2.0 ** -9,
                            1.5 * 2.0 ** -9, -2.5 * 2.0 ** -9,
                            -(2.0 ** -10), 0.0, 447.9, 14.0, -14.0, 13.875],
                           device=dev)
    x[0, :special.numel()] = special
    return x.clamp(-448.0, 448.0).to(dtype)


def codec_packs():
    """``{name: (kernel wrapper, plain version, batched wrapper, batched
    plain version)}`` of the three packs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    return {name: (getattr(kp, name), getattr(ref, name + "_ref"),
                   getattr(kp, name + "_leaves"),
                   getattr(ref, name + "_leaves_ref"))
            for name in ("fp8_pack", "int8_pack", "blocksparse_pack")}


PACK_SITES = {"fp8_pack": "src/repro/kernels/offload_pack.py:63",
              "int8_pack": "src/repro/kernels/offload_pack.py:110",
              "blocksparse_pack": "src/repro/kernels/offload_pack.py:143"}
UNPACK_SITE = "src/repro/kernels/offload_pack.py:86"


def codec_row(fn, plain, nbytes, n, replaces):
    """A codec kernel's timing row: device and eager ms of ``fn``, its plain
    version's device ms, and the bound of ``nbytes`` moved and 3 f32
    operations an element of ``n``."""
    b_ms, b_by = bound_ms(nbytes, 3.0 * n, PEAK_F32_FLOPS)
    return dict(route="cuda",
                source="src/repro_torch/kernels/csrc/offload_pack.cu",
                replaces=replaces, max_abs_err=0.0, ms=device_ms(fn),
                plain_ms=device_ms(plain), bound_ms=b_ms, bound_by=b_by,
                library_ms=None, eager_ms=eager_ms(fn))


def fp8_probe_differs(dev, rows, cols):
    """The fp8 reciprocal probe (``offload_pack.fp8_probe``) packed on the
    card, f32 and bf16: each probe row as one row block of a row, then
    each row laid into a zero (rows, cols) tensor as one row block (both
    of the pack's regimes).  Returns (probe values, payload bytes that
    differ from the plain version)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    n_vals, bad = 0, 0
    for dtype in (torch.float32, torch.bfloat16):
        probe = kp.fp8_probe(dtype).to(dev)
        n_vals += int((probe != 0).sum()) - probe.shape[0]
        cases = [(probe, 1)]
        for row in probe:
            x = torch.zeros((rows, cols), device=dev, dtype=dtype)
            x.view(-1)[:row.numel()] = row
            cases.append((x, rows))
        for x, br in cases:
            q, s = kp.fp8_pack(x, block_rows=br)
            qr, sr = ref.fp8_pack_ref(x, br)
            bad += int((q.view(torch.uint8) != qr.view(torch.uint8)).sum())
            bad += int((s != sr).sum())
    return n_vals, bad


def check_codec(dev, results, others):
    """The fp8 reciprocal probe (limit 0 bytes); then fp8, int8 and
    blocksparse packs and the shared unpack (int8 and fp8 payloads),
    bit-exact against their plain versions: at the training shape as one
    row block (a whole stashed layer input), at the serving page-leaf
    shape as 1, 9 and 90 row blocks, and at 4 value spreads.  Times go to
    ``results`` at each kernel's main-path shape and to ``others`` at its
    other shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    packs = codec_packs()
    train_rc = (8 * 1024, 576)       # one stashed layer input, full width
    leaf_rc = (30 * 16 * 3, 64)      # one spilled page leaf, full width
    n_vals, bad = fp8_probe_differs(dev, *train_rc)
    print(f"  fp8_pack reciprocal probe: {n_vals} values whose code from x "
          "times 1/s rounded is not that of x / s (f32, bf16; exact ties "
          "and values off them; normal and subnormal; scales 1.75 and "
          f"1.875; every regime): {bad} bytes differ (limit 0)", flush=True)
    if bad:
        fail(f"fp8_pack reciprocal probe: {bad} bytes differ (limit 0)")
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
                for name, (kern, plain, _, _) in packs.items():
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
          "(f32 and bf16; 8192 x 576 as one row block with fp8 ties, "
          "subnormals and the blocksparse threshold; 1440 x 64 as 1, 9 and "
          "90 row blocks at 4 spreads; all zeros)", flush=True)

    # times, on randn values (their fp8 scale is no power of two, as a
    # stash's almost always is; codec_case's absmax 448 makes it 1, where
    # one bf16 value in 16 lies on an e4m3 midpoint and takes the fp8
    # pack's slow path): fp8 and blocksparse at their main path's shape
    # (the training stash of smollm), and at mamba2's stash and a page
    # leaf for the log; int8 at 8192 x 576 and a page leaf for the log (its
    # main-path row is the page, check_codec_pages); the unpack at the
    # training stash (fp8 payload) and a page leaf.  Each pack's bound
    # reads x once and writes a byte an element and a scale, as each pack
    # reads x from HBM once (a row block in the registers of a cluster or
    # of the card, or a second pass reading x from L2)
    shapes = {"train": train_rc, "mamba2": (8 * 1024, 1024), "leaf": leaf_rc}
    for tag, rc in shapes.items():
        g = torch.Generator(device=dev).manual_seed(7)
        x = (torch.randn(rc, generator=g, device=dev) * 3).to(torch.bfloat16)
        n, R = x.numel(), x.shape[0]
        for name, (kern, plain, _, _) in packs.items():
            if tag == "mamba2" and name == "int8_pack":
                continue
            main = tag == "train" and name != "int8_pack"
            row = codec_row(lambda: kern(x, block_rows=R), lambda: plain(x, R),
                            n * 2 + n + 4, n, PACK_SITES[name])
            if main:
                results[name] = row
            else:
                others[f"{name}@{tag}"] = row
        if tag == "mamba2":
            continue
        pack = kp.fp8_pack if tag == "train" else kp.int8_pack
        q, s = pack(x, block_rows=R)
        row = codec_row(lambda: kp.fp8_unpack(q, s, block_rows=R),
                        lambda: ref.fp8_unpack_ref(q, s, R, torch.bfloat16),
                        n + 4 + 2 * n, n, UNPACK_SITE)
        if tag == "train":
            results["fp8_unpack"] = row
        else:
            others["fp8_unpack@leaf"] = row


#: the serving depth of a model the card serves cut (phase 11)
SERVE_LAYERS = {"mixtral-8x7b": MIXTRAL_SERVE_LAYERS}


def codec_page(dev, arch, num_pages, dtype, seed):
    """A full-width page pool of ``arch`` (at its ``SERVE_LAYERS`` depth)
    as the serving path allocates it (``transformer.paged_pool``: leaves
    (n_groups, num_pages + 1, 16, K, hd)), k 10^4 times smaller than v,
    random; returns the pool's leaves and the frame views (one a leaf) of
    pages 5 and 9."""
    from repro_torch import tree
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as tfm
    cfg = (cut(arch, SERVE_LAYERS[arch]) if arch in SERVE_LAYERS
           else ARCHS[arch])
    pool, _ = tfm.paged_pool(cfg, num_pages, 16, dtype, dev)
    leaves, _ = tree.flatten(pool)
    g = torch.Generator(device=dev).manual_seed(seed)
    for c, mag in zip(leaves, (1e-2, 1e2)):        # k, v
        c.copy_(torch.randn(c.shape, generator=g, device=dev) * mag)
    return leaves, [c[:, 5] for c in leaves], [c[:, 9] for c in leaves]


def same_codes(got, want) -> bool:
    """Two packs' ``[(q, scale)]`` agree bit for bit."""
    return all(torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
               and torch.equal(s, sr) for (q, s), (qr, sr) in zip(got, want))


def check_codec_pages(dev, results, others):
    """Every pack and the shared unpack on the serving page path: the
    leaves of one page packed in one launch straight from a full-width
    pool's frame and decoded in one launch straight into another frame
    (smollm's page: 2 leaves of (30, 16, 3, 64); zamba2's: 2 of (9, 16,
    32, 80); h2o-danube's: 2 of (24, 16, 8, 80); mixtral's at 8 layers: 2
    of (8, 16, 8, 128); whisper's: 2 of (24, 16, 16, 64); qwen2-vl's: 2
    of (28, 16, 2, 128)), bit-exact against the plain versions leaf by
    leaf, float32
    and bfloat16 pools, for each codec; then, for each pack, half-way ties,
    ragged tails, row blocks whose 16-code chunks straddle two scales, all
    zeros and an absmax in the last slice, in both regimes (a row block
    on one cluster, or a stash-sized one in two passes).  Times each
    codec's page pack and the page unpack (the int8 pack's main-path
    row)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import offload_pack as kp
    packs = codec_packs()
    pages = {"smollm-135m": 64, "zamba2-2.7b": 96,
             "h2o-danube-1.8b": DANUBE_PAGES, "mixtral-8x7b": MIXTRAL_PAGES,
             "whisper-medium": WHISPER_PAGES, "qwen2-vl-2b": QWEN_PAGES}
    tags = {"smollm-135m": "page", "zamba2-2.7b": "zamba2_page",
            "h2o-danube-1.8b": "danube_page", "mixtral-8x7b": "mixtral_page",
            "whisper-medium": "whisper_page", "qwen2-vl-2b": "qwen2vl_page"}
    for dtype in (torch.float32, torch.bfloat16):
        for arch, num in pages.items():
            leaves, src, dst = codec_page(dev, arch, num, dtype, seed=num)
            for name, (kern, _, kern_leaves, plain_leaves) in packs.items():
                before = kern.launches, kp.fp8_unpack.launches
                got = kern_leaves(src)
                if not same_codes(got, plain_leaves(src)):
                    fail(f"{name} of a {arch} page ({dtype}) from the pool "
                         "not bit-exact")
                if not float(got[1][1]) > 1e3 * float(got[0][1]):
                    fail(f"{name} of a {arch} page: one scale for both "
                         "leaves")
                old = [c.clone() for c in leaves]
                kp.unpack_leaves([q for q, _ in got], [s for _, s in got],
                                 dst)
                if (kern.launches, kp.fp8_unpack.launches) != (
                        before[0] + 1, before[1] + 1):
                    fail(f"{name}: a {arch} page took more than one pack "
                         "and one unpack launch")
                for c, was, (q, s) in zip(leaves, old, got):
                    hd = q.shape[-1]
                    R = q.numel() // hd
                    if not torch.equal(c[:, 9], ref.fp8_unpack_ref(
                            q.reshape(R, hd), s.reshape(1), R, dtype)
                            .reshape(q.shape)):
                        fail(f"unpack of a {arch} {name} page into the pool "
                             f"({dtype}) not bit-exact")
                    c[:, 9] = was[:, 9]
                    if not torch.equal(c, was):
                        fail(f"unpack of a {arch} page wrote outside its "
                             "frame")
                del old
            del leaves, src, dst
    n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        cases = []
        for rows, cols in ((1440, 64), (8192, 576)):          # every regime
            x = torch.zeros((rows, cols), device=dev, dtype=dtype)
            x[0, :5] = torch.tensor([127.0, 0.5, -0.5, 2.5, -3.5])
            x[-1, -4:] = torch.tensor([0.5, -0.5, 2.5, -3.5])
            cases.append((x, rows, [127, 0, 0, 2, -4]))
            cases.append((torch.zeros_like(x), rows, None))
            x = codec_case(dev, dtype, rows, cols, seed=rows + 1)
            cases.append((x, rows, "last"))
        for rows, cols, br in ((1601, 63, 1601), (1600, 63, 16),
                               (1440, 63, 9), (8193, 577, 8193),
                               (8192, 1024, 8192)):
            cases.append((codec_case(dev, dtype, rows, cols, seed=rows + br),
                          br, None))
        for x, br, ties in cases:
            for i, (name, (kern, plain, _, _)) in enumerate(packs.items()):
                if ties == "last":   # an absmax in the last slice, of its own
                    x[-1, -1] = 500.0 * (i + 2)
                q, s = kern(x, block_rows=br)
                qr, sr = plain(x, br)
                ok = same_codes([(q, s)], [(qr, sr)])
                for out in (torch.float32, torch.bfloat16):
                    ok = ok and torch.equal(
                        kp.fp8_unpack(q, s, block_rows=br, dtype=out),
                        ref.fp8_unpack_ref(q, s, br, out))
                if isinstance(ties, list) and name == "int8_pack":
                    ok = ok and q[0, :5].tolist() == ties \
                        and q[-1, -4:].tolist() == ties[1:]
                if not ok:
                    fail(f"{name} / unpack {dtype} {tuple(x.shape)} "
                         f"block_rows {br}: not bit-exact")
                n_cases += 1
    torch.cuda.synchronize()
    print("  fp8 / int8 / blocksparse pack and the unpack of a full-width "
          "page, one launch each, from and into the pool (smollm, zamba2, "
          "danube, mixtral, whisper, qwen2-vl; "
          "f32, bf16; leaves 1e4 apart): bit-exact; and over "
          f"{n_cases} more (case, codec) pairs (ties at absmax 127, all "
          "zeros, an absmax in the last slice, both regimes; 1601 x 63, "
          "100 row blocks of 16 x 63, row blocks of 9 x 63, 8193 x 577, "
          "8192 x 1024): bit-exact", flush=True)

    for arch, num in pages.items():
        leaves, src, dst = codec_page(dev, arch, num, torch.bfloat16, seed=1)
        n = sum(x.numel() for x in src)
        tag = tags[arch]
        for name, (_, _, kern_leaves, plain_leaves) in packs.items():
            row = codec_row(lambda: kern_leaves(src),
                            lambda: plain_leaves(src),
                            2 * n + n + 4 * len(src), n, PACK_SITES[name])
            if name == "int8_pack" and tag == "page":  # the serving path's
                results[name] = row
            else:
                others[f"{name}@{tag}"] = row
        got = kp.int8_pack_leaves(src)
        qs, ss = [q for q, _ in got], [s for _, s in got]
        others[f"fp8_unpack@{tag}"] = codec_row(
            lambda: kp.unpack_leaves(qs, ss, dst),
            lambda: ref.unpack_leaves_ref(qs, ss, dst),
            n + 4 * len(src) + 2 * n, n, UNPACK_SITE)
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


# flash forward cases (B, H, K, S, T, d, causal, window): whisper-medium's
# three training attentions (the encoder's at 1500 frames and the
# decoder's cross-attention over them, both non-causal with a ragged last
# kv tile, and its causal self-attention at 448 tokens); qwen2-vl-2b's
# (d 128, 12 heads over 2) at 2048 tokens; mixtral-8x7b's training shape
# (d 128, GQA 4, its 4096-row window); smollm's training shape, a window,
# ragged S; head_dim 80 (zamba2-2.7b) at its attention shape (H = K =
# 32), ragged with a window, non-causal with S != T, a short window; head
# dims 32 and 128
FLASH_CASES = [(8, 16, 16, 1500, 1500, 64, False, 0),
               (8, 16, 16, 448, 1500, 64, False, 0),
               (8, 16, 16, 448, 448, 64, True, 0),
               (4, 12, 2, 2048, 2048, 128, True, 0),
               (8, 32, 8, 1024, 1024, 128, True, 4096),
               (8, 9, 3, 1024, 1024, 64, True, 0),
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
    H 9, K 3, S = T = 1024, d 64, causal), at zamba2's (B 8, H = K = 32,
    d 80), at mixtral's (B 8, H 32 over K 8, d 128, window 4096: SDPA's
    causal mask is the same function at 1024 rows), at whisper's three
    (B 8, 16 heads of 64: 1500 x 1500 and 448 x 1500 non-causal, 448 x
    448 causal) and at qwen2-vl's (B 4, 12 over 2 heads of 128, 2048
    rows, causal)."""
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
              f"{len(FLASH_CASES)} cases (d 32, 64, 80, 128; whisper's "
              "1500 x 1500, 448 x 1500 and 448 x 448, qwen2-vl's 2048 at "
              "12 over 2, mixtral's 8 x 32 over 8 x 1024 at d 128; "
              "causal, windowed, ragged, non-causal) and the p-rounding "
              "probe",
              flush=True)

    import ctypes
    from repro_torch.kernels import build
    per_sm = build.function("flash_attention", "flash_attention_blocks_per_sm",
                            (ctypes.c_int,))
    print("  flash_attention_fwd bfloat16: thread blocks resident a SM by "
          f"head dim {({d: per_sm(d) for d in (32, 64, 80, 128)})}",
          flush=True)
    for key, (B, H, K, S, T, d, causal, window) in (
            ("train", (8, 9, 3, 1024, 1024, 64, True, 0)),
            ("zamba2", (8, 32, 32, 1024, 1024, 80, True, 0)),
            ("mixtral", (8, 32, 8, 1024, 1024, 128, True, 4096)),
            ("whisper_enc", (8, 16, 16, 1500, 1500, 64, False, 0)),
            ("whisper_cross", (8, 16, 16, 448, 1500, 64, False, 0)),
            ("whisper_self", (8, 16, 16, 448, 448, 64, True, 0)),
            ("qwen2vl", (4, 12, 2, 2048, 2048, 128, True, 0))):
        q = torch.randn((B, H, S, d), generator=g, device=dev).bfloat16()
        k = torch.randn((B, K, T, d), generator=g, device=dev).bfloat16()
        v = torch.randn((B, K, T, d), generator=g, device=dev).bfloat16()

        def kernel():
            return flash_attention_fwd(q, k, v, causal=causal,
                                       window=window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        nbytes, ops = flash_bytes_ops(q, k, causal, window)
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
        row = dict(
            route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:109",
            max_abs_err=max_err[torch.bfloat16],
            ms=device_ms(kernel, iters=20),
            plain_ms=device_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, window=window), iters=3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(library, iters=20),
            eager_ms=eager_ms(kernel, iters=20))
        if key == "train":
            results["flash_attention_fwd"] = row
        else:
            others[f"flash_attention_fwd@{key}"] = row


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


def check_paged_at(dev, others, label, what, shape, idxs, seed, window=0):
    """The paged decode at one model's serving shape (``shape``: the
    arguments of ``paged_case``; ``window``: the sliding window), with
    int8 side-pool frames, at each cache index of ``idxs``: float32 to
    2e-5, bfloat16 to two bf16 ulps of |out|, as ``check_paged``; then
    timed in bfloat16 at the last index into
    ``others["paged_decode_attention@<label>"]``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_decode_attention
    for dtype in (torch.float32, torch.bfloat16):
        args, side = paged_case(dev, dtype, seed=seed, **shape)
        share = 0.0
        for idx in idxs:
            for extra in ({}, side):
                got = paged_decode_attention(*args, idx, window=window,
                                             **extra)
                torch.cuda.synchronize()
                want = ref.paged_decode_attention_ref(*args, idx,
                                                      window=window, **extra)
                tol = 2e-5 if dtype == torch.float32 else bf16_ulps(want, 2)
                e = (got.float() - want.float()).abs().max().item()
                if not torch.isfinite(got.float()).all() or e > tol:
                    fail(f"paged decode at {label}'s shape {dtype} "
                         f"cache_index {idx}: max abs err {e} > {tol}")
                share = max(share, e / tol)
        print(f"  paged_decode_attention at {what}, {str(dtype)[6:]}: at "
              f"most {share:.2f} of the limit", flush=True)
    args, side = paged_case(dev, torch.bfloat16, seed=seed + 1, **shape)
    idx = idxs[-1]

    def paged():
        return paged_decode_attention(*args, idx, window=window, **side)

    nbytes, ops = paged_bytes_ops(args, idx, window)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    others[f"paged_decode_attention@{label}"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:189",
        max_abs_err=None, ms=device_ms(paged), plain_ms=device_ms(
            lambda: ref.paged_decode_attention_ref(*args, idx, window=window,
                                                   **side)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: paged_library(args, side, idx, window)),
        eager_ms=eager_ms(paged))


def check_zamba2_kernels(dev, others):
    """The kernels at zamba2-2.7b's shapes, new to them: the paged
    decode at B 6, H = K = 32 (no GQA), head_dim 80, 448 rows visible,
    with int8 side-pool frames (``check_paged_at``); the scan at (1, 384, 80 heads, P 64), N 64, with and
    without an initial state, and at the training path's (8, 1024, 80
    heads, P 64), N 64 (``SSD_RTOL``); the int8 pack and the unpack of one
    spilled page leaf, 9 sites x 16 rows x 32 heads = 4608 rows of 80,
    bit-exact; the fp8 pack and the unpack of one stashed sub-layer input,
    8192 x 2560 as one row block, bit-exact.  Each timed in bfloat16."""
    from repro_torch.kernels import offload_pack as kp
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    check_paged_at(dev, others, "zamba2", "hd 80, H = K = 32",
                   dict(B=6, H=32, K=32, hd=80, page=16, pp=32, P=193, C=32),
                   (0, 15, 127, 383, 447), seed=7)
    for dtype in (torch.float32, torch.bfloat16):
        worst = 0.0
        for b, S, init in ((1, 384, False), (1, 384, True),
                           (8, 1024, False)):
            x, dt, A, B, C, s0 = ssd_case(dev, dtype, b, S, 80, 1, 60,
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
        print(f"  ssd_scan at 80 heads, N 64 (1 x 384, 8 x 1024), "
              f"{str(dtype)[6:]}: max |d| / max |want| {worst:.3g} (limit "
              f"{SSD_RTOL[dtype]})", flush=True)
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

    # the training path: the scan at 8 x 1024 tokens of 80 heads
    x, dt, A, B, C, _ = ssd_case(dev, torch.bfloat16, 8, 1024, 80, 1, 62,
                                 P=64, N=64)
    nbytes, ops = ssd_bytes_ops(x, dt, B, None, 128)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    others["ssd_scan@zamba2_train"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:85", max_abs_err=None,
        ms=device_ms(lambda: ssd_scan(x, dt, A, B, C, 128), iters=20),
        plain_ms=device_ms(lambda: ref.ssd_chunked_ref(x, dt, A, B, C, 128),
                           iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        eager_ms=eager_ms(lambda: ssd_scan(x, dt, A, B, C, 128), iters=20))
    del x, dt, A, B, C
    check_stash(dev, others, "zamba2", 2560, seed=9)


def check_stash(dev, others, model, cols, seed, rows=8 * 1024):
    """The fp8 pack and the unpack of one stashed sub-layer input of
    ``model``, ``rows`` x ``cols`` bf16 as one row block (the training
    path's 8 x 1024 tokens by default), bit-exact against the plain
    versions, and timed."""
    from repro_torch.kernels import offload_pack as kp
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    stash = (torch.randn((rows, cols), generator=g, device=dev)
             * 3).bfloat16()
    n, R = stash.numel(), stash.shape[0]
    q, sc = kp.fp8_pack(stash, block_rows=R)
    qr, sr = ref.fp8_pack_ref(stash, R)
    if not (torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
            and torch.equal(sc, sr) and torch.equal(
                kp.fp8_unpack(q, sc, block_rows=R, dtype=torch.bfloat16),
                ref.fp8_unpack_ref(q, sc, R, torch.bfloat16))):
        fail(f"fp8 pack / unpack of a {model} stash ({rows} x {cols}) not "
             "bit-exact")
    print(f"  fp8_pack and unpack of a {model} stash ({rows} x {cols}, "
          "bf16): bit-exact", flush=True)
    others[f"fp8_pack@{model}_stash"] = codec_row(
        lambda: kp.fp8_pack(stash, block_rows=R),
        lambda: ref.fp8_pack_ref(stash, R), n * 2 + n + 4, n,
        PACK_SITES["fp8_pack"])
    others[f"fp8_unpack@{model}_stash"] = codec_row(
        lambda: kp.fp8_unpack(q, sc, block_rows=R),
        lambda: ref.fp8_unpack_ref(q, sc, R, torch.bfloat16),
        n + 4 + 2 * n, n, UNPACK_SITE)


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
    """Phase 4's counted run, at ``MAIN_COUNT_LAYERS`` of the 30 layers:
    every request finishes, pages are evicted and resumed compressed, and
    the serving kernels launched."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(
        MAIN_ARGS, cfg=cut("smollm-135m", MAIN_COUNT_LAYERS)))
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
                     require_fall=True, cfg=None, traffic=None,
                     tokens=TRAIN_BATCH * TRAIN_SEQ):
    """A counted training run through ``repro_torch.launch.train``:
    ``steps`` full-width steps (of ``cfg`` if given: a cut depth), host
    tier, fp8 stash codec.  Losses finite (and falling with
    ``require_fall``), the tier's traffic exact, each kernel of
    ``per_step`` launched that many times a step.  ``traffic``: a step's
    (raw bytes, wire bytes, calls) each way; by default ``layers`` inputs
    of ``tokens`` rows of d_model in bf16 through the fp8 codec (half the
    bytes on the wire)."""
    from repro_torch.launch import train as train_cli
    out, launches = counted(lambda: train_cli.main(argv, cfg=cfg))
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
    if traffic is None:
        raw = layers * tokens * out["model"].cfg.d_model * 2
        traffic = (raw, raw / 2, layers)
    raw, wire, calls = (x * steps for x in traffic)
    for d in ("stash", "fetch"):
        r = report.get(d, {})
        if (r.get("raw_bytes"), r.get("wire_bytes"), r.get("calls")) != (
                raw, wire, calls):
            fail(f"memory traffic {d}: {r}; want {raw} raw bytes, {wire} "
                 f"on the wire, {calls} calls")
    print(f"  memory traffic: {out['model'].runtime.traffic_summary()}; "
          f"stash and fetch raw {raw} B each, wire {wire} B", flush=True)
    for name, n in per_step.items():
        if launches[name] != n * steps:
            fail(f"kernel {name} launched {launches[name]} times in "
                 f"{steps} steps; want {n} a step")
    ms = sorted(h["ms"] for h in hist[1:])
    step_ms = ms[len(ms) // 2]
    print(f"  step time: median {step_ms:.1f} ms over steps 2-{steps} "
          f"(first step {hist[0]['ms']:.1f} ms), "
          f"{tokens / step_ms * 1e3:.0f} tokens/s", flush=True)
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


def free_device_memory() -> None:
    """Drop what the last run left (its model, state, cycles) and hand
    the caching allocator's free blocks back, so the next full-width run
    starts on an empty card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def train_steps_with(argv, kinds, impl: str, n: int = 3, dtype=None,
                     cfg=None):
    """``n`` full-width training steps of the run ``argv`` describes (its
    weights in ``dtype`` if given; ``cfg``: a cut depth), from its weights
    and batches, with the
    kernels of ``kinds`` ("flash", "ssd") on ``impl``; returns the losses
    and the first step's gradients, moved to host memory (a full-width
    zamba2 float32 run holds 38 GB on the card; its kept gradients would
    add 10 GB a run)."""
    from repro_torch import tree
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import grads_of
    from repro_torch.train.optimizer import apply_adamw
    from repro_torch.train.train_state import init_state
    setters = [getattr(ops, f"set_{kind}_impl") for kind in kinds]
    for select in setters:
        select(impl)
    try:
        model, tc, source = train_cli.build_run(train_cli.parse_args(argv),
                                                dtype=dtype, cfg=cfg)
        state = init_state(model, tc)
        losses, first = [], None
        for t in range(n):
            batch = to_device(source.batch_at(t), model.device)
            g, _, m = grads_of(model, tc, state["params"], batch)
            if t == 0:
                first = tree.map(lambda x: x.detach().cpu(), g)
            _, state["opt"], _ = apply_adamw(state["params"], g, state["opt"],
                                             tc)
            losses.append(float(m["loss"]))
            del g, batch
        del model, state
    finally:
        for select in setters:
            select("cuda")
    free_device_memory()
    return losses, first


def train_gap(got, want, label, zero_leaf=lambda path: False):
    """How far two ``train_steps_with`` results lie apart; prints it.
    Returns ``loss`` (max |d loss| over the steps), ``loss1`` (step 1's,
    from identical weights), ``leaf`` (the worst step-1 gradient leaf's
    max |d| / max |g|), ``leaf_norm`` (the worst leaf's |d| / |g| in the
    2-norm) and ``norm`` (|d| / |g| over all leaves at once).  Leaves for
    which ``zero_leaf(path)`` holds have a gradient of 0 in exact
    arithmetic (rounding noise on both sides): they count in ``norm``
    only, and their largest |g| is printed."""
    from repro_torch import tree
    (got_l, got_g), (want_l, want_g) = got, want
    gap = {"loss": max(abs(a - b) for a, b in zip(got_l, want_l)),
           "loss1": abs(got_l[0] - want_l[0]), "leaf": 0.0,
           "leaf_norm": 0.0}
    where = {}
    d2 = g2 = noise = 0.0
    leaves_w, paths = tree.flatten(want_g)
    dev = torch.device("cuda")
    for w, g, path in zip(leaves_w, tree.leaves(got_g), paths):
        w, g = w.to(dev).float(), g.to(dev).float()
        if not torch.isfinite(g).all():
            fail(f"gradient {'/'.join(path)} not finite")
        d = g - w
        dn, wn = d.norm().item(), w.norm().item()
        d2, g2 = d2 + dn ** 2, g2 + wn ** 2
        if zero_leaf(path):
            noise = max(noise, w.abs().max().item(), g.abs().max().item())
            continue
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
          f"{gap['norm']:.3g}" + (f"; the leaves whose gradient is 0 in "
                                  f"exact arithmetic: max |g| {noise:.3g}"
                                  if noise else ""), flush=True)
    return gap


def check_train_kernel_vs_plain(argv, kind, label, loss_tol, grad_tol):
    """The training path with the ``kind`` kernel on its plain version,
    then on the kernel, from the same weights and batches: each step's
    loss and every gradient leaf of step 1."""
    gap = train_gap(train_steps_with(argv, (kind,), "cuda"),
                    train_steps_with(argv, (kind,), "torch"),
                    f"{label} kernel vs plain")
    print(f"    limits: {loss_tol} on the losses, {grad_tol} on the worst "
          "leaf's max |d| / max |g|", flush=True)
    if gap["loss"] > loss_tol or gap["leaf"] > grad_tol:
        fail(f"training with the {label} kernel disagrees with the plain "
             "version")


def check_train_flash_vs_plain() -> None:
    check_train_kernel_vs_plain(TRAIN_ARGS, "flash", "flash",
                                TRAIN_LOSS_ATOL, TRAIN_GRAD_RTOL)


def check_train_kernels_f32_bf16(argv, kinds, what, f32_tol) -> None:
    """3 steps from the same weights and batches, the kernels of ``kinds``
    against their plain versions, with the weights in float32 (limits
    ``f32_tol``) and in bfloat16 (held to the distance between the plain
    version's bfloat16 and float32 runs: step 1's loss and all gradient
    leaves at once).  Each pair is compared as soon as both runs exist, so
    no more than two runs' gradients are kept (in host memory)."""
    f32_plain = train_steps_with(argv, kinds, "torch", dtype="float32")
    f32 = train_gap(train_steps_with(argv, kinds, "cuda", dtype="float32"),
                    f32_plain, f"{what} vs plain, float32")
    bf16_plain = train_steps_with(argv, kinds, "torch", dtype="bfloat16")
    rounding = train_gap(bf16_plain, f32_plain, "plain bf16 vs plain f32")
    del f32_plain
    bf16 = train_gap(train_steps_with(argv, kinds, "cuda", dtype="bfloat16"),
                     bf16_plain, f"{what} vs plain, bfloat16")
    print(f"    limits: float32 {f32_tol}; bfloat16 step-1 loss "
          f"<= {rounding['loss1']:.3g} and all leaves <= "
          f"{rounding['norm']:.3g} (plain bf16 vs plain f32)", flush=True)
    if any(f32[k] > tol for k, tol in f32_tol.items()):
        fail(f"training with the {what} (float32) disagrees with the plain "
             "version")
    if bf16["loss1"] > rounding["loss1"] or bf16["norm"] > rounding["norm"]:
        fail(f"training with the {what} (bfloat16): the kernels move it "
             "further than bfloat16 rounding moves the plain version")


def check_train_ssd_vs_plain() -> None:
    """Phase 7's comparison: 3 mamba2 steps, scan kernel against plain
    version (``SSM_TRAIN_F32_TOL``)."""
    check_train_kernels_f32_bf16(SSM_TRAIN_ARGS, ("ssd",), "SSD scan kernel",
                                 SSM_TRAIN_F32_TOL)


def check_train_zamba2_vs_plain() -> None:
    """Phase 9's comparison: 3 full-width zamba2 steps, the flash forward
    and the scan on their kernels against both on their plain versions
    (``ZAMBA_TRAIN_F32_TOL``).  Not cut in depth: at 18 of the 54 blocks
    the float32 losses read 0.00582 apart (limit 0.005; 0.0020 at full
    depth) on an H100 (700 W)."""
    check_train_kernels_f32_bf16(ZAMBA_TRAIN_ARGS, ("flash", "ssd"),
                                 "flash + scan kernels", ZAMBA_TRAIN_F32_TOL)


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
def serve_logits(argv, kinds, impl: str, dtype: str, forced=None,
                 cfg=None, forced_routes=None):
    """Drive the serving path ``argv`` describes (fresh model from the same
    seed, its weights in ``dtype``; ``cfg``: a cut depth) with the kernels
    of ``kinds`` ("paged", "ssd") on ``impl``.  Returns the logits and
    tokens of every sampling call (after each admission's prefill and each
    decode step) and how many engine steps decoded at more than one
    length.  With ``forced`` (another run's tokens, per call) the engine
    emits those.  Every MoE block's routing (``gather_idx``,
    ``combine_w``) is kept in ``stats["routes"]``; with ``forced_routes``
    (another run's) each block takes that run's instead, so two runs
    differ only by arithmetic, and ``stats["flips"]`` counts the routed
    rows (a prefill's tokens, a decode call's decoding slots; of
    ``stats["rows"]``) whose own experts differed.  Every
    decode call is also checked to leave the recurrent (conv / ssm) state
    of the slots outside its length group bit for bit as it was
    (``stats["state_moved"]`` counts the calls that did not); ``stats``
    also counts the pages evicted, the pages adopted compressed and the
    slots parked."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models.transformer import PAGED_KEYS
    args = serve.parse_args(argv)
    calls, routes = [], []
    stats = {"steps": 0, "mixed": 0, "decodes": 0, "state_moved": 0,
             "routes": routes, "flips": 0, "rows": 0}
    live = []           # the decoding slots of the decode call in flight
    setters = [getattr(ops, f"set_{kind}_impl") for kind in kinds]
    for select in setters:
        select(impl)
    route = moe.route

    def spy_route(x2d, router, top_k, cap, num_experts):
        gather_idx, combine_w, probs = route(x2d, router, top_k, cap,
                                             num_experts)
        if forced_routes is not None:
            if len(routes) >= len(forced_routes) or \
                    forced_routes[len(routes)][0].shape != gather_idx.shape:
                fail("the forced run left the first run's MoE blocks")
            want = forced_routes[len(routes)]
            T = x2d.shape[0]
            rows = live[0] if live else torch.arange(T, device=x2d.device)
            own, theirs = (torch.zeros((T + 1, num_experts), dtype=torch.bool,
                                       device=x2d.device).index_put_(
                (g, torch.arange(num_experts, device=g.device)[:, None]
                 .expand_as(g)), torch.tensor(True, device=g.device))
                for g in (gather_idx, want[0]))
            stats["flips"] += int((own[rows] != theirs[rows]).any(1).sum())
            stats["rows"] += len(rows)
            gather_idx, combine_w = want
        routes.append((gather_idx, combine_w))
        return gather_idx, combine_w, probs

    moe.route = spy_route
    try:
        eng = serve.build_engine(args, dtype=dtype, cfg=cfg)
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
            live.append(torch.as_tensor(np.flatnonzero(mask),
                                        device=tok.device))
            try:
                out = decode(tok, length, mask)
            finally:
                live.clear()
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
        report = eng.traffic_report()
        stats["evictions"] = report.get("pages", {}).get("evictions", 0)
        stats["compressed"] = report.get("decode_io", {}).get(
            "compressed_adopts", 0)
        stats["parks"] = report.get("slots", {}).get("parks", 0)
    finally:
        moe.route = route
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
                                 f32_share=None, must=(), cfg=None,
                                 plain_argv=None):
    """A serving path (of ``cfg`` if given: a cut depth) with the kernels
    of ``kinds`` against the same path with their plain versions (or,
    with ``plain_argv``, against that path: whisper's paged gather, which
    runs no paged decode kernel), every sampling call, in bfloat16 (the
    main path) and with the weights in float32; every run after the first
    is forced onto the first's tokens and MoE routings.  float32 is held
    to ``f32_tol`` (max, worst call's mean) or to ``f32_share`` of the
    distance bfloat16 rounding puts between the plain version's two runs,
    bfloat16 to all of that distance.  Each ``stats`` count named in
    ``must`` ("evictions", "compressed", "parks") must be above 0 in the
    first run."""
    argv_of = {"torch": plain_argv or argv, "cuda": argv}
    base, stats = serve_logits(argv_of["torch"], kinds, "torch", "bfloat16",
                               cfg=cfg)
    free_device_memory()       # each run's model goes before the next's
    print(f"  {label}: the slot-shaped state (conv / ssm, cross caches) of "
          f"the slots outside each decode call's length group moved in "
          f"{stats['state_moved']} of "
          f"{stats['decodes']} calls; {stats['evictions']} pages evicted, "
          f"{stats['compressed']} adopted compressed, {stats['parks']} "
          "slots parked", flush=True)
    if stats["state_moved"]:
        fail(f"{label}: a decode call changed the recurrent state of slots "
             "it does not decode")
    if any(stats[k] <= 0 for k in must):
        fail(f"{label}: the comparison runs must count {must} above 0: "
             f"{ {k: stats[k] for k in must} }")
    forced, routes = [t for _, t in base], stats["routes"]
    runs = {("bfloat16", "torch"): base}
    for key in (("bfloat16", "cuda"), ("float32", "torch"),
                ("float32", "cuda")):
        runs[key], got = serve_logits(argv_of[key[1]], kinds, key[1], key[0],
                                      forced, cfg=cfg, forced_routes=routes)
        free_device_memory()
        if len(runs[key]) != len(base) or len(got["routes"]) != len(routes):
            fail(f"run {key} made {len(runs[key])} sampling calls and "
                 f"routed {len(got['routes'])} MoE blocks, the first "
                 f"{len(base)} and {len(routes)}")
        if routes:
            print(f"  {label} run {key}: {got['flips']} of {got['rows']} "
                  f"rows routed in {len(routes)} MoE blocks would have gone "
                  "to other experts than in the first run (replayed)",
                  flush=True)
    gaps = {"bfloat16": logit_gap(runs["bfloat16", "cuda"], base, label),
            "float32": logit_gap(runs["float32", "cuda"],
                                 runs["float32", "torch"], label),
            "bfloat16 rounding": logit_gap(base, runs["float32", "torch"],
                                           label)}
    top = max(w.abs().max().item() for w, _ in base)
    print(f"  {label} logits over {len(base)} sampling calls "
          f"({stats['decodes']} decode calls in {stats['steps']} engine "
          f"steps, {stats['mixed']} steps at mixed lengths), |logits| max "
          f"{top:.3g}:", flush=True)
    plain = "the gather path" if plain_argv else "plain"
    for name, (err, mean, agree) in gaps.items():
        line = ("plain bf16 vs plain f32" if name == "bfloat16 rounding"
                else f"{what} vs {plain}, {name}")
        print(f"    {line}: max abs err {err:.4g}, worst call's mean "
              f"{mean:.3g}, argmax agreement {agree}", flush=True)
    if stats["mixed"] == 0:
        fail("no engine step decoded at mixed lengths")
    err, mean, _ = gaps["float32"]
    if f32_tol is None:
        f32_tol = tuple(f32_share * g for g in gaps["bfloat16 rounding"][:2])
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
    check_serve_kernels_vs_plain("mamba2", SSM_CMP_ARGS, ("ssd",),
                                 "scan kernel", SSM_LOGIT_F32_TOL)


def check_zamba2_serve_logits() -> None:
    """Phase 8: zamba2 serving at ``ZAMBA_CMP_LAYERS``, the paged decode
    and the scan on their kernels against both on their plain versions
    (the int8 codec runs its kernels in every run)."""
    check_serve_kernels_vs_plain("zamba2", ZAMBA_CMP_ARGS,
                                 ("paged", "ssd"),
                                 "paged decode + scan kernels",
                                 f32_share=ZAMBA_LOGIT_F32_SHARE,
                                 must=("evictions", "compressed", "parks"),
                                 cfg=cut("zamba2-2.7b", ZAMBA_CMP_LAYERS))


def check_ssm_serve_main_path():
    """Phase 6's counted run at ``SSM_COUNT_LAYERS`` layers: every request
    finishes, the scan launches once per layer per admission, parked
    state comes back byte for byte."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(
        SSM_SERVE_ARGS, cfg=cut("mamba2-370m", SSM_COUNT_LAYERS)))
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
    if launches["ssd_scan"] != SSM_COUNT_LAYERS * len(sessions):
        fail(f"ssd_scan launched {launches['ssd_scan']} times for "
             f"{len(sessions)} admissions; want {SSM_COUNT_LAYERS} each")
    report = eng.traffic_report()
    stash, fetch = report.get("kv_stash", {}), report.get("kv_fetch", {})
    print(f"  spill: stash {stash}, fetch {fetch}; preemptions "
          f"{sum(s.preemptions for s in sessions)}", flush=True)
    if not stash.get("calls") or any(stash.get(k) != fetch.get(k)
                                     for k in ("wire_bytes", "calls")):
        fail("the mamba2 spill did not move equal stash and fetch bytes")
    return launches


def check_counted_serve(label, argv, layers, n_requests, cfg=None):
    """A counted serving run through ``repro_torch.launch.serve`` (of
    ``cfg`` if given): every request finishes with 64 tokens inside the
    padded vocabulary; the paged decode launches ``layers`` times a decode
    call and the codec once a page; pages are evicted and resumed
    compressed; what was stashed comes back byte for byte.  Returns (the
    engine, the launches)."""
    from repro_torch.launch import serve
    eng, launches = counted(lambda: serve.main(argv, cfg=cfg))
    print(f"  launches on the {label} serving path: {launches}", flush=True)
    sessions = eng.sessions
    if len(sessions) != n_requests or any(s.finish_reason != "length"
                                          or len(s.result()) != 64
                                          for s in sessions):
        fail(f"{label}: not every request finished with 64 tokens: " + str(
            [(s.uid, s.finish_reason, len(s.result())) for s in sessions]))
    vocab = eng.model.cfg.padded_vocab
    if any(not 0 <= t < vocab for s in sessions for t in s.result()):
        fail(f"{label}: a generated token lies outside the padded "
             "vocabulary")
    report = eng.traffic_report()
    steps = report["decode_io"]["steps"]
    print(f"  {label} pages {report['pages']}; compressed adoptions "
          f"{report['decode_io']['compressed_adopts']}; slots parked "
          f"{report['slots']['parks']}x, {report['slots']['park_bytes']} B; "
          f"preemptions {sum(s.preemptions for s in sessions)}", flush=True)
    if report["pages"]["evictions"] <= 0 or \
            report["decode_io"]["compressed_adopts"] <= 0:
        fail(f"the {label} path must evict pages and resume some "
             "compressed")
    if launches["paged_decode_attention"] != layers * steps:
        fail(f"paged_decode_attention launched "
             f"{launches['paged_decode_attention']} times in {steps} decode "
             f"calls; want {layers} each")
    check_page_launches(label, report, launches)
    stash, fetch = report.get("kv_stash", {}), report.get("kv_fetch", {})
    if not stash.get("calls") or any(stash.get(k) != fetch.get(k)
                                     for k in ("wire_bytes", "calls")):
        fail(f"the {label} spill did not move equal stash and fetch bytes")
    return eng, launches


def check_zamba2_serve_main_path():
    """Phase 8's counted run (``check_counted_serve``: the paged decode
    once per site per decode call) at ``ZAMBA_CMP_LAYERS`` of the 54
    Mamba2 blocks: the scan launches once per Mamba2 block per admission;
    slots are parked, each park one session's state."""
    blocks = ZAMBA_CMP_LAYERS
    eng, launches = check_counted_serve(
        "zamba2", ZAMBA_ARGS, blocks // 6, 16,
        cfg=cut("zamba2-2.7b", blocks))
    if launches["ssd_scan"] != blocks * len(eng.sessions):
        fail(f"ssd_scan launched {launches['ssd_scan']} times for "
             f"{len(eng.sessions)} admissions; want {blocks} each")
    state = blocks * ZAMBA_BLOCK_STATE_BYTES
    slots = eng.traffic_report()["slots"]
    if slots["parks"] <= 0 or slots["park_bytes"] != slots["parks"] * state:
        fail(f"parked {slots['park_bytes']} B in {slots['parks']} parks; "
             f"want {state} B each, at least one")
    return launches


def check_train_zamba2():
    """Phase 9: the counted zamba2 training run (every one of the 63
    sub-layers stashed through fp8 and recomputed: the fp8 pack and the
    unpack 63 times a step, the scan 108 (54 blocks, forward and
    recompute), the flash forward 18 (9 sites)), two profiled steps, then
    the kernels against their plain versions."""
    out, launches = check_train_path(
        "zamba2 training", ZAMBA_TRAIN_ARGS, ZAMBA_SUBLAYERS,
        ZAMBA_TRAIN_STEPS,
        {"fp8_pack": ZAMBA_SUBLAYERS, "fp8_unpack": ZAMBA_SUBLAYERS,
         "ssd_scan": 2 * ZAMBA_LAYERS,
         "flash_attention_fwd": 2 * ZAMBA_SITES}, require_fall=False)
    profile_train_steps(out, ZAMBA_TRAIN_STEPS)
    del out
    free_device_memory()
    check_train_zamba2_vs_plain()
    return launches


def shared_frames(cache) -> set:
    """The frames a writer must not touch: held by two sessions, or named
    by the prefix index (a later admission may bind them)."""
    table = cache.table
    return set(cache._pid_nodes) | {pid for pid in range(table.num_pages)
                                    if table.refcount(pid) > 1}


def danube_serve_run(argv, dtype: str, forced=None, cfg=None):
    """Drive the prefix-sharing path ``argv`` describes (fresh model from
    the same seed, its weights in ``dtype``; ``cfg``: a cut depth).  Returns the logits of every
    sampled token keyed by (request uid, token index), the tokens, and
    ``stats``: pages evicted and adopted compressed, prefix hits and
    forks, writes into shared frames (``shared_frames``; by the suffix
    prefill's scatter or the in-place decode's row), and per engine step
    the pages the running sessions hold (``held``) against the distinct
    frames behind them (``frames``), at their peaks.  With ``forced``
    (another run's tokens, by key) the sessions emit those: the schedule
    may differ (sharing changes page pressure), the sequences do not."""
    from collections import deque
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    args = serve.parse_args(argv)
    eng = serve.build_engine(args, dtype=dtype, cfg=cfg)
    cache = eng.cache
    rows = deque()
    stats = {"shared_writes": 0, "suffix": 0, "decodes": 0,
             "peak_held": 0, "peak_frames": 0}
    sample, decode, step = eng._sample, eng._decode, eng.step
    suffix, scatter = eng._prefill_suffix, tfm.scatter_pages
    targets = []

    def spy_sample(logits):
        rows.extend(logits.float())
        return sample(logits)

    def spy_scatter(pool, caches, page_map):
        targets.extend(page_map.reshape(-1).tolist())
        return scatter(pool, caches, page_map)

    def spy_suffix(toks, sess, match):
        held = shared_frames(cache)
        targets.clear()
        out = suffix(toks, sess, match)
        stats["shared_writes"] += len(held & set(targets))
        stats["suffix"] += 1
        return out

    def spy_decode(tok, length, mask):
        written = cache.page_map_host()[mask, length // cache.page_size]
        stats["shared_writes"] += len(shared_frames(cache)
                                      & set(written.tolist()))
        stats["decodes"] += 1
        return decode(tok, length, mask)

    def spy_step():
        n = step()
        pids = [pid for sess in cache.running()
                for pid in cache.table.resident_pids(sess.uid)]
        stats["peak_held"] = max(stats["peak_held"], len(pids))
        stats["peak_frames"] = max(stats["peak_frames"], len(set(pids)))
        return n

    eng._sample, eng._decode, eng.step = spy_sample, spy_decode, spy_step
    eng._prefill_suffix = spy_suffix
    tfm.scatter_pages = spy_scatter
    try:
        logits_by, tokens_by = keyed_emits(
            serve.submit_requests(eng, args, {}), rows, forced)
        eng.run()
    finally:
        tfm.scatter_pages = scatter
    if rows:
        fail(f"{len(rows)} sampled rows were never emitted")
    report = eng.traffic_report()
    stats.update(evictions=report["pages"]["evictions"],
                 compressed=report["decode_io"]["compressed_adopts"],
                 hits=report["prefix"]["hits"],
                 forks=report["prefix"]["forks"])
    torch.cuda.synchronize()
    return logits_by, tokens_by, stats


def keyed_emits(sessions, rows, forced):
    """Key every sampled row by (request uid, token index): each session's
    ``emit`` takes the next row of ``rows`` (the sampler's spy appends its
    logits there, one row a token emitted in order) and, with ``forced``
    (another run's tokens by key), emits that run's token instead of its
    own.  Returns the dicts of logits and tokens, filled as the run goes."""
    logits_by, tokens_by = {}, {}
    for sess in sessions:
        def emit(tok, sess=sess, orig=sess.emit):
            key = (sess.uid, len(sess.tokens))
            logits_by[key] = rows.popleft()
            tok = forced[key] if forced is not None else tok
            tokens_by[key] = tok
            orig(tok)
        sess.emit = emit
    return logits_by, tokens_by


def keyed_gap(got, want, label):
    """(max |d|, worst row's mean |d|, rows whose argmax agrees) of two
    runs' logits keyed by (request, token index)."""
    if got.keys() != want.keys():
        fail(f"{label}: the runs sampled different (request, token) keys")
    err = mean = 0.0
    agree = 0
    for key, w in want.items():
        g = got[key]
        if not torch.isfinite(g).all():
            fail(f"{label} logits are not finite")
        d = (g - w).abs()
        err, mean = max(err, d.max().item()), max(mean, d.mean().item())
        agree += int(g.argmax() == w.argmax())
    return err, mean, f"{agree}/{len(want)}"


def check_danube_prefix_logits() -> None:
    """Phase 10's comparison at ``DANUBE_CMP_LAYERS``: prefix sharing on
    against off, every sampled token's logits (each admission's prefill
    and every decode step), in bfloat16 and with the weights in float32,
    every run after the first on the first's tokens, raw pages spilled
    (``DANUBE_CMP_ARGS``); then the int8 spill's runs, sharing on and off
    in both dtypes, for the int8 sharing-on run's two limits
    (``DANUBE_INT8_SHARE``).  The sharing runs must hit, fork and evict,
    the int8 ones adopt pages compressed, and no run may write a shared
    frame."""
    cfg = cut("h2o-danube-1.8b", DANUBE_CMP_LAYERS)
    base, forced, stats = danube_serve_run(DANUBE_CMP_ARGS, "bfloat16",
                                           cfg=cfg)
    free_device_memory()
    argvs = {("raw", True): DANUBE_CMP_ARGS,
             ("raw", False): DANUBE_CMP_UNSHARED_ARGS,
             ("int8", True): DANUBE_INT8_ARGS,
             ("int8", False): DANUBE_INT8_UNSHARED_ARGS}
    runs, run_stats = {("raw", True, "bfloat16"): base}, {}
    for (codec, share), argv in argvs.items():
        for dtype in ("bfloat16", "float32"):
            key = (codec, share, dtype)
            if key in runs:
                continue
            runs[key], _, st = danube_serve_run(argv, dtype, forced, cfg=cfg)
            free_device_memory()
            run_stats[key] = st
            print(f"  danube run {dtype}, {codec} spill, sharing "
                  f"{'on' if share else 'off'}: {st}", flush=True)
            if share and st["shared_writes"]:
                fail(f"danube {key}: {st['shared_writes']} writes into "
                     "shared frames")
            if codec == "int8" and st["compressed"] <= 0:
                fail(f"danube {key}: no page adopted compressed")
    off_stats = run_stats["raw", False, "bfloat16"]
    print(f"  danube at {DANUBE_CMP_LAYERS} layers, sharing on (bf16, the "
          f"first run): {stats}; the pages the running sessions hold peak "
          f"at {stats['peak_held']} on {stats['peak_frames']} frames, "
          f"unshared on {off_stats['peak_frames']}; {stats['evictions']} "
          f"pages evicted with sharing, {off_stats['evictions']} without",
          flush=True)
    if stats["shared_writes"]:
        fail(f"danube: {stats['shared_writes']} writes into shared frames "
             "(a suffix prefill's scatter or a decode's row)")
    if min(stats[k] for k in ("hits", "forks", "evictions", "suffix")) <= 0:
        fail(f"danube: the sharing run must hit, fork and evict: {stats}")

    def gap(a, b):
        return keyed_gap(runs[a], runs[b], "danube")

    gaps = {"sharing on vs off, float32": gap(("raw", True, "float32"),
                                              ("raw", False, "float32")),
            "sharing on vs off, bfloat16": gap(("raw", True, "bfloat16"),
                                               ("raw", False, "bfloat16")),
            "sharing off, bf16 vs f32": gap(("raw", False, "bfloat16"),
                                            ("raw", False, "float32")),
            "int8, sharing on, bf16 vs f32": gap(("int8", True, "bfloat16"),
                                                 ("int8", True, "float32")),
            "sharing on, f32, int8 vs raw": gap(("int8", True, "float32"),
                                                ("raw", True, "float32")),
            "int8, sharing off, bf16 vs f32": gap(
                ("int8", False, "bfloat16"), ("int8", False, "float32"))}
    top = max(w.abs().max().item() for w in base.values())
    print(f"  danube logits over {len(base)} sampled tokens, |logits| max "
          f"{top:.3g}:", flush=True)
    for name, (err, mean, agree) in gaps.items():
        print(f"    {name}: max abs err {err:.4g}, worst row's mean "
              f"{mean:.3g}, argmax agreement {agree}", flush=True)
    rounding = gaps["sharing off, bf16 vs f32"][:2]
    int8_off = gaps["int8, sharing off, bf16 vs f32"][:2]
    limits = {"sharing on vs off, float32": (DANUBE_F32_SHARE, rounding),
              "sharing on vs off, bfloat16": (DANUBE_BF16_SHARE, rounding),
              "int8, sharing on, bf16 vs f32": (DANUBE_INT8_SHARE, int8_off),
              "sharing on, f32, int8 vs raw": (DANUBE_INT8_SHARE, int8_off)}
    print("    limits (max, worst row's mean): " + "; ".join(
        f"{name} {share} x ({d[0]:.4g}, {d[1]:.3g})"
        for name, (share, d) in limits.items()), flush=True)
    for name, (share, d) in limits.items():
        if gaps[name][0] > share * d[0] or gaps[name][1] > share * d[1]:
            fail(f"danube logits, {name}: beyond {share} x {d}")


def check_danube_serve_main_path():
    """Phase 10's counted run (``check_counted_serve``) at
    ``DANUBE_CMP_LAYERS`` of its 24 layers: the prefix cache hits and
    forks."""
    eng, launches = check_counted_serve(
        "danube", DANUBE_ARGS, DANUBE_CMP_LAYERS, 16,
        cfg=cut("h2o-danube-1.8b", DANUBE_CMP_LAYERS))
    prefix = eng.traffic_report()["prefix"]
    print(f"  danube prefix: {prefix}", flush=True)
    if prefix["hits"] <= 0 or prefix["forks"] <= 0:
        fail(f"the danube path must hit and fork prefix pages: {prefix}")
    return launches


def check_mixtral_serve_logits() -> None:
    """Phase 11's comparison at ``MIXTRAL_SERVE_LAYERS``: the paged decode
    on its kernel against its plain version, in bfloat16 and with the
    weights in float32, every MoE block on the first run's routing
    (``MIXTRAL_CMP_ARGS``)."""
    check_serve_kernels_vs_plain("mixtral", MIXTRAL_CMP_ARGS, ("paged",),
                                 "paged decode kernel",
                                 f32_share=MIXTRAL_LOGIT_F32_SHARE,
                                 must=("evictions", "compressed"),
                                 cfg=cut("mixtral-8x7b",
                                         MIXTRAL_SERVE_LAYERS))


def routed_prefills(run, batch: int):
    """Run ``run()`` counting what every MoE prefill (a block of more rows
    than the ``batch`` decode slots) routed: assignments, those dropped at
    capacity and the tokens each expert received, summed over the layers
    and admissions.  Returns (run's result, counts)."""
    from repro_torch.models import moe
    route = moe.route
    counts = {"prefills": 0, "assigned": 0, "dropped": 0, "per_expert": 0}

    def spy(x2d, router, top_k, cap, num_experts):
        out = route(x2d, router, top_k, cap, num_experts)
        T = x2d.shape[0]
        if T > batch:
            kept = (out[0] < T).sum(1)
            counts["prefills"] += 1
            counts["assigned"] += T * top_k
            counts["dropped"] = counts["dropped"] + T * top_k - kept.sum()
            counts["per_expert"] = counts["per_expert"] + kept
        return out

    moe.route = spy
    try:
        result = run()
    finally:
        moe.route = route
    counts["dropped"] = int(counts["dropped"])
    counts["per_expert"] = (counts["per_expert"].tolist()
                            if counts["prefills"] else [])
    return result, counts


def check_mixtral_serve_main_path():
    """Phase 11's counted serving run (``check_counted_serve``: the paged
    decode once per layer per decode call); prefills drop tokens at
    capacity."""
    cfg = cut("mixtral-8x7b", MIXTRAL_SERVE_LAYERS)
    (eng, launches), routed = routed_prefills(
        lambda: check_counted_serve("mixtral", MIXTRAL_ARGS,
                                    MIXTRAL_SERVE_LAYERS, 16, cfg=cfg), 6)
    print(f"  mixtral prefills: {routed['prefills']} MoE blocks routed "
          f"{routed['assigned']} assignments, {routed['dropped']} dropped at "
          f"capacity ({routed['dropped'] / max(routed['assigned'], 1):.2%});"
          f" tokens each expert received {routed['per_expert']}", flush=True)
    if routed["prefills"] != MIXTRAL_SERVE_LAYERS * len(eng.sessions) or \
            routed["dropped"] <= 0:
        fail(f"mixtral: want {MIXTRAL_SERVE_LAYERS} routed blocks an "
             f"admission and tokens dropped at capacity: {routed}")
    return launches


def check_train_mixtral():
    """Phase 11's training: the counted run at ``MIXTRAL_TRAIN_LAYERS``
    (each MoE sub-layer stashed through fp8 and recomputed: the fp8 pack
    and the unpack once a layer a step, the flash forward twice), finite
    losses and a finite aux loss above 0; two profiled steps; then 3 steps
    in float32, the flash forward plain against the kernel."""
    cfg = cut("mixtral-8x7b", MIXTRAL_TRAIN_LAYERS)
    n = MIXTRAL_TRAIN_LAYERS
    out, launches = check_train_path(
        "mixtral training", MIXTRAL_TRAIN_ARGS, n, MIXTRAL_TRAIN_STEPS,
        {"fp8_pack": n, "fp8_unpack": n, "flash_attention_fwd": 2 * n},
        require_fall=False, cfg=cfg)
    aux = [h["aux_loss"] for h in out["history"]]
    print(f"  aux loss (Switch, summed over {n} layers): "
          f"{[round(a, 4) for a in aux]}", flush=True)
    if not all(math.isfinite(a) and a > 0 for a in aux):
        fail(f"mixtral aux loss not finite and above 0: {aux}")
    profile_train_steps(out, MIXTRAL_TRAIN_STEPS)
    del out
    free_device_memory()
    gap = train_gap(
        train_steps_with(MIXTRAL_TRAIN_ARGS, ("flash",), "cuda",
                         dtype="float32", cfg=cfg),
        train_steps_with(MIXTRAL_TRAIN_ARGS, ("flash",), "torch",
                         dtype="float32", cfg=cfg),
        "mixtral flash kernel vs plain, float32")
    print(f"    limits: {MIXTRAL_TRAIN_F32_TOL}", flush=True)
    if any(gap[k] > tol for k, tol in MIXTRAL_TRAIN_F32_TOL.items()):
        fail("mixtral training with the flash kernel (float32) disagrees "
             "with the plain version")
    return launches


def check_qwen2vl_serve_logits() -> None:
    """Phase 12's qwen2-vl comparison at ``QWEN_CMP_LAYERS``: the paged
    decode (G 6 at head_dim 128) on its kernel against its plain version,
    in bfloat16 and with the weights in float32."""
    check_serve_kernels_vs_plain("qwen2-vl", QWEN_CMP_ARGS, ("paged",),
                                 "paged decode kernel",
                                 f32_share=QWEN_LOGIT_F32_SHARE,
                                 must=("evictions", "compressed"),
                                 cfg=cut("qwen2-vl-2b", QWEN_CMP_LAYERS))


def check_qwen2vl_serve_main_path():
    """Phase 12's counted qwen2-vl run at full depth (28 paged decodes a
    decode call), with ``--prefix-share``: the gate turns it off (M-RoPE
    positions), so no page is bound from the prefix index."""
    eng, launches = check_counted_serve(
        "qwen2-vl", QWEN_ARGS + ["--prefix-share"], QWEN_LAYERS, 16)
    prefix = eng.traffic_report()["prefix"]
    print(f"  qwen2-vl prefix sharing: enabled {prefix['enabled']}, "
          f"{prefix['hits']} page hits", flush=True)
    if prefix["enabled"] or prefix["hits"]:
        fail(f"qwen2-vl: the prefix gate must turn sharing off: {prefix}")
    return launches


def check_train_whisper():
    """Phase 12's whisper training: the counted run (each of the 24
    encoder and 24 decoder layers stashed through fp8 and recomputed, the
    encoder's states stashed raw beside each decoder layer's input; the
    flash forward 144 times a step), two profiled steps, then 3 steps
    twice in float32 at ``WHISPER_TRAIN_CMP_LAYERS`` encoder and decoder
    layers, the flash forward plain against the kernel.  The key biases' gradient
    is 0 in exact arithmetic (no RoPE: softmax ignores a shift shared by
    every key), so those leaves are rounding noise and are held only in
    the all-leaves norm."""
    n = WHISPER_LAYERS
    enc = TRAIN_BATCH * WHISPER_FRAMES * 1024 * 2     # bf16 bytes
    dec = TRAIN_BATCH * WHISPER_SEQ * 1024 * 2
    out, launches = check_train_path(
        "whisper training", WHISPER_TRAIN_ARGS, 2 * n, WHISPER_TRAIN_STEPS,
        {"fp8_pack": 2 * n, "fp8_unpack": 2 * n,
         "flash_attention_fwd": 6 * n}, require_fall=False,
        traffic=(n * (2 * enc + dec), n * (enc + dec) / 2 + n * enc, 3 * n),
        tokens=TRAIN_BATCH * WHISPER_SEQ)
    profile_train_steps(out, WHISPER_TRAIN_STEPS)
    del out
    free_device_memory()
    check_train_whisper_vs_plain()
    return launches


def check_train_whisper_vs_plain() -> None:
    """Phase 12's whisper training comparison (see check_train_whisper)."""
    cfg = cut("whisper-medium", WHISPER_TRAIN_CMP_LAYERS)
    gap = train_gap(
        train_steps_with(WHISPER_TRAIN_ARGS, ("flash",), "cuda",
                         dtype="float32", cfg=cfg),
        train_steps_with(WHISPER_TRAIN_ARGS, ("flash",), "torch",
                         dtype="float32", cfg=cfg),
        f"whisper flash kernel vs plain, float32, "
        f"{WHISPER_TRAIN_CMP_LAYERS} + {WHISPER_TRAIN_CMP_LAYERS} layers",
        zero_leaf=lambda p: p[-1] == "bk")
    print(f"    limits: {WHISPER_TRAIN_F32_TOL}", flush=True)
    if any(gap[k] > tol for k, tol in WHISPER_TRAIN_F32_TOL.items()):
        fail("whisper training with the flash kernel (float32) disagrees "
             "with the plain version")


def check_whisper_serve_logits() -> None:
    """Phase 12's whisper comparison at ``WHISPER_SERVE_CMP_LAYERS``, all 8
    requests: the in-place kernel path against the paged-gather path, in
    bfloat16 and with the weights in float32."""
    check_serve_kernels_vs_plain("whisper", WHISPER_ARGS, ("paged",),
                                 "kernel path",
                                 f32_share=WHISPER_LOGIT_F32_SHARE,
                                 must=("evictions", "parks"),
                                 cfg=cut("whisper-medium",
                                         WHISPER_SERVE_CMP_LAYERS),
                                 plain_argv=WHISPER_GATHER_ARGS)


def check_whisper_serve_main_path():
    """Phase 12's counted whisper run: 24 paged decodes a decode call;
    every preempted slot parks its cross-attention cache whole."""
    eng, launches = check_counted_serve("whisper", WHISPER_ARGS,
                                        WHISPER_LAYERS, 8)
    slots = eng.traffic_report()["slots"]
    if slots["parks"] <= 0 or \
            slots["park_bytes"] != slots["parks"] * WHISPER_CROSS_BYTES:
        fail(f"whisper parked {slots['park_bytes']} B in {slots['parks']} "
             f"parks; want {WHISPER_CROSS_BYTES} B each, at least one")
    return launches


def disagg_serve_run(argv, dtype: str, forced=None, cfg=None,
                     **engine_kwargs):
    """Drive the serving path ``argv`` describes (colocated, or a prefill /
    decode pair with ``--role both``; fresh model from the same seed, its
    weights in ``dtype``; ``cfg``: a cut depth; ``engine_kwargs`` to the
    (decode) engine).  Returns the logits of every sampled token keyed by
    (request uid, token index), the tokens, and the engine or pair.  With
    ``forced`` (another run's tokens, by key) the sessions emit those:
    the page schedule depends only on lengths, so the runs then hold the
    same sequences and their logits differ by arithmetic only; each run's
    own argmax says where its greedy stream would have left them."""
    from collections import deque
    from repro_torch.launch import serve
    args = serve.parse_args(argv)
    eng = serve.build_engine(args, dtype=dtype, cfg=cfg, **engine_kwargs)
    rows = deque()
    for e in (eng.prefill, eng.decode) if args.role else (eng,):
        def spy_sample(logits, sample=e._sample):
            rows.extend(logits.float())
            return sample(logits)
        e._sample = spy_sample
    logits_by, tokens_by = keyed_emits(serve.submit_requests(eng, args, {}),
                                       rows, forced)
    eng.run()
    if rows:
        fail(f"{len(rows)} sampled rows were never emitted")
    torch.cuda.synchronize()
    return logits_by, tokens_by, eng


def check_transfer(label, pair, n_requests, layers, itemsize=2):
    """A drained pair lost no handoff and adopted none twice (every
    request published once, each publish adopted once, ``claim`` never
    aliases), moved page bytes x shipped pages on both legs and left no
    payload in the transfer tier.  Returns the queue's counters."""
    rep = pair.transfer.traffic_report()
    tq = rep["transfer"]
    pub, adopt = rep.get("kv_publish", {}), rep.get("kv_adopt", {})
    page = SMOLLM_PAGE_LAYER_ELEMS * layers * itemsize
    want = page * tq["shipped_pages"]
    print(f"  {label} transfer[{rep['tier']}]: {tq['published']} handoffs "
          f"shipped ({tq['shipped_pages']} pages), {tq['adopted_pages']} "
          f"pages adopted, {tq['requeued']} requeued; kv_publish "
          f"{pub.get('wire_bytes')} B / {pub.get('calls')} calls, kv_adopt "
          f"{adopt.get('wire_bytes')} B / {adopt.get('calls')} calls "
          f"({page} B a page)", flush=True)
    if pub.get("wire_bytes") != want:
        fail(f"{label}: kv_publish moved {pub.get('wire_bytes')} B; want "
             f"{page} B x {tq['shipped_pages']} shipped pages")
    if any(adopt.get(k) != pub.get(k) for k in ("wire_bytes", "calls")):
        fail(f"{label}: kv_adopt {adopt} differs from kv_publish {pub}")
    if not (tq["published"] == n_requests == tq["delivered"] - tq["requeued"]
            == pair.decode.cache.table.adoptions) \
            or tq["adopted_pages"] != tq["shipped_pages"] or tq["depth"]:
        fail(f"{label}: a handoff was lost or adopted twice: {tq}, "
             f"{pair.decode.cache.table.adoptions} adoptions")
    tier = pair.transfer.runtime.tier
    left = [getattr(tier, k) for k in ("_primary_used", "_overflow_used")
            if hasattr(tier, k)]
    if any(left):
        fail(f"{label}: {left} B left in the transfer tier")
    return tq


def check_disagg_logits() -> None:
    """Phase 13's comparison (``DISAGG_CMP_LAYERS``): the colocated engine
    and the pair on the gather path and on the kernel, 8 requests, in
    bfloat16 and with the weights in float32, every run on the first's
    tokens; per dtype, the streams each pair path shares with the
    colocated run, and every stream's logits held to its share of the
    colocated bf16 vs f32 distance."""
    cfg = cut("smollm-135m", DISAGG_CMP_LAYERS)
    paths = {"colocated": (DISAGG_COLO_CMP_ARGS, {}),
             "pair, gather": (DISAGG_CMP_ARGS, {}),
             "pair, kernel": (DISAGG_CMP_ARGS, {"decode_kernel": True})}
    runs, forced = {}, None
    for name, (argv, kw) in paths.items():
        for dtype in ("bfloat16", "float32"):
            runs[name, dtype], toks, eng = disagg_serve_run(
                argv, dtype, forced, cfg=cfg, **kw)
            forced = forced or toks
            if name != "colocated":
                check_transfer(f"disagg {name}, {dtype}", eng, 8,
                               DISAGG_CMP_LAYERS,
                               torch.finfo(getattr(torch, dtype)).bits // 8)
                rep = eng.decode.traffic_report()
                print(f"  disagg {name}, {dtype}: decode pages "
                      f"{rep['pages']}, compressed adoptions "
                      f"{rep['decode_io']['compressed_adopts']}", flush=True)
                if rep["pages"]["evictions"] <= 0:
                    fail(f"disagg {name}, {dtype}: the decode pool must "
                         "evict")
            del eng
            free_device_memory()
    rounding = keyed_gap(runs["colocated", "bfloat16"],
                         runs["colocated", "float32"], "disagg")
    top = max(w.abs().max().item() for w in runs["colocated",
                                                 "bfloat16"].values())
    print(f"  disagg logits over {len(forced)} sampled tokens, |logits| "
          f"max {top:.3g}: colocated bf16 vs f32 max abs err "
          f"{rounding[0]:.4g}, worst row's mean {rounding[1]:.3g}, argmax "
          f"agreement {rounding[2]}", flush=True)
    uids = sorted({uid for uid, _ in forced})
    for name in ("pair, gather", "pair, kernel"):
        for dtype, share in (("bfloat16", DISAGG_BF16_SHARE),
                             ("float32", DISAGG_F32_SHARE)):
            got, want = runs[name, dtype], runs["colocated", dtype]
            keyed_gap(got, want, f"disagg {name}, {dtype}")   # same keys
            same, worst = 0, (0.0, 0.0)
            for uid in uids:
                keys = [k for k in want if k[0] == uid]
                gap = keyed_gap({k: got[k] for k in keys},
                                {k: want[k] for k in keys}, "disagg")
                same += gap[2] == f"{len(keys)}/{len(keys)}"
                worst = tuple(max(a, b) for a, b in zip(worst, gap[:2]))
            limit = tuple(share * d for d in rounding[:2])
            print(f"    {name} vs colocated, {dtype}: {same} of "
                  f"{len(uids)} streams identical; worst stream max abs "
                  f"err {worst[0]:.4g}, worst row's mean {worst[1]:.3g} "
                  f"(limit {share} x the distance: {limit[0]:.4g}, "
                  f"{limit[1]:.3g})", flush=True)
            if worst[0] > limit[0] or worst[1] > limit[1]:
                fail(f"disagg logits, {name}, {dtype}: beyond {share} x "
                     f"{rounding[:2]}")


def check_disagg_serve_main_path():
    """Phase 13's counted run at ``DISAGG_COUNT_LAYERS``: 16 requests over
    a spill transfer tier to the kernel decode; every request finishes,
    the transfer checks hold (``check_transfer``), pages are evicted and
    resumed compressed, the paged decode launches once a layer a decode
    call and the codec once a page."""
    from repro_torch.launch import serve
    layers = DISAGG_COUNT_LAYERS
    pair, launches = counted(lambda: serve.main(
        DISAGG_ARGS, cfg=cut("smollm-135m", layers), decode_kernel=True))
    print(f"  launches on the disaggregated serving path: {launches}",
          flush=True)
    sessions = pair.sessions
    if len(sessions) != 16 or any(s.finish_reason != "length"
                                  or len(s.result()) != 64
                                  for s in sessions):
        fail("disagg: not every request finished with 64 tokens: " + str(
            [(s.uid, s.finish_reason, len(s.result())) for s in sessions]))
    vocab = pair.model.cfg.vocab_size
    if any(not 0 <= t < vocab for s in sessions for t in s.result()):
        fail("disagg: a generated token lies outside the vocabulary")
    check_transfer("disagg", pair, 16, layers)
    report = pair.decode.traffic_report()
    steps = report["decode_io"]["steps"]
    print(f"  disagg decode pages {report['pages']}; compressed adoptions "
          f"{report['decode_io']['compressed_adopts']}; preemptions "
          f"{sum(s.preemptions for s in sessions)}", flush=True)
    if report["pages"]["evictions"] <= 0 or \
            report["decode_io"]["compressed_adopts"] <= 0:
        fail("the disagg decode pool must evict pages and resume some "
             "compressed")
    if launches["paged_decode_attention"] != layers * steps:
        fail(f"paged_decode_attention launched "
             f"{launches['paged_decode_attention']} times in {steps} decode "
             f"calls; want {layers} each")
    check_page_launches("disagg", report, launches)
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
    marks = []

    def phase(title):
        """Print the wall time of the phase that ends here, then the next
        phase's title."""
        now = time.perf_counter()
        if marks:
            print(f"  {marks[-1][0]}: {now - marks[-1][1]:.1f} s wall",
                  flush=True)
        marks.append((title.split(":")[0], now))
        print(f"== {title} (at {now - t_start:.0f} s)", flush=True)

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
    built = build.build()
    for name, info in built.items():
        print(f"  {name}.cu: {info['seconds']:.1f}s", flush=True)
        for line in info["log"].splitlines():
            entry = line.split("Compiling entry function '")
            if len(entry) == 2:        # the mangled kernel name, shortened
                print(f"    {entry[1].split(chr(39))[0][:100]}")
            elif "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"  {len(built)} libraries built", flush=True)

    phase("phase 3: kernels against their plain versions")
    results, others = {}, {}
    check_paged(dev, results, others)
    check_codec(dev, results, others)
    check_codec_pages(dev, results, others)
    check_flash(dev, results, others)
    check_ssd(dev, results, others)
    check_zamba2_kernels(dev, others)
    check_stash(dev, others, "mixtral", 4096, seed=10)
    # whisper's two stashes: an encoder layer's input (8 x 1500 frames)
    # and a decoder layer's (8 x 448 tokens), d 1024
    check_stash(dev, others, "whisper_enc", 1024, seed=21,
                rows=TRAIN_BATCH * WHISPER_FRAMES)
    check_stash(dev, others, "whisper_dec", 1024, seed=22,
                rows=TRAIN_BATCH * WHISPER_SEQ)
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
          f"monolithic slots, host spill; the counted run at "
          f"{SSM_COUNT_LAYERS} of {SSM_LAYERS} layers)")
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
          "paged shared-block KV beside slot-shaped SSM state, int8 spill; "
          f"comparison and counted runs at {ZAMBA_CMP_LAYERS} of "
          f"{ZAMBA_LAYERS} blocks)")
    check_zamba2_serve_logits()
    by_path["serve_zamba2"] = check_zamba2_serve_main_path()
    free_device_memory()

    phase(f"phase 9: training main path (full-width zamba2-2.7b, bf16, "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, host tier, fp8 stash)")
    by_path["train_zamba2"] = check_train_zamba2()
    free_device_memory()

    phase("phase 10: prefix-sharing serving main path (full-width "
          "h2o-danube-1.8b, bf16, a 328-token shared head, int8 spill; "
          f"comparison and counted runs at {DANUBE_CMP_LAYERS} of 24 "
          "layers)")
    check_danube_prefix_logits()
    by_path["serve_danube"] = check_danube_serve_main_path()
    free_device_memory()

    phase(f"phase 11: MoE (full-width mixtral-8x7b, bf16): serving at "
          f"{MIXTRAL_SERVE_LAYERS} of 32 layers, training at "
          f"{MIXTRAL_TRAIN_LAYERS} (batch {TRAIN_BATCH} x {TRAIN_SEQ}, host "
          "tier, fp8 stash)")
    check_mixtral_serve_logits()
    by_path["serve_mixtral"] = check_mixtral_serve_main_path()
    free_device_memory()
    by_path["train_mixtral"] = check_train_mixtral()
    free_device_memory()

    phase(f"phase 12a: VLM serving (full-width qwen2-vl-2b, bf16, int8 "
          f"spill; comparison runs at {QWEN_CMP_LAYERS} of "
          f"{QWEN_LAYERS} layers)")
    check_qwen2vl_serve_logits()
    by_path["serve_qwen2vl"] = check_qwen2vl_serve_main_path()
    free_device_memory()
    phase(f"phase 12b: encoder-decoder training (full-width whisper-medium, "
          f"bf16, batch {TRAIN_BATCH} x {WHISPER_SEQ} over "
          f"{WHISPER_FRAMES} frames, host tier, fp8 stash)")
    by_path["train_whisper"] = check_train_whisper()
    free_device_memory()
    phase("phase 12c: encoder-decoder serving (full-width whisper-medium, "
          "bf16, int8 spill, parked cross caches)")
    check_whisper_serve_logits()
    by_path["serve_whisper"] = check_whisper_serve_main_path()
    free_device_memory()
    phase(f"phase 13: disaggregated serving (full-width smollm-135m, bf16, "
          f"a prefill / decode pair over a transfer tier; comparisons at "
          f"{DISAGG_CMP_LAYERS} of 30 layers, the counted run at "
          f"{DISAGG_COUNT_LAYERS})")
    check_disagg_logits()
    by_path["serve_disagg"] = check_disagg_serve_main_path()
    phase("done")
    print(f"  whole script: {time.perf_counter() - t_start:.1f} s wall",
          flush=True)

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
