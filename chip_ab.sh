#!/usr/bin/env bash
# Phase 5 of chip_smoke.py -- the training main path: full-width
# smollm-135m, 20 steps of 8 x 1024 tokens with every layer's input
# stashed through the fp8 codec to pinned host memory, then two profiled
# steps -- in two checkouts, in turns A, B, B, A, on one NVIDIA GPU.
#
#     bash chip_ab.sh DIR_A DIR_B
#
# Each directory is a checkout (e.g. a parent commit unpacked with
# `git archive` into build/); each builds its own kernels at first use.
# Prints each run's step time, tokens/s and profile, prefixed A or B.
set -eu
run() {   # dir, tag
  (cd "$1" && python3 -c "import sys, torch; sys.path.insert(0, 'src')
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out, _ = c.check_train_path('training', c.TRAIN_ARGS, c.TRAIN_LAYERS,
    c.TRAIN_STEPS, {'fp8_pack': c.TRAIN_LAYERS, 'fp8_unpack': c.TRAIN_LAYERS,
                    'flash_attention_fwd': 2 * c.TRAIN_LAYERS})
c.profile_train_steps(out, c.TRAIN_STEPS)" 2>&1) | sed "s|^|$2: |"
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$1" A
run "$2" B
run "$2" B
run "$1" A
