#!/usr/bin/env bash
# One training phase of chip_smoke.py in two checkouts, in turns A, B, B,
# A, on one NVIDIA GPU:
#   phase 5 (the default) -- full-width smollm-135m, 20 steps of 8 x 1024
#     tokens, every layer's input stashed through the fp8 codec to pinned
#     host memory, then two profiled steps;
#   phase 7 -- full-width mamba2-370m, 10 steps of 8 x 1024 tokens, the
#     same tier, the SSD scan kernel forward and recompute, then two
#     profiled steps.
#
#     bash chip_ab.sh DIR_A DIR_B [5|7]
#
# Each directory is a checkout (e.g. a parent commit unpacked with
# `git archive` into build/); each builds its own kernels at first use.
# Prints each run's step time, tokens/s and profile, prefixed A or B.
set -eu
case "${3:-5}" in
  5) PHASE="out, _ = c.check_train_path('training', c.TRAIN_ARGS,
    c.TRAIN_LAYERS, c.TRAIN_STEPS, {'fp8_pack': c.TRAIN_LAYERS,
    'fp8_unpack': c.TRAIN_LAYERS, 'flash_attention_fwd': 2 * c.TRAIN_LAYERS})
c.profile_train_steps(out, c.TRAIN_STEPS)" ;;
  7) PHASE="out, _ = c.check_train_path('mamba2 training', c.SSM_TRAIN_ARGS,
    c.SSM_LAYERS, c.SSM_TRAIN_STEPS, {'fp8_pack': c.SSM_LAYERS,
    'fp8_unpack': c.SSM_LAYERS, 'ssd_scan': 2 * c.SSM_LAYERS},
    require_fall=False)
c.profile_train_steps(out, c.SSM_TRAIN_STEPS)" ;;
  *) echo "chip_ab.sh: phase ${3} is not 5 or 7" >&2; exit 2 ;;
esac
run() {   # dir, tag
  (cd "$1" && python3 -c "import sys, torch; sys.path.insert(0, 'src')
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
$PHASE" 2>&1) | sed "s|^|$2: |"
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run "$1" A
run "$2" B
run "$2" B
run "$1" A
