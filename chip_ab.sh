#!/usr/bin/env bash
# One phase of chip_smoke.py (or the codec's timings) in two checkouts,
# in turns A, B, B, A, on one NVIDIA GPU:
#   phase 5 (the default) -- full-width smollm-135m, 20 steps of 8 x 1024
#     tokens, every layer's input stashed through the fp8 codec to pinned
#     host memory, then two profiled steps;
#   phase 7 -- full-width mamba2-370m, 10 steps of 8 x 1024 tokens, the
#     same tier, the SSD scan kernel forward and recompute, then two
#     profiled steps;
#   codec -- every pack's page path, its stash shapes (8192 x 576,
#     8192 x 1024; synthetic values and the layer inputs of a training
#     step of smollm-135m and mamba2-370m) and the unpack timed
#     (tests/torch_codec_times.py of this checkout, run in each; in a
#     checkout with the one pack family each stash also forced through
#     every regime).
#
#     bash chip_ab.sh DIR_A DIR_B [5|7|codec]
#
# Each directory is a checkout (e.g. a parent commit unpacked with
# `git archive` into build/); each builds its own kernels at first use.
# Prints each run's step time, tokens/s and profile (or the codec's
# times), prefixed A or B.
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
  codec) PHASE="" ;;
  *) echo "chip_ab.sh: phase ${3} is not 5, 7 or codec" >&2; exit 2 ;;
esac
TIMES="$(cd "$(dirname "$0")" && pwd)/tests/torch_codec_times.py"
run() {   # dir, tag
  if [ -z "$PHASE" ]; then
    (cd "$1" && python3 "$TIMES" 2>&1) | sed "s|^|$2: |"
    return
  fi
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
