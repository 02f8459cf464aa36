#!/usr/bin/env bash
# Planted faults against chip_smoke.py's comparisons, on one NVIDIA GPU.
#
#     bash chip_faults.sh          # from anywhere; needs what chip_smoke.py needs
#
# Each fault is one edit to the paged-decode kernel, made in a throwaway
# copy of the checkout under build/faults/ (the checkout itself is not
# touched).  The copy's kernels are rebuilt and chip_smoke.py's checks run
# on it: a "FAILED" line means the check caught the fault; a reading with
# no "FAILED" line means it did not.
set -u
cd "$(dirname "$0")"
SRC=src/repro_torch/kernels/csrc/paged_attention.cu
MAIN='check_main_path_logits() check_paged(torch.device(0),{})'
KERNEL='check_paged(torch.device(0),{})'

fault() {   # name, sed expression, chip_smoke.py checks to run
  local dir=build/faults/$1
  rm -rf "$dir"
  mkdir -p "$dir"
  tar --exclude=./build --exclude=./chiprun_out --exclude=./.git -cf - . |
    tar -xf - -C "$dir"
  sed -i "$2" "$dir/$SRC"
  if cmp -s "$SRC" "$dir/$SRC"; then
    echo "fault $1: the edit matched nothing in $SRC"
    exit 1
  fi
  for check in $3; do
    (cd "$dir" && python3 -c "import sys, torch; sys.path.insert(0, 'src'); \
import chip_smoke as c; c.$check" 2>&1) |
      grep -E "main path logits|paged_decode_attention (float|bfloat)|FAILED" |
      sed "s/^/fault $1, $check: /"
  done
  rm -rf "$dir"
}

# side-pool tiles dequantised with frame 0's scales
fault scale_of_frame0 \
  's/const float sk = ks\[ci\], sv = vs\[ci\];/const float sk = ks[0], sv = vs[0];/' \
  "$MAIN"
# K and V side-pool scales swapped
fault kv_scales_swapped \
  's/const float sk = ks\[ci\], sv = vs\[ci\];/const float sk = vs[ci], sv = ks[ci];/' \
  "$MAIN"
# p not rounded to the pool dtype before the PV product
fault p_not_rounded \
  's/pv += round_to<T>(p_s\[g \* page + r\])/pv += (p_s[g * page + r])/' \
  "$KERNEL"
# dequantised side-pool values not rounded to the pool dtype
fault dequant_not_rounded \
  's/round_to<T>((float)kq\[off\] \* sk)/((float)kq[off] * sk)/; s/round_to<T>((float)vq\[off\] \* sv)/((float)vq[off] * sv)/' \
  "$KERNEL"
