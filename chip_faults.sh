#!/usr/bin/env bash
# Planted faults against chip_smoke.py's comparisons, on one NVIDIA GPU.
#
#     bash chip_faults.sh          # from anywhere; needs what chip_smoke.py needs
#     bash chip_faults.sh NAME...  # only the named faults
#
# Each fault is one edit to a kernel source (or, for the engine, to its
# Python), made in a throwaway copy of the checkout under build/faults/
# (the checkout itself is not touched).  The copy's kernels are rebuilt
# and chip_smoke.py's checks run on it: a "FAILED" line means the check
# caught the fault; a reading with no "FAILED" line means it did not.
set -u
cd "$(dirname "$0")"
CSRC=src/repro_torch/kernels/csrc
MAIN='check_main_path_logits() check_paged(torch.device(0),{})'
KERNEL='check_paged(torch.device(0),{})'
FLASH='check_flash(torch.device(0),{}) check_train_flash_vs_plain()'
CODEC='check_codec(torch.device(0),{},{})'
SSD='check_ssd(torch.device(0),{},{})'
SSD_SERVE="$SSD check_ssm_serve_logits()"
SSD_TRAIN="$SSD check_train_ssd_vs_plain()"
GEMM='check_gemm(torch.device(0),{},{}) check_gemm_path()'
ZAMBA='check_zamba2_serve_logits()'
SHOW='main path logits|paged_decode_attention (float|bfloat)|flash_attention_fwd (float|bfloat)|training, |bit-exact|  ssd_scan (float|bfloat)|(mamba2|zamba2) logits|    (scan kernel|paged decode|plain bf16)|gemm_os (float|bfloat)|gemm path|state of the slots|    limits: float32|FAILED'
ONLY=" $* "

fault() {   # name, file (from the checkout's root), sed expression, checks
  local dir=build/faults/$1 src=$2
  if [ "$ONLY" != "  " ] && [[ "$ONLY" != *" $1 "* ]]; then
    return
  fi
  rm -rf "$dir"
  mkdir -p "$dir"
  tar --exclude=./build --exclude=./chiprun_out --exclude=./.git -cf - . |
    tar -xf - -C "$dir"
  sed -i "$3" "$dir/$src"
  if cmp -s "$src" "$dir/$src"; then
    echo "fault $1: the edit matched nothing in $src"
    exit 1
  fi
  for check in $4; do
    (cd "$dir" && python3 -c "import sys, torch; sys.path.insert(0, 'src'); \
import chip_smoke as c; c.$check" 2>&1) |
      grep -E "$SHOW" | sed "s/^/fault $1, $check: /"
  done
  rm -rf "$dir"
}

# side-pool tiles dequantised with frame 0's scales
fault scale_of_frame0 $CSRC/paged_attention.cu \
  's/const float sk = ks\[ci\], sv = vs\[ci\];/const float sk = ks[0], sv = vs[0];/' \
  "$MAIN $ZAMBA"
# K and V side-pool scales swapped
fault kv_scales_swapped $CSRC/paged_attention.cu \
  's/const float sk = ks\[ci\], sv = vs\[ci\];/const float sk = vs[ci], sv = ks[ci];/' \
  "$MAIN"
# p not rounded to the pool dtype before the PV product
fault p_not_rounded $CSRC/paged_attention.cu \
  's/pv += round_to<T>(p_s\[g \* page + r\])/pv += (p_s[g * page + r])/' \
  "$KERNEL"
# dequantised side-pool values not rounded to the pool dtype
fault dequant_not_rounded $CSRC/paged_attention.cu \
  's/round_to<T>((float)kq\[off\] \* sk)/((float)kq[off] * sk)/; s/round_to<T>((float)vq\[off\] \* sv)/((float)vq[off] * sv)/' \
  "$KERNEL"
# flash: query head h reads kv head h % K instead of h / G
fault flash_kv_head_mod $CSRC/flash_attention.cu \
  's|const int kh = h / (a.H / a.K);|const int kh = h % a.K;|' \
  "$FLASH"
# flash: the causal mask shifted by one (the diagonal masked out)
fault flash_causal_shift $CSRC/flash_attention.cu \
  's/ok = ok \&\& q_pos >= k_pos;/ok = ok \&\& q_pos > k_pos;/' \
  "$FLASH"
# codecs: the fp8 scale as absmax times the rounded reciprocal of 448
fault fp8_scale_reciprocal $CSRC/offload_pack.cu \
  's|fmaxf(absmax / 448.0f, 1e-12f)|fmaxf(absmax * (1.0f / 448.0f), 1e-12f)|' \
  "$CODEC"
# SSD scan: the causal mask applied after the exp (exp of the unbounded
# anti-causal entries overflows, and inf x 0 is NaN)
fault ssd_mask_after_exp $CSRC/ssd_scan.cu \
  's|out\[a\] = i >= j ? round_to<T>(acc\[a\]\[b\] \* expf(cum\[i\] - cum\[j\]))|out[a] = true ? (float)(i >= j) * round_to<T>(acc[a][b] * expf(cum[i] - cum[j]))|' \
  "$SSD_SERVE"
# SSD scan: the state carried from chunk to chunk without its decay
fault ssd_no_chunk_decay $CSRC/ssd_scan.cu \
  's/s = s \* decay + acc\[r\];/s = s + acc[r];/' \
  "$SSD_TRAIN $ZAMBA"
# SSD scan: head h reads B / C of group h % G instead of h / (H / G)
fault ssd_group_mod $CSRC/ssd_scan.cu \
  's|const int g = h / (H / G);|const int g = h % G;|' \
  "$SSD"
# GEMM: the last K slab never consumed
fault gemm_drop_last_slab $CSRC/gemm_os.cu \
  's/for (int t = 0; t < n_k; ++t) {/for (int t = 0; t < n_k - 1; ++t) {/' \
  "$GEMM"
# GEMM: w read with row stride K, as if stored (N, K) -- w indexed (n, k)
# instead of (k, n); a square product cannot tell
fault gemm_w_stride_k $CSRC/gemm_os.cu \
  's/wb + (size_t)(k0 + r) \* N + col/wb + (size_t)(k0 + r) * K + col/' \
  "$GEMM"
# engine: the paged decode no longer puts back the conv / ssm state of the
# slots outside its length group (they advance by the dummy token)
fault engine_state_not_restored src/repro_torch/serve/engine.py \
  's/cache.slot_tree if cache.paged else cache.caches/{} if cache.paged else cache.caches/' \
  "$ZAMBA"
