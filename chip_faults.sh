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
MAIN='check_main_path_logits() check_paged(torch.device(0),{},{})'
KERNEL='check_paged(torch.device(0),{},{})'
FLASH='check_flash(torch.device(0),{},{}) check_train_flash_vs_plain()'
CODEC='check_codec(torch.device(0),{},{})'
PAGES='check_codec_pages(torch.device(0),{},{})'
SSD='check_ssd(torch.device(0),{},{})'
SSD_SERVE="$SSD check_ssm_serve_logits()"
SSD_TRAIN="$SSD check_train_ssd_vs_plain()"
GEMM='check_gemm(torch.device(0),{},{}) check_gemm_path()'
ZAMBA='check_zamba2_serve_logits()'
# phase 9's comparison (full-width zamba2 training, flash and scan kernels
# against their plain versions in float32 and bfloat16).  zamba2 has no
# GQA (32 heads over 32 kv heads), so the *_kv_head_mod plants read the
# same kv head there and are not run against it
ZAMBA_TRAIN='check_train_zamba2_vs_plain()'
# phase 10's comparison (h2o-danube-1.8b at 8 of its 24 layers: prefix
# sharing on against off, float32 and bfloat16, no write into a shared
# frame, and the int8 sharing-on run against its float32 twin and against
# the raw sharing-on run)
DANUBE='check_danube_prefix_logits()'
# phase 11's serving comparison (mixtral-8x7b at 8 layers, the paged
# decode on its kernel against its plain version in float32 and bfloat16,
# every MoE block on the first run's routing)
MIXTRAL='check_mixtral_serve_logits()'
# phase 12's comparisons: qwen2-vl serving at 8 of its 28 layers (the
# paged decode at G 6, head_dim 128), whisper training in float32 at 6
# encoder and 6 decoder layers (the flash forward non-causal over 1500
# frames), whisper serving (the kernel path against the gather path)
# phase 13's comparison (full-width smollm served by a prefill / decode
# pair, gather path and kernel, against the colocated engine)
DISAGG='check_disagg_logits()'
QWEN='check_qwen2vl_serve_logits()'
WHISPER_TRAIN='check_train_whisper_vs_plain()'
WHISPER_SERVE='check_whisper_serve_logits()'
SHOW='disagg logits|    pair, |main path logits|reciprocal probe|paged_decode_attention (float|bfloat)|ssd_scan rounding probe|flash_attention_fwd (float|bfloat)|training, |bit-exact|  ssd_scan (float|bfloat)|(mamba2|zamba2|mixtral|qwen2-vl|whisper) logits|    (scan kernel|paged decode|plain bf16|kernel path)|gemm_os (float|bfloat)|gemm path|of the slots outside|    limits: |    limits \(max|    sharing |    int8, |danube at |MoE blocks|FAILED'
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

# side-pool tiles dequantised with frame 0's scales (both paths: bf16 on
# the tensor cores, float32 on the CUDA cores)
fault scale_of_frame0 $CSRC/paged_attention.cu \
  's/sk = a.ks\[ci\]; sv = a.vs\[ci\];/sk = a.ks[0]; sv = a.vs[0];/; s/const float sk = a.ks\[ci\], sv = a.vs\[ci\];/const float sk = a.ks[0], sv = a.vs[0];/' \
  "$MAIN $ZAMBA $MIXTRAL $QWEN $WHISPER_SERVE"
# K and V side-pool scales swapped (both paths)
fault kv_scales_swapped $CSRC/paged_attention.cu \
  's/sk = a.ks\[ci\]; sv = a.vs\[ci\];/sk = a.vs[ci]; sv = a.ks[ci];/; s/const float sk = a.ks\[ci\], sv = a.vs\[ci\];/const float sk = a.vs[ci], sv = a.ks[ci];/' \
  "$MAIN"
# p not rounded to the pool dtype before the PV product: on the tensor
# cores its low 16 bits cut off as it is packed (bf16 holds no more), on
# the CUDA cores left as float32
fault p_not_rounded $CSRC/paged_attention.cu \
  's/const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);/const __nv_bfloat162 v = __halves2bfloat162(__float2bfloat16_rz(lo), __float2bfloat16_rz(hi));/; s/p_s\[g \* PAGE + r\] = round_to<T>(p);/p_s[g * PAGE + r] = p;/' \
  "$KERNEL"
# dequantised side-pool values not rounded to the pool dtype: cut to 8
# bits on the tensor cores, left as float32 on the CUDA cores
fault dequant_not_rounded $CSRC/paged_attention.cu \
  's/const __nv_bfloat162 d = __floats2bfloat162_rn(x0, x1);/const __nv_bfloat162 d = __halves2bfloat162(__float2bfloat16_rz(x0), __float2bfloat16_rz(x1));/; s/return make_float2(round_to<T>(lo), round_to<T>(hi));/return make_float2(lo, hi);/' \
  "$KERNEL"
# the split merge drops split 0's partial
fault paged_split_dropped $CSRC/paged_attention.cu \
  's/for (int s = 0; s < a.n_split; ++s) {/for (int s = 1; s < a.n_split; ++s) {/' \
  "$KERNEL"
# the split merge adds the partials without scaling each by e^(m_split - m)
fault paged_merge_unscaled $CSRC/paged_attention.cu \
  's/const float w = expf(__ldcg(ml + (s \* G + g) \* 2) - m);/const float w = 1.f;/' \
  "$KERNEL"
# flash (float32, CUDA cores): query head h reads kv head h % K instead of
# h / G
fault flash_kv_head_mod $CSRC/flash_attention.cu \
  's|const int kh = h / (a.H / a.K);|const int kh = h % a.K;|' \
  "$FLASH"
# flash (float32, CUDA cores): the causal mask shifted by one (the diagonal
# masked out)
fault flash_causal_shift $CSRC/flash_attention.cu \
  's/ok = ok \&\& q_pos >= k_pos;/ok = ok \&\& q_pos > k_pos;/' \
  "$FLASH $ZAMBA_TRAIN"
# flash (bfloat16, tensor cores): query head h reads kv head h % K
fault flash_mma_kv_head_mod $CSRC/flash_attention.cu \
  's|const int kvh = h / (a.H / a.K);|const int kvh = h % a.K;|' \
  "$FLASH"
# flash (bfloat16): the causal mask shifted by one
fault flash_mma_causal_shift $CSRC/flash_attention.cu \
  's/vis = vis \&\& qp >= kp;/vis = vis \&\& qp > kp;/' \
  "$FLASH $ZAMBA_TRAIN"
# flash (both paths): the ragged last kv tile dropped when causal == 0
# (whisper's encoder and cross-attention read 1500 frames, 23 tiles of 64
# and 28 rows)
fault flash_noncausal_ragged_tail $CSRC/flash_attention.cu \
  's/^  end = n_kv;$/  end = a.T \/ BK;/' \
  "$FLASH $WHISPER_TRAIN"
# flash (bfloat16): p left unrounded before the PV product -- its low 16
# bits cut off as it is packed, where the reference rounds it to bf16
fault flash_mma_p_unrounded $CSRC/flash_attention.cu \
  's/__floats2bfloat162_rn(lo, hi)/__halves2bfloat162(__float2bfloat16_rz(lo), __float2bfloat16_rz(hi))/' \
  "$FLASH"
# codecs: the fp8 scale as absmax times the rounded reciprocal of 448
fault fp8_scale_reciprocal $CSRC/offload_pack.cu \
  's|fmaxf(absmax / 448.0f, 1e-12f)|fmaxf(absmax * (1.0f / 448.0f), 1e-12f)|' \
  "$CODEC"
# int8 pack (cluster regime): the cluster barrier dropped -- each block
# quantises with its own partial absmax
fault cluster_barrier_dropped $CSRC/offload_pack.cu \
  's|^  cluster.sync();  .*$||; s|\*cluster.map_shared_rank(&partial, threadIdx.x)|partial|' \
  "$PAGES"
# int8 pack: the ragged chunks (the row block's tail) left unwritten
fault int8_tail_unwritten $CSRC/offload_pack.cu \
  's/const unsigned m = n;/const unsigned m = 0;/' \
  "$PAGES"
# unpack of a page: leaf 0's scale used for every leaf of the launch
fault unpack_scale_of_leaf0 $CSRC/offload_pack.cu \
  's/const float s = __ldg(L.scales + b0);/const float s = __ldg(a.l[0].scales + b0);/' \
  "$PAGES"
# int8 pack: round half away from zero (roundf) instead of half to even
fault int8_round_not_rint $CSRC/offload_pack.cu \
  's/  return fminf(fmaxf(r, -127.f), 127.f) + kRound;/  return roundf(fminf(fmaxf(r, -127.f), 127.f)) + kRound;/' \
  "$PAGES"
# unpack: one scale a 16-code chunk even where the chunk straddles two row
# blocks
fault unpack_scale_per_chunk $CSRC/offload_pack.cu \
  's|if (fdiv(e0 + n - 1, L.block_div) == b0) {|if (true) {|' \
  "$PAGES"
# unpack: the bf16 cast truncated instead of rounded to nearest even
fault unpack_bf16_truncated $CSRC/offload_pack.cu \
  's/__floats2bfloat162_rn(v\[2 \* j\], v\[2 \* j + 1\])/__halves2bfloat162(__float2bfloat16_rz(v[2 * j]), __float2bfloat16_rz(v[2 * j + 1]))/' \
  "$PAGES"
# fp8 pack: the near-midpoint guard dropped -- every code from x times the
# rounded reciprocal of the scale, never the IEEE quotient
fault fp8_guard_dropped $CSRC/offload_pack.cu \
  's/  if (near) {/  if (false) {/' \
  "$CODEC"
# fp8 pack: a value on an e4m3 midpoint (an exact tie) coded from the
# product instead of the midpoint itself
fault fp8_tie_as_product $CSRC/offload_pack.cu \
  's/t\[j\] = fmaf(-m, s, v) == 0.f ? m : v \/ s;/t[j] = fmaf(-m, s, v) == 0.f ? t[j] : v \/ s;/' \
  "$CODEC"
# fp8 pack: a value near a midpoint but off it coded from the product
fault fp8_off_tie_as_product $CSRC/offload_pack.cu \
  's/t\[j\] = fmaf(-m, s, v) == 0.f ? m : v \/ s;/t[j] = fmaf(-m, s, v) == 0.f ? m : t[j];/' \
  "$CODEC"
# blocksparse pack: |x| equal to absmax / 32 pruned as well
fault blocksparse_threshold_strict $CSRC/offload_pack.cu \
  's/if (!(fabsf(to_float(x\[j\])) >= thr)) t\[j\] = kRound;/if (!(fabsf(to_float(x[j])) > thr)) t[j] = kRound;/' \
  "$CODEC"
# fp8 pack: the two codes of each e4m3x2 conversion swapped
fault fp8x2_halves_swapped $CSRC/offload_pack.cu \
  's/return __nv_cvt_float2_to_fp8x2(make_float2(lo, hi),/return __nv_cvt_float2_to_fp8x2(make_float2(hi, lo),/' \
  "$CODEC"
# fp8 pack (cluster regime) only: the cluster barrier dropped -- each block
# quantises with its own partial absmax
fault fp8_cluster_barrier_dropped $CSRC/offload_pack.cu \
  's|^  cluster.sync();  .*$|  if (Q != kFp8) cluster.sync();|; s|\*cluster.map_shared_rank(&partial, threadIdx.x)|(Q == kFp8 ? partial : *cluster.map_shared_rank(\&partial, threadIdx.x))|' \
  "$CODEC"
# two passes: the last slice's partial absmax never written (the pass
# folds whatever the scratch held)
fault last_partial_unwritten $CSRC/offload_pack.cu \
  's/if (threadIdx.x == 0) partials\[(size_t)(L.first + rb) \* slices + sl\] = m;/if (threadIdx.x == 0 \&\& sl + 1 < slices) partials[(size_t)(L.first + rb) * slices + sl] = m;/' \
  "$PAGES"
# SSD scan (bfloat16, tensor cores): the causal mask applied after the
# exp (exp of the unbounded anti-causal entries overflows, and inf x 0 is
# NaN)
fault ssd_mask_after_exp $CSRC/ssd_scan.cu \
  's/return i >= j ? round_bf(s \* expf(cum\[i\] - cum\[j\])) : 0.f;/return (float)(i >= j) * round_bf(s * expf(cum[i] - cum[j]));/' \
  "$SSD_SERVE"
# SSD scan (bfloat16): the state carried from chunk to chunk without its
# decay
fault ssd_no_chunk_decay $CSRC/ssd_scan.cu \
  's/for (int e = 0; e < 4; ++e) st\[u\]\[j\]\[e\] \*= decay;/for (int e = 0; e < 4; ++e) st[u][j][e] *= 1.f;/' \
  "$SSD $ZAMBA $ZAMBA_TRAIN"
# SSD scan (bfloat16): head h reads B / C of group h % G instead of
# h / (H / G)
fault ssd_group_mod $CSRC/ssd_scan.cu \
  '/^namespace tc {/,$ s|const int g = h / (H / G);|const int g = h % G;|' \
  "$SSD"
# SSD scan (bfloat16): dt x rounded to bf16 -- only the hi part of each
# split operand kept
fault ssd_xdt_bf16 $CSRC/ssd_scan.cu \
  's/lo = pack2(a - h.x, b - h.y);/lo = 0u;/; s/split2(a - h.x, b - h.y, mid, lo);/mid = lo = 0u;/' \
  "$SSD"
# SSD scan (bfloat16): the state not rounded where it meets C -- its lo
# part kept beside the bf16 copy and multiplied in as well
fault ssd_state_unrounded $CSRC/ssd_scan.cu \
  's/return (size_t)P \* padded(N) \* 2;/return (size_t)P * padded(N) * 4;/; s/= hi;$/= hi; { const float2 h_ = unpack2(hi); *reinterpret_cast<uint32_t*>(st_smem + ((P + p) * LN + n) * 2) = pack2(st[u][j][2 * hf] - h_.x, st[u][j][2 * hf + 1] - h_.y); }/; s|mma_16816(yacc\[2 \* pp + 1\], a, b\[2\], b\[3\]);|mma_16816(yacc[2 * pp + 1], a, b[2], b[3]); ldsm_x4(sS + P * LN * 2 + ((16 * pp + (lane % 8) + 8 * (lane / 16)) * LN + 16 * kk + 8 * ((lane / 8) % 2)) * 2, b); mma_16816(yacc[2 * pp], a, b[0], b[1]); mma_16816(yacc[2 * pp + 1], a, b[2], b[3]);|' \
  "$SSD"
# GEMM (float32, CUDA cores): the last K slab never consumed
fault gemm_drop_last_slab $CSRC/gemm_os.cu \
  's/for (int t = 0; t < n_k; ++t) {/for (int t = 0; t < n_k - 1; ++t) {/' \
  "$GEMM"
# GEMM (float32): w read with row stride K, as if stored (N, K) -- w
# indexed (n, k) instead of (k, n); a square product cannot tell
fault gemm_w_stride_k $CSRC/gemm_os.cu \
  's/wb + (size_t)(k0 + r) \* N + col/wb + (size_t)(k0 + r) * K + col/' \
  "$GEMM"
# GEMM (bfloat16, tensor cores): the last K stage never consumed
fault gemm_tc_drop_last_stage $CSRC/gemm_os.cu \
  's/for (int ks = 0; ks < n_k; ++ks) {/for (int ks = 0; ks < n_k - 1; ++ks) {/' \
  "$GEMM"
# GEMM (bfloat16): B's transpose mode flipped -- w's N-major boxes read as
# K-major, which only a product of a symmetric w would survive
fault gemm_tc_b_major_flipped $CSRC/gemm_os.cu \
  's/constexpr int kTransB = 1;/constexpr int kTransB = 0;/' \
  "$GEMM"
# engine: the paged decode no longer puts back the conv / ssm state of the
# slots outside its length group (they advance by the dummy token)
fault engine_state_not_restored src/repro_torch/serve/engine.py \
  's/cache.slot_tree if cache.paged else cache.caches/{} if cache.paged else cache.caches/' \
  "$ZAMBA"
# prefix sharing: the suffix prefill attends only to its in-flight tokens
# (blockwise over the suffix), not to the grafted prefix rows
fault prefix_suffix_in_flight src/repro_torch/models/attention.py \
  's/            o = prefix_prefill_attention(q, kc, vc, positions, window=window,/            o = blockwise_attention(q, k, v, causal=causal, window=window,/' \
  "$DANUBE"
# prefix sharing: the suffix prefill's scatter writes the shared page
# columns too (the same bytes: only the write itself shows)
fault prefix_scatter_shared src/repro_torch/serve/engine.py \
  's/torch.where(cols >= match.write_from, row,/torch.where(cols >= 0, row,/' \
  "$DANUBE"
# int8 spill: a page adopted compressed into the side pool has its scale
# stored in the neighbouring frame's slot, so the decode reads it with its
# neighbour's scale (sharing on and off alike: the int8 sharing-on run's
# float32 twin shares the fault, the raw sharing-on run does not)
fault side_scale_of_neighbour src/repro_torch/serve/cache_manager.py \
  's/            store\[:, ci\] = scale/            store[:, (ci + 1) % store.shape[1]] = scale/' \
  "$DANUBE"
# an adopted handoff's pages land one frame late: page 0 twice, the last
# page lost.  (Landing them in reverse order is no fault a check can see:
# RoPE is applied before the write, and attention over whole pages a
# decode query sees is invariant to their order)
fault adopt_page_shifted src/repro_torch/serve/cache_manager.py \
  's/zip(pids, queue.fetch_pages(handoff))/zip(pids, (lambda p: p[:1] + p[:-1])(queue.fetch_pages(handoff)))/' \
  "$DISAGG"
# the prefill role ships one page short: the decode role grows the
# session into a fresh frame for it (stale rows), and the byte check holds
# (page bytes x shipped pages)
fault publish_last_page_dropped src/repro_torch/serve/engine.py \
  's/pages_for(sess.length, self._page_size))/pages_for(sess.length, self._page_size) - 1)/' \
  "$DISAGG"
