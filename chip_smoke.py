#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (each failure exits non-zero; nothing is caught and carried on):

1. device   — requires CUDA; prints the card's name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``.
3. kernels  — holds each kernel against its plain PyTorch version on the
              card at the main path's shapes and times kernel, plain
              version, the least time the card could take (bound) and, for
              the paged decode, one PyTorch library call as a yardstick.
4. main     — serves full-width smollm-135m (bf16, random weights from a
              seed) through ``repro_torch.launch.serve``: paged KV, in-place
              kernel decode, int8 spill codec through its kernels, an
              overcommitted pool with host spill, so pages are evicted,
              refetched and resumed compressed.  First the whole path runs
              twice, the paged decode on its plain version and then on the
              kernel, the second run emitting the first run's tokens: the
              logits of every decode step, those after compressed
              adoptions included, must agree.  Then the path runs once
              more with the launch counts set to 0, and checks every
              request finished and every kernel launched.

The line before the last is a JSON object with one entry per kernel; the
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
PEAK_INT8_OPS = 1979e12           # H100 SXM dense int8

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
# token streams, both bf16 through 30 layers: attention outputs may differ
# by a bf16 ulp per layer (different summation order) and the caches drift
# apart by as much.  On an H100 (700 W) the 622 calls read 0.051 max and
# 0.0088 worst-call mean with |logits| up to 2.7; a kernel reading its side
# pool with K and V scales swapped reads 0.60 and 0.087.
LOGIT_ATOL = 0.15
LOGIT_MEAN_ATOL = 0.02


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
        max_err[dtype] = err
        limit = "2e-5" if dtype == torch.float32 else "2 bf16 ulps of |out|"
        print(f"  paged_decode_attention {str(dtype)[6:]}: max abs err "
              f"{err:.3g}, at most {share:.2f} of the limit ({limit})",
              flush=True)
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

    def library():
        # yardstick: inflate the page map, one SDPA call (not used by the
        # port)
        q, kp, vp, pm = args
        k = ref.inflate_pages_ref(kp, pm, side["kq_pool"], side["k_scale"])
        v = ref.inflate_pages_ref(vp, pm, side["vq_pool"], side["v_scale"])
        mask = (torch.arange(k.shape[1], device=dev) <= idx)[None, None, None]
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)

    lib = device_ms(library)
    nbytes, ops = paged_bytes_ops(args, idx)
    b_ms, b_by = bound_ms(nbytes, ops, PEAK_BF16_FLOPS)
    results["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:189",
        max_abs_err=max_err[torch.bfloat16], ms=ms, plain_ms=plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=lib, eager_ms=host)


def check_codec(dev, results):
    from repro_torch.kernels import ref
    from repro_torch.kernels.offload_pack import int8_pack, int8_unpack
    g = torch.Generator(device=dev).manual_seed(3)
    # one page leaf at full width: 30 layers x 16 rows x 3 kv heads, hd 64
    R, C = 30 * 16 * 3, 64
    for dtype, spread in ((d, sp) for d in (torch.float32, torch.bfloat16)
                          for sp in (0.01, 3.0, 7.0, 1e4)):
        x = (torch.randn((R, C), generator=g, device=dev) * spread).to(dtype)
        for br in (R, R // 9):
            q, s = int8_pack(x, block_rows=br)
            qr, sr = ref.int8_pack_ref(x, br)
            if not (torch.equal(q, qr) and torch.equal(s, sr)):
                fail(f"int8_pack {dtype} block_rows {br}: not bit-exact")
            for out in (torch.float32, torch.bfloat16):
                y = int8_unpack(q, s, block_rows=br, dtype=out)
                if not torch.equal(y, ref.int8_unpack_ref(q, s, br, out)):
                    fail(f"int8_unpack {dtype}->{out}: not bit-exact")
    print("  int8_pack / int8_unpack: bit-exact (f32 and bf16 at 4 value "
          "spreads, 1 and 9 row blocks)", flush=True)
    x = (torch.randn((R, C), generator=g, device=dev) * 3).to(torch.bfloat16)
    q, s = int8_pack(x, block_rows=R)
    n = R * C

    def pack():
        return int8_pack(x, block_rows=R)

    def unpack():
        return int8_unpack(q, s, block_rows=R)

    b_ms, b_by = bound_ms(n * 2 + n + 4, 3.0 * n, PEAK_BF16_FLOPS)
    results["int8_pack"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/offload_pack.cu",
        replaces="src/repro/kernels/offload_pack.py:110", max_abs_err=0.0,
        ms=device_ms(pack),
        plain_ms=device_ms(lambda: ref.int8_pack_ref(x, R)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        eager_ms=eager_ms(pack))
    b_ms, b_by = bound_ms(n + 4 + n * 2, 1.0 * n, PEAK_INT8_OPS)
    results["int8_unpack"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/offload_pack.cu",
        replaces="src/repro/kernels/offload_pack.py:86", max_abs_err=0.0,
        ms=device_ms(unpack),
        plain_ms=device_ms(lambda: ref.int8_unpack_ref(q, s, R,
                                                       torch.bfloat16)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        eager_ms=eager_ms(unpack))


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, os.path.join(REPO, "src"))
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.offload_pack import int8_pack, int8_unpack
        from repro_torch.kernels.paged_attention import paged_decode_attention
        from repro_torch.launch import serve
    except ImportError as e:
        fail(f"cannot import the port from {REPO}/src: {e}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== phase 1: device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    built = build.build()
    for name, info in built.items():
        print(f"  {name}.cu: {info['seconds']:.1f}s", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    print(f"  build: {time.perf_counter() - t0:.1f}s wall "
          f"({len(built)} libraries)", flush=True)

    print("== phase 3: kernels against their plain versions", flush=True)
    results = {}
    check_paged(dev, results)
    check_codec(dev, results)
    for name, r in results.items():
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {name}: {r['ms']:.4f} ms on the card (eager call "
              f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']})", flush=True)

    print("== phase 4: main path (full-width smollm-135m, bf16)", flush=True)
    check_main_path_logits()

    kernels = {"paged_decode_attention": paged_decode_attention,
               "int8_pack": int8_pack, "int8_unpack": int8_unpack}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.synchronize()
    eng = serve.main(MAIN_ARGS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernels.items()}
    print(f"  launches on the main path: {launches}", flush=True)

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
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    print(card)
    print(json.dumps({"kernels": [dict(name=name, launches=launches[name], **r)
                                  for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
