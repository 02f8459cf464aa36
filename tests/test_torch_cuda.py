"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode).  The file imports no JAX, so it runs on a GPU host that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import offload_pack, ops, ref
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import TenantQuota
from repro_torch.serve.scheduler import FairScheduler

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _paged_inputs(dev, dtype, B=8, H=9, K=3, hd=64, page=16, pp=8, C=6,
                  seed=0, stride=1):
    """Pools of B*pp+1 frames (last: scratch), a permuted page map with one
    scratch entry, and C mapped frames (every ``stride``-th entry of the
    map, from the first) moved to an int8 side pool."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    P = B * pp + 1
    q = torch.randn((B, 1, H, hd), generator=g)
    kp = torch.randn((P, page, K, hd), generator=g)
    vp = torch.randn((P, page, K, hd), generator=g)
    pm = torch.randperm(P - 1, generator=g)[:B * pp].reshape(B, pp)
    pm = pm.to(torch.int32)
    pm[0, -1] = P - 1
    side = {"kq_pool": [], "vq_pool": [], "k_scale": [], "v_scale": []}
    for ci, fr in enumerate(pm.reshape(-1)[::stride][:C].tolist()):
        for pool, qn, sn in ((kp, "kq_pool", "k_scale"),
                             (vp, "vq_pool", "v_scale")):
            qq, sc = ref.int8_pack_ref(pool[fr].reshape(page * K, hd),
                                       page * K)
            side[qn].append(qq.reshape(page, K, hd))
            side[sn].append(sc)
        pm[pm == fr] = P + ci
    side = {k: torch.stack(v).to(dev) for k, v in side.items()}
    args = [t.to(dev, dtype) for t in (q, kp, vp)] + [pm.to(dev)]
    return args, side


def _bf16_ulps(x, n):
    """``n`` bf16 ulps at the largest magnitude in ``x``."""
    return n * 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 30.0)])
@pytest.mark.parametrize("shape", [
    dict(),                                       # GQA, G 3, hd 64
    dict(B=3, H=4, K=4, hd=80, pp=12, C=12, stride=3)])  # G 1, hd 80
def test_paged_decode_matches_plain(dev, dtype, window, softcap, shape):
    """Kernel == plain version with and without side-pool frames, across
    fills: f32 to 2e-5, bf16 to two bf16 ulps of each fill's largest output
    (the two sum in different orders, then round once to bf16).  The
    cases a split of the page map can get wrong: fills that leave the
    last splits dead (0, 15), a fill on a page boundary and on a split
    boundary (15 / 16, 63 / 64), a window that kills the first splits
    (40 rows at fill 127 and up), softcap, side-pool frames in every split
    (the second shape: every third map entry), head_dim 80 with G = 1, and
    -1 (nothing visible: zeros)."""
    from repro_torch.kernels.paged_attention import split_plan
    args, side = _paged_inputs(dev, dtype, **shape)
    B, pp = args[3].shape
    _, _, K, hd = args[1].shape
    n_split, per, _ = split_plan(pp, B, K, args[0].shape[2] // K, hd,
                                 torch.cuda.get_device_properties(
                                     dev).multi_processor_count)
    assert n_split > 1 and per == 4          # the cases above cut splits
    for idx in (0, 15, 16, 63, 64, 70, 127, 16 * pp - 1):
        for extra in ({}, side):
            before = paged_decode_attention.launches
            got = paged_decode_attention(*args, idx, window=window,
                                         softcap=softcap, **extra)
            assert paged_decode_attention.launches == before + 1
            want = ref.paged_decode_attention_ref(
                *args, idx, window=window, softcap=softcap, **extra)
            tol = 2e-5 if dtype == torch.float32 else _bf16_ulps(want, 2)
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=tol)
    got = paged_decode_attention(*args, -1, **side)
    assert torch.equal(got, torch.zeros_like(got))


def test_paged_decode_rejects_what_it_cannot_run(dev):
    args, _ = _paged_inputs(dev, torch.bfloat16)
    with pytest.raises(TypeError):          # mixed dtypes: no fallback
        paged_decode_attention(args[0].float(), *args[1:], 5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_codec_bit_exact(dev, dtype):
    g = torch.Generator(device="cpu").manual_seed(3)
    x = (torch.randn((1440, 64), generator=g) * 3.0).to(dev, dtype)
    for br in (1440, 160):
        q, s = offload_pack.int8_pack(x, block_rows=br)
        qr, sr = ref.int8_pack_ref(x, br)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        for out in (torch.float32, torch.bfloat16):
            y = offload_pack.int8_unpack(q, s, block_rows=br, dtype=out)
            assert torch.equal(y, ref.int8_unpack_ref(q, s, br, out))
    with pytest.raises(TypeError):          # float16 out: no fallback
        offload_pack.int8_unpack(q, s, block_rows=160, dtype=torch.float16)


def test_engine_kernels_match_plain_under_eviction(dev):
    """The reduced model on the card, overcommitted pool, int8 codec through
    its kernels: the kernel decode streams what the plain decode does, and
    every kernel ran."""
    cfg = ARCHS["smollm-135m"].reduced(dtype="float32")
    model = Model(cfg, device=dev)
    params = model.init(0)
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=(10,)).astype(np.int32), 10)
            for i in range(4)]

    def streams(impl):
        ops.set_paged_impl(impl)
        try:
            eng = Engine(model, params, batch=2, max_len=32, page_size=4,
                         pages=10, spill="host", decode_kernel=True,
                         quota=TenantQuota(codec="int8"),
                         scheduler=FairScheduler(quantum=3))
            for uid, prompt, n in reqs:
                eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
            done = sorted(eng.run(), key=lambda r: r.uid)
        finally:
            ops.set_paged_impl("cuda")
        return [r.out_tokens for r in done], eng.traffic_report()

    want, _ = streams("torch")
    counts = {f: f.launches for f in (paged_decode_attention,
                                      offload_pack.int8_pack,
                                      offload_pack.int8_unpack)}
    got, report = streams("cuda")
    assert got == want
    assert report["decode_io"]["compressed_adopts"] > 0
    assert all(f.launches > n for f, n in counts.items())


# ---------------------------------------------------------------------------
# slice 2: the stash codecs, the flash forward, a wrapped training step
def _codec_values(dev, dtype, rows, cols, seed):
    """Values over many magnitudes, with the block absmax 448, fp8
    rounding ties and e4m3 subnormals and their ties in the first row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((rows, cols), generator=g) * 60
    x[rows // 2:] *= 1e-3
    x[0, :8] = torch.tensor([448.0, -448.0, 1.0625, -3.375, 2.0 ** -9,
                             1.5 * 2.0 ** -9, -2.5 * 2.0 ** -9, 2.0 ** -10])
    return x.clamp(-448, 448).to(dev, dtype)


@pytest.mark.parametrize("name", ["fp8_pack", "int8_pack",
                                  "blocksparse_pack"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,block_rows", [(8192, 8192), (1440, 1440),
                                             (1440, 16)])
def test_pack_unpack_bit_exact(dev, name, dtype, rows, block_rows):
    """Every pack and the shared unpack == their plain versions, bit for
    bit: a whole stashed activation as one row block (split over many
    thread blocks), a page leaf, and 90 row blocks."""
    kern = getattr(offload_pack, name)
    plain = getattr(ref, name + "_ref")
    x = _codec_values(dev, dtype, rows, 576 if rows == 8192 else 64, rows)
    before = kern.launches
    q, s = kern(x, block_rows=block_rows)
    assert kern.launches == before + 1
    qr, sr = plain(x, block_rows)
    assert torch.equal(q.view(torch.uint8), qr.view(torch.uint8))
    assert torch.equal(s, sr)
    for out in (torch.float32, torch.bfloat16):
        y = offload_pack.fp8_unpack(q, s, block_rows=block_rows, dtype=out)
        assert torch.equal(y, ref.fp8_unpack_ref(q, s, block_rows, out))


def _int8_exact(q, s, x, block_rows):
    """The int8 pack's (q, s) of x (R, C) == its plain version, bit for
    bit, and the shared unpack of them == its plain version in f32 and
    bf16."""
    qr, sr = ref.int8_pack_ref(x, block_rows)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    for out in (torch.float32, torch.bfloat16):
        y = offload_pack.fp8_unpack(q, s, block_rows=block_rows, dtype=out)
        assert torch.equal(y, ref.fp8_unpack_ref(q, s, block_rows, out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,cols,block_rows", [
    (1440, 64, 1440),      # a smollm page leaf: one cluster
    (4608, 80, 4608),      # a zamba2 page leaf: one cluster of 16
    (8192, 576, 8192),     # a stashed activation: two passes
    (1601, 63, 1601),      # 100,863 elements: numel % 16 != 0
    (1600, 63, 16),        # 100 row blocks of 16 x 63
    (1440, 63, 9),         # row blocks of 567: chunks straddle two
    (1440, 64, 1),         # 1440 row blocks of one row
])
def test_int8_pack_regimes_and_tails(dev, dtype, rows, cols, block_rows):
    """The int8 pack in both regimes (a row block on one cluster, or two
    passes) and on ragged layouts, one launch a call; the unpack across
    row-block boundaries inside a 16-code chunk."""
    x = _codec_values(dev, dtype, rows, cols, rows + cols)
    before = offload_pack.int8_pack.launches
    q, s = offload_pack.int8_pack(x, block_rows=block_rows)
    assert offload_pack.int8_pack.launches == before + 1
    _int8_exact(q, s, x, block_rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_pack_zeros_and_ties(dev, dtype):
    """All zeros (the scale clamps to 1e-30, every code 0), and half-way
    ties: absmax 127 makes the scale exactly 1, so +-0.5, 2.5 and -3.5
    round half to even (0, 0, 2, -4; rounding away from zero gives 1, -1,
    3, -4)."""
    z = torch.zeros((1440, 64), device=dev, dtype=dtype)
    q, s = offload_pack.int8_pack(z, block_rows=1440)
    _int8_exact(q, s, z, 1440)
    assert float(s) == float(np.float32(1e-30)) and not q.any()
    for rows, cols in ((1440, 64), (8192, 576)):     # both regimes
        x = torch.zeros((rows, cols), device=dev, dtype=dtype)
        x[0, :5] = torch.tensor([127.0, 0.5, -0.5, 2.5, -3.5])
        x[rows - 1, -4:] = torch.tensor([0.5, -0.5, 2.5, -3.5])
        q, s = offload_pack.int8_pack(x, block_rows=rows)
        _int8_exact(q, s, x, rows)
        assert float(s) == 1.0
        assert q[0, :5].tolist() == [127, 0, 0, 2, -4]
        assert q[rows - 1, -4:].tolist() == [0, 0, 2, -4]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(30, 16, 3, 64), (9, 16, 32, 80)])
def test_int8_page_leaves_one_launch(dev, dtype, shape):
    """A page's two leaves packed in one launch straight from the pool's
    frame (the leaves 10^4 apart in magnitude: each keeps its own scale),
    then decoded in one launch straight into another frame: bit for bit
    what the per-leaf plain versions give, and no other frame is
    written."""
    G, page, K, hd = shape
    g = torch.Generator(device="cpu").manual_seed(hd)
    pools = [torch.randn((G, 5, page, K, hd), generator=g).to(dev, dtype)
             * m for m in (1e-2, 1e2)]
    xs = [p[:, 3] for p in pools]
    before = offload_pack.int8_pack.launches
    got = offload_pack.int8_pack_leaves(xs)
    assert offload_pack.int8_pack.launches == before + 1
    want = ref.int8_pack_leaves_ref([x.clone() for x in xs])
    for (q, s), (qr, sr) in zip(got, want):
        assert torch.equal(q, qr) and torch.equal(s, sr)
    assert float(got[1][1]) > 1e3 * float(got[0][1])
    for out_dtype in (torch.float32, torch.bfloat16):
        frames = [torch.full((G, 4, page, K, hd), 7.0, device=dev,
                             dtype=out_dtype) for _ in xs]
        before = offload_pack.fp8_unpack.launches
        offload_pack.unpack_leaves([q for q, _ in got],
                                   [s for _, s in got],
                                   [f[:, 2] for f in frames])
        assert offload_pack.fp8_unpack.launches == before + 1
        for f, (q, s) in zip(frames, got):
            R = q.numel() // hd
            assert torch.equal(f[:, 2], ref.fp8_unpack_ref(
                q.reshape(R, hd), s.reshape(1), R, out_dtype)
                .reshape(G, page, K, hd))
            assert bool((f[:, [0, 1, 3]] == 7.0).all())


def test_int8_leaves_reject_what_they_cannot_take(dev):
    x = torch.randn((8, 16, 64), device=dev)
    with pytest.raises(ValueError):          # not runs at one stride
        offload_pack.int8_pack_leaves([x[:, 1:3, :8]])
    with pytest.raises(TypeError):           # mixed dtypes in one launch
        offload_pack.int8_pack_leaves([x, x.bfloat16()])
    with pytest.raises(ValueError):          # more leaves than a launch holds
        offload_pack.int8_pack_leaves([x] * (offload_pack.MAX_LEAVES + 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,d,causal,window", [
    (1024, 1024, 64, True, 0), (1024, 1024, 64, True, 256),
    (1000, 1000, 64, True, 0), (200, 330, 32, False, 0),
    (256, 256, 128, True, 0), (77, 77, 32, True, 16),
    (256, 256, 80, True, 0), (1000, 1000, 80, True, 256),
    (200, 330, 80, False, 0), (77, 77, 80, True, 16)])
def test_flash_forward_matches_plain(dev, dtype, S, T, d, causal, window):
    """Kernel == plain twin: f32 (CUDA cores) to 2e-5, bf16 (tensor cores)
    to two bf16 ulps of the largest output (the two sum in different
    orders, then round once); strided (B, S, H, d) views give the same
    result as contiguous ones.  Head dims 32, 64, 80 (zamba2) and 128."""
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    g = torch.Generator(device="cpu").manual_seed(S + d)
    q = torch.randn((2, 9, S, d), generator=g).to(dev, dtype)
    k = torch.randn((2, 3, T, d), generator=g).to(dev, dtype)
    v = torch.randn((2, 3, T, d), generator=g).to(dev, dtype)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal, window=window)
    assert flash_attention_fwd.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else _bf16_ulps(want, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    again = flash_attention_fwd(*views, causal=causal, window=window)
    assert torch.equal(again, got)


def test_flash_rejects_what_it_cannot_run(dev):
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    q = torch.randn((1, 2, 8, 48), device=dev)
    with pytest.raises(ValueError):          # head dim 48: no fallback
        flash_attention_fwd(q, q, q)
    for d in (40, 144):                      # not a multiple of 16; > 128
        x = torch.randn((1, 2, 8, d), device=dev).bfloat16()
        with pytest.raises(ValueError):
            flash_attention_fwd(x, x, x)
    x = torch.randn((1, 2, 8, 81), device=dev).bfloat16()[..., 1:]
    with pytest.raises(ValueError):          # rows 2 bytes past 16: no copy
        flash_attention_fwd(x, x, x)
    with pytest.raises(TypeError):           # mixed dtypes
        flash_attention_fwd(q[..., :32], q[..., :32].bfloat16(),
                            q[..., :32])


@pytest.mark.parametrize("codec,loss_tol,grad_tol", [
    # f32 on both devices: matmul and attention sums in different orders
    ("none", 1e-4, 1e-4),
    # the fp8 stash rounds layer inputs that differ by f32 rounding
    # between the devices; a value at an fp8 rounding tie can land one
    # fp8 step apart
    ("fp8", 1e-3, 2e-2)])
def test_wrapped_train_step_cuda_matches_cpu(dev, codec, loss_tol, grad_tol):
    """One reduced-size training step under the host tier, every layer
    wrapped (stash, fetch, recompute), on the card against the CPU: loss
    and every gradient leaf, from the same weights and batch; the card's
    step ran the flash and codec kernels."""
    from repro_torch import tree
    from repro_torch.configs import MemoryPlan, RunConfig, TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import grads_of

    cfg = ARCHS["smollm-135m"].reduced(dtype="float32")
    tc = TrainConfig()
    batch = SyntheticLM(cfg, batch=2, seq=64, seed=1).batch_at(0)
    params = Model(cfg, device="cpu").init(0)
    out = {}
    for device in ("cpu", dev):
        model = build_model(RunConfig(
            model=cfg, shape=ShapeConfig("t", 64, 2, "train"),
            memory=MemoryPlan(policy="host", compress=codec), train=tc),
            device=device)
        p = tree.map(lambda t: t.to(device).requires_grad_(), params)
        launches = flash_attention_fwd.launches
        g, loss, _ = grads_of(model, tc, p, to_device(batch, device))
        out[str(device)] = (float(loss), tree.map(lambda t: t.cpu(), g),
                            flash_attention_fwd.launches - launches)
        assert model.runtime.traffic_report()["stash"]["calls"] == 2
    (lc, gc, nc), (lg, gg, ng) = out["cpu"], out[str(dev)]
    assert nc == 0 and ng == 4          # forward + recompute, 2 layers
    assert abs(lc - lg) < loss_tol
    for a, b in zip(tree.leaves(gc), tree.leaves(gg)):
        scale = a.abs().max().item() or 1.0
        assert (a - b).abs().max().item() / scale < grad_tol


# ---------------------------------------------------------------------------
# slice 3: the SSD chunked scan and the mamba2 engine
def _ssd_inputs(dev, dtype, b, S, H, G, P=64, N=128, init=False, seed=0):
    """Scan inputs as ``mamba_block`` hands them over (dt softplus'd, A the
    init's decays), the rows past ``S`` padded to the chunk with zeros."""
    F = torch.nn.functional
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, S, H, P), generator=g)
    B = torch.randn((b, S, G, N), generator=g)
    C = torch.randn((b, S, G, N), generator=g)
    dt = F.softplus(torch.randn((b, S, H), generator=g))
    A = -torch.linspace(1.0, 16.0, H)
    s0 = torch.randn((b, H, P, N), generator=g) * 0.5 if init else None
    pad = (-S) % 128
    x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
    dt = F.pad(dt, (0, 0, 0, pad))
    return ([x.to(dev, dtype), dt.to(dev), A.to(dev), B.to(dev, dtype),
             C.to(dev, dtype)],
            None if s0 is None else s0.to(dev, dtype))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("b,S,G,init", [(2, 1024, 1, False),
                                        (2, 1024, 1, True),
                                        (1, 384, 2, True),
                                        (2, 1000, 2, False)])
def test_ssd_scan_matches_plain(dev, dtype, tol, b, S, G, init):
    """Kernel == plain version (``ssd_chunked``), y and the final state,
    each within ``tol`` of its largest magnitude: f32 sums in other
    orders; bf16 rounds the scores, the decayed B / C and the state at the
    same places, where an f32 difference can tip one rounding (one bf16
    ulp of the largest output)."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    args, s0 = _ssd_inputs(dev, dtype, b, S, 32, G, init=init, seed=S + G)
    before = ssd_scan.launches
    y, fin = ssd_scan(*args, 128, init_state=s0)
    assert ssd_scan.launches == before + 1
    wy, wfin = ref.ssd_chunked_ref(*args, 128, init_state=s0)
    for got, want in ((y, wy), (fin, wfin)):
        assert got.dtype == want.dtype and got.shape == want.shape
        err = (got.float() - want.float()).abs().max() \
            / want.float().abs().max()
        assert err.item() < tol


def test_ssd_scan_rejects_what_it_cannot_run(dev):
    from repro_torch.kernels.ssd_scan import ssd_scan
    args, _ = _ssd_inputs(dev, torch.float32, 1, 256, 4, 1)
    x, dt, A, B, C = args
    with pytest.raises(ValueError):          # non-contiguous x
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, B,
                 C, 128)
    with pytest.raises(ValueError):          # S not a multiple of the chunk
        ssd_scan(x[:, :200].contiguous(), dt[:, :200].contiguous(), A,
                 B[:, :200].contiguous(), C[:, :200].contiguous(), 128)
    with pytest.raises(TypeError):           # mixed dtypes
        ssd_scan(x, dt, A, B.bfloat16(), C, 128)
    with pytest.raises(ValueError):          # a CPU input beside CUDA ones
        ssd_scan(x, dt, A.cpu(), B, C, 128)
    shifted = torch.empty(x.numel() + 2, device=dev)[2:].view_as(x)
    shifted.copy_(x)                         # contiguous, 8 bytes off
    with pytest.raises(ValueError):
        ssd_scan(shifted, dt, A, B, C, 128)
    # bfloat16 runs the tensor-core kernel only: a shape it lacks raises,
    # never reaching the float32 kernel
    before = ssd_scan.launches
    for b_, S_, H_, P_, N_, chunk in ((1, 256, 4, 64, 128, 8),   # chunk 8
                                      (1, 256, 4, 64, 48, 128),  # N 48
                                      (1, 256, 4, 96, 128, 128),  # P 96
                                      (1, 256, 4, 40, 64, 128)):  # P 40
        (xb, dtb, Ab, Bb, Cb), _ = _ssd_inputs(dev, torch.bfloat16, b_, S_,
                                               H_, 1, P=P_, N=N_)
        with pytest.raises(ValueError):
            ssd_scan(xb, dtb, Ab, Bb, Cb, chunk)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("chunk,N,P", [(128, 128, 64), (128, 64, 64),
                                       (16, 16, 16)])
def test_ssd_scan_rounding_probe(dev, chunk, N, P):
    """The scan's rounding probe (``ssd_scan.rounding_probe``): the kernel
    reproduces the plain version bit for bit, y and the final state."""
    from repro_torch.kernels.ssd_scan import rounding_probe, ssd_scan
    args = rounding_probe(chunk, N, P, device=dev)
    y, fin = ssd_scan(*args, chunk)
    wy, wfin = ref.ssd_chunked_ref(*args, chunk)
    assert torch.equal(y, wy) and torch.equal(fin, wfin)


def test_mamba2_engine_kernel_matches_plain(dev):
    """The reduced mamba2 on the card (chunk 16, N 16, P 32), fair
    preemption parking state to the host tier, prompts across chunk
    boundaries: the scan kernel streams what its plain version does."""
    cfg = ARCHS["mamba2-370m"].reduced(dtype="float32")
    model = Model(cfg, device=dev)
    params = model.init(0)
    rng = np.random.default_rng(11)
    reqs = [(i, rng.integers(0, 512, size=(n,)).astype(np.int32), 9)
            for i, n in enumerate((12, 20, 37, 12))]

    def streams(impl):
        ops.set_ssd_impl(impl)
        try:
            eng = Engine(model, params, batch=2, max_len=64, spill="host",
                         scheduler=FairScheduler(quantum=3))
            for uid, prompt, n in reqs:
                eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
            done = sorted(eng.run(), key=lambda r: r.uid)
        finally:
            ops.set_ssd_impl("cuda")
        return [r.out_tokens for r in done], eng.traffic_report()

    from repro_torch.kernels.ssd_scan import ssd_scan
    want, _ = streams("torch")
    before = ssd_scan.launches
    got, report = streams("cuda")
    assert got == want
    assert report["kv_stash"]["calls"] > 0
    assert ssd_scan.launches - before == 2 * len(reqs)   # 2 layers each


# ---------------------------------------------------------------------------
# output-stationary GEMM
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,blocks", [
    (128, 128, 128, None), (256, 512, 384, None), (256, 512, 256, (128, 128,
                                                                  128)),
    (192, 320, 448, (64, 64, 32)), (384, 96, 640, (128, 64, 48)),
    (256, 1024, 128, (64, 128, 64)), (256, 640, 512, (128, 256, 64)),
    (192, 384, 768, (64, 256, 128)), (384, 768, 192, (128, 64, 192)),
    (128, 192, 320, (64, 64, 64)), (1024, 2560, 768, None)])
def test_gemm_os_matches_plain(dev, dtype, m, k, n, blocks):
    """Kernel == plain version (the float32 product rounded once): float32
    (CUDA cores) within 1e-5 of the largest output (the same products
    summed in other orders), bfloat16 (tensor cores) within one bf16 ulp
    of it (the float32 sums differ in their last bits, so a rounding can
    tip).  Non-square shapes, so w read as (n, k) cannot pass.  Blocks the
    dtype's path lacks (bfloat16: bk not a multiple of 64; float32: bn
    256) raise ``ValueError`` without a launch."""
    from repro_torch.kernels.gemm_os import gemm_os, supported
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g).to(dev, dtype)
    w = torch.randn((k, n), generator=g).to(dev, dtype)
    kw = {} if blocks is None else dict(zip(("bm", "bn", "bk"), blocks))
    before = gemm_os.launches
    if blocks and not supported(*blocks, x.element_size()):
        with pytest.raises(ValueError, match="no .* tile"):
            gemm_os(x, w, **kw)
        assert gemm_os.launches == before
        return
    got = gemm_os(x, w, **kw)
    assert gemm_os.launches == before + 1
    want = ref.gemm_ref(x, w)
    assert got.dtype == dtype and got.shape == (m, n)
    tol = (1e-5 * want.abs().max().item() if dtype == torch.float32
           else _bf16_ulps(want.float(), 1))
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_gemm_os_rejects_what_it_cannot_run(dev):
    from repro_torch.kernels.gemm_os import gemm_os
    x = torch.randn((128, 256), device=dev)
    w = torch.randn((256, 128), device=dev)
    with pytest.raises(ValueError):          # non-contiguous w
        gemm_os(x, w.t().contiguous().t())
    with pytest.raises(TypeError):           # mixed dtypes
        gemm_os(x, w.bfloat16())
    with pytest.raises(TypeError):           # a dtype the kernel lacks
        gemm_os(x.half(), w.half())
    with pytest.raises(ValueError):          # w on the CPU
        gemm_os(x, w.cpu())
    with pytest.raises(ValueError):          # a tile the kernel lacks
        gemm_os(x, w, bm=128, bn=128, bk=256)
    shifted = torch.empty(x.numel() + 2, device=dev)[2:].view_as(x)
    shifted.copy_(x)                         # contiguous, 8 bytes off
    with pytest.raises(ValueError):
        gemm_os(shifted, w)


def test_zamba2_engine_kernels_match_plain(dev):
    """The reduced zamba2 on the card over an overcommitted page pool
    (int8 spill, fair preemption, in-place kernel decode): with the paged
    decode and the scan on their kernels it streams what their plain
    versions do, and the slots' SSM state parks and comes back."""
    cfg = ARCHS["zamba2-2.7b"].reduced(dtype="float32", num_layers=4,
                                       head_dim=80, num_kv_heads=4)
    model = Model(cfg, device=dev)
    params = model.init(0)
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, 512, size=(n,)).astype(np.int32), 8)
            for i, n in enumerate((7, 20, 13, 33, 9))]

    def streams(impl):
        ops.set_paged_impl(impl)
        ops.set_ssd_impl(impl)
        try:
            eng = Engine(model, params, batch=2, max_len=64, page_size=8,
                         pages=12, spill="host", decode_kernel=True,
                         scheduler=FairScheduler(quantum=3),
                         quota=TenantQuota(codec="int8"))
            for uid, prompt, n in reqs:
                eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
            done = sorted(eng.run(), key=lambda r: r.uid)
        finally:
            ops.set_paged_impl("cuda")
            ops.set_ssd_impl("cuda")
        return [r.out_tokens for r in done], eng.traffic_report()

    from repro_torch.kernels.ssd_scan import ssd_scan
    want, _ = streams("torch")
    before = ssd_scan.launches
    got, report = streams("cuda")
    assert got == want
    assert report["slots"]["parks"] > 0
    assert report["decode_io"]["compressed_adopts"] > 0
    assert ssd_scan.launches - before == 4 * len(reqs)   # 4 blocks each
