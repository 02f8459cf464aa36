"""The spill codec's page path on the CPU: the batched int8 pack and the
shared unpack (``kernels/offload_pack.int8_pack_leaves`` /
``unpack_leaves`` through ``core/compress.encode_leaves`` /
``decode_leaves``) against the per-leaf ``encode_tensor`` /
``decode_tensor`` and the reference's int8 codec, and the paged cache
manager's evict / resume / inflate cycle against the per-leaf path.

On the CPU every wrapper takes its plain version (``kernels/ref.py``); the
CUDA kernels are held to those in ``tests/test_torch_cuda.py`` on the card.
The reference's Pallas kernels run in interpret mode, under jit, where XLA
turns the scale's ``absmax / 127`` into ``absmax * f32(1/127)``: their
payload is held bit for bit wherever that scale equals the IEEE quotient,
and to one code where it does not (as ``test_torch_train.py`` holds them);
the reference's plain twin is held bit for bit everywhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import offload_pack as jpack
from repro.kernels import ref as jref
from repro_torch import tree
from repro_torch.configs import ARCHS
from repro_torch.core import compress
from repro_torch.kernels import offload_pack, ref
from repro_torch.models.model import Model
from repro_torch.serve import cache_manager
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import TenantQuota
from repro_torch.serve.scheduler import FairScheduler

INT8 = compress.get_codec("int8")


def _pool(rng, G, frames, page, K, hd, dtype):
    """A pool-shaped (G, frames, page, K, hd) tensor of values over several
    magnitudes (the layout ``transformer.paged_pool`` allocates)."""
    x = rng.standard_normal((G, frames, page, K, hd)).astype(np.float32)
    x *= 10.0 ** rng.integers(-3, 3, size=(1, frames, 1, 1, 1))
    return torch.from_numpy(x).to(dtype)


def _leaves(dtype):
    """Leaves of different sizes and widths (cols 64, 63, 80): two frames
    of pools (strided views: one run a group) and a contiguous tensor."""
    rng = np.random.default_rng(11)
    pa = _pool(rng, 3, 5, 4, 2, 64, dtype)
    pb = _pool(rng, 2, 4, 8, 1, 63, dtype)
    c = torch.from_numpy(rng.standard_normal((7, 80)).astype(np.float32)
                         * 1e3).to(dtype)
    return [pa[:, 2], pb[:, 1], c, pa[:, 4]]


def _jax(x: torch.Tensor):
    return jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_leaves_matches_per_leaf_and_reference(dtype):
    xs = _leaves(dtype)
    assert offload_pack.runs(xs[0]) == (4 * 2 * 64, 5 * 4 * 2 * 64)
    got = compress.encode_leaves(INT8, xs)
    assert len(got) == len(xs)
    for x, (q, s) in zip(xs, got):
        qt, st = compress.encode_tensor(INT8, x)
        assert q.shape == x.shape and q.dtype == torch.int8 and s.ndim == 0
        assert torch.equal(q, qt) and torch.equal(s, st)
        x2 = _jax(x.reshape(-1, x.shape[-1]))
        R = x2.shape[0]
        qr, sr = jref.int8_pack_ref(x2, R)
        np.testing.assert_array_equal(q.reshape(R, -1).numpy(),
                                      np.asarray(qr))
        assert float(s) == float(sr[0])
        qj, sj = jpack.int8_pack(x2, block_rows=R, interpret=True)
        absmax = np.float32(np.abs(np.asarray(x2, np.float32)).max())
        assert float(sj[0]) == max(absmax * np.float32(1 / 127), 1e-30)
        codes = q.reshape(R, -1).numpy().astype(np.int32)
        want = np.asarray(qj).astype(np.int32)
        if float(sj[0]) == float(s):
            np.testing.assert_array_equal(codes, want)
        else:
            assert np.abs(codes - want).max() <= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_leaves_into_pool_frames(dtype):
    """Each payload decoded straight into a strided pool frame: the frame
    holds what ``decode_tensor`` gives (and the reference's unpack, run on
    the same codes), every other frame is untouched."""
    xs = _leaves(torch.float32)
    coded = compress.encode_leaves(INT8, xs)
    rng = np.random.default_rng(5)
    pools = [_pool(rng, x.shape[0], 3, *x.shape[1:], dtype)
             if x.ndim == 4 else None for x in xs]
    flat = torch.zeros((7, 80), dtype=dtype)
    outs = [p[:, 1] if p is not None else flat for p in pools]
    before = [p.clone() if p is not None else None for p in pools]
    compress.decode_leaves(INT8, [q for q, _ in coded],
                           [s for _, s in coded], outs)
    for (q, s), out, p, old in zip(coded, outs, pools, before):
        assert torch.equal(out, compress.decode_tensor(INT8, q, s, dtype))
        R = q.numel() // q.shape[-1]
        want = jpack.int8_unpack(jnp.asarray(q.reshape(R, -1).numpy()),
                                 jnp.asarray(s.reshape(1).numpy()),
                                 block_rows=R,
                                 dtype=jnp.bfloat16 if dtype == torch.bfloat16
                                 else jnp.float32, interpret=True)
        np.testing.assert_array_equal(out.float().reshape(R, -1).numpy(),
                                      np.asarray(want, np.float32))
        if p is not None:
            assert torch.equal(p[:, 0], old[:, 0])
            assert torch.equal(p[:, 2], old[:, 2])


@pytest.mark.parametrize("shape,block,want", [
    ((30, 16, 3, 64), None, (16, 0)),        # smollm page leaf
    ((9, 16, 32, 80), None, (16, 0)),        # zamba2 page leaf
    ((8192, 576), None, (0, 576)),           # one stashed activation
    ((1600, 63), 16 * 63, (1, 0)),           # row blocks of 16 x 63
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_plan_regimes(shape, block, want, dtype):
    """The int8 pack's regime from a row block's size: every page leaf of
    the main paths (bf16, and zamba2's in the f32 run) on one cluster,
    8192 x 576 over two passes; a cluster's blocks hold the row block."""
    n = int(np.prod(shape)) if block is None else block
    size = torch.tensor([], dtype=dtype).element_size()
    cluster, slices = offload_pack.pack_plan(n, size)
    assert (cluster, slices) == want
    chunks = -(-n // offload_pack.VEC)
    if cluster:
        assert cluster * offload_pack.CLUSTER_THREADS \
            * offload_pack.REG_CHUNKS >= chunks
    else:
        assert slices * offload_pack.PASS_THREADS * offload_pack.BATCH \
            >= chunks


def test_runs_of_views():
    pool = torch.zeros((3, 6, 4, 2, 8))
    assert offload_pack.runs(pool[:, 5]) == (64, 6 * 64)
    assert offload_pack.runs(pool[:1, 2]) == (64, 64)   # one group: contiguous
    assert offload_pack.runs(pool[2, 1]) == (64, 64)
    assert offload_pack.runs(torch.zeros((5, 7))) == (35, 35)
    assert offload_pack.runs(torch.zeros((5, 7))[:, :3]) == (3, 7)
    assert offload_pack.runs(torch.zeros((5, 7)).t()) is None
    assert offload_pack.runs(pool[:, 1:3]) == (128, 6 * 64)
    assert offload_pack.runs(pool[:, :, 0]) == (16, 64)
    assert offload_pack.runs(pool[:, 1:3, :, 0]) is None


# ---------------------------------------------------------------------------
# the cache manager: the page path against the per-leaf path
def _per_leaf_encode(codec, xs):
    return [compress.encode_tensor(codec, x.clone()) for x in xs]


def _per_leaf_decode(codec, qs, scales, outs):
    for q, s, out in zip(qs, scales, outs):
        out.copy_(compress.decode_tensor(codec, q, s, out.dtype))


SERVE_CASES = {
    # reduced smollm: 10 frames of 4 rows for 2 slots of 8 pages, fair
    # preemption every 3 tokens
    "smollm": ("smollm-135m", dict(batch=2, max_len=32, page_size=4,
                                   pages=10), 10),
    # reduced zamba2: 12 frames of 8 rows for 2 slots of 8 pages
    "zamba2": ("zamba2-2.7b", dict(batch=2, max_len=64, page_size=8,
                                   pages=12), 20),
}


@pytest.mark.parametrize("decode_kernel", [False, True])
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_page_cycle_matches_per_leaf_path(case, decode_kernel, monkeypatch):
    """An int8 spill under pool pressure: pages evicted from the pool in
    one batched pack each, fetched back (or adopted into the side pool and
    inflated) in one batched unpack each.  The pool and side pool end byte
    for byte as the per-leaf path leaves them, with the same streams and
    the same stash / fetch bytes and page counters."""
    arch, kw, prompt = SERVE_CASES[case]
    model = Model(ARCHS[arch].reduced(dtype="float32"), device="cpu")
    params = model.init(0)
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=(prompt + 3 * i,))
             .astype(np.int32), 10) for i in range(4)]

    def run():
        eng = Engine(model, params, spill="host", decode_kernel=decode_kernel,
                     quota=TenantQuota(codec="int8"),
                     scheduler=FairScheduler(quantum=3), **kw)
        for uid, p, n in reqs:
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=n))
        done = sorted(eng.run(), key=lambda r: r.uid)
        return [r.out_tokens for r in done], eng.traffic_report(), eng.cache

    calls = {"encode": 0, "decode": 0}

    def counted(fn, key):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(cache_manager, "encode_leaves",
                        counted(compress.encode_leaves, "encode"))
    monkeypatch.setattr(cache_manager, "decode_leaves",
                        counted(compress.decode_leaves, "decode"))
    got, rep, cache = run()
    monkeypatch.setattr(cache_manager, "encode_leaves", _per_leaf_encode)
    monkeypatch.setattr(cache_manager, "decode_leaves", _per_leaf_decode)
    want, wrep, wcache = run()

    assert got == want
    for key in ("kv_stash", "kv_fetch", "pages", "decode_io",
                "page_decodes"):
        assert rep[key] == wrep[key], key
    assert rep["pages"]["evictions"] > 0
    assert rep["kv_stash"]["wire_bytes"] == rep["kv_fetch"]["wire_bytes"]
    dec = rep["page_decodes"]
    assert calls["encode"] == rep["pages"]["evictions"]
    assert calls["decode"] == dec["refetched"] + dec["inflated"]
    assert dec["refetched"] == (rep["pages"]["refetches"]
                                - rep["decode_io"]["compressed_adopts"])
    if decode_kernel:
        assert dec["inflated"] == rep["decode_io"]["compressed_adopts"] > 0
    for a, b in zip(tree.leaves(cache.pool), tree.leaves(wcache.pool)):
        assert torch.equal(a, b)
    if decode_kernel:
        for a, b in zip(tree.leaves(cache.cpool), tree.leaves(wcache.cpool)):
            assert torch.equal(a, b)


def test_fp8_pages_keep_the_per_leaf_pack(monkeypatch):
    """Only the int8 codec packs a page in one launch: an fp8 page packs
    leaf by leaf from a clone of its frame, and still decodes in one
    launch."""
    model = Model(ARCHS["smollm-135m"].reduced(dtype="float32"),
                  device="cpu")
    params = model.init(0)
    assert compress.get_codec("fp8").pack_leaves is None
    seen = []
    monkeypatch.setattr(cache_manager, "encode_leaves",
                        lambda *a: seen.append(a))
    eng = Engine(model, params, batch=2, max_len=32, page_size=4, pages=10,
                 spill="host", quota=TenantQuota(codec="fp8"),
                 scheduler=FairScheduler(quantum=3))
    rng = np.random.default_rng(5)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=rng.integers(0, 512, size=(10,))
                           .astype(np.int32), max_new_tokens=10))
    eng.run()
    rep = eng.traffic_report()
    assert not seen and rep["pages"]["evictions"] > 0
    assert rep["page_decodes"]["refetched"] == rep["pages"]["refetches"]


def test_leaf_wrappers_take_the_plain_version_on_the_cpu():
    xs = _leaves(torch.bfloat16)
    got = offload_pack.int8_pack_leaves(xs)
    for (q, s), (qr, sr) in zip(got, ref.int8_pack_leaves_ref(xs)):
        assert torch.equal(q, qr) and torch.equal(s, sr)
    before = offload_pack.int8_pack.launches, offload_pack.fp8_unpack.launches
    outs = [torch.empty(x.shape) for x in xs]
    offload_pack.unpack_leaves([q for q, _ in got], [s for _, s in got],
                               outs)
    assert (offload_pack.int8_pack.launches,
            offload_pack.fp8_unpack.launches) == before
    with pytest.raises(ValueError):
        offload_pack.unpack_leaves([got[0][0]], [], outs[:1])
