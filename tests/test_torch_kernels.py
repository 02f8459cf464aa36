"""The port's kernels' plain versions against the JAX reference's kernels,
on the CPU (the CUDA kernels against their plain versions on the card are
in test_torch_cuda.py, which imports no JAX).

Inputs come from numpy seeds and go to both frameworks as numpy arrays.
The Pallas kernels run in interpret mode, as the reference's own tests run
them on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcomp
from repro.kernels import offload_pack as jpack
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_decode_attention as jpaged
from repro_torch.core import compress as tcomp
from repro_torch.kernels import offload_pack as tpack
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.paged_attention import paged_decode_attention

# float32 on both sides; the two frameworks sum the dot products in
# different orders, so agreement is to a few float32 ulps of O(1) values
PAGED_TOL = 1e-5


def _paged_inputs(B, H, K, hd, page, pp, seed=0, n_comp=0):
    """q, raw pools and a permuted page map with one scratch-routed entry
    (the layout PagedKVCacheManager produces); with ``n_comp`` > 0 that many
    mapped frames move to an int8 side pool (ids >= P) through the int8
    codec's per-tensor encode."""
    rng = np.random.default_rng(seed)
    P = B * pp + 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    pm = rng.permutation(P - 1)[:B * pp].reshape(B, pp).astype(np.int32)
    pm[0, -1] = P - 1
    side = {}
    if n_comp:
        frames = [int(f) for f in pm.reshape(-1)[:n_comp]]
        kq, vq, ks, vs = [], [], [], []
        for ci, fr in enumerate(frames):
            for pool, qs, ss in ((kp, kq, ks), (vp, vq, vs)):
                qq, sc = jcomp.int8_compress(jnp.asarray(pool[fr]))
                qs.append(np.asarray(qq))
                ss.append([float(sc)])
            pm[pm == fr] = P + ci
        side = dict(kq_pool=np.stack(kq), vq_pool=np.stack(vq),
                    k_scale=np.asarray(ks, np.float32),
                    v_scale=np.asarray(vs, np.float32))
    return q, kp, vp, pm, side


def _both(q, kp, vp, pm, idx, side, **kw):
    got = paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(pm), idx, **kw,
        **{k: torch.from_numpy(v) for k, v in side.items()})
    want = jpaged(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                  jnp.asarray(pm), jnp.int32(idx), interpret=True, **kw,
                  **{k: jnp.asarray(v) for k, v in side.items()})
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("page,pp,window,softcap,H,K", [
    (4, 6, 0, 0.0, 4, 4),
    (8, 4, 9, 0.0, 4, 2),
    (16, 2, 0, 30.0, 6, 2),
    (8, 4, 9, 30.0, 6, 2),
])
def test_paged_plain_matches_pallas(page, pp, window, softcap, H, K):
    """Plain paged decode == the Pallas kernel (interpret mode) across page
    size x window x softcap x GQA, at fills including page boundaries."""
    q, kp, vp, pm, side = _paged_inputs(2, H, K, 32, page, pp)
    for idx in (0, page - 1, page, pp * page - 1):
        got, want = _both(q, kp, vp, pm, idx, side, window=window,
                          softcap=softcap)
        np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)


def test_paged_plain_fused_int8_side_pool():
    """Side-pool frames dequantise in the load exactly as the reference's
    fused path does, and really replace the raw frames."""
    q, kp, vp, pm, side = _paged_inputs(2, 4, 2, 32, 8, 3, seed=1, n_comp=3)
    got, want = _both(q, kp, vp, pm, 23, side)
    np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    *_, raw_pm, _ = _paged_inputs(2, 4, 2, 32, 8, 3, seed=1)
    raw = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp),
                                 torch.from_numpy(raw_pm), 23)
    assert not np.allclose(got, raw.numpy())


def test_paged_plain_inactive_slot_finite():
    """cache_index=-1 masks every row: finite output (the engine discards
    it), equal to the reference's plain twin."""
    q, kp, vp, pm, _ = _paged_inputs(2, 4, 2, 32, 8, 3)
    got = paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                 torch.from_numpy(vp), torch.from_numpy(pm),
                                 -1)
    assert torch.isfinite(got).all()
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(pm),
        jnp.int32(-1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=PAGED_TOL, atol=PAGED_TOL)


def test_paged_impl_registry():
    q, kp, vp, pm, _ = _paged_inputs(1, 2, 2, 16, 4, 2)
    args = [torch.from_numpy(a) for a in (q, kp, vp, pm)] + [5]
    a = tops.paged_attention(*args, impl="cuda")
    b = tops.paged_attention(*args, impl="torch")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.set_paged_impl("pallas")
    assert tops._PAGED_IMPL["default"] == "cuda"


@pytest.mark.parametrize("pp,B,K,sms", [(16, 8, 3, 132), (32, 6, 32, 132),
                                         (1, 1, 1, 132), (0, 2, 2, 132),
                                         (7, 1, 2, 8), (64, 16, 8, 132),
                                         (33, 2, 1, 132), (5, 40, 40, 16)])
def test_paged_split_plan(pp, B, K, sms):
    """The paged decode's split plan: every page-map column in exactly one
    split, no split empty of columns, each split at least 4 columns where
    the map has them, the scratch sized for every split's partial; and
    nothing in it can depend on ``cache_index`` (it is not an argument),
    so a pool and batch launch one grid at every length."""
    from repro_torch.kernels.paged_attention import split_plan
    n, per, scratch = split_plan(pp, B, K, 3, 64, sms)
    assert (n, per, scratch) == split_plan(pp, B, K, 3, 64, sms)
    assert n >= 1 and per >= 1
    cols = [j for s in range(n)
            for j in range(s * per, min(pp, (s + 1) * per))]
    assert cols == list(range(pp))
    if pp:
        assert (n - 1) * per < pp                 # the last split has columns
        assert per >= min(pp, 4)
    assert scratch == (B * K * n * 3 * (64 + 2),)
    assert "cache_index" not in split_plan.__code__.co_varnames


# ---------------------------------------------------------------------------
# int8 codec: bit-exact against the reference
@pytest.mark.parametrize("rows,block_rows,dtype", [
    (256, 64, "float32"),
    (1440, 1440, "float32"),     # one page leaf at full width, R % 128 != 0
    (1440, 1440, "bfloat16"),
    (384, 128, "bfloat16"),
])
def test_int8_pack_unpack_bit_exact(rows, block_rows, dtype):
    rng = np.random.default_rng(rows + block_rows)
    x32 = (rng.standard_normal((rows, 64)) * 3.0).astype(np.float32)
    xj = jnp.asarray(x32, dtype=dtype)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    qj, sj = jpack.int8_pack(xj, block_rows=block_rows, interpret=True)
    qt, st = tpack.int8_pack(xt, block_rows=block_rows)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    for out in ("float32", "bfloat16"):
        yj = jpack.int8_unpack(qj, sj, block_rows=block_rows,
                               dtype=jnp.dtype(out), interpret=True)
        yt = tpack.int8_unpack(qt, st, block_rows=block_rows,
                               dtype=getattr(torch, out))
        np.testing.assert_array_equal(yt.float().numpy(),
                                      np.asarray(yj, np.float32))


@pytest.mark.parametrize("name,dtype", [("int8", "float32"),
                                        ("int8", "bfloat16"),
                                        ("blocksparse", "float32"),
                                        ("fp8", "float32")])
def test_encode_decode_tensor_bit_exact(name, dtype):
    """The per-page spill encode/decode equals the reference's: every codec
    through its kernels (one row block per page leaf) against the
    reference's per-tensor transform, which its serving spill runs op by
    op.  (The reference's Pallas kernels run under jit, where XLA turns
    the scale's division by a constant into a multiplication by its
    reciprocal: see test_torch_train.py's codec test.)"""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 8, 4, 16)) * 3.0).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    qj, sj = jcomp.encode_tensor(jcomp.get_codec(name), xj, kernel=False)
    codec = tcomp.get_codec(name)
    qt, st = tcomp.encode_tensor(codec,
                                 torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(qt.float().numpy(),
                                  np.asarray(qj, np.float32))
    assert float(st) == float(sj)
    yj = jcomp.decode_tensor(jcomp.get_codec(name), qj, sj, jnp.float32,
                             kernel=False)
    yt = tcomp.decode_tensor(codec, qt, st, torch.float32)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
