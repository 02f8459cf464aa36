"""The output-stationary GEMM of the port against the JAX reference, on the
CPU.

The reference's Pallas ``gemm_os`` runs in interpret mode, as its own
``tests/test_kernels.py`` runs it; the port's ``ops.gemm`` on CPU tensors
takes the kernel's plain version (``kernels/ref.gemm_ref``).  Inputs come
from numpy seeds.  The CUDA kernel against that plain version is in
test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemm_os import gemm_os as jgemm_os
from repro_torch.kernels import gemm_os as tg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

#: the reference's sweep (tests/test_kernels.py::test_gemm_os_sweep): its
#: shapes, blocks and tolerances (float32 summation order; bfloat16
#: inputs and output)
SWEEP = [(128, 128, 128, 128, 128, 128),
         (256, 512, 384, 128, 128, 128),
         (256, 1024, 256, 128, 128, 256),
         (512, 256, 512, 256, 256, 128)]
TOLS = {"float32": 1e-4, "bfloat16": 2e-1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, n, dtype, seed=0):
    """x (m, k), w (k, n) rounded to ``dtype`` once, handed to both."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.float32).astype(jd)
    w = jnp.asarray(rng.standard_normal((k, n)), jnp.float32).astype(jd)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)
              for a in (x, w))
    return x, w, tx, tw


@pytest.mark.parametrize("dtype", sorted(TOLS))
@pytest.mark.parametrize("m,k,n,bm,bn,bk", SWEEP)
def test_gemm_matches_reference_sweep(m, k, n, bm, bn, bk, dtype):
    """Each of the reference's sweep cases through its Pallas kernel
    (interpret mode, its blocks) and through the port's ``ops.gemm`` (its
    own blocks: ``pick_blocks``), to the reference's tolerance."""
    x, w, tx, tw = _inputs(m, k, n, dtype)
    want = jgemm_os(x, w, bm=bm, bn=bn, bk=bk, interpret=True)
    got = tops.gemm(tx, tw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (m, n)
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("dtype", sorted(TOLS))
def test_plain_version_is_the_f32_product_rounded_once(dtype):
    """``gemm_ref`` sums in float32 and rounds to the input type once: the
    reference's oracle (``jnp.dot`` with a float32 accumulator) to float32
    rounding, and in bfloat16 to one bf16 ulp of the largest output."""
    from repro.kernels import ref as jref
    x, w, tx, tw = _inputs(64, 96, 48, dtype, seed=1)
    got = tref.gemm_ref(tx, tw).float().numpy()
    want = np.asarray(jref.gemm_ref(x, w).astype(jnp.float32))
    top = float(np.abs(want).max())
    tol = 1e-6 * top if dtype == "float32" else \
        2.0 ** (np.floor(np.log2(top)) - 7)
    assert float(np.abs(got - want).max()) <= tol


# the blocks the reference's cases name, and the tiles of each path: float32
# (CUDA cores) takes (bm, bn) in {64, 128} and a bk, a multiple of 16, whose
# slabs fit 227 KB of shared memory (bk <= 208 at 128 x 128); bfloat16
# (tensor cores) takes bm in {64, 128}, bn in {64, 128, 256} and a bk, a
# multiple of 64, with one ring stage within 227 KB (bk <= 256 at 128 x
# 256)
NAMED = [((128, 128, 128), "float32", True),
         ((128, 128, 128), "bfloat16", True),
         ((128, 128, 256), "bfloat16", True),
         ((128, 128, 256), "float32", False),
         ((256, 256, 128), "float32", False),
         ((256, 256, 128), "bfloat16", False),
         ((64, 128, 48), "float32", True),
         ((64, 128, 48), "bfloat16", False),
         ((128, 256, 64), "bfloat16", True),
         ((128, 256, 64), "float32", False),
         ((64, 256, 192), "bfloat16", True),
         ((128, 256, 384), "bfloat16", False)]


@pytest.mark.parametrize("blocks,dtype,taken", NAMED)
def test_named_blocks_taken_or_refused(blocks, dtype, taken):
    """A caller's blocks are used as named where the kernel instantiates
    that tile; otherwise ``ValueError`` names the tiles it takes — never
    a quiet swap for other blocks."""
    bm, bn, bk = blocks
    _, _, tx, tw = _inputs(512, 1536, 512, dtype, seed=2)
    assert tg.supported(bm, bn, bk, tx.element_size()) == taken
    if taken:
        got = tops.gemm(tx, tw, bm=bm, bn=bn, bk=bk)
        assert torch.equal(got, tref.gemm_ref(tx, tw))
    else:
        with pytest.raises(ValueError, match=r"no \(.*\) tile.*\(bm, bn\) in"):
            tops.gemm(tx, tw, bm=bm, bn=bn, bk=bk)


@pytest.mark.parametrize("m,k,n", [(256, 8192, 22528), (4096, 512, 1024),
                                   (128, 128, 128), (4096, 2560, 10240),
                                   (4096, 10240, 2560), (192, 80, 320)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_pick_blocks_divide_fit_and_exist(m, k, n, itemsize):
    """The reference's pick_blocks shapes (tests/test_kernels.py), zamba2's
    MLP and a ragged one: blocks that divide the dims and are a tile of the
    dtype's path.  float32: bk aligned to the kernel's 16-byte copies,
    double-buffered slabs within half of the 227 KB a block may use (two
    blocks a SM).  bfloat16: bk 64 (one swizzled 128-byte row of x), a
    ring of at least 4 stages in one block's shared memory; K = 80 has no
    such bk and is refused."""
    if itemsize == 2 and k % tg.TC_BOX:
        with pytest.raises(ValueError, match=r"no tile.*\(bm, bn\) in"):
            tg.pick_blocks(m, k, n, itemsize)
        return
    bm, bn, bk = tg.pick_blocks(m, k, n, itemsize)
    assert m % bm == 0 and n % bn == 0 and k % bk == 0
    assert tg.supported(bm, bn, bk, itemsize)
    if itemsize == 2:
        assert (bm, bn) in tg.TC_TILES and bk == tg.TC_BOX
        assert tg.stages_for(bm, bn, bk, 2) >= 4
        assert tg.TC_RESERVED + tg.stages_for(bm, bn, bk, 2) * \
            tg.tc_stage_bytes(bm, bn, bk) <= tg.SMEM_PER_BLOCK
    else:
        assert (bm, bn) in tg.TILES and bk % tg.BK_ALIGN == 0
        assert 2 * tg.slab_bytes(bm, bn, bk, itemsize) <= \
            tg.SMEM_PER_BLOCK // 2


@pytest.mark.parametrize("m,k,n,blocks", [
    (256, 512, 384, (128, 128, 96)),     # bk does not divide K
    (200, 512, 384, (128, 128, 128)),    # bm does not divide M
    (256, 512, 384, (128, 256, 128)),    # bn does not divide N
    (96, 512, 384, None),                # no tile divides M
    (256, 520, 384, None)])              # no bk divides K
def test_dims_the_blocks_do_not_divide_raise(m, k, n, blocks):
    _, _, tx, tw = _inputs(m, k, n, "float32")
    kw = {} if blocks is None else dict(zip(("bm", "bn", "bk"), blocks))
    with pytest.raises(ValueError):
        tops.gemm(tx, tw, **kw)


def test_gemm_impl_registry():
    """'torch' runs the plain version and takes no blocks; unknown names
    raise."""
    _, _, tx, tw = _inputs(128, 64, 128, "float32")
    tops.set_gemm_impl("torch")
    try:
        assert torch.equal(tops.gemm(tx, tw), tref.gemm_ref(tx, tw))
        with pytest.raises(ValueError):
            tops.gemm(tx, tw, bm=128, bn=128, bk=64)
    finally:
        tops.set_gemm_impl("cuda")
    with pytest.raises(ValueError):
        tops.set_gemm_impl("pallas")
