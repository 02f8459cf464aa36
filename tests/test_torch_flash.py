"""The port's flash-attention forward and its gradient pairing against the
JAX reference's, on the CPU (the CUDA kernel against its plain version on
the card is in test_torch_cuda.py).

Inputs come from numpy seeds and go to both frameworks as numpy arrays.
The reference's ``kernels/ops.flash_attention`` runs its Pallas forward in
interpret mode (as its own tests run it on the CPU) and recomputes the
backward through XLA's blockwise twin; the port's runs its plain forward
on a CPU tensor and recomputes the backward through its blockwise twin.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention_fwd

# float32 on both sides; the two sum the QK and PV products in different
# orders and the reference walks kv in 128-row tiles with an online
# softmax, the twin in one span: agreement to a few f32 ulps of O(1)
# outputs and gradients
TOL = 2e-5

CASES = {
    "gqa_causal": (2, 4, 2, 128, 128, 32, True, 0),
    "window64": (1, 4, 2, 256, 256, 32, True, 64),
    "non_causal": (2, 4, 2, 96, 160, 32, False, 0),
    "ragged_s200": (1, 6, 2, 200, 200, 64, True, 0),
}


def _inputs(B, H, K, S, T, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, d)).astype(np.float32)
    k = rng.standard_normal((B, K, T, d)).astype(np.float32)
    v = rng.standard_normal((B, K, T, d)).astype(np.float32)
    g = rng.standard_normal((B, H, S, d)).astype(np.float32)
    return q, k, v, g


@functools.lru_cache(maxsize=None)
def _case(case):
    """A case's numpy inputs, and the reference's forward and VJP against
    the cotangent g (computed once per case)."""
    B, H, K, S, T, d, causal, window = CASES[case]
    q, k, v, g = _inputs(B, H, K, S, T, d)

    def f(q, k, v):
        return jops.flash_attention(q, k, v, causal, window)

    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    return (q, k, v, g), want


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_twin_matches_reference_forward(case):
    """The plain twin (the kernel's CPU path) == the Pallas kernel."""
    *_, causal, window = CASES[case]
    (q, k, v, _), want = _case(case)
    want = want[0]
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    wrapped = flash_attention_fwd(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_op_forward_and_grads_match_reference(case):
    """ops.flash_attention (forward and torch.autograd.grad) == the
    reference's ops.flash_attention under jax.vjp."""
    *_, causal, window = CASES[case]
    (q, k, v, g), want = _case(case)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = tops.flash_attention(*ts, causal, window)
    grads = torch.autograd.grad(o, ts, torch.from_numpy(g))
    for name, got, w in zip(("out", "dq", "dk", "dv"), [o, *grads], want):
        np.testing.assert_allclose(got.detach().numpy(), w, rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("impl", ["cuda", "torch"])
def test_flash_impl_switch(impl):
    """Both impls give the same numbers on a CPU tensor (the 'cuda' impl's
    CPU path is the plain twin); unknown names are refused."""
    q, k, v, _ = _inputs(1, 2, 1, 64, 64, 32)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    want = tref.flash_attention_ref(*args, causal=True, window=0)
    tops.set_flash_impl(impl)
    try:
        got = tops.flash_attention(*args, True, 0)
    finally:
        tops.set_flash_impl("cuda")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tops.set_flash_impl("pallas")
    assert tops._FLASH_IMPL["default"] == "cuda"


def test_flash_strided_views_match_contiguous():
    """The model hands the op (B, S, H, d) projections seen as (B, H, S, d)
    views: same result as contiguous inputs."""
    q, k, v, _ = _inputs(2, 4, 2, 64, 64, 32)
    views = [torch.from_numpy(np.ascontiguousarray(a.swapaxes(1, 2)))
             .transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = tops.flash_attention(*views, True, 0)
    want = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                True, 0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
