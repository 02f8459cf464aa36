"""The SSM (Mamba2) slice of the port against the JAX reference, on the CPU.

Inputs come from numpy seeds; weights from the reference's initialisers on
``mamba2_370m.reduced(dtype="float32")`` (2 layers, d_model 128, 8 heads
of P = 32, N = 16, chunk 16), carried over with
``repro_torch.convert.params_from_jax``.  The reference's Pallas scan runs
in interpret mode, as its own tests run it on the CPU.  The port's scan
takes its plain version on CPU tensors (the CUDA kernel against that plain
version is in test_torch_cuda.py).
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan as JMeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import ssm as jssm
from repro.models.layers import ModelContext as JContext
from repro.models.model import build_model as jbuild
from repro.parallel.sharding import ShardingPlanner
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.scheduler import FairScheduler as JFair
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import ModelContext
from repro_torch.models.model import Model, build_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import FairScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = JMeshPlan((1,), ("data",))
# float32 on both sides, the chunk products summed in different orders:
# agreement to a few f32 ulps of each output's largest magnitude
SCAN_TOL = 1e-5
# the reference's own tolerance for its Pallas scan against its oracle
# (tests/test_kernels.py::test_ssd_scan_sweep, float32)
PALLAS_TOL = 3e-4
# as tests/test_torch_serve.py (logits) and tests/test_torch_train.py
# (loss, gradients relative to each leaf's scale)
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
ARCH = "mamba2-370m"


def _cfgs(dtype="float32"):
    return JARCHS[ARCH].reduced(dtype=dtype), TARCHS[ARCH].reduced(dtype=dtype)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _scan_inputs(b, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    B = (rng.standard_normal((b, S, G, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, S, G, N)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, s0


def _close(got, want, tol, what=""):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err < tol, (what, err)


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]


# ---------------------------------------------------------------------------
# (a) the plain scan against the reference's chunked scan, its Pallas
# kernel, its oracle and both recurrences
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("S", [16, 48, 64])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_chunked_matches_reference(G, S, with_init):
    x, dt, A, B, C, s0 = _scan_inputs(2, S, 8, 32, G, 16, seed=S + G)
    s0 = s0 if with_init else None
    jy, jf = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 16,
                              init_state=None if s0 is None
                              else jnp.asarray(s0))
    ty, tf = tssm.ssd_chunked(*_t(x, dt, A, B, C), 16,
                              init_state=_t(s0)[0])
    assert ty.dtype == torch.float32 and tf.dtype == torch.float32
    _close(ty, jy, SCAN_TOL, "y")
    _close(tf, jf, SCAN_TOL, "final state")


@pytest.mark.parametrize("S,P,N,chunk", [(64, 32, 16, 16), (128, 32, 16, 32),
                                         (256, 64, 64, 128)])
def test_ssd_plain_matches_pallas_and_oracles(S, P, N, chunk):
    """Zero state, one group: the reference's Pallas scan takes x dt-scaled,
    the log decay dt A and B / C per (batch x head) row."""
    b, H = 2, 3
    x, dt, A, B, C, _ = _scan_inputs(b, S, H, P, 1, N, seed=S)
    ty, tf = tssm.ssd_chunked(*_t(x, dt, A, B, C), chunk)
    xbh = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(b * H, S, P)
    abh = (dt * A).transpose(0, 2, 1).reshape(b * H, S)
    Bbh = np.broadcast_to(B, (b, S, H, N)).transpose(0, 2, 1, 3) \
        .reshape(b * H, S, N)
    Cbh = np.broadcast_to(C, (b, S, H, N)).transpose(0, 2, 1, 3) \
        .reshape(b * H, S, N)
    jy = jssd_scan(*map(jnp.asarray, (xbh, abh, Bbh, Cbh)), chunk=chunk,
                   interpret=True)
    got = ty.numpy().transpose(0, 2, 1, 3).reshape(b * H, S, P)
    _close(got, jy, PALLAS_TOL, "pallas")
    fin = tf.numpy().reshape(b * H, P, N)
    for i in range(b * H):
        wy, wf = jref.ssd_ref(*map(jnp.asarray, (xbh[i], abh[i], Bbh[i],
                                                  Cbh[i])))
        oy, of = tref.ssd_ref(*_t(xbh[i], abh[i], Bbh[i], Cbh[i]))
        _close(oy, wy, SCAN_TOL, f"oracle y {i}")
        _close(of, wf, SCAN_TOL, f"oracle state {i}")
        _close(got[i], wy, PALLAS_TOL, f"y vs oracle {i}")
        _close(fin[i], wf, PALLAS_TOL, f"state vs oracle {i}")


def _ssd_variant(x, dt, A, B, C, chunk, change):
    """``models/ssm.ssd_chunked`` with one rounding changed: ``change``
    names one of its five roundings to x's dtype, which is skipped, or is
    "xdt", which rounds the float32 ``dt x`` to x's dtype as well."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    c, n, rep, dtype = chunk, S // chunk, H // G, x.dtype

    def rnd(t, name):
        return t.float() if name == change else t.to(dtype).float()

    cum = torch.cumsum((dt * A).reshape(b, n, c, H), dim=2)
    Bc = B.reshape(b, n, c, G, N).repeat_interleave(rep, dim=3).float()
    Cc = C.reshape(b, n, c, G, N).repeat_interleave(rep, dim=3).float()
    idx = torch.arange(c)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    L = torch.exp(torch.where(causal, seg, float("-inf")))
    scores = torch.einsum("bnihd,bnjhd->bnijh", Cc, Bc) * L
    xdt = x.reshape(b, n, c, H, P).float() * dt.reshape(b, n, c, H)[..., None]
    if change == "xdt":
        xdt = xdt.to(dtype).float()
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", rnd(scores, "scores"), xdt)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bnchd,bnchp->bnhpd",
                          rnd(Bc * decay_to_end[..., None], "decayed_B"), xdt)
    st = torch.zeros((b, H, P, N))
    prev = []
    for k in range(n):
        prev.append(st)
        st = st * torch.exp(cum[:, k, -1, :])[:, :, None, None] + states[:, k]
    y_inter = torch.einsum(
        "bnchd,bnhpd->bnchp",
        rnd(Cc * torch.exp(cum)[..., None], "decayed_C"),
        rnd(torch.stack(prev, dim=1), "state"))
    y = y_intra + rnd(y_inter, "y_inter")
    return y.reshape(b, S, H, P), st.to(dtype)


# what each change moves the probe's output by (max |d| over y and the
# final state, chunk 16): ``kernels/ssd_scan.rounding_probe``
PROBE_SHIFT = {"scores": 16 * 2.0 ** -8 * (1 + 2.0 ** -12),
               "decayed_B": 2.0 ** -7, "decayed_C": 2.0 ** -7,
               "state": 16 * 2.0 ** -7, "y_inter": 16 * 2.0 ** -8,
               "xdt": 16 * 2.0 ** -12}


@pytest.mark.parametrize("change", sorted(PROBE_SHIFT))
def test_ssd_rounding_probe(change):
    """The scan's rounding probe: the reference's ``ssd_chunked`` and the
    port's agree bit for bit on it (y float32, the final state bfloat16),
    the plain variant that changes nothing agrees too, and changing the
    named rounding moves the output by the probe's stated amount."""
    from repro_torch.kernels.ssd_scan import rounding_probe
    x, dt, A, B, C = rounding_probe(chunk=16, N=16, P=16)
    jx, jB, jC = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (x, B, C))
    jy, jf = jssm.ssd_chunked(jx, jnp.asarray(dt.numpy()),
                              jnp.asarray(A.numpy()), jB, jC, 16)
    ty, tf = tssm.ssd_chunked(x, dt, A, B, C, 16)
    assert np.array_equal(ty.numpy(), np.asarray(jy, np.float32))
    assert np.array_equal(tf.float().numpy(), np.asarray(jf, np.float32))
    vy, vf = _ssd_variant(x, dt, A, B, C, 16, None)
    assert torch.equal(vy, ty) and torch.equal(vf, tf)
    cy, cf = _ssd_variant(x, dt, A, B, C, 16, change)
    moved = max((cy - ty).abs().max().item(),
                (cf.float() - tf.float()).abs().max().item())
    assert moved == pytest.approx(PROBE_SHIFT[change], rel=1e-6)


@pytest.mark.parametrize("G,with_init", [(1, False), (2, True)])
def test_ssd_chunked_matches_recurrences(G, with_init):
    x, dt, A, B, C, s0 = _scan_inputs(2, 48, 8, 32, G, 16, seed=3)
    s0 = s0 if with_init else None
    ty, tf = tssm.ssd_chunked(*_t(x, dt, A, B, C), 16, init_state=_t(s0)[0])
    ry, rf = tssm.ssd_recurrent(*_t(x, dt, A, B, C), init_state=_t(s0)[0])
    jy, jf = jssm.ssd_recurrent(*map(jnp.asarray, (x, dt, A, B, C)),
                                init_state=None if s0 is None
                                else jnp.asarray(s0))
    _close(ry, jy, SCAN_TOL, "recurrent y")
    _close(rf, jf, SCAN_TOL, "recurrent state")
    _close(ty, ry, PALLAS_TOL, "chunked vs recurrent y")
    _close(tf, rf, PALLAS_TOL, "chunked vs recurrent state")


def test_ssd_op_grads_match_plain_autograd():
    """``kernels/ops.ssd`` (the autograd Function: active forward, backward
    recomputed through the plain version) against autograd straight
    through ``ssd_chunked``, for every input, the initial state included,
    and with a cotangent on the final state."""
    x, dt, A, B, C, s0 = _scan_inputs(1, 32, 4, 16, 2, 8, seed=9)
    rng = np.random.default_rng(10)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gf = rng.standard_normal(s0.shape).astype(np.float32)
    grads = []
    for fn in (tops.ssd, tssm.ssd_chunked):
        ins = [t.requires_grad_() for t in _t(x, dt, A, B, C, s0)]
        y, fin = fn(*ins[:5], 16, init_state=ins[5])
        ((y * torch.from_numpy(gy)).sum()
         + (fin * torch.from_numpy(gf)).sum()).backward()
        grads.append([t.grad for t in ins])
    for name, g, w in zip("x dt A B C init".split(), *grads):
        _close(g, w.numpy(), 1e-6, name)


def test_ssd_impl_registry():
    with pytest.raises(ValueError):
        tops.set_ssd_impl("pallas")
    x, dt, A, B, C, _ = _scan_inputs(1, 16, 2, 16, 1, 8)
    tops.set_ssd_impl("torch")
    try:
        y, _ = tops.ssd(*_t(x, dt, A, B, C), 16)
    finally:
        tops.set_ssd_impl("cuda")
    y2, _ = tops.ssd(*_t(x, dt, A, B, C), 16)      # CPU tensor: plain
    assert torch.equal(y, y2)


# ---------------------------------------------------------------------------
# (b) the causal conv and the Mamba2 block, prefill then decode
@functools.lru_cache(maxsize=None)
def _block_params():
    """Layer 0's SSM parameters of the reduced model, from the reference."""
    jcfg, _ = _cfgs()
    jp = jssm.mamba_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jp, params_from_jax(_np(jp), "cpu")


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jy, js = jssm._causal_conv(*map(jnp.asarray, (x, w, b)),
                               None if st is None else jnp.asarray(st))
    ty, ts = tssm._causal_conv(*_t(x, w, b), _t(st)[0])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(ty, jy, SCAN_TOL, "conv")


@pytest.mark.parametrize("S", [12, 16, 37])
def test_mamba_block_prefill_then_decode_matches_reference(S):
    """Prefill S tokens from a zeroed cache (S padded to the chunk inside
    the block), then two S = 1 decode steps through the recurrence: the
    outputs and both cache leaves after every call."""
    jcfg, tcfg = _cfgs()
    jp, tp = _block_params()
    rng = np.random.default_rng(S)
    xs = (rng.standard_normal((2, S + 2, jcfg.d_model)) * 0.5) \
        .astype(np.float32)
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tcache = tssm.init_ssm_cache(tcfg, 2, torch.float32, "cpu")
    jctx = JContext(cfg=jcfg, planner=ShardingPlanner(SINGLE),
                    memory=JMemoryPlan(policy="none"), mode="prefill")
    tctx = ModelContext(cfg=tcfg, mode="prefill")
    for lo, hi in ((0, S), (S, S + 1), (S + 1, S + 2)):
        jy, jcache = jssm.mamba_block(jp, jctx, jnp.asarray(xs[:, lo:hi]),
                                      jcache)
        ty, tcache = tssm.mamba_block(tp, tctx, _t(xs[:, lo:hi])[0], tcache)
        _close(ty, jy, LOGIT_TOL, f"block out {lo}:{hi}")
        for k in ("conv", "ssm"):
            _close(tcache[k], jcache[k], LOGIT_TOL, f"{k} {lo}:{hi}")


# ---------------------------------------------------------------------------
# (c) the whole reduced model: prefill, decode, loss and gradients
@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    run = JRunConfig(model=jcfg, shape=JShapeConfig("t", 64, 2, "decode"),
                     mesh=SINGLE, memory=JMemoryPlan(policy="none"))
    jm = jbuild(run)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(tcfg, device="cpu")
    tp = params_from_jax(_np(jp), "cpu")
    return jm, jp, tm, tp


def test_param_tree_layout(models):
    jm, jp, tm, tp = models
    init = tm.init(0)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t, i = tp, init
        for k in path:
            t, i = t[k.key], i[k.key]
        assert tuple(t.shape) == leaf.shape == tuple(i.shape), path
        assert i.dtype == t.dtype, path
    assert sorted(tp["groups"]["sub_0"]["ssm"]) == sorted(
        ["in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
         "norm_scale", "out_proj"])


@pytest.mark.parametrize("S", [11, 20, 37])
def test_prefill_and_decode_logits_match(models, S):
    """Prefill S tokens (S padded to the chunk inside each block), then two
    decode steps through the recurrence."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(S)
    toks = rng.integers(0, 512, size=(2, S + 2)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S + 2, dtype=np.int32), (2, S + 2))

    def j_in(lo, hi):
        return jnp.asarray(toks[:, lo:hi]), jnp.asarray(pos[:, lo:hi])

    def t_in(lo, hi):
        return (torch.from_numpy(np.ascontiguousarray(a[:, lo:hi])).long()
                for a in (toks, pos))

    jt, jpos = j_in(0, S)
    jl, jc = jm.prefill(jp, {"tokens": jt, "positions": jpos},
                        jm.init_cache(2, 64))
    tt, tpos = t_in(0, S)
    tl, tc = tm.prefill(tp, {"tokens": tt, "positions": tpos},
                        tm.init_cache(2, 64))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for i in (S, S + 1):
        jl, jc = jm.decode_step(jp, *j_in(i, i + 1), jc, jnp.int32(i))
        tl, tc = tm.decode_step(tp, *t_in(i, i + 1), tc, i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_decode_matches_prefill_continuation(dtype, tol):
    """As the reference's ``test_smoke_archs.py``: decode after prefill(S)
    equals a fresh prefill(S+1)'s last-token logits."""
    _, tcfg = _cfgs(dtype)
    m = Model(tcfg, device="cpu")
    params = m.init(0)
    S, B = 21, 2
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, size=(B, S + 1))).long()
    pos = torch.arange(S + 1)[None].expand(B, S + 1)
    _, caches = m.prefill(params, {"tokens": toks[:, :S],
                                   "positions": pos[:, :S]},
                          m.init_cache(B, S + 8))
    dec, _ = m.decode_step(params, toks[:, S:], pos[:, S:], caches, S)
    pref, _ = m.prefill(params, {"tokens": toks, "positions": pos},
                        m.init_cache(B, S + 8))
    a, b = dec.float(), pref.float()
    assert float((a - b).abs().max() / b.abs().max()) < tol
    assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_loss_fn_and_grads_match_reference():
    """One step's loss and every gradient leaf under ``--policy host`` (each
    layer's input stashed and the layer recomputed in backward) with no
    codec, against the reference's."""
    jcfg, tcfg = _cfgs()
    shape = JShapeConfig("train", 40, 4, "train")
    jm = jbuild(JRunConfig(model=jcfg, shape=shape, mesh=SINGLE,
                           memory=JMemoryPlan(policy="host")))
    tm = build_model(RunConfig(model=tcfg,
                               shape=ShapeConfig("train", 40, 4, "train"),
                               memory=MemoryPlan(policy="host")),
                     device="cpu")
    assert tm.runtime.offloads
    jp = jm.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(tm.cfg, batch=4, seq=40, seed=1).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.requires_grad_(),
                  params_from_jax(_np(jp), "cpu"))
    tl, _ = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    want = _np(jg)
    for g, path in zip(tg, paths):
        w = want
        for k in path:
            w = w[k]
        _close(g, w, GRAD_TOL, "/".join(path))
    rep = tm.runtime.traffic_report()       # one stash + fetch per layer
    assert rep["stash"]["calls"] == rep["fetch"]["calls"] == 2


# ---------------------------------------------------------------------------
# (d) the serving engine
def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return [r.out_tokens for r in done], eng.traffic_report()


def test_engine_streams_match_reference_under_preemption(models):
    """Prompts across chunk boundaries (12, 20, 37 tokens with chunk 16),
    fair preemption every 3 tokens over 2 slots, sessions parked whole to
    the host tier and resumed: the greedy streams and the spill bytes are
    the reference engine's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(11)
    reqs = [(i, rng.integers(0, 512, size=(n,)).astype(np.int32), 9)
            for i, n in enumerate((12, 20, 37, 12))]
    kw = dict(batch=2, max_len=64, spill="host")
    want, jrep = _streams(JEngine, JRequest, jm, jp, reqs,
                          scheduler=JFair(quantum=3), **kw)
    got, trep = _streams(Engine, Request, tm, tp, reqs,
                         scheduler=FairScheduler(quantum=3), **kw)
    assert got == want
    assert trep["kv_stash"]["calls"] > 0
    assert trep["kv_stash"] == jrep["kv_stash"]
    assert trep["kv_fetch"] == jrep["kv_fetch"]


def test_mixed_length_decode_keeps_other_slots_state(models):
    """Two sessions at different lengths decode in one batch, one length
    group at a time: each group's step must leave the other slot's conv
    and ssm state as it was, so each stream equals the one it gives when
    served alone."""
    _, _, tm, tp = models
    reqs = [(0, np.arange(5, dtype=np.int32) + 1, 8),
            (1, (np.arange(9, dtype=np.int32) * 7 + 3) % 512, 8)]
    together, _ = _streams(Engine, Request, tm, tp, reqs, batch=2,
                           max_len=32)
    alone = [_streams(Engine, Request, tm, tp, [r], batch=1,
                      max_len=32)[0][0] for r in reqs]
    assert together == alone


def test_paged_pool_rejects_pure_ssm(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="k/v"):
        ttfm.paged_pool(tm.cfg, 8, 8, torch.float32, "cpu")
    with pytest.raises(ValueError):
        Engine(tm, tp, batch=1, max_len=32, page_size=8)


# ---------------------------------------------------------------------------
# (e) conversion, guards and the CLIs
def test_bf16_carry_over_keeps_ssm_f32_leaves():
    """Under a bf16 cast the norms and the block's A_log, D, dt_bias and
    norm_scale stay float32 and bit-equal to the reference's."""
    jcfg, _ = _cfgs("bfloat16")
    jp = jbuild(JRunConfig(model=jcfg, shape=JShapeConfig("t", 8, 1, "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy="none"))
                ).init(jax.random.PRNGKey(0))
    want = _np(jp)
    tp = params_from_jax(want, "cpu", dtype=torch.bfloat16)
    ssm = tp["groups"]["sub_0"]["ssm"]
    for k in ("A_log", "D", "dt_bias", "norm_scale"):
        w = want["groups"]["sub_0"]["ssm"][k]
        assert w.dtype == np.float32, k
        assert ssm[k].dtype == torch.float32, k
        np.testing.assert_array_equal(ssm[k].numpy(), w)
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert ssm[k].dtype == torch.bfloat16, k
    assert tp["groups"]["sub_0"]["ln1"]["scale"].dtype == torch.float32
    assert tp["final_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_every_configuration_builds_and_prefills(arch):
    """Every configuration of the registry builds in the port: its reduced
    twin initialises, and one prefill (with its frontend's frames or
    patches, M-RoPE's (3, B, S) positions) gives finite logits over the
    padded vocabulary and fills the cache."""
    cfg = TARCHS[arch].reduced(dtype="float32")
    m = Model(cfg, device="cpu")
    batch = to_device(SyntheticLM(cfg, batch=2, seq=16, seed=0).batch_at(0),
                      "cpu")
    batch.pop("labels")
    cache = m.init_cache(2, 24)
    logits, cache = m.prefill(m.init(0), batch, cache)
    assert logits.shape == (2, cfg.padded_vocab)
    assert torch.isfinite(logits).all()
    assert any(c.abs().max() > 0 for c in tree.leaves(cache))


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_serve_cli_smoke():
    proc = _cli("repro_torch.launch.serve", "--arch", ARCH, "--smoke",
                "--device", "cpu", "--batch", "2", "--max-len", "64",
                "--requests", "4", "--prompt-len", "20", "--new-tokens", "6",
                "--scheduler", "fair", "--quantum", "2", "--spill", "host")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 4 requests, 24 tokens" in proc.stdout
    assert "spill[" in proc.stdout


def test_train_cli_smoke(tmp_path):
    proc = _cli("repro_torch.launch.train", "--arch", ARCH, "--smoke",
                "--device", "cpu", "--steps", "3", "--policy", "host",
                "--compress", "fp8", "--log-every", "1",
                "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3 loss=" in proc.stdout
    assert "2 of 2 layer groups stashed" in proc.stdout
    assert "memory traffic: tier=host+fp8" in proc.stdout
