"""The encoder-decoder (whisper-medium) and VLM (qwen2-vl-2b) families of
the port against the JAX reference, on the CPU.

Each runs ``.reduced(dtype="float32")`` (whisper: 2 encoder and 2 decoder
layers over 8 frames; qwen2-vl: 2 layers, 8 patches, M-RoPE sections (8,
4, 4)) with weights from the reference's ``Model.init(PRNGKey(0))``
carried over through numpy, and the same seeded noise on the leaves the
reference initialises to constants (qkv biases, norm scales and biases),
as ``tests/test_torch_dense.py`` does.  Logits agree to 1e-4, losses to
1e-5, every gradient leaf to 2e-5 of its largest magnitude; token streams
and data batches are bit-exact.

Two reference facts shape the checks.  No reference serving path feeds
audio to the decoder: every cache it builds carries zeroed cross-attention
``ck`` / ``cv``, and a ``"dec"`` layer reads those whenever the cache has
them, so ``Model.prefill`` with frames computes the encoder and discards
it (pinned below; the port keeps it).  And the reference's in-place paged
decode cannot run whisper (ROADMAP C10): its ``"dec"`` layer calls
``attention_block`` without ``paged=``, so the pool-shaped leaves reach
the plain decode attention and raise; the port's kernel path is held to
the reference's paged gather streams instead.
"""
import functools
import logging
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
from repro.configs import MeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.runtime import MemoryRuntime as JRuntime
from repro.data.pipeline import MemmapTokens as JMemmapTokens
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
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
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.data.pipeline import MemmapTokens, SyntheticLM, to_device
from repro_torch.models import attention as tattn
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import ModelContext
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.scheduler import FairScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER, QWEN = "whisper-medium", "qwen2-vl-2b"
SINGLE = MeshPlan((1,), ("data",))
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
#: the leaves the reference initialises to constants
NOISY = ("bq", "bk", "bv", "scale", "bias")
TRAIN_B, TRAIN_S = 2, 12           # whisper: 12 decoder tokens, 8 frames
QWEN_S = 20                        # past qwen2-vl's 8 patch positions


def _noisy(params):
    """The reference's tree as numpy, with seeded noise on ``NOISY``."""
    rng = np.random.default_rng(11)

    def walk(t):
        if isinstance(t, dict):
            return {k: (np.asarray(v) + rng.standard_normal(np.shape(v))
                        .astype(np.float32) * 0.1 if k in NOISY
                        else walk(v)) for k, v in t.items()}
        return np.asarray(t)

    return walk(jax.tree.map(np.asarray, params))


@functools.lru_cache(maxsize=None)
def _pair(arch, policy="host"):
    """(reference model, its params, port model, its params) on one set
    of weights."""
    shape = (TRAIN_S if arch == WHISPER else QWEN_S, TRAIN_B)
    jm = jbuild(JRunConfig(model=JARCHS[arch].reduced(dtype="float32"),
                           shape=JShapeConfig("train", *shape, "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy=policy)))
    params = _noisy(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(RunConfig(model=TARCHS[arch].reduced(dtype="float32"),
                               shape=ShapeConfig("train", *shape, "train"),
                               memory=MemoryPlan(policy=policy)),
                     device="cpu")
    return (jm, jax.tree.map(jnp.asarray, params), tm,
            params_from_jax(params, "cpu"))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if dtype is None and not t.is_floating_point() else t


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _mrope_positions(B, S, seed, offset=0):
    """(3, B, S) positions whose three axes differ (the engine and the
    synthetic stream give three equal axes, which M-RoPE turns into plain
    RoPE)."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(offset, offset + S), (B, S))
    return np.stack([t, t // 3 + rng.integers(0, 4, (B, S)),
                     (t * 7) % 11]).astype(np.int32)


# ---------------------------------------------------------------------------
# (a) frontends, M-RoPE and sinusoidal positions
@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_frontend_matches_reference(arch):
    """whisper's ``embed_frames`` and qwen2-vl's ``merge_patches``: the
    projection of the stub's raw embeddings plus the learned positions
    (and, for patches, the text embeddings past them)."""
    jm, jp, tm, tp = _pair(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    d_in = tfront.frontend_dim(cfg)
    assert d_in == jfront.frontend_dim(jm.cfg) == {
        WHISPER: tfront.AUDIO_FRAME_DIM, QWEN: tfront.VISION_PATCH_DIM}[arch]
    raw = rng.standard_normal((2, 6, d_in)).astype(np.float32)
    if arch == WHISPER:
        want = jfront.embed_frames(jp["frontend"], jm.cfg, jnp.asarray(raw))
        got = tfront.embed_frames(tp["frontend"], cfg, _t(raw))
    else:
        emb = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
        want = jfront.merge_patches(jp["frontend"], jm.cfg,
                                    jnp.asarray(emb), jnp.asarray(raw))
        got = tfront.merge_patches(tp["frontend"], cfg, _t(emb), _t(raw))
        np.testing.assert_array_equal(got[:, 6:].numpy(), emb[:, 6:])
    _close(got.numpy(), want, LOGIT_TOL)


@pytest.mark.parametrize("case", ["mrope", "mrope_full", "rope",
                                  "sinusoidal"])
def test_positions_match_reference(case):
    """M-RoPE on distinct (3, B, S) axes (the reduced sections and
    qwen2-vl's own (16, 24, 24) over head_dim 128), plain RoPE, and the
    sinusoidal encoding at an offset (whisper's decode step)."""
    rng = np.random.default_rng(6)
    if case == "sinusoidal":
        for seq, off in ((5, 37), (1, 447), (12, 0)):
            _close(tlayers.sinusoidal_pos(seq, 128, "cpu", off).numpy(),
                   jlayers.sinusoidal_pos(seq, 128, off), 1e-5)
        return
    hd, secs = {"mrope": (32, (8, 4, 4)), "mrope_full": (128, (16, 24, 24)),
                "rope": (32, ())}[case]
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = (_mrope_positions(2, 9, seed=1) if secs else
           rng.integers(0, 300, (2, 9)).astype(np.int32))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, secs)
    got = tlayers.apply_rope(_t(x), _t(pos), 1e6, secs)
    _close(got.numpy(), want, 1e-5)
    if secs:      # distinct axes rotate otherwise than the temporal one
        plain = tlayers.apply_rope(_t(x), _t(pos[0]), 1e6)
        assert (got - plain).abs().max() > 1e-3


def test_cross_attention_through_kv_x_matches_reference():
    """``attention_block(kv_x=...)``: K/V from a second sequence, no RoPE,
    non-causal, as the reference's."""
    jm, jp, tm, tp = _pair(WHISPER)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, tm.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, tm.cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda t: t[0], jp["groups"]["sub_0"]["cross"])
    jctx = JContext(cfg=jm.cfg, planner=ShardingPlanner(SINGLE),
                    memory=JMemoryPlan(), mesh=None, mode="prefill")
    want, _ = jattn.attention_block(lp, jctx, jnp.asarray(x),
                                    jnp.zeros((2, 5), jnp.int32),
                                    causal=False, kv_x=jnp.asarray(enc))
    got, _ = tattn.attention_block(
        tree.map(lambda t: t[0], tp["groups"]["sub_0"]["cross"]),
        ModelContext(cfg=tm.cfg, mode="prefill"), _t(x), None, causal=False,
        kv_x=_t(enc))
    _close(got.numpy(), want, LOGIT_TOL)


def test_bf16_carry_over_keeps_norms_f32():
    """In a bfloat16 carry-over the norms stay float32 (the decoder's
    ``ln_x``, the encoder's ``final_norm`` and layer norms included), the
    frontend and encoder weights take the model dtype."""
    _, jp, _, _ = _pair(WHISPER)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu",
                         dtype=torch.bfloat16)
    for path in (("groups", "sub_0", "ln_x", "scale"),
                 ("encoder", "final_norm", "bias"),
                 ("encoder", "layers", "ln1", "scale")):
        t = tp
        for k in path:
            t = t[k]
        assert t.dtype == torch.float32, path
    assert tp["frontend"]["proj"].dtype == torch.bfloat16
    assert tp["encoder"]["layers"]["attn"]["wq"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (b) serving compute: prefill and decode
def test_whisper_prefill_then_decode_matches_reference():
    """``Model.prefill`` with frames, then 4 ``decode_step``s, each step's
    logits against the reference's.  Frames change nothing there (the
    zeroed ``ck`` / ``cv`` of the cache are read, in both packages)."""
    jm, jp, tm, tp = _pair(WHISPER)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, (2, 10)).astype(np.int32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    frames = rng.standard_normal((2, 8, 128)).astype(np.float32)
    batch = {"tokens": toks, "positions": pos, "frames": frames}
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        jc)
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, tc)
    _close(tl.numpy(), jl, LOGIT_TOL, "prefill")
    jl0, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "positions": jnp.asarray(pos)},
                        jm.init_cache(2, 16))
    np.testing.assert_array_equal(np.asarray(jl0), np.asarray(jl))
    for i in range(4):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        p = np.full((2, 1), 10 + i, np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(p), jc,
                                jnp.int32(10 + i))
        tl, tc = tm.decode_step(tp, _t(tok), _t(p), tc, 10 + i)
        _close(tl.numpy(), jl, LOGIT_TOL, f"decode {i}")


def test_whisper_decoder_over_encoder_states_matches_reference():
    """A cache without ``ck`` / ``cv``: the decoder cross-attends over the
    encoder's states (``encode`` of the frames, bare), as in training."""
    jm, jp, tm, tp = _pair(WHISPER)
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 512, (2, 7)).astype(np.int32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    frames = rng.standard_normal((2, 8, 128)).astype(np.float32)

    def no_cross(c):
        return {g: {k: v for k, v in sub.items() if k in ("k", "v")}
                for g, sub in c.items()}

    jctx = jm.ctx("prefill")
    jh, _ = jtfm.forward_serve(jp, jctx, jnp.asarray(toks), jnp.asarray(pos),
                               no_cross(jm.init_cache(2, 8)), jnp.int32(0),
                               frames=jnp.asarray(frames))
    th, _ = ttfm.forward_serve(tp, tm.ctx("prefill"), _t(toks), _t(pos),
                               no_cross(tm.init_cache(2, 8)), 0,
                               frames=_t(frames))
    _close(th.numpy(), jh, LOGIT_TOL)
    jh0, _ = jtfm.forward_serve(jp, jctx, jnp.asarray(toks), jnp.asarray(pos),
                                no_cross(jm.init_cache(2, 8)), jnp.int32(0),
                                frames=jnp.asarray(frames * 2))
    assert float(jnp.abs(jh0 - jh).max()) > 1e-3     # the audio is read


def test_qwen2vl_prefill_with_patches_distinct_axes_matches_reference():
    """Prefill with patches on distinct M-RoPE axes, then 3 decode steps
    on distinct (3, B, 1) positions."""
    jm, jp, tm, tp = _pair(QWEN)
    rng = np.random.default_rng(12)
    S = 14
    toks = rng.integers(0, 512, (2, S)).astype(np.int32)
    pos = _mrope_positions(2, S, seed=3)
    patches = rng.standard_normal((2, 8, 1176)).astype(np.float32)
    batch = {"tokens": toks, "positions": pos, "patches": patches}
    jc, tc = jm.init_cache(2, 24), tm.init_cache(2, 24)
    jl, jc = jm.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                        jc)
    tl, tc = tm.prefill(tp, {k: _t(v) for k, v in batch.items()}, tc)
    _close(tl.numpy(), jl, LOGIT_TOL, "prefill")
    for i in range(3):
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        p = _mrope_positions(2, 1, seed=20 + i, offset=S + i)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(p), jc,
                                jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, _t(tok), _t(p), tc, S + i)
        _close(tl.numpy(), jl, LOGIT_TOL, f"decode {i}")


# ---------------------------------------------------------------------------
# (c) training: loss, every gradient leaf, the tier's bytes
def _grad_scale(jg, path):
    """The magnitude a gradient leaf is held to: its own largest, or, for
    the key bias of a model without RoPE, whose gradient is 0 in exact
    arithmetic (softmax ignores a shift shared by every key) and rounding
    noise (~1e-10) on both sides, the largest of its attention block's
    gradient leaves."""
    w = jg
    for k in path:
        w = w[k]
    if path[-1] == "bk":
        block = jg
        for k in path[:-1]:
            block = block[k]
        return w, max(float(np.abs(v).max()) for v in block.values())
    return w, max(float(np.abs(w).max()), 1e-6)


@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_loss_fn_and_grads_match_reference(arch):
    """One step's loss and every gradient leaf (whisper's encoder and
    frontend included, qwen2-vl's patch frontend on distinct M-RoPE axes)
    through the port's wrapped layers (host tier); whisper's encoder
    states enter every decoder layer as stashed aux, whose gradient must
    reach the encoder."""
    jm, jp, tm, tp = _pair(arch)
    S = TRAIN_S if arch == WHISPER else QWEN_S
    batch = SyntheticLM(tm.cfg, batch=TRAIN_B, seq=S, seed=1).batch_at(0)
    if arch == QWEN:
        assert (batch["labels"][:, 8:-1] >= 0).all()
        batch["positions"] = _mrope_positions(TRAIN_B, S, seed=2)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.clone().requires_grad_(), tp)
    tm.runtime.reset_traffic()
    tl, _ = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    jg = jax.tree.map(np.asarray, jg)
    assert {p[0] for p in paths} >= ({"encoder", "frontend"} if arch ==
                                     WHISPER else {"frontend"})
    for g, path in zip(grads, paths):
        w, scale = _grad_scale(jg, path)
        if path[-1] != "bk" or arch == QWEN:
            assert np.abs(w).max() > 0, path
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg="/".join(path))
    rep = tm.runtime.traffic_report()
    cfg = tm.cfg
    x_bytes = TRAIN_B * S * cfg.d_model * 4
    if arch == QWEN:
        want = {"calls": cfg.num_layers, "raw_bytes": cfg.num_layers *
                x_bytes}
    else:
        enc_bytes = TRAIN_B * cfg.frontend_tokens * cfg.d_model * 4
        want = {"calls": cfg.encoder_layers + 2 * cfg.num_layers,
                "raw_bytes": (cfg.encoder_layers + cfg.num_layers) *
                enc_bytes + cfg.num_layers * x_bytes}
    for d in ("stash", "fetch"):
        assert {k: rep[d][k] for k in want} == want, d


def test_whisper_wrapped_layers_meter_the_reference_bytes():
    """The reference meters once per trace, the port once per call: one
    wrapped call (forward and backward) of an encoder layer and of a
    decoder layer (its encoder states stashed raw beside its fp8-coded
    input) meters the same stash and fetch bytes in both, under the host
    tier with the fp8 codec; the decoder layer's gradients, the encoder
    states' included, agree."""
    jm, jp, tm, tp = _pair(WHISPER)
    jcfg, tcfg = jm.cfg, tm.cfg
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, TRAIN_S, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(TRAIN_S, dtype=np.int32), (2, TRAIN_S))
    mem = dict(policy="host", compress="fp8")
    jrt = JRuntime(SINGLE, JMemoryPlan(**mem), mesh=None)
    jctx = JContext(cfg=jcfg, planner=ShardingPlanner(SINGLE),
                    memory=JMemoryPlan(**mem), mesh=None, mode="train",
                    runtime=jrt)
    trt = MemoryRuntime(SINGLE, MemoryPlan(**mem), device="cpu")
    tctx = ModelContext(cfg=tcfg, mode="train", runtime=trt)
    jdec = jax.tree.map(lambda t: t[0], jp["groups"]["sub_0"])
    tdec = tree.map(lambda t: t[0].clone().requires_grad_(),
                    tp["groups"]["sub_0"])
    jf = jrt.wrap_layer(functools.partial(jtfm._train_sublayer, jctx, "dec",
                                          False), name="dec_layer")

    @jax.jit
    def jdec_vjp(p, e):
        y, vjp = jax.vjp(lambda p, e: jf(p, jnp.asarray(x), jnp.asarray(pos),
                                         e)[0], p, e)
        return y, vjp(jnp.asarray(gy))

    jy, (jdp, jde) = jdec_vjp(jdec, jnp.asarray(enc))
    jenc = jrt.wrap_layer(functools.partial(jtfm._enc_layer, jctx),
                          name="enc_layer")
    jax.jit(lambda p, e: jax.vjp(lambda p, e: jenc(
        p, e, jnp.zeros((), jnp.int32)), p, e)[1](e))(
        jax.tree.map(lambda t: t[0], jp["encoder"]["layers"]),
        jnp.asarray(enc))
    tf = trt.wrap_layer(functools.partial(ttfm._train_sublayer, tctx,
                                          "dec"), name="dec_layer")
    te = _t(enc).requires_grad_()
    ty, _ = tf(tdec, _t(x).requires_grad_(), _t(pos), te)
    leaves, paths = tree.flatten(tdec)
    got = torch.autograd.grad(ty, [te, *leaves], _t(gy))
    tenc = trt.wrap_layer(functools.partial(ttfm._enc_layer, tctx),
                          name="enc_layer")
    e = _t(enc).requires_grad_()
    torch.autograd.grad(tenc(tree.map(lambda t: t[0], tp["encoder"]
                                      ["layers"]), e), e, _t(enc))
    _close(ty.detach().numpy(), jy, GRAD_TOL)
    scale = float(np.abs(np.asarray(jde)).max())
    _close(got[0].numpy() / scale, np.asarray(jde) / scale, GRAD_TOL, "enc")
    jdp = jax.tree.map(np.asarray, jdp)
    for g, path in zip(got[1:], paths):
        w, s = _grad_scale(jdp, path)
        _close(g.numpy() / s, w / s, GRAD_TOL, "/".join(path))
    jrep, trep = jrt.traffic_report(), trt.traffic_report()
    for d in ("stash", "fetch"):
        assert trep[d] == jrep[d], d
    assert trep["stash"]["calls"] == 3       # enc x; dec x and its aux


# ---------------------------------------------------------------------------
# (d) the serving engine
def _requests(n=5):
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 512, size=(m,)).astype(np.int32), 7)
            for i, m in enumerate((9, 20, 9, 20, 9)[:n])]


def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return [r.out_tokens for r in done], eng.traffic_report()


#: path -> engine kwargs shared by both packages: 2 slots, fair quantum 3
#: (sessions park their slot-shaped cross cache), pages of 8 in an
#: overcommitted pool of 8 frames
PATHS = {"monolithic": dict(),
         "paged_gather": dict(page_size=8, pages=8),
         "paged_kernel": dict(page_size=8, pages=8, decode_kernel=True)}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_engine_streams_match_reference(arch, path):
    """Greedy streams of 5 sessions over 2 slots under fair preemption,
    bit-identical to the reference's on the same path (qwen2-vl's kernel
    path against the reference's XLA twin of its kernel); whisper's
    kernel path, which the reference cannot run (C10), against the
    reference's paged gather streams.  Equal stash and fetch bytes;
    whisper parks its cross cache with every preempted slot."""
    jm, jp, tm, tp = _pair(arch, "none")
    base = dict(batch=2, max_len=48, spill="host")
    kw = dict(base, **PATHS[path])
    want_kw = dict(base, **PATHS["paged_gather"]) \
        if arch == WHISPER and path == "paged_kernel" else kw
    jops.set_paged_impl("xla")
    try:
        want, jrep = _streams(JEngine, JRequest, jm, jp, _requests(),
                              scheduler=JFair(quantum=3), **want_kw)
    finally:
        jops.set_paged_impl("pallas")
    got, rep = _streams(Engine, Request, tm, tp, _requests(),
                        scheduler=FairScheduler(quantum=3), **kw)
    assert got == want
    assert rep["kv_stash"] == jrep["kv_stash"]
    assert rep["kv_stash"]["wire_bytes"] == rep["kv_fetch"]["wire_bytes"]
    if path != "monolithic":
        assert rep["pages"]["evictions"] > 0
        assert rep["pages"] == jrep["pages"]
    if arch == WHISPER and path != "monolithic":
        cfg = tm.cfg
        cross = (2 * cfg.num_layers * cfg.frontend_tokens
                 * cfg.num_kv_heads * cfg.resolved_head_dim * 4)
        assert rep["slots"]["parks"] > 0
        assert rep["slots"]["park_bytes"] == rep["slots"]["parks"] * cross


def test_reference_kernel_path_cannot_run_whisper():
    """ROADMAP C10: the reference's ``"dec"`` layer calls
    ``attention_block`` without ``paged=``, so the in-place decode hands
    the page pool to the plain decode attention, which raises."""
    jm, jp, _, _ = _pair(WHISPER, "none")
    jops.set_paged_impl("xla")
    try:
        with pytest.raises(ValueError, match="Size of label"):
            _streams(JEngine, JRequest, jm, jp, _requests(1), batch=2,
                     max_len=48, page_size=8, decode_kernel=True)
    finally:
        jops.set_paged_impl("pallas")


@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_prefix_sharing_gate_turns_sharing_off(arch, caplog):
    """Prefix sharing grafts rows mid-sequence, which an encoder-decoder
    (cross cache, sinusoidal positions) and M-RoPE positions do not
    allow: both packages switch it off and say so, and serve the same
    streams unshared."""
    jm, jp, tm, tp = _pair(arch, "none")
    reqs = [(i, np.r_[np.arange(16), i + 20].astype(np.int32), 4)
            for i in range(3)]
    kw = dict(batch=2, max_len=48, page_size=8, prefix_share=True)
    with caplog.at_level(logging.WARNING):
        eng = Engine(tm, tp, **kw)
    assert not eng.cache.prefix_share
    assert "prefix sharing disabled" in caplog.text
    assert not JEngine(jm, jp, **kw).cache.prefix_share
    got, rep = _streams(Engine, Request, tm, tp, reqs, **kw)
    want, _ = _streams(JEngine, JRequest, jm, jp, reqs, **kw)
    assert got == want
    assert rep["prefix"]["hits"] == 0


# ---------------------------------------------------------------------------
# (e) data and the CLIs
@pytest.mark.parametrize("arch,t", [(WHISPER, 0), (QWEN, 3)])
def test_synthetic_frames_and_patches_byte_identical(arch, t):
    """Frames (whisper) or patches and their masked labels (qwen2-vl),
    drawn from the step's generator in the reference's order."""
    want = JSyntheticLM(JARCHS[arch].reduced(), batch=3, seq=24,
                        seed=5).batch_at(t)
    got = SyntheticLM(TARCHS[arch].reduced(), batch=3, seq=24,
                      seed=5).batch_at(t)
    assert sorted(got) == sorted(want)
    assert "frames" in got if arch == WHISPER else "patches" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k
    dev = to_device(got, "cpu")
    assert all(dev[k].dtype == (torch.float32 if got[k].dtype == np.float32
                                else torch.int64) for k in got)


def test_memmap_tokens_byte_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 512, 1000).astype(np.int32) \
        .tofile(path)
    want = JMemmapTokens(str(path), JARCHS[QWEN].reduced(), batch=3, seq=40,
                         seed=2)
    got = MemmapTokens(str(path), TARCHS[QWEN].reduced(), batch=3, seq=40,
                       seed=2)
    for t in (0, 1, 7):
        w, g = want.batch_at(t), got.batch_at(t)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == \
                w[k].tobytes(), (t, k)
    assert next(iter(got))[1]["tokens"].tobytes() == \
        want.batch_at(0)["tokens"].tobytes()


def _cli(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_serve_cli_smoke(arch):
    """The kernel path's CLI: an overcommitted pool with int8 spill, fair
    preemption; whisper parks its cross cache."""
    proc = _cli("repro_torch.launch.serve", "--arch", arch, "--smoke",
                "--device", "cpu", "--batch", "2", "--max-len", "64",
                "--page-size", "8", "--pages", "8", "--decode-kernel",
                "--requests", "4", "--prompt-len", "12,20",
                "--new-tokens", "6", "--scheduler", "fair", "--quantum",
                "2", "--spill", "host", "--page-codec", "int8")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert f"{arch}-smoke 2L" in out and "served 4 requests, 24 tokens" in out
    assert ("slots parked" in out) == (arch == WHISPER), out[-2000:]
    assert "kernel launches:" in out


@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_train_cli_smoke(arch, tmp_path):
    """Host tier, fp8 stash: finite losses; whisper stashes its 2 encoder
    and 2 decoder layers (and each decoder layer's encoder states, raw),
    qwen2-vl its 2 layers."""
    proc = _cli("repro_torch.launch.train", "--arch", arch, "--smoke",
                "--device", "cpu", "--steps", "2", "--seq", "24",
                "--policy", "host", "--compress", "fp8", "--log-every", "1",
                "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if " loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), out[-2000:]
    subs = 4 if arch == WHISPER else 2
    assert f"2 of 2 layer groups stashed ({subs} sub-layers)" in out
    line = next(x for x in out.splitlines() if "memory traffic:" in x)
    calls = 2 * (6 if arch == WHISPER else 2)
    assert f"/{calls}x of" in line, line
