"""The MoE family against the JAX reference on the CPU: mixtral-8x7b (every
layer MoE, 8 experts top-2 in full, 4 here; sliding window) and
llama4-maverick-400b (a ("dense", "moe") group, 128 experts top-1 in full,
4 here, one shared expert).

Each runs ``.reduced(dtype="float32")`` with weights from the reference's
``Model.init(PRNGKey(0))`` carried over through numpy, with seeded noise on
the norms (the reference initialises them to 1).  Checks: the MoE block's
routing (which expert, which tokens dropped at capacity) exactly, its
output and aux loss; the reference's own MoE scenarios
(``tests/test_ssm_moe.py``) replayed against the port; prefill logits
with tokens dropped at capacity; greedy paged streams on the in-place
kernel path and on the gather path; the loss with every gradient leaf,
the router's included; the router kept float32 under a bf16 carry-over;
and both entry points on the reduced twins.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models.layers import ModelContext as JContext
from repro.models.model import build_model as jbuild
from repro.parallel.sharding import ShardingPlanner
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import ModelContext
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, Request

ARCHS = ["mixtral-8x7b", "llama4-maverick-400b"]
SINGLE = MeshPlan((1,), ("data",))
# float32 on both sides, products summed in different orders
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
# the softmax of the router logits rounds otherwise in XLA and in torch
COMBINE_TOL = 1e-6
#: the leaves the reference initialises to constants
NOISY = ("scale", "bias")


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg = JARCHS[arch].reduced(dtype="float32")
    jm = jbuild(JRunConfig(model=cfg,
                           shape=JShapeConfig("train", 32, 4, "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy="host")))
    params = _noisy(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(RunConfig(model=TARCHS[arch].reduced(dtype="float32"),
                               shape=ShapeConfig("train", 32, 4, "train"),
                               memory=MemoryPlan(policy="host")),
                     device="cpu")
    return (jm, jax.tree.map(jnp.asarray, params), tm,
            params_from_jax(params, "cpu"))


def _moe_sub(tm):
    """The MoE sub-layer's group key (mixtral: sub_0; llama4: sub_1)."""
    return "sub_1" if tm.cfg.moe_every == 2 else "sub_0"


def _jctx(cfg):
    return JContext(cfg=cfg, planner=ShardingPlanner(SINGLE),
                    memory=JMemoryPlan(), mesh=None)


def _dropped(gather_idx: np.ndarray, T: int, k: int) -> int:
    """Assignments that found no slot: T*k less the slots filled."""
    return T * k - int((gather_idx < T).sum())


def test_code_paths(pair):
    """Each model reaches the path it is here for."""
    _, _, tm, tp = pair
    cfg = tm.cfg
    moe = tp["groups"][_moe_sub(tm)]["moe"]
    assert moe["router"].shape[-1] == cfg.num_experts == 4
    if cfg.name.startswith("mixtral"):
        assert cfg.top_k == 2 and cfg.attention == "swa"
        assert list(tp["groups"]) == ["sub_0"]
        assert "shared_w1" not in moe
    else:
        assert cfg.top_k == 1 and cfg.shared_experts == 1
        assert list(tp["groups"]) == ["sub_0", "sub_1"]
        assert "mlp" in tp["groups"]["sub_0"] and "shared_w1" in moe


@pytest.mark.parametrize("S,factor", [(40, None), (40, 0.5)])
def test_moe_block_matches_reference(pair, S, factor):
    """The MoE block of layer 0 on the same (2, S, D) input: the routing
    (``gather_idx``: which expert takes which token, the dropped ones
    gathering the zero row T) exactly, the combine weights on the same
    slots, the output and the aux loss; at the model's capacity factor
    and at 0.5, where tokens must drop."""
    _, jp, tm, tp = pair
    sub = _moe_sub(tm)
    jcfg = JARCHS[tm.cfg.name[:-len("-smoke")]].reduced(dtype="float32")
    tcfg = tm.cfg
    if factor is not None:
        jcfg = JModelConfig(**{**jcfg.__dict__, "capacity_factor": factor})
        tcfg = ModelConfig(**{**tcfg.__dict__, "capacity_factor": factor})
    jw = jax.tree.map(lambda t: t[0], jp["groups"][sub]["moe"])
    tw = tree.map(lambda t: t[0], tp["groups"][sub]["moe"])
    x = np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32)
    T, k, E = 2 * S, tcfg.top_k, tcfg.num_experts
    cap = tmoe.capacity(tcfg, T)
    gi, cw, probs = tmoe.route(torch.from_numpy(x.reshape(T, -1)),
                               tw["router"], k, cap, E)
    jgi, jcw, jprobs = jmoe._route(jnp.asarray(x.reshape(T, -1)),
                                   jw["router"], k, cap, E)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    np.testing.assert_array_equal(cw.numpy() > 0, np.asarray(jcw) > 0)
    np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), rtol=0,
                               atol=COMBINE_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=COMBINE_TOL)
    if factor is not None:
        assert _dropped(gi.numpy(), T, k) > 0
    out, aux = tmoe.moe_block(tw, ModelContext(cfg=tcfg),
                              torch.from_numpy(x))
    jout, jaux = jmoe.moe_block(jw, _jctx(jcfg), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=BLOCK_TOL)
    assert abs(float(aux) - float(jaux)) < BLOCK_TOL


# ---------------------------------------------------------------------------
# the reference's scenarios (tests/test_ssm_moe.py), replayed on the port
def _scenario(capacity_factor, top_k, shared, seed_scale):
    kw = dict(name="t", family="moe", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=128, num_experts=4,
              top_k=top_k, shared_experts=shared,
              capacity_factor=capacity_factor)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jw = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, 32)) * seed_scale
    return jcfg, tcfg, jw, params_from_jax(jax.tree.map(np.asarray, jw),
                                           "cpu"), x, torch.tensor(
                                               np.asarray(x))


def _dense_moe_loop(cfg, p, x):
    """Every expert on every token, weighted by the normalised top-k
    probabilities (no capacity): what the block computes when nothing
    drops."""
    x2d = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(x2d @ p["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.top_k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x2d)
    for e in range(cfg.num_experts):
        h = torch.nn.functional.silu(x2d @ p["w1"][e]) * (x2d @ p["w3"][e])
        w_e = torch.where(top_i == e, top_p, 0.0).sum(-1)
        out = out + (h @ p["w2"][e]) * w_e[:, None]
    if cfg.shared_experts:
        h = torch.nn.functional.silu(x2d @ p["shared_w1"]) * \
            (x2d @ p["shared_w3"])
        out = out + h @ p["shared_w2"]
    return out.reshape(x.shape)


def test_moe_local_equals_dense_loop():
    """``test_moe_local_equals_dense_loop``: with capacity to spare the
    block equals the dense loop over every expert, on the port as in the
    reference, and the aux loss sits near E * 1/E * 1 = 1."""
    jcfg, tcfg, jw, tw, x, xt = _scenario(2.0, 2, 1, 0.5)
    out, aux = tmoe.moe_block(tw, ModelContext(cfg=tcfg), xt)
    ref = _dense_moe_loop(tcfg, tw, xt)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert 0.5 < float(aux) < 4.0
    jout, jaux = jmoe.moe_block(jw, _jctx(jcfg), x)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=BLOCK_TOL)
    assert abs(float(aux) - float(jaux)) < BLOCK_TOL


def test_moe_capacity_drops_overflow():
    """``test_moe_capacity_drops_overflow``: at capacity factor 0.25 tokens
    drop, the output stays finite and its norm falls below the output at
    factor 4; equal to the reference's at both."""
    jcfg, tcfg, jw, tw, x, xt = _scenario(0.25, 1, 0, 1.0)
    out, _ = tmoe.moe_block(tw, ModelContext(cfg=tcfg), xt)
    assert bool(torch.isfinite(out).all())
    full = ModelConfig(**{**tcfg.__dict__, "capacity_factor": 4.0})
    out_full, _ = tmoe.moe_block(tw, ModelContext(cfg=full), xt)
    assert float(out.norm()) < float(out_full.norm())
    for t_out, c in ((out, jcfg),
                     (out_full, JModelConfig(**{**jcfg.__dict__,
                                                "capacity_factor": 4.0}))):
        jout, _ = jmoe.moe_block(jw, _jctx(c), x)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(jout), rtol=0,
                                   atol=BLOCK_TOL)


# ---------------------------------------------------------------------------
def test_prefill_logits_match_with_drops(pair, monkeypatch):
    """Two prompts of 80 tokens (past mixtral's 64-row window): the MoE
    blocks drop tokens at capacity, and the logits still match."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(2, 80)).astype(np.int32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    dropped = []
    route = tmoe.route

    def spy(x2d, router, top_k, cap, num_experts):
        out = route(x2d, router, top_k, cap, num_experts)
        dropped.append(_dropped(out[0].numpy(), x2d.shape[0], top_k))
        return out

    monkeypatch.setattr(tmoe, "route", spy)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                            "positions": jnp.asarray(pos)},
                       jm.init_cache(2, 96))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "positions": torch.from_numpy(pos.copy()).long()},
                       tm.init_cache(2, 96))
    assert len(dropped) == tm.cfg.num_layers // tm.cfg.moe_every
    assert sum(dropped) > 0, dropped
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    return [r.out_tokens for r in sorted(eng.run(), key=lambda r: r.uid)]


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_paged_streams_match_reference(pair, decode_kernel):
    """Three concurrent sessions of 66 to 70 prompt rows over 2 slots (the
    window masks in mixtral's decode; every decode call routes both slots,
    the idle one's dummy row included, as in the reference); the
    reference's in-place path runs the XLA twin of its Pallas kernel."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    reqs = [(i, rng.integers(0, 512, size=(66 + 2 * i,)).astype(np.int32),
             6 + i) for i in range(3)]
    kw = dict(batch=2, max_len=96, page_size=16,
              decode_kernel=decode_kernel)
    jops.set_paged_impl("xla" if decode_kernel else "pallas")
    try:
        want = _streams(JEngine, JRequest, jm, jp, reqs, **kw)
    finally:
        jops.set_paged_impl("pallas")
    assert _streams(Engine, Request, tm, tp, reqs, **kw) == want


def test_loss_fn_and_grads_match_reference(pair):
    """The loss, the aux loss and every gradient leaf (the router's
    included), relative to each leaf's largest magnitude, through the
    port's wrapped layers (host tier)."""
    jm, jp, tm, tp = pair
    batch = SyntheticLM(tm.cfg, batch=4, seq=32, seed=1).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.clone().requires_grad_(), tp)
    tl, met = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    aux = met["aux_loss"].item()
    assert aux > 0 and abs(aux - float(jmet["aux_loss"])) < LOSS_TOL
    jg = jax.tree.map(np.asarray, jg)
    assert any("router" in p for p in paths)
    for g, path in zip(grads, paths):
        w = jg
        for k in path:
            w = w[k]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg="/".join(path))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_carry_over_keeps_router_f32(arch):
    """Under a bf16 cast the router stays float32 and bit-equal to the
    reference's (``moe_init`` makes it float32 in a bf16 model), the
    experts go bf16; the port's own init keeps the same dtypes."""
    cfg = JARCHS[arch].reduced(dtype="bfloat16")
    jp = jbuild(JRunConfig(model=cfg, shape=JShapeConfig("t", 8, 1, "train"),
                           mesh=SINGLE, memory=JMemoryPlan(policy="none"))
                ).init(jax.random.PRNGKey(0))
    want = jax.tree.map(np.asarray, jp)
    tp = params_from_jax(want, "cpu", dtype=torch.bfloat16)
    sub = "sub_1" if cfg.moe_every == 2 else "sub_0"
    own = build_model(RunConfig(model=TARCHS[arch].reduced(),
                                shape=ShapeConfig("t", 8, 1, "train"),
                                memory=MemoryPlan(policy="none")),
                      device="cpu").init(0)
    for p in (tp, own):
        moe = p["groups"][sub]["moe"]
        assert moe["router"].dtype == torch.float32
        for k in moe:
            if k != "router":
                assert moe[k].dtype == torch.bfloat16, k
    w = want["groups"][sub]["moe"]["router"]
    assert w.dtype == np.float32
    np.testing.assert_array_equal(tp["groups"][sub]["moe"]["router"].numpy(),
                                  w)


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_on_the_reduced_twin(arch, tmp_path):
    """Both CLIs on the CPU: the paged in-place decode with int8 spill
    under fair preemption, and three wrapped training steps through the
    fp8 stash with a finite, positive aux loss."""
    eng = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--max-len", "64", "--page-size",
                          "8", "--pages", "6", "--decode-kernel",
                          "--requests", "4", "--prompt-len", "24,32",
                          "--new-tokens", "6", "--scheduler", "fair",
                          "--quantum", "2", "--spill", "host",
                          "--page-codec", "int8"])
    assert [len(s.result()) for s in eng.sessions] == [6] * 4
    report = eng.traffic_report()
    assert report["pages"]["evictions"] > 0
    assert report["decode_io"]["compressed_adopts"] > 0
    out = train_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--steps", "3", "--policy", "host", "--compress",
                          "fp8", "--log-every", "1", "--ckpt-dir",
                          str(tmp_path)])
    hist = out["history"]
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) and h["aux_loss"] > 0 for h in hist)
