"""The three dense decoders no other port test runs, against the JAX
reference on the CPU: h2o-danube-1.8b (sliding window, GQA), starcoder2-7b
(qkv bias, LayerNorm, tanh-gelu) and command-r-35b (LayerNorm, parallel
block, tied embeddings).

Each runs ``.reduced(dtype="float32")`` with weights from the reference's
``Model.init(PRNGKey(0))`` carried over through numpy.  The reference
initialises the qkv biases and the norms' biases to 0 and the norms'
scales to 1, which would leave those code paths unchecked, so the same
seeded noise is added to them on both sides.  Three checks per model:
prefill logits, greedy paged streams (the in-place kernel path and the
gather path) and the loss with every gradient leaf.
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
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.models.model import build_model as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Engine, Request

ARCHS = ["h2o-danube-1.8b", "starcoder2-7b", "command-r-35b"]
SINGLE = MeshPlan((1,), ("data",))
# float32 on both sides, products summed in different orders
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5
#: the leaves the reference initialises to constants
NOISY = ("bq", "bk", "bv", "scale", "bias")


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


def test_code_paths(pair):
    """Each model reaches the path it is here for."""
    _, _, tm, tp = pair
    cfg, sub = tm.cfg, tp["groups"]["sub_0"]
    if cfg.name.startswith("h2o-danube"):
        assert cfg.attention == "swa" and cfg.window == 64
        assert cfg.num_heads > cfg.num_kv_heads
    elif cfg.name.startswith("starcoder2"):
        assert "bq" in sub["attn"] and cfg.act == "gelu"
        assert "bias" in sub["ln1"] and "ln2" in sub
    else:
        assert cfg.tie_embeddings and "unembed" not in tp
        assert cfg.parallel_block and "ln2" not in sub
        assert "bias" in sub["ln1"]


def test_prefill_logits_match(pair):
    """Two prompts of 80 tokens: past danube's 64-row window."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(2, 80)).astype(np.int32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                            "positions": jnp.asarray(pos)},
                       jm.init_cache(2, 96))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "positions": torch.from_numpy(pos.copy()).long()},
                       tm.init_cache(2, 96))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    return [r.out_tokens for r in sorted(eng.run(), key=lambda r: r.uid)]


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_paged_streams_match_reference(pair, decode_kernel):
    """Three concurrent sessions at mixed lengths, 70 to 77 rows so the
    window masks in danube's decode; the reference's in-place path runs
    the XLA twin of its Pallas kernel."""
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
    """The loss and every gradient leaf, relative to each leaf's largest
    magnitude, through the port's wrapped layers (host tier)."""
    jm, jp, tm, tp = pair
    batch = SyntheticLM(tm.cfg, batch=4, seq=32, seed=1).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.clone().requires_grad_(), tp)
    tl, _ = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    grads = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    jg = jax.tree.map(np.asarray, jg)
    for g, path in zip(grads, paths):
        w = jg
        for k in path:
            w = w[k]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg="/".join(path))
