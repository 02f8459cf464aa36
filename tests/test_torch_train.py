"""The training slice of the port against the JAX reference, on the CPU.

Weights come from the reference's initialisers on
``smollm_135m.reduced(dtype="float32")`` and are carried over with
``repro_torch.convert.params_from_jax``; inputs come from numpy seeds.  The
reference's Pallas codec kernels run in interpret mode, as its own tests
run them on the CPU.  The reference runs on ``mesh=None``: its model then
calls every layer bare (``ModelContext.wrap``), while the port wraps
whenever the tier offloads, so stash/fetch parity is held at the
``wrap_layer`` level with the reference's runtime on ``mesh=None``.
"""
import dataclasses
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
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.runtime import MemoryRuntime as JRuntime
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import offload_pack as jpack
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.models.layers import ModelContext as JContext
from repro.models.model import build_model as jbuild
from repro.parallel.sharding import ShardingPlanner
from repro.train.loop import make_train_step as jmake_train_step
from repro.train.train_state import init_state as jinit_state
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig, TrainConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import ModelContext
from repro_torch.models.model import build_model
from repro_torch.train.loop import make_train_step
from repro_torch.train.train_state import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SINGLE = JMeshPlan((1,), ("data",))
# float32 on both sides, products summed in different orders: the loss and
# the gradients of a 2-layer stack agree to a few f32 ulps of their scale
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5


def _cfgs():
    return (JARCHS["smollm-135m"].reduced(dtype="float32"),
            TARCHS["smollm-135m"].reduced(dtype="float32"))


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


@functools.lru_cache(maxsize=None)
def _layer_params():
    """One dense sub-layer's reference parameters (layer 0 of the reduced
    model), initialised once."""
    return jax.tree.map(lambda l: l[0], jtfm.init_params(
        jax.random.PRNGKey(0), _cfgs()[0], jnp.float32)["groups"]["sub_0"])


def _assert_tree_close(got, want, tol, what):
    """Every leaf of the port's tree against the reference's (a nested dict
    of numpy arrays), relative to each leaf's largest magnitude."""
    leaves, paths = tree.flatten(got)
    for leaf, path in zip(leaves, paths):
        w = want
        for k in path:
            w = w[k]
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(leaf.detach().float().numpy() / scale,
                                   w / scale, rtol=0, atol=tol,
                                   err_msg=f"{what} {'/'.join(path)}")


# ---------------------------------------------------------------------------
# (a) the synthetic stream is byte-identical
@pytest.mark.parametrize("arch,t,frontend", [
    ("smollm-135m", 0, "none"), ("smollm-135m", 7, "none"),
    ("h2o-danube-1.8b", 3, "none"), ("qwen2-vl-2b", 2, "none"),
    ("qwen2-vl-2b", 2, "vision_stub")])
def test_synthetic_batches_byte_identical(arch, t, frontend):
    # with its frontend, qwen2-vl's batch carries patches drawn after the
    # tokens and masks the labels of the patch positions
    jcfg = JARCHS[arch].reduced(frontend=frontend)
    tcfg = TARCHS[arch].reduced(frontend=frontend)
    want = JSyntheticLM(jcfg, batch=3, seq=40, seed=5).batch_at(t)
    got = SyntheticLM(tcfg, batch=3, seq=40, seed=5).batch_at(t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# (b) the plain codec twins against the reference's twins and kernels
CODECS = {"fp8": (jpack.fp8_pack, jref.fp8_pack_ref, tref.fp8_pack_ref,
                  448.0),
          "blocksparse": (jpack.blocksparse_pack, jref.blocksparse_pack_ref,
                          tref.blocksparse_pack_ref, 127.0)}


def _codec_input(rows, kind, dtype):
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 64)) * 3.0).astype(np.float32)
    if kind == "zeros":
        x[:] = 0.0
    elif kind == "ties":
        # absmax 448 (fp8 scale 1.0), fp8 rounding ties, e4m3 subnormals
        # and their ties, values below the blocksparse threshold
        x[:, 0] = 448.0
        x[0, 1:9] = [1.0625, -3.375, 2.0 ** -9, 1.5 * 2.0 ** -9,
                     -2.5 * 2.0 ** -9, 2.0 ** -10, 13.0, 14.0]
        x[rows // 2:] *= 1e-3
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def _codes(q):
    """A payload's values as float32 numpy (fp8 and int8 alike)."""
    return (q.float().numpy() if isinstance(q, torch.Tensor)
            else np.asarray(q, np.float32))


@pytest.mark.parametrize("codec", sorted(CODECS))
@pytest.mark.parametrize("rows,block_rows,kind,dtype", [
    (256, 256, "normal", "float32"),      # whole tensor as one block
    (384, 128, "normal", "bfloat16"),     # 128-row blocks
    (256, 128, "ties", "float32"),
    (256, 256, "ties", "bfloat16"),
    (128, 128, "zeros", "float32"),       # the scale clamps
])
def test_codec_plain_twins_bit_exact(codec, rows, block_rows, kind, dtype):
    """Bit-exact against the reference's plain twins (evaluated op by op,
    as its serving spill and its eager stash run them) and, with the same
    inputs, the shared unpack against the Pallas unpack.  Against the
    Pallas packs in interpret mode, which run under jit: XLA rewrites the
    scale's ``absmax / 448`` (``/ 127``) as ``absmax * f32(1/448)``, so
    their scale is that product, one ulp off the IEEE quotient for about
    half of all fp8 blocks; the payload is bit-exact wherever the two
    scales agree and within one code where they do not."""
    jkern, jplain, tplain, qmax = CODECS[codec]
    xj, xt = _codec_input(rows, kind, dtype)
    qt, st = tplain(xt, block_rows)
    assert qt.dtype == (torch.float8_e4m3fn if codec == "fp8"
                        else torch.int8)
    qr, sr = jplain(xj, block_rows)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qr).view(np.uint8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sr))
    for out in ("float32", "bfloat16"):
        yj = jpack.fp8_unpack(jnp.asarray(np.asarray(qr)), sr,
                              block_rows=block_rows, dtype=jnp.dtype(out),
                              interpret=True)
        yt = tref.fp8_unpack_ref(qt, st, block_rows, getattr(torch, out))
        np.testing.assert_array_equal(yt.float().numpy(),
                                      np.asarray(yj, np.float32))

    qj, sj = jkern(xj, block_rows=block_rows, interpret=True)
    absmax = np.abs(np.asarray(xj, np.float32)).reshape(
        -1, block_rows * 64).max(axis=1)
    floor = np.float32(1e-12 if codec == "fp8" else 1e-30)
    np.testing.assert_array_equal(
        np.asarray(sj), np.maximum(absmax * np.float32(1 / qmax), floor))
    np.testing.assert_array_equal(
        st.numpy(), np.maximum(absmax / np.float32(qmax), floor))
    same = np.repeat(st.numpy() == np.asarray(sj), block_rows)
    got, want = _codes(qt), _codes(qj)
    np.testing.assert_array_equal(got[same], want[same])
    step = (np.maximum(np.abs(want), 2.0 ** -6) * 2.0 ** -3
            if codec == "fp8" else 1.0)
    assert (np.abs(got - want) <= step)[~same].all()


# ---------------------------------------------------------------------------
# (d) wrap_layer: gradients and per-call bytes against the reference's
POLICIES = ("none", "host", "mcdla", "spill")


@pytest.mark.parametrize("codec", ["none", "fp8", "int8", "blocksparse"])
@pytest.mark.parametrize("policy", POLICIES)
def test_wrap_layer_matches_reference(policy, codec):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    jp = _layer_params()

    jmem = JMemoryPlan(policy=policy, compress=codec)
    jrt = JRuntime(SINGLE, jmem, mesh=None)
    jctx = JContext(cfg=jcfg, planner=ShardingPlanner(SINGLE), memory=jmem,
                    mesh=None, mode="train", runtime=jrt)
    jf = jrt.wrap_layer(functools.partial(jtfm._train_sublayer, jctx,
                                          "dense", True), name="dense_layer")
    jy, jvjp = jax.vjp(lambda p, x: jf(p, x, jnp.asarray(pos))[0], jp,
                       jnp.asarray(x))
    jdp, jdx = jvjp(jnp.asarray(gy))

    trt = MemoryRuntime(SINGLE, MemoryPlan(policy=policy, compress=codec),
                        device="cpu")
    tctx = ModelContext(cfg=tcfg, mode="train", runtime=trt)
    tf = trt.wrap_layer(functools.partial(ttfm._train_sublayer, tctx,
                                          "dense"), name="dense_layer")
    tp = tree.map(lambda t: t.requires_grad_(), params_from_jax(_np(jp),
                                                                "cpu"))
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = tf(tp, tx, torch.from_numpy(pos).long())
    leaves, paths = tree.flatten(tp)
    got = torch.autograd.grad(ty, [tx, *leaves], torch.from_numpy(gy))

    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    _assert_tree_close({"x": got[0]}, {"x": np.asarray(jdx)}, GRAD_TOL,
                       "dx")
    _assert_tree_close(tree.unflatten(paths, list(got[1:])), _np(jdp),
                       GRAD_TOL, "dparams")
    # the reference meters once per trace, the port once per call: one
    # wrapped call each here, so the per-call bytes compare directly
    jrep, trep = jrt.traffic_report(), trt.traffic_report()
    for d in ("stash", "fetch"):
        assert (d in trep) == (d in jrep) == (policy != "none"), d
        if d in jrep:
            assert trep[d] == jrep[d], d
    assert trep["tier"] == jrep["tier"]


def test_wrap_layer_saves_no_input_and_discards_spill_budget():
    """The forward keeps the payload, not x; the backward returns the
    spill leg's budget, so a training loop does not fill the pool."""
    _, tcfg = _cfgs()
    rt = MemoryRuntime(SINGLE, MemoryPlan(policy="spill", compress="fp8"),
                       device="cpu")
    ctx = ModelContext(cfg=tcfg, mode="train", runtime=rt)
    f = rt.wrap_layer(functools.partial(ttfm._train_sublayer, ctx, "dense"))
    gen = torch.Generator().manual_seed(0)
    p = tree.map(lambda t: t[0].requires_grad_(),
                 ttfm.init_params(gen, tcfg, torch.float32,
                                  "cpu")["groups"]["sub_0"])
    x = torch.randn((2, 8, tcfg.d_model), requires_grad=True)
    pos = torch.arange(8).expand(2, 8)
    spill = rt.tier.inner
    y, _ = f(p, x, pos)
    assert spill.primary_headroom() < spill.primary_budget
    y.sum().backward()
    assert spill.primary_headroom() == spill.primary_budget
    with torch.no_grad():                 # primal path: nothing stashed
        f(p, x, pos)
    assert rt.traffic_report()["stash"]["calls"] == 1


# ---------------------------------------------------------------------------
# (e) Model.loss_fn: loss and every gradient leaf
def _models(policy="host", codec="none", opt_bits=32, accum=1, seq=32):
    jcfg, tcfg = _cfgs()
    shape = JShapeConfig("train", seq, 4, "train")
    jtc = JTrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-3,
                       grad_accum=accum)
    jm = jbuild(JRunConfig(model=jcfg, shape=shape, mesh=SINGLE,
                           memory=JMemoryPlan(policy=policy, compress=codec,
                                              opt_state_bits=opt_bits),
                           train=jtc))
    ttc = TrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-3,
                      grad_accum=accum)
    tm = build_model(RunConfig(model=tcfg,
                               shape=ShapeConfig("train", seq, 4, "train"),
                               memory=MemoryPlan(policy=policy,
                                                 compress=codec,
                                                 opt_state_bits=opt_bits),
                               train=ttc), device="cpu")
    return jm, jtc, tm, ttc


def test_loss_fn_and_grads_match_reference():
    jm, _, tm, _ = _models()
    assert tm.runtime.offloads
    jp = jm.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(tm.cfg, batch=4, seq=32, seed=1).batch_at(0)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = tree.map(lambda t: t.requires_grad_(), params_from_jax(_np(jp),
                                                                "cpu"))
    tl, tmet = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    assert float(tmet["tokens"]) == float(jmet["tokens"])
    _assert_tree_close(tree.unflatten(paths, list(tg)), _np(jg), GRAD_TOL,
                       "grad")
    rep = tm.runtime.traffic_report()       # one stash + fetch per layer
    assert rep["stash"]["calls"] == rep["fetch"]["calls"] == 2


# ---------------------------------------------------------------------------
# (f) a 3-step loss curve and the final parameters
@pytest.mark.parametrize("opt_bits,accum", [(32, 1), (8, 1), (32, 2)])
def test_train_steps_match_reference(opt_bits, accum):
    jm, jtc, tm, ttc = _models(opt_bits=opt_bits, accum=accum)
    jstate = jinit_state(jm, jtc)
    tstate = init_state(tm, ttc, params=params_from_jax(
        _np(jstate["params"]), "cpu"))
    jstep = jax.jit(jmake_train_step(jm, jtc))
    tstep = make_train_step(tm, ttc)
    src = SyntheticLM(tm.cfg, batch=4, seq=32, seed=2)
    for t in range(3):
        batch = src.batch_at(t)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tstate, tmet = tstep(tstate, to_device(batch, "cpu"))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) < LOSS_TOL, t
        assert float(tmet["tokens"]) == float(jmet["tokens"])
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= \
            1e-7 * float(jmet["lr"])
    # Adam divides each entry by its own running magnitude: an entry whose
    # gradient sits at f32 rounding level (1e-9 where the leaf's largest is
    # 1e-2) takes an update of O(eps-damped lr) whose sign is rounding
    # noise in both frameworks.  So: the bulk agrees to GRAD_TOL of each
    # leaf's scale, and no entry differs by more than a fraction of lr.
    leaves, paths = tree.flatten(tstate["params"])
    for leaf, path in zip(leaves, paths):
        w = _np(jstate["params"])
        for k in path:
            w = w[k]
        d = np.abs(leaf.detach().numpy() - np.asarray(w))
        scale = float(np.abs(np.asarray(w)).max())
        assert d.max() <= ttc.learning_rate / 4, path
        assert (d > GRAD_TOL * scale).mean() < 0.01, path
    assert int(tstate["opt"]["count"]) == int(jstate["opt"]["count"]) == 3


# ---------------------------------------------------------------------------
# (g) the CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_train_cli_smoke(tmp_path):
    proc = _cli("--arch", "smollm", "--smoke", "--device", "cpu", "--steps",
                "5", "--policy", "host", "--compress", "fp8",
                "--log-every", "1", "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 5 loss=" in proc.stdout
    assert "memory traffic: tier=host+fp8" in proc.stdout
    assert "2 of 2 layer groups stashed" in proc.stdout


def test_train_cli_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--arch", "smollm", "--smoke", "--steps", "1",
                "--ckpt-dir", str(tmp_path))
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_unported_options_raise():
    _, tcfg = _cfgs()
    with pytest.raises(KeyError, match="slice 5"):
        MemoryRuntime(SINGLE, MemoryPlan(policy="auto"), device="cpu")
    tm = build_model(RunConfig(model=tcfg,
                               shape=ShapeConfig("t", 8, 1, "train"),
                               memory=MemoryPlan(policy="none")),
                     device="cpu")
    assert not tm.runtime.offloads
    with pytest.raises(NotImplementedError, match="slice 4"):
        init_state(tm, TrainConfig(grad_compress="int8"))


@pytest.mark.parametrize("policy", ["none", "host"])
def test_softcap_training_attention_raises(policy):
    """The flash kernel has no softcap, so training a softcapped model
    raises instead of taking a second attention path."""
    _, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, logit_softcap=30.0)
    tm = build_model(RunConfig(model=tcfg,
                               shape=ShapeConfig("t", 8, 1, "train"),
                               memory=MemoryPlan(policy=policy)),
                     device="cpu")
    params = tree.map(lambda t: t.requires_grad_(), tm.init(0))
    batch = to_device(SyntheticLM(tcfg, batch=1, seq=8, seed=0).batch_at(0),
                      "cpu")
    with pytest.raises(NotImplementedError, match="softcap"):
        tm.loss_fn(params, batch)
