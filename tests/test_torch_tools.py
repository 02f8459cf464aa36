"""The port's tools against the JAX reference, on the CPU: the offload /
vDNN shims, the roofline, the dry-run, the wire probe and the hill climb.

* Shims: a reduced smollm layer through ``offload_layer`` /
  ``maybe_offload`` (none, host, host + fp8) against the reference's
  ``offload_layer`` on ``mesh=None``; ``stash`` -> ``fetch``;
  ``stash_fraction`` and ``split_layers`` exactly; ``VdnnContext`` off-mesh
  returns the plain layer in both packages.
* Roofline: ``analyze_cell`` under the reference's chip equals the
  reference's on every key; under the H100 at mesh "1" the hand-worked
  terms; skipped and failed cells pass through.
* Dry-run (on the fake ``cpu`` device: every kernel wrapper then takes its
  plain version, as a real CPU step does): the ring formulas against the
  reference's HLO parser; the args of train, prefill and decode cells
  against the reference's abstract state / params and caches plus its
  input specs, byte for byte; FLOPs exactly linear in depth; the tracker
  on a fake step against the same real step; ``checkpoint_cell``; the
  refusals naming A8 / A9.  Each kernel wrapper given FakeTensors on the
  card reports its work and allocates, and launches nothing.
* The wire probe against the reference's (the same frames, up to the
  pickled class paths) and the hill climb's tables and JSON schema.

The reference's ``launch/dryrun.py`` and ``hillclimb.py`` set 512 host
devices in ``XLA_FLAGS`` on import: :func:`_reference` fixes JAX's backend
first and restores the variable, so no other test of the worker sees it.
"""
import dataclasses
import functools
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import hw as jhw
from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import CheckpointPlan as JCheckpointPlan
from repro.configs.base import MeshPlan as JMeshPlan
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import dag as jdag
from repro.core import offload as joffload
from repro.core import vdnn as jvdnn
from repro.launch import roofline as jroofline
from repro.models import transformer as jtfm
from repro.models.layers import ModelContext as JContext
from repro.models.model import build_model as jbuild
from repro.parallel.sharding import ShardingPlanner as JPlanner
from repro.serve import transport as jtransport
from repro_torch import hw, tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, MeshPlan, TrainConfig
from repro_torch.configs.base import CheckpointPlan, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import compress, offload, vdnn
from repro_torch.core import dag as tdag
from repro_torch.kernels import fake, ops
from repro_torch.kernels import offload_pack as kp
from repro_torch.kernels import ref as kref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.gemm_os import gemm_os
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import dryrun, hillclimb, roofline
from repro_torch.models import transformer as ttfm
from repro_torch.models.layers import ModelContext
from repro_torch.models.model import build_model
from repro_torch.parallel.sharding import ShardingPlanner
from repro_torch.serve import transport as ttransport
from repro_torch.train.loop import make_train_step
from repro_torch.train.train_state import init_state

from test_torch_train import GRAD_TOL, _assert_tree_close, _cfgs, \
    _layer_params, _np

SINGLE = (1,), ("data",)
PROD = (16, 16), ("data", "model")


@functools.lru_cache(maxsize=None)
def _reference(name: str):
    """``repro.launch.<name>`` imported with JAX's backend already fixed and
    ``XLA_FLAGS`` restored after (the module sets 512 host devices)."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


# ---------------------------------------------------------------------------
# shims
@pytest.mark.parametrize("entry", ["offload_layer", "maybe_offload"])
@pytest.mark.parametrize("policy,codec", [("none", "none"), ("host", "none"),
                                          ("host", "fp8")])
def test_offload_layer_matches_reference(entry, policy, codec):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    jp = _layer_params()
    plan = JMeshPlan(*SINGLE)
    jmem = JMemoryPlan(policy=policy, compress=codec)
    jplanner = JPlanner(plan)
    jctx = JContext(cfg=jcfg, planner=jplanner, memory=jmem, mesh=None,
                    mode="train")
    jf = getattr(joffload, entry)(functools.partial(
        jtfm._train_sublayer, jctx, "dense", True), jplanner, None, jmem)
    jy, jvjp = jax.vjp(lambda p, x: jf(p, x, jnp.asarray(pos))[0], jp,
                       jnp.asarray(x))
    jdp, jdx = jvjp(jnp.asarray(gy))

    tmem = MemoryPlan(policy=policy, compress=codec)
    planner = ShardingPlanner(MeshPlan(*SINGLE))
    tctx = ModelContext(cfg=tcfg, mode="train")
    tf = getattr(offload, entry)(functools.partial(
        ttfm._train_sublayer, tctx, "dense"), planner, None, tmem,
        device="cpu")
    if policy == "none":
        assert tf.func is ttfm._train_sublayer      # the plain layer
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


@pytest.mark.parametrize("policy,codec", [("host", "none"), ("host", "fp8"),
                                          ("mcdla", "none")])
def test_stash_fetch_round_trip(policy, codec):
    planner = ShardingPlanner(MeshPlan(*SINGLE))
    memory = MemoryPlan(policy=policy, compress=codec)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 96)).astype(np.float32)).to(torch.bfloat16)
    payload = offload.stash(x, planner, None, memory)
    tier = offload._tier(planner, None, memory, "cuda")   # the cached one
    assert tier.device.type == "cpu"                      # built on x's
    back = offload.fetch(payload, planner, None, memory, None, x.dtype)
    if codec == "none":
        assert torch.equal(back, x)
    else:
        c = compress.get_codec(codec)
        want = compress.decode_tensor(c, *compress.encode_tensor(c, x),
                                      dtype=x.dtype)
        assert torch.equal(back.view(torch.int16), want.view(torch.int16))
    # the reference's raw host round trip gives the tensor back too
    if codec == "none":
        jplanner = JPlanner(JMeshPlan(*SINGLE))
        jmem = JMemoryPlan(policy=policy)
        jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        jback = joffload.fetch(joffload.stash(jx, jplanner, None, jmem),
                               jplanner, None, jmem, None, jnp.bfloat16)
        np.testing.assert_array_equal(np.asarray(jback, np.float32),
                                      back.float().numpy())


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b",
                                  "zamba2-2.7b"])
def test_stash_fraction_and_split_layers_exact(arch):
    shape = ("train", 4096, 32, "train")
    jd = jdag.build_dag(JARCHS[arch], JShapeConfig(*shape))
    td = tdag.build_dag(TARCHS[arch], ShapeConfig(*shape))
    jchip = jhw.Chip(**dataclasses.asdict(hw.H100))
    for policy in ("none", "host", "mcdla", "spill", "auto"):
        for budget in (16.0, 80.0):
            for mesh in (SINGLE, PROD):
                kw = dict(policy=policy, hbm_budget_gb=budget)
                state = TARCHS[arch].param_count() * 14.0
                want = jvdnn.stash_fraction(jd, JMeshPlan(*mesh),
                                            JMemoryPlan(**kw), state)
                got = vdnn.stash_fraction(td, MeshPlan(*mesh),
                                          MemoryPlan(**kw), state,
                                          chip=hw.TPU_V5E)
                assert got == want, (policy, budget, mesh)
                from repro.core.runtime import MemoryRuntime as JRuntime
                want = JRuntime(JMeshPlan(*mesh), JMemoryPlan(**kw),
                                chip=jchip).stash_fraction(jd, state)
                assert vdnn.stash_fraction(td, MeshPlan(*mesh),
                                           MemoryPlan(**kw), state) == want
    for n in (0, 1, 7, 24, 30):
        for frac in (0.0, 0.1, 0.25, 0.5, 0.51, 0.99, 1.0, 1.5, -0.2):
            assert vdnn.split_layers(n, frac) == jvdnn.split_layers(n, frac)


def test_vdnn_context_off_mesh_is_the_plain_layer():
    def f(params, x):
        return x

    jctx = jvdnn.VdnnContext(JPlanner(JMeshPlan(*SINGLE)), None,
                             JMemoryPlan(policy="host"))
    tctx = vdnn.VdnnContext(ShardingPlanner(MeshPlan(*SINGLE)), None,
                            MemoryPlan(policy="host"), device="cpu")
    assert jctx.wrap_layer(f) is f
    assert tctx.wrap_layer(f) is f
    assert tctx.runtime.offloads


# ---------------------------------------------------------------------------
# roofline
def _cell(mesh, **over):
    r = {"ok": True, "arch": "smollm-135m", "shape": "train_4k",
         "mesh": mesh, "policy": "mcdla", "placement": "bw_aware",
         "compress": "none", "opt_bits": 32, "accum": 1,
         "flops_per_dev": 197e12 * 0.5, "bytes_accessed_per_dev": 819e9 / 4,
         "collective_wire_bytes_per_dev": 50e9 * 0.1,
         "arg_bytes_per_dev": 1e9, "temp_bytes_per_dev": 2e9}
    r.update(over)
    return r


@pytest.mark.parametrize("cell", [
    _cell("16x16"), _cell("2x16x16"),
    _cell("16x16", arch="mixtral-8x7b", shape="decode_32k"),
    _cell("2x16x16", arch="whisper-medium", shape="prefill_32k",
          flops_per_dev=1e12, bytes_accessed_per_dev=4e12,
          temp_bytes_per_dev=30e9),
    _cell("16x16", flops_per_dev=0.0, bytes_accessed_per_dev=1.0,
          collective_wire_bytes_per_dev=1e12)])
def test_analyze_cell_equals_reference_under_its_chip(cell):
    want = jroofline.analyze_cell(dict(cell))
    got = roofline.analyze_cell(dict(cell), chip=hw.TPU_V5E)
    for k, v in want.items():
        if k != "advice":               # the levers of the port's card
            assert got[k] == v, k


def test_analyze_cell_h100_one_device_by_hand():
    r = _cell("1", flops_per_dev=989e12 * 0.2,
              bytes_accessed_per_dev=3.35e12 * 0.3,
              collective_wire_bytes_per_dev=0.0,
              arg_bytes_per_dev=50e9, temp_bytes_per_dev=40e9)
    a = roofline.analyze_cell(r)
    mf = 6.0 * TARCHS["smollm-135m"].param_count() * 256 * 4096
    assert a["compute_s"] == pytest.approx(0.2)
    assert a["memory_s"] == pytest.approx(0.3)
    assert a["collective_s"] == 0.0
    assert a["dominant"] == "memory" and a["bound_s"] == a["memory_s"]
    assert a["model_flops"] == mf
    assert a["ideal_s"] == pytest.approx(mf / 989e12)
    assert a["roofline_fraction"] == pytest.approx(mf / 989e12 / 0.3)
    assert a["useful_ratio"] == pytest.approx(mf / (989e12 * 0.2))
    assert not a["fits_hbm"]                     # 90 GB on an 80 GB card
    assert "HBM" in a["advice"] and "Pallas" not in a["advice"]
    assert [roofline.mesh_chips(m) for m in ("1", "16x16", "2x16x16")] == \
        [1, 256, 512]


def test_skip_and_error_cells_pass_through(tmp_path):
    assert roofline.analyze_cell({"ok": None, "skip": "x"}) is None
    assert roofline.analyze_cell({"ok": False, "error": "y"}) is None
    rows = [_cell("1"), {"arch": "a", "shape": "s", "mesh": "1", "ok": None,
                         "skip": "skip: pure full-attention"},
            {"arch": "b", "shape": "s", "mesh": "1", "ok": False,
             "error": "boom"}]
    path = tmp_path / "dry.json"
    path.write_text(json.dumps(rows))
    got = roofline.analyze_file(str(path))
    want = jroofline.analyze_file(str(path))
    assert got[1] == want[1] and got[2] == want[2]
    md = roofline.to_markdown(got)
    assert "SKIP: skip: pure" in md and "ERROR: boom" in md
    assert md.count("\n") == 4


# ---------------------------------------------------------------------------
# dry-run
def test_ring_formulas_equal_the_reference_parser():
    records = [("all-gather", "bf16", (16, 4096, 512), 16),
               ("all-reduce", "f32", (1024,), 256),
               ("reduce-scatter", "bf16", (8, 128), 16),
               ("all-to-all", "bf16", (64, 32), 8),
               ("collective-permute", "bf16", (64,), 2),
               ("all-gather", "f32", (3, 5), 4)]
    size = {"bf16": 2, "f32": 4}
    lines = []
    for i, (kind, dt, dims, n) in enumerate(records):
        shape = f"{dt}[{','.join(map(str, dims))}]{{0}}"
        groups = ("" if kind == "collective-permute"
                  else f", replica_groups=[{256 // n},{n}]<=[256]")
        lines.append(f"  %c{i} = {shape} {kind}({shape} %p{i}){groups}")
    want = _reference("dryrun").parse_collectives("\n".join(lines))
    got = {}
    for kind, dt, dims, n in records:
        got[kind] = got.get(kind, 0.0) + dryrun.ring_wire_bytes(
            kind, size[dt] * int(np.prod(dims)), n)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def _nbytes(tree_) -> int:
    return sum(int(np.prod(l.shape)) * np.dtype(l.dtype).itemsize
               for l in jax.tree.leaves(tree_))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-370m",
                                  "whisper-medium", "qwen2-vl-2b"])
def test_arg_bytes_equal_the_reference_abstract_state(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    for mode in ("train", "prefill", "decode"):
        shape = (mode, 48, 3, mode)
        jmodel = jbuild(JRunConfig(model=jcfg, shape=JShapeConfig(*shape),
                                   mesh=JMeshPlan(*SINGLE),
                                   memory=JMemoryPlan(policy="none")))
        specs = jmodel.input_specs(JShapeConfig(*shape))
        if mode == "train":
            from repro.train.train_state import abstract_state
            want = _nbytes(abstract_state(jmodel, JTrainConfig()))
        else:
            want = _nbytes(jmodel.abstract_params()) + _nbytes(
                jax.eval_shape(lambda: jmodel.init_cache(3, 48)))
        want += _nbytes(specs)
        r = dryrun.lower_cell(arch, ShapeConfig(*shape), policy="none",
                              device="cpu", cfg=tcfg)
        assert r["arg_bytes_per_dev"] == want, mode
        assert r["temp_bytes_per_dev"] > 0 and r["flops_per_dev"] > 0
        assert r["mesh"] == "1" and r["ok"] and r["collectives"] == {}


@pytest.mark.parametrize("arch,unit", [("smollm-135m", 1),
                                       ("zamba2-2.7b", 2)])
def test_flops_exactly_linear_in_depth(arch, unit):
    shape = ShapeConfig("train", 32, 2, "train")
    f = {}
    for k in (1, 2, 4):
        cfg = dataclasses.replace(TARCHS[arch].reduced(),
                                  num_layers=k * unit)
        r = dryrun.lower_cell(arch, shape, policy="mcdla", device="cpu",
                              cfg=cfg)
        f[k] = r["flops_per_dev"]
        assert f[k] >= tdag.model_flops(cfg, shape)
    assert f[4] - f[2] == 2 * (f[2] - f[1]) > 0


def test_tracker_peak_fake_equals_real_step():
    cfg = TARCHS["smollm-135m"].reduced()
    shape = ShapeConfig("train", 64, 2, "train")
    for policy, codec in (("host", "fp8"), ("none", "none")):
        fake_r = dryrun.lower_cell("smollm-135m", shape, policy=policy,
                                   compress=codec, device="cpu", cfg=cfg)
        from repro_torch.configs import RunConfig
        run = RunConfig(model=cfg, shape=shape, memory=MemoryPlan(
            policy=policy, compress=codec), train=TrainConfig())
        model = build_model(run, device="cpu")
        params = ttfm.init_params(torch.Generator().manual_seed(0), cfg,
                                  model.dtype, model.device)
        state = init_state(model, TrainConfig(), params=params)
        batch = dryrun.input_specs(model, shape)
        step = make_train_step(model, TrainConfig())
        real = dryrun.trace_step(lambda: step(state, batch), (state, batch),
                                 "cpu")
        assert real["arg_bytes"] == fake_r["arg_bytes_per_dev"]
        assert real["temp_bytes"] == fake_r["temp_bytes_per_dev"]
        assert real["flops"] == fake_r["flops_per_dev"]
        assert real["bytes_accessed"] == fake_r["bytes_accessed_per_dev"]
        assert not real["kernels"] and not fake_r["kernels"]


@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x7b",
                                  "mamba2-370m"])
def test_checkpoint_cell_equals_reference(arch):
    for codec, every, asyncs in (("none", 0, False), ("fp8", 0, True),
                                 ("none", 50, False)):
        kw = dict(enabled=True, tier="host", codec=codec, every=every,
                  async_saves=asyncs, mtbf_steps=1000)
        common = dict(multi_pod=False, policy="mcdla", placement="bw_aware",
                      compress="none", opt_bits=32)
        want = _reference("dryrun").checkpoint_cell(
            arch, "train_4k", ckpt=JCheckpointPlan(**kw), **common)
        got = dryrun.checkpoint_cell(arch, "train_4k",
                                     ckpt=CheckpointPlan(**kw),
                                     chip=hw.TPU_V5E, **common)
        assert got == want


def test_refusals_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="A9"):
        dryrun.pipeline_cell("smollm-135m", "train_4k", multi_pod=False,
                             policy="mcdla", placement="bw_aware",
                             compress="none", opt_bits=32, pipeline=None)
    with pytest.raises(NotImplementedError, match="A8"):
        dryrun.lower_cell("smollm-135m", "train_4k", multi_pod=True)
    with pytest.raises(NotImplementedError, match="A8"):
        dryrun.lower_cell("smollm-135m", "train_4k", mesh=object())


def test_kernel_wrappers_fake_path_only_for_fake_tensors():
    """FakeTensors on the card: each wrapper allocates its outputs, reports
    its work to the tracker and launches nothing; FakeTensors on the CPU
    take the plain version and report nothing."""
    counters = [flash_attention_fwd, ssd_scan, paged_decode_attention,
                gemm_os, kp.int8_pack, kp.fp8_pack, kp.blocksparse_pack,
                kp.fp8_unpack]
    before = [f.launches for f in counters]
    bf = torch.bfloat16

    def calls(dev):
        def e(*shape, dtype=bf):
            return torch.zeros(shape, dtype=dtype, device=dev)
        x = e(256, 64)
        q, s = kp.int8_pack(x, block_rows=128)
        kp.fp8_pack(x, block_rows=128)
        kp.blocksparse_pack(x, block_rows=128)
        back = kp.fp8_unpack(q, s, block_rows=128)
        halves = list(x.split(128))      # (indexing needs the CUDA build)
        leaves = kp.int8_pack_leaves(halves)
        kp.unpack_leaves([lq for lq, _ in leaves],
                         [ls for _, ls in leaves], halves)
        o = flash_attention_fwd(e(2, 4, 64, 64), e(2, 2, 64, 64),
                                e(2, 2, 64, 64))
        y, fin = ssd_scan(e(1, 64, 4, 32), e(1, 64, 4, dtype=torch.float32),
                          e(4, dtype=torch.float32), e(1, 64, 1, 16),
                          e(1, 64, 1, 16), 32)
        d = paged_decode_attention(e(2, 1, 4, 64), e(9, 16, 2, 64),
                                   e(9, 16, 2, 64),
                                   e(2, 4, dtype=torch.int32), 40)
        g = gemm_os(e(128, 64), e(64, 128))
        return [q, s, back, o, y, fin, d, g]

    with FakeTensorMode():
        tracker = dryrun.StepTracker("cuda")
        with tracker:
            outs = calls("cuda")
        cpu = dryrun.StepTracker("cpu")
        with cpu:
            calls("cpu")
    assert [f.launches for f in counters] == before
    assert not cpu.kernels
    want = [((256, 64), torch.int8), ((2,), torch.float32),
            ((256, 64), bf), ((2, 4, 64, 64), bf),
            ((1, 64, 4, 32), torch.float32), ((1, 4, 32, 16), bf),
            ((2, 1, 4, 64), bf), ((128, 128), bf)]
    assert [(tuple(t.shape), t.dtype) for t in outs] == want
    assert all(t.device.type == "cuda" and fake.is_fake(t) for t in outs)
    assert outs[3].stride() == torch.empty((2, 64, 4, 64)).transpose(
        1, 2).stride()
    k = tracker.kernels
    assert {n: v["calls"] for n, v in k.items()} == {
        "int8_pack": 3, "fp8_pack": 1, "blocksparse_pack": 1,
        "fp8_unpack": 3, "flash_attention_fwd": 1, "ssd_scan": 1,
        "paged_decode_attention": 1, "gemm_os": 1}
    assert k["flash_attention_fwd"]["flops"] == 4.0 * 64 * 2 * 4 * (
        64 * 65 // 2)
    assert k["gemm_os"]["flops"] == 2.0 * 128 * 64 * 128
    assert k["gemm_os"]["bytes"] == (128 * 64 + 64 * 128 + 128 * 128) * 2
    # the pages a query at cache_index 40 sees: 3 of 16 rows, 2 kv heads
    assert k["paged_decode_attention"]["bytes"] == (
        2 * 2 * 4 * 64 * 2 + 2 * 4 * 4 + 2 * 2 * 3 * 16 * 2 * 64 * 2)
    assert fake.visible_pairs(6, 6, True, 2) == 11
    assert fake.visible_pairs(3, 5, False, 0) == 15
    # a real CPU tensor still takes the plain version
    x = torch.randn(128, 64)
    q, s = kp.int8_pack(x, block_rows=64)
    wq, ws = kref.int8_pack_ref(x, 64)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert [f.launches for f in counters] == before
    assert ops.flash_attention is not None


# ---------------------------------------------------------------------------
# wire probe and hill climb
WIRES = [dict(transport="memory"), dict(transport="tcp"),
         dict(transport="tcp", streams=4), dict(transport="shm"),
         dict(transport="tcp", streams=4, codec="int8")]


def _frames(module, **kw):
    """The frames one probe sends through in-memory pipes."""
    sent = []
    orig = module.InMemoryChannel.send

    def send(self, data):
        sent.append(bytes(data))
        return orig(self, data)

    module.InMemoryChannel.send = send
    try:
        r = module.probe_wire(payload_mb=1, pages=8, repeats=1, **kw)
    finally:
        module.InMemoryChannel.send = orig
    return r, sent


@pytest.mark.parametrize("kw", WIRES, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_probe_wire_bytes_equal_the_reference(kw):
    """``wire_bytes`` is the bytes one handoff puts on the channel; the
    page bytes are the reference's.  A pickle names the port's wire class
    (``repro_torch.serve.transport``, 6 bytes longer than the reference's
    path) once in each frame that carries leaves (the handoff's, or each
    of a striped handoff's 8 page frames); an int8 page's codes pickle
    from a view of the handoff's staging buffer, which numpy frames
    otherwise (within 64 bytes a frame).  The frames that cross in-memory
    pipes are decoded and held leaf by leaf."""
    got = ttransport.probe_wire(payload_mb=1, pages=8, repeats=1,
                                device="cpu", **kw)
    want = jtransport.probe_wire(payload_mb=1, pages=8, repeats=1, **kw)
    assert (got["transport"], got["streams"], got["payload_mb"]) == (
        want["transport"], want["streams"], want["payload_mb"])
    frames = 8 if kw.get("streams", 1) > 1 else 1
    if kw.get("codec") is None:
        assert got["wire_bytes"] - want["wire_bytes"] == 6 * frames
    else:
        assert abs(got["wire_bytes"] - want["wire_bytes"]) <= 64 * frames
    assert got["mb_per_s"] > 0 and got["handoff_ms"] > 0
    if kw["transport"] in ("memory", "shm") and kw.get("streams", 1) == 1:
        (_, tf), (_, jf) = (_frames(ttransport, device="cpu", **kw),
                            _frames(jtransport, **kw))
        assert [f[:5] for f in tf][1:] == [f[:5] for f in jf][1:]
        assert len(tf) == len(jf)
        tmsg = ttransport._loads(tf[0][9:-4])
        jmsg = ttransport._loads(jf[0][9:-4])   # the reference's frame
        tl, jl = ([leaf for page in m["pages"] for leaf in page.values()]
                  for m in (tmsg, jmsg))
        assert len(tl) == len(jl) == 16
        for a, b in zip(tl, jl):
            assert type(a) is type(b)
            assert a.__dict__.keys() == b.__dict__.keys()
            for f, v in a.__dict__.items():
                w = getattr(b, f)
                if isinstance(v, np.ndarray):
                    assert v.tobytes() == w.tobytes(), f
                else:
                    assert v == w, f


def test_hill_climb_tables_and_wire_schema(tmp_path, monkeypatch):
    ref = _reference("hillclimb")
    assert hillclimb.VARIANTS == ref.VARIANTS
    assert hillclimb.WIRE_VARIANTS == ref.WIRE_VARIANTS
    ours, theirs = tmp_path / "port.json", tmp_path / "ref.json"
    args = ["--wire", "--variants", "wire-baseline,shm", "--payload-mb",
            "1"]
    rows = hillclimb.main(args + ["--out", str(ours), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["hillclimb"] + args
                        + ["--out", str(theirs)])
    ref.main()
    got, want = json.loads(ours.read_text()), json.loads(theirs.read_text())
    assert len(got) == len(want) == 1
    assert got[0].keys() == want[0].keys()
    assert (got[0]["arch"], got[0]["shape"]) == (want[0]["arch"],
                                                 want[0]["shape"])
    assert [r["variant"] for r in got[0]["rows"]] == \
        [r["variant"] for r in want[0]["rows"]] == ["wire-baseline", "shm"]
    for g, w in zip(got[0]["rows"], want[0]["rows"]):
        assert g.keys() == w.keys() and "error" not in g
    assert rows == got[0]["rows"]


def test_hill_climb_training_variants_on_the_fake_card(tmp_path):
    """Two training variants of a reduced cell through ``lower_cell`` and
    ``analyze_cell`` (the CLI's rows, here on the fake ``cpu`` device and
    a cut configuration)."""
    cfg = TARCHS["smollm-135m"].reduced()
    shape = ShapeConfig("train", 64, 2, "train")
    rows = {}
    for name in ("baseline", "oracle", "fp8"):
        r = dryrun.lower_cell("smollm-135m", shape, device="cpu", cfg=cfg,
                              **hillclimb.VARIANTS[name])
        rows[name] = roofline.analyze_cell(r, cfg=cfg)
        assert rows[name]["bound_s"] > 0 and rows[name]["useful_ratio"] > 0
    # the oracle keeps every layer: no recompute, fewer FLOPs
    assert rows["oracle"]["compute_s"] < rows["baseline"]["compute_s"]
    assert rows["fp8"]["compute_s"] == rows["baseline"]["compute_s"]
