"""The port's layer DAG and KEEP / POOL / RECOMPUTE planner against the
JAX reference, on the CPU.

``build_dag`` layer for layer for every configuration; ``plan_memory``
decisions, memory map, stalls, checkpoint cadence and ``summarize`` strings
for the same chip figures (the reference's ``hw.Chip`` built from the
port's) and the same budget; ``MemoryRuntime.resolve_stash_groups`` and
``build_model``'s split; a reduced model at a budget where the planner
splits the stack, whose loss and gradients match the reference's step with
the same ``stash_groups``; the pins ``chip_smoke.py`` phase 17 reads on the
H100 (no group stashed for smollm-135m at 8 x 1024, the planned cadence
for its MTBF); and the CLI's cadence (``--ckpt-every 0 --mtbf-steps``)
against the reference's arithmetic.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import hw as jhw
from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan as JMeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import CheckpointPlan as JCheckpointPlan
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import dag as jdag
from repro.core import policy as jpolicy
from repro.core.runtime import MemoryRuntime as JRuntime
from repro.models.model import build_model as jbuild
from repro_torch import hw, tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, MeshPlan, RunConfig
from repro_torch.configs.base import CheckpointPlan, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import dag as tdag
from repro_torch.core import policy as tpolicy
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model

from test_torch_train import GRAD_TOL, LOSS_TOL, _assert_tree_close, _np

SHAPES = [("train", 1024, 8, "train"), ("train", 4096, 32, "train")]
MESHES = [((1,), ("data",)), ((16, 16), ("data", "model"))]
# every chip both packages know, the reference's built from the port's
CHIPS = {name: (getattr(hw, name), jhw.Chip(**dataclasses.asdict(
    getattr(hw, name)))) for name in ("H100", "TPU_V5E", "PAPER_DEVICE")}
# phase 17 of chip_smoke.py: smollm-135m at 8 x 1024, --mtbf-steps 1
PHASE17_MTBF, PHASE17_EVERY = 1, 5


def _ref_plan(policy="auto", budget=80.0, **kw):
    return JMemoryPlan(policy=policy, hbm_budget_gb=budget, **kw)


def _port_plan(policy="auto", budget=80.0, **kw):
    return MemoryPlan(policy=policy, hbm_budget_gb=budget, **kw)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_build_dag_layer_for_layer(arch):
    for shape in SHAPES:
        want = jdag.build_dag(JARCHS[arch], JShapeConfig(*shape))
        got = tdag.build_dag(TARCHS[arch], ShapeConfig(*shape))
        assert [dataclasses.astuple(n) for n in got.layers] == \
            [dataclasses.astuple(n) for n in want.layers]
        assert got.schedule() == want.schedule()
        assert got.total_flops() == want.total_flops()
        assert got.total_saved_bytes() == want.total_saved_bytes()
        assert tdag.model_flops(TARCHS[arch], ShapeConfig(*shape)) == \
            jdag.model_flops(JARCHS[arch], JShapeConfig(*shape))


def _both_plans(arch, shape, mesh, policy, budget, chip, compress="none",
                ckpt=None):
    """(port report, reference report) for one cell."""
    tchip, jchip = CHIPS[chip]
    cfg_t, cfg_j = TARCHS[arch], JARCHS[arch]
    state = cfg_j.param_count() * 14
    got = tpolicy.plan_memory(
        tdag.build_dag(cfg_t, ShapeConfig(*shape)), MeshPlan(*mesh),
        _port_plan(policy, budget, compress=compress), chip=tchip,
        model_state_bytes=state,
        checkpoint=None if ckpt is None else CheckpointPlan(**ckpt))
    want = jpolicy.plan_memory(
        jdag.build_dag(cfg_j, JShapeConfig(*shape)), JMeshPlan(*mesh),
        _ref_plan(policy, budget, compress=compress), chip=jchip,
        model_state_bytes=state,
        checkpoint=None if ckpt is None else JCheckpointPlan(**ckpt))
    return got, want


def _report(r) -> tuple:
    return ([dataclasses.astuple(d) for d in r.decisions],
            r.resident_bytes_per_dev, r.pooled_bytes_per_dev,
            r.budget_bytes, r.tier, r.host_bytes, r.fits,
            r.total_stall(),
            None if r.checkpoint is None
            else dataclasses.astuple(r.checkpoint))


@pytest.mark.parametrize("arch", sorted(TARCHS))
@pytest.mark.parametrize("policy,compress", [
    ("auto", "none"), ("auto", "fp8"), ("mcdla", "none"), ("host", "fp8"),
    ("spill", "none"), ("none", "none")])
def test_plan_memory_matches_reference(arch, policy, compress):
    """Decisions, memory map, stalls and the summary line, at budgets
    from the H100's to one that forces eviction, on one card and a
    256-device mesh, for every chip both packages model."""
    for shape in SHAPES:
        for mesh in MESHES:
            for budget in (80.0, 16.0, 2.5):
                for chip in CHIPS:
                    got, want = _both_plans(arch, shape, mesh, policy,
                                            budget, chip, compress)
                    assert _report(got) == _report(want)
                    assert tpolicy.summarize(got) == \
                        jpolicy.summarize(want)


@pytest.mark.parametrize("mtbf", [1, 2, 10, 1000, 10_000])
@pytest.mark.parametrize("tier,codec,async_saves", [
    ("host", "none", False), ("host", "fp8", True), ("mcdla", "none", False),
    ("spill", "int8", False)])
def test_plan_memory_checkpoint_cadence_matches_reference(mtbf, tier, codec,
                                                          async_saves):
    ckpt = dict(enabled=True, tier=tier, codec=codec, every=0,
                async_saves=async_saves, mtbf_steps=mtbf)
    for arch in ("smollm-135m", "zamba2-2.7b"):
        got, want = _both_plans(arch, SHAPES[0], MESHES[0], "auto", 80.0,
                                "H100", ckpt=ckpt)
        assert _report(got) == _report(want)
        assert tpolicy.summarize(got) == jpolicy.summarize(want)


def test_fetch_bandwidth_and_micro_candidates_match_reference():
    for placement in ("bw_aware", "local"):
        for policy in ("auto", "mcdla", "host", "spill", "none"):
            for mesh in MESHES:
                for chip in CHIPS:
                    tchip, jchip = CHIPS[chip]
                    assert tpolicy.fetch_bandwidth(
                        MeshPlan(*mesh), _port_plan(policy,
                                                    placement=placement),
                        tchip) == jpolicy.fetch_bandwidth(
                        JMeshPlan(*mesh), _ref_plan(policy,
                                                    placement=placement),
                        jchip)
    for batch in (1, 8, 12, 64, 96):
        for stages in (1, 2, 4, 8):
            assert tpolicy.micro_candidates(batch, stages) == \
                jpolicy.micro_candidates(batch, stages)


def test_pipelined_plan_waits_for_the_pipeline():
    from repro_torch.configs.base import PipelinePlan
    dag = tdag.build_dag(TARCHS["smollm-135m"], ShapeConfig(*SHAPES[0]))
    with pytest.raises(NotImplementedError, match="A9"):
        tpolicy.plan_memory(dag, MeshPlan(*MESHES[0]), _port_plan(),
                            pipeline=PipelinePlan(enabled=True, n_stages=2))


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_resolve_stash_groups_matches_reference(arch):
    """The split ``build_model`` takes: every group for a stash-all tier,
    none without offload, and for ``auto`` the planner's count (8-bit
    moments too: the two packages' optimizer-state bytes)."""
    n = TARCHS[arch].num_layers
    for policy in ("auto", "mcdla", "host", "none"):
        for budget in (80.0, 16.0, 2.5):
            for bits in (32, 8):
                got = MemoryRuntime(
                    MeshPlan(*MESHES[0]),
                    _port_plan(policy, budget, opt_state_bits=bits),
                    device="cpu").resolve_stash_groups(
                        TARCHS[arch], ShapeConfig(*SHAPES[0]), n)
                want = JRuntime(
                    JMeshPlan(*MESHES[0]),
                    _ref_plan(policy, budget, opt_state_bits=bits),
                    chip=CHIPS["H100"][1]).resolve_stash_groups(
                        JARCHS[arch], JShapeConfig(*SHAPES[0]), n)
                assert got == want, (policy, budget, bits)


# ---------------------------------------------------------------------------
def _split_models(layers=4, seq=32, batch=4):
    """Reduced smollm-135m (float32, ``layers`` deep) in both packages
    under ``auto`` at the first budget where the reference's planner keeps
    some layer groups and evicts others; returns (reference model, port
    model, k)."""
    jcfg = dataclasses.replace(
        JARCHS["smollm-135m"].reduced(dtype="float32"), num_layers=layers)
    tcfg = dataclasses.replace(
        TARCHS["smollm-135m"].reduced(dtype="float32"), num_layers=layers)
    dag = jdag.build_dag(jcfg, JShapeConfig("train", seq, batch, "train"))
    state = jcfg.param_count() * 14
    for frac in (0.5, 0.25, 0.75):
        budget = (state + frac * dag.total_saved_bytes()) / 1e9
        jm = jbuild(JRunConfig(
            model=jcfg, shape=JShapeConfig("train", seq, batch, "train"),
            mesh=JMeshPlan((1,), ("data",)),
            memory=JMemoryPlan(policy="auto", hbm_budget_gb=budget)))
        if 0 < jm.stash_groups < layers:
            break
    tm = build_model(RunConfig(
        model=tcfg, shape=ShapeConfig("train", seq, batch, "train"),
        memory=MemoryPlan(policy="auto", hbm_budget_gb=budget)),
        device="cpu")
    return jm, tm, jm.stash_groups


def test_split_model_loss_and_grads_match_reference():
    """The planner splits a 4-layer stack (0 < k < 4): the port wraps the
    same first k groups (k stashes a forward) and runs the rest bare; its
    loss and gradients equal the reference's ``stash_groups = k`` step."""
    jm, tm, k = _split_models()
    assert 0 < k < 4 and tm.stash_groups == k
    jp = jm.init(jax.random.PRNGKey(0))
    batch = SyntheticLM(tm.cfg, batch=4, seq=32, seed=1).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(
        jp, {key: jnp.asarray(v) for key, v in batch.items()})
    tp = tree.map(lambda t: t.requires_grad_(),
                  params_from_jax(_np(jp), "cpu"))
    tl, _ = tm.loss_fn(tp, to_device(batch, "cpu"))
    leaves, paths = tree.flatten(tp)
    tg = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) < LOSS_TOL
    _assert_tree_close(tree.unflatten(paths, list(tg)), _np(jg), GRAD_TOL,
                       "grad")
    rep = tm.runtime.traffic_report()
    assert rep["stash"]["calls"] == rep["fetch"]["calls"] == k


# ---------------------------------------------------------------------------
def test_h100_pins_of_phase_17():
    """What ``chip_smoke.py`` phase 17 checks on the card: ``auto`` (fp8
    stash codec, as phase 5's run) keeps every group of full-width
    smollm-135m at 8 x 1024 (resident estimate 2.17 GB), and
    ``--mtbf-steps 1`` plans a save every 5 steps; both equal the
    reference's arithmetic with the H100's figures."""
    shape = ShapeConfig("train", 1024, 8, "train")
    tm_run = RunConfig(model=TARCHS["smollm-135m"], shape=shape,
                       memory=MemoryPlan(policy="auto", compress="fp8"))
    rt = MemoryRuntime(MeshPlan(*MESHES[0]), tm_run.memory, device="cpu")
    cfg = TARCHS["smollm-135m"]
    assert rt.resolve_stash_groups(cfg, shape, cfg.num_layers) == 0
    report = rt.plan_report(tdag.build_dag(cfg, shape),
                            model_state_bytes=cfg.param_count() * 14)
    assert tpolicy.summarize(report).startswith(
        "tier=pooled_hbm[bw_aware]+fp8 keep=30 pool=0 recompute=0 "
        "resident=2.17GB")
    want = JRuntime(JMeshPlan((1,), ("data",)), _ref_plan(compress="fp8"),
                    chip=CHIPS["H100"][1]).resolve_stash_groups(
        JARCHS["smollm-135m"], JShapeConfig("train", 1024, 8, "train"), 30)
    assert want == 0

    class _Model:                     # what plan_cadence reads of a Model
        plan = MeshPlan(*MESHES[0])
        memory = tm_run.memory
    _Model.cfg = cfg
    ckpt, rep = train_cli.plan_cadence(_Model, shape, CheckpointPlan(
        enabled=True, tier="host", every=0, mtbf_steps=PHASE17_MTBF))
    jrep = jpolicy.plan_memory(
        jdag.build_dag(JARCHS["smollm-135m"],
                       JShapeConfig("train", 1024, 8, "train")),
        JMeshPlan((1,), ("data",)), _ref_plan(compress="fp8"),
        chip=CHIPS["H100"][1],
        model_state_bytes=cfg.param_count() * (4 + 2 * 32 // 8),
        checkpoint=JCheckpointPlan(enabled=True, tier="host", every=0,
                                   mtbf_steps=PHASE17_MTBF))
    assert ckpt.every == rep.checkpoint.every == jrep.checkpoint.every \
        == PHASE17_EVERY


@pytest.mark.parametrize("mtbf", [1, 2, 5, 10, 100, 10_000])
def test_cli_cadence_matches_reference(mtbf):
    """``--ckpt-tier host --ckpt-every 0 --mtbf-steps M``: the cadence the
    train CLI plans for its smoke twin (4 x 128) and for the full-width
    model (8 x 1024) equals the reference launcher's arithmetic."""
    for smoke, shape in ((True, (128, 4)), (False, (1024, 8))):
        argv = ["--arch", "smollm", "--device", "cpu", "--policy", "auto",
                "--ckpt-tier", "host", "--mtbf-steps", str(mtbf)]
        args = train_cli.parse_args(argv + (["--smoke"] if smoke else [
            "--batch", "8", "--seq", "1024"]))
        ckpt = train_cli.checkpoint_plan(args)
        assert ckpt.every == 0 and ckpt.mtbf_steps == mtbf
        cfg_t = TARCHS["smollm-135m"].reduced() if smoke \
            else TARCHS["smollm-135m"]
        cfg_j = JARCHS["smollm-135m"].reduced() if smoke \
            else JARCHS["smollm-135m"]

        class _Model:
            plan = MeshPlan(*MESHES[0])
            memory = _port_plan()
        _Model.cfg = cfg_t
        got, _ = train_cli.plan_cadence(
            _Model, ShapeConfig("train", *shape, "train"), ckpt)
        want = jpolicy.plan_memory(
            jdag.build_dag(cfg_j, JShapeConfig("train", *shape, "train")),
            JMeshPlan((1,), ("data",)), _ref_plan(), chip=CHIPS["H100"][1],
            model_state_bytes=cfg_j.param_count() * (4 + 2 * 32 // 8),
            checkpoint=JCheckpointPlan(enabled=True, tier="host", every=0,
                                       mtbf_steps=mtbf)).checkpoint
        assert got.every == want.every, (smoke, mtbf)
