"""Checkpoints as a memory tier, fault handling and chaos: the port against
the JAX reference, on the CPU.

Schedules, retries, the straggler monitor, the checkpoint tier's contract,
the cadence planner and snapshot metering are held to the reference's
numbers; the manager to the reference's guarantees (atomic commit, CRC,
keep-K, async failure in ``wait``); the on-disk format both ways (each
package restores, bit for bit, a directory the other wrote); and the
reference's chaos scenario (``tests/test_chaos.py``) runs in the port on
reduced smollm-135m in float32, from the reference's initial weights.
"""
import dataclasses
import functools
import glob
import itertools
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan as JMeshPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs import TrainConfig as JTrainConfig
from repro.configs.base import CheckpointPlan as JCheckpointPlan
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import policy as jpolicy
from repro.core.pool import PoolAccountant as JPoolAccountant
from repro.core.tiers import TransferHints as JHints
from repro.core.tiers import build_ckpt_tier as jbuild_ckpt_tier
from repro.data.pipeline import MemmapTokens as JMemmapTokens
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as jbuild
from repro.parallel.sharding import ShardingPlanner
from repro.train import chaos as jchaos
from repro.train import fault as jfault
from repro.train.checkpoint import CheckpointManager as JManager
from repro.train.checkpoint import make_ckpt_runtime as jmake_runtime
from repro.train.elastic import ElasticController as JElastic
from repro.train.loop import make_manager as jmake_manager
from repro.train.loop import train as jtrain
from repro.train.train_state import init_state as jinit_state
from repro_torch import hw
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, MeshPlan, RunConfig, TrainConfig
from repro_torch.configs.base import CheckpointPlan, ShapeConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import CADENCE_CANDIDATES, plan_checkpoint
from repro_torch.core.pool import PoolAccountant
from repro_torch.core.tiers import (CheckpointTier, TransferHints,
                                    build_ckpt_tier, registered_policies)
from repro_torch.data.pipeline import MemmapTokens, Prefetcher, SyntheticLM
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as train_cli
from repro_torch.models.model import build_model
from repro_torch.train import chaos, fault
from repro_torch.train.checkpoint import (CheckpointError, CheckpointManager,
                                          _flatten, make_ckpt_runtime,
                                          to_device)
from repro_torch.train.elastic import ElasticController
from repro_torch.train.loop import make_manager, train
from repro_torch.train.train_state import init_state, state_template

PLAN1 = MeshPlan((1,), ("data",))
JPLAN1 = JMeshPlan((1,), ("data",))
# the port's target chip, in the reference's type, so both price the same
JH100 = jhw.Chip(**dataclasses.asdict(hw.H100))
# float32 on both sides, products summed in different orders: as
# tests/test_torch_train.py holds a 3-step curve
LOSS_TOL = 1e-5
SCENARIO = "kill@3:2,corrupt@4,preempt@7"


@pytest.fixture(scope="module", autouse=True)
def deterministic():
    """Bit-identical curves need run-to-run determinism: the port's float32
    CPU training is not without it (two equal runs of the scenario's 10
    steps read other last bits with several threads; ROADMAP C13).
    Deterministic algorithms made them agree, but one run of
    this file still failed its bit-identity checks (not reproduced since),
    so the file also runs on one thread: a library that sizes its thread
    team by the machine's load then has no team to size."""
    before = torch.are_deterministic_algorithms_enabled()
    threads = torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    yield
    torch.use_deterministic_algorithms(before)
    torch.set_num_threads(threads)


def _bits(x) -> bytes:
    """A leaf's bytes (a torch tensor or a numpy / ml_dtypes array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8) \
            .numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# ---------------------------------------------------------------------------
# (a) chaos schedules, hooks, retries, the straggler monitor
@pytest.mark.parametrize("spec", [SCENARIO,
                                  "kill@3,corrupt@5,stage_loss@7:1,preempt@9",
                                  "preempt@2,kill@1:3, corrupt@0:1"])
def test_schedule_parse_matches_reference(spec):
    got, want = chaos.ChaosSchedule.parse(spec), \
        jchaos.ChaosSchedule.parse(spec)
    assert got.spec() == want.spec()
    assert [dataclasses.astuple(e) for e in got.events] == \
        [dataclasses.astuple(e) for e in want.events]


@pytest.mark.parametrize("bad,match", [("explode@3", "unknown chaos kind"),
                                       ("kill@three", "bad chaos event")])
def test_schedule_parse_rejects_as_reference(bad, match):
    for mod in (chaos, jchaos):
        with pytest.raises(ValueError, match=match):
            mod.ChaosSchedule.parse(bad)


@pytest.mark.parametrize("seed,steps", [(0, 200), (7, 200), (3, 50)])
def test_schedule_random_matches_reference(seed, steps):
    got = chaos.ChaosSchedule.random(seed, steps)
    assert got.spec() == jchaos.ChaosSchedule.random(seed, steps).spec()
    rates = {"kill": 0.2, "preempt": 0.05}
    assert chaos.ChaosSchedule.random(seed, steps, rates).spec() == \
        jchaos.ChaosSchedule.random(seed, steps, rates).spec()


def test_monkey_hooks_match_reference(tmp_path):
    fired = []
    for mod in (chaos, jchaos):
        monkey = mod.ChaosMonkey(mod.ChaosSchedule.parse(
            "kill@2:2,stage_loss@4:1,preempt@6,corrupt@1"), seed=3)

        def step(state, batch):
            return state + 1, {}

        assert monkey.wrap_step(step, 0) is step
        wrapped = monkey.wrap_step(step, 2)
        for _ in range(2):
            with pytest.raises(mod.TransientCollectiveError):
                wrapped(0, None)
        assert wrapped(0, None)[0] == 1
        with pytest.raises(mod.StageLostError) as e:
            monkey.before_step(4)
        assert e.value.stage == 1
        monkey.before_step(4)                        # fired once only
        handler = (fault if mod is chaos else jfault).FaultHandler(
            install_signals=False)
        monkey.before_step(6, handler)
        assert handler.should_stop
        d = tmp_path / mod.__name__ / "step_00000002"
        d.mkdir(parents=True)
        for name in ("arrays.npz", "arrays.1.npz", "arrays.2.npz"):
            (d / name).write_bytes(bytes(range(256)) * 8)
        monkey.after_save(2, str(d))
        monkey.after_save(3, str(d))                 # one-shot
        fired.append((monkey.fired, monkey.summary(),
                      {n: (d / n).read_bytes() for n in os.listdir(d)}))
    assert fired[0] == fired[1]             # same seeded shard and byte


@pytest.mark.parametrize("fails,retries", [(99, 3), (2, 4), (0, 2)])
def test_retry_step_sleeps_match_reference(fails, retries):
    runs = []
    for mod in (fault, jfault):
        sleeps, attempts = [], []

        def flaky(state, batch):
            attempts.append(1)
            if len(attempts) <= fails:
                raise RuntimeError("transient")
            return "ok"

        try:
            out = mod.retry_step(flaky, None, None, retries=retries,
                                 backoff=0.25, sleep=sleeps.append)
        except RuntimeError:
            out = "raised"
        runs.append((out, sleeps, len(attempts)))
    assert runs[0] == runs[1]
    if fails > retries:     # no sleep after the last failed attempt
        assert len(runs[0][1]) == retries


def test_straggler_monitor_and_fault_flag_match_reference():
    rng = np.random.default_rng(0)
    times = list(0.1 + 0.01 * rng.random(40))
    times[15] = times[30] = 1.0
    seen = []
    for mod in (fault, jfault):
        calls = []
        mon = mod.StragglerMonitor(threshold=3.0, window=8,
                                   on_straggler=lambda s, m: calls.append(s))
        flags = [mon.observe(t) for t in times]
        seen.append((flags, mon.flagged, calls, len(mon.times)))
        handler = mod.FaultHandler(install_signals=False)
        assert not handler.should_stop
        handler._handle(15, None)
        assert handler.should_stop
    assert seen[0] == seen[1]
    assert seen[0][1] == 2


def test_fault_handler_restores_signal_handlers():
    import signal
    before = signal.getsignal(signal.SIGTERM)
    handler = fault.FaultHandler()
    if handler._prev:                  # installed (the main thread)
        assert signal.getsignal(signal.SIGTERM) == handler._handle
    handler.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------------------
# (b) the checkpoint tier, the cadence planner, snapshot metering
def test_checkpoint_policy_registered():
    assert "checkpoint" in registered_policies()
    tier = build_ckpt_tier(MemoryPlan(), PLAN1, "cpu", backing="checkpoint")
    assert tier.describe() == "ckpt[host]"


@pytest.mark.parametrize("backing", ["host", "mcdla", "spill"])
@pytest.mark.parametrize("codec,keep", [("none", 1), ("fp8", 4)])
def test_ckpt_tier_contract_matches_reference(backing, codec, keep):
    # one HBM budget for both (the port's default is the H100's 80 GB)
    mem, jmem = MemoryPlan(hbm_budget_gb=16.0), JMemoryPlan(hbm_budget_gb=16.0)
    got = build_ckpt_tier(mem, PLAN1, "cpu", backing=backing, codec=codec,
                          keep=keep)
    want = jbuild_ckpt_tier(jmem, ShardingPlanner(JPLAN1), backing=backing,
                            codec=codec, keep=keep)
    assert got.describe() == want.describe()
    assert got.offloads and want.offloads
    assert got.payload_ratio() == want.payload_ratio()
    assert got.bandwidth(PLAN1, hw.H100) == want.bandwidth(JPLAN1, JH100)
    assert 0 < got.bandwidth(PLAN1, hw.H100) <= hw.DCN_BW
    assert got.capacity(PoolAccountant(PLAN1, mem)) == \
        want.capacity(JPoolAccountant(JPLAN1, jmem))
    inner = got.inner if codec != "none" else got
    assert isinstance(inner, CheckpointTier)
    assert got.capacity(PoolAccountant(PLAN1, mem)) == pytest.approx(
        inner.inner.capacity(PoolAccountant(PLAN1, mem)) / keep)


@pytest.mark.parametrize("kwargs", [
    dict(state_bytes=1e9, step_time_s=0.1, every=25),
    dict(state_bytes=1e9, step_time_s=0.1, mtbf_steps=1000),
    dict(state_bytes=1.35e9, step_time_s=0.4, every=10, async_saves=True),
    dict(state_bytes=1.35e9, step_time_s=0.4, mtbf_steps=200,
         async_saves=True)])
@pytest.mark.parametrize("backing", ["host", "mcdla"])
def test_plan_checkpoint_matches_reference(kwargs, backing):
    tier = build_ckpt_tier(MemoryPlan(), PLAN1, "cpu", backing=backing)
    jtier = jbuild_ckpt_tier(JMemoryPlan(), ShardingPlanner(JPLAN1),
                             backing=backing)
    args = dict(kwargs)
    sb, st = args.pop("state_bytes"), args.pop("step_time_s")
    got = plan_checkpoint(sb, st, tier, PLAN1, hw.H100, **args)
    want = jpolicy.plan_checkpoint(sb, st, jtier, JPLAN1, JH100, **args)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.total_s == want.total_s
    if "every" not in args:
        assert got.every in CADENCE_CANDIDATES
        for k in (CADENCE_CANDIDATES[0], CADENCE_CANDIDATES[-1]):
            edge = plan_checkpoint(sb, st, tier, PLAN1, hw.H100,
                                   **dict(args, every=k))
            assert got.total_s <= edge.total_s + 1e-12


def test_plan_checkpoint_async_hides_save():
    tier = build_ckpt_tier(MemoryPlan(), PLAN1, "cpu")
    sync = plan_checkpoint(1e9, 0.5, tier, PLAN1, every=10)
    asyn = plan_checkpoint(1e9, 0.5, tier, PLAN1, every=10, async_saves=True)
    assert asyn.overhead_s <= sync.overhead_s
    assert asyn.async_saves and not sync.async_saves


@pytest.mark.parametrize("codec", ["none", "fp8", "int8", "blocksparse"])
def test_snapshot_metering_matches_reference(codec):
    x = np.random.default_rng(1).standard_normal((128, 64)).astype(
        np.float32)
    rt = make_ckpt_runtime(CheckpointPlan(enabled=True, codec=codec), PLAN1,
                           MemoryPlan(), "cpu")
    jrt = jmake_runtime(JCheckpointPlan(enabled=True, codec=codec), JPLAN1,
                        JMemoryPlan())
    payload = rt.snapshot(torch.from_numpy(x),
                          TransferHints(dtype=torch.float32, name="w"))
    back = rt.restore_snapshot(payload, TransferHints(dtype=torch.float32))
    jpayload = jrt.snapshot(jax.numpy.asarray(x),
                            JHints(dtype=jax.numpy.float32, name="w"))
    jrt.restore_snapshot(jpayload, JHints(dtype=jax.numpy.float32))
    assert back.shape == x.shape and back.dtype == torch.float32
    got, want = rt.traffic_report(), jrt.traffic_report()
    for d in ("ckpt_save", "ckpt_load"):
        assert (got[d]["calls"], got[d]["raw_bytes"], got[d]["wire_bytes"]) \
            == (want[d]["calls"], want[d]["raw_bytes"],
                want[d]["wire_bytes"]), d
    assert got["tier"] == want["tier"]


# ---------------------------------------------------------------------------
# (c) the manager
def _runtime(codec="none", keep=1, tier="host"):
    return make_ckpt_runtime(CheckpointPlan(enabled=True, tier=tier,
                                            codec=codec),
                             PLAN1, MemoryPlan(), "cpu", keep=keep)


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(64, 32, generator=g),
                       "b": torch.randn(32, generator=g).bfloat16()},
            "opt": {"mu": torch.zeros(64, 32), "count": torch.tensor(
                3, dtype=torch.int32),
                    # an 8-bit moment: int8 codes pass through a codec
                    "q8": {"q": torch.randint(-127, 128, (64, 32),
                                              generator=g).to(torch.int8),
                           "scale": torch.rand(64, 1, generator=g)}},
            "step": torch.tensor(3, dtype=torch.int32)}


@pytest.mark.parametrize("codec", ["none", "fp8", "int8", "blocksparse"])
@pytest.mark.parametrize("tier", ["host", "mcdla"])
def test_manager_roundtrip_codecs(tmp_path, codec, tier):
    rt = _runtime(codec, tier=tier)
    mgr = CheckpointManager(str(tmp_path), keep=2, runtime=rt)
    state = _state()
    mgr.save(7, {"state": state, "data": {"step": 7, "seed": 0}})
    step, payload = mgr.restore_latest()
    assert step == 7 and payload["data"] == {"step": 7, "seed": 0}
    flat, want = payload["state"], _flatten(state)
    assert sorted(flat) == sorted(want)
    for key, x in want.items():
        got = flat[key]
        assert got.dtype == x.dtype and got.shape == x.shape, key
        if codec == "none" or not x.is_floating_point():
            assert _bits(got) == _bits(x), key
            continue
        # the plain twins: one row block a leaf
        x2 = x.reshape(-1, x.shape[-1])
        q, s = getattr(tref, f"{codec}_pack_ref")(x2, block_rows=x2.shape[0])
        plain = tref.fp8_unpack_ref(q, s, block_rows=x2.shape[0],
                                    dtype=x.dtype).reshape(x.shape)
        assert _bits(got) == _bits(plain), key
    man = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    tr = rt.traffic_report()
    assert tr["ckpt_save"]["wire_bytes"] == man["bytes"]["wire"]
    assert tr["ckpt_load"]["wire_bytes"] == man["bytes"]["wire"]
    assert man["codec"] == rt.tier.describe()
    if codec != "none":
        assert man["bytes"]["wire"] < man["bytes"]["raw"]


def test_spill_backing_round_trips_where_the_reference_cannot(tmp_path):
    """A snapshot through a spill backing: the port writes the payload
    inside the spill leg and restores it over the host leg; the
    reference writes the leg's wrapper as a pickled object array, which
    its own restore refuses (ROADMAP C12)."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "port"), runtime=_runtime(
        tier="spill"))
    mgr.save(1, {"state": state, "data": None})
    _, payload = mgr.restore(1)
    for key, x in _flatten(state).items():
        assert _bits(payload["state"][key]) == _bits(x), key
    jmgr = JManager(str(tmp_path / "reference"), runtime=jmake_runtime(
        JCheckpointPlan(enabled=True, tier="spill"), JPLAN1, JMemoryPlan()))
    jmgr.save(1, {"state": {"w": jax.numpy.ones((4, 4))}, "data": None})
    with pytest.raises(Exception, match="allow_pickle=False"):
        jmgr.restore(1)


def test_manager_shards_balanced_and_all_read(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, runtime=_runtime(),
                            shards=3)
    mgr.save(1, {"state": _state(), "data": None})
    files = sorted(os.path.basename(p) for p in
                   glob.glob(str(tmp_path / "step_00000001" / "*.npz")))
    assert files == ["arrays.1.npz", "arrays.2.npz", "arrays.npz"]
    man = json.load(open(tmp_path / "step_00000001" / "manifest.json"))
    assert len(man["shards"]) == 3
    loads = [sum(e["nbytes"] for e in man["keys"] if e["shard"] == s)
             for s in range(3)]
    # greedy by bytes: the largest leaf alone, the rest beside it
    assert max(loads) == max(e["nbytes"] for e in man["keys"])
    _, payload = mgr.restore_latest()
    assert _bits(payload["state"]["params::w"]) == \
        _bits(_state()["params"]["w"])


def test_manager_async_save_overlaps_and_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, runtime=_runtime(),
                            async_saves=True)
    state = _state()
    mgr.save(1, {"state": state, "data": None})
    # the next "step" updates in place while the save may be writing: the
    # snapshot holds the values at save time
    state["params"]["w"].add_(1.0)
    mgr.save(2, {"state": state, "data": None})     # waits for save 1
    mgr.wait()
    assert not mgr.in_flight
    assert mgr.all_steps() == [1, 2]
    assert len(mgr.stats["encode_s"]) == len(mgr.stats["write_s"]) == 2
    _, first = mgr.restore(1)
    assert _bits(first["state"]["params::w"]) == \
        _bits(_state()["params"]["w"])
    assert mgr.restore_latest()[0] == 2


def test_manager_async_failure_surfaces_in_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2, runtime=_runtime(),
                            async_saves=True)
    monkeypatch.setattr(
        "repro_torch.train.checkpoint.os.replace",
        lambda *a: (_ for _ in ()).throw(OSError("disk gone")))
    mgr.save(1, {"state": _state(), "data": None})
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    mgr.wait()                                      # raised once


def test_legacy_manager_reads_tierless(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state()
    mgr.save(5, {"state": state, "data": None})
    state["params"]["w"].add_(1.0)          # the legacy copy is its own
    man_path = tmp_path / "step_00000005" / "manifest.json"
    man = json.load(open(man_path))
    assert man["codec"] == "none"
    del man["shards"]
    json.dump(man, open(man_path, "w"))
    step, payload = mgr.restore_latest()
    assert step == 5
    assert _bits(payload["state"]["params::w"]) == \
        _bits(_state()["params"]["w"])


def test_tierless_restore_decodes_codec_payloads(tmp_path):
    CheckpointManager(str(tmp_path), runtime=_runtime("fp8")).save(
        2, {"state": _state(), "data": None})
    _, want = CheckpointManager(str(tmp_path),
                                runtime=_runtime("fp8")).restore(2)
    _, got = CheckpointManager(str(tmp_path)).restore(2)
    for key in want["state"]:
        assert _bits(got["state"][key]) == _bits(want["state"][key]), key


def _two_checkpoints(d):
    mgr = CheckpointManager(d, keep=3, runtime=_runtime(), shards=2)
    mgr.save(1, {"state": _state(), "data": None})
    mgr.save(2, {"state": _state(), "data": None})
    return mgr


def test_restore_raises_on_corrupt_shard(tmp_path):
    mgr = _two_checkpoints(str(tmp_path))
    f = tmp_path / "step_00000002" / "arrays.1.npz"
    with open(f, "r+b") as fh:
        fh.seek(40)
        b = fh.read(1)
        fh.seek(40)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(CheckpointError, match="CRC mismatch"):
        mgr.restore(2)
    assert mgr.restore_latest()[0] == 1          # skips + warns


def test_restore_raises_on_missing_shard_or_leaf(tmp_path):
    mgr = _two_checkpoints(str(tmp_path))
    man_path = tmp_path / "step_00000001" / "manifest.json"
    man = json.load(open(man_path))
    man["keys"].append(dict(man["keys"][0], key="params::ghost"))
    json.dump(man, open(man_path, "w"))
    with pytest.raises(CheckpointError, match="'params::ghost' missing"):
        mgr.restore(1)
    os.remove(tmp_path / "step_00000002" / "arrays.npz")
    with pytest.raises(CheckpointError, match="arrays.npz missing"):
        mgr.restore(2)
    assert mgr.restore_latest() is None


def test_restore_raises_on_bad_manifest(tmp_path):
    mgr = _two_checkpoints(str(tmp_path))
    mpath = tmp_path / "step_00000002" / "manifest.json"
    mpath.write_text("{not json")
    with pytest.raises(CheckpointError, match="manifest.json unreadable"):
        mgr.restore(2)
    mpath.write_text("{}")
    with pytest.raises(CheckpointError, match="no key table"):
        mgr.restore(2)
    os.remove(mpath)
    with pytest.raises(CheckpointError, match="manifest.json missing"):
        mgr.restore(2)
    with pytest.raises(CheckpointError, match="no such checkpoint"):
        mgr.restore(42)
    assert mgr.restore_latest()[0] == 1


def test_crash_between_write_and_commit_preserves_previous(tmp_path,
                                                           monkeypatch):
    mgr = _two_checkpoints(str(tmp_path))
    monkeypatch.setattr(
        "repro_torch.train.checkpoint.os.replace",
        lambda *a: (_ for _ in ()).throw(OSError("power cut")))
    with pytest.raises(OSError, match="power cut"):
        mgr.save(3, {"state": _state(), "data": None})
    monkeypatch.undo()
    assert mgr.all_steps() == [1, 2]
    assert mgr.restore_latest()[0] == 2
    assert glob.glob(str(tmp_path / "tmp.*"))       # the wreck is on disk
    mgr.save(4, {"state": _state(), "data": None})
    assert not glob.glob(str(tmp_path / "tmp.*"))   # ...swept next save
    assert mgr.restore_latest()[0] == 4


def test_keep_k_garbage_collection(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, runtime=_runtime())
    for s in (1, 2, 3, 4):
        mgr.save(s, {"state": _state(), "data": None})
    assert mgr.all_steps() == [3, 4]


# ---------------------------------------------------------------------------
# (d) the on-disk format, both ways
@functools.lru_cache(maxsize=None)
def _jstate():
    """Reduced smollm-135m's train state in the reference (bf16 params,
    float32 moments, int32 counters), one step in so no moment is 0."""
    cfg = JARCHS["smollm-135m"].reduced()
    tc = JTrainConfig(total_steps=3, warmup_steps=1, learning_rate=3e-3)
    m = jbuild(JRunConfig(model=cfg, shape=JShapeConfig("t", 32, 2, "train"),
                          mesh=JPLAN1, memory=JMemoryPlan(policy="none"),
                          train=tc))
    from repro.train.loop import make_train_step as jmake_step
    state = jinit_state(m, tc)
    batch = JSyntheticLM(cfg, batch=2, seq=32, seed=0).batch_at(0)
    state, _ = jax.jit(jmake_step(m, tc))(
        state, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, state)


def _tstate():
    js = _jstate()
    return {"params": params_from_jax(js["params"], "cpu"),
            "opt": {k: params_from_jax(v, "cpu") if isinstance(v, dict)
                    else torch.from_numpy(np.array(v))
                    for k, v in js["opt"].items()},
            "step": torch.from_numpy(np.array(js["step"]))}


def _managers(d, codec):
    j = JManager(d, keep=2, shards=2, runtime=jmake_runtime(
        JCheckpointPlan(enabled=True, codec=codec), JPLAN1, JMemoryPlan()))
    t = CheckpointManager(d, keep=2, shards=2, runtime=_runtime(codec))
    return j, t


@pytest.mark.parametrize("codec", ["none", "fp8"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_cross_read_bit_exact(tmp_path, codec, writer):
    jmgr, tmgr = _managers(str(tmp_path), codec)
    data = {"step": 5, "seed": 0}
    if writer == "reference":
        jmgr.save(5, {"state": _jstate(), "data": data})
    else:
        tmgr.save(5, {"state": _tstate(), "data": data})
    jstep, jpay = jmgr.restore(5)
    tstep, tpay = tmgr.restore(5)
    assert jstep == tstep == 5 and jpay["data"] == tpay["data"] == data
    assert sorted(jpay["state"]) == sorted(tpay["state"])
    assert len(jpay["state"]) > 20
    for key, want in jpay["state"].items():
        got = tpay["state"][key]
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), key
        assert tuple(got.shape) == tuple(np.shape(want)), key
        assert _bits(got) == _bits(want), key
    man = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
    assert {e["payload_dtype"] for e in man["keys"]} == (
        {"bfloat16", "float32", "int32"} if codec == "none"
        else {"float8_e4m3fn", "int32"})
    if codec == "none":       # lossless: both restore the written state
        written = _flatten(_tstate())
        for key, want in written.items():
            assert _bits(tpay["state"][key]) == _bits(want), key


def test_cross_read_payloads_differ_only_in_scale_last_bit(tmp_path):
    """The two packages' fp8 snapshots of one state: codes equal wherever
    the scales are equal, scales at most one ulp apart (ROADMAP C2)."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _managers(jdir, "fp8")[0].save(1, {"state": _jstate(), "data": None})
    _managers(tdir, "fp8")[1].save(1, {"state": _tstate(), "data": None})
    raw = []
    for d in (jdir, tdir):
        arrays = {}
        for f in glob.glob(os.path.join(d, "step_00000001", "*.npz")):
            with np.load(f) as z:
                arrays.update({k: z[k] for k in z.files})
        raw.append(arrays)
    assert sorted(raw[0]) == sorted(raw[1])
    man = json.load(open(os.path.join(tdir, "step_00000001",
                                      "manifest.json")))
    scaled = [e["key"] for e in man["keys"] if "scale_dtype" in e]
    assert len(scaled) > 20
    for key in scaled:
        a, b = (np.asarray(r[key + "::scale"]).view(np.int32) for r in raw)
        assert abs(int(a) - int(b)) <= 1, key
        if a == b:
            assert raw[0][key].tobytes() == raw[1][key].tobytes(), key


# ---------------------------------------------------------------------------
# (e) the reference's chaos scenario, in the port
def _cfgs():
    return (JARCHS["smollm-135m"].reduced(dtype="float32"),
            TARCHS["smollm-135m"].reduced(dtype="float32"))


def _tcs(d, every):
    kw = dict(total_steps=10, warmup_steps=2, learning_rate=1e-2,
              checkpoint_every=every, log_every=1, checkpoint_dir=d)
    return JTrainConfig(**kw), TrainConfig(**kw)


def _jbuild(tc):
    return jbuild(JRunConfig(model=_cfgs()[0],
                             shape=JShapeConfig("t", 64, 4, "train"),
                             mesh=JPLAN1, memory=JMemoryPlan(policy="none"),
                             train=tc))


def _trun(tc):
    return RunConfig(model=_cfgs()[1], shape=ShapeConfig("t", 64, 4, "train"),
                     memory=MemoryPlan(policy="none"), train=tc)


def _stream():
    """The scenario's batches, prefetched: the loop takes tensors."""
    return Prefetcher(SyntheticLM(_cfgs()[1], 4, 64, seed=0), "cpu")


@pytest.fixture
def feed():
    """:func:`_stream` for a test, every stream closed after it."""
    made = []

    def make():
        made.append(_stream())
        return made[-1]
    yield make
    for data in made:
        data.close()


def _curve(sink):
    return {"on_log": lambda s, m: sink.append((s, m["loss"]))}


def _start_state(tm, tc):
    """The port's state from the reference's initial weights."""
    jm = _jbuild(_tcs("", 100)[0])
    params = jax.tree.map(np.asarray, jinit_state(jm, _tcs("", 100)[0])[
        "params"])
    return init_state(tm, tc, params=params_from_jax(params, "cpu"))


@functools.lru_cache(maxsize=None)
def _uninterrupted(tmp_root):
    """Both packages' uninterrupted 10-step curves (the port's final state
    too), from the reference's initial weights."""
    jcurve, tcurve = [], []
    jtc, ttc = _tcs(os.path.join(tmp_root, "jref"), 100)
    jtrain(_jbuild(jtc), jtc, iter(JSyntheticLM(_cfgs()[0], 4, 64, seed=0)),
           hooks=_curve(jcurve))
    tm = build_model(_trun(ttc), device="cpu")
    data = _stream()
    try:
        tstate, _ = train(tm, ttc, data, state=_start_state(tm, ttc),
                          hooks=_curve(tcurve))
    finally:
        data.close()
    return jcurve, tcurve, tstate


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    return _uninterrupted(str(tmp_path_factory.mktemp("uninterrupted")))


def test_uninterrupted_curve_matches_reference(uninterrupted):
    jcurve, tcurve, _ = uninterrupted
    assert [s for s, _ in jcurve] == [s for s, _ in tcurve] == \
        list(range(1, 11))
    for (s, jl), (_, tl) in zip(jcurve, tcurve):
        assert abs(tl - float(jl)) < LOSS_TOL, (s, tl, float(jl))


def test_chaos_run_resumes_bit_identical(tmp_path, uninterrupted, feed):
    _, ref_curve, ref_state = uninterrupted
    _, ttc = _tcs(str(tmp_path), 2)
    ckpt = CheckpointPlan(enabled=True, tier="host", codec="none", shards=2,
                          async_saves=True)
    monkey = chaos.ChaosMonkey(chaos.ChaosSchedule.parse(SCENARIO),
                               retries=2, backoff=0.0)
    part1, part2 = [], []
    m = build_model(_trun(ttc), device="cpu")
    mgr = make_manager(m, ttc, ckpt, monkey)
    train(m, ttc, feed(), state=_start_state(m, ttc),
          fault_handler=fault.FaultHandler(install_signals=False),
          ckpt=ckpt, chaos=monkey, mgr=mgr, hooks=_curve(part1))
    fired = monkey.summary()
    assert "kill@3,kill@3" in fired and "corrupt@4" in fired \
        and "preempt@7" in fired, fired
    assert [s for s, _ in part1] == list(range(1, 9))
    assert mgr.all_steps() == [4, 6, 8]
    with pytest.raises(CheckpointError, match="CRC mismatch"):
        mgr.restore(4)
    # a process restart: fresh model, manager and stream, restored from disk
    m2 = build_model(_trun(ttc), device="cpu")
    mgr2 = make_manager(m2, ttc, ckpt, None)
    state2, _ = train(m2, ttc, feed(),
                      fault_handler=fault.FaultHandler(install_signals=False),
                      ckpt=ckpt, mgr=mgr2, hooks=_curve(part2))
    assert mgr2.runtime.traffic_report()["ckpt_load"]["wire_bytes"] > 0
    assert [s for s, _ in part2] == [9, 10]
    ref = dict(ref_curve)
    for s, loss in part1 + part2:
        assert loss == ref[s], (s, loss, ref[s])        # bit-identical
    for key, leaf in _flatten(ref_state).items():
        assert _bits(leaf) == _bits(_flatten(state2)[key]), key


def test_resume_falls_back_past_a_corrupt_newest(tmp_path, uninterrupted,
                                                feed):
    _, ref_curve, ref_state = uninterrupted
    _, ttc = _tcs(str(tmp_path), 2)
    ckpt = CheckpointPlan(enabled=True, tier="host", shards=2)
    m = build_model(_trun(ttc), device="cpu")
    # the 10-step run, its stream ending after step 6
    train(m, ttc, itertools.islice(feed(), 6),
          state=_start_state(m, ttc), ckpt=ckpt)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]
    chaos.ChaosMonkey(chaos.ChaosSchedule.parse("corrupt@6:1")).after_save(
        6, str(tmp_path / "step_00000006"))
    resumed = []
    m2 = build_model(_trun(ttc), device="cpu")
    mgr = make_manager(m2, ttc, ckpt)
    state, _ = train(m2, ttc, feed(),
                     ckpt=ckpt, mgr=mgr, hooks=_curve(resumed))
    assert [s for s, _ in resumed] == list(range(5, 11))
    ref = dict(ref_curve)
    assert all(loss == ref[s] for s, loss in resumed), resumed
    for key, leaf in _flatten(ref_state).items():
        assert _bits(leaf) == _bits(_flatten(state)[key]), key


def test_stage_loss_unpipelined_both_packages(tmp_path, uninterrupted,
                                              feed):
    """``stage_loss`` on one device: each package rebuilds the model,
    restores the newest snapshot, rewinds the stream and replays; the
    curve after the replay is the uninterrupted one, bit for bit."""
    jref, tref_curve, _ = uninterrupted
    curves = {}
    for pkg in ("reference", "port"):
        d = str(tmp_path / pkg)
        jtc, ttc = _tcs(d, 2)
        sink = curves.setdefault(pkg, [])
        if pkg == "reference":
            cfg, mod = _cfgs()[0], jchaos
            monkey = mod.ChaosMonkey(mod.ChaosSchedule.parse("stage_loss@5"))
            run = JRunConfig(model=cfg, shape=JShapeConfig("t", 64, 4,
                                                           "train"),
                             mesh=JPLAN1, memory=JMemoryPlan(policy="none"),
                             train=jtc)
            m = jbuild(run)
            mgr = jmake_manager(m, jtc, None, monkey)
            elastic = JElastic(run, mgr)
            jtrain(m, jtc, JSyntheticLM(cfg, 4, 64, seed=0), chaos=monkey,
                   elastic=elastic, mgr=mgr, hooks=_curve(sink))
        else:
            monkey = chaos.ChaosMonkey(chaos.ChaosSchedule.parse(
                "stage_loss@5"))
            run = _trun(ttc)
            m = build_model(run, device="cpu")
            mgr = make_manager(m, ttc, None, monkey)
            elastic = ElasticController(run, mgr, device="cpu")
            train(m, ttc, feed(),
                  state=_start_state(m, ttc), chaos=monkey, elastic=elastic,
                  mgr=mgr, hooks=_curve(sink))
        assert elastic.recoveries == 1 and monkey.fired == ["stage_loss@5"]
    for pkg, ref in (("reference", jref), ("port", tref_curve)):
        # steps 1-5, then the replay from the snapshot at 4: 5-10
        assert [s for s, _ in curves[pkg]] == [1, 2, 3, 4, 5] + list(
            range(5, 11)), pkg
        want = dict(ref)
        assert all(float(loss) == float(want[s]) for s, loss in curves[pkg])


def test_elastic_pipelined_branch_names_a9():
    run = dataclasses.replace(_trun(TrainConfig()), pipeline=dataclasses.
                              replace(_trun(TrainConfig()).pipeline,
                                      enabled=True, n_stages=2))
    ctl = ElasticController(run, mgr=None, device="cpu")
    assert ctl.surviving_stages(0) == 1
    with pytest.raises(NotImplementedError, match="A9"):
        ctl._shrink_pipe_mesh(1, 0)


# ---------------------------------------------------------------------------
# (f) the CLI, the default directory, the data streams
def _cli(*args):
    return train_cli.main(["--arch", "smollm", "--smoke", "--device", "cpu",
                           "--log-every", "1", *args])


def test_cli_chaos_then_resume(tmp_path, monkeypatch):
    d = str(tmp_path)
    flags = ["--steps", "10", "--ckpt-dir", d, "--ckpt-tier", "host",
             "--ckpt-every", "2", "--ckpt-async", "--ckpt-shards", "2"]
    whole = _cli(*flags[:3], str(tmp_path / "whole"), *flags[4:])
    hurt = _cli(*flags, "--chaos", SCENARIO)
    assert hurt["chaos"].summary() == \
        "kill@3,kill@3,corrupt@4:arrays.1.npz,preempt@7"
    assert [h["step"] for h in hurt["history"]] == list(range(1, 9))
    drawn = []
    batch_at = SyntheticLM.batch_at
    monkeypatch.setattr(SyntheticLM, "batch_at", lambda self, t: (
        drawn.append(t), batch_at(self, t))[1])
    back = _cli(*flags)
    monkeypatch.undo()
    assert [h["step"] for h in back["history"]] == [9, 10]
    assert min(drawn) == 8          # the stream resumed, not replayed
    assert back["mgr"].runtime.traffic_report()["ckpt_load"]["calls"] > 0
    ref = {h["step"]: h["loss"] for h in whole["history"]}
    for h in hurt["history"] + back["history"]:
        assert h["loss"] == ref[h["step"]], h
    for key, leaf in _flatten(whole["state"]).items():
        assert _bits(leaf) == _bits(_flatten(back["state"])[key]), key
    assert whole["mgr"].stats["encode_s"] and whole["mgr"].stats["write_s"]


def test_cli_refuses_planner_cadence(tmp_path):
    with pytest.raises(SystemExit, match="A12"):
        _cli("--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-tier",
             "host")


def test_cli_refuses_mtbf_without_the_planner(tmp_path):
    """``--mtbf-steps`` feeds only the planner's cadence: set, it exits
    naming A12 instead of being ignored."""
    with pytest.raises(SystemExit, match="A12"):
        _cli("--steps", "2", "--ckpt-dir", str(tmp_path), "--ckpt-tier",
             "host", "--ckpt-every", "1", "--mtbf-steps", "500")
    assert not os.listdir(tmp_path)


def test_default_directory_different_archs_do_not_resume(tmp_path):
    """Two runs of different architectures one after the other in one
    directory (the default: the reference's ``/tmp/repro_ckpt``, the
    port's the same under ``$TMPDIR``; a private one here): the second
    raises on the first's keys, in the reference and in the port."""
    assert JTrainConfig().checkpoint_dir == "/tmp/repro_ckpt"
    assert train_cli.parse_args(["--arch", "smollm"]).ckpt_dir == \
        TrainConfig().checkpoint_dir == \
        os.path.join(tempfile.gettempdir(), "repro_ckpt")
    d = str(tmp_path / "port")
    _cli("--steps", "2", "--ckpt-dir", d, "--ckpt-tier", "host",
         "--ckpt-every", "1")
    with pytest.raises(KeyError):
        train_cli.main(["--arch", "mamba2-370m", "--smoke", "--device",
                        "cpu", "--steps", "2", "--ckpt-dir", d])
    d = str(tmp_path / "reference")
    for arch, exc in (("smollm-135m", None), ("mamba2-370m", KeyError)):
        cfg = JARCHS[arch].reduced()
        tc = JTrainConfig(total_steps=2, warmup_steps=1, checkpoint_every=1,
                          log_every=1, checkpoint_dir=d)
        m = jbuild(JRunConfig(model=cfg, shape=JShapeConfig("t", 32, 2,
                                                            "train"),
                              mesh=JPLAN1, memory=JMemoryPlan(policy="none"),
                              train=tc))
        run = lambda: jtrain(m, tc, iter(JSyntheticLM(cfg, 2, 32)))  # noqa
        if exc is None:
            run()
        else:
            with pytest.raises(exc):
                run()


def test_to_device_refuses_a_wrong_shape():
    tm = build_model(_trun(TrainConfig()), device="cpu")
    template = state_template(tm, TrainConfig())
    flat = _flatten(init_state(tm, TrainConfig()))
    key = next(k for k in flat if k.startswith("params::"))
    flat[key] = flat[key][..., :1]
    with pytest.raises(ValueError, match="shape"):
        to_device(flat, template, "cpu")
    del flat[key]
    with pytest.raises(KeyError, match=key):
        to_device(flat, template, "cpu")


@pytest.mark.parametrize("opt_bits", [32, 8])
def test_state_template_matches_init_state(opt_bits):
    tc = TrainConfig(seed=3)
    run = _trun(tc)
    tm = build_model(dataclasses.replace(run, memory=dataclasses.replace(
        run.memory, opt_state_bits=opt_bits)), device="cpu")
    want = _flatten(init_state(tm, tc))
    got = _flatten(state_template(tm, tc))
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        t = got[key]
        assert t.device.type == "meta", key
        assert (t.shape, t.dtype, t.requires_grad) == \
            (leaf.shape, leaf.dtype, leaf.requires_grad), key


@pytest.mark.parametrize("kind", ["synthetic", "memmap"])
def test_stream_state_matches_reference(tmp_path, kind):
    cfg, jcfg = TARCHS["smollm-135m"].reduced(), JARCHS["smollm-135m"]\
        .reduced()
    if kind == "memmap":
        path = str(tmp_path / "tokens.bin")
        np.arange(5000, dtype=np.int32).tofile(path)
        src, jsrc = MemmapTokens(path, cfg, 2, 16, seed=4), \
            JMemmapTokens(path, jcfg, 2, 16, seed=4)
    else:
        src, jsrc = SyntheticLM(cfg, 2, 16, seed=4), \
            JSyntheticLM(jcfg, 2, 16, seed=4)
    for s in (src, jsrc):
        it = iter(s)
        for _ in range(3):
            next(it)
    assert src.get_state() == jsrc.get_state() == {"step": 3, "seed": 4}
    src.set_state({"step": 7, "seed": 1})
    jsrc.set_state({"step": 7, "seed": 1})
    (t, got), (jt, want) = next(iter(src)), next(iter(jsrc))
    assert t == jt == 7
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_prefetcher_state_is_the_consumers():
    src = SyntheticLM(TARCHS["smollm-135m"].reduced(), 2, 16, seed=0)
    data = Prefetcher(src, "cpu", depth=3)
    try:
        it = iter(data)
        assert [next(it)[0] for _ in range(2)] == [0, 1]
        assert data.get_state() == {"step": 2, "seed": 0}   # not lookahead
        data.set_state({"step": 5, "seed": 0})
        t, batch = next(it)
        assert t == 5 and data.get_state()["step"] == 6
        want = src.batch_at(5)
        assert batch["tokens"].numpy().tobytes() == \
            want["tokens"].astype(np.int64).tobytes()
    finally:
        data.close()
