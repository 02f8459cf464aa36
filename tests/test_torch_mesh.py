"""The port's sharded training step on a device mesh, on the CPU.

Four gloo ranks in subprocesses form a (2, 2) ``("data", "model")`` mesh
and train ``.reduced()`` configurations in float32: each rank holds the
shards of the state its specs name and its rows of every global batch.
Their loss, every gradient leaf (gathered whole) and the state after one
AdamW step are held to the one-device port step on the same weights and
batch (which ``tests/test_torch_train.py`` holds to the reference) over
the policies ``none`` / ``host`` / ``mcdla`` (and a half-stashed run),
the placements ``bw_aware`` / ``local``, the stash codecs ``none`` /
``fp8``, smollm, mamba2 and zamba2 (the shared block), 32- and 8-bit
moments, ``grad_accum`` 2 and the int8 error-feedback residual.  Each
rank's pooled stash bytes are a quarter of the one-device run's.  The
spec tables (``param_specs``, ``cache_specs``, ``opt_state_specs``,
``batch_specs``, ``pool_spec``) equal the reference's for all ten
configurations on the single-pod, multi-pod and (2, 2) plans, with the
planner's fallbacks.  Then the ``torchrun`` command line over four CPU
ranks, and what a mesh refuses, each naming its ROADMAP item.

The one-device reference runs in this process; the ranks run all cases in
one spawn, each rank under a subprocess timeout and its process group
under a collective timeout, so a hang fails these tests and no other.
"""
import functools
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import RunConfig as JRunConfig
from repro.configs.base import HOST_TEST as JHOST_TEST
from repro.configs.base import MULTI_POD as JMULTI_POD
from repro.configs.base import SINGLE_POD as JSINGLE_POD
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.core.pool import pool_spec as jpool_spec
from repro.models import transformer as jtfm
from repro.models.model import build_model as jbuild
from repro.parallel import sharding as jsharding
from repro.train.optimizer import opt_state_specs as jopt_specs
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import MemoryPlan, RunConfig, TrainConfig
from repro_torch.configs.base import (HOST_TEST, MULTI_POD, SHAPES_BY_NAME,
                                      SINGLE_POD, ShapeConfig)
from repro_torch.core.pool import pool_spec
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as ttfm
from repro_torch.models.model import Model, build_model
from repro_torch.parallel import sharding as tsharding
from repro_torch.train.loop import grads_of, make_train_step
from repro_torch.train.optimizer import opt_state_specs
from repro_torch.train.train_state import init_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
RANKS = 4
SPAWN_S = 300                 # the ranks' subprocess timeout
# float32 on both sides, the batch's rows summed in another order: the
# loss and the gradients agree to a few f32 ulps of their scale (the same
# limits as tests/test_torch_train.py's, one-device against the
# reference)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5
# the state after one AdamW step: the reference's own limits for its
# sharded step against its one-device step
# (tests/multidev/sharded_train_equiv.py); Adam's first update is about
# sign(g), so a gradient near 0 moves by up to lr on rounding alone
PARAM_RTOL, PARAM_ATOL = 2e-2, 2e-4
BATCH, SEQ = 8, 32

#: name -> (arch, memory plan, train config overrides, stash groups)
CASES = {
    "none": ("smollm-135m", dict(policy="none"), {}, None),
    "host": ("smollm-135m", dict(policy="host"), {}, None),
    "host_fp8": ("smollm-135m", dict(policy="host", compress="fp8"), {},
                 None),
    "mcdla_bw": ("smollm-135m", dict(policy="mcdla"), {}, None),
    "mcdla_bw_fp8": ("smollm-135m", dict(policy="mcdla", compress="fp8"),
                     {}, None),
    "mcdla_local": ("smollm-135m", dict(policy="mcdla", placement="local"),
                    {}, None),
    "mcdla_local_fp8": ("smollm-135m", dict(policy="mcdla",
                                            placement="local",
                                            compress="fp8"), {}, None),
    # the first layer group stashed, the second bare (auto's split)
    "mcdla_half": ("smollm-135m", dict(policy="mcdla", compress="fp8"), {},
                   1),
    "opt8": ("smollm-135m", dict(policy="mcdla", compress="fp8",
                                 opt_state_bits=8), {}, None),
    "accum2": ("smollm-135m", dict(policy="mcdla", compress="fp8"),
               dict(grad_accum=2), None),
    "ef_int8": ("smollm-135m", dict(policy="mcdla"),
                dict(grad_compress="int8"), None),
    "mamba2_fp8": ("mamba2-370m", dict(policy="mcdla", compress="fp8"), {},
                   None),
    "zamba2_fp8": ("zamba2-2.7b", dict(policy="mcdla", compress="fp8"), {},
                   None),
    "zamba2_host": ("zamba2-2.7b", dict(policy="host"), {}, None),
}
#: configurations a mesh refuses, and the ROADMAP item each names
REFUSED = {"mixtral-8x7b": "A9", "whisper-medium": "A8b",
           "qwen2-vl-2b": "A8b"}


def _run(name):
    """(model config, RunConfig, TrainConfig, stash groups) of a case."""
    arch, mem, tc_kw, stash = CASES[name]
    cfg = TARCHS[arch].reduced(dtype="float32")
    tc = TrainConfig(total_steps=10, warmup_steps=1, learning_rate=1e-2,
                     seed=0, **tc_kw)
    run = RunConfig(model=cfg, shape=ShapeConfig("t", SEQ, BATCH, "train"),
                    mesh=HOST_TEST, memory=MemoryPlan(**mem), train=tc)
    return cfg, run, tc, stash


def _batch(cfg):
    return to_device(SyntheticLM(cfg, batch=BATCH, seq=SEQ,
                                 seed=0).batch_at(0), "cpu")


_RANK = r"""
import datetime, json, os, sys
import torch, torch.distributed as dist
from repro_torch import tree
from repro_torch.configs import ARCHS, MemoryPlan, RunConfig, TrainConfig
from repro_torch.configs.base import HOST_TEST, ShapeConfig
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, build_model
from repro_torch.parallel.sharding import PartitionSpec, constrain, local_shape
from repro_torch.train.loop import grads_of, make_train_step
from repro_torch.train.train_state import init_state, state_specs
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
with open(os.path.join(out, "cases.json")) as f:
    spec = json.load(f)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=spec["ranks"], rank=rank,
                        timeout=datetime.timedelta(seconds=120))
mesh = make_host_mesh(spec["ranks"])
B, S = spec["batch"], spec["seq"]


def case_run(arch, mem, tc_kw):
    cfg = ARCHS[arch].reduced(dtype="float32")
    tc = TrainConfig(total_steps=10, warmup_steps=1, learning_rate=1e-2,
                     seed=0, **tc_kw)
    return cfg, tc, RunConfig(model=cfg, shape=ShapeConfig("t", S, B, "train"),
                              mesh=HOST_TEST, memory=MemoryPlan(**mem),
                              train=tc)


def whole(t, sp):
    return constrain(t, mesh, PartitionSpec(), src=sp)


checks, refused = {}, {}
for name, (arch, mem, tc_kw, stash) in sorted(spec["cases"].items()):
    cfg, tc, run = case_run(arch, mem, tc_kw)
    model = build_model(run, device="cpu", mesh=mesh)
    if stash is not None:
        model.stash_groups = stash
    batch = to_device(SyntheticLM(cfg, batch=B, seq=S, seed=0).batch_at(0),
                      "cpu")
    state = init_state(model, tc)
    specs = state_specs(model, tc)
    one = Model(cfg=cfg, memory=model.memory, device="cpu")
    meta = init_state(one, tc, params=tfm.init_params(
        torch.Generator().manual_seed(0), cfg, one.dtype, "meta"))
    shapes_ok = all(tuple(t.shape) == local_shape(g.shape, sp, mesh)
                    for t, g, sp in zip(tree.leaves(state), tree.leaves(meta),
                                        tree.leaves(specs)))
    g, loss, metrics = grads_of(model, tc, state["params"], batch)
    grads = tree.map(whole, g, specs["params"])
    model.runtime.reset_traffic()
    state, m = make_train_step(model, tc)(state, batch)
    after = tree.map(whole, tree.map(lambda t: t.detach(), state), specs)
    traffic = model.runtime.traffic_report()
    checks[name] = dict(shapes_ok=shapes_ok,
                        stash=traffic.get("stash", {}).get("raw_bytes", 0.0),
                        fetch=traffic.get("fetch", {}).get("raw_bytes", 0.0))
    if rank == 0:
        torch.save(dict(loss=loss, metrics=metrics, grads=grads,
                        step_metrics=m, state=after),
                   os.path.join(out, name + ".pt"))
for arch in spec["refused"]:
    cfg, tc, run = case_run(arch, {"policy": "none"}, {})
    try:
        build_model(run, device="cpu", mesh=mesh)
        refused[arch] = ""
    except NotImplementedError as e:
        refused[arch] = str(e)
with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
    json.dump(dict(checks=checks, refused=refused), f)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(code: str, out: str, n: int = RANKS,
                timeout: float = SPAWN_S):
    """Run ``code`` as ``n`` ranks (``argv``: rank, a free port, ``out``),
    each killed at the shared deadline; every rank must exit 0."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(port), out], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(dict(ranks=RANKS, batch=BATCH, seq=SEQ, cases=CASES,
                       refused=sorted(REFUSED)), f)
    spawn_ranks(_RANK, out)
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return out, ranks


@functools.lru_cache(maxsize=None)
def _one_device(name):
    """The one-device port step of a case: (loss, metrics, grads, step
    metrics, state after the step, the runtime's traffic of the step).
    On one thread: the reduced model is small, and beside the suite's
    other workers a thread team only waits for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _one_device_step(name)
    finally:
        torch.set_num_threads(threads)


def _one_device_step(name):
    cfg, run, tc, stash = _run(name)
    model = build_model(run, device="cpu")
    if stash is not None:
        model.stash_groups = stash
    batch = _batch(cfg)
    state = init_state(model, tc)
    g, loss, metrics = grads_of(model, tc, state["params"], batch)
    model.runtime.reset_traffic()
    state, m = make_train_step(model, tc)(state, batch)
    return (loss, metrics, g, m, tree.map(lambda t: t.detach(), state),
            model.runtime.traffic_report())


def _close(got, want, tol, what):
    for (g, path), w in zip(zip(*tree.flatten(got)), tree.leaves(want)):
        scale = float(w.float().abs().max()) or 1.0
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * scale, (what, path, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_equals_one_device_step(mesh_run, case):
    out, ranks = mesh_run
    got = torch.load(os.path.join(out, case + ".pt"))
    loss, metrics, grads, m, state, _ = _one_device(case)
    np.testing.assert_allclose(float(got["loss"]), float(loss),
                               rtol=LOSS_RTOL)
    for k in ("loss", "tokens"):
        np.testing.assert_allclose(float(got["metrics"][k]),
                                   float(metrics[k]), rtol=LOSS_RTOL)
    _close(got["grads"], grads, GRAD_TOL, "gradient")
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got["step_metrics"][k]),
                                   float(m[k]), rtol=LOSS_RTOL)
    sharded = got["state"]
    assert sorted(sharded) == sorted(state)
    for (g, path), w in zip(zip(*tree.flatten(sharded["params"])),
                            tree.leaves(state["params"])):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=str(path))
    if CASES[case][1].get("opt_state_bits", 32) == 32:
        # m is 0.1 x the clipped gradient, v 0.001 x its square: twice
        # the gradient's relative error
        _close(sharded["opt"]["m"], state["opt"]["m"], GRAD_TOL, "m")
        _close(sharded["opt"]["v"], state["opt"]["v"], 2 * GRAD_TOL, "v")
    else:
        # the codes of every row (its absmax or log range over the whole
        # row, sharded or not) within one code of the one-device run's
        for (g, path), w in zip(zip(*tree.flatten(sharded["opt"])),
                                tree.leaves(state["opt"])):
            if path[-1] == "q":
                assert (g.int() - w.int()).abs().max() <= 1, path
            elif path[-1] == "lo":
                # the log of the row's smallest second moment: its
                # rounding is that of the row's smallest gradient, which
                # the leaf's scale does not bound; a rank's half row would
                # move it by a share of the row's log range
                np.testing.assert_allclose(g.numpy(), w.numpy(),
                                           rtol=1e-3, err_msg=str(path))
            elif g.is_floating_point():
                np.testing.assert_allclose(g.numpy(), w.numpy(),
                                           rtol=1e-4, err_msg=str(path))
    if "ef_err" in state:
        # carried unchanged by the step: zeros, float32, the parameters'
        # shapes (ROADMAP C16)
        for g, w in zip(tree.leaves(sharded["ef_err"]),
                        tree.leaves(state["params"])):
            assert g.dtype == torch.float32 and g.shape == w.shape
            assert not g.any()
    assert all(r["checks"][case]["shapes_ok"] for r in ranks), \
        "a rank's state leaf is not its shard's local shape"


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c][1]["policy"] == "mcdla"))
def test_pooled_bytes_are_a_quarter_per_rank(mesh_run, case):
    """Each rank's pooled stash (and fetch) bytes are 1/4 of the
    one-device run's: the global batch over the data ranks, each data
    rank's rows or sequence over the pool's model ranks."""
    _, ranks = mesh_run
    traffic = _one_device(case)[-1]
    for d in ("stash", "fetch"):
        want = traffic[d]["raw_bytes"]
        assert want > 0
        for r in ranks:
            assert r["checks"][case][d] * RANKS == want, (d, r["checks"])


def test_unsupported_configurations_refuse_a_mesh(mesh_run):
    _, ranks = mesh_run
    for r in ranks:
        for arch, item in REFUSED.items():
            assert f"ROADMAP {item}" in r["refused"][arch], (arch, r)


# ---------------------------------------------------------------------------
# the spec tables against the reference's
PLANS = {"single_pod": (JSINGLE_POD, SINGLE_POD),
         "multi_pod": (JMULTI_POD, MULTI_POD),
         "host_test": (JHOST_TEST, HOST_TEST)}
# (batch, seq) of the caches: a decode cell and an odd batch
CACHE_SHAPES = [(128, 32768), (3, 1000)]
# (shape, batch_dim) of stashes: a residual, a non-divisible batch, an
# aux without a batch dim
POOL_SHAPES = [((256, 4096, 576), 0), ((6, 4096, 1024), 0),
               ((3, 1500, 1024), 0), ((4096, 1024), None)]


def _tuples(specs):
    return tree.map(tuple, specs)


def _jtuples(specs):
    """The reference's spec tree as nested dicts of tuples."""
    if isinstance(specs, dict):
        return {k: _jtuples(v) for k, v in specs.items()}
    return tuple(specs)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_spec_tables_equal_the_reference(arch, plan):
    jplan, tplan = PLANS[plan]
    jmodel = jbuild(JRunConfig(model=JARCHS[arch], shape=JSHAPES["train_4k"],
                               mesh=jplan,
                               memory=JMemoryPlan(policy="none")))
    tmodel = Model(cfg=TARCHS[arch], plan=tplan, device="cpu")
    jp, tp = jmodel.planner, tmodel.planner
    jspecs, tspecs = jmodel.param_specs(), tmodel.param_specs()
    assert _tuples(tspecs) == _jtuples(jspecs)
    for bits in (32, 8):
        assert _tuples(opt_state_specs(tspecs, bits)) == \
            _jtuples(jopt_specs(jspecs, bits))
    for b, s in CACHE_SHAPES:
        assert _tuples(tmodel.cache_specs(b, s)) == \
            _jtuples(jmodel.cache_specs(b, s))
    for name in ("train_4k", "decode_32k"):
        assert _tuples(tmodel.batch_specs(SHAPES_BY_NAME[name])) == \
            _jtuples(jmodel.batch_specs(JSHAPES[name]))
    for shape, bdim in POOL_SHAPES:
        for placement in ("bw_aware", "local"):
            assert tuple(pool_spec(shape, tp, placement, bdim)) == tuple(
                jpool_spec(shape, jp, placement, bdim))
    assert tp.fallbacks == jp.fallbacks


# ---------------------------------------------------------------------------
# the command line
def test_torchrun_cli_over_four_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(RANKS), "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.train", "--arch", "smollm", "--smoke",
         "--device", "cpu", "--policy", "mcdla", "--compress", "fp8",
         "--steps", "3", "--log-every", "1"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=SPAWN_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "mesh: (2, 2) over ('data', 'model'), 4 ranks; backend gloo" \
        in out, out
    assert out.count("step ") == 3, out     # rank 0 logs, the others not
    line = next(x for x in out.splitlines()
                if x.startswith("pool traffic per rank:"))
    # smoke: 4 x 128 tokens of d_model 128 in bf16, 2 layers, 3 steps;
    # a quarter a rank, half of that on the wire (fp8)
    raw = 4 * 128 * 128 * 2 * 2 * 3 / RANKS
    assert f"of {raw / 1e3:.2f}KB raw" in line, line
    assert not os.listdir(tmp_path)          # no checkpoint written


@pytest.mark.parametrize("argv,item", [
    (["--ckpt-tier", "host"], "A8b"),
    (["--ckpt-every", "2"], "A8b"),
    (["--chaos", "kill@2"], "A8b"),
])
def test_train_cli_refuses_checkpoints_on_a_mesh(monkeypatch, argv, item):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match=item):
        train_cli.main(["--arch", "smollm", "--smoke", "--device", "cpu"]
                       + argv)


def test_multi_pod_needs_512_ranks_and_serving_refuses_a_mesh(monkeypatch):
    with pytest.raises(SystemExit, match="512 ranks.*A8b"):
        train_cli.main(["--arch", "smollm", "--device", "cpu",
                        "--multi-pod"])
    with pytest.raises(SystemExit, match="A8b"):
        serve_cli.main(["--arch", "smollm", "--smoke", "--device", "cpu",
                        "--multi-pod"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="A8b"):
        serve_cli.main(["--arch", "smollm", "--smoke", "--device", "cpu"])
