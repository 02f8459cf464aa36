"""The serving slice of the port against the JAX reference, on the CPU.

Weights come from the reference's ``Model.init(PRNGKey(0))`` on
``smollm_135m.reduced(dtype="float32")`` and are carried over with
``repro_torch.convert.params_from_jax``.  Greedy token streams must be
bit-identical; logits agree to float32 rounding.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan, MeshPlan, RunConfig
from repro.configs.base import ShapeConfig
from repro.kernels import ops as jops
from repro.models.model import build_model as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.quota import TenantQuota as JQuota
from repro.serve.scheduler import FairScheduler as JFair
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import TenantQuota
from repro_torch.serve.scheduler import FairScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 on both sides, matmuls summed in different orders: logits of
# O(1) agree to a few float32 ulps accumulated over the 2-layer stack
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    cfg = JARCHS["smollm-135m"].reduced(dtype="float32")
    run = RunConfig(model=cfg, shape=ShapeConfig("t", 64, 2, "decode"),
                    mesh=MeshPlan((1,), ("data",)),
                    memory=MemoryPlan(policy="none"))
    jm = jbuild(run)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(TARCHS["smollm-135m"].reduced(dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _streams(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, **kw)
    for uid, prompt, n in reqs:
        eng.submit(request_cls(uid=uid, prompt=prompt, max_new_tokens=n))
    done = sorted(eng.run(), key=lambda r: r.uid)
    return [r.out_tokens for r in done], eng.traffic_report()


def _jax_streams(jm, jp, reqs, decode_kernel=False, **kw):
    """The reference engine; its in-place kernel path runs the XLA twin of
    the Pallas kernel (as the reference's own stream tests do)."""
    if decode_kernel:
        jops.set_paged_impl("xla")
    try:
        return _streams(JEngine, JRequest, jm, jp, reqs,
                        decode_kernel=decode_kernel, **kw)
    finally:
        jops.set_paged_impl("pallas")


def test_configs_match_reference():
    assert sorted(JARCHS) == sorted(TARCHS)
    for name, cfg in JARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(TARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(TARCHS[name].reduced())


def test_param_tree_layout(models):
    jm, jp, tm, tp = models
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    init = tm.init(0)
    for path, leaf in jleaves:
        t, i = tp, init
        for k in path:
            t, i = t[k.key], i[k.key]
        assert tuple(t.shape) == leaf.shape == tuple(i.shape), path
        assert i.dtype == t.dtype, path


def test_prefill_logits_match(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(2, 11)).astype(np.int32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    jl, _ = jm.prefill(jp, {"tokens": jax.numpy.asarray(toks),
                            "positions": jax.numpy.asarray(pos)},
                       jm.init_cache(2, 16))
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                            "positions": torch.from_numpy(pos.copy()).long()},
                       tm.init_cache(2, 16))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def _mixed_requests():
    return [(0, np.arange(5, dtype=np.int32) + 1, 6),
            (1, (np.arange(9, dtype=np.int32) * 3 + 2) % 512, 6),
            (2, np.arange(11, dtype=np.int32) % 512, 4)]


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_paged_streams_match_reference(models, decode_kernel):
    """Mixed-length concurrent sessions at page_size=8: the same greedy
    streams as the reference engine, in-place kernel path and gather
    path."""
    jm, jp, tm, tp = models
    kw = dict(batch=2, max_len=64, page_size=8, decode_kernel=decode_kernel)
    want, _ = _jax_streams(jm, jp, _mixed_requests(), **kw)
    got, report = _streams(Engine, Request, tm, tp, _mixed_requests(), **kw)
    assert got == want
    io = report["decode_io"]
    assert io["in_place"] == decode_kernel and io["steps"] > 0


@pytest.mark.parametrize("codec", ["int8", "fp8", "blocksparse"])
def test_eviction_streams_and_traffic_match_reference(models, codec):
    """An overcommitted pool (46 page evictions) with a tenant codec under
    fair preemption, every codec through its pack/unpack kernels: the
    in-place kernel path (cold int8-payload pages resume compressed-
    resident) streams exactly what the inflate path does, in the port and
    in the reference, and meters the same bytes and page counters."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=(10,)).astype(np.int32), 10)
            for i in range(4)]
    kw = dict(batch=2, max_len=32, page_size=4, pages=10, spill="host")
    want, jrep = _jax_streams(jm, jp, reqs, scheduler=JFair(quantum=3),
                              quota=JQuota(codec=codec), **kw)
    off, trep = _streams(Engine, Request, tm, tp, reqs,
                         scheduler=FairScheduler(quantum=3),
                         quota=TenantQuota(codec=codec), **kw)
    on, krep = _streams(Engine, Request, tm, tp, reqs,
                        scheduler=FairScheduler(quantum=3),
                        quota=TenantQuota(codec=codec), decode_kernel=True,
                        **kw)
    assert off == want
    assert on == want
    assert jrep["pages"]["evictions"] > 0
    # only int8 payloads fit the side pool the decode kernel reads
    assert (krep["decode_io"]["compressed_adopts"] > 0) == (codec != "fp8")
    for key in ("kv_stash", "kv_fetch", "pages", "decode_io", "tier"):
        assert trep[key] == jrep[key], key
    assert krep["kv_stash"] == jrep["kv_stash"]
    assert krep["pages"] == jrep["pages"]


def test_unpaged_preemption_streams_match_reference(models):
    """Monolithic slots spilled whole under fair preemption."""
    jm, jp, tm, tp = models
    reqs = [(i, np.arange(4 + i, dtype=np.int32) + 2 * i, 6)
            for i in range(3)]
    kw = dict(batch=1, max_len=32, spill="spill")
    want, jrep = _streams(JEngine, JRequest, jm, jp, reqs,
                          scheduler=JFair(quantum=2), **kw)
    got, trep = _streams(Engine, Request, tm, tp, reqs,
                         scheduler=FairScheduler(quantum=2), **kw)
    assert got == want
    assert trep["kv_stash"] == jrep["kv_stash"]
    assert trep["kv_fetch"] == jrep["kv_fetch"]


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(TARCHS["smollm-135m"].reduced(), device="cuda")


def test_prefix_share_not_ported(models):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError):
        Engine(tm, tp, batch=1, max_len=16, page_size=8, prefix_share=True)


def test_serve_cli_smoke():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm", "--smoke", "--device", "cpu", "--page-size", "8",
         "--decode-kernel", "--requests", "4", "--new-tokens", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 4 requests, 32 tokens" in proc.stdout
    assert "decode_io[in-place]" in proc.stdout
