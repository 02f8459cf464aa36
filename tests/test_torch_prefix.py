"""Prefix-sharing paged serving of the port against the JAX reference, on
the CPU.

The scenarios are the reference's (``tests/test_paging.py``, the prefix
sharing section) run in float32: weights from the reference's
``Model.init(PRNGKey(0))`` on ``.reduced(dtype="float32")`` configurations,
carried over with ``repro_torch.convert.params_from_jax``.  Prefix sharing
is a pure storage change, so greedy streams must equal the sharing-off and
the solo streams bit for bit, and the reference's.  Only in float32: in
bfloat16 a suffix prefill (``prefix_prefill_attention`` over the grafted
rows) and a whole-prompt prefill (``blockwise_attention``) round
differently, and the reference's own streams leave the solo streams under
eviction pressure (ROADMAP C8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan, RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.compress import decode_tensor as jdecode
from repro.core.compress import encode_tensor as jencode
from repro.core.compress import get_codec as jget_codec
from repro.kernels import ops as jops
from repro.models.attention import prefix_prefill_attention as jprefix_attn
from repro.models.model import build_model as jbuild
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro.serve.quota import TenantQuota as JQuota
from repro.serve.scheduler import FairScheduler as JFair
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import prefix_prefill_attention
from repro_torch.models.model import Model
from repro_torch.serve.cache_manager import PagedKVCacheManager
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paging import SharedPayload
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.scheduler import FairScheduler
from repro_torch.serve.session import Session

# float32 on both sides, products summed in different orders
ATTN_TOL = 1e-5


def _pair(arch):
    """(reference model, its params, port model, the same params)."""
    cfg = JARCHS[arch].reduced(dtype="float32")
    run = JRunConfig(model=cfg, shape=JShapeConfig("t", 64, 2, "decode"),
                     mesh=MeshPlan((1,), ("data",)),
                     memory=JMemoryPlan(policy="none"))
    jm = jbuild(run)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(TARCHS[arch].reduced(dtype="float32"), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def smollm():
    return _pair("smollm-135m")


@pytest.fixture(scope="module")
def danube():
    return _pair("h2o-danube-1.8b")


def _prompts(vocab, n=4, head_len=20, tail_len=12):
    """The reference's scenario: the head crosses one full page of 16 and
    diverges inside the second (row 20 of 16..31): a hit on page 0, a
    fork of page 1."""
    head = (np.arange(head_len, dtype=np.int32) * 3 + 5) % vocab
    return [np.concatenate([
        head, (np.arange(tail_len, dtype=np.int32) * (i + 2) + i) % vocab
    ]).astype(np.int32) for i in range(n)]


def _run(eng, prompts, n_new=6, each_step=None):
    """Serve ``prompts`` on either package's engine; the streams in order.
    ``each_step(eng)`` runs after every engine step."""
    request = JRequest if isinstance(eng, JEngine) else Request
    ss = [eng.submit(request(uid=i, prompt=p, max_new_tokens=n_new))
          for i, p in enumerate(prompts)]
    if each_step is None:
        eng.run()
    else:
        while eng.step() or eng.scheduler.has_waiting():
            each_step(eng)
    return [s.result() for s in ss]


def _jax_engine(jm, jp, decode_kernel=False, **kw):
    # the reference's in-place path on its XLA twin, as its own stream
    # tests run it on the CPU
    if decode_kernel:
        jops.set_paged_impl("xla")
    return JEngine(jm, jp, decode_kernel=decode_kernel, **kw)


@pytest.fixture(autouse=True)
def _pallas_paged_impl():
    yield
    jops.set_paged_impl("pallas")


def _solo(model, params, prompts, n_new=6, max_len=64):
    cls = JEngine if not isinstance(model, Model) else Engine
    out = []
    for p in prompts:
        eng = cls(model, params, batch=1, max_len=max_len)
        out += _run(eng, [p], n_new)
    return out


# ---------------------------------------------------------------------------
# the suffix prefill's attention
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 0.0), (0, 30.0),
                                            (6, 30.0)])
def test_prefix_prefill_attention_matches_reference(window, softcap):
    """Random q / caches, GQA (4 heads over 2), suffix positions inside a
    longer cache; one batch row padded (position -1: every row masked)
    must stay finite, the others agree with the reference."""
    rng = np.random.default_rng(7)
    B, S2, T, H, K, d = 2, 5, 24, 4, 2, 16
    q = rng.standard_normal((B, S2, H, d)).astype(np.float32)
    k = rng.standard_normal((B, T, K, d)).astype(np.float32)
    v = rng.standard_normal((B, T, K, d)).astype(np.float32)
    pos = np.stack([np.arange(11, 11 + S2), np.full(S2, -1)]).astype(
        np.int32)
    want = np.asarray(jprefix_attn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   window=window, softcap=softcap))
    got = prefix_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos).long(), window=window, softcap=softcap)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=ATTN_TOL,
                               atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# streams: sharing on == sharing off == solo == the reference
@pytest.mark.parametrize("decode_kernel", [False, True])
def test_streams_identical_and_hit(smollm, decode_kernel):
    jm, jp, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size)
    want = _solo(tm, tp, prompts)
    assert _solo(jm, jp, prompts) == want
    kw = dict(batch=2, max_len=64, spill="host", page_size=16,
              decode_kernel=decode_kernel)
    base = _run(Engine(tm, tp, **kw), prompts)
    eng = Engine(tm, tp, prefix_share=True, **kw)
    got = _run(eng, prompts)
    jeng = _jax_engine(jm, jp, prefix_share=True, **kw)
    ref = _run(jeng, prompts)
    assert got == want and base == want and ref == want
    rep = eng.traffic_report()["prefix"]
    assert rep["enabled"] and rep["hits"] > 0 and rep["forks"] > 0
    assert rep["hit_rate"] > 0
    assert eng.cache.table.shared_binds > 0
    assert rep == jeng.traffic_report()["prefix"]
    eng.cache.table.check()


def test_streams_equal_solo_under_eviction_pressure(smollm):
    """The reference's eviction-pressure scenario (4 pages of 16, fair
    preemption every 2 tokens) in float32: shared pages spill once and
    re-home on one fetch without moving a stream."""
    jm, jp, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size)
    want = _solo(tm, tp, prompts)
    eng = Engine(tm, tp, batch=2, max_len=64, page_size=16, pages=4,
                 spill="host", prefix_share=True,
                 scheduler=FairScheduler(quantum=2))
    assert _run(eng, prompts) == want
    rep = eng.traffic_report()
    assert rep["pages"]["evictions"] > 0 and rep["prefix"]["hits"] > 0
    eng.cache.table.check()


def test_reference_float32_equals_solo_under_eviction_pressure(smollm):
    """Pins why the reference's own bfloat16 scenario
    (``test_paging.py::test_prefix_share_identical_under_eviction_pressure``)
    fails: in float32, under the same pressure and the same matches, its
    streams equal the solo streams, so the bfloat16 failure is rounding
    (suffix prefill against whole-prompt prefill), not paging."""
    jm, jp, _, _ = smollm
    prompts = _prompts(jm.cfg.vocab_size)
    want = _solo(jm, jp, prompts)
    eng = JEngine(jm, jp, batch=2, max_len=64, page_size=16, pages=4,
                  spill="host", prefix_share=True,
                  scheduler=JFair(quantum=2))
    assert _run(eng, prompts) == want
    rep = eng.traffic_report()
    assert rep["pages"]["evictions"] > 0 and rep["prefix"]["hits"] > 0


def test_charges_only_private_pages(smollm):
    _, _, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size, n=2)
    quota = QuotaManager({"default": TenantQuota(max_pages=64)})
    eng = Engine(tm, tp, batch=2, max_len=64, page_size=16, spill="host",
                 prefix_share=True, quota=quota)
    ss = [eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
          for i, p in enumerate(prompts)]
    eng.step()                              # both admitted together
    # solo demand: ceil(38 / 16) = 3 pages each; the second session binds
    # the first page read-only, so the pair is charged 3 + 2
    assert quota.usage()["default"]["pages"] == 5
    eng.run()
    assert all(s.finish_reason == "length" for s in ss)
    assert quota.usage()["default"]["pages"] == 0


@pytest.mark.parametrize("codec", [None, "fp8", "int8"])
def test_shared_page_spilled_once_per_codec(smollm, codec):
    """A page two sessions hold, through the real spill tier: evicted once
    (one stash for both holders), refetched once (re-homing both), and the
    bytes that come back are the reference codec's round trip of the frame
    that left."""
    _, _, tm, _ = smollm
    mgr = PagedKVCacheManager(tm, 2, 32, page_size=16, pages=3,
                              spill="spill", codec_for=lambda tenant: codec)

    def mk(uid):
        return Session(request=Request(uid=uid,
                                       prompt=np.zeros(2, np.int32)),
                       seq=uid)

    a, b, c = mk(0), mk(1), mk(2)
    mgr.prepare_slot(0, a, rows=16)         # a: one private page
    mgr.bind(0, a, 16)
    pid = mgr.table.resident_pids(0)[0]
    filled = tree.map(lambda x: (torch.arange(x.numel(), dtype=torch.float32)
                                 .reshape(x.shape) % 7 - 3).to(x.dtype),
                      tfm.page_slice(mgr.pool, pid))
    tfm.page_insert(mgr.pool, filled, pid)
    mgr._sessions[1] = b                    # b binds it read-only
    mgr._codec_by_uid[1] = codec
    mgr.table.share(1, pid)
    assert mgr.table.refcount(pid) == 2
    mgr.pause(a)
    mgr.table.mark_cold(1)
    stash = mgr.spill_runtime.traffic_report().get(
        "kv_stash", {"calls": 0})["calls"]
    mgr.prepare_slot(1, c, rows=48)         # 2 free frames + the shared one
    mgr.bind(1, c, 48)
    assert mgr.table.evictions == 1
    parked = mgr.table.entries(0)[0].payload
    assert isinstance(parked, SharedPayload)
    assert mgr.table.entries(1)[0].payload is parked
    n_leaves = len(tree.leaves(filled))
    assert mgr.spill_runtime.traffic_report()["kv_stash"]["calls"] - \
        stash == n_leaves
    mgr.table.check()
    mgr.release(c)
    mgr.resume(a, 0)                        # one fetch re-homes b too
    assert mgr.table.refetches == 1
    new_pid = mgr.table.resident_pids(0)[0]
    assert mgr.table.resident_pids(1) == [new_pid]
    assert mgr.table.refcount(new_pid) == 2
    mgr.table.check()
    got = tree.leaves(tfm.page_slice(mgr.pool, new_pid))
    cdc = jget_codec(codec) if codec else None
    for want, leaf in zip(tree.leaves(filled), got):
        w = jnp.asarray(want.numpy())
        if cdc is not None and cdc.applies_to(w):
            q, scale = jencode(cdc, w)
            w = jdecode(cdc, q, scale, w.dtype)
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))


def test_prefix_report_matches_reference(smollm):
    """One trace under pressure with an int8 tenant and the in-place
    decode (cold pages resume compressed): the port's prefix, page, spill
    and decode-io counters equal the reference's, and so do the
    streams."""
    jm, jp, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size, n=6, head_len=36, tail_len=10)
    kw = dict(batch=2, max_len=64, page_size=8, pages=14, spill="host",
              prefix_share=True, decode_kernel=True)
    eng = Engine(tm, tp, scheduler=FairScheduler(quantum=3),
                 quota=TenantQuota(codec="int8"), **kw)
    got = _run(eng, prompts, n_new=8)
    jeng = _jax_engine(jm, jp, scheduler=JFair(quantum=3),
                       quota=JQuota(codec="int8"), **kw)
    assert _run(jeng, prompts, n_new=8) == got
    trep, jrep = eng.traffic_report(), jeng.traffic_report()
    assert trep["prefix"]["hits"] > 0 and trep["prefix"]["forks"] > 0
    assert trep["pages"]["evictions"] > 0
    for key in ("prefix", "pages", "kv_stash", "kv_fetch", "decode_io"):
        assert trep[key] == jrep[key], key


# ---------------------------------------------------------------------------
# h2o-danube: the sliding window inside the suffix prefill and the decode
@pytest.mark.parametrize("decode_kernel", [False, True])
def test_danube_window_streams(danube, decode_kernel):
    """Prompts of 100-106 rows against the reduced config's 64-row window:
    the window masks inside the suffix prefill (rows 84..) and every
    decode step.  Sharing on == off == the reference's."""
    jm, jp, tm, tp = danube
    assert tm.cfg.attention == "swa" and tm.cfg.window == 64
    prompts = _prompts(tm.cfg.vocab_size, n=3, head_len=84, tail_len=16)
    prompts = [np.concatenate([p, p[:2 * i]]) for i, p in enumerate(prompts)]
    kw = dict(batch=2, max_len=128, page_size=16, spill="host",
              decode_kernel=decode_kernel)
    base = _run(Engine(tm, tp, **kw), prompts, n_new=8)
    eng = Engine(tm, tp, prefix_share=True, **kw)
    got = _run(eng, prompts, n_new=8)
    ref = _run(_jax_engine(jm, jp, prefix_share=True, **kw), prompts,
               n_new=8)
    assert got == base == ref
    rep = eng.traffic_report()["prefix"]
    assert rep["hits"] >= 5 and rep["forks"] > 0


# ---------------------------------------------------------------------------
# invariants of the index and the shared frames
def _pressure_engine(tm, tp, decode_kernel=True):
    return Engine(tm, tp, batch=2, max_len=64, page_size=8, pages=14,
                  spill="host", prefix_share=True,
                  decode_kernel=decode_kernel,
                  scheduler=FairScheduler(quantum=3),
                  quota=TenantQuota(codec="int8"))


def test_index_holds_only_raw_resident_pids(smollm):
    """After every engine step (evictions, compressed adoptions, releases)
    every frame the prefix index names is resident and raw: a dying frame
    leaves the index, and a page resumed into the int8 side pool is never
    registered."""
    _, _, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size, n=6, head_len=36, tail_len=10)
    eng = _pressure_engine(tm, tp)
    seen = {"indexed": 0, "compressed": 0}

    def check(eng):
        cache = eng.cache
        for pid, (parent, key) in cache._pid_nodes.items():
            assert cache.table.is_resident_pid(pid), pid
            assert pid not in cache._cframe_by_pid, pid
            assert parent[key][0] == pid
        seen["indexed"] += len(cache._pid_nodes)
        seen["compressed"] += len(cache._cframe_by_pid)
        cache.table.check()

    _run(eng, prompts, n_new=8, each_step=check)
    rep = eng.traffic_report()
    assert rep["decode_io"]["compressed_adopts"] > 0
    assert rep["prefix"]["hits"] > 0 and rep["pages"]["evictions"] > 0
    assert seen["indexed"] > 0 and seen["compressed"] > 0


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_no_shared_frame_written(smollm, decode_kernel, monkeypatch):
    """No decode step and no suffix prefill writes a frame that two
    sessions hold or that the prefix index names: no scatter targets one
    (the suffix prefill routes the shared columns to the scratch frame),
    and none changes a byte (the decode writes the private tail page)."""
    _, _, tm, tp = smollm
    prompts = _prompts(tm.cfg.vocab_size, n=6, head_len=36, tail_len=10)
    eng = _pressure_engine(tm, tp, decode_kernel)
    cache = eng.cache
    checked = {"decode": 0, "suffix": 0}
    targets = []

    def spy(fn, key):
        def run(pool, caches, target, *rest):
            targets.extend(target.reshape(-1).tolist())
            return fn(pool, caches, target, *rest)
        monkeypatch.setattr(tfm, key, run)

    spy(tfm.scatter_pages, "scatter_pages")
    spy(tfm.scatter_one_page, "scatter_one_page")

    def guarded(fn, kind):
        def run(*args):
            table = cache.table
            pids = {pid for pid in cache._pid_nodes}
            pids |= {pid for pid in range(table.num_pages)
                     if table.refcount(pid) > 1}
            before = {pid: tfm.page_slice(cache.pool, pid) for pid in pids}
            targets.clear()
            out = fn(*args)
            assert not pids & set(targets), (kind, pids & set(targets))
            for pid, page in before.items():
                after = tfm.page_slice(cache.pool, pid)
                for x, y in zip(tree.leaves(page), tree.leaves(after)):
                    assert torch.equal(x, y), (kind, pid)
            checked[kind] += len(pids) > 0
            return out
        return run

    eng._decode = guarded(eng._decode, "decode")
    eng._prefill_suffix = guarded(eng._prefill_suffix, "suffix")
    _run(eng, prompts, n_new=8)
    assert checked["decode"] > 0 and checked["suffix"] > 0
    assert eng.traffic_report()["prefix"]["forks"] > 0


# ---------------------------------------------------------------------------
# models whose serving state is not pure k/v
@pytest.mark.parametrize("arch,paged", [("mamba2-370m", False),
                                        ("zamba2-2.7b", True)])
def test_recurrent_models_warn_and_serve_unshared(arch, paged, caplog):
    """mamba2 (monolithic slots: nothing to share) and zamba2 (paged k/v
    beside recurrent slot state, which cannot be grafted mid-sequence)
    take ``prefix_share=True``, warn, and serve the unshared streams —
    the reference's, which serves them unshared too."""
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts(tm.cfg.vocab_size, n=3, head_len=20, tail_len=12)
    kw = dict(batch=2, max_len=64, spill="host")
    if paged:
        kw["page_size"] = 16
    base = _run(Engine(tm, tp, **kw), prompts, n_new=4)
    with caplog.at_level("WARNING"):
        eng = Engine(tm, tp, prefix_share=True, **kw)
    assert "prefix sharing" in caplog.text
    assert _run(eng, prompts, n_new=4) == base
    assert _run(JEngine(jm, jp, prefix_share=True, **kw), prompts,
                n_new=4) == base
    if paged:
        rep = eng.traffic_report()["prefix"]
        assert not rep["enabled"] and rep["hits"] == 0
        assert eng.cache.table.shared_binds == 0
