"""Disaggregated prefill/decode of the port against the JAX reference, on
the CPU.

The scenarios are the reference's (``tests/test_disagg.py``) run in
float32: weights from the reference's ``Model.init(PRNGKey(0))`` on
``.reduced(dtype="float32")`` configurations, carried over with
``repro_torch.convert.params_from_jax``.  The split is a pure storage and
scheduling change, so greedy streams must equal the reference's
``build_disagg`` streams and the port's colocated paged streams bit for
bit, and the transfer queue must meter and count what the reference's
does: handoffs, pages, ``kv_publish`` / ``kv_adopt`` bytes and calls,
requeues.  The queue's ordering invariants run through the reference's
own trace function (``run_transfer_queue_trace``) on the port's queue.
"""
import os
import random
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan, RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.kernels import ops as jops
from repro.models.model import build_model as jbuild
from repro.serve.disagg import build_disagg as jbuild_disagg
from repro.serve.engine import Request as JRequest
from repro.serve.quota import QuotaManager as JQuotaManager
from repro.serve.quota import TenantQuota as JQuota
from repro.serve.scheduler import FairScheduler as JFair
from repro_torch import tree
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve.disagg import DisaggPair, TransferQueue, build_disagg
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.scheduler import FairScheduler
from repro_torch.serve.session import SessionState

from test_disagg import LedgerRuntime, run_transfer_queue_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the queue's metering and counters, compared key by key
TRANSFER_KEYS = ("kv_publish", "kv_adopt", "transfer")


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
def zamba2():
    return _pair("zamba2-2.7b")


def _prompts(vocab, n, base=4):
    """The reference's prompts (``tests/test_disagg.py:_prompts``)."""
    return [((np.arange(base + i, dtype=np.int32) * (i + 2) + 1) % vocab)
            for i in range(n)]


def _drive(target, request_cls, reqs):
    """Submit ``(uid, prompt, max_new_tokens)`` requests to ``target`` (a
    pair or an engine), run it; returns the sessions and, per session,
    the tokens its ``on_token`` callback streamed."""
    streamed = {}
    ss = [target.submit(request_cls(uid=uid, prompt=p, max_new_tokens=n),
                        on_token=lambda s, t: streamed.setdefault(
                            s.uid, []).append(t))
          for uid, p, n in reqs]
    target.run()
    return ss, [streamed.get(s.uid, []) for s in ss]


def _jax_disagg(jm, jp, reqs, decode_kernel=False, **kw):
    """The reference's pair; its in-place kernel path runs the XLA twin of
    the Pallas kernel (as the reference's own stream tests do)."""
    if decode_kernel:
        jops.set_paged_impl("xla")
    try:
        pair = jbuild_disagg(jm, jp, decode_kernel=decode_kernel, **kw)
        ss, _ = _drive(pair, JRequest, reqs)
    finally:
        jops.set_paged_impl("pallas")
    return pair, [s.result() for s in ss]


def _port_disagg(tm, tp, reqs, **kw):
    pair = build_disagg(tm, tp, **kw)
    ss, streamed = _drive(pair, Request, reqs)
    # the first token (sampled by the prefill side) streams once
    assert streamed == [s.result() for s in ss]
    return pair, ss


def _colocated(tm, tp, reqs, scheduler=None, **kw):
    eng = Engine(tm, tp, scheduler=scheduler or "fcfs", **kw)
    ss, _ = _drive(eng, Request, reqs)
    return [s.result() for s in ss]


def _transfer_report(pair):
    rep = pair.transfer.traffic_report()
    return {k: rep.get(k) for k in TRANSFER_KEYS}


# ---------------------------------------------------------------------------
# streams: the port's pair == the reference's pair == the port colocated
#: name -> (prompt count, prompt base, new tokens per request, pair kwargs,
#: fair quantum of the decode side or None)
STREAMS = {
    # plain FIFO decode (reference test_disagg.py:54)
    "fifo": (5, 4, [6] * 5, dict(batch=2, max_len=64, page_size=16), None),
    # an overcommitted decode pool under fair preemption (:79): pages
    # evicted through the spill tier on top of the adoption traffic
    "overcommit_fair": (5, 4, [6] * 5,
                        dict(batch=2, max_len=64, page_size=16, pages=3), 2),
    # unequal max_new_tokens: decode slots retire and refill mid-run (:89)
    "staggered_retires": (4, 4, [3, 9, 4, 6],
                          dict(batch=2, max_len=64, page_size=16), None),
    # 18..21-row prompts: two pages a handoff (:134)
    "two_pages": (4, 18, [4] * 4, dict(batch=2, max_len=64, page_size=16),
                  None),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_and_transfer_match_reference(smollm, name):
    jm, jp, tm, tp = smollm
    n, base, new, kw, quantum = STREAMS[name]
    reqs = [(i, p, k) for i, (p, k) in enumerate(
        zip(_prompts(tm.cfg.vocab_size, n, base), new))]
    kw = dict(kw, transfer="host", spill="host")
    jpair, want = _jax_disagg(
        jm, jp, reqs, **kw,
        **({"decode_scheduler": JFair(quantum=quantum)} if quantum else {}))
    pair, ss = _port_disagg(
        tm, tp, reqs, **kw,
        **({"decode_scheduler": FairScheduler(quantum=quantum)}
           if quantum else {}))
    got = [s.result() for s in ss]
    assert got == want
    assert all(s.finish_reason == "length" for s in ss)
    colo = {k: v for k, v in kw.items() if k != "transfer"}
    assert _colocated(tm, tp, reqs, FairScheduler(quantum=quantum)
                      if quantum else None, **colo) == want
    assert _transfer_report(pair) == _transfer_report(jpair)
    drep, jdrep = pair.decode.traffic_report(), jpair.decode.traffic_report()
    assert drep["pages"] == jdrep["pages"]
    for key in ("kv_stash", "kv_fetch"):
        assert drep.get(key) == jdrep.get(key), key
    if quantum:
        assert drep["pages"]["evictions"] > 0
    tq = pair.transfer.traffic_report()["transfer"]
    assert tq["adopted_pages"] == tq["shipped_pages"]
    assert tq["published"] == tq["delivered"] - tq["requeued"] == n
    assert pair.decode.cache.table.adoptions == n


def test_transfer_bytes_are_page_bytes_times_pages(smollm):
    """Wire bytes on both legs are page bytes x shipped pages, one call a
    page leaf; every adoption claimed fresh frames once, all freed at
    retire (reference test_disagg.py:134)."""
    _, _, tm, tp = smollm
    reqs = [(i, p, 4) for i, p in enumerate(_prompts(tm.cfg.vocab_size, 4,
                                                     base=18))]
    pair, _ = _port_disagg(tm, tp, reqs, batch=2, max_len=64, page_size=16,
                           transfer="host", spill="host")
    rep = pair.transfer.traffic_report()
    shipped = rep["transfer"]["shipped_pages"]
    assert shipped == 4 * 2
    leaves = tree.leaves(tfm.page_slice(pair.decode.cache.pool, 0))
    page_bytes = sum(x.numel() * x.element_size() for x in leaves)
    assert rep["kv_publish"]["wire_bytes"] == shipped * page_bytes
    assert rep["kv_adopt"]["wire_bytes"] == shipped * page_bytes
    assert rep["kv_publish"]["calls"] == shipped * len(leaves)
    table = pair.decode.cache.table
    assert table.adoptions == 4
    assert table.sessions() == ()
    assert table.num_free() == table.num_pages


def test_backpressure_parks_pages_never_reprefills(smollm):
    """3 decode slots over a 2-page pool: the third adoption finds every
    frame hot and requeues at the back, its pages parked in the transfer
    tier; prefill publishes once a request, with the reference's requeue
    count and streams (reference test_disagg.py:165)."""
    jm, jp, tm, tp = smollm
    reqs = [(i, p, 8) for i, p in enumerate(_prompts(tm.cfg.vocab_size, 3))]
    kw = dict(batch=3, max_len=32, page_size=16, pages=2, transfer="host",
              spill="host")
    jpair, want = _jax_disagg(jm, jp, reqs, **kw)
    pair, ss = _port_disagg(tm, tp, reqs, **kw)
    assert [s.result() for s in ss] == want
    tq = pair.transfer
    assert tq.requeued == jpair.transfer.requeued > 0
    assert tq.published == 3
    assert tq.shipped_pages == tq.adopted_pages == 3
    assert pair.decode.cache.table.adoptions == 3
    assert _transfer_report(pair) == _transfer_report(jpair)


def test_quota_reservation_follows_session(smollm):
    """The worst-case page charge taken at prefill admission stays on the
    shared ledger while the KV is in flight and releases at decode-side
    retire, as the reference's (test_disagg.py:188)."""
    jm, jp, tm, tp = smollm

    def scenario(build, request_cls, qm):
        pair = build(batch=2, max_len=64, page_size=16, transfer="host",
                     spill="host", quota=qm)
        prompt = np.arange(20, dtype=np.int32)
        a = [pair.submit(request_cls(uid=i, prompt=prompt,
                                     max_new_tokens=10, tenant="A"))
             for i in range(2)]
        b = pair.submit(request_cls(uid=5, prompt=prompt, max_new_tokens=10,
                                    tenant="B"))
        seen = []
        pair.prefill.step()                     # a0 prefilled + published
        seen.append((qm.charge_of(0), pair.transfer.depth(),
                     qm.usage()["A"]["pages"]))
        pair.prefill.step()                     # A over budget: b admits
        seen.append((qm.charge_of(1), qm.charge_of(5)))
        pair.run()
        seen.append(([s.finish_reason for s in a + [b]],
                     [s.result() for s in a + [b]], qm.charged_uids(),
                     qm.usage()["A"]))
        return seen

    want = scenario(lambda **kw: jbuild_disagg(jm, jp, **kw), JRequest,
                    JQuotaManager({"A": JQuota(max_pages=2)}))
    got = scenario(lambda **kw: build_disagg(tm, tp, **kw), Request,
                   QuotaManager({"A": TenantQuota(max_pages=2)}))
    assert got == want
    assert got[0] == (("A", 2), 1, 2)
    assert got[1] == (None, ("B", 2))
    assert got[2][2] == () and got[2][3] == {"sessions": 0, "pages": 0}


def test_cancel_in_transit_releases_everything(smollm):
    """A session cancelled while its handoff is parked: its quota charge
    and its parked payloads are released, nothing re-prefilled, and the
    spill tier's ledger ends empty (reference test_disagg.py:216)."""
    jm, jp, tm, tp = smollm
    p0 = np.arange(4, dtype=np.int32) + 1
    p1 = np.arange(5, dtype=np.int32) + 2
    _, want = _jax_disagg(jm, jp, [(0, p0, 6)], batch=1, max_len=64,
                          page_size=16, transfer="host", spill="host")
    qm = QuotaManager({"A": TenantQuota(max_pages=4)})
    pair = build_disagg(tm, tp, batch=1, max_len=64, page_size=16,
                        transfer="spill", spill="host", quota=qm)
    s0 = pair.submit(Request(uid=0, prompt=p0, max_new_tokens=6,
                             tenant="A"))
    s1 = pair.submit(Request(uid=1, prompt=p1, max_new_tokens=6,
                             tenant="A"))
    pair.prefill.step()
    pair.step()                                 # s0 adopted; s1 published
    assert pair.transfer.depth() == 1
    assert qm.charge_of(1) == ("A", 1)
    s1.cancel()
    pair.run()
    assert s0.result() == want[0]
    assert s1.state is SessionState.CANCELLED
    assert len(s1.result()) == 1                # only the prefill token
    assert pair.transfer.swept == 1
    assert pair.transfer.depth() == 0
    assert qm.charged_uids() == ()
    assert qm.usage()["A"] == {"sessions": 0, "pages": 0}
    spill = pair.transfer.runtime.tier
    assert spill._primary_used == spill._overflow_used == 0.0


def test_role_guards(smollm):
    """The reference's guards (test_disagg.py:288), and a decode engine
    that samples from ``seed + 1``."""
    _, _, tm, tp = smollm
    with pytest.raises(ValueError):
        Engine(tm, tp, batch=1, max_len=32, role="prefill")    # no queue
    with pytest.raises(ValueError):
        Engine(tm, tp, batch=1, max_len=32, role="encode")
    pair = build_disagg(tm, tp, batch=1, max_len=32, page_size=16,
                        transfer="host", spill="host", seed=3)
    with pytest.raises(RuntimeError):
        pair.decode.submit(Request(uid=0, prompt=np.zeros(2, np.int32)))
    with pytest.raises(ValueError):             # mismatched geometry
        DisaggPair(pair.prefill,
                   Engine(tm, tp, batch=1, max_len=64, page_size=16,
                          spill="host", role="decode",
                          transfer=pair.transfer),
                   pair.transfer)
    with pytest.raises(ValueError):             # page_size must tile slots
        Engine(tm, tp, batch=1, max_len=40, page_size=16, spill=None,
               role="prefill", transfer=pair.transfer)
    with pytest.raises(ValueError):             # no kernel on the prefill
        Engine(tm, tp, batch=1, max_len=32, page_size=16, spill=None,
               role="prefill", transfer=pair.transfer, decode_kernel=True)
    with pytest.raises(ValueError):             # quotas must be shared
        DisaggPair(pair.prefill,
                   Engine(tm, tp, batch=1, max_len=32, page_size=16,
                          spill="host", role="decode",
                          transfer=pair.transfer,
                          quota=TenantQuota(max_pages=4)),
                   pair.transfer)
    assert pair.prefill.generator.initial_seed() == 3
    assert pair.decode.generator.initial_seed() == 4
    assert "role=prefill" in pair.describe()
    assert "role=decode" in pair.describe()


def test_prefill_side_terminal_requests_never_ship(smollm):
    """Rejections and instant finishes retire on the prefill side; the
    decode side never sees them (reference test_disagg.py:309)."""
    jm, jp, tm, tp = smollm
    reqs = [(0, np.arange(32, dtype=np.int32), 4),
            (1, np.arange(4, dtype=np.int32) + 1, 1),
            (2, np.arange(5, dtype=np.int32) + 2, 4)]
    kw = dict(batch=2, max_len=32, page_size=16, transfer="host",
              spill="host")
    jpair, want = _jax_disagg(jm, jp, reqs, **kw)
    pair, ss = _port_disagg(tm, tp, reqs, **kw)
    assert [s.result() for s in ss] == want
    assert [s.finish_reason for s in ss] == ["rejected", "length", "length"]
    assert pair.transfer.published == jpair.transfer.published == 1
    assert {r.uid for r in pair.prefill.finished + pair.decode.finished} \
        == {0, 1, 2}


def test_deadline_accounting_across_the_handoff(smollm):
    """The prefill side announces a shipped session through ``on_handoff``
    (not a retirement): deadlines are met or missed only on the decode
    side, which retires the session, and both sides' ledgers equal the
    reference's."""
    jm, jp, tm, tp = smollm
    reqs = [(i, np.arange(4 + i, dtype=np.int32) + i, 4 + 2 * i)
            for i in range(4)]
    kw = dict(batch=2, max_len=32, page_size=16, transfer="host",
              spill="host", scheduler="deadline")

    def run(build, request_cls):
        pair = build(**kw)
        for uid, p, n in reqs:
            pair.submit(request_cls(uid=uid, prompt=p, max_new_tokens=n,
                                    deadline=6 + 2 * uid))
        pair.run()
        return (pair.prefill.scheduler.miss_report(),
                pair.decode.scheduler.miss_report())

    want = run(lambda **k: jbuild_disagg(jm, jp, **k), JRequest)
    got = run(lambda **k: build_disagg(tm, tp, **k), Request)
    assert got == want
    assert got[0]["met"] == got[0]["missed"] == 0
    assert got[1]["met"] + got[1]["missed"] == 4
    assert got[1]["missed"] > 0


def test_transfer_depth_bounds_a_prefill_burst(smollm):
    """The admission gate counts residents not yet published: a 3-slot
    prefill burst never overshoots ``max_depth`` (reference
    test_disagg.py:424)."""
    jm, jp, tm, tp = smollm
    reqs = [(i, np.arange(4, dtype=np.int32) + i, 3) for i in range(4)]
    kw = dict(batch=2, max_len=32, page_size=16, prefill_batch=3,
              max_depth=1, transfer="host", spill="host")
    pair = build_disagg(tm, tp, **kw)
    ss = [pair.submit(Request(uid=u, prompt=p, max_new_tokens=n))
          for u, p, n in reqs]
    for _ in range(3):
        pair.prefill.step()
        assert pair.transfer.depth() <= 1
    pair.run()
    _, want = _jax_disagg(jm, jp, reqs, **kw)
    assert [s.result() for s in ss] == want
    assert [len(s.result()) for s in ss] == [3, 3, 3, 3]


def test_standalone_prefill_run_stops_when_queue_full(smollm):
    """A prefill engine with no consumer stops once its queue is full,
    leaving the unshipped prompts waiting (reference test_disagg.py:442)."""
    _, _, tm, tp = smollm
    q = TransferQueue(LedgerRuntime(), max_depth=2)
    eng = Engine(tm, tp, batch=1, max_len=32, page_size=16, spill=None,
                 scheduler="deadline", role="prefill", transfer=q)
    for i in range(4):
        eng.submit(Request(uid=i, prompt=np.arange(4, dtype=np.int32) + i,
                           max_new_tokens=4))
    eng.run(max_steps=50)
    assert q.depth() == 2
    assert len(eng.scheduler.waiting()) == 2
    assert eng.scheduler.now < 10


def test_hybrid_slot_state_ships_bit_identical(zamba2):
    """zamba2's conv / ssm state rides beside the shared block's k/v pages
    and the adopted streams equal the reference's pair and the port's
    colocated engine; the slot leg is metered on both legs as the
    reference's (test_disagg.py:370)."""
    jm, jp, tm, tp = zamba2
    reqs = [(i, p, 5) for i, p in enumerate(_prompts(tm.cfg.vocab_size, 2))]
    kw = dict(batch=2, max_len=32, page_size=16, transfer="host",
              spill="host")
    jpair, want = _jax_disagg(jm, jp, reqs, **kw)
    pair, ss = _port_disagg(tm, tp, reqs, **kw)
    assert [s.result() for s in ss] == want
    assert _colocated(tm, tp, reqs, batch=2, max_len=32, page_size=16,
                      spill="host") == want
    rep = pair.transfer.traffic_report()
    page_leaves = len(tree.leaves(tfm.page_slice(pair.decode.cache.pool, 0)))
    shipped = rep["transfer"]["shipped_pages"]
    assert rep["kv_publish"]["calls"] > shipped * page_leaves
    assert rep["kv_adopt"]["calls"] == rep["kv_publish"]["calls"]
    assert _transfer_report(pair) == _transfer_report(jpair)


def test_transfer_queue_random_traces():
    """The reference's trace function and seeds (test_disagg.py:568) on the
    port's queue: FIFO per session, delivery exactly once, no starvation,
    no payload leak."""
    def make_queue(depth):
        runtime = LedgerRuntime()
        queue = TransferQueue(runtime, max_depth=depth)

        def leak_check():
            assert not runtime.store, "payloads leaked in the transfer tier"
        return queue, leak_check

    rng = random.Random(4321)
    for _ in range(30):
        ops = [(rng.choice(["publish", "adopt", "adopt", "cancel"]),
                rng.randrange(16)) for _ in range(60)]
        q, _ = run_transfer_queue_trace(
            ops, max_depth=rng.choice([None, 2, 4]), make_queue=make_queue)
        assert q.depth() == 0


def test_kernel_decode_role_matches_reference(smollm):
    """The decode role on the in-place paged decode (``decode_kernel=True``
    through the pair's engine kwargs, as the reference passes it): an
    overcommitted pool, int8 spill, fair preemption, so pages resume
    compressed into the side pool.  The port's streams equal the
    reference's kernel-path pair (its XLA twin) and the gather path's,
    and every adoption lands in raw frames: no adopted frame keeps a
    compressed side-pool entry."""
    jm, jp, tm, tp = smollm
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 512, size=(10 + 3 * i,)).astype(np.int32),
             12) for i in range(5)]
    kw = dict(batch=2, max_len=32, page_size=4, pages=9, transfer="host",
              spill="host")
    jpair, want = _jax_disagg(jm, jp, reqs, decode_kernel=True,
                              decode_scheduler=JFair(quantum=3),
                              quota=JQuota(codec="int8"), **kw)
    pair = build_disagg(tm, tp, decode_kernel=True,
                        decode_scheduler=FairScheduler(quantum=3),
                        quota=TenantQuota(codec="int8"), **kw)
    cache = pair.decode.cache
    adopt, stale = cache.adopt, []

    def spy_adopt(slot, sess, handoff, queue):
        adopt(slot, sess, handoff, queue)
        stale.extend(pid for pid in cache.table.resident_pids(sess.uid)
                     if pid in cache._cframe_by_pid)

    cache.adopt = spy_adopt
    ss, _ = _drive(pair, Request, reqs)
    assert [s.result() for s in ss] == want
    gather, _ = _port_disagg(tm, tp, reqs,
                             decode_scheduler=FairScheduler(quantum=3),
                             quota=TenantQuota(codec="int8"), **kw)
    assert [s.result() for s in gather.prefill.sessions] == want
    assert not stale
    drep = pair.decode.traffic_report()
    assert drep["decode_io"]["in_place"]
    assert drep["decode_io"]["compressed_adopts"] > 0
    assert drep["page_decodes"]["inflated"] > 0
    assert drep["pages"] == jpair.decode.traffic_report()["pages"]
    assert _transfer_report(pair) == _transfer_report(jpair)


# ---------------------------------------------------------------------------
def _cli(*extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--arch", "smollm-135m", "--device", "cpu", "--requests", "4",
         "--new-tokens", "8", *extra],
        env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_role_both():
    """``--role both`` serves through the pair, prints the transfer report
    and the TTFT, and streams what the colocated engine streams."""
    proc = _cli("--page-size", "16", "--role", "both")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "role=prefill" in out and "role=decode" in out
    assert "served 4 requests, 32 tokens" in out
    assert "ttft: mean" in out
    assert ("transfer[spill[pooled_hbm[bw_aware]->host]]: 4 handoffs "
            "shipped (4 pages), 4 pages adopted, 0 requeued, 0 swept, "
            "depth 0; kv_publish") in out
    assert "4 adopted" in out
    colo = _cli("--page-size", "16")
    assert colo.returncode == 0, colo.stderr[-2000:]
    reqs = [line for line in out.splitlines() if line.startswith("  req ")]
    assert len(reqs) == 3
    assert reqs == [line for line in colo.stdout.splitlines()
                    if line.startswith("  req ")]


@pytest.mark.parametrize("flags,message", [
    (("--page-size", "16", "--role", "decode"),
     "--role decode needs a peer feeding the transfer queue"),
    (("--page-size", "16", "--role", "both", "--decode-kernel"),
     "--decode-kernel is a colocated-engine feature for now"),
    (("--page-size", "16", "--role", "both", "--prefix-share"),
     "--prefix-share is a colocated-engine feature for now"),
    (("--role", "prefill"), "--role ships page-shaped KV: pass --page-size"),
])
def test_serve_cli_role_guards(flags, message, capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.parse_args(["--smoke", "--arch", "smollm-135m", "--device",
                          "cpu", *flags])
    assert exit_.value.code == 2
    assert message in capsys.readouterr().err
