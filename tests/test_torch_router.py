"""The port's cluster router and traffic generator against the JAX
reference, on the CPU.

The cases are the reference's (``tests/test_router.py``): the placement
policies and the router's submit / drain / fail logic on the reference's
seeded random schedules over its lightweight fake pairs, where every
placement decision must equal the reference router's; the wire sender /
receiver through the reference's transfer-queue trace function; real
engines (reduced smollm-135m in float32, the reference's weights carried
over by ``repro_torch.convert.params_from_jax``): the shared cluster
quota, drain with zero dropped sessions, engine loss, a router with a wire
engine and a replayed synthetic trace, the streams equal to the
reference's router; ``generate_traffic`` traces equal to the reference's;
and the two-process drain over TCP through the command line, with every
wait bounded.
"""
import os
import random
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan, RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models.model import build_model as jbuild
from repro.serve import router as jrouter
from repro.serve.engine import Request as JRequest
from repro.sim import workloads as jworkloads
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import router as trouter
from repro_torch.serve.disagg import build_disagg
from repro_torch.serve.engine import Request
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.router import (ACTIVE, DETACHED, LOST, EngineView,
                                      LeastLoaded, PrefixAffinity,
                                      RoundRobin, Router, build_placement,
                                      build_router, registered_placements,
                                      replay_trace, synth_prompt)
from repro_torch.serve.session import Session
from repro_torch.serve.transport import (WireReceiver, WireSender,
                                         build_wire_pair, memory_pair)
from repro_torch.sim.workloads import (TrafficSpec, generate_traffic,
                                       traffic_summary)

from test_disagg import run_transfer_queue_trace
from test_router import FakePair, SpyPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(batch=2, max_len=64, page_size=16, transfer="host", spill="host")


@pytest.fixture(scope="module")
def smollm():
    """(reference model, its params, port model, the same params)."""
    cfg = JARCHS["smollm-135m"].reduced(dtype="float32")
    run = JRunConfig(model=cfg, shape=JShapeConfig("t", 64, 2, "decode"),
                     mesh=MeshPlan((1,), ("data",)),
                     memory=JMemoryPlan(policy="none"))
    jm = jbuild(run)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(TARCHS["smollm-135m"].reduced(dtype="float32"), device="cpu")
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _prompts(vocab, n, base=4):
    """The reference's prompts (``tests/test_router.py:_prompts``)."""
    return [((np.arange(base + i, dtype=np.int32) * (i + 2) + 1) % vocab)
            for i in range(n)]


# ---------------------------------------------------------------------------
# placement policies (pure)
def _views(*loads, window=8):
    return [EngineView(i, load, window - load)
            for i, load in enumerate(loads)]


def _sess(uid, prompt=(1, 2, 3)):
    return Session(request=Request(uid=uid, prompt=list(prompt)), seq=uid)


def test_registry():
    assert registered_placements() == jrouter.registered_placements()
    assert isinstance(build_placement("round_robin"), RoundRobin)
    with pytest.raises(KeyError, match="unknown placement"):
        build_placement("darts")


def test_least_loaded_and_round_robin():
    pol = LeastLoaded()
    assert pol.choose(_views(3, 1, 1), _sess(0)) == 1
    assert pol.choose(_views(0, 0, 0), _sess(0)) == 0
    pol = RoundRobin()
    assert [pol.choose(_views(0, 0, 0), _sess(i)) for i in range(6)] == \
        [0, 1, 2, 0, 1, 2]
    # a drain mid-rotation: the rotation continues from the last-placed
    # engine's identity over the survivors
    survivors = [v for v in _views(0, 0, 0) if v.index != 1]
    assert [pol.choose(survivors, _sess(i)) for i in range(3)] == [0, 2, 0]
    assert [pol.choose(_views(0, 0, 0), _sess(i)) for i in range(3)] == \
        [1, 2, 0]


def test_prefix_affinity_matches_the_reference():
    """Sticky homes, minimal disruption, spill when the home is full; the
    rendezvous hash is the reference's, so every choice is too."""
    pol, jpol = PrefixAffinity(prefix_len=4), jrouter.PrefixAffinity(
        prefix_len=4)
    rng = np.random.default_rng(3)
    for trial in range(60):
        prompt = [int(t) for t in rng.integers(0, 9, size=5)]
        loads = [int(x) for x in rng.integers(0, 9, size=3)]
        views = [v for v in _views(*loads) if v.index != trial % 4]
        jviews = [jrouter.EngineView(*v) for v in views]
        assert pol.choose(views, _sess(0, prompt)) == jpol.choose(
            jviews, jrouter.Session(request=JRequest(uid=0, prompt=prompt),
                                    seq=0))
    same = [_sess(i, prompt=[7, 7, 7, 7, i]) for i in range(10)]
    homes = {pol.choose(_views(0, 0, 0), s) for s in same}
    assert len(homes) == 1
    home = homes.pop()
    survivors = [v for v in _views(0, 0, 0) if v.index != (home + 1) % 3]
    assert {pol.choose(survivors, s) for s in same} == {home}
    full = [EngineView(v.index, 8, 0) if v.index == home else v
            for v in _views(0, 0, 0)]
    assert pol.choose(full, same[0]) != home


# ---------------------------------------------------------------------------
# the router's logic on the reference's fake pairs and seeded schedules
def _run_ops(module, ops, policy, n_engines=3, slots=2):
    """The reference's schedule function (test_router.py:_run_ops) over
    ``module``'s Router; returns it and the spy's choices."""
    router = module.Router([FakePair(slots=slots) for _ in range(n_engines)],
                           placement=policy)
    router.policy = SpyPolicy(router.policy, lambda: router)
    request = Request if module is trouter else JRequest
    uid = 0
    for op, arg in ops:
        if op == "submit":
            router.submit(request(uid=uid, prompt=[1 + arg % 5] * 4,
                                  max_new_tokens=1 + arg % 4))
            uid += 1
        elif op in ("drain", "fail"):
            live = [e for e in router.engines if e.state == ACTIVE]
            if len(live) > 1:
                getattr(router, op)(live[arg % len(live)].index)
        router.step()
    router.run(max_steps=5000)
    return router


def _outcome(router):
    return (router.policy.choices, router.placement_log, router.requeues,
            [e.state for e in router.engines], router.now,
            {u: (s.finish_reason, list(s.tokens))
             for u, s in router.sessions.items()},
            router.ttft_report(), router.slo_report())


def test_router_random_schedules_equal_the_reference():
    rng = random.Random(99)
    for _ in range(25):
        ops = [(rng.choice(["submit", "submit", "submit", "drain", "fail"]),
                rng.randrange(32)) for _ in range(rng.randrange(5, 40))]
        pol = rng.choice(["least_loaded", "round_robin", "prefix_affinity"])
        router = _run_ops(trouter, ops, pol)
        assert _outcome(router) == _outcome(_run_ops(jrouter, ops, pol))
        assert all(s.done for s in router.sessions.values())
        assert not router.queue
        for eng in router.engines:
            if eng.state == "draining":
                assert not eng.pair.has_work()


# ---------------------------------------------------------------------------
# the wire through the reference's transfer-queue trace function
class _NullRuntime:
    device = torch.device("cpu")

    def meter_transfer(self, *a, **k):
        pass

    def traffic_report(self):
        return {}


class _WireLoop:
    """The port's sender and receiver glued into the TransferQueue surface
    (the trace function's numpy pages cross as CPU tensors), every handoff
    crossing a fragmented in-memory byte channel."""

    def __init__(self, max_depth):
        tx, rx = memory_pair(max_chunk=97)
        self.sender = WireSender(tx, _NullRuntime(), max_depth=max_depth,
                                 backoff=0.0, sleep=lambda _: None)
        self.receiver = WireReceiver(rx, _NullRuntime(), backoff=0.0,
                                     sleep=lambda _: None)

    def has_room(self, pending=0):
        return self.sender.has_room(pending)

    def publish(self, handoff, pages, slot_one=None):
        self.sender.publish(handoff, [{k: torch.from_numpy(v)
                                       for k, v in p.items()}
                                      for p in pages], slot_one)

    def next_ready(self):
        return self.receiver.next_ready()

    def requeue(self, h):
        self.receiver.requeue(h)

    def fetch_pages(self, h):
        return self.receiver.fetch_pages(h)

    def discard(self, h):
        self.receiver.discard(h)

    def parked_uids(self):
        self.receiver.pump()
        return self.receiver.parked_uids()

    def depth(self):
        return self.receiver.depth()

    @property
    def _parked(self):
        self.receiver.pump()
        return self.receiver._parked

    @property
    def adopted_pages(self):
        return self.receiver.adopted_pages

    def sweep_cancelled(self):
        return self.receiver.sweep_cancelled() + \
            self.sender.sweep_cancelled()


def test_wire_queue_random_traces_seeded():
    def make_queue(depth):
        loop = _WireLoop(depth)

        def leak_check():
            loop.receiver.pump()
            assert not loop.receiver._parked, "handoffs parked at drain"
            loop.sender.pump()
            assert not loop.sender._inflight, "sender credits leaked"
        return loop, leak_check

    rng = random.Random(2718)
    for _ in range(15):
        ops = [(rng.choice(["publish", "adopt", "adopt", "cancel"]),
                rng.randrange(16)) for _ in range(60)]
        q, _ = run_transfer_queue_trace(
            ops, max_depth=rng.choice([None, 2, 4]), make_queue=make_queue)
        assert q.depth() == 0


# ---------------------------------------------------------------------------
# real engines
def _submit_all(router, prompts, n, request_cls=Request):
    return [router.submit(request_cls(uid=i, prompt=p, max_new_tokens=n))
            for i, p in enumerate(prompts)]


def _at_step(step, action):
    fired = []

    def hook(r):
        if r.now == step and not fired:
            fired.append(True)
            action(r)
    return hook


def test_cluster_quota_shared_across_engines(smollm):
    """One tenant's pages are bounded by its quota across engines: every
    engine charges the same ledger, which never exceeds the summed
    quotas."""
    _, _, tm, params = smollm
    quota = QuotaManager(default_quota=TenantQuota(max_pages=4))
    router = build_router(tm, params, engines=2, quota=quota, **KW)
    shared = router.engines[0].pair.prefill.quota
    assert shared is router.engines[1].pair.prefill.quota
    seen = []
    ss = [router.submit(Request(uid=i, prompt=p, max_new_tokens=4,
                                tenant=f"t{i % 2}"))
          for i, p in enumerate(_prompts(tm.cfg.vocab_size, 8, base=18))]
    for _ in range(2000):
        if not router.has_work():
            break
        router.step()
        pages = sum(u["pages"] for u in shared.usage().values())
        seen.append(pages)
        assert pages <= 8, f"cluster admitted {pages} > 8 pages"
    assert max(seen) > 0 and all(s.done for s in ss)


def test_drain_zero_dropped_equals_the_reference(smollm):
    jm, jp, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 8)
    router = build_router(tm, params, engines=2, **KW)
    ss = _submit_all(router, prompts, 4)
    done = router.run(on_step=_at_step(2, lambda r: r.drain(0)))
    assert len(done) == 8 and all(s.done for s in ss)
    assert router.engines[0].state == DETACHED
    assert all(s.finish_reason in ("eos", "length") for s in ss)
    jr = jrouter.build_router(jm, jp, engines=2, **KW)
    js = _submit_all(jr, prompts, 4, JRequest)
    jr.run(on_step=_at_step(2, lambda r: r.drain(0)))
    assert [s.result() for s in ss] == [s.result() for s in js]
    assert router.placement_log == jr.placement_log
    assert router.ttft_report() == jr.ttft_report()


def test_engine_loss_requeues_and_streams_survive(smollm):
    _, _, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 6)

    def run(lose):
        router = build_router(tm, params, engines=2, **KW)
        ss = _submit_all(router, prompts, 5)
        router.run(on_step=_at_step(2, lambda r: r.fail(1)) if lose
                   else None)
        return router, [s.result() for s in ss]

    _, want = run(lose=False)
    router, got = run(lose=True)
    assert got == want
    assert router.engines[1].state == LOST and router.requeues > 0


def test_losing_a_wire_engine_drops_nothing_where_the_reference_does(
        smollm):
    """Failing an in-process wire pair: its decode side holds sessions
    rebuilt off the wire.  The reference's ``Router.fail`` requeues such a
    copy, so the router's own session never finishes (ROADMAP C14); the
    port requeues the router's session, every stream finishes and equals
    an undisturbed run's."""
    jm, jp, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 6)
    kw = {k: v for k, v in KW.items() if k != "transfer"}

    def run(router_cls, wire, disagg, request_cls, lose):
        router = router_cls([wire(seed=0, **kw),
                             disagg(transfer="host", seed=2, **kw)])
        ss = _submit_all(router, prompts, 6, request_cls)
        router.run(max_steps=2000, on_step=_at_step(5, lambda r: r.fail(0))
                   if lose else None)
        return router, ss

    def port(**k):
        return build_wire_pair(tm, params, **k)

    router, ss = run(Router, port, lambda **k: build_disagg(tm, params, **k),
                     Request, lose=True)
    _, want = run(Router, port, lambda **k: build_disagg(tm, params, **k),
                  Request, lose=False)
    assert router.requeues > 0 and all(s.done for s in ss)
    assert [s.result() for s in ss] == [s.result() for s in want]
    from repro.serve.disagg import build_disagg as jbuild_disagg
    from repro.serve.transport import build_wire_pair as jbuild_wire
    jr, js = run(jrouter.Router, lambda **k: jbuild_wire(jm, jp, **k),
                 lambda **k: jbuild_disagg(jm, jp, **k), JRequest, lose=True)
    assert jr.requeues == router.requeues
    assert [s.uid for s in js if not s.done] != []


@pytest.mark.parametrize("transport", ["memory", "tcp"])
def test_router_with_wire_engine(smollm, transport):
    """A mixed cluster (engine 0 a wire pair, engine 1 a loopback pair)
    streams what an all-loopback cluster does."""
    _, _, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 6)
    kw = {k: v for k, v in KW.items() if k != "transfer"}
    wire = build_wire_pair(tm, params, seed=0, transport=transport, **kw)
    try:
        router = Router([wire, build_disagg(tm, params, transfer="host",
                                            seed=2, **kw)],
                        placement="round_robin")
        ss = _submit_all(router, prompts, 4)
        router.run(on_step=_at_step(3, lambda r: r.drain(0)))
    finally:
        wire.close()
    loop = build_router(tm, params, engines=2, placement="round_robin", **KW)
    ls = _submit_all(loop, prompts, 4)
    loop.run(on_step=_at_step(3, lambda r: r.drain(0)))
    # (the placements may differ after the drain: a loopback queue hands
    # its parked handoffs back for redistribution, a wire sender's are
    # already on the remote side and finish there)
    assert [s.result() for s in ss] == [s.result() for s in ls]
    assert router.placement_log[:6] == loop.placement_log[:6]
    assert wire.sender.traffic_report()["transfer"]["results"] > 0


# ---------------------------------------------------------------------------
# synthetic traffic
SPECS = [TrafficSpec(sessions=200, seed=0),
         TrafficSpec(sessions=50, horizon_s=100.0, prompt_mean=8.0,
                     prompt_max=20, decode_mean=4.0, decode_max=8,
                     prefix_len=6, seed=5),
         TrafficSpec(sessions=300, horizon_s=3600.0, burst_rate_per_hour=30.0,
                     diurnal_amplitude=1.0, seed=11)]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_traffic_equals_the_reference(i):
    import dataclasses
    spec = SPECS[i]
    trace = generate_traffic(spec)
    jtrace = jworkloads.generate_traffic(
        jworkloads.TrafficSpec(**dataclasses.asdict(spec)))
    assert [dataclasses.asdict(s) for s in trace] == \
        [dataclasses.asdict(s) for s in jtrace]
    assert traffic_summary(trace) == jworkloads.traffic_summary(jtrace)
    for s, js in zip(trace[:40], jtrace[:40]):
        assert np.array_equal(synth_prompt(s, 512),
                              jrouter.synth_prompt(js, 512))


def test_replay_trace_equals_the_reference(smollm):
    jm, jp, tm, params = smollm
    spec = dict(sessions=10, horizon_s=100.0, prompt_mean=8.0, prompt_max=20,
                decode_mean=4.0, decode_max=8, prefix_len=6, seed=5)
    router = build_router(tm, params, engines=2, placement="prefix_affinity",
                          **KW)
    done = replay_trace(router, generate_traffic(TrafficSpec(**spec)),
                        tm.cfg.vocab_size, arrivals_per_step=2.0)
    assert len(done) == 10 and all(len(r.out_tokens) > 0 for r in done)
    jr = jrouter.build_router(jm, jp, engines=2, placement="prefix_affinity",
                              **KW)
    jrouter.replay_trace(jr, jworkloads.generate_traffic(
        jworkloads.TrafficSpec(**spec)), tm.cfg.vocab_size,
        arrivals_per_step=2.0)
    assert router.placement_log == jr.placement_log
    assert {u: s.result() for u, s in router.sessions.items()} == \
        {u: s.result() for u, s in jr.sessions.items()}
    assert router.slo_report() == jr.slo_report()


# ---------------------------------------------------------------------------
def test_two_process_router_drain_over_tcp(tmp_path):
    """The command line's two-process deployment: a router whose engine 0
    is the prefill half of a TCP wire, the decode worker in a second
    process; engine 0 drains mid-run; both exit clean with zero dropped
    sessions.  Children log to files (an undrained pipe could stall them)
    and every wait is bounded."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "smollm-135m", "--smoke", "--device", "cpu", "--batch", "2",
            "--max-len", "64", "--page-size", "16"]
    rlog, wlog = tmp_path / "router.log", tmp_path / "worker.log"
    with open(rlog, "w") as rf, open(wlog, "w") as wf:
        router = subprocess.Popen(
            args + ["--router", "--engines", "2", "--listen", "0",
                    "--requests", "6", "--new-tokens", "4",
                    "--drain-after", "4", "--drain-engine", "0"],
            stdout=rf, stderr=subprocess.STDOUT, env=env)
        worker = None
        try:
            port = None
            deadline = time.time() + 120
            while time.time() < deadline and port is None:
                for line in rlog.read_text().splitlines():
                    if "listening on" in line:
                        port = int(line.rsplit(" ", 1)[-1])
                if port is None:
                    assert router.poll() is None, \
                        "router died early:\n" + rlog.read_text()
                    time.sleep(0.2)
            assert port, "router never opened its port:\n" + rlog.read_text()
            worker = subprocess.Popen(
                args + ["--role", "decode", "--connect",
                        f"127.0.0.1:{port}"],
                stdout=wf, stderr=subprocess.STDOUT, env=env)
            assert router.wait(timeout=120) == 0, rlog.read_text()
            assert worker.wait(timeout=60) == 0, wlog.read_text()
        finally:
            for proc in (router, worker):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    log, wout = rlog.read_text(), wlog.read_text()
    assert "0 dropped" in log and "drained engine 0" in log, log
    assert "decode worker done: adopted" in wout, wout


@pytest.mark.parametrize("flags,match", [
    (["--router", "--peer", "127.0.0.1:1", "--trace", "4"], "federation"),
    (["--router", "--fed-listen", "0", "--trace", "4"], "federation"),
    (["--role", "decode"], "--connect"),
    (["--router", "--listen", "0"], "--batch"),
    (["--router", "--transport", "shm", "--wire-streams", "2"], "shm"),
    (["--router", "--decode-kernel"], "colocated"),
])
def test_cli_guards(flags, match, capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "smollm-135m", "--page-size", "16"]
                         + flags)
    assert match in capsys.readouterr().err


def test_cli_router_trace_and_shm(capsys):
    """``--trace`` replays the synthetic traffic through the router, and
    ``--transport shm`` makes engine 0 a shared-memory wire pair."""
    from repro_torch.launch import serve
    router = serve.main(["--arch", "smollm-135m", "--smoke", "--device",
                         "cpu", "--batch", "2", "--max-len", "64",
                         "--page-size", "16", "--router", "--transport",
                         "shm", "--trace", "6", "--drain-after", "3"])
    out = capsys.readouterr().out
    assert "0 dropped" in out and "placement[least_loaded]" in out
    assert "wire[shm[" in out and "drained engine 0" in out
    assert len(router.sessions) == 6
    assert all(s.done for s in router.sessions.values())
