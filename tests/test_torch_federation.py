"""The port's router federation against the JAX reference, on the CPU.

The reference's four federation scenarios (``tests/test_wire_scaleout.py``:
overflow forwarding, the quota overlay, a drain racing forwards, a peer
lost mid-flight) run through both packages on the same prompts, reduced
smollm-135m in float32 with the reference's weights carried over by
``repro_torch.convert.params_from_jax``: every request's stream and the
forward / adopt / reject / requeue counts must be equal.  Then a
reference cluster federates with a port cluster over a TCP pair in one
process and forwards into it, every stream coming home equal to the
reference-only run; and the command line federates two processes over
TCP (``--fed-listen`` / ``--peer``), every wait bounded.
"""
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan, RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models.model import build_model as jbuild
from repro.serve import router as jrouter
from repro.serve import transport as jtransport
from repro.serve.engine import Request as JRequest
from repro.serve.quota import QuotaManager as JQuotaManager
from repro.serve.quota import TenantQuota as JTenantQuota
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.serve import router as trouter
from repro_torch.serve import transport as ttransport
from repro_torch.serve.engine import Request
from repro_torch.serve.quota import QuotaManager, TenantQuota

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(batch=2, max_len=64, page_size=16, transfer="host", spill="host")
# each package's router module, request type and quota classes
SIDES = {"ref": (jrouter, JRequest, JQuotaManager, JTenantQuota),
         "port": (trouter, Request, QuotaManager, TenantQuota)}


@pytest.fixture(scope="module")
def smollm():
    """{"ref": (model, params), "port": (model, the same params)}."""
    cfg = JARCHS["smollm-135m"].reduced(dtype="float32")
    run = JRunConfig(model=cfg, shape=JShapeConfig("t", 64, 2, "decode"),
                     mesh=MeshPlan((1,), ("data",)),
                     memory=JMemoryPlan(policy="none"))
    jm = jbuild(run)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(TARCHS["smollm-135m"].reduced(dtype="float32"), device="cpu")
    return {"ref": (jm, jp),
            "port": (tm, params_from_jax(jax.tree.map(np.asarray, jp),
                                         "cpu"))}


def _prompts(vocab, n, base=4):
    """The reference's prompts (``tests/test_wire_scaleout.py:_prompts``)."""
    return [((np.arange(base + i, dtype=np.int32) * (i + 2) + 1) % vocab)
            for i in range(n)]


def _run_feds(feds, max_steps=20_000):
    for _ in range(max_steps):
        if not any(f.has_work() for f in feds):
            return
        for f in feds:
            f.step()
    raise AssertionError("federation never drained")


def _submit(side, fed, vocab, n=8):
    Req = SIDES[side][1]
    return [fed.submit(Req(uid=i, prompt=p, max_new_tokens=4))
            for i, p in enumerate(_prompts(vocab, n))]


def _outcome(feds, sessions) -> dict:
    return {"streams": {s.uid: [int(t) for t in s.tokens] for s in sessions},
            "finish": {s.uid: s.finish_reason for s in sessions},
            "forwarded": [f.forwarded for f in feds],
            "adopted": [f.adopted for f in feds],
            "rejected": [f.rejected for f in feds],
            "requeues": [f.router.requeues for f in feds]}


# ---------------------------------------------------------------------------
def _overflow(side, model, params):
    router = SIDES[side][0]
    fed0, fed1 = router.federate([router.build_router(model, params,
                                                      engines=1, **KW)
                                  for _ in range(2)])
    ss = _submit(side, fed0, model.cfg.vocab_size)
    _run_feds([fed0, fed1])
    assert all(s.done and len(s.tokens) == 4 for s in ss)
    assert fed0.forwarded > 0 and fed1.adopted == fed0.forwarded
    assert all(uid >= router.FOREIGN_UID_BASE for uid in fed1._foreign)
    assert all(s.request.out_tokens is s.tokens for s in ss)
    return _outcome([fed0, fed1], ss)


def _drain(side, model, params):
    router = SIDES[side][0]
    fed0, fed1 = router.federate([router.build_router(model, params,
                                                      engines=1, **KW)
                                  for _ in range(2)])
    ss = _submit(side, fed0, model.cfg.vocab_size)
    fed1.step()
    for _ in range(200):
        fed0.step()
        if fed0.forwarded > 0:
            break
    assert fed0.forwarded > 0
    fed1.drain()
    _run_feds([fed0, fed1])
    assert fed1.rejected == fed0.forwarded and fed1.adopted == 0
    assert fed0.router.requeues >= fed0.forwarded
    assert all(s.done and len(s.tokens) == 4 for s in ss)
    return _outcome([fed0, fed1], ss)


def _dead_peer(side, model, params):
    router, _, QM, TQ = SIDES[side]
    quota = QM(default_quota=TQ(max_pages=1000))
    r0 = router.build_router(model, params, engines=1, quota=quota, **KW)
    r1 = router.build_router(model, params, engines=1, **KW)
    fed0, fed1 = router.federate([r0, r1])
    ss = _submit(side, fed0, model.cfg.vocab_size)
    for _ in range(200):
        fed0.step()
        fed1.step()
        if fed0.forwarded > 0:
            break
    assert fed0.forwarded > 0
    fed0.peers["cluster1"].channel.close()          # the peer vanishes
    _run_feds([fed0])
    assert fed0.peers["cluster1"].closed
    assert all(s.done and len(s.tokens) == 4 for s in ss)
    assert r0.requeues >= fed0.forwarded
    assert quota.remote_peers() == () and quota.charged_uids() == ()
    return _outcome([fed0, fed1], ss)


@pytest.mark.parametrize("scenario", [_overflow, _drain, _dead_peer],
                         ids=["forwards_overflow", "drain_rejects",
                              "dead_peer_requeues"])
def test_federation_scenarios_match_reference(smollm, scenario):
    """Each scenario, through each package: equal streams request by
    request and equal forward / adopt / reject / requeue counts."""
    got = scenario("port", *smollm["port"])
    want = scenario("ref", *smollm["ref"])
    assert got == want


def test_federation_quota_overlay_matches_reference():
    """The remote-usage overlay admits as the reference's does, step by
    step, and a dropped peer releases its overlay."""
    steps = [("can", 10), ("set", "peer-a", {"t": {"sessions": 3,
                                                    "pages": 80}}),
             ("peers",), ("can", 10), ("can", 30),
             ("set", "peer-b", {"t": {"sessions": 1, "pages": 0}}),
             ("can", 1), ("set", "peer-a", None), ("can", 30), ("peers",)]
    seen = {}
    for side, (_, _, QM, TQ) in SIDES.items():
        q = QM({"t": TQ(max_sessions=4, max_pages=100)})
        out = []
        for op, *rest in steps:
            if op == "can":
                out.append(q.can_admit("t", pages=rest[0]))
            elif op == "set":
                q.set_remote_usage(*rest)
            else:
                out.append(q.remote_peers())
        seen[side] = out
    assert seen["port"] == seen["ref"] == [
        True, ("peer-a",), True, False, False, True, ("peer-b",)]


# ---------------------------------------------------------------------------
def test_reference_cluster_forwards_into_port_cluster(smollm):
    """A reference cluster and a port cluster federated over one TCP pair
    in this process: the reference's backlog is forwarded to the port
    cluster, served there, and every stream comes home equal to the
    reference-only federation's."""
    want = _overflow("ref", *smollm["ref"])
    jm, jp = smollm["ref"]
    tm, tp = smollm["port"]
    ja, jb = jtransport.tcp_pair()
    jb.sock.setblocking(True)
    origin = jrouter.FederatedRouter(
        jrouter.build_router(jm, jp, engines=1, **KW), name="cluster0")
    served = trouter.FederatedRouter(
        trouter.build_router(tm, tp, engines=1, **KW), name="cluster1")
    origin.add_peer("cluster1", ja)
    served.add_peer("cluster0", ttransport.TcpChannel(jb.sock))
    ss = _submit("ref", origin, jm.cfg.vocab_size)
    deadline = time.time() + 240
    while origin.has_work() or served.has_work():
        assert time.time() < deadline, "the federation never drained"
        origin.step()
        served.step()
    try:
        assert origin.forwarded > 0
        assert served.adopted == origin.forwarded
        assert all(s.done and s.finish_reason == "length" for s in ss)
        assert {s.uid: [int(t) for t in s.tokens] for s in ss} == \
            want["streams"]
        assert all(s.request.out_tokens is s.tokens for s in ss)
    finally:
        origin.close()
        served.close()


# ---------------------------------------------------------------------------
def _wait_for_port(proc, log_path, deadline):
    while time.time() < deadline:
        for line in log_path.read_text().splitlines():
            if line.startswith("federation: listening on"):
                return int(line.rsplit(" ", 1)[-1])
        assert proc.poll() is None, \
            "the listening router died early:\n" + log_path.read_text()
        time.sleep(0.2)
    raise AssertionError("no federation port:\n" + log_path.read_text())


def _fed_counts(log: str) -> tuple:
    line = [ln for ln in log.splitlines() if ln.startswith("fed[")][-1]
    fields = dict(f.split("=") for f in line.split("|")[0].split()[1:])
    return int(fields["fwd"]), int(fields["adopted"])


def test_two_process_federation_over_tcp(tmp_path):
    """The command line's federation: a router listening for its peer
    (``--fed-listen 0``, one engine with one slot: its backlog overflows)
    and a router peering with it (``--peer``, room to spare, and its own
    requests staggered long enough to outlive the listener's first
    steps); the listener forwards, the peer adopts as many (and the
    other way round, when the peer's own queue backs up), both exit clean
    with zero dropped sessions.  Children log to files and every wait is
    bounded."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="2")
    args = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "smollm-135m", "--smoke", "--device", "cpu", "--max-len", "64",
            "--page-size", "16", "--router", "--engines", "1",
            "--new-tokens", "12"]
    olog, plog = tmp_path / "origin.log", tmp_path / "peer.log"
    with open(olog, "w") as of, open(plog, "w") as pf:
        origin = subprocess.Popen(
            args + ["--batch", "1", "--requests", "6", "--fed-listen", "0"],
            stdout=of, stderr=subprocess.STDOUT, env=env)
        peer = None
        try:
            port = _wait_for_port(origin, olog, time.time() + 120)
            peer = subprocess.Popen(
                args + ["--batch", "4", "--requests", "4", "--stagger",
                        "16", "--peer", f"127.0.0.1:{port}"],
                stdout=pf, stderr=subprocess.STDOUT, env=env)
            assert origin.wait(timeout=180) == 0, olog.read_text()
            assert peer.wait(timeout=120) == 0, plog.read_text()
        finally:
            for proc in (origin, peer):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    out, pout = olog.read_text(), plog.read_text()
    assert "federation: peered" in out and "federation: peered" in pout
    assert "0 dropped" in out and "0 dropped" in pout, (out, pout)
    forwarded, adopted_home = _fed_counts(out)
    forwarded_back, adopted = _fed_counts(pout)
    assert forwarded > 0 and adopted == forwarded, (out, pout)
    assert adopted_home == forwarded_back, (out, pout)
