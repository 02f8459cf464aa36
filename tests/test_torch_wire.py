"""The port's wire transport against the JAX reference, on the CPU.

Reduced smollm-135m in float32, the reference's weights carried over with
``repro_torch.convert.params_from_jax``.  The cases are the reference's
(``tests/test_transport.py``, ``tests/test_wire_scaleout.py`` without
federation):

* frames: for every kind each package packs the same bytes and reads the
  other's frames; corrupt, schema, magic, partial-read and starvation
  errors match;
* wire pairs over memory / TCP / fragmented / striped / shm stream what
  the port's loopback pair and the reference's wire pair stream, bit for
  bit, and ``kv_wire`` reconciles exactly with the bytes the channel
  carried;
* codecs, cancel in transit, publish failures, stripe death, poisoned
  channels, the decode worker loop, ``submit(session=)``;
* the reference's ``build_wire_prefill`` hands off over a real TCP socket
  to the port's ``run_decode_worker``, and the streams are bit-identical.

Every wait is bounded: sockets take port 0 and carry timeouts, threads are
joined with a timeout and the test fails on expiry, channels (and their
``/dev/shm`` arenas) close in ``finally``.
"""
import pickle
import threading
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import MemoryPlan as JMemoryPlan
from repro.configs import MeshPlan, RunConfig as JRunConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models.model import build_model as jbuild
from repro.serve import transport as jtp
from repro.serve.engine import Request as JRequest
from repro_torch.configs import ARCHS as TARCHS
from repro_torch import tree
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref as kref
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve import transport as tp
from repro_torch.serve.disagg import build_disagg
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.session import Session
from repro_torch.serve.transport import (Channel, ShmChannel, StripedChannel,
                                         TransportError, WireFormatError,
                                         build_transport, build_wire_pair,
                                         memory_pair, pack_frame, recv_frame,
                                         registered_transports,
                                         run_decode_worker, striped_pair,
                                         tcp_pair)

KIND_NAMES = sorted(tp._KIND_NAMES.items())
#: seconds any thread or socket wait in this file may take
JOIN_S = 60.0


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
    """The reference's prompts (``tests/test_transport.py:_prompts``)."""
    return [((np.arange(base + i, dtype=np.int32) * (i + 2) + 1) % vocab)
            for i in range(n)]


def _drive(pair, prompts, new_tokens=6, request_cls=Request):
    ss = [pair.submit(request_cls(uid=i, prompt=p,
                                  max_new_tokens=new_tokens))
          for i, p in enumerate(prompts)]
    pair.run()
    return [s.result() for s in ss]


def _closing(pair):
    """Close a wire pair's channels (joins stripe threads, unlinks an shm
    arena)."""
    for ch in (pair.sender.channel, pair.receiver.channel):
        ch.close()


def _no_sleep(_):
    raise AssertionError("framing slept on a healthy channel")


@pytest.fixture(scope="module")
def want(smollm):
    """Five prompts, and the streams of the port's loopback pair, which
    must equal the reference's wire pair's."""
    jm, jp, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 5)
    loop = build_disagg(tm, params, batch=2, max_len=64, page_size=16,
                        transfer="host", spill="host")
    got = _drive(loop, prompts)
    jwire = jtp.build_wire_pair(jm, jp, batch=2, max_len=64, page_size=16,
                                spill="host", transport="memory")
    assert _drive(jwire, prompts, request_cls=JRequest) == got
    return prompts, got


# ---------------------------------------------------------------------------
# frames
def _page_frame(module, msg):
    """A K_PAGE frame as ``module``'s striped sender writes it (Adler-32,
    pickle-5 out-of-band buffers)."""
    a, b = module.memory_pair()
    n = module._send_page_frame(a, msg)
    frame = b.recv(1 << 20)
    assert len(frame) == n
    return frame


@pytest.mark.parametrize("kind,name", KIND_NAMES)
def test_frames_byte_equal_and_cross_readable(kind, name):
    if kind == tp.K_PAGE:
        msg = {"msg_id": 3, "seq": 1,
               "page": np.arange(40, dtype=np.float32).reshape(5, 8)}
        frame = _page_frame(tp, msg)
        assert frame == _page_frame(jtp, msg)
        for read, unpack in ((recv_frame, tp._unpack_page_payload),
                             (jtp.recv_frame, jtp._unpack_page_payload)):
            a, b = memory_pair()
            a.send(frame)
            got_kind, payload = read(b, sleep=_no_sleep)
            got = unpack(payload)
            assert got_kind == kind and got["seq"] == 1
            assert np.array_equal(got["page"], msg["page"])
        return
    payload = pickle.dumps({"kind": name, "blob": b"x" * kind}, 4)
    frame = pack_frame(kind, payload)
    assert frame == jtp.pack_frame(kind, payload)
    for pack, read in ((pack_frame, jtp.recv_frame),
                       (jtp.pack_frame, recv_frame)):
        a, b = (memory_pair() if read is recv_frame else jtp.memory_pair())
        a.send(pack(kind, payload))
        assert read(b, sleep=_no_sleep) == (kind, payload)
        assert read(b, sleep=_no_sleep) is None
    assert (tp.SCHEMA_VERSION, tp._MAGIC) == (jtp.SCHEMA_VERSION,
                                              jtp._MAGIC) == (2, b"KW")
    assert tp._KIND_NAMES == jtp._KIND_NAMES


def _bad_frames():
    payload = pickle.dumps({"uid": 1})
    corrupt = bytearray(pack_frame(tp.K_RESULT, payload))
    corrupt[tp._HEADER.size + 2] ^= 0xFF
    head = tp._HEADER.pack(tp._MAGIC, tp.SCHEMA_VERSION + 1, tp.K_ACK,
                           len(payload))
    schema = head + payload + tp._CRC.pack(
        zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF)
    return {"CRC": bytes(corrupt), "schema": schema,
            "magic": b"XXzzzzzzz" + b"\0" * 20}


@pytest.mark.parametrize("what", ["CRC", "schema", "magic"])
def test_bad_frames_raise_as_the_reference(what):
    """Each package refuses the same bad frame with the same message,
    before anything is unpickled, and the channel stays poisoned."""
    frame = _bad_frames()[what]
    errors = []
    for pair, read in ((memory_pair, recv_frame),
                       (jtp.memory_pair, jtp.recv_frame)):
        a, b = pair()
        a.send(frame)
        with pytest.raises(Exception, match=what) as info:
            read(b, sleep=_no_sleep)
        errors.append(str(info.value))
        with pytest.raises(Exception, match="poisoned"):
            read(b, sleep=_no_sleep)
    assert errors[0] == errors[1]
    a, b = memory_pair()
    a.send(frame)
    with pytest.raises(WireFormatError):
        recv_frame(b, sleep=_no_sleep)


def test_partial_reads_and_starvation_as_the_reference():
    payload = pickle.dumps(list(range(50)))
    a, b = memory_pair(max_chunk=1)
    a.send(pack_frame(tp.K_RESULT, payload))
    naps = []
    assert recv_frame(b, retries=3, backoff=0.5,
                      sleep=naps.append) == (tp.K_RESULT, payload)
    assert not naps
    frame = pack_frame(tp.K_ACK, pickle.dumps({"uid": 1}))
    msgs = []
    for pair, read in ((memory_pair, recv_frame),
                       (jtp.memory_pair, jtp.recv_frame)):
        a, b = pair()
        a.send(frame[:len(frame) // 2])
        naps = []
        with pytest.raises(Exception, match="partial read") as info:
            read(b, retries=3, backoff=0.5, sleep=naps.append)
        assert naps == [0.5, 1.0, 2.0]
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_poisoned_channel_fails_fast():
    a, b = memory_pair()
    frame = pack_frame(tp.K_ACK, b"\x80\x04N.")
    a.send(frame[:len(frame) - 3])
    with pytest.raises(TransportError, match="partial read"):
        recv_frame(b, retries=2, backoff=0.0, sleep=lambda s: None)
    a.send(frame[len(frame) - 3:])
    with pytest.raises(TransportError, match="poisoned"):
        recv_frame(b, retries=2, backoff=0.0, sleep=lambda s: None)


def test_registry_and_tcp_pair():
    assert set(registered_transports()) == {"memory", "tcp", "shm"}
    a, b = build_transport("memory")
    a.send(b"hi")
    assert b.recv(10) == b"hi"
    with pytest.raises(KeyError, match="unknown transport"):
        build_transport("carrier-pigeon")
    a, b = tcp_pair()
    try:
        payload = pickle.dumps(np.arange(1000))
        a.send(pack_frame(tp.K_HANDOFF, payload))
        assert recv_frame(b, retries=20, backoff=0.001) == (tp.K_HANDOFF,
                                                             payload)
        assert a.sock.gettimeout() is not None
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# wire leaves
def test_leaves_cross_in_dtype_and_bf16_as_v2():
    g = torch.Generator().manual_seed(0)
    page = {"g": {"k": torch.randn(2, 16, 3, 8, generator=g).bfloat16(),
                  "v": torch.randn(2, 16, 3, 8, generator=g)},
            "n": torch.arange(6, dtype=torch.int32)}
    (wired,), raw, wire, calls = tp._encode_trees([page], None)
    assert wired["g"]["k"].data.dtype == np.dtype("V2")
    assert wired["g"]["k"].dtype == "bfloat16"
    assert calls == 3 and raw == wire == 768 * 2 + 768 * 4 + 24
    # the same leaves under the reference's class unpickle into the port's
    blob = pickle.dumps(tree.map(lambda leaf: jtp._WireLeaf(
        leaf.data, leaf.scale, leaf.dtype, leaf.codec), wired), 5)
    assert b"repro.serve.transport" in blob
    got = tp._loads(blob)
    assert isinstance(got["g"]["k"], tp._WireLeaf)
    (back,) = tp._decode_trees([got], torch.device("cpu"))
    for path in (("g", "k"), ("g", "v"), ("n",)):
        x, y = page, back
        for key in path:
            x, y = x[key], y[key]
        assert y.dtype == x.dtype and torch.equal(y.view(torch.uint8),
                                                  x.view(torch.uint8))


@pytest.mark.parametrize("codec", ["int8", "fp8"])
def test_codec_leaf_is_the_plain_twin_and_near_the_reference(codec):
    """A coded page leaf decodes to the plain twins' result bit for bit
    (one row block a leaf); against the reference's wire codec it is held
    by decoded values: the reference's scale may sit one ulp from the
    IEEE quotient the port uses (ROADMAP C2), so a code may move one
    step."""
    x = torch.randn(2, 16, 3, 8, generator=torch.Generator().manual_seed(1))
    (wired,), raw, wire, _ = tp._encode_trees([{"k": x}], codec)
    (back,) = tp._decode_trees([wired], torch.device("cpu"))
    x2 = x.reshape(-1, x.shape[-1])
    q, s = getattr(kref, f"{codec}_pack_ref")(x2, block_rows=x2.shape[0])
    plain = kref.fp8_unpack_ref(q, s, block_rows=x2.shape[0],
                                dtype=x.dtype).reshape(x.shape)
    assert torch.equal(back["k"], plain)
    jleaf = jtp._encode_leaf(x.numpy(), codec)
    assert (jleaf.nbytes, jleaf.data.shape) == (wire, tuple(x.shape))
    assert raw == x.numel() * 4
    jback = jtp._decode_leaf(jleaf)
    step = float(s[0]) * (1.0 if codec == "int8" else 32.0)
    assert np.abs(np.asarray(jback) - back["k"].numpy()).max() <= step


# ---------------------------------------------------------------------------
# streams: wire == loopback == the reference's wire pair
TRANSPORTS = {
    "memory": dict(transport="memory"),
    "tcp": dict(transport="tcp"),
    "fragmented": dict(channels=lambda: memory_pair(max_chunk=127)),
    "striped": dict(streams=4),
    "striped_tcp_fragmented": dict(channels=lambda: striped_pair(
        3, max_chunk=127)),
    "shm": dict(transport="shm"),
}


@pytest.mark.parametrize("name", sorted(TRANSPORTS))
def test_wire_streams_identical(smollm, want, name):
    _, _, tm, params = smollm
    prompts, expect = want
    kw = dict(TRANSPORTS[name])
    if "channels" in kw:
        kw["channels"] = kw["channels"]()
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", **kw)
    try:
        assert _drive(wire, prompts) == expect
        rep = wire.traffic_report()
        out, inn = rep["wire_out"]["transfer"], rep["wire_in"]["transfer"]
        assert out["published"] == inn["published"] == 5
        assert inn["adopted_pages"] == inn["shipped_pages"] == 5
        assert out["depth"] == inn["depth"] == 0 == out["results"] - 5
        kv = rep["wire_out"]["kv_wire"]
        assert kv["wire_bytes"] == kv["raw_bytes"] == \
            wire.sender.channel.bytes_sent
        assert rep["wire_in"]["kv_wire"]["wire_bytes"] == \
            wire.receiver.channel.bytes_sent
        pub, adopt = rep["wire_out"]["kv_publish"], rep["wire_in"]["kv_adopt"]
        assert pub == adopt and pub["wire_bytes"] > 0
        if name == "shm":
            assert kv["wire_bytes"] < pub["wire_bytes"], \
                "shm headers should be far smaller than the tensor payload"
            chan = wire.sender.channel
            assert not chan._allocs
            assert chan.arena.free_bytes() == chan.arena.size
        elif name.startswith("striped"):
            chan = wire.sender.channel
            assert kv["wire_bytes"] == sum(s.bytes_sent
                                           for s in chan.stripes)
        else:
            assert kv["wire_bytes"] > pub["wire_bytes"]
    finally:
        _closing(wire)


def test_kv_bytes_match_the_reference(smollm):
    """Two-page handoffs: the publish and adopt legs meter the reference's
    bytes and calls (raw pages, and through the int8 codec); the frames'
    own bytes reconcile on each side."""
    jm, jp, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 4, base=18)
    for codec in (None, "int8"):
        wire = build_wire_pair(tm, params, batch=2, max_len=64,
                               page_size=16, spill="host", wire_codec=codec)
        jwire = jtp.build_wire_pair(jm, jp, batch=2, max_len=64,
                                    page_size=16, spill="host",
                                    wire_codec=codec)
        _drive(wire, prompts)
        _drive(jwire, prompts, request_cls=JRequest)
        rep, jrep = wire.traffic_report(), jwire.traffic_report()
        for side, leg in (("wire_out", "kv_publish"), ("wire_in",
                                                       "kv_adopt")):
            assert rep[side][leg] == jrep[side][leg], (codec, leg)
        for side in ("wire_out", "wire_in"):
            assert rep[side]["transfer"] == jrep[side]["transfer"]
        out = rep["wire_out"]["kv_wire"]["wire_bytes"]
        assert out == wire.sender.channel.bytes_sent > \
            rep["wire_out"]["kv_publish"]["wire_bytes"]
        if codec:
            pub = rep["wire_out"]["kv_publish"]
            assert pub["wire_bytes"] < pub["raw_bytes"]


def test_striped_codec_matches_single_stream(smollm):
    _, _, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 3, base=18)
    single = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                             spill="host", wire_codec="int8")
    striped = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                              spill="host", wire_codec="int8", streams=3)
    try:
        assert _drive(striped, prompts) == _drive(single, prompts)
        s_pub = single.traffic_report()["wire_out"]["kv_publish"]
        t_pub = striped.traffic_report()["wire_out"]["kv_publish"]
        assert t_pub == s_pub and s_pub["wire_bytes"] < s_pub["raw_bytes"]
    finally:
        _closing(striped)


class LateChannel(Channel):
    """Shows the bytes sent to it only ``lag`` reads after they arrive, as
    a socket polled before they have landed."""

    def __init__(self, inner, lag=8):
        self.inner, self.lag = inner, lag
        self.reads = 0
        self.landing = []           # (read count at arrival, bytes)
        self.landed = bytearray()

    def send(self, data: bytes) -> None:
        self.inner.send(data)

    def recv(self, n: int) -> bytes:
        self.reads += 1
        got = self.inner.recv(1 << 30)
        if got:
            self.landing.append((self.reads, got))
        while self.landing and self.reads - self.landing[0][0] >= self.lag:
            self.landed += self.landing.pop(0)[1]
        out = bytes(self.landed[:n])
        del self.landed[:n]
        return out

    def close(self) -> None:
        self.inner.close()

    @property
    def closed(self) -> bool:
        return self.inner.closed

    @property
    def bytes_sent(self) -> int:
        return self.inner.bytes_sent


def _steps(pair, prompts):
    """The decode slots' uids after every step, and the streams."""
    ss = [pair.submit(Request(uid=i, prompt=p, max_new_tokens=6))
          for i, p in enumerate(prompts)]
    steps = []
    for _ in range(10_000):
        pair.step()
        steps.append(tuple(s.uid for s in pair.decode.cache.running()))
        if not pair.has_work():
            break
    return steps, [s.result() for s in ss]


@pytest.mark.parametrize("late", ["decode side", "prefill side"])
def test_late_delivery_steps_as_the_loopback(smollm, late):
    """Frames that land late (HANDOFFs at the decode side, ACKs and
    RESULTs at the prefill side) still step the in-process pair as its
    loopback twin: the same sessions in the decode slots after every
    step, and the same streams."""
    _, _, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 5)
    loop = build_disagg(tm, params, batch=2, max_len=64, page_size=16,
                        transfer="host", spill="host")
    tx, rx = memory_pair()
    channels = ((tx, LateChannel(rx)) if late == "decode side"
                else (LateChannel(tx), rx))
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", channels=channels)
    assert _steps(wire, prompts) == _steps(loop, prompts)


@pytest.mark.parametrize("kw", [{}, {"streams": 3}, {"transport": "shm"}],
                         ids=["memory", "striped", "shm"])
def test_cancel_in_transit(smollm, kw):
    """A session cancelled while on the wire is CANCELed on the remote,
    its quota released on both sides (and its arena blocks freed)."""
    _, _, tm, params = smollm
    quota = QuotaManager(default_quota=TenantQuota(max_pages=64))
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", quota=quota, **kw)
    try:
        ss = [wire.submit(Request(uid=i, prompt=p, max_new_tokens=4))
              for i, p in enumerate(_prompts(tm.cfg.vocab_size, 3))]
        wire.prefill.step()
        ss[1].cancel()
        wire.run()
        assert ss[1].finish_reason == "cancelled"
        assert ss[0].done and ss[2].done
        assert quota.charged_uids() == ()
        if "transport" in kw:
            assert not wire.sender.channel._allocs
    finally:
        _closing(wire)


# ---------------------------------------------------------------------------
# faults
class FlakyChannel(Channel):
    """Fails the Nth send, wrapping a real channel."""

    def __init__(self, inner, fail_on: int):
        self.inner = inner
        self.fail_on = fail_on
        self.sends = 0

    def send(self, data: bytes) -> None:
        self.sends += 1
        if self.sends == self.fail_on:
            raise TransportError("injected send failure")
        self.inner.send(data)

    def recv(self, n: int) -> bytes:
        return self.inner.recv(n)

    def close(self) -> None:
        self.inner.close()

    @property
    def closed(self) -> bool:
        return self.inner.closed

    @property
    def bytes_sent(self) -> int:
        return self.inner.bytes_sent


def test_publish_failure_releases_quota_and_requeues(smollm, want):
    _, _, tm, params = smollm
    prompts, expect = want
    quota = QuotaManager(default_quota=TenantQuota(max_pages=64))
    tx, rx = memory_pair()
    flaky = FlakyChannel(tx, fail_on=1)
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", quota=quota, channels=(flaky, rx))
    ss = [wire.submit(Request(uid=i, prompt=p, max_new_tokens=6))
          for i, p in enumerate(prompts)]
    wire.prefill.step()                     # uid 0's publish fails
    assert 0 not in quota.charged_uids(), \
        "failed publish leaked its quota reservation"
    wire.run()
    assert [s.result() for s in ss] == expect
    assert quota.charged_uids() == ()
    assert all(s.finish_reason == "length" for s in ss)


def test_publish_failure_then_cancel_releases_quota(smollm):
    _, _, tm, params = smollm
    quota = QuotaManager(default_quota=TenantQuota(max_pages=64))
    tx, rx = memory_pair()
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", quota=quota,
                           channels=(FlakyChannel(tx, fail_on=1), rx))
    sess = wire.submit(Request(uid=0, prompt=_prompts(tm.cfg.vocab_size,
                                                      1)[0],
                               max_new_tokens=6))
    wire.prefill.step()
    sess.cancel()
    wire.run()
    assert sess.finish_reason == "cancelled"
    assert quota.charged_uids() == ()


def test_stripe_death_requeues_without_double_emit(smollm):
    """A stripe dying mid-handoff raises TransportError, the session
    replays from a fresh prefill, the ``emitted`` mark streams no position
    twice, and ``kv_wire`` still equals the bytes that crossed."""
    _, _, tm, params = smollm
    prompts = _prompts(tm.cfg.vocab_size, 4, base=18)
    loop = build_disagg(tm, params, batch=2, max_len=64, page_size=16,
                        transfer="host", spill="host")
    expect = _drive(loop, prompts)
    pairs = [memory_pair() for _ in range(3)]
    tx_stripes = [p[0] for p in pairs]
    flaky = FlakyChannel(tx_stripes[1], fail_on=1)
    tx_stripes[1] = flaky
    stx, srx = StripedChannel(tx_stripes), StripedChannel(
        [p[1] for p in pairs])
    wire = build_wire_pair(tm, params, batch=2, max_len=64, page_size=16,
                           spill="host", channels=(stx, srx))
    try:
        notified = {}
        ss = []
        for i, p in enumerate(prompts):
            s = wire.submit(Request(uid=i, prompt=p, max_new_tokens=6))
            s.on_token = lambda sess, tok: notified.setdefault(
                sess.uid, []).append(tok)
            ss.append(s)
        wire.run()
        assert flaky.sends >= 2, "the injected stripe death never fired"
        assert [s.result() for s in ss] == expect
        for s in ss:
            assert notified[s.uid] == list(s.tokens[:1])
        kv = wire.traffic_report()["wire_out"]["kv_wire"]
        assert kv["wire_bytes"] == stx.bytes_sent
    finally:
        _closing(wire)


def test_striped_rx_corruption_poisons_whole_channel():
    stx, srx = striped_pair(3)
    try:
        stx.stripes[1].send(b"XXgarbage-not-a-frame" * 4)
        deadline = time.time() + 10.0
        with pytest.raises(TransportError, match="stripe 1"):
            while time.time() < deadline:
                srx.poll_msg()
                time.sleep(0.002)
            pytest.fail("stripe corruption never surfaced")
        with pytest.raises(TransportError, match="poisoned"):
            srx.poll_msg()
    finally:
        stx.close()
        srx.close()


def _reassembly(msgs, streams, max_chunk, deadline_s=30.0):
    """The reference's striped-reassembly harness (test_wire_scaleout.py)
    on the port's channels: a striped pair and a single stream carry the
    same messages; returns both delivered sequences and meters."""
    stx, srx = striped_pair(streams, base="memory", max_chunk=max_chunk)
    mtx, mrx = memory_pair(max_chunk)
    try:
        s_total = m_total = 0
        for m in msgs:
            if m[0] == "handoff":
                pages = [np.frombuffer(b, dtype=np.uint8).copy()
                         for b in m[1]]
                hdr = {"schema": tp.SCHEMA_VERSION, "uid": len(pages),
                       "pages": [], "slot_one": None}
                s_total += tp._send_handoff_msg(stx, dict(hdr), pages)
                m_total += tp._send_handoff_msg(mtx, dict(hdr), pages)
            else:
                s_total += tp._send_msg(stx, m[1], {"uid": m[2]})
                m_total += tp._send_msg(mtx, m[1], {"uid": m[2]})

        def drain(ch):
            out, t0 = [], time.time()
            while len(out) < len(msgs):
                got = tp._poll_msg(ch, retries=4, backoff=0.0,
                                   sleep=lambda s: None)
                if got is None:
                    assert time.time() - t0 < deadline_s, "stalled"
                    time.sleep(0.001)
                    continue
                out.append(got)
            return out

        return (drain(srx), drain(mrx), (s_total, stx.bytes_sent),
                (m_total, mtx.bytes_sent))
    finally:
        stx.close()
        srx.close()


@pytest.mark.parametrize("streams,max_chunk",
                         [(1, None), (2, None), (3, 7), (4, 127)])
def test_striped_reassembly_seeded(streams, max_chunk):
    rng = np.random.default_rng(streams * 1000 + (max_chunk or 0))
    kinds = (tp.K_ACK, tp.K_CANCEL, tp.K_RESULT)
    msgs = []
    for i in range(8):
        if i % 3 == 2:
            msgs.append(("ctrl", kinds[i % len(kinds)], i))
        else:
            msgs.append(("handoff", [rng.bytes(int(n)) for n in
                                     rng.integers(0, 2048, size=i % 4)]))
    msgs.append(("ctrl", tp.K_RESULT, 99))
    striped, single, s_meter, m_meter = _reassembly(msgs, streams,
                                                    max_chunk)
    assert len(striped) == len(single) == len(msgs)
    for (ka, ma), (kb, mb) in zip(striped, single):
        assert ka == kb and set(ma) == set(mb)
        for key in ma:
            if key == "pages":
                assert all(np.array_equal(x, y)
                           for x, y in zip(ma[key], mb[key]))
                assert len(ma[key]) == len(mb[key])
            else:
                assert ma[key] == mb[key]
    assert s_meter[0] == s_meter[1] and m_meter[0] == m_meter[1]


# ---------------------------------------------------------------------------
# the worker loop, submit(session=), and the cross-package handoff
def _worker_thread(target, kwargs):
    box = {}

    def run():
        try:
            box["engine"] = target(**kwargs)
        except BaseException as e:          # surfaced by the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def _join(t, box):
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "the decode worker did not exit"
    if "error" in box:
        raise box["error"]
    return box["engine"]


def test_run_decode_worker_loop(smollm, want):
    _, _, tm, params = smollm
    prompts, expect = want
    tx, rx = memory_pair()
    half = tp.build_wire_prefill(tm, params, tx, max_len=64, page_size=16)
    t, box = _worker_thread(run_decode_worker, dict(
        model=tm, params=params, channel=rx, batch=2, max_len=64,
        page_size=16, spill="host", idle_sleep=0.001))
    try:
        ss = [half.submit(Request(uid=i, prompt=p, max_new_tokens=6))
              for i, p in enumerate(prompts)]
        half.run()
        assert [s.result() for s in ss] == expect
    finally:
        half.close()
    eng = _join(t, box)
    tq = eng.transfer.traffic_report()["transfer"]
    assert tq["adopted_pages"] == tq["published"] == 5


def test_engine_submit_session_passthrough(smollm):
    _, _, tm, params = smollm
    eng = Engine(tm, params, batch=2, max_len=64, page_size=16,
                 spill="host")
    req = Request(uid=7, prompt=_prompts(tm.cfg.vocab_size, 1)[0],
                  max_new_tokens=3)
    sess = Session(request=req, seq=42)
    assert eng.submit(session=sess) is sess and sess.seq == 42
    assert eng._seq == 43
    eng.run()
    assert sess.done and req.out_tokens is sess.tokens
    assert len(req.out_tokens) == 3


def test_reference_prefill_to_port_decode_over_tcp(smollm, want):
    """The cross-package deployment: the reference's prefill half (JAX)
    hands off over a real TCP socket to the port's decode worker (torch);
    its HANDOFF frames name the reference's ``_WireLeaf``, which the
    port's unpickler maps to its own, and the port's ACK / RESULT / BYE
    frames hold builtins the reference reads.  Streams bit-identical."""
    jm, jp, tm, params = smollm
    prompts, expect = want
    listener, port = tp.tcp_listen()
    t, box = _worker_thread(
        lambda **kw: run_decode_worker(
            channel=tp.tcp_connect("127.0.0.1", port, retries=5), **kw),
        dict(model=tm, params=params, batch=2, max_len=64, page_size=16,
             spill="host", idle_sleep=0.001))
    chan = jtp.tcp_accept(listener, timeout=JOIN_S)
    half = jtp.build_wire_prefill(jm, jp, chan, max_len=64, page_size=16)
    try:
        ss = [half.submit(JRequest(uid=i, prompt=p, max_new_tokens=6))
              for i, p in enumerate(prompts)]
        half.run()
        assert [s.result() for s in ss] == expect
        assert all(s.finish_reason == "length" for s in ss)
    finally:
        half.close()
    eng = _join(t, box)
    rep = eng.transfer.traffic_report()
    assert rep["transfer"]["adopted_pages"] == 5
    assert rep["kv_wire"]["wire_bytes"] == eng.transfer.channel.bytes_sent
    assert half.transfer.traffic_report()["kv_publish"] == rep["kv_adopt"]
