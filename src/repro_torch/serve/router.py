"""Cluster routing front-end over N prefill/decode engine pairs.

The serving fabric's top layer: a :class:`Router` owns a cluster-wide
admission queue and N steppable pairs (loopback
:class:`~repro_torch.serve.disagg.DisaggPair`, in-process
:class:`~repro_torch.serve.transport.WirePair`, or cross-process
:class:`~repro_torch.serve.transport.WirePrefill` halves — anything with
``submit(session=)`` / ``step`` / ``has_work`` and a ``prefill`` engine),
placing sessions by a pluggable policy from a registry that mirrors the
scheduler/codec/transport registries:

- ``least_loaded`` — fewest in-system sessions (waiting + resident +
  in-flight on the transfer leg), ties to the lowest index;
- ``prefix_affinity`` — rendezvous (highest-random-weight) hash of the
  prompt's first ``prefix_len`` tokens, so sessions sharing a system
  prompt land on the same engine (KV reuse locality) yet redistribute
  minimally when an engine drains or is lost;
- ``round_robin`` — strict rotation, the baseline.

Admission is continuous-batching: each :meth:`Router.step` tops every
engine up to a bounded per-engine backlog (its ``window``) from the
cluster queue, so the load signal stays meaningful — an engine never
hoards the whole queue.  Per-tenant quotas are enforced cluster-wide for
free: every engine shares ONE :class:`~repro_torch.serve.quota.QuotaManager`
ledger, so a tenant's pages are bounded across the cluster, not per
engine.

Lifecycle: :meth:`drain` marks an engine DRAINING — placement stops
immediately, its un-admitted queue and parked transfer handoffs are
pulled back and redistributed, resident sessions retire in place, and the
engine detaches once idle (zero dropped sessions).  :meth:`fail` models
engine loss: every non-done session on the engine is reset and requeued
for a fresh prefill elsewhere — at temperature 0 the re-decoded stream is
identical, so a lost engine costs latency, never tokens.

Federation: a :class:`FederatedRouter` peers one cluster's router with
others over the wire framing (any transport ``Channel``; TCP across
processes or hosts, :func:`federate` in memory).  Work no local engine
has room for is forwarded to a peer advertising headroom and its token
stream comes home; a draining peer rejects forwards and a lost peer's
forwards requeue locally, so neither drops a session.
"""
from __future__ import annotations

import logging
import zlib
from collections import deque
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.serve.engine import Request
from repro_torch.serve.session import Session

log = logging.getLogger(__name__)

ACTIVE, DRAINING, LOST, DETACHED = "active", "draining", "lost", "detached"


class EngineView(NamedTuple):
    """What a placement policy sees of one engine."""

    index: int
    load: int           # in-system sessions (waiting + resident + in-flight)
    headroom: int       # admission window minus load (placeable slots)


# ---------------------------------------------------------------------------
# placement-policy registry (mirrors scheduler/codec/transport registries)
_PLACEMENTS: Dict[str, Callable[..., "PlacementPolicy"]] = {}


def register_placement(name: str, factory: Callable[..., "PlacementPolicy"]
                       ) -> None:
    _PLACEMENTS[name] = factory


def build_placement(policy, **kwargs) -> "PlacementPolicy":
    if not isinstance(policy, str):
        return policy
    if policy not in _PLACEMENTS:
        raise KeyError(f"unknown placement policy {policy!r}; "
                       f"registered: {registered_placements()}")
    return _PLACEMENTS[policy](**kwargs)


def registered_placements() -> tuple:
    return tuple(sorted(_PLACEMENTS))


class PlacementPolicy:
    """Chooses an engine index from the placeable views (never sees
    draining/lost engines — the router filters them first)."""

    name = "base"

    def choose(self, views: List[EngineView], sess: Session) -> int:
        raise NotImplementedError

    def describe(self) -> str:
        return self.name


class LeastLoaded(PlacementPolicy):
    name = "least_loaded"

    def choose(self, views: List[EngineView], sess: Session) -> int:
        return min(views, key=lambda v: (v.load, v.index)).index


class RoundRobin(PlacementPolicy):
    """Rotate by engine *identity*, not list position: when an engine
    drains or is lost the placeable list shrinks, and a positional
    ``turn % len(views)`` cursor would shift onto whichever engine
    happens to inherit the vacated slot — double-placing on it while
    skipping another.  Remembering the last-placed engine index and
    advancing to the next-larger live index keeps the rotation fair
    across membership changes."""

    name = "round_robin"

    def __init__(self):
        self._last = -1                 # engine index placed last

    def choose(self, views: List[EngineView], sess: Session) -> int:
        order = sorted(v.index for v in views)
        nxt = next((i for i in order if i > self._last), order[0])
        self._last = nxt
        return nxt


class PrefixAffinity(PlacementPolicy):
    """Rendezvous-hash the prompt prefix onto the live engines.

    Sessions sharing their first ``prefix_len`` tokens (system prompts,
    few-shot preambles) map to the same engine, concentrating prefix KV
    where it can be reused; because each (prefix, engine) pair scores
    independently, removing an engine only remaps ITS sessions — the
    affinity of everyone else survives a drain.  ``spill_at`` headroom
    exhaustion falls back to least-loaded so a hot prefix cannot wedge
    the cluster behind one engine."""

    name = "prefix_affinity"

    def __init__(self, prefix_len: int = 8):
        self.prefix_len = prefix_len

    def _key(self, sess: Session) -> tuple:
        prompt = sess.request.prompt
        return tuple(int(t) for t in prompt[:self.prefix_len])

    def choose(self, views: List[EngineView], sess: Session) -> int:
        key = self._key(sess)

        def score(v: EngineView) -> int:
            return zlib.crc32(repr((key, v.index)).encode())

        ranked = sorted(views, key=score, reverse=True)
        for v in ranked:
            if v.headroom > 0:
                return v.index
        return ranked[0].index


register_placement("least_loaded", LeastLoaded)
register_placement("round_robin", RoundRobin)
register_placement("prefix_affinity", PrefixAffinity)


# ---------------------------------------------------------------------------
class RouterEngine:
    """One routable pair plus its cluster-side state."""

    def __init__(self, pair, index: int, window: Optional[int] = None):
        self.pair = pair
        self.index = index
        self.state = ACTIVE
        if window is None:
            window = getattr(pair, "window_hint", None)
        if window is None:
            decode = getattr(pair, "decode", None)
            window = pair.prefill.batch + (decode.batch if decode is not None
                                           else pair.prefill.batch)
        self.window = max(1, window)

    # ------------------------------------------------------------------
    def load(self) -> int:
        """In-system sessions: the placement signal."""
        p = self.pair.prefill
        n = len(p.scheduler.waiting()) + len(p.cache.running())
        n += self.pair.transfer.depth()
        decode = getattr(self.pair, "decode", None)
        if decode is not None:
            n += len(decode.scheduler.waiting()) + len(decode.cache.running())
        else:
            n += self.pair.transfer.outstanding() - self.pair.transfer.depth()
        return n

    def view(self) -> EngineView:
        load = self.load()
        return EngineView(self.index, load, self.window - load)

    def placeable(self) -> bool:
        return self.state == ACTIVE

    def live(self) -> bool:
        return self.state in (ACTIVE, DRAINING)

    def describe(self) -> str:
        return (f"engine[{self.index} {self.state} load={self.load()}"
                f"/{self.window}]")


class Router:
    """Cluster-wide admission queue + placement over N engine pairs.

    The router owns session identity: it mints each :class:`Session` with
    a cluster-global ``seq`` and hands the SAME object to whichever
    engine serves it (``Engine.submit(session=)``), so scheduler
    ordering, the token-stream alias, and quota charges survive
    redistribution.  ``now`` counts router steps — deadlines and the SLO
    report are measured on this clock."""

    def __init__(self, pairs, *, placement="least_loaded",
                 window: Optional[int] = None, **placement_kwargs):
        if not pairs:
            raise ValueError("need at least one engine pair")
        self.engines = [RouterEngine(p, i, window=window)
                        for i, p in enumerate(pairs)]
        self.policy = build_placement(placement, **placement_kwargs)
        self.queue: Deque[Session] = deque()
        self.sessions: Dict[int, Session] = {}
        self.now = 0
        self._seq = 0
        self.submitted_at: Dict[int, int] = {}
        self.first_token_at: Dict[int, int] = {}
        self.finished_at: Dict[int, int] = {}
        self.placement_log: List[tuple] = []   # (uid, engine index)
        self.requeues = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request, on_token=None) -> Session:
        """Queue a request cluster-wide; placement happens at step time."""

        def hook(sess: Session, token: int) -> None:
            self.first_token_at.setdefault(sess.uid, self.now)
            if on_token is not None:
                on_token(sess, token)

        sess = Session(request=req, seq=self._seq, on_token=hook)
        self._seq += 1
        self.sessions[sess.uid] = sess
        self.submitted_at[sess.uid] = self.now
        self.queue.append(sess)
        return sess

    def cancel(self, uid: int) -> None:
        sess = self.sessions.get(uid)
        if sess is not None and not sess.done:
            sess.cancel()

    # ------------------------------------------------------------------
    def _views(self) -> List[EngineView]:
        return [e.view() for e in self.engines if e.placeable()]

    def _place(self) -> int:
        """Top engines up from the cluster queue (continuous batching)."""
        placed = 0
        while self.queue:
            if self.queue[0].done:          # cancelled while queued
                self.queue.popleft()
                continue
            views = [v for v in self._views() if v.headroom > 0]
            if not views:
                break
            sess = self.queue.popleft()
            idx = self.policy.choose(views, sess)
            eng = self.engines[idx]
            assert eng.placeable(), \
                f"policy placed uid={sess.uid} on a {eng.state} engine"
            eng.pair.submit(session=sess)
            self.placement_log.append((sess.uid, idx))
            placed += 1
        return placed

    def step(self) -> int:
        """One cluster round: place, step every live engine, account
        retirements, detach drained engines.  Returns placed + busy."""
        self.now += 1
        placed = self._place()
        busy = 0
        for eng in self.engines:
            if eng.live():
                busy += eng.pair.step()
        self._scan_finished()
        self._advance_drains()
        return placed + busy

    def _scan_finished(self) -> None:
        for uid, sess in self.sessions.items():
            if sess.done and uid not in self.finished_at:
                self.finished_at[uid] = self.now

    def _advance_drains(self) -> None:
        for eng in self.engines:
            if eng.state == DRAINING and not eng.pair.has_work():
                eng.state = DETACHED
                log.info("engine %d drained and detached", eng.index)

    # ------------------------------------------------------------------
    def _requeue_session(self, sess: Session) -> None:
        """Reset a displaced session for a fresh prefill elsewhere.

        The quota charge is released (re-charged at readmission) and the
        partial stream is discarded — at temperature 0 the replacement
        engine re-derives the identical tokens, so displacement costs
        latency, never correctness."""
        quota = self.engines[0].pair.prefill.quota   # ONE shared ledger
        if quota is not None:
            quota.release_uid(sess.uid)
        if sess.done:
            return
        sess.rewind()                   # keeps the Request.out_tokens alias
        self.queue.append(sess)
        self.requeues += 1

    def _pull_unadmitted(self, eng: RouterEngine) -> int:
        """Pull not-yet-admitted sessions off an engine's prefill queue."""
        pulled = 0
        sched = eng.pair.prefill.scheduler
        while True:
            sess = sched.next_ready()
            if sess is None:
                break
            self._requeue_session(sess)
            pulled += 1
        return pulled

    def _pull_parked(self, eng: RouterEngine) -> int:
        """Pull parked handoffs back out of an engine's transfer leg.

        Loopback queues hand their parked sessions back (payloads
        discarded, budget returned).  A wire sender's in-flight handoffs
        are already on the remote side — they ride to completion there
        and the drain simply waits them out (``pair.has_work``)."""
        transfer = eng.pair.transfer
        if not hasattr(transfer, "discard"):
            return 0
        pulled = 0
        while True:
            handoff = transfer.next_ready()
            if handoff is None:
                break
            transfer.discard(handoff)
            self._requeue_session(handoff.session)
            pulled += 1
        return pulled

    def drain(self, index: int) -> None:
        """Gracefully drain one engine: stop placing on it immediately,
        redistribute everything not yet resident, let resident sessions
        retire in place; it detaches once idle."""
        eng = self.engines[index]
        if eng.state != ACTIVE:
            raise ValueError(f"cannot drain engine {index}: {eng.state}")
        eng.state = DRAINING
        pulled = self._pull_unadmitted(eng) + self._pull_parked(eng)
        log.info("draining engine %d: redistributed %d sessions",
                 index, pulled)

    def fail(self, index: int) -> None:
        """Engine loss: its resident KV is gone; every non-done session
        it held is requeued for a fresh prefill elsewhere.  A wire pair's
        decode side holds sessions rebuilt off the wire: the router's own
        session of that uid is the one requeued (the reference requeues
        the rebuilt copy, and the router's session never finishes:
        ROADMAP C14)."""
        eng = self.engines[index]
        if not eng.live():
            raise ValueError(f"cannot fail engine {index}: {eng.state}")
        eng.state = LOST
        displaced: Dict[int, Session] = {}
        for owner in filter(None, (eng.pair.prefill,
                                   getattr(eng.pair, "decode", None))):
            for sess in owner.sessions:
                if not sess.done:
                    displaced[sess.uid] = self.sessions.get(sess.uid, sess)
        for sess in displaced.values():
            self._requeue_session(sess)
        log.warning("engine %d lost: requeued %d sessions",
                    index, len(displaced))

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return bool(self.queue) or any(
            e.live() and e.pair.has_work() for e in self.engines)

    def run(self, max_steps: int = 100_000,
            on_step: Optional[Callable[["Router"], None]] = None
            ) -> List[Request]:
        """Drain the cluster; ``on_step`` (called after each round) is
        the hook drain/fail scenarios inject themselves through."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            self.step()
            if on_step is not None:
                on_step(self)
        return [s.request for s in self.sessions.values() if s.done]

    # ------------------------------------------------------------------
    def slo_report(self) -> Dict[str, Any]:
        """Deadline outcomes on the router clock (finish step vs the
        request's absolute-step deadline)."""
        met = missed = 0
        for uid, sess in self.sessions.items():
            deadline = sess.request.deadline
            if deadline is None or uid not in self.finished_at:
                continue
            ok = (self.finished_at[uid] <= deadline
                  and sess.finish_reason in ("eos", "length"))
            met, missed = met + ok, missed + (not ok)
        total = met + missed
        return {"met": met, "missed": missed,
                "miss_rate": missed / total if total else 0.0}

    def ttft_report(self) -> Dict[str, float]:
        waits = [self.first_token_at[uid] - self.submitted_at[uid]
                 for uid in self.first_token_at]
        if not waits:
            return {"mean": 0.0, "p99": 0.0, "n": 0}
        waits.sort()
        return {"mean": sum(waits) / len(waits),
                "p99": float(waits[min(len(waits) - 1,
                                       int(0.99 * len(waits)))]),
                "n": len(waits)}

    def traffic_report(self) -> Dict[str, Any]:
        return {f"engine{e.index}": e.pair.traffic_report()
                for e in self.engines if e.state != LOST}

    def describe(self) -> str:
        states = " ".join(e.describe() for e in self.engines)
        return (f"router[{self.policy.describe()} queue={len(self.queue)} "
                f"now={self.now} | {states}]")


# ---------------------------------------------------------------------------
# router-to-router federation: clusters peer over the same wire framing
class _Peer:
    """Cluster-side state for one federated peer."""

    def __init__(self, name: str, channel):
        self.name = name
        self.channel = channel
        self.free = 0                   # last advertised placeable headroom
        self.draining = False
        self.closed = False
        self.outstanding: Dict[int, Session] = {}   # fid -> origin session

    def sendable(self) -> bool:
        return not (self.draining or self.closed)


#: local uids for foreign (forwarded-in) sessions live far above any
#: origin-minted uid so the two spaces can never collide on one ledger
FOREIGN_UID_BASE = 1 << 40
#: seconds an idle federated run waits on its peers' sockets a step
IDLE_WAIT_S = 0.005


class FederatedRouter:
    """A cluster :class:`Router` peered with remote clusters over the wire.

    Peers speak the transport framing (``K_FWD`` / ``K_FWD_RESULT`` /
    ``K_FWD_REJECT`` / ``K_LOAD`` / ``K_QUOTA`` / ``K_DRAIN`` / ``K_BYE``)
    over any :class:`~repro_torch.serve.transport.Channel`.  Each step the
    local router places what it can; if the cluster queue is still
    backed up and a peer advertises free headroom (LOAD frames), the
    queue head is forwarded (FWD) — the peer admits it as a *foreign*
    session under a collision-free local uid, serves it to completion,
    and returns the token stream (FWD_RESULT), which is applied to the
    origin :class:`Session` object exactly like a wire RESULT.  A
    draining peer rejects inbound forwards (FWD_REJECT → the origin
    requeues locally; zero dropped sessions) and broadcasts DRAIN so
    origins stop selecting it.

    Quota stays consistent across clusters without a central ledger:
    every step each cluster broadcasts its local
    :meth:`~repro_torch.serve.quota.QuotaManager.usage` snapshot (QUOTA), and
    each receiver installs it as a remote overlay
    (:meth:`~repro_torch.serve.quota.QuotaManager.set_remote_usage`) that
    ``can_admit`` counts — one tenant's page budget binds over the sum
    of local + remote holdings, eventually consistent at the broadcast
    cadence."""

    def __init__(self, router: Router, *, name: str = "cluster"):
        self.router = router
        self.name = name
        self.peers: Dict[str, _Peer] = {}
        self.draining = False
        # foreign sessions this cluster serves for its peers
        self._foreign: Dict[int, tuple] = {}    # local uid -> (peer, fid)
        self._foreign_done: set = set()         # result already returned
        self._next_foreign = FOREIGN_UID_BASE
        self.forwarded = 0
        self.adopted = 0
        self.rejected = 0
        self.sent: Dict[int, List[int]] = {}    # frame kind -> [bytes, frames]

    # ------------------------------------------------------------------
    def add_peer(self, name: str, channel) -> None:
        if name in self.peers:
            raise ValueError(f"peer {name!r} already registered")
        self.peers[name] = _Peer(name, channel)

    @property
    def quota(self):
        return self.router.engines[0].pair.prefill.quota

    def submit(self, req: Request, on_token=None) -> Session:
        return self.router.submit(req, on_token=on_token)

    def cancel(self, uid: int) -> None:
        self.router.cancel(uid)

    # ------------------------------------------------------------------
    def _send(self, peer: _Peer, kind: int, msg: Dict[str, Any]) -> None:
        from repro_torch.serve import transport as tfm
        try:
            n = tfm._send_msg(peer.channel, kind, msg)
        except tfm.TransportError as e:
            log.warning("peer %s unreachable, detaching: %s", peer.name, e)
            self._lose_peer(peer)
            return
        meter = self.sent.setdefault(kind, [0, 0])
        meter[0] += n
        meter[1] += 1

    def _lose_peer(self, peer: _Peer) -> None:
        """A dead peer's forwarded sessions requeue locally — the
        federation analogue of :meth:`Router.fail`."""
        peer.closed = True
        if self.quota is not None:
            self.quota.set_remote_usage(peer.name, None)
        for fid, sess in list(peer.outstanding.items()):
            if not sess.done:
                sess.rewind()
                self.router.queue.append(sess)
                self.router.requeues += 1
        peer.outstanding.clear()

    # ------------------------------------------------------------------
    def _pump_peer(self, peer: _Peer) -> None:
        from repro_torch.serve import transport as tfm
        while True:
            try:
                got = tfm._poll_msg(peer.channel, retries=2, backoff=0.0,
                                    sleep=lambda s: None)
            except tfm.TransportError as e:
                log.warning("peer %s channel failed: %s", peer.name, e)
                self._lose_peer(peer)
                return
            if got is None:
                return
            kind, msg = got
            if kind == tfm.K_LOAD:
                peer.free = int(msg["free"])
            elif kind == tfm.K_QUOTA:
                if self.quota is not None:
                    self.quota.set_remote_usage(peer.name, msg["usage"])
            elif kind == tfm.K_FWD:
                self._adopt_forward(peer, msg)
            elif kind == tfm.K_FWD_RESULT:
                self._apply_forward_result(peer, msg)
            elif kind == tfm.K_FWD_REJECT:
                sess = peer.outstanding.pop(msg["fid"], None)
                if sess is not None and not sess.done:
                    sess.rewind()
                    self.router.queue.append(sess)
                    self.router.requeues += 1
            elif kind == tfm.K_DRAIN:
                peer.draining = True
                peer.free = 0
            elif kind == tfm.K_BYE:
                self._lose_peer(peer)
            else:
                raise tfm.WireFormatError(
                    f"unexpected federation frame kind {kind}")

    def _adopt_forward(self, peer: _Peer, msg: Dict[str, Any]) -> None:
        if self.draining:
            self.rejected += 1
            self._send(peer, _k().K_FWD_REJECT, {"fid": msg["fid"]})
            return
        uid = self._next_foreign
        self._next_foreign += 1
        req = Request(uid=uid, prompt=np.asarray(msg["prompt"]),
                      max_new_tokens=msg["max_new_tokens"],
                      eos_id=msg["eos_id"], priority=msg["priority"],
                      tenant=msg["tenant"], deadline=msg["deadline"])
        self.router.submit(req)
        self._foreign[uid] = (peer.name, msg["fid"])
        self.adopted += 1

    def _apply_forward_result(self, peer: _Peer, msg: Dict[str, Any]) -> None:
        sess = peer.outstanding.pop(msg["fid"], None)
        if self.quota is not None:
            self.quota.release_uid(msg["fid"])
        if sess is None:
            return
        if not sess.done:
            # same list object: keep the Request.out_tokens alias intact
            del sess.tokens[:]
            sess.tokens.extend(msg["tokens"])
            sess.length = int(msg["length"])
            sess.finish(msg["finish_reason"])
        self.router.finished_at.setdefault(sess.uid, self.router.now)

    def _flush_foreign_results(self) -> None:
        for uid, (peer_name, fid) in list(self._foreign.items()):
            sess = self.router.sessions.get(uid)
            peer = self.peers.get(peer_name)
            if sess is None or not sess.done or uid in self._foreign_done:
                continue
            self._foreign_done.add(uid)
            if peer is not None and not peer.closed:
                self._send(peer, _k().K_FWD_RESULT, {
                    "fid": fid,
                    "tokens": list(sess.tokens),
                    "length": int(sess.length),
                    "finish_reason": sess.finish_reason,
                })

    # ------------------------------------------------------------------
    def _forward_backlog(self) -> int:
        """Forward queue-head sessions no local engine has headroom for."""
        if self.draining:
            return 0
        sent = 0
        while self.router.queue:
            if any(v.headroom > 0 for v in self.router._views()):
                break                    # local placement will take it
            targets = [p for p in self.peers.values()
                       if p.sendable() and p.free > 0]
            if not targets:
                break
            sess = self.router.queue.popleft()
            if sess.done:
                continue
            peer = max(targets, key=lambda p: p.free)
            peer.free -= 1               # optimistic; refreshed by LOAD
            self._send(peer, _k().K_FWD, {
                "fid": sess.uid,
                "prompt": np.asarray(sess.request.prompt),
                "max_new_tokens": int(sess.request.max_new_tokens),
                "eos_id": int(sess.request.eos_id),
                "priority": int(getattr(sess.request, "priority", 0)),
                "tenant": sess.tenant,
                "deadline": getattr(sess.request, "deadline", None),
            })
            if peer.closed:              # send failed, session requeued
                continue
            peer.outstanding[sess.uid] = sess
            self.forwarded += 1
            sent += 1
        return sent

    def _broadcast_state(self) -> None:
        free = sum(max(0, v.headroom) for v in self.router._views())
        if self.draining:
            free = 0
        usage = self.quota.usage() if self.quota is not None else None
        for peer in list(self.peers.values()):
            if peer.closed:
                continue
            self._send(peer, _k().K_LOAD, {"free": free})
            if usage is not None and not peer.closed:
                self._send(peer, _k().K_QUOTA, {"usage": usage})

    # ------------------------------------------------------------------
    def step(self) -> int:
        for peer in list(self.peers.values()):
            if not peer.closed:
                self._pump_peer(peer)
        busy = self.router.step()
        busy += self._forward_backlog()
        self._flush_foreign_results()
        self._broadcast_state()
        return busy

    def drain(self) -> None:
        """Drain this whole cluster: stop forwarding out, reject inbound
        forwards, broadcast DRAIN; local + already-adopted work retires
        in place and forwarded-out sessions ride to completion on their
        peers."""
        self.draining = True
        for peer in list(self.peers.values()):
            if not peer.closed:
                self._send(peer, _k().K_DRAIN, {})

    def close(self) -> None:
        for peer in list(self.peers.values()):
            if not peer.closed:
                self._send(peer, _k().K_BYE, {})
                peer.closed = True

    # ------------------------------------------------------------------
    def has_work(self) -> bool:
        return (self.router.has_work()
                or any(p.outstanding for p in self.peers.values())
                or any(uid not in self._foreign_done
                       for uid in self._foreign))

    def run(self, max_steps: int = 100_000,
            on_step: Optional[Callable[["FederatedRouter"], None]] = None
            ) -> List[Request]:
        """Step until this cluster has no work.  A step that finds nothing
        to do locally (only forwards outstanding on peers) waits up to
        ``IDLE_WAIT_S`` for a peer's socket to turn readable instead of
        spinning: a spinning origin would send a LOAD and a QUOTA frame
        a step to a peer that has to read them all, and use up
        ``max_steps`` in seconds."""
        for _ in range(max_steps):
            if not self.has_work():
                break
            busy = self.step()
            if on_step is not None:
                on_step(self)
            if not busy and not self.router.has_work():
                self._await_peers(IDLE_WAIT_S)
        return [s.request for s in self.router.sessions.values() if s.done]

    def _await_peers(self, timeout: float) -> None:
        for peer in self.peers.values():
            waiter = getattr(peer.channel, "wait_readable", None)
            if not peer.closed and waiter is not None and waiter(timeout):
                return

    def describe(self) -> str:
        peers = " ".join(
            f"{p.name}:{'x' if p.closed else ('drain' if p.draining else p.free)}"
            for p in self.peers.values())
        return (f"fed[{self.name} fwd={self.forwarded} "
                f"adopted={self.adopted} | {peers or 'no peers'}]")

    def wire_summary(self) -> str:
        """The bytes and frames this cluster sent its peers, by kind."""
        names = _k()._KIND_NAMES
        return "federation sent: " + (", ".join(
            f"{names[k]} {b} B/{n}x" for k, (b, n) in sorted(
                self.sent.items())) or "nothing")


def _k():
    """Frame-kind namespace (import deferred: transport imports session,
    router imports transport lazily to stay cycle-free)."""
    from repro_torch.serve import transport
    return transport


def federate(routers: List[Router], *, names: Optional[List[str]] = None,
             max_chunk: Optional[int] = None) -> List[FederatedRouter]:
    """Peer N local routers into a full federation mesh over in-memory
    channels (the same-process harness; cross-host uses TCP channels via
    :meth:`FederatedRouter.add_peer`)."""
    from repro_torch.serve.transport import memory_pair

    names = names or [f"cluster{i}" for i in range(len(routers))]
    feds = [FederatedRouter(r, name=n) for r, n in zip(routers, names)]
    for i in range(len(feds)):
        for j in range(i + 1, len(feds)):
            a, b = memory_pair(max_chunk)
            feds[i].add_peer(names[j], a)
            feds[j].add_peer(names[i], b)
    return feds


# ---------------------------------------------------------------------------
def build_router(model, params, *, engines: int = 2,
                 placement="least_loaded", window: Optional[int] = None,
                 quota=None, seed: int = 0,
                 placement_kwargs: Optional[Dict[str, Any]] = None,
                 **pair_kwargs) -> Router:
    """A router over N loopback pairs sharing ONE quota ledger.

    Each pair gets a disjoint seed block (``seed + 2*i``: prefill, +1
    decode — the ``build_disagg`` discipline), so engines sample
    independently while staying reproducible.  ``pair_kwargs`` forward to
    :func:`~repro_torch.serve.disagg.build_disagg` (batch, page_size, pages,
    transfer, spill, scheduler, ...)."""
    from repro_torch.serve.disagg import build_disagg
    from repro_torch.serve.quota import QuotaManager, TenantQuota

    if quota is None or isinstance(quota, QuotaManager):
        shared = quota
    elif isinstance(quota, TenantQuota):
        shared = QuotaManager(default_quota=quota)
    else:
        shared = QuotaManager(dict(quota))

    pairs = [build_disagg(model, params, quota=shared, seed=seed + 2 * i,
                          **pair_kwargs)
             for i in range(engines)]
    return Router(pairs, placement=placement, window=window,
                  **(placement_kwargs or {}))


def replay_trace(router: Router, trace, vocab: int, *,
                 arrivals_per_step: float = 1.0,
                 max_steps: int = 200_000,
                 on_step: Optional[Callable[[Router], None]] = None
                 ) -> List[Request]:
    """Replay a :func:`repro_torch.sim.workloads.generate_traffic` trace
    against a real router, scaled down: arrival times are quantized onto
    the router's step clock at ``arrivals_per_step`` sessions per step.

    Prompts are derived deterministically from each synthetic session's
    ``prefix_id``/``uid`` (shared prefixes really share tokens, so
    ``prefix_affinity`` has something to exploit); deadlines become
    absolute router steps from the session's SLO slack."""
    sessions = sorted(trace, key=lambda s: (s.arrival, s.uid))
    pending = deque()
    for i, s in enumerate(sessions):
        arrive_step = int(i / max(arrivals_per_step, 1e-9))
        prompt = synth_prompt(s, vocab)
        deadline = None
        if s.slo != "batch":
            # slack scales with the decode budget; floor keeps tiny
            # requests from being born dead on the step clock
            deadline = arrive_step + max(8, int(s.slack_steps))
        pending.append((arrive_step, Request(
            uid=s.uid, prompt=prompt, max_new_tokens=s.decode_len,
            tenant=s.tenant, deadline=deadline,
            priority=1 if s.slo == "interactive" else 0)))

    def feed(r: Router) -> None:
        while pending and pending[0][0] <= r.now:
            r.submit(pending.popleft()[1])
        if on_step is not None:
            on_step(r)

    feed(router)
    for _ in range(max_steps):
        if not pending and not router.has_work():
            break
        router.step()
        feed(router)
    return [s.request for s in router.sessions.values() if s.done]


def synth_prompt(s, vocab: int):
    """Deterministic tokens for a synthetic session: the shared prefix is
    a pure function of ``prefix_id``, the tail of ``uid`` — two sessions
    with the same prefix_id share their first ``prefix_len`` tokens
    exactly."""
    lo, hi = 1, max(2, vocab - 1)
    parts = []
    if s.prefix_id is not None and s.prefix_len > 0:
        rng = np.random.default_rng(10_000 + s.prefix_id)
        parts.append(rng.integers(lo, hi, size=min(s.prefix_len,
                                                   s.prompt_len)))
    tail = s.prompt_len - (len(parts[0]) if parts else 0)
    if tail > 0:
        rng = np.random.default_rng(20_000 + s.uid)
        parts.append(rng.integers(lo, hi, size=tail))
    return np.concatenate(parts).astype(np.int32) if parts else \
        np.array([lo], np.int32)
