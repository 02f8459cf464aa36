"""Scheduler: admission, continuous batching and preemption policies.

One of the three serving APIs behind the ``Engine`` facade (DESIGN.md §6).
The scheduler owns every *waiting* session — freshly submitted and paused
(preempted) alike — and answers three questions each engine step:

  ``next_ready()``        which session takes the next free decode slot
  ``preempt_victim()``    which running session to pause when waiting work
                          outranks it (its KV spills to the secondary tier)
  ``has_waiting()``       is there admission pressure at all

Policies are registry-pluggable (:func:`register_scheduler` /
:func:`build_scheduler`), mirroring the tier/codec registries in
``core.tiers``:

* :class:`FCFSScheduler`     — run-to-completion first-come-first-served
  (the legacy engine behaviour; ``deque`` admission, no preemption).
* :class:`PriorityScheduler` — highest ``Request.priority`` first; a
  strictly higher-priority arrival preempts the lowest-priority running
  session (strict inequality prevents equal-priority thrash).
* :class:`FairScheduler`     — round-robin with a decode-token quantum:
  once a session has decoded ``quantum`` tokens while others wait, it is
  paused and requeued behind them.  This is the policy that keeps a
  many-requests/few-slots workload live for everyone (cold sessions wait
  in the spill tier, not in HBM).
* :class:`SRPTScheduler`     — shortest-remaining-processing-time first
  (``Session.remaining`` from ``max_new_tokens``), the mean-latency-
  optimal policy; strictly shorter waiting work preempts the longest
  running session.
* :class:`DeadlineScheduler` — earliest-deadline-first over
  ``Request.deadline`` (absolute engine steps via the :meth:`on_step`
  clock) with met/missed accounting at retirement.

Disaggregated serving (serve/disagg.py) splits admission across TWO
queues, each behind its own engine's scheduler: the *prefill queue* is
the prefill-role engine's scheduler ordering fresh prompts toward the
prefill slots (gated by transfer-tier backpressure), while the *decode
queue* is the decode-role engine's scheduler ordering paused-session
resumes — fresh work reaches the decode side only through the
``TransferQueue`` (arrival-ordered, requeue-to-back under backpressure,
so adoptions never starve resumes nor each other).  A session leaving
the prefill role is announced via :meth:`on_handoff`, NOT
:meth:`on_retire`: it has not finished, and deadline accounting must
happen exactly once, on the side that retires it.
"""
from __future__ import annotations

import abc
import heapq
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serve.session import Session


class Scheduler(abc.ABC):
    """Admission + preemption policy over waiting sessions."""

    name: str = "abstract"

    @abc.abstractmethod
    def submit(self, sess: Session) -> None:
        """Enqueue a freshly submitted session."""

    @abc.abstractmethod
    def next_ready(self) -> Optional[Session]:
        """Pop the session that should take the next free slot (or None)."""

    @abc.abstractmethod
    def requeue(self, sess: Session) -> None:
        """Put a just-paused session back in the waiting set."""

    @abc.abstractmethod
    def has_waiting(self) -> bool:
        """True when any session waits for a slot."""

    @abc.abstractmethod
    def waiting(self) -> Tuple[Session, ...]:
        """Snapshot of the waiting set (admission order, for reporting)."""

    def preempt_victim(self, running: List[Session]) -> Optional[Session]:
        """Running session to pause in favour of waiting work (None: keep
        all running sessions resident — run-to-completion)."""
        return None

    def on_retire(self, sess: Session) -> None:
        """Hook: a session finished and left its slot."""

    def on_handoff(self, sess: Session) -> None:
        """Hook: a prefill-role engine shipped this session to the decode
        side.  Not a retirement — the session is still live, and any
        SLO/latency accounting belongs to the engine that retires it."""

    def on_step(self) -> None:
        """Hook: the engine completed one decode step (scheduler clock)."""

    def describe(self) -> str:
        return self.name


# ---------------------------------------------------------------------------
class FCFSScheduler(Scheduler):
    """First-come-first-served, run-to-completion.

    The legacy engine policy, minus its O(n²) ``list.pop(0)`` admission
    queue — a deque pops the head in O(1), which matters at the
    heavy-traffic queue depths the north star targets.
    """

    name = "fcfs"

    def __init__(self):
        self._queue: deque = deque()

    def submit(self, sess: Session) -> None:
        self._queue.append(sess)

    def next_ready(self) -> Optional[Session]:
        while self._queue:
            sess = self._queue.popleft()
            if not sess.done:           # cancelled-while-queued sessions drop
                return sess
        return None

    def requeue(self, sess: Session) -> None:
        # paused sessions resume ahead of fresh arrivals (they hold spilled
        # state the fetch path should drain first)
        self._queue.appendleft(sess)

    def has_waiting(self) -> bool:
        return any(not s.done for s in self._queue)

    def waiting(self) -> Tuple[Session, ...]:
        return tuple(s for s in self._queue if not s.done)


# ---------------------------------------------------------------------------
class PriorityScheduler(Scheduler):
    """Highest ``Request.priority`` first; FCFS within a priority level.

    A waiting session with *strictly* higher priority preempts the
    lowest-priority running session — its KV moves to the spill tier and
    the slot turns over immediately.
    """

    name = "priority"

    def __init__(self):
        self._heap: List[Tuple[int, int, Session]] = []

    def submit(self, sess: Session) -> None:
        heapq.heappush(self._heap, (-sess.priority, sess.seq, sess))

    def next_ready(self) -> Optional[Session]:
        while self._heap:
            _, _, sess = heapq.heappop(self._heap)
            if not sess.done:
                return sess
        return None

    def requeue(self, sess: Session) -> None:
        heapq.heappush(self._heap, (-sess.priority, sess.seq, sess))

    def has_waiting(self) -> bool:
        return any(not s.done for _, _, s in self._heap)

    def waiting(self) -> Tuple[Session, ...]:
        return tuple(s for _, _, s in sorted(self._heap, key=lambda t: t[:2])
                     if not s.done)

    def preempt_victim(self, running: List[Session]) -> Optional[Session]:
        best_waiting = max((s.priority for _, _, s in self._heap
                            if not s.done), default=None)
        if best_waiting is None or not running:
            return None
        victim = min(running, key=lambda s: (s.priority, -s.seq))
        return victim if victim.priority < best_waiting else None


# ---------------------------------------------------------------------------
class FairScheduler(FCFSScheduler):
    """Round-robin over sessions with a decode-token quantum.

    When sessions wait and a running session has decoded ``quantum``
    tokens since admission/resume, it is paused (KV spilled) and requeued
    *behind* the waiters — every session makes progress even when the
    request count far exceeds the slot count.
    """

    name = "fair"

    def __init__(self, quantum: int = 8):
        super().__init__()
        assert quantum >= 1, quantum
        self.quantum = quantum

    def requeue(self, sess: Session) -> None:
        # round-robin: an expired quantum goes to the back of the line
        self._queue.append(sess)

    def preempt_victim(self, running: List[Session]) -> Optional[Session]:
        expired = [s for s in running if s.steps_since_admit >= self.quantum]
        if not expired:
            return None
        # the longest-over-quantum session yields first
        return max(expired, key=lambda s: (s.steps_since_admit, -s.seq))

    def describe(self) -> str:
        return f"{self.name}[q={self.quantum}]"


# ---------------------------------------------------------------------------
class SRPTScheduler(Scheduler):
    """Shortest-remaining-processing-time first.

    The remaining time of a session is the decode tokens it is still owed
    (``Session.remaining``, from ``Request.max_new_tokens``) — the classic
    mean-latency-optimal policy when service times are known, which they
    are here up to early EOS.  A waiting session with *strictly* less
    remaining work preempts the longest-remaining running session; ties
    break FCFS by admission ticket so equal-length jobs never thrash.

    Remaining work only changes while a session runs, so heap keys frozen
    at push time stay correct for every *waiting* session.
    """

    name = "srpt"

    def __init__(self):
        self._heap: List[Tuple[int, int, Session]] = []

    def submit(self, sess: Session) -> None:
        heapq.heappush(self._heap, (sess.remaining, sess.seq, sess))

    def next_ready(self) -> Optional[Session]:
        while self._heap:
            _, _, sess = heapq.heappop(self._heap)
            if not sess.done:
                return sess
        return None

    def requeue(self, sess: Session) -> None:
        heapq.heappush(self._heap, (sess.remaining, sess.seq, sess))

    def has_waiting(self) -> bool:
        return any(not s.done for _, _, s in self._heap)

    def waiting(self) -> Tuple[Session, ...]:
        return tuple(s for _, _, s in sorted(self._heap, key=lambda t: t[:2])
                     if not s.done)

    def preempt_victim(self, running: List[Session]) -> Optional[Session]:
        shortest = min((s.remaining for _, _, s in self._heap if not s.done),
                       default=None)
        if shortest is None or not running:
            return None
        victim = max(running, key=lambda s: (s.remaining, -s.seq))
        return victim if victim.remaining > shortest else None


# ---------------------------------------------------------------------------
class DeadlineScheduler(Scheduler):
    """Earliest-deadline-first with deadline-miss accounting.

    ``Request.deadline`` is an absolute engine-step number (the scheduler's
    clock advances by one per :meth:`on_step`); deadline-less requests rank
    last (+inf) and can never miss.  EDF never idles while an unmet
    deadline waits: ``next_ready`` always yields the earliest-deadline
    waiting session.  A strictly earlier waiting deadline preempts the
    latest-deadline running session.  Misses are counted at retirement
    (``now > deadline``) and per-tenant in :attr:`misses_by_tenant`.
    """

    name = "deadline"

    def __init__(self):
        self._heap: List[Tuple[float, int, Session]] = []
        self.now = 0
        self.misses = 0
        self.met = 0
        self.max_lateness = 0          # worst (now - deadline) over misses
        self.misses_by_tenant: Dict[str, int] = {}
        self.met_by_tenant: Dict[str, int] = {}

    def submit(self, sess: Session) -> None:
        heapq.heappush(self._heap, (sess.deadline, sess.seq, sess))

    def next_ready(self) -> Optional[Session]:
        while self._heap:
            _, _, sess = heapq.heappop(self._heap)
            if not sess.done:
                return sess
        return None

    def requeue(self, sess: Session) -> None:
        heapq.heappush(self._heap, (sess.deadline, sess.seq, sess))

    def has_waiting(self) -> bool:
        return any(not s.done for _, _, s in self._heap)

    def waiting(self) -> Tuple[Session, ...]:
        return tuple(s for _, _, s in sorted(self._heap, key=lambda t: t[:2])
                     if not s.done)

    def preempt_victim(self, running: List[Session]) -> Optional[Session]:
        earliest = min((s.deadline for _, _, s in self._heap if not s.done),
                       default=None)
        if earliest is None or not running:
            return None
        victim = max(running, key=lambda s: (s.deadline, -s.seq))
        return victim if victim.deadline > earliest else None

    def on_step(self) -> None:
        self.now += 1

    #: terminal reasons outside the SLO: the request was never served
    #: (rejected / over-quota) or the client walked away — counting them
    #: as met/missed would skew the deadline accounting either way
    _UNSERVED = ("rejected", "quota", "cancelled")

    def on_retire(self, sess: Session) -> None:
        if sess.deadline == float("inf") or \
                sess.finish_reason in self._UNSERVED:
            return
        if self.now > sess.deadline:
            self.misses += 1
            self.max_lateness = max(self.max_lateness,
                                    int(self.now - sess.deadline))
            self.misses_by_tenant[sess.tenant] = \
                self.misses_by_tenant.get(sess.tenant, 0) + 1
        else:
            self.met += 1
            self.met_by_tenant[sess.tenant] = \
                self.met_by_tenant.get(sess.tenant, 0) + 1

    def miss_report(self) -> Dict[str, object]:
        """Per-tenant SLO ledger: both sides of the met/missed split."""
        tenants = set(self.misses_by_tenant) | set(self.met_by_tenant)
        return {"now": self.now, "met": self.met, "missed": self.misses,
                "max_lateness": self.max_lateness,
                "by_tenant": {t: {"met": self.met_by_tenant.get(t, 0),
                                  "missed": self.misses_by_tenant.get(t, 0)}
                              for t in sorted(tenants)}}

    def describe(self) -> str:
        return f"{self.name}[met={self.met} missed={self.misses}]"


# ---------------------------------------------------------------------------
# registry (mirrors core.tiers' policy/codec registries)
_SCHEDULERS: Dict[str, Callable[..., Scheduler]] = {}


def register_scheduler(name: str, factory: Callable[..., Scheduler]) -> None:
    _SCHEDULERS[name] = factory


def registered_schedulers() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDULERS))


def build_scheduler(name: str, **kwargs) -> Scheduler:
    if name not in _SCHEDULERS:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"registered: {registered_schedulers()}")
    return _SCHEDULERS[name](**kwargs)


register_scheduler("fcfs", FCFSScheduler)
register_scheduler("priority", PriorityScheduler)
register_scheduler("fair", FairScheduler)
register_scheduler("srpt", SRPTScheduler)
register_scheduler("deadline", DeadlineScheduler)
