"""Session: the streaming result API of the serving stack (DESIGN.md §6).

A :class:`Session` is the engine-side lifecycle object for one submitted
:class:`~repro.serve.engine.Request`: it carries the generated-token
stream, the scheduler state (queued / running / paused / finished), the
cache residency (slot index, cached length) and the finish reason —
replacing the old pattern of mutating ``Request.out_tokens`` from inside
``Engine.step``.

Streaming: every generated token flows through :meth:`emit`, which appends
to the stream and invokes the optional ``on_token`` callback — the hook a
serving frontend uses to push tokens to a client mid-decode.  The legacy
``Request.out_tokens`` list is kept as an *alias* of the session stream
(same list object), so pre-Session callers keep working unchanged.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional


class SessionState(enum.Enum):
    QUEUED = "queued"          # submitted, no cache slot yet
    RUNNING = "running"        # resident in a decode slot
    PAUSED = "paused"          # preempted: KV spilled to the secondary tier
    FINISHED = "finished"      # retired (see finish_reason)
    CANCELLED = "cancelled"


#: finish reasons
FINISH_EOS = "eos"                  # sampled the request's eos_id
FINISH_LENGTH = "length"            # hit max_new_tokens
FINISH_CACHE_FULL = "cache_full"    # cache slot exhausted (max_len rows)
FINISH_REJECTED = "rejected"        # prompt does not fit a cache slot
FINISH_QUOTA = "quota"              # exceeds the tenant quota outright
FINISH_CANCELLED = "cancelled"


@dataclasses.dataclass
class Session:
    """Lifecycle + token stream of one request inside the engine."""

    request: "Request"                 # noqa: F821 — serve.engine.Request
    seq: int                           # admission ticket (FCFS order)
    state: SessionState = SessionState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    on_token: Optional[Callable[["Session", int], None]] = None
    # cache residency (owned by KVCacheManager)
    slot: Optional[int] = None
    length: int = 0                    # tokens currently cached (slot/spill)
    steps_since_admit: int = 0         # preemption quantum bookkeeping
    preemptions: int = 0               # times this session was paused
    emitted: int = 0                   # high-water mark of on_token notifies

    def __post_init__(self):
        # alias the legacy output list: one list, two names
        if self.request.out_tokens:
            self.tokens = self.request.out_tokens
        else:
            self.request.out_tokens = self.tokens

    # ------------------------------------------------------------------
    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def priority(self) -> int:
        return getattr(self.request, "priority", 0)

    @property
    def tenant(self) -> str:
        return getattr(self.request, "tenant", "default")

    @property
    def deadline(self) -> float:
        """EDF rank: the request's deadline in engine steps (inf: none)."""
        d = getattr(self.request, "deadline", None)
        return float("inf") if d is None else float(d)

    @property
    def remaining(self) -> int:
        """SRPT rank: decode tokens still owed (never negative)."""
        return max(0, self.request.max_new_tokens - len(self.tokens))

    @property
    def done(self) -> bool:
        return self.state in (SessionState.FINISHED, SessionState.CANCELLED)

    @property
    def resident(self) -> bool:
        return self.slot is not None

    # ------------------------------------------------------------------
    def emit(self, token: int) -> None:
        """Append one generated token to the stream (and notify).

        ``on_token`` fires only for stream positions not yet notified:
        when a failed handoff rewinds ``tokens`` and the session is
        replayed, re-generated positions are appended silently instead
        of streaming the same token to the client twice.
        """
        self.tokens.append(token)
        self.steps_since_admit += 1
        if self.on_token is not None and len(self.tokens) > self.emitted:
            self.emitted = len(self.tokens)
            self.on_token(self, token)

    def rewind(self) -> None:
        """Reset to freshly-queued for a requeue/replay.

        Clears the token stream in place (preserving the
        ``Request.out_tokens`` alias) and drops the cache residency; the
        ``emitted`` high-water mark deliberately survives so a replayed
        session never streams the same position to the client twice."""
        del self.tokens[:]
        self.length = 0
        self.slot = None
        self.state = SessionState.QUEUED

    def finish(self, reason: str) -> None:
        self.state = (SessionState.CANCELLED if reason == FINISH_CANCELLED
                      else SessionState.FINISHED)
        self.finish_reason = reason

    def cancel(self) -> None:
        self.finish(FINISH_CANCELLED)

    def result(self) -> List[int]:
        """The generated tokens so far (complete once ``done``)."""
        return list(self.tokens)

    def __repr__(self) -> str:
        return (f"Session(uid={self.uid}, state={self.state.value}, "
                f"slot={self.slot}, len={self.length}, "
                f"tokens={len(self.tokens)})")
