"""Disaggregated prefill/decode over the memory-tier API.

Prefill is compute-bound (one matmul-heavy pass per prompt), decode is
memory-bound (one cache-wide read per token); a pooled memory lets each
run where it is shaped for it while the state moves between them.  This
module is that split for the serving stack:

* a **prefill-role Engine** runs prompt prefill in plain contiguous slots
  (no pool, no page table), samples the first token, chops the finished
  KV into page-shaped chunks (``models/transformer.slot_pages``) and
  publishes them;
* the :class:`TransferQueue` parks the pages in a *transfer tier* — a
  :class:`~repro_torch.core.runtime.MemoryRuntime` over pooled HBM
  overflowing to host (``"spill"``) or pinned host memory (``"host"``) —
  with every leg metered (``kv_publish`` / ``kv_adopt`` in
  ``traffic_report()``: wire bytes are page bytes x shipped pages);
* a **decode-role Engine** adopts the pages through its
  :class:`~repro_torch.serve.paging.PageTable` (``claim``: fresh frames,
  never aliasing an existing owner) and decodes; the greedy token stream
  is the colocated paged engine's.

Backpressure is survivable at both ends: the prefill engine stops
admitting prompts while the queue is at ``max_depth`` (prompts wait in its
scheduler), and a decode-side adoption that finds every pool frame hot
rolls back *before* fetching any bytes and requeues the handoff at the
BACK of the queue — the pages stay parked (never re-prefilled) and later
handoffs get their turn first.  Within one session, pages move in logical
position order.

Quota reservations follow the session: both engines share one
:class:`~repro_torch.serve.quota.QuotaManager`, whose per-uid ledger keeps
the worst-case page charge while the KV is in flight and releases it on
the side that retires (or sweeps the cancellation of) the session.

Both roles run in one process (``--role both``).  Each handed-off page is
private bytes: the prefill role computes in monolithic slots, with no
prefix index.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple, Union

from repro_torch import tree
from repro_torch.configs.base import MemoryPlan
from repro_torch.core.runtime import MemoryRuntime
from repro_torch.core.tiers import TransferHints
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.session import Session


@dataclasses.dataclass
class KVHandoff:
    """One prefilled session in flight from the prefill to the decode role.

    ``page_payloads`` holds, per logical page position (ascending), the
    transfer tier's payloads for that page's cache leaves;
    ``slot_payloads`` the slot-shaped leaves (SSM / cross-attention state)
    shipped whole.  Payloads are consumed (fetched, then their tier budget
    discarded) exactly once, at adoption."""

    session: Session
    length: int                            # cached rows (== prompt length)
    #: per page: (tree paths, leaf payloads, leaf dtypes)
    page_payloads: List[Tuple[Any, List[Any], List[Any]]] = \
        dataclasses.field(default_factory=list)
    slot_payloads: Optional[Tuple[Any, List[Any], List[Any]]] = None
    requeues: int = 0                      # decode-side backpressure count

    @property
    def uid(self) -> int:
        return self.session.uid

    @property
    def num_pages(self) -> int:
        return len(self.page_payloads)


def _hints(dtype, batch_dim: int, name: str) -> TransferHints:
    return TransferHints(dtype=dtype, batch_dim=batch_dim,
                         allow_compress=False, name=name)


class TransferQueue:
    """KV handoffs parked in a transfer tier, arrival-ordered.

    * **FIFO per session** — a session's pages are stashed, fetched and
      landed in logical position order; a handoff is delivered at most
      once (requeues re-deliver the same object, payloads intact).
    * **No starvation across sessions** — :meth:`next_ready` pops the
      head, :meth:`requeue` appends at the back.

    ``max_depth`` bounds the parked handoffs; the prefill engine checks
    :meth:`has_room` before admitting fresh prompts."""

    def __init__(self, runtime: MemoryRuntime,
                 max_depth: Optional[int] = None):
        if max_depth is not None and max_depth < 1:
            raise ValueError(f"max_depth must be >= 1: {max_depth}")
        self.runtime = runtime
        self.max_depth = max_depth
        self._parked: Deque[KVHandoff] = deque()
        self.published = 0
        self.delivered = 0
        self.requeued = 0
        self.swept = 0
        self.shipped_pages = 0
        self.adopted_pages = 0

    def depth(self) -> int:
        return len(self._parked)

    def has_room(self, pending: int = 0) -> bool:
        """Whether one more handoff fits under ``max_depth``; ``pending``
        counts sessions admitted to prefill slots and not yet published
        (publish is unconditional)."""
        return self.max_depth is None or \
            len(self._parked) + pending < self.max_depth

    def parked_uids(self) -> Tuple[int, ...]:
        return tuple(h.uid for h in self._parked)

    # ------------------------------------------------------------------
    # prefill side
    def publish(self, handoff: KVHandoff, pages: List[Any],
                slot_one: Any = None) -> None:
        """Stash a prefilled session's KV into the transfer tier: ``pages``
        in logical position order (``transformer.slot_pages``), and the
        slot-shaped leaves ``slot_one`` (None: the model has none)."""
        assert not handoff.page_payloads, "handoff already published"
        for page in pages:
            leaves, paths = tree.flatten(page)
            payloads = [self.runtime.stash(
                x, _hints(x.dtype, 0, "kv_page"), direction="kv_publish")
                for x in leaves]
            handoff.page_payloads.append(
                (paths, payloads, [x.dtype for x in leaves]))
        if slot_one is not None:
            leaves, paths = tree.flatten(slot_one)
            payloads = [self.runtime.stash(
                x, _hints(x.dtype, 1, "kv_slot"), direction="kv_publish")
                for x in leaves]
            handoff.slot_payloads = (paths, payloads,
                                     [x.dtype for x in leaves])
        self._parked.append(handoff)
        self.published += 1
        self.shipped_pages += handoff.num_pages

    # ------------------------------------------------------------------
    # decode side
    def next_ready(self) -> Optional[KVHandoff]:
        """Pop the oldest parked handoff (None when the queue is empty)."""
        if not self._parked:
            return None
        self.delivered += 1
        return self._parked.popleft()

    def requeue(self, handoff: KVHandoff) -> None:
        """Decode-side backpressure: park the handoff again, at the BACK;
        its pages stay in the transfer tier."""
        handoff.requeues += 1
        self.requeued += 1
        self._parked.append(handoff)

    def _fetch(self, entry, batch_dim: int, name: str) -> Any:
        paths, payloads, dtypes = entry
        leaves = []
        for payload, dt in zip(payloads, dtypes):
            leaves.append(self.runtime.fetch(
                payload, _hints(dt, batch_dim, name), direction="kv_adopt"))
            self.runtime.discard(payload)
        return tree.unflatten(paths, leaves)

    def fetch_pages(self, handoff: KVHandoff) -> List[Any]:
        """The handoff's pages in logical position order, consuming the
        payloads (their transfer-tier budget is returned)."""
        pages = [self._fetch(entry, 0, "kv_page")
                 for entry in handoff.page_payloads]
        self.adopted_pages += len(pages)
        handoff.page_payloads = []
        return pages

    def fetch_slot_leaves(self, handoff: KVHandoff) -> Any:
        if handoff.slot_payloads is None:
            return None
        one = self._fetch(handoff.slot_payloads, 1, "kv_slot")
        handoff.slot_payloads = None
        return one

    # ------------------------------------------------------------------
    # lifecycle
    def discard(self, handoff: KVHandoff) -> None:
        """Drop an unconsumed handoff's payloads (cancelled in transit),
        returning their transfer-tier budget."""
        for _, payloads, _ in handoff.page_payloads:
            for payload in payloads:
                self.runtime.discard(payload)
        handoff.page_payloads = []
        if handoff.slot_payloads is not None:
            for payload in handoff.slot_payloads[1]:
                self.runtime.discard(payload)
            handoff.slot_payloads = None

    def sweep_cancelled(self) -> List[Session]:
        """Drop parked handoffs whose session was cancelled in transit;
        returns their sessions so the caller can release their quota
        reservations (release is idempotent: both engines may sweep)."""
        swept = []
        for handoff in [h for h in self._parked if h.session.done]:
            self._parked.remove(handoff)
            self.discard(handoff)
            self.swept += 1
            swept.append(handoff.session)
        return swept

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, Any]:
        """Transfer-tier byte accounting (kv_publish / kv_adopt) plus the
        queue's handoff counters."""
        report = dict(self.runtime.traffic_report())
        report["transfer"] = {
            "published": self.published,
            "delivered": self.delivered,
            "requeued": self.requeued,
            "swept": self.swept,
            "depth": self.depth(),
            "shipped_pages": self.shipped_pages,
            "adopted_pages": self.adopted_pages,
        }
        return report

    def describe(self) -> str:
        cap = "" if self.max_depth is None else f"/{self.max_depth}"
        return (f"transfer[{self.runtime.tier.describe()} "
                f"depth={self.depth()}{cap} shipped={self.shipped_pages}p "
                f"requeued={self.requeued}]")


class DisaggPair:
    """Two cooperating engines and the transfer queue, stepped in lockstep:
    ``submit`` goes to the prefill engine, ``step`` advances prefill
    (admission + publish) then decode (adoption + decode), ``run`` drains
    prompts waiting, pages in flight and decode residents alike."""

    def __init__(self, prefill, decode, transfer: TransferQueue):
        if prefill.role != "prefill" or decode.role != "decode":
            raise ValueError(f"need (prefill, decode) roles, got "
                             f"({prefill.role!r}, {decode.role!r})")
        if prefill.transfer is not transfer or decode.transfer is not transfer:
            raise ValueError("both engines must share THIS transfer queue")
        if prefill._page_size != decode.cache.page_size:
            raise ValueError(
                f"page_size mismatch: prefill ships {prefill._page_size}-row "
                f"pages, decode pools {decode.cache.page_size}-row frames")
        if prefill.max_len != decode.max_len:
            raise ValueError(f"max_len mismatch: {prefill.max_len} vs "
                             f"{decode.max_len} (the roles must agree on "
                             f"cache rows per session)")
        if (prefill.quota is not None or decode.quota is not None) \
                and prefill.quota is not decode.quota:
            raise ValueError("prefill and decode must share one QuotaManager "
                             "(reservations follow the session)")
        self.prefill = prefill
        self.decode = decode
        self.transfer = transfer

    def submit(self, req, on_token=None) -> Session:
        return self.prefill.submit(req, on_token=on_token)

    def step(self) -> int:
        """One lockstep round; returns shipped handoffs + resident decode
        sessions."""
        return self.prefill.step() + self.decode.step()

    def has_work(self) -> bool:
        return (self.prefill.scheduler.has_waiting()
                or bool(self.prefill.cache.running())
                or self.transfer.depth() > 0
                or self.decode.scheduler.has_waiting()
                or bool(self.decode.cache.running()))

    def run(self, max_steps: int = 10_000) -> List[Any]:
        """Drain the pair; returns finished Requests (prefill-side
        rejections and instant finishes first, then decode completions)."""
        for _ in range(max_steps):
            self.step()
            if not self.has_work():
                break
        return self.prefill.finished + self.decode.finished

    @property
    def sessions(self) -> List[Session]:
        return self.prefill.sessions

    @property
    def model(self):
        return self.decode.model

    @property
    def quota(self) -> Optional[QuotaManager]:
        return self.decode.quota

    def traffic_report(self) -> Dict[str, Any]:
        return {"transfer": self.transfer.traffic_report(),
                "decode": self.decode.traffic_report(),
                "prefill": self.prefill.traffic_report()}

    def quota_report(self) -> Dict[str, Any]:
        return self.decode.quota_report()

    def describe(self) -> str:
        return (f"disagg[{self.prefill.describe()} -> "
                f"{self.transfer.describe()} -> {self.decode.describe()}]")


def build_disagg(model, params, *,
                 batch: Optional[int] = None,
                 max_len: Optional[int] = None,
                 page_size: int = 16,
                 pages: Optional[int] = None,
                 prefill_batch: int = 1,
                 transfer: Union[str, MemoryRuntime] = "spill",
                 max_depth: Optional[int] = None,
                 scheduler: Union[str, Any] = "fcfs",
                 decode_scheduler: Union[str, Any, None] = None,
                 spill: Union[str, Any, None] = "spill",
                 quota: Union[QuotaManager, TenantQuota,
                              Dict[str, TenantQuota], None] = None,
                 temperature: float = 0.0, seed: int = 0,
                 **cache_kwargs) -> DisaggPair:
    """Wire a prefill/decode pair over one transfer tier.

    ``transfer`` names the tier policy carrying the in-flight KV pages
    (``"spill"``: pooled HBM overflowing to host; ``"host"``: pinned host
    memory) or passes a ready :class:`MemoryRuntime`.  ``scheduler``
    orders the prefill queue, ``decode_scheduler`` (default: the same
    policy string, or fcfs for a scheduler object) the decode side's
    resume queue.  One :class:`QuotaManager` is built from ``quota`` and
    shared.  ``cache_kwargs`` (``decode_kernel=True`` among them) go to the
    decode engine."""
    from repro_torch.serve.engine import Engine   # engine imports this module

    if isinstance(transfer, MemoryRuntime):
        runtime = transfer
    else:
        runtime = MemoryRuntime(
            model.plan,
            MemoryPlan(policy=transfer, placement=model.memory.placement),
            model.device)
    queue = TransferQueue(runtime, max_depth=max_depth)

    if quota is None or isinstance(quota, QuotaManager):
        shared_quota = quota
    elif isinstance(quota, TenantQuota):
        shared_quota = QuotaManager(default_quota=quota)
    else:
        shared_quota = QuotaManager(dict(quota))

    if decode_scheduler is None:
        decode_scheduler = scheduler if isinstance(scheduler, str) else "fcfs"

    # decode first: when sizes are auto-derived the prefill side takes the
    # decode side's (page-aligned) geometry.  The decode engine samples
    # from ``seed + 1``: at temperature > 0 sharing ``seed`` would
    # correlate the prefill-sampled first token with the first decode draw
    decode = Engine(model, params, batch=batch, max_len=max_len,
                    temperature=temperature, seed=seed + 1,
                    scheduler=decode_scheduler, spill=spill,
                    page_size=page_size, pages=pages, quota=shared_quota,
                    role="decode", transfer=queue, **cache_kwargs)
    prefill = Engine(model, params, batch=prefill_batch,
                     max_len=decode.max_len,
                     temperature=temperature, seed=seed,
                     scheduler=scheduler, spill=None,
                     page_size=page_size, quota=shared_quota,
                     role="prefill", transfer=queue)
    return DisaggPair(prefill, decode, queue)
