"""PageTable: free-list page allocation for the paged KV cache.

The paper's pooled-memory thesis says capacity management must be
transparent to the algorithm while the runtime decides placement; the page
is the unit of that placement for serving.  This module is the pure-Python
bookkeeping half (no jax): which sessions hold which fixed-size page, which
pages are *cold* (every holder paused) and therefore evictable, and which
logical positions of a session currently live in the spill tier.  The array
surgery — extracting/inserting page contents, codecs, the spill-tier
stash/fetch — stays in :class:`~repro.serve.cache_manager.PagedKVCacheManager`,
which drives this table and hands it an eviction callback.

Lifecycle of one page position of one session:

          alloc                    mark_cold        (demand) evict_cb
  FREE ─────────► RESIDENT+hot ───────────► RESIDENT+cold ───────────► SPILLED
                      ▲                          │ mark_hot                │
                      └──────────────────────────┘ (copy-free readmit)     │
                      ▲                                 set_resident       │
                      └────────────────────────────────────────────────────┘

Pausing a session costs nothing: its pages merely become eviction
candidates (LRU by pause order).  They are spilled *lazily*, one page at a
time, only when an allocation finds the free list empty — and a session
resumed before that happens re-binds with **zero copies** (the
Buddy-Compression cold-page pattern, arXiv:1903.02596).

**Prefix sharing** (copy-on-write): a physical page may back the same
logical position of many sessions — :meth:`share` binds an already
resident page read-only as another session's next logical page.  The
per-page refcount is the holder set in ``_owner``; the frame returns to
the free list only when the last holder releases it, a shared page is
evictable only once *every* holder is paused, and evicting it spills
**one** payload (a :class:`SharedPayload`) referenced by all holders —
N sessions sharing a cold prefix page cost one stash, not N.  Refetching
any holder re-homes every holder onto the one fresh frame.  Writers never
mutate a shared frame: the cache manager forks (copies) a page into a
private frame before any write (see ``PagedKVCacheManager.match_prefix``).
Every invariant the property suite drives is checked by :meth:`check`.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, Optional, Set, Tuple)


class PageError(RuntimeError):
    """Allocation failure: every page is hot (resident running sessions)."""


def pages_for(rows: int, page_size: int) -> int:
    """Pages needed to hold ``rows`` cache rows (always >= 1).

    Module-level so every party to the page contract rounds identically:
    the decode table's charge/claim (:meth:`PageTable.pages_for`), the
    prefill role's quota reservation and handoff chunk count
    (serve/engine.py) — a divergence would break the shared-ledger
    reservation that follows a session across the disaggregated split."""
    return max(1, -(-rows // page_size))


#: evict_cb(holder_sid, position, page_id) -> payload
#: Called while the page is still resident; must copy the page's contents
#: out (spill-tier stash) and return an opaque payload the table stores in
#: the holder's entry (for a shared page: one payload, wrapped in a
#: SharedPayload, stored in every holder's entry).  Raising aborts the
#: allocation.
EvictFn = Callable[[int, int, int], Any]


@dataclasses.dataclass
class SharedPayload:
    """One spill payload referenced by every holder of an evicted shared
    page.  ``holders`` shrinks as sessions release; the inner payload is
    surrendered for discard only by the last holder, and a refetch by any
    holder re-homes all of them onto the one fresh frame."""

    payload: Any
    holders: List[Tuple[int, int]]     # (sid, pos) still referencing it


@dataclasses.dataclass
class PageEntry:
    """One logical page position of one session."""

    pid: Optional[int] = None          # resident page id (None: spilled)
    payload: Any = None                # spill payload when not resident
    #                                    (SharedPayload if the page was
    #                                    shared at eviction time)
    refetched: bool = False            # copied back through the spill tier
    #                                    during the current pause/resume
    #                                    cycle (NOT a copy-free readmit)

    @property
    def resident(self) -> bool:
        return self.pid is not None


class PageTable:
    """Session → ordered pages over a fixed pool, with lazy cold eviction
    and refcounted prefix sharing (copy-on-write is the *caller's* duty:
    the table only tracks holders; it never copies frames)."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 1 and page_size >= 1, (num_pages, page_size)
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: a just-freed (warm) page is reused first
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        # pid -> holders; len(holders) IS the page's refcount
        self._owner: Dict[int, Set[Tuple[int, int]]] = {}
        self._entries: Dict[int, List[PageEntry]] = {}
        self._cold: "OrderedDict[int, None]" = OrderedDict()  # pid, LRU order
        self._paused: Set[int] = set()  # sids marked cold (pause order lost,
        #                                 _cold keeps the LRU order per pid)
        #: called with the pid whenever a frame's contents die (evicted or
        #: freed) — the cache manager uses it to invalidate its prefix
        #: index before the frame id is reused
        self.on_release: Optional[Callable[[int], None]] = None
        # counters (the metering the property suite cross-checks)
        self.evictions = 0
        self.refetches = 0
        self.readmits_free = 0         # pages re-bound without a copy
        self.adoptions = 0             # sessions claimed from another role
        self.shared_binds = 0          # share() calls (prefix-cache hits)

    # ------------------------------------------------------------------
    # queries
    def pages_for(self, rows: int) -> int:
        """Pages needed to hold ``rows`` cache rows."""
        return pages_for(rows, self.page_size)

    def sessions(self) -> Tuple[int, ...]:
        return tuple(sorted(self._entries))

    def entries(self, sid: int) -> List[PageEntry]:
        return self._entries.get(sid, [])

    def resident_pids(self, sid: int) -> List[Optional[int]]:
        """Page ids in logical order (None where the position is spilled)."""
        return [e.pid for e in self.entries(sid)]

    def spilled_positions(self, sid: int) -> List[int]:
        return [i for i, e in enumerate(self.entries(sid)) if not e.resident]

    def num_free(self) -> int:
        return len(self._free)

    def num_cold(self) -> int:
        return len(self._cold)

    def holds(self, sid: int) -> int:
        """Total pages charged to a session (resident + spilled)."""
        return len(self.entries(sid))

    def refcount(self, pid: int) -> int:
        """How many (sid, pos) entries hold the resident page ``pid``."""
        return len(self._owner.get(pid, ()))

    def num_shared(self) -> int:
        return sum(1 for holders in self._owner.values() if len(holders) > 1)

    def is_resident_pid(self, pid: int) -> bool:
        return pid in self._owner

    # ------------------------------------------------------------------
    # allocation
    def _all_holders_paused(self, pid: int) -> bool:
        return all(s in self._paused for s, _ in self._owner[pid])

    def _released(self, pid: int) -> None:
        if self.on_release is not None:
            self.on_release(pid)

    def _take_page(self, evict: Optional[EvictFn]) -> int:
        if self._free:
            return self._free.pop()
        if not self._cold:
            raise PageError(f"page pool exhausted: all {self.num_pages} "
                            f"pages are hot")
        if evict is None:
            raise PageError("free list empty and no eviction callback "
                            "(cache manager built with spill=None?)")
        vpid = next(iter(self._cold))                  # LRU victim (peek)
        holders = sorted(self._owner[vpid])
        v_sid, v_pos = holders[0]          # representative for the stash
        payload = evict(v_sid, v_pos, vpid)   # may raise: table untouched
        self._cold.pop(vpid)
        self._owner.pop(vpid)
        if len(holders) > 1:
            payload = SharedPayload(payload, holders=list(holders))
        for sid, pos in holders:
            entry = self._entries[sid][pos]
            entry.pid, entry.payload = None, payload
        self.evictions += 1                # one spill, however many holders
        self._released(vpid)
        return vpid

    def alloc(self, sid: int, evict: Optional[EvictFn] = None) -> int:
        """Append one fresh *private* page to ``sid``'s logical sequence."""
        pid = self._take_page(evict)
        pos = len(self._entries.setdefault(sid, []))
        self._owner[pid] = {(sid, pos)}
        self._entries[sid].append(PageEntry(pid=pid))
        return pid

    def share(self, sid: int, pid: int) -> int:
        """Bind the already-resident page ``pid`` read-only as ``sid``'s
        next logical page (prefix-cache hit).  The refcount (holder set)
        grows by one; a hot holder pins the frame, so the bind pulls it
        off the eviction queue.  Returns the logical position bound."""
        holders = self._owner.get(pid)
        if holders is None:
            raise PageError(f"page {pid} is not resident; cannot share")
        pos = len(self._entries.setdefault(sid, []))
        if any(s == sid for s, _ in holders):
            raise ValueError(f"session {sid} already holds page {pid}")
        holders.add((sid, pos))
        self._entries[sid].append(PageEntry(pid=pid))
        if sid not in self._paused:
            self._cold.pop(pid, None)
        self.shared_binds += 1
        return pos

    def ensure(self, sid: int, rows: int,
               evict: Optional[EvictFn] = None) -> List[int]:
        """Grow ``sid`` to cover ``rows`` cache rows; returns new page ids."""
        new = []
        while self.holds(sid) < self.pages_for(rows):
            new.append(self.alloc(sid, evict))
        return new

    def claim(self, sid: int, n_pages: int,
              evict: Optional[EvictFn] = None) -> List[int]:
        """Allocate exactly ``n_pages`` fresh pages for an *adopted* session
        (disaggregated serving: the decode role takes ownership of KV pages
        prefilled by another runtime).

        Cross-role ownership handoff must never alias: ``sid`` has to be
        unknown to this table — the shipped pages become the one and only
        copy this role serves from.  All-or-nothing: a :class:`PageError`
        mid-claim (pool too hot) returns every page already taken and
        re-raises, so a backpressured adoption leaves no residue."""
        if sid in self._entries:
            # a real raise, not an assert: this is the invariant that keeps
            # cross-role handoffs un-aliased, and it must survive python -O
            raise ValueError(f"adoption would alias existing session {sid}")
        pids = []
        try:
            for _ in range(n_pages):
                pids.append(self.alloc(sid, evict))
        except PageError:
            self.free_session(sid)
            raise
        self.adoptions += 1
        return pids

    def set_resident(self, sid: int, pos: int,
                     evict: Optional[EvictFn] = None) -> int:
        """Give a *spilled* position a fresh page to be re-fetched into.

        If the position was evicted while shared, every holder of the one
        :class:`SharedPayload` is re-homed onto the fresh frame in this
        single call — the caller fetches the payload once and the other
        holders' positions are already resident when their resumes run."""
        entry = self._entries[sid][pos]
        if entry.resident:
            raise ValueError(f"position {(sid, pos)} is already resident "
                             f"on page {entry.pid}")
        parked = entry.payload
        pid = self._take_page(evict)
        if isinstance(parked, SharedPayload):
            holders = list(parked.holders)
        else:
            holders = [(sid, pos)]
        self._owner[pid] = set(holders)
        for s, p in holders:
            e = self._entries[s][p]
            e.pid, e.payload, e.refetched = pid, None, True
        if self._all_holders_paused(pid):
            self._cold[pid] = None
        self.refetches += 1            # one fetch, however many holders
        return pid

    def unset_resident(self, sid: int, pos: int, payload: Any) -> None:
        """Roll back a :meth:`set_resident` whose data fetch failed: the
        fresh frame returns to the free list and the position(s) spill
        again over the SAME (still intact) payload — a later resume
        retries the fetch instead of serving the unfilled frame."""
        entry = self._entries[sid][pos]
        if not entry.resident:
            raise ValueError(f"position {(sid, pos)} is not resident; "
                             "nothing to roll back")
        pid = entry.pid
        for s, p in self._owner.pop(pid):
            e = self._entries[s][p]
            e.pid, e.payload, e.refetched = None, payload, False
        self._cold.pop(pid, None)
        self._free.append(pid)
        self.refetches -= 1            # the metered fetch never happened
        self._released(pid)

    # ------------------------------------------------------------------
    # temperature (pause / resume)
    def mark_cold(self, sid: int) -> None:
        """Owner paused: its resident pages become eviction candidates —
        a shared page only once *every* holder is paused."""
        self._paused.add(sid)
        for e in self.entries(sid):
            if e.resident and e.pid not in self._cold \
                    and self._all_holders_paused(e.pid):
                self._cold[e.pid] = None

    def mark_hot(self, sid: int) -> int:
        """Owner resuming: pull surviving pages off the eviction queue.

        Returns how many pages are still resident.  Counting them as
        copy-free readmits is deferred to :meth:`note_resumed` — a resume
        attempt can still fail (pool too hot to re-home spilled pages),
        and pages refetched through the spill tier were copied, not kept."""
        self._paused.discard(sid)
        kept = 0
        for e in self.entries(sid):
            if e.resident:
                self._cold.pop(e.pid, None)
                kept += 1
        return kept

    def note_resumed(self, sid: int) -> int:
        """Commit a SUCCESSFUL resume: count (and return) the pages that
        survived the whole pause in place — resident and never refetched —
        and start a fresh cycle for the next pause."""
        kept = 0
        for e in self.entries(sid):
            if e.resident and not e.refetched:
                kept += 1
            e.refetched = False
        self.readmits_free += kept
        return kept

    # ------------------------------------------------------------------
    # release
    def free_session(self, sid: int) -> List[Any]:
        """Drop one session's hold on its pages.  A private frame returns
        to the free list; a shared frame merely loses one holder (and
        becomes evictable if every survivor is paused).

        Returns the spill payloads this release *orphaned* — private
        payloads, plus a shared payload whose last holder this was — so
        the caller can discard them (SpillTier budget).  Double-free safe:
        freeing an unknown sid is a no-op returning []."""
        payloads = []
        self._paused.discard(sid)
        for pos, e in enumerate(self._entries.pop(sid, [])):
            if e.resident:
                if e.pid in self._free:
                    # a real raise, not an assert: double frees must be
                    # caught under python -O too
                    raise ValueError(f"double free of page {e.pid}")
                holders = self._owner[e.pid]
                holders.discard((sid, pos))
                if not holders:
                    self._owner.pop(e.pid)
                    self._cold.pop(e.pid, None)
                    self._free.append(e.pid)
                    self._released(e.pid)
                elif e.pid not in self._cold \
                        and self._all_holders_paused(e.pid):
                    self._cold[e.pid] = None    # last hot holder left
            elif isinstance(e.payload, SharedPayload):
                try:
                    e.payload.holders.remove((sid, pos))
                except ValueError:
                    raise ValueError(
                        f"double free of shared payload at {(sid, pos)}")
                if not e.payload.holders:
                    payloads.append(e.payload.payload)
            elif e.payload is not None:
                payloads.append(e.payload)
        return payloads

    # ------------------------------------------------------------------
    def check(self) -> None:
        """Internal-consistency audit (the property suite calls this after
        every step): no *unintended* aliasing — a pid may appear in many
        sessions' entries iff its holder set (refcount) matches exactly;
        free list duplicate-free and disjoint from held pages; cold ⊆
        held, and only when every holder is paused; shared payloads'
        holder lists in sync; frames conserved."""
        assert len(set(self._free)) == len(self._free), "free-list duplicates"
        owned = set(self._owner)
        assert not (owned & set(self._free)), "page both free and owned"
        seen: Dict[int, Set[Tuple[int, int]]] = {}
        shared_payloads: Dict[int, SharedPayload] = {}
        referers: Dict[int, Set[Tuple[int, int]]] = {}
        for sid, entries in self._entries.items():
            for pos, e in enumerate(entries):
                if e.resident:
                    seen.setdefault(e.pid, set()).add((sid, pos))
                elif isinstance(e.payload, SharedPayload):
                    key = id(e.payload)
                    shared_payloads[key] = e.payload
                    referers.setdefault(key, set()).add((sid, pos))
        for pid, holders in seen.items():
            assert self._owner.get(pid) == holders, \
                f"page {pid} aliased: holders {self._owner.get(pid)} " \
                f"but referenced by {holders}"
        assert seen.keys() == owned, "owner map out of sync"
        assert set(self._cold) <= owned, "cold page not owned"
        for pid in self._cold:
            assert self._all_holders_paused(pid), \
                f"cold page {pid} has a hot holder: {self._owner[pid]}"
        for key, sp in shared_payloads.items():
            assert set(sp.holders) == referers[key], \
                f"shared payload holders {sp.holders} out of sync with " \
                f"referencing entries {referers[key]}"
        assert len(self._free) + len(owned) == self.num_pages, \
            "pages leaked or invented"

    def describe(self) -> str:
        return (f"pages[{self.num_pages}x{self.page_size} "
                f"free={self.num_free()} cold={self.num_cold()} "
                f"shared={self.num_shared()} "
                f"evict={self.evictions} refetch={self.refetches} "
                f"readmit_free={self.readmits_free} "
                f"adopt={self.adoptions}]")
