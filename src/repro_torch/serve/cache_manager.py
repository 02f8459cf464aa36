"""KVCacheManager: decode-slot / page allocation over the memory tiers.

The manager owns the KV cache storage and everything about where a
session's cache lives:

* **sizing** — when the caller leaves ``batch``/``max_len`` unspecified,
  :func:`~repro_torch.serve.kv_cache.derive_cache_shape` sizes them from
  the serving tier's ``cache_tier_report``.
* **slot lifecycle** — allocate / bind / release of the fixed decode slots.
* **spill** — a paused session's KV leaves HBM through a secondary
  :class:`~repro_torch.core.runtime.MemoryRuntime` (``kv_stash`` /
  ``kv_fetch`` in its ``traffic_report()``) and is fetched back on resume.

Two storage models share that contract:

* :class:`KVCacheManager` — one contiguous ``max_len``-row region per
  session, spilled/fetched whole.
* :class:`PagedKVCacheManager` — KV lives in a pool of fixed-size pages; a
  session holds a page list (:class:`~repro_torch.serve.paging.PageTable`),
  pausing merely marks its pages *cold*, and spill happens lazily per page
  through a per-tenant codec, only when an allocation needs the frame.
  A hybrid model's recurrent (conv / ssm) state has no sequence axis to
  page: it stays one row per slot beside the pool (``slot_tree``) and is
  parked whole on preemption, as the monolithic manager parks a slot.

Storage is updated in place (the reference donates its buffers to jit).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import MemoryPlan
from repro_torch.core.compress import (decode_leaves, encode_leaves,
                                       encode_tensor, get_codec)
from repro_torch.core.runtime import MemoryRuntime, fmt_bytes
from repro_torch.core.tiers import TransferHints
from repro_torch.models import transformer as tfm
from repro_torch.serve.kv_cache import (DEFAULT_HBM_FRAC, DEFAULT_MAX_BATCH,
                                        DEFAULT_MAX_LEN, derive_cache_shape)
from repro_torch.serve.paging import PageTable, SharedPayload
from repro_torch.serve.session import Session, SessionState

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _SpilledSlot:
    """One paused session's slot cache, parked in the secondary tier."""

    session: Session                  # owner (for cancelled-entry sweeps)
    paths: List[tree.Path]            # cache tree structure
    payloads: List[Any]               # one tier payload per cache leaf
    dtypes: List[torch.dtype]         # restore dtypes on fetch


@dataclasses.dataclass
class _SpilledPage:
    """One evicted page, parked in the secondary tier (paged manager)."""

    paths: List[tree.Path]            # page tree structure
    items: List[Tuple[Any, Any, Any]]  # (tier payload, codec scale, dtype)
    codec: Optional[str]              # None: raw


def _frame(pool, pid: int) -> Tuple[List[torch.Tensor], List[tree.Path]]:
    """The leaves (views, in the pool's flatten order) and paths of frame
    ``pid`` of a page pool or side pool."""
    return tree.flatten(tree.map(lambda c: c[:, pid], pool))


class KVCacheManager:
    """Slot allocation + tier placement for the serving KV cache."""

    #: storage model marker (the Engine branches its compute on this)
    paged: bool = False
    #: page size in cache rows (None: monolithic slots)
    page_size: Optional[int] = None

    def __init__(self, model, batch: Optional[int] = None,
                 max_len: Optional[int] = None, *,
                 spill: Union[str, MemoryRuntime, None] = "spill",
                 hbm_frac: float = DEFAULT_HBM_FRAC,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 default_max_len: int = DEFAULT_MAX_LEN,
                 dtype_bytes: int = 2):
        self.model = model
        sized = derive_cache_shape(
            model.cfg, model.runtime, batch, max_len,
            page_size=self.page_size, hbm_frac=hbm_frac,
            max_batch=max_batch, default_max_len=default_max_len,
            dtype_bytes=dtype_bytes)
        self.batch: int = sized["batch"]
        self.max_len: int = sized["max_len"]
        self.report: Dict[str, Any] = sized["report"]
        self.auto_sized = not batch or not max_len

        self.slots: List[Optional[Session]] = [None] * self.batch
        self._spilled: Dict[int, _SpilledSlot] = {}
        self._slot_parks = 0              # slots parked whole, and bytes
        self._slot_park_bytes = 0
        self._init_storage()

        # secondary tier for cold slots/pages (None: preemption unsupported)
        if isinstance(spill, MemoryRuntime) or spill is None:
            self.spill_runtime: Optional[MemoryRuntime] = spill
        else:
            self.spill_runtime = MemoryRuntime(
                model.plan,
                MemoryPlan(policy=spill, placement=model.memory.placement),
                model.device)
        log.info("kv cache [%s]: batch=%d max_len=%d (%s/device, fits=%s)%s%s",
                 self.report["tier"], self.batch, self.max_len,
                 fmt_bytes(self.report["per_device_bytes"]),
                 self.report["fits"],
                 " [auto-sized]" if self.auto_sized else "",
                 f" [pages={self.report['num_pages']}"
                 f"x{self.page_size}]" if self.paged else "")

    def _init_storage(self) -> None:
        self.caches = self.model.init_cache(self.batch, self.max_len)

    # ------------------------------------------------------------------
    # slot lifecycle
    def free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    def num_free(self) -> int:
        return sum(1 for s in self.slots if s is None)

    def running(self) -> List[Session]:
        return [s for s in self.slots if s is not None]

    def fits_prompt(self, prompt_len: int) -> bool:
        """A prompt must leave at least one cache row for decode writes."""
        return prompt_len < self.max_len

    def session_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case page reservation for one session (0: unpaged — page
        budgets only bind in paged mode)."""
        return 0

    def prepare_slot(self, slot: int, sess: Session, rows: int) -> None:
        """Hook: back ``rows`` cache rows for a fresh admission (paged:
        allocate the prompt's pages before the prefill)."""

    def abort_prepare(self, sess: Session) -> None:
        """Hook: undo a failed :meth:`prepare_slot`."""

    def ensure_rows(self, sess: Session, rows: int) -> None:
        """Hook: grow a resident session to ``rows`` cache rows (paged:
        demand page allocation, evicting cold pages as needed)."""

    def bind(self, slot: int, sess: Session, length: int) -> None:
        assert self.slots[slot] is None, (slot, self.slots[slot])
        self.slots[slot] = sess
        sess.slot = slot
        sess.length = length
        sess.state = SessionState.RUNNING
        sess.steps_since_admit = 0

    def release(self, sess: Session) -> None:
        """Retire a session's slot (its cache rows are dead)."""
        if sess.slot is not None:
            self.slots[sess.slot] = None
            sess.slot = None
        self.drop_spilled(sess)

    @property
    def can_preempt(self) -> bool:
        return self.spill_runtime is not None

    # ------------------------------------------------------------------
    # spill / resume (cold slots through the secondary tier)
    def pause(self, sess: Session) -> None:
        """Preempt: move the session's KV out of HBM into the spill tier."""
        assert sess.slot is not None, sess
        assert self.spill_runtime is not None, \
            "KVCacheManager(spill=None) cannot preempt sessions"
        self._park_slot(self.caches, sess)
        self._clear_slot(sess)

    def resume(self, sess: Session, slot: int) -> None:
        """Fetch a paused session's KV back into ``slot``."""
        tfm.merge_slot_cache(self.caches, self._unpark_slot(sess), slot)
        self.bind(slot, sess, sess.length)

    def _park_slot(self, caches, sess: Session) -> None:
        leaves, paths = tree.flatten(tfm.slot_cache(caches, sess.slot))
        self._slot_parks += 1
        self._slot_park_bytes += sum(x.numel() * x.element_size()
                                     for x in leaves)
        payloads = [self.spill_runtime.stash(
            x, TransferHints(dtype=x.dtype, batch_dim=1, name="kv_spill"),
            direction="kv_stash") for x in leaves]
        self._spilled[sess.uid] = _SpilledSlot(
            sess, paths, payloads, [x.dtype for x in leaves])

    def _unpark_slot(self, sess: Session):
        entry = self._spilled.pop(sess.uid)
        leaves = []
        for payload, dt in zip(entry.payloads, entry.dtypes):
            leaves.append(self.spill_runtime.fetch(
                payload, TransferHints(dtype=dt, batch_dim=1,
                                       name="kv_spill"),
                direction="kv_fetch"))
            self._discard(payload)
        return tree.unflatten(entry.paths, leaves)

    def _clear_slot(self, sess: Session) -> None:
        self.slots[sess.slot] = None
        sess.slot = None
        sess.state = SessionState.PAUSED
        sess.steps_since_admit = 0
        sess.preemptions += 1

    def drop_spilled(self, sess: Session) -> None:
        """Discard a paused session's parked cache (cancel/retire)."""
        entry = self._spilled.pop(sess.uid, None)
        if entry is not None:
            for payload in entry.payloads:
                self._discard(payload)

    def sweep_cancelled(self) -> None:
        """Drop parked caches whose owner was cancelled while paused."""
        for entry in list(self._spilled.values()):
            if entry.session.done:
                self.drop_spilled(entry.session)

    def _discard(self, payload) -> None:
        """Return capacity-contract budget to a SpillTier leg, if any."""
        if self.spill_runtime is not None:
            self.spill_runtime.discard(payload)

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, Any]:
        """Spill-tier byte accounting (kv_stash / kv_fetch directions)."""
        if self.spill_runtime is None:
            return {}
        return self.spill_runtime.traffic_report()

    def describe(self) -> str:
        spill = (self.spill_runtime.tier.describe()
                 if self.spill_runtime else "none")
        return (f"kv[batch={self.batch} max_len={self.max_len} "
                f"tier={self.report['tier']} spill={spill}]")


# ---------------------------------------------------------------------------
class PagedKVCacheManager(KVCacheManager):
    """Paged KV: sessions hold page lists over a shared pool.

    * The pool (:func:`~repro_torch.models.transformer.paged_pool`) holds
      ``pages`` frames plus one scratch frame absorbing masked writes;
      ``pages`` < batch x pages_per_slot **overcommits** it (the smaller
      pool is physically smaller).  Pool pressure evicts cold pages or, at
      the limit, preempts (Engine policy).
    * ``codec_for(tenant)`` picks the spill codec per tenant (None: raw
      pages); a codec with kernels packs and unpacks through them
      (``kernels/offload_pack.py``: the CUDA kernel on the card, its plain
      version on the CPU — bit-identical to the per-tensor transform).
      A page is one launch each way where the codec allows: the int8 pack
      reads every leaf of an evicted page straight from its frame, and
      every fetched or inflated page decodes straight into its frame.
    * ``decode_kernel``: decode runs in place over the pool through the
      paged-attention kernel, and a cold int8 page may resume *compressed*
      into a side pool that the kernel dequantises in its K/V load.
    * A hybrid model's slot-shaped leaves (``slot_tree``: the SSM groups'
      conv / ssm state) sit beside the pool, one row per decode slot, and
      are parked whole through the spill tier when their session pauses.
    * Prefix sharing (the reference's radix index) is not ported yet.

    A page's bytes never depend on the decode path: a compressed-resident
    page is inflated back into its raw frame before that frame is released
    (evicted or freed), so the frame — whose stale rows a later tail page
    inherits, and whose int8 scale those rows help set — holds exactly what
    the inflate path leaves there, and an evicted page is re-encoded from
    those bytes as the inflate path does.
    """

    paged = True

    def __init__(self, model, batch: Optional[int] = None,
                 max_len: Optional[int] = None, *,
                 page_size: int = 64,
                 pages: Optional[int] = None,
                 codec_for: Optional[Callable[[str], Optional[str]]] = None,
                 decode_kernel: bool = False,
                 prefix_share: bool = False,
                 **kwargs):
        if prefix_share:
            raise NotImplementedError(
                "prefix sharing (the radix prefix index) is not ported yet")
        self.page_size = int(page_size)
        self._pages_override = pages
        self.codec_for = codec_for or (lambda tenant: None)
        self.decode_kernel = bool(decode_kernel)
        self._sessions: Dict[int, Session] = {}       # uid -> owner
        self._codec_by_uid: Dict[int, Optional[str]] = {}
        super().__init__(model, batch, max_len, **kwargs)

    def _init_storage(self) -> None:
        if self.max_len % self.page_size:
            raise ValueError(f"page_size {self.page_size} must divide "
                             f"max_len {self.max_len}")
        self.pages_per_slot = self.max_len // self.page_size
        full = self.batch * self.pages_per_slot
        num = self._pages_override if self._pages_override else full
        if not 1 <= num <= full:
            raise ValueError(f"pages must be in [1, {full}]: {num}")
        m = self.model
        self.pool, self.slot_tree = tfm.paged_pool(
            m.cfg, num, self.page_size, m.dtype, m.device, batch=self.batch)
        self._has_slot_leaves = bool(tree.leaves(self.slot_tree))
        self.table = PageTable(num, self.page_size)
        # a dying frame (evicted / freed) takes its compressed page back
        # to raw bytes first (see the class docstring)
        self.table.on_release = self._inflate_side_frame
        self.scratch_id = num                     # pool holds num+1 frames
        self._pmap_dev: Optional[torch.Tensor] = None
        self._pmap_np: Optional[np.ndarray] = None
        self.report["num_pages"] = num
        # compressed side pool (decode_kernel): int8 frames + one scale per
        # (layer, frame); translated page-map ids >= num+1 address frame
        # ``id - (num+1)`` and the decode kernel dequantises them in the
        # K/V load.  Only codecs with an int8 payload are eligible.
        self._cframe_by_pid: Dict[int, Tuple] = {}   # pid -> (ci, codec,
        self._cframe_free: List[int] = []            #   leaf scales)
        self.cpool = self.cscale = None
        if self.decode_kernel:
            self.cpool = tree.map(
                lambda c: torch.zeros(c.shape[:1] + (num,) + c.shape[2:],
                                      dtype=torch.int8, device=c.device),
                self.pool)
            self.cscale = tree.map(
                lambda c: torch.zeros(c.shape[:1] + (num, 1),
                                      dtype=torch.float32, device=c.device),
                self.pool)
            self._cframe_free = list(range(num))
        self._cframe_adopts = 0
        # pages decoded into the pool: refetched (not adopted) and side
        # frames inflated -- one unpack launch each
        self._decoded_refetches = 0
        self._cframe_inflates = 0
        # decode-io metering: pages the attention reads per step
        cfg = m.cfg
        self._decode_window = cfg.window if cfg.attention == "swa" else 0
        self._decode_steps = 0
        self._decode_pages_touched = 0
        self._decode_pages_gather = 0
        self._page_frame_bytes = sum(
            math.prod(c.shape[:1] + c.shape[2:]) * c.element_size()
            for c in tree.leaves(self.pool))

    # ------------------------------------------------------------------
    def session_pages(self, prompt_len: int, max_new: int) -> int:
        """Worst-case reservation: rows the session can ever occupy."""
        return self.table.pages_for(min(self.max_len, prompt_len + max_new))

    def _inflate_side_frame(self, pid: int) -> None:
        """Decode a compressed-resident page into its raw frame and return
        its side-pool frame; no-op for a raw page."""
        entry = self._cframe_by_pid.pop(pid, None)
        if entry is None:
            return
        ci, codec_name, scales = entry
        decode_leaves(get_codec(codec_name), _frame(self.cpool, ci)[0],
                      scales, _frame(self.pool, pid)[0])
        self._cframe_inflates += 1
        self._cframe_free.append(ci)
        self._pmap_dev = None

    def prepare_slot(self, slot: int, sess: Session, rows: int) -> None:
        """Back the prompt's rows with pages before the prefill.  Raises
        :class:`~repro_torch.serve.paging.PageError` when the pool cannot
        cover them (every page hot) — the Engine then aborts and defers."""
        self._sessions[sess.uid] = sess
        self._codec_by_uid[sess.uid] = self.codec_for(sess.tenant)
        self.table.ensure(sess.uid, rows, self._evict_cb)

    def abort_prepare(self, sess: Session) -> None:
        for entry in self.table.free_session(sess.uid):
            self._discard_page(entry)
        self._sessions.pop(sess.uid, None)
        self._codec_by_uid.pop(sess.uid, None)

    def bind(self, slot: int, sess: Session, length: int) -> None:
        super().bind(slot, sess, length)
        self._pmap_dev = None           # the slot's row of the map changed

    def ensure_rows(self, sess: Session, rows: int) -> None:
        """Demand paging for decode growth (may evict cold pages)."""
        if self.table.ensure(sess.uid, rows, self._evict_cb):
            self._pmap_dev = None

    def page_map(self) -> torch.Tensor:
        """(batch, pages_per_slot) int32 pool indices on the device;
        unowned positions point at the scratch frame.  Cached — the map only
        changes on admission/growth/preemption/adoption, not per decode step.

        With ``decode_kernel`` the map is *translated*: a page resident in
        the compressed side pool emits ``scratch_id + 1 + ci``."""
        if self._pmap_dev is None:
            self._pmap_np = self._build_map(translate=self.decode_kernel)
            self._pmap_dev = torch.as_tensor(self._pmap_np,
                                             device=self.model.device)
        return self._pmap_dev

    def page_map_host(self) -> np.ndarray:
        """Host copy of :meth:`page_map` (same translation)."""
        self.page_map()
        return self._pmap_np

    def _build_map(self, translate: bool = False) -> np.ndarray:
        m = np.full((self.batch, self.pages_per_slot), self.scratch_id,
                    np.int32)
        for slot, sess in enumerate(self.slots):
            if sess is not None:
                self._fill_row(m, slot, sess, translate)
        return m

    def page_row_for(self, sess: Session) -> np.ndarray:
        """A pending admission's (untranslated) page row — its pages are
        fresh raw frames; the prefill runs before :meth:`bind`."""
        m = np.full((1, self.pages_per_slot), self.scratch_id, np.int32)
        self._fill_row(m, 0, sess, False)
        return m

    def _fill_row(self, m: np.ndarray, slot: int, sess: Session,
                  translate: bool = False) -> None:
        for pos, pid in enumerate(self.table.resident_pids(sess.uid)):
            assert pid is not None, \
                f"resident session {sess.uid} has a spilled page {pos}"
            if translate and pid in self._cframe_by_pid:
                m[slot, pos] = (self.scratch_id + 1
                                + self._cframe_by_pid[pid][0])
            else:
                m[slot, pos] = pid

    # ------------------------------------------------------------------
    # per-page spill path (lazy: only on real pool pressure)
    def _evict_cb(self, uid: int, pos: int, pid: int) -> _SpilledPage:
        assert self.spill_runtime is not None, \
            "page eviction needs a spill tier " \
            "(PagedKVCacheManager(spill=None) cannot overcommit)"
        self._inflate_side_frame(pid)
        codec_name = self._codec_by_uid.get(uid)
        codec = get_codec(codec_name) if codec_name else None
        frame, paths = _frame(self.pool, pid)
        if codec is not None and codec.pack_leaves is not None \
                and all(codec.applies_to(x) for x in frame):
            # the whole page in one launch, read straight from the frame
            coded = encode_leaves(codec, frame)
        else:
            leaves = tree.leaves(tfm.page_slice(self.pool, pid))
            coded = [encode_tensor(codec, x)
                     if codec is not None and codec.applies_to(x)
                     else (x, None) for x in leaves]
        items = []
        for x, (q, scale) in zip(frame, coded):
            payload = self.spill_runtime.stash(
                q, TransferHints(dtype=q.dtype, batch_dim=0,
                                 allow_compress=False, name="kv_page"),
                direction="kv_stash")
            items.append((payload, scale, x.dtype))
        return _SpilledPage(paths, items, codec_name)

    def _fetch_items(self, entry: _SpilledPage) -> List[torch.Tensor]:
        """Fetch a spilled page's payloads, then discard them: only after
        EVERY leaf fetched, so a failure leaves the payload intact and the
        caller can re-park the position for a later retry."""
        qs = [self.spill_runtime.fetch(
            payload, TransferHints(dtype=dtype, batch_dim=0,
                                   allow_compress=False, name="kv_page"),
            direction="kv_fetch") for payload, _, dtype in entry.items]
        self._discard_page(entry)
        return qs

    def _unstash_page(self, entry: _SpilledPage, pid: int) -> None:
        """Fetch a spilled page (every payload, before any decode) into
        frame ``pid``: raw leaves copied in, the coded ones decoded straight
        into the frame in one launch."""
        qs = self._fetch_items(entry)
        frame = _frame(self.pool, pid)[0]
        coded = [(q, scale, out) for q, (_, scale, _), out
                 in zip(qs, entry.items, frame) if scale is not None]
        for q, (_, scale, _), out in zip(qs, entry.items, frame):
            if scale is None:
                out.copy_(q)
        if coded:
            decode_leaves(get_codec(entry.codec), *zip(*coded))
            self._decoded_refetches += 1

    def _discard_page(self, entry: _SpilledPage) -> None:
        for payload, _, _ in entry.items:
            self._discard(payload)

    # ------------------------------------------------------------------
    # compressed residency (decode_kernel=True)
    def _compressible_resume(self, sess: Session, pos: int, parked,
                             entry: _SpilledPage) -> bool:
        """Eligibility for fused-decode residency.  The tail page (the one
        the next decode step writes into) resumes raw; only int8-payload
        codecs fit the side pool."""
        return (self.decode_kernel
                and entry.codec in ("int8", "blocksparse")
                and bool(self._cframe_free)
                and not isinstance(parked, SharedPayload)
                and pos < sess.length // self.page_size
                and all(s is not None for _, s, _ in entry.items))

    def _adopt_compressed(self, entry: _SpilledPage, pid: int) -> None:
        """Fetch a quantized page into a side-pool frame verbatim (no
        decode) and record the pid -> frame mapping."""
        qleaves = self._fetch_items(entry)
        ci = self._cframe_free.pop()
        tfm.page_insert(self.cpool, tree.unflatten(entry.paths, qleaves), ci)
        scales = [s for _, s, _ in entry.items]

        def set_scale(store, scale):
            store[:, ci] = scale

        tree.map(set_scale, self.cscale, tree.unflatten(entry.paths, scales))
        self._cframe_by_pid[pid] = (ci, entry.codec, scales)
        self._cframe_adopts += 1
        self._pmap_dev = None

    # ------------------------------------------------------------------
    # pause / resume: pages go cold in place; slot-shaped leaves park whole
    def pause(self, sess: Session) -> None:
        assert sess.slot is not None, sess
        assert self.spill_runtime is not None, \
            "PagedKVCacheManager(spill=None) cannot preempt sessions"
        if self._has_slot_leaves:
            self._park_slot(self.slot_tree, sess)
        self.table.mark_cold(sess.uid)
        self._clear_slot(sess)
        self._pmap_dev = None

    def resume(self, sess: Session, slot: int) -> None:
        """Re-bind a paused session: surviving pages readmit copy-free,
        evicted ones are fetched (and decoded, or adopted compressed) into
        fresh frames, and a parked slot-shaped state is fetched into
        ``slot`` — after every page, so a pool too hot to re-home them
        leaves the state parked."""
        uid = sess.uid
        self.table.mark_hot(uid)
        try:
            while True:
                spilled = self.table.spilled_positions(uid)
                if not spilled:
                    break
                pos = spilled[0]
                parked = self.table.entries(uid)[pos].payload
                inner = parked.payload \
                    if isinstance(parked, SharedPayload) else parked
                pid = self.table.set_resident(uid, pos, self._evict_cb)
                try:
                    if self._compressible_resume(sess, pos, parked, inner):
                        self._adopt_compressed(inner, pid)
                        continue
                    self._unstash_page(inner, pid)
                except Exception:
                    # the fetch failed AFTER the position went resident:
                    # roll it back to spilled over the (intact) payload
                    self.table.unset_resident(uid, pos, parked)
                    raise
        except Exception:
            # pool too hot to re-home every page: stay paused, the Engine
            # retries later
            self.table.mark_cold(uid)
            raise
        if uid in self._spilled:
            tfm.merge_slot_cache(self.slot_tree, self._unpark_slot(sess),
                                 slot)
        self.table.note_resumed(uid)
        self.bind(slot, sess, sess.length)

    def release(self, sess: Session) -> None:
        super().release(sess)
        self._pmap_dev = None
        for entry in self.table.free_session(sess.uid):
            self._discard_page(entry)
        self._sessions.pop(sess.uid, None)
        self._codec_by_uid.pop(sess.uid, None)

    def sweep_cancelled(self) -> None:
        super().sweep_cancelled()
        for uid in list(self.table.sessions()):
            sess = self._sessions.get(uid)
            if sess is not None and sess.done and sess.slot is None:
                self.release(sess)

    # ------------------------------------------------------------------
    def note_decode(self, length: int, n_active: int) -> None:
        """Record one decode step for ``n_active`` sessions at ``length``
        rows: in-place decode touches only the pages covering the rows the
        query can see; the gather path reads the whole view."""
        lo = 0
        if self._decode_window > 0:
            lo = max(0, length - self._decode_window + 1) // self.page_size
        touched = self.table.pages_for(length + 1) - lo
        gather = self.batch * self.pages_per_slot
        self._decode_steps += 1
        self._decode_pages_touched += \
            touched * n_active if self.decode_kernel else gather
        self._decode_pages_gather += gather

    def traffic_report(self) -> Dict[str, Any]:
        report = dict(super().traffic_report())
        report["pages"] = {
            "page_size": self.page_size,
            "num_pages": self.table.num_pages,
            "evictions": self.table.evictions,
            "refetches": self.table.refetches,
            "readmits_free": self.table.readmits_free,
            "adoptions": self.table.adoptions,
            "shared_binds": self.table.shared_binds,
        }
        report["slots"] = {
            "parks": self._slot_parks,
            "park_bytes": self._slot_park_bytes,
        }
        report["decode_io"] = {
            "in_place": self.decode_kernel,
            "steps": self._decode_steps,
            "pages_touched": self._decode_pages_touched,
            "pages_gather_equiv": self._decode_pages_gather,
            "bytes_touched":
                self._decode_pages_touched * self._page_frame_bytes,
            "bytes_gather_equiv":
                self._decode_pages_gather * self._page_frame_bytes,
            "compressed_resident": len(self._cframe_by_pid),
            "compressed_adopts": self._cframe_adopts,
        }
        report["page_decodes"] = {
            "refetched": self._decoded_refetches,
            "inflated": self._cframe_inflates,
        }
        return report

    def describe(self) -> str:
        return (f"{super().describe()[:-1]} "
                f"{self.table.describe()}]")
