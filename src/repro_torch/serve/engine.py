"""Engine: thin facade over the Scheduler / KVCacheManager / Session APIs.

The serving stack is three composable APIs; the engine wires them to the
model's prefill/decode compute and the sampler:

* :class:`~repro_torch.serve.scheduler.Scheduler` — admission, continuous
  batching, preemption (fcfs / priority / fair / srpt / deadline).
* :class:`~repro_torch.serve.cache_manager.KVCacheManager` — slot
  allocation, auto-sizing, cold-KV spill to a secondary memory tier;
  ``page_size`` switches to the
  :class:`~repro_torch.serve.cache_manager.PagedKVCacheManager`.
* :class:`~repro_torch.serve.session.Session` — the streaming result API.

Multi-tenant admission (``quota=``) is enforced here: a session is charged
its worst-case page reservation against its tenant's quota before it may
take a slot.  This is the colocated engine (prefill and decode in one
lifecycle); the reference's disaggregated roles and prefix sharing come
with later slices.

Decode runs one batched step per unique cache length (the paged kernel
takes one ``cache_index`` per call).  With ``decode_kernel`` the step's
K/V row is written straight into its page frame and attention runs over
the pool through the block table; otherwise the slots' pages are gathered
into a contiguous view and the touched page is scattered back.  Every
slot decodes, so every path puts back what the step changed for the
slots outside its length group: row ``length`` of their k/v (monolithic
slots; paged, those rows land in the scratch frame) and the whole of
their recurrent conv / ssm state (the reference's ``_masked_merge``).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve.cache_manager import (KVCacheManager,
                                             PagedKVCacheManager)
from repro_torch.serve.paging import PageError
from repro_torch.serve.quota import QuotaManager, TenantQuota
from repro_torch.serve.scheduler import Scheduler, build_scheduler
from repro_torch.serve.session import (FINISH_CACHE_FULL, FINISH_EOS,
                                       FINISH_LENGTH, FINISH_QUOTA,
                                       FINISH_REJECTED, Session, SessionState)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S_prompt,) int32
    max_new_tokens: int = 16
    eos_id: int = -1                   # -1: never
    priority: int = 0                  # PriorityScheduler rank (higher first)
    tenant: str = "default"            # quota / codec bucket
    deadline: Optional[float] = None   # DeadlineScheduler: absolute step
    out_tokens: Optional[List[int]] = None

    def __post_init__(self):
        if self.out_tokens is None:
            self.out_tokens = []


class Engine:
    """Facade: scheduler + cache manager + quotas + sampler in one object.

    ``batch`` / ``max_len`` may be omitted — the cache manager then sizes
    them from the serving tier's ``cache_tier_report``."""

    def __init__(self, model: Model, params,
                 batch: Optional[int] = None,
                 max_len: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 scheduler: Union[str, Scheduler] = "fcfs",
                 spill: Union[str, object, None] = "spill",
                 page_size: Optional[int] = None,
                 pages: Optional[int] = None,
                 decode_kernel: bool = False,
                 quota: Union[QuotaManager, TenantQuota,
                              Dict[str, TenantQuota], None] = None,
                 prefix_share: bool = False,
                 **cache_kwargs):
        self.model = model
        self.params = params
        self.device = model.device
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.scheduler: Scheduler = (build_scheduler(scheduler)
                                     if isinstance(scheduler, str)
                                     else scheduler)
        if quota is None or isinstance(quota, QuotaManager):
            self.quota: Optional[QuotaManager] = quota
        elif isinstance(quota, TenantQuota):
            self.quota = QuotaManager(default_quota=quota)
        else:
            self.quota = QuotaManager(dict(quota))

        if decode_kernel and not page_size:
            raise ValueError("decode_kernel needs paged KV: pass page_size")
        if page_size:
            self.cache: KVCacheManager = PagedKVCacheManager(
                model, batch, max_len, spill=spill, page_size=page_size,
                pages=pages,
                codec_for=self.quota.codec_for if self.quota else None,
                decode_kernel=decode_kernel,
                prefix_share=prefix_share, **cache_kwargs)
        else:
            if prefix_share:
                raise ValueError("prefix_share needs paged KV (page_size)")
            self.cache = KVCacheManager(model, batch, max_len, spill=spill,
                                        **cache_kwargs)
        self.batch, self.max_len = self.cache.batch, self.cache.max_len
        self.kv_report = self.cache.report
        if not self.kv_report["fits"]:
            log.warning("kv cache exceeds per-device HBM: %.2f GB/device "
                        "(tier %s could address %.2f GB) — expect OOM at "
                        "this batch/max_len",
                        self.kv_report["per_device_bytes"] / 1e9,
                        self.kv_report["tier"],
                        self.kv_report["capacity_bytes"] / 1e9)

        self.sessions: List[Session] = []      # every submission, in order
        self.finished: List[Request] = []      # legacy result list
        self._seq = 0
        self._by_uid: Dict[int, Session] = {}

    # ------------------------------------------------------------------
    # compute: prefill / decode against the manager's storage (in place)
    def _prefill(self, toks: torch.Tensor, slot: int,
                 sess: Session) -> torch.Tensor:
        """Prefill one prompt from a zeroed single-slot cache (a reused
        slot's old rows, and its previous occupant's recurrent state, must
        not leak into the new session), then write the slot — paged: its
        pages, and its slot-shaped state into row ``slot`` beside them —
        into the storage."""
        cache = self.cache
        one = self.model.init_cache(1, self.max_len)
        pos = self._positions(toks.shape[1], 0, 1)
        logits, one = self.model.prefill(
            self.params, {"tokens": toks, "positions": pos}, one)
        if cache.paged:
            row = torch.as_tensor(cache.page_row_for(sess),
                                  device=self.device)
            tfm.scatter_pages(cache.pool, one, row)
            tfm.merge_slot_cache(cache.slot_tree, tfm.split_paged(one)[1],
                                 slot)
        else:
            tfm.merge_slot_cache(cache.caches, one, slot)
        return logits[0]

    def _saved_outside(self, caches, mask: np.ndarray,
                       length: int) -> list:
        """Copies of what a decode step at ``length`` must not change for
        the slots outside ``mask``: row ``length`` of their k/v leaves,
        the whole of every other (slot-shaped) leaf; :meth:`_restore` puts
        them back."""
        leaves, paths = tree.flatten(caches)
        if not leaves:
            return []
        keep = torch.as_tensor(np.flatnonzero(~mask), device=self.device)
        where = [(slice(None), keep, length) if path[-1] in tfm.PAGED_KEYS
                 else (slice(None), keep) for path in paths]
        return [(c, w, c[w].clone()) for c, w in zip(leaves, where)]

    @staticmethod
    def _restore(saved: list) -> None:
        for c, w, s in saved:
            c[w] = s

    def _decode(self, tok: torch.Tensor, length: int,
                mask: np.ndarray) -> torch.Tensor:
        """One decode step of every slot at cache position ``length``; only
        the ``mask`` slots' storage takes the step's K/V row and its new
        recurrent state."""
        cache = self.cache
        pos = self._positions(1, length, self.batch)
        # the slots outside the group decode a dummy token: paged, its k/v
        # row lands in the scratch frame; what it writes into their slots
        # (monolithic k/v row ``length``, recurrent state) is put back
        saved = self._saved_outside(
            cache.slot_tree if cache.paged else cache.caches, mask, length)
        if cache.paged and cache.decode_kernel:
            page = cache.page_size
            wp, row_off = divmod(length, page)
            write = np.where(mask, cache.page_map_host()[:, wp],
                             cache.scratch_id)
            # the write page is raw by construction (tail pages never
            # resume compressed); a translated id here would scribble past
            # the pool
            if int(write.max()) > cache.scratch_id:
                raise RuntimeError(f"decode write frame past the raw pool: "
                                   f"{write.tolist()}")
            cache.note_decode(length, int(mask.sum()))
            caches = {g: dict(cache.pool[g],
                              kq=cache.cpool[g]["k"], vq=cache.cpool[g]["v"],
                              ks=cache.cscale[g]["k"], vs=cache.cscale[g]["v"])
                      for g in cache.pool}
            caches.update(cache.slot_tree)
            logits, _ = self.model.decode_step(
                self.params, tok, pos, caches, length,
                paged=dict(page_map=cache.page_map(),
                           write_pid=torch.as_tensor(
                               write, dtype=torch.long, device=self.device),
                           row_off=row_off))
        elif cache.paged:
            pm = cache.page_map()
            cache.note_decode(length, int(mask.sum()))
            view = tfm.gather_pages(cache.pool, cache.slot_tree, pm)
            logits, view = self.model.decode_step(self.params, tok, pos,
                                                  view, length)
            # one row written per slot -> write back only its page
            wp = length // cache.page_size
            target = torch.where(
                torch.as_tensor(mask, device=self.device), pm[:, wp],
                cache.scratch_id)
            tfm.scatter_one_page(cache.pool, view, target,
                                 wp * cache.page_size, cache.page_size)
        else:
            logits, _ = self.model.decode_step(self.params, tok, pos,
                                               cache.caches, length)
        self._restore(saved)
        return logits

    # ------------------------------------------------------------------
    def submit(self, req: Request, on_token=None) -> Session:
        """Queue a request; returns its :class:`Session` (token stream)."""
        sess = Session(request=req, seq=self._seq, on_token=on_token)
        self._seq += 1
        self.sessions.append(sess)
        self._by_uid[sess.uid] = sess
        self.scheduler.submit(sess)
        return sess

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """One token per row of ``logits`` (greedy at temperature 0)."""
        if self.temperature <= 0:
            return logits.argmax(dim=-1).tolist()
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1,
                                 generator=self.generator)[:, 0].tolist()

    def _retire(self, sess: Session, reason: str) -> None:
        sess.finish(reason)
        self.cache.release(sess)
        self.scheduler.on_retire(sess)
        self._release_quota(sess)
        self.finished.append(sess.request)

    def _release_quota(self, sess: Session) -> None:
        if self.quota is not None:
            self.quota.release_uid(sess.uid)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        """One engine step: advance the scheduler clock, sweep
        cancellations, preempt, admit, back the next decode row with pages,
        then one decode step for every resident session.  Returns the
        number of resident sessions."""
        self.scheduler.on_step()
        self._sweep_cancelled()
        self._preempt()
        self._admit()
        self._grow_pages()

        slots = self.cache.slots
        active = [i for i, s in enumerate(slots) if s is not None]
        if not active:
            return 0
        # idle slots decode a dummy token (masked out); mixed cache lengths
        # decode per unique-length group
        tok = np.zeros((self.batch, 1), np.int64)
        for i in active:
            tok[i, 0] = slots[i].tokens[-1]
        tok = torch.as_tensor(tok, device=self.device)
        groups: Dict[int, List[int]] = {}
        for i in active:
            groups.setdefault(slots[i].length, []).append(i)
        for length, idxs in sorted(groups.items()):
            mask = np.zeros((self.batch,), bool)
            mask[idxs] = True
            logits = self._decode(tok, length, mask)
            for i, nxt in zip(idxs, self._sample(logits[idxs])):
                sess = slots[i]
                sess.emit(nxt)
                sess.length += 1
                if sess.done:
                    # cancelled from the on_token callback mid-stream
                    self.cache.release(sess)
                    self.scheduler.on_retire(sess)
                    self._release_quota(sess)
                elif nxt == sess.request.eos_id:
                    self._retire(sess, FINISH_EOS)
                elif len(sess.tokens) >= sess.request.max_new_tokens:
                    self._retire(sess, FINISH_LENGTH)
                elif sess.length >= self.max_len:
                    # the NEXT decode would write past the last cache row
                    self._retire(sess, FINISH_CACHE_FULL)
        return len(active)

    # ------------------------------------------------------------------
    def _sweep_cancelled(self) -> None:
        """Honour out-of-band Session.cancel(): free the slot of a
        cancelled resident session, drop the parked cache / pages of one
        cancelled while paused, and return the tenant-quota charge."""
        for sess in self.cache.running():
            if sess.done:
                self.cache.release(sess)
                self.scheduler.on_retire(sess)
        self.cache.sweep_cancelled()
        if self.quota is not None:
            for uid in self.quota.charged_uids():
                sess = self._by_uid.get(uid)
                if sess is not None and sess.done:
                    self.quota.release_uid(uid)

    def _preempt(self) -> None:
        """Pause running sessions when the scheduler ranks waiting work
        above them (their KV goes cold: pages lazily, slots eagerly)."""
        if not self.cache.can_preempt:
            return
        want = len(self.scheduler.waiting())
        freed = self.cache.num_free()
        while freed < want:
            victim = self.scheduler.preempt_victim(self.cache.running())
            if victim is None:
                break
            self.cache.pause(victim)
            self.scheduler.requeue(victim)
            freed += 1

    def _admit(self) -> None:
        """Fill free slots in scheduler order.

        A popped paused session resumes (copy-free for pages never
        evicted); a fresh one is quota-checked, page-backed and prefilled.
        Quota-blocked sessions are deferred — later arrivals (other
        tenants) admit past them — unless their demand could never fit the
        tenant's quota, which rejects with finish reason ``"quota"``.
        Pool-pressure failures (every page hot) stop admission for this
        step."""
        deferred: List[Session] = []
        while True:
            slot = self.cache.free_slot()
            if slot is None:
                break
            sess = self.scheduler.next_ready()
            if sess is None:
                break
            if sess.state is SessionState.PAUSED:
                try:
                    self.cache.resume(sess, slot)
                except PageError:
                    deferred.append(sess)
                    break               # pool too hot; retry next step
                continue
            prompt = np.asarray(sess.request.prompt)
            if not self.cache.fits_prompt(len(prompt)):
                log.warning("req %d: prompt of %d tokens does not fit a "
                            "%d-row cache slot — rejected",
                            sess.uid, len(prompt), self.max_len)
                self._retire(sess, FINISH_REJECTED)
                continue
            pages_needed = self.cache.session_pages(
                len(prompt), sess.request.max_new_tokens)
            if self.quota is not None:
                if not self.quota.admissible(sess.tenant, pages_needed):
                    log.warning("req %d: demand (%d pages) can never fit "
                                "tenant %r quota — rejected",
                                sess.uid, pages_needed, sess.tenant)
                    self._retire(sess, FINISH_QUOTA)
                    continue
                if not self.quota.can_admit(sess.tenant, pages_needed):
                    deferred.append(sess)
                    continue
            try:
                self.cache.prepare_slot(slot, sess, max(1, len(prompt)))
            except PageError:
                self.cache.abort_prepare(sess)
                deferred.append(sess)
                break                   # pool too hot; retry next step
            if self.quota is not None:
                self.quota.charge(sess.uid, sess.tenant, pages_needed)
            toks = torch.as_tensor(prompt, dtype=torch.long,
                                   device=self.device)[None, :]
            logits = self._prefill(toks, slot, sess)
            self.cache.bind(slot, sess, toks.shape[1])
            nxt = self._sample(logits[None])[0]
            sess.emit(nxt)
            if nxt == sess.request.eos_id:
                self._retire(sess, FINISH_EOS)
            elif len(sess.tokens) >= sess.request.max_new_tokens:
                self._retire(sess, FINISH_LENGTH)
        for sess in reversed(deferred):
            self.scheduler.requeue(sess)

    def _grow_pages(self) -> None:
        """Back every resident session's next decode row with a page.
        Under pool overcommit the allocation may find every page hot; the
        engine then pauses the longest other running session and retries —
        at the limit a session alone in the pool retires ``cache_full``."""
        if not self.cache.paged:
            return
        for sess in list(self.cache.running()):
            if sess.slot is None or sess.done:
                continue    # paused by an earlier iteration's relief
            while True:
                try:
                    self.cache.ensure_rows(sess, sess.length + 1)
                    break
                except PageError:
                    if not self._relieve_pressure(sess):
                        self._retire(sess, FINISH_CACHE_FULL)
                        break

    def _relieve_pressure(self, needy: Session) -> bool:
        others = [s for s in self.cache.running() if s is not needy]
        if not others or not self.cache.can_preempt:
            return False
        victim = max(others, key=lambda s: (s.length, s.seq))
        self.cache.pause(victim)
        self.scheduler.requeue(victim)
        return True

    # ------------------------------------------------------------------
    def _positions(self, S: int, offset: int, batch: int) -> torch.Tensor:
        return torch.arange(offset, offset + S,
                            device=self.device)[None].expand(batch, S)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if self.step() == 0 and not self.scheduler.has_waiting():
                break
        return self.finished

    # ------------------------------------------------------------------
    def traffic_report(self) -> Dict[str, object]:
        """Spill-tier byte accounting (cold-KV kv_stash / kv_fetch) plus,
        in paged mode, the page-level transfer counters."""
        return self.cache.traffic_report()

    def quota_report(self) -> Dict[str, object]:
        """Per-tenant session/page usage (empty without quotas)."""
        return self.quota.usage() if self.quota is not None else {}

    def describe(self) -> str:
        quota = f" {self.quota.describe()}" if self.quota else ""
        return (f"engine[{self.cache.describe()} "
                f"sched={self.scheduler.describe()}{quota}]")
