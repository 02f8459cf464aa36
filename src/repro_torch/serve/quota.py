"""Multi-tenant admission quotas for the serving engine.

The pooled KV cache is a shared resource; without admission control one
tenant's long-context burst evicts everyone else's pages.  A
:class:`TenantQuota` caps what one tenant may hold — a **page budget**
(the unit of pool placement, enforced by reservation at admission so a
mid-decode page allocation can never deadlock on quota) and a **max
concurrent sessions** count — and optionally picks the tenant's spill
codec from the ``core/compress.py`` registry (a latency-insensitive batch
tenant can take int8 pages at half the spill bytes; an interactive tenant
keeps raw pages).

:class:`QuotaManager` is the engine-side ledger: ``charge``/``release_uid``
record and return one session's reservation, ``can_admit``/``admissible``
answer the scheduler-time questions, ``usage`` feeds the traffic report.
Page budgets only bind in paged mode (the unpaged slot cache has no page
notion); session caps bind in both.

The per-session ledger lives *here* (not in the Engine) so a reservation
can follow a session across cooperating runtimes: under disaggregated
serving (serve/disagg.py) the prefill and decode engines share one
QuotaManager — the charge taken at prefill admission stays on the ledger
while the session's KV pages are in flight through the transfer tier and
is released by whichever side retires (or sweeps a cancellation of) the
session.  ``release_uid`` is idempotent for exactly that reason: a
cancelled-in-transit session may be swept by both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission contract of one tenant (None fields: unlimited)."""

    max_pages: Optional[int] = None      # page budget (paged mode)
    max_sessions: Optional[int] = None   # concurrent in-flight sessions
    codec: Optional[str] = None          # spill codec for this tenant's pages

    def validate(self) -> "TenantQuota":
        if self.max_pages is not None and self.max_pages < 0:
            raise ValueError(f"max_pages must be >= 0: {self.max_pages}")
        if self.max_sessions is not None and self.max_sessions < 0:
            raise ValueError(f"max_sessions must be >= 0: {self.max_sessions}")
        if self.codec is not None:
            from repro_torch.core.compress import get_codec
            get_codec(self.codec)        # raises KeyError on unknown codec
        return self

    def describe(self) -> str:
        bits = []
        if self.max_pages is not None:
            bits.append(f"pages={self.max_pages}")
        if self.max_sessions is not None:
            bits.append(f"sessions={self.max_sessions}")
        if self.codec is not None:
            bits.append(f"codec={self.codec}")
        return ",".join(bits) or "unlimited"


class QuotaManager:
    """Per-tenant reservation ledger enforced by the Engine at admission.

    ``quotas`` maps tenant name → :class:`TenantQuota`; tenants without an
    entry fall back to ``default_quota`` (unlimited unless given).  Pages
    are charged as a *reservation* — the worst case the session can grow
    to — when it is first admitted, and returned when it retires; paused
    sessions keep their charge (their pages still occupy pool or spill
    capacity).
    """

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None):
        self.quotas = {t: q.validate() for t, q in (quotas or {}).items()}
        self.default_quota = (default_quota or TenantQuota()).validate()
        self._pages: Dict[str, int] = {}
        self._sessions: Dict[str, int] = {}
        self._charged: Dict[int, Tuple[str, int]] = {}  # uid -> (tenant, pages)
        # federation overlay: peer name -> usage() snapshot of that peer's
        # ledger.  ``can_admit`` counts remote holdings too, so a tenant's
        # quota binds cluster-wide even though each cluster charges locally.
        self._remote: Dict[str, Dict[str, Dict[str, int]]] = {}

    # ------------------------------------------------------------------
    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def codec_for(self, tenant: str) -> Optional[str]:
        return self.quota_for(tenant).codec

    # ------------------------------------------------------------------
    def admissible(self, tenant: str, pages: int) -> bool:
        """Could this session EVER be admitted (empty-tenant headroom)?
        False means the engine should reject it outright instead of
        deferring forever."""
        q = self.quota_for(tenant)
        if q.max_sessions is not None and q.max_sessions < 1:
            return False
        return q.max_pages is None or pages <= q.max_pages

    def can_admit(self, tenant: str, pages: int) -> bool:
        q = self.quota_for(tenant)
        if q.max_sessions is not None and \
                self._sessions.get(tenant, 0) + \
                self._remote_held(tenant, "sessions") + 1 > q.max_sessions:
            return False
        if q.max_pages is not None and \
                self._pages.get(tenant, 0) + \
                self._remote_held(tenant, "pages") + pages > q.max_pages:
            return False
        return True

    def admit(self, tenant: str, pages: int) -> None:
        self._sessions[tenant] = self._sessions.get(tenant, 0) + 1
        self._pages[tenant] = self._pages.get(tenant, 0) + pages

    def release(self, tenant: str, pages: int) -> None:
        self._sessions[tenant] = max(0, self._sessions.get(tenant, 0) - 1)
        self._pages[tenant] = max(0, self._pages.get(tenant, 0) - pages)

    # ------------------------------------------------------------------
    # per-session ledger (reservations that survive role handoffs)
    def charge(self, uid: int, tenant: str, pages: int) -> None:
        """Record one session's worst-case reservation against its tenant."""
        assert uid not in self._charged, f"session {uid} already charged"
        self.admit(tenant, pages)
        self._charged[uid] = (tenant, pages)

    def release_uid(self, uid: int) -> bool:
        """Return a session's reservation; idempotent (False: not charged).

        Safe to call from every runtime that ever saw the session — the
        first caller wins, later sweeps are no-ops — which is what makes
        cancel-while-parked (paused, deferred, or in a transfer queue)
        leak-free without coordinating the sweepers."""
        entry = self._charged.pop(uid, None)
        if entry is None:
            return False
        self.release(*entry)
        return True

    def charge_of(self, uid: int) -> Optional[Tuple[str, int]]:
        return self._charged.get(uid)

    def charged_uids(self) -> Tuple[int, ...]:
        return tuple(self._charged)

    # ------------------------------------------------------------------
    # federation: fold peer clusters' usage snapshots into admission
    def set_remote_usage(self, peer: str,
                         usage: Optional[Dict[str, Dict[str, int]]]) -> None:
        """Install (or with None, drop) one peer cluster's usage snapshot.

        Snapshots arrive over the wire as QUOTA frames; admission then
        treats remote holdings as if they were local, which keeps one
        tenant's quota consistent across federated clusters (eventually
        consistent — bounded by the broadcast cadence)."""
        if usage is None:
            self._remote.pop(peer, None)
        else:
            self._remote[peer] = {t: dict(u) for t, u in usage.items()}

    def _remote_held(self, tenant: str, key: str) -> int:
        return sum(snap.get(tenant, {}).get(key, 0)
                   for snap in self._remote.values())

    def remote_peers(self) -> Tuple[str, ...]:
        return tuple(self._remote)

    # ------------------------------------------------------------------
    def usage(self) -> Dict[str, Dict[str, int]]:
        tenants = set(self._sessions) | set(self._pages) | set(self.quotas)
        return {t: {"sessions": self._sessions.get(t, 0),
                    "pages": self._pages.get(t, 0)}
                for t in sorted(tenants)}

    def describe(self) -> str:
        per = [f"{t}:{q.describe()}" for t, q in sorted(self.quotas.items())]
        per.append(f"*:{self.default_quota.describe()}")
        return f"quota[{' '.join(per)}]"


# ---------------------------------------------------------------------------
def parse_quota_spec(spec: str) -> Tuple[Dict[str, TenantQuota], TenantQuota]:
    """Parse the ``--tenant-quota`` CLI string.

    Grammar: ``[tenant:]k=v[,k=v...][;[tenant:]...]`` with keys
    ``pages`` / ``sessions`` / ``codec``.  A clause without a tenant name
    sets the default quota for every tenant.  Examples::

        pages=16,sessions=2
        interactive:sessions=4;batch:pages=8,codec=int8

    Returns ``(per_tenant, default_quota)`` for :class:`QuotaManager`.
    """
    per: Dict[str, TenantQuota] = {}
    default = TenantQuota()
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        tenant = None
        if ":" in clause:
            tenant, clause = clause.split(":", 1)
            tenant = tenant.strip()
        kw: Dict[str, object] = {}
        for item in filter(None, (i.strip() for i in clause.split(","))):
            if "=" not in item:
                raise ValueError(f"bad quota item {item!r} (want k=v)")
            k, v = (s.strip() for s in item.split("=", 1))
            if k == "pages":
                kw["max_pages"] = int(v)
            elif k == "sessions":
                kw["max_sessions"] = int(v)
            elif k == "codec":
                kw["codec"] = v
            else:
                raise ValueError(f"unknown quota key {k!r} "
                                 "(want pages/sessions/codec)")
        quota = TenantQuota(**kw).validate()
        if tenant:
            per[tenant] = quota
        else:
            default = quota
    return per, default


def quota_from_cli(spec: Optional[str],
                   page_codec: Optional[str] = None
                   ) -> Optional[QuotaManager]:
    """Build the Engine's QuotaManager from the ``--tenant-quota`` /
    ``--page-codec`` CLI pair.

    ``page_codec`` is the fleet-wide spill-codec default: it fills every
    quota — named tenants included — that does not pick its own ``codec``.
    Returns None when neither flag is given (no quota enforcement).
    """
    if not spec and not page_codec:
        return None
    per, default = parse_quota_spec(spec) if spec else ({}, TenantQuota())
    if page_codec:
        def fill(q: TenantQuota) -> TenantQuota:
            return q if q.codec else dataclasses.replace(q, codec=page_codec)
        per = {t: fill(q) for t, q in per.items()}
        default = fill(default)
    return QuotaManager(per, default)
