"""Affinity placement across a fleet of job-server hosts.

The port of `avenir_tpu/net/router.py` (host code: no device work).

The single-server admission controller prices every dispatch in bytes
against ONE budget; a fleet generalizes that scalar to a budget
*vector* — one priced-bytes ceiling per host — and adds a placement
question: which host should a request hit?

The answer that keeps the fleet fast is affinity: a host that already
served a corpus holds its WarmStore pins (encoded-block caches, managed
checkpoints) and its loaded kernel libraries, so a repeat request
over that corpus is cheapest exactly there. The router keeps a sticky
``affinity key -> host`` map (the key is the corpus identity — the same
paths component ``server.compat_key`` batches on) and routes:

1. **Affinity hit** — the sticky host has budget headroom: place there.
2. **Spill** — the sticky host is over its vector entry: place on the
   least-loaded host with headroom (the coded-dispatch framing of
   arXiv:1802.03049 — redundancy beats waiting), WITHOUT moving the
   sticky mapping, so the corpus returns to its warm host when the
   pressure passes.
3. **Miss** — unseen key: least-loaded host with headroom becomes the
   sticky host.
4. **Held** — no host has headroom: ``place`` returns None and the
   caller holds (fleet front) or sheds (listener edge) the request;
   the budget vector is NEVER breached by placement.

Fault awareness (avenir-fault, :mod:`avenir_tpu_torch.net.fault`): each host
carries a supervision state (``serving`` / ``restarting`` / ``stalled``
/ ``quarantined``); only ``serving`` hosts take new placements. A
sticky mapping whose host left ``serving`` is DROPPED on the next
placement for that corpus (counted as a ``failover``) and the corpus
re-places by the normal least-loaded rule — so when the host recovers
it re-earns affinity through fresh hits, never through a map reset.
``place_mirror`` is the hedged-dispatch placement: least-loaded serving
host outside an exclusion set, charged against the budget vector like
any placement but never touching the sticky map (the corpus still
belongs to its slow warm host; the mirror is insurance, not a move).

"Least loaded" orders hosts by priced-bytes utilisation
(``assigned/budget``), tie-broken by pending fold cost — the autotune
profile store's measured per-chunk fold means when the caller supplies
them; the port has no profile store yet, so its fleet passes none, the
``None`` an unmeasured corpus prices at — then by host index, so
placement is deterministic for a given submission order.

Thread shape: one lock around all mutable state; ``place``/``release``
are safe from any thread (the fleet front and a listener edge may share
one router).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence


class RouterError(RuntimeError):
    """A request's priced bytes exceed every host's budget entry — it
    can never be placed, mirroring the single-server AdmissionError."""


@dataclass
class HostLoad:
    """One host's slice of the budget vector plus its live load."""

    budget_bytes: int
    assigned_bytes: int = 0
    assigned_requests: int = 0
    pending_cost_ms: float = 0.0
    peak_assigned_bytes: int = 0
    placed_total: int = 0
    #: supervision state (avenir_tpu_torch.net.fault); only "serving" hosts
    #: take new placements
    state: str = "serving"

    @property
    def available(self) -> bool:
        return self.state == "serving"

    def utilisation(self) -> float:
        return self.assigned_bytes / self.budget_bytes \
            if self.budget_bytes > 0 else float(self.assigned_requests)

    def fits(self, priced: int) -> bool:
        return self.assigned_bytes + priced <= self.budget_bytes


@dataclass
class Placement:
    """``place``'s receipt: hand it back to ``release`` so the router
    never depends on the caller recomputing the priced bytes."""

    host: int
    priced_bytes: int
    cost_ms: float = 0.0
    kind: str = "miss"   # "hit" | "spill" | "miss" | "pinned" | "hedge"
    key: Hashable = field(default=None, repr=False)


class AffinityRouter:
    """Sticky corpus->host placement against a per-host budget vector
    (module docstring has the policy)."""

    def __init__(self, budgets: Sequence[int]):
        if not budgets:
            raise ValueError("router needs at least one host budget")
        self.hosts: List[HostLoad] = [HostLoad(int(b)) for b in budgets]
        self._affinity: Dict[Hashable, int] = {}
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "placed": 0, "affinity_hits": 0, "affinity_misses": 0,
            "spills": 0, "held": 0, "failovers": 0, "hedges": 0,
        }

    # ------------------------------------------------------------ placing
    def place(self, key: Hashable, priced_bytes: int,
              cost_ms: Optional[float] = None,
              count_held: bool = True,
              exclude: Sequence[int] = ()) -> Optional[Placement]:
        """Place one request of `priced_bytes` with affinity `key`;
        None when every host is over its vector entry (caller holds or
        sheds). Raises :class:`RouterError` when the request exceeds
        every budget entry even on an idle fleet.

        ``count_held=False`` marks a RETRY of an arrival already
        counted held — pollers re-placing every 0.1s must not inflate
        the held stat 10x per second held (the same transition-not-
        re-check rule the server's admission_holds counter follows).

        ``exclude`` removes hosts from consideration for THIS placement
        (the requeue path excludes every host a request already failed
        on); an excluded sticky host keeps its mapping — exclusion is
        per-request, failover is per-host-state."""
        priced = max(int(priced_bytes), 0)
        cost = float(cost_ms) if cost_ms else 0.0
        banned = set(exclude)
        with self._lock:
            if not any(priced <= h.budget_bytes for h in self.hosts):
                raise RouterError(
                    f"request priced at {priced} bytes exceeds every "
                    f"host budget "
                    f"{[h.budget_bytes for h in self.hosts]}")
            sticky = self._affinity.get(key)
            if sticky is not None and not self.hosts[sticky].available:
                # the warm host is down/quarantined: drop the mapping —
                # the corpus re-places least-loaded and the recovered
                # host re-earns affinity through hits, never a map reset
                self._affinity.pop(key, None)
                self.stats["failovers"] += 1
                sticky = None
            if sticky is not None and sticky not in banned \
                    and self.hosts[sticky].fits(priced):
                self.stats["affinity_hits"] += 1
                return self._assign(sticky, priced, cost, "hit", key)
            candidates = [i for i, h in enumerate(self.hosts)
                          if h.available and h.fits(priced)
                          and i not in banned]
            if not candidates:
                if count_held:
                    self.stats["held"] += 1
                return None
            best = min(candidates, key=lambda i: (
                self.hosts[i].utilisation(),
                self.hosts[i].pending_cost_ms, i))
            if sticky is None:
                # unseen corpus: the chosen host becomes its warm home
                self._affinity[key] = best
                self.stats["affinity_misses"] += 1
                return self._assign(best, priced, cost, "miss", key)
            # sticky host over budget (or excluded for this request):
            # spill WITHOUT moving the sticky mapping — the corpus
            # returns to its warm host later
            self.stats["spills"] += 1
            return self._assign(best, priced, cost, "spill", key)

    def _assign(self, host: int, priced: int, cost: float, kind: str,
                key: Hashable) -> Placement:
        h = self.hosts[host]
        h.assigned_bytes += priced
        h.assigned_requests += 1
        h.pending_cost_ms += cost
        h.placed_total += 1
        h.peak_assigned_bytes = max(h.peak_assigned_bytes,
                                    h.assigned_bytes)
        self.stats["placed"] += 1
        return Placement(host, priced, cost, kind, key)

    def assign_to(self, host: int, key: Hashable, priced_bytes: int,
                  cost_ms: Optional[float] = None) -> Placement:
        """Pin one request to `host`, bypassing affinity (warmup
        traffic that must touch a specific process). Accounted against
        the budget vector like any placement; does not move sticky
        mappings."""
        with self._lock:
            return self._assign(host, max(int(priced_bytes), 0),
                                float(cost_ms) if cost_ms else 0.0,
                                "pinned", key)

    def place_mirror(self, key: Hashable, priced_bytes: int,
                     cost_ms: Optional[float] = None,
                     exclude: Sequence[int] = ()
                     ) -> Optional[Placement]:
        """The hedged-dispatch placement: least-loaded SERVING host
        outside `exclude` (the slow host and any host already carrying
        a copy) with budget headroom, charged against the vector like
        any placement, never touching the sticky map. None when no
        compatible host has headroom — a hedge is opportunistic
        insurance, never worth holding for."""
        priced = max(int(priced_bytes), 0)
        cost = float(cost_ms) if cost_ms else 0.0
        banned = set(exclude)
        with self._lock:
            candidates = [i for i, h in enumerate(self.hosts)
                          if h.available and h.fits(priced)
                          and i not in banned]
            if not candidates:
                return None
            best = min(candidates, key=lambda i: (
                self.hosts[i].utilisation(),
                self.hosts[i].pending_cost_ms, i))
            self.stats["hedges"] += 1
            return self._assign(best, priced, cost, "hedge", key)

    def set_host_state(self, host: int, state: str) -> None:
        """Record host `host`'s supervision state (``serving`` /
        ``restarting`` / ``stalled`` / ``quarantined``). Any state but
        ``serving`` removes the host from NEW placements; its sticky
        mappings fail over lazily on the next placement that needs
        them. Existing assignments keep their accounting until
        released — a dead host's priced bytes come back when its
        requests complete elsewhere."""
        with self._lock:
            self.hosts[host].state = str(state)

    def host_state(self, host: int) -> str:
        with self._lock:
            return self.hosts[host].state

    def release(self, placement: Placement) -> None:
        """The placed request finished (or was abandoned): return its
        budget slice and pending cost to the host."""
        with self._lock:
            h = self.hosts[placement.host]
            h.assigned_bytes -= placement.priced_bytes
            h.assigned_requests -= 1
            h.pending_cost_ms -= placement.cost_ms

    # --------------------------------------------------------------- view
    def snapshot(self) -> Dict:
        """The router's metrics row for the fleet ``metrics.json``:
        placement counters plus the per-host budget-vector occupancy
        (assigned/peak/budget bytes — the fleet-level generalization of
        the single server's ``inflight`` section)."""
        with self._lock:
            return {
                "stats": dict(self.stats),
                "affinity_keys": len(self._affinity),
                "hosts": [{
                    "host": i,
                    "state": h.state,
                    "budget_bytes": h.budget_bytes,
                    "assigned_bytes": h.assigned_bytes,
                    "assigned_requests": h.assigned_requests,
                    "peak_assigned_bytes": h.peak_assigned_bytes,
                    "pending_cost_ms": round(h.pending_cost_ms, 3),
                    "placed_total": h.placed_total,
                } for i, h in enumerate(self.hosts)],
            }

    def affinity_hit_rate(self) -> float:
        """Fraction of ROUTED placements that landed on their sticky
        warm host (the fleet tripwire's warm-locality gate). Pinned
        placements (``assign_to`` warmups) are not routing decisions
        and do not dilute the rate."""
        with self._lock:
            routed = (self.stats["affinity_hits"]
                      + self.stats["affinity_misses"]
                      + self.stats["spills"])
            return self.stats["affinity_hits"] / routed if routed else 0.0
