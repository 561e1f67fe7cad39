"""Fault tolerance for the job-server fleet: supervision, leases, hedging.

The port of `avenir_tpu/net/fault.py`, policy for policy (host code: no
device work of its own).

PR 12 built the fleet's happy path; this module is the back half the
ROADMAP's fleet item names: a host process dying mid-scan must not
strand the requests it had claimed, and a host running hot must not
hold the tail hostage. The license for all of it is the repo's
idempotency contract: every request is byte-identical by construction
(the merge-algebra and stream-invariance audits prove it) and every
result is nonce-namespaced and atomically renamed into place, so
RE-EXECUTION IS ALWAYS SAFE — a requeued or hedged duplicate of a
request that later finishes anyway is a harmless identical write,
never a conflict. That is exactly the framing of "Leveraging Coding
Techniques for Speeding up Distributed Computing" (arXiv:1802.03049):
when recomputation is free of coordination, redundancy beats waiting.

Four pieces, policy here, mechanism in :mod:`avenir_tpu_torch.net.fleet` and
:mod:`avenir_tpu_torch.net.router`:

- **Supervision** — the fleet front watches its host subprocesses: the
  exit code (a dead process is certain), the spool heartbeat (the
  host's ``metrics.json`` mtime — a ``serve --spool`` host refreshes
  it from its scheduler tick, so a frozen file means a wedged or
  stopped process), and ``/healthz`` for hosts that expose a listener
  (:func:`probe_healthz`). A dead host is restarted with capped
  exponential backoff; a host that dies repeatedly inside the
  quarantine window is QUARANTINED — dropped from placement until an
  operator reinstates it (:class:`RestartTracker` is the policy).
- **Request leases** — every placed request carries a lease file
  (host id, claim time, TTL, attempt trail) under the fleet root
  (:class:`LeaseStore`). The front renews leases while the assigned
  host stays healthy; when the host dies or stops heartbeating, the
  expired lease is swept and the request REQUEUED to a different
  healthy host (the failed ones excluded), capped at
  ``max_requeues`` so a request that kills every host it touches
  becomes an in-band failure row instead of a fleet-wide crash loop.
- **Hedged tail dispatch** — when one host's rolled-up queue-wait p99
  (its served histogram, or the age its oldest PENDING request has
  already accrued — a live lower bound of the same number) runs past
  ``hedge_multiple``× the fleet median, the front mirrors that host's
  queued requests onto the least-loaded compatible host and takes
  whichever result lands first (:func:`hot_hosts` is the decision).
  The mirror is charged against the budget vector like any placement.
- **Failover + reintegration** — the router drops a quarantined or
  dead host out of its sticky map (corpora re-place by the normal
  least-loaded rule, counted as ``failovers``); a recovered host
  re-earns affinity through hits, never through a map reset.

Everything is deterministic under test: the chaos harness
(``bench_scaling.fleet_fault_tripwire``) SIGKILLs a host mid-batch and
asserts zero lost and zero conflicting results, byte-identical to solo
twins; the hedging leg stalls a host and asserts the mirror fires and
the first result wins.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from avenir_tpu_torch.core.atomic import (publish_json, sched_point,
                                    sweep_stale_tmps, unique_tmp)


@dataclass
class FaultPolicy:
    """The fleet's fault-tolerance knobs, all in one place.

    ``supervise=False`` turns the whole layer off (the fleet behaves
    exactly as the PR-12 happy path: a dead host raises FleetError).
    The defaults are serving-scale; tests and the chaos harness dial
    them down for determinism."""

    supervise: bool = True
    #: supervisor tick granularity
    poll_interval_s: float = 0.25
    #: metrics.json older than this on a live process = stalled host
    heartbeat_timeout_s: float = 10.0
    #: restart backoff: base * 2^deaths, capped
    restart_backoff_base_s: float = 0.5
    restart_backoff_cap_s: float = 10.0
    #: deaths inside the window before the host is quarantined
    max_restarts: int = 3
    quarantine_window_s: float = 120.0
    #: lease TTL: how long a request may sit on an UNHEALTHY host
    #: before the front requeues it (healthy hosts renew their leases)
    lease_ttl_s: float = 10.0
    #: attempts before a request is failed in-band instead of requeued
    #: (a poison request must not crash-loop the whole fleet)
    max_requeues: int = 2
    #: how long a STRANDED request (attempt trail covers every host,
    #: none healthy) may wait for a restarting/stalled host to recover
    #: before it is abandoned in-band — the bound that keeps "never
    #: hang to the collect() timeout" true even when the only hosts
    #: left are permanently wedged (STALLED never restarts: only an
    #: exit code triggers respawn)
    stranded_patience_s: float = 60.0
    #: hedge when a host's queue-wait p99 (or oldest pending age) runs
    #: past this multiple of the fleet median
    hedge_multiple: float = 4.0
    #: the median is floored here so an all-idle fleet (median ~0) does
    #: not hedge every microscopic wobble
    hedge_floor_ms: float = 1000.0
    hedge: bool = True


#: host supervision states (the router mirrors these as availability)
SERVING = "serving"
RESTARTING = "restarting"
STALLED = "stalled"
QUARANTINED = "quarantined"
STOPPED = "stopped"

#: states a host can take NEW placements in
PLACEABLE_STATES = (SERVING,)


class RestartTracker:
    """Restart/quarantine policy for ONE host: record deaths, answer
    the backoff delay before the next respawn, and flip to quarantine
    when the host dies ``max_restarts`` times inside the window. Pure
    bookkeeping — callers pass ``now`` so tests drive the clock. The
    clock is ``time.monotonic()``: backoff and the quarantine window
    are in-process durations, and an NTP step of the wall clock must
    never stretch or collapse them (the fleet passes its monotonic
    tick time; only lease files persisted across processes carry wall
    timestamps)."""

    def __init__(self, policy: FaultPolicy):
        self.policy = policy
        self.deaths: List[float] = []

    def record_death(self, now: float) -> str:
        """Record one death at `now`; returns the next state —
        :data:`RESTARTING` (respawn after :meth:`backoff_s`) or
        :data:`QUARANTINED` (stop respawning)."""
        self.deaths.append(now)
        window = self.policy.quarantine_window_s
        recent = [t for t in self.deaths if now - t <= window]
        self.deaths = recent
        if len(recent) > self.policy.max_restarts:
            return QUARANTINED
        return RESTARTING

    def backoff_s(self) -> float:
        """Capped exponential backoff before the next respawn."""
        deaths = max(len(self.deaths), 1)
        return min(self.policy.restart_backoff_base_s
                   * (2.0 ** (deaths - 1)),
                   self.policy.restart_backoff_cap_s)

    @property
    def recent_deaths(self) -> int:
        """Deaths still inside the quarantine window — the number the
        quarantine verdict is judged on, NOT a lifetime restart count
        (the fleet tracks that itself)."""
        return len(self.deaths)


@dataclass
class Lease:
    """One placed request's claim record: who holds it, since when,
    for how long, and the attempt trail (hosts already tried — the
    requeue excludes them)."""

    name: str
    host: int
    claimed_at: float
    ttl_s: float
    attempts: int = 1
    hosts: List[int] = field(default_factory=list)
    nonce: Optional[str] = None

    def expired(self, now: float) -> bool:
        return now - self.claimed_at > self.ttl_s

    def to_dict(self) -> Dict:
        return {"name": self.name, "host": self.host,
                "claimed_at": self.claimed_at, "ttl_s": self.ttl_s,
                "attempts": self.attempts, "hosts": list(self.hosts),
                "nonce": self.nonce}

    @classmethod
    def from_dict(cls, obj: Dict) -> "Lease":
        return cls(name=str(obj["name"]), host=int(obj["host"]),
                   claimed_at=float(obj["claimed_at"]),
                   ttl_s=float(obj["ttl_s"]),
                   attempts=int(obj.get("attempts", 1)),
                   hosts=[int(h) for h in obj.get("hosts", [])],
                   nonce=obj.get("nonce"))


class LeaseStore:
    """Lease files under ``<fleet-root>/leases/`` — one JSON per
    outstanding request, atomically renamed in (the spool discipline),
    removed when the result is swept. On-disk so the claim trail
    survives a front restart and an operator can inspect exactly which
    host owes which request (``ls leases/`` is the debugging surface
    the chaos harness reads back)."""

    def __init__(self, root: str):
        self.dir = os.path.join(root, "leases")
        os.makedirs(self.dir, exist_ok=True)
        # startup GC: tmp files a hard-killed front left behind (the
        # age gate keeps a concurrent writer's live tmp safe)
        sweep_stale_tmps(self.dir)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def write(self, lease: Lease) -> str:
        return publish_json(lease.to_dict(), self.path(lease.name),
                            site="lease.write")

    def renew(self, lease: Lease, now: float) -> None:
        """Re-stamp the claim time — the sweep for a HEALTHY host."""
        sched_point("lease.renew")
        lease.claimed_at = now
        self.write(lease)

    def load(self, name: str) -> Optional[Lease]:
        try:
            with open(self.path(name)) as fh:
                return Lease.from_dict(json.load(fh))
        except (OSError, ValueError, KeyError):
            return None           # torn mid-rename or already swept

    def take(self, name: str) -> Optional[Lease]:
        """Atomically CLAIM a lease file for exclusive handling: rename
        it aside (exactly one of N racing sweepers wins the rename),
        parse the taken copy, remove the aside, return the Lease — or
        None when someone else took/removed it first or the copy is
        torn. This is the sweep's compare-and-swap: between a plain
        :meth:`load` and the requeue that acts on it, a healthy front
        may RENEW the lease, and destroying that renewal double-places
        the request. ``take`` moves the decision onto one atomic
        rename: whatever state the taken copy shows is the state the
        caller owns. The aside uses the protocol tmp naming so a
        crashed taker's leftover is GC'd by :func:`sweep_stale_tmps`
        and never read back as a live lease by :meth:`names`."""
        sched_point("lease.sweep")
        aside = unique_tmp(self.path(name))
        try:
            os.rename(self.path(name), aside)
        except OSError:
            return None            # lost the race (taken or removed)
        sched_point("lease.sweep")
        try:
            with open(aside) as fh:
                return Lease.from_dict(json.load(fh))
        except (OSError, ValueError, KeyError):
            return None           # torn by an external writer
        finally:
            try:
                os.remove(aside)
            except OSError:
                pass

    def remove(self, name: str) -> None:
        try:
            os.remove(self.path(name))
        except OSError:
            pass

    def names(self) -> List[str]:
        try:
            return sorted(n for n in os.listdir(self.dir)
                          if not n.endswith(".tmp"))
        except OSError:
            return []


def hot_hosts(p99_by_host: Dict[int, float],
              pending_age_ms: Dict[int, float],
              policy: FaultPolicy,
              healthy: Sequence[int]) -> List[int]:
    """The hedge decision: which healthy hosts' queued requests should
    be mirrored. A host is HOT when its effective queue-wait p99 — the
    max of its rolled-up served p99 and the age its oldest pending
    request has already accrued (a live lower bound of the p99 a
    stalled host will eventually report) — exceeds ``hedge_multiple``
    times the fleet median (floored at ``hedge_floor_ms``). Pure
    function: the chaos harness and tests drive it with synthetic
    numbers."""
    if not policy.hedge or len(healthy) < 2:
        return []
    effective = {
        h: max(p99_by_host.get(h, 0.0), pending_age_ms.get(h, 0.0))
        for h in healthy}
    ordered = sorted(effective.values())
    # LOWER middle for even counts: with 2 hosts the upper middle IS
    # the slow host, which would set its own threshold and never hedge
    median = ordered[(len(ordered) - 1) // 2]
    threshold = policy.hedge_multiple * max(median,
                                            policy.hedge_floor_ms)
    return [h for h, eff in sorted(effective.items())
            if eff > threshold]


def probe_healthz(address: str, timeout: float = 2.0) -> Optional[str]:
    """The ``/healthz`` status string of a listener-fronted host
    (``"serving"``, ``"draining"``, ``"quarantined"``, ``"restarting"``
    — the states :meth:`NetListener.set_health_state` surfaces), or
    None when the probe fails (connection refused = the process is
    gone; the exit-code check is the authority there)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"{address}/healthz",
                                    timeout=timeout) as resp:
            return json.load(resp).get("status")
    except urllib.error.HTTPError as exc:
        try:
            return json.loads(exc.read() or b"{}").get("status")
        except ValueError:
            return None
    except (OSError, ValueError):
        return None


def heartbeat_age_s(metrics_path: str, now: Optional[float] = None
                    ) -> Optional[float]:
    """Seconds since the host last refreshed its ``metrics.json``
    heartbeat, or None when the file does not exist yet (a host still
    booting has no heartbeat to be stale)."""
    try:
        mtime = os.stat(metrics_path).st_mtime
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime


class Supervisor:
    """The fleet's supervision thread: calls ``tick()`` every
    ``interval_s`` until stopped. The tick body lives on the Fleet
    (where the locks already are); this class owns only the thread's
    lifecycle — started by ``Fleet.start``, joined (bounded) by
    ``Fleet.stop`` — so the thread has one obvious owner. A tick that
    raises is recorded and the loop keeps going: supervision must outlive
    a transient filesystem hiccup."""

    def __init__(self, tick, interval_s: float):
        import threading

        self._tick = tick
        self._interval_s = float(interval_s)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._errors: List[str] = []
        self._thread = threading.Thread(target=self._loop,
                                        name="avenir-fleet-supervisor",
                                        daemon=True)

    def start(self) -> "Supervisor":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as exc:  # noqa: BLE001 — supervision survives
                with self._lock:
                    self._errors.append(f"{type(exc).__name__}: {exc}")
                    del self._errors[:-8]
            self._stop.wait(self._interval_s)

    def errors(self) -> List[str]:
        with self._lock:
            return list(self._errors)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
