"""A fleet of job-server processes behind one affinity router.

The port of `avenir_tpu/net/fleet.py`. Each host is a fresh interpreter,
``python -m avenir_tpu_torch serve --spool ... --device D`` (never a
fork: the coordinator may hold a CUDA context), with the repo root on
its ``PYTHONPATH``; ``Fleet(device=...)`` names D (default cuda, the
hosts sharing the card). ``Fleet(profile_dir=...)`` shares one autotune
profile store (``tune/``) across the hosts (each gets ``--autotune-dir``)
and the front: the front prices with the same tuned pricer the hosts
admit with, and weights placement by the measured fold cost.

One resident JobServer amortizes scans/compiles across tenants but is
still one Python process on one core-set; the fleet layer is the
scale-out: N ``serve --spool`` subprocesses (same host here — the spool
transport is already host-agnostic, so a host list later is a mount
away), each with its own spool, byte budget and warm state, fed by an
:class:`~avenir_tpu_torch.net.router.AffinityRouter` that keeps a corpus
hitting the process whose WarmStore already pins its encoded blocks and
checkpoints, against a per-host priced-bytes budget vector.

The front half runs in the CALLER's process:

- :class:`Fleet` — spawn/stop the server processes, ``submit`` request
  objects (priced by ``price_request_bytes``, placed by the router,
  written atomically into the placed host's spool ``in/``),
  ``collect`` result rows from the per-host ``out/`` dirs, and roll
  the per-host ``metrics.json`` snapshots into ONE fleet view through
  the additive ``LatencyHistogram.merge`` algebra
  (``obs.report.merge_snapshots``) with the router's placement stats
  attached.
- :func:`fleet_main` — ``python -m avenir_tpu_torch fleet``: a fleet-level
  spool (requests into ``<root>/in/``, results out of ``<root>/out/``)
  so tenants address ONE directory and the router fans out behind it.
  SIGTERM/SIGINT drain gracefully: stop claiming, finish in-flight,
  final merged metrics.json, exit 0.

Placement cost: when a profile store (``avenir_tpu_torch.tune``) is
configured, the router's tie-break consults the measured per-chunk fold
cost of each (job, corpus): a corpus whose folds are measured expensive
counts for more pending load than its bytes alone say. Without one, or
without a measurement, placement is by bytes alone.

Fault tolerance (avenir-fault, :mod:`avenir_tpu_torch.net.fault`): a
supervisor thread watches the host processes (exit code + spool
heartbeat = the host's ``metrics.json`` mtime), restarts a dead host
with capped exponential backoff and quarantines one that dies
repeatedly; every placed request carries a LEASE file under
``<root>/leases/`` that the front renews while the host stays healthy
and sweeps when it does not — the request requeues to a different
healthy host (failed ones excluded), and because results are
nonce-namespaced, byte-identical by construction and atomically
renamed into place, a slow original finishing late is a harmless
duplicate write, never a conflict. When a healthy host's queue-wait
tail runs hot past the fleet median, its queued requests are MIRRORED
to the least-loaded compatible host (hedged dispatch, charged against
the budget vector) and the first result to land wins. All of it is
policy-driven by :class:`~avenir_tpu_torch.net.fault.FaultPolicy` and gated
by ``bench_scaling.fleet_fault_tripwire``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.core.atomic import publish_json
from avenir_tpu_torch.net import fault
from avenir_tpu_torch.net.fault import (FaultPolicy, Lease, LeaseStore,
                                        RestartTracker, Supervisor)
from avenir_tpu_torch.net.router import AffinityRouter, Placement
from avenir_tpu_torch.server.spool import (nonce_result_name,
                                           request_from_json, spool_dirs)
from avenir_tpu_torch.utils.devices import DeviceLike

#: fleet front poll granularity (seconds)
_POLL_SECS = 0.1
#: price-memo freshness: long enough to amortize an arrival burst over
#: a hot corpus, short enough that a growing refresh corpus re-prices
_PRICE_MEMO_TTL_SECS = 30.0
#: price-memo size bound for resident fronts
_PRICE_MEMO_MAX = 4096


def _pkg_parent() -> str:
    import avenir_tpu_torch

    return os.path.dirname(os.path.dirname(
        os.path.abspath(avenir_tpu_torch.__file__)))


def affinity_key(request) -> Tuple:
    """The router's sticky key: the corpus identity (mode + absolute
    input paths) — the component of ``server.compat_key`` warm state
    actually keys on. Everything else (job, conf) may vary per request
    without moving the corpus off its warm host."""
    return (request.mode,
            tuple(os.path.abspath(p) for p in request.inputs))


def score_affinity_key(kind: str, model: str) -> Tuple:
    """The QUERY path's sticky key: the model identity. A host that
    scored an artifact holds it loaded in its ModelCache (on its
    device), so repeat scores are cheapest exactly
    there — the same warmth argument ``affinity_key`` makes for
    corpora, at model granularity. Request row / round / conf may vary
    without moving the model off its warm host (they are excluded from
    ``core.keys.model_tuple`` for the same reason)."""
    return ("score", kind, os.path.abspath(model))


class ScoreFront:
    """Model-affinity fan-out for ``POST /score`` across listener
    URLs: every score places through an :class:`AffinityRouter` keyed
    by :func:`score_affinity_key`, so one artifact's queries pin to
    one host's warm ModelCache while distinct models spread across the
    fleet. One persistent HTTP/1.1 connection per (thread, host) —
    the keep-alive socket is what keeps per-score transport cost below
    the score itself."""

    def __init__(self, urls: Sequence[str],
                 budgets: Optional[Sequence[int]] = None):
        if not urls:
            raise ValueError("score front needs at least one listener")
        self.urls = [u.rstrip("/") for u in urls]
        self.router = AffinityRouter(
            list(budgets) if budgets else [1 << 30] * len(self.urls))
        self._local = threading.local()
        # every connection ever handed out, across ALL threads —
        # close() runs on one thread but must reach the keep-alive
        # sockets the other scoring threads opened
        self._conns_lock = threading.Lock()
        self._all_conns: List = []

    def _conn(self, host: int, fresh: bool = False):
        import http.client
        from urllib.parse import urlsplit as _split
        conns = getattr(self._local, "conns", None)
        if conns is None:
            conns = self._local.conns = {}
        conn = conns.get(host)
        if fresh and conn is not None:
            conn.close()
            with self._conns_lock:
                if conn in self._all_conns:
                    self._all_conns.remove(conn)
            conn = None
        if conn is None:
            conn = conns[host] = http.client.HTTPConnection(
                _split(self.urls[host]).netloc, timeout=120)
            with self._conns_lock:
                self._all_conns.append(conn)
        return conn

    @staticmethod
    def _decode(resp) -> Dict:
        """The response body as a dict; a torn/non-JSON body (a host
        dying mid-write) decodes to {} so the status check below turns
        it into a FleetError instead of a raw traceback."""
        try:
            payload = json.loads(resp.read())
        except (OSError, ValueError):
            return {}
        return payload if isinstance(payload, dict) else {}

    def score(self, kind: str, model: str, row: str,
              conf: Optional[Dict[str, str]] = None,
              action: str = "score", req_id: str = "",
              timeout: float = 30.0) -> Dict:
        """Route one score (or reward append) to the model's warm
        host; returns the decoded response body. Raises FleetError on
        a non-200 answer (the body's error text attached)."""
        import http.client
        if action == "reward" and not req_id:
            # a reward append is only retry-safe when the journal can
            # nonce-dedupe it: the fresh-connection retry below can
            # land after the host already committed the first send, so
            # an empty req_id would double-apply the observation. Mint
            # one; both sends carry the same body, so the second
            # dedupes server-side.
            req_id = uuid.uuid4().hex
        body = json.dumps({"kind": kind, "model": model, "row": row,
                           "conf": conf or {}, "action": action,
                           "req_id": req_id}).encode()
        placement = self.router.place(score_affinity_key(kind, model),
                                      priced_bytes=len(body))
        if placement is None:
            raise FleetError("no score host has budget headroom")
        try:
            target = f"/score?timeout={timeout}"
            headers = {"Content-Type": "application/json"}
            conn = self._conn(placement.host)
            try:
                conn.request("POST", target, body, headers)
                resp = conn.getresponse()
                payload = self._decode(resp)
            except (OSError, http.client.HTTPException):
                # the host may have idle-closed the persistent socket;
                # one fresh-connection retry, then the error is real
                conn = self._conn(placement.host, fresh=True)
                conn.request("POST", target, body, headers)
                resp = conn.getresponse()
                payload = self._decode(resp)
            if resp.status != 200:
                raise FleetError(
                    f"score host {placement.host} answered "
                    f"{resp.status}: {payload.get('error')}")
            return payload
        finally:
            self.router.release(placement)

    def snapshot(self) -> Dict:
        return self.router.snapshot()

    def close(self) -> None:
        with self._conns_lock:
            conns, self._all_conns = self._all_conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        local = getattr(self._local, "conns", None)
        if local:
            local.clear()


class FleetError(RuntimeError):
    """A fleet host died or refused to start."""


class _Copy:
    """One spooled COPY of an outstanding request: the original
    placement, a requeue, or a hedged mirror — each with its own spool
    name, out path and budget accounting."""

    __slots__ = ("placement", "name", "out_path")

    def __init__(self, placement: Placement, name: str, out_path: str):
        self.placement = placement
        self.name = name
        self.out_path = out_path


class _Outstanding:
    """One submitted request the front is waiting on. ``copies`` holds
    every spooled copy (original + requeues + mirrors); the first
    result to land on ANY copy's out path wins and releases all of
    them — re-execution is safe by the idempotency contract, so a late
    duplicate is an identical write, never a conflict.

    ``submitted_at`` and ``stranded_at`` are ``time.monotonic()``
    stamps: they drive in-process age/patience arithmetic (the hedge's
    pending-age clock, the stranded-patience bound), which an NTP step
    of the wall clock must never stretch or collapse. Only the lease's
    ``claimed_at`` — persisted to disk and compared against file
    mtimes across processes — stays wall-clock."""

    __slots__ = ("copies", "obj", "submitted_at", "lease", "mirrored",
                 "stranded_at")

    def __init__(self, copy: _Copy, obj: Dict, submitted_at: float,
                 lease: Lease):
        self.copies = [copy]
        self.obj = obj
        self.submitted_at = submitted_at
        self.lease = lease
        self.mirrored = False
        #: when the request first became STRANDED (trail covers every
        #: host, none healthy) — the patience clock _rescue_stranded
        #: abandons on; None while the request has a way forward
        self.stranded_at: Optional[float] = None


class Fleet:
    """N job-server processes + the affinity front (module docstring).

    Construct, ``start()``, ``submit()`` request objects (the spool
    JSON schema), ``collect()`` rows, ``stop()``. The budget vector is
    one ``budget_mb`` entry per host; ``device`` is every host's
    ``--device`` (default cuda). ``profile_dir`` opts placement into
    fold-cost weighting and is forwarded to every host as its autotune
    store.

    Single-writer: one Fleet coordinates one spool tree — request
    names come from a per-instance sequence and every ``in/`` spool
    write is this process's alone (hosts only ever RENAME requests out
    and publish results to ``out/``). The one cross-process seam, the
    lease trail, is serialized through ``LeaseStore.take``'s
    rename-aside CAS (the lease.sweep site)."""

    def __init__(self, root: str, hosts: int = 2,
                 budget_mb: float = 3072.0, workers: int = 1,
                 warm_budget_mb: float = 256.0,
                 metrics_interval_s: float = 0.5,
                 profile_dir: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None,
                 pin_cores: Optional[Sequence[int]] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 listen_addresses: Optional[Dict[int, str]] = None,
                 device: DeviceLike = None):
        """``pin_cores``: pin host i to CPU ``pin_cores[i % len]``
        (Linux ``sched_setaffinity``; ignored where unsupported). On a
        shared box an UNPINNED single process borrows every core
        through torch's intra-op threads, so a same-box fleet-vs-one
        comparison measures nothing — pinning one core per host is
        what makes a single machine a faithful proxy for N hosts
        (``bench_scaling.fleet_tripwire`` relies on it).

        ``listen_addresses``: base URL per host index (e.g.
        ``{0: "http://127.0.0.1:8191"}``) for hosts that run a
        ``--listen`` edge — the supervisor then heartbeats those hosts
        through ``fault.probe_healthz`` (/healthz) instead of the
        metrics.json mtime: a listener answering "serving"/"draining"
        is live; a refused probe or a quarantined/restarting overlay
        marks the host stalled and out of placement. The exit-code
        check stays authoritative for death either way."""
        if hosts < 1:
            raise ValueError("fleet needs at least one host")
        #: every host's --device: the coordinator opens no device of
        #: its own, so a missing card fails in the hosts' boot
        self.device = "cuda" if device is None else str(device)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.host_dirs = [os.path.join(self.root, f"host{i}")
                          for i in range(hosts)]
        self.budget_bytes = int(budget_mb * (1 << 20))
        self.router = AffinityRouter([self.budget_bytes] * hosts)
        self.workers = int(workers)
        self.warm_budget_mb = float(warm_budget_mb)
        self.metrics_interval_s = float(metrics_interval_s)
        self.profile_dir = profile_dir
        self._env = env
        self.pin_cores = list(pin_cores) if pin_cores else None
        self.fault = fault_policy or FaultPolicy()
        self.listen_addresses = dict(listen_addresses or {})
        #: per-host (stamped_at, hb_live) memo of the last /healthz
        #: probe: the probe is a blocking HTTP round trip (a WEDGED
        #: listener holds the connection to the timeout — the exact
        #: state it exists to detect), so it must not run every tick or
        #: stalled hosts would stall the whole supervisor loop past the
        #: lease-renewal window; probing at half the heartbeat budget
        #: keeps detection latency inside the same bound the mtime
        #: heartbeat has
        self._probe_memo: Dict[int, Tuple[float, bool]] = {}
        self._procs: List[Optional[subprocess.Popen]] = [None] * hosts
        self._logs: List[str] = [
            os.path.join(d, "server.log") for d in self.host_dirs]
        self._lock = threading.Lock()
        self._seq = 0
        self._outstanding: Dict[str, _Outstanding] = {}
        # ---- fault-tolerance state (avenir_tpu_torch.net.fault) ----
        self._leases = LeaseStore(self.root)
        self._trackers = [RestartTracker(self.fault)
                          for _ in range(hosts)]
        self._host_state = [fault.SERVING] * hosts
        self._restart_at: List[Optional[float]] = [None] * hosts
        #: wall-clock spawn stamp — compared against lease claimed_at
        #: (a persisted wall timestamp) for the incarnation check
        self._spawned_at = [0.0] * hosts
        #: monotonic spawn stamp — drives boot-grace and heartbeat-age
        #: fallbacks (in-process durations; immune to NTP steps)
        self._spawned_mono = [0.0] * hosts
        self._supervisor: Optional[Supervisor] = None
        # a heartbeat bound tighter than the metrics refresh would mark
        # every host stalled between writes
        self._hb_timeout = max(self.fault.heartbeat_timeout_s,
                               4.0 * self.metrics_interval_s)
        self._fault_stats = {"requeues": 0, "respools": 0,
                             "restarts": 0, "quarantined": 0,
                             "abandoned": 0}
        self._restart_counts = [0] * hosts
        #: finished rows swept off disk but not yet collect()ed — the
        #: submit loop's capacity sweep must never lose a row a later
        #: named collect() will ask for
        self._collected: Dict[str, Dict] = {}
        # pricing memo: corpus_stats head-samples the corpus per call,
        # so an open-loop front pricing hundreds of arrivals over a few
        # hot corpora would pay the sample per request; identical
        # (job, conf, corpus, mode) submissions price once, and the
        # fold cost rides along. Entries expire (a
        # refresh corpus GROWS between rounds — a price from its
        # smallest snapshot must not undercount the vector forever)
        # and the dict is bounded for resident fronts. Value:
        # (priced_bytes, cost_ms, stamped_at).
        self._price_memo: Dict[Tuple, Tuple] = {}

    # ------------------------------------------------------------ lifecycle
    def _host_env(self) -> Dict[str, str]:
        env = dict(os.environ if self._env is None else self._env)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_pkg_parent(), env.get("PYTHONPATH")) if p)
        return env

    def _spawn_host(self, i: int) -> None:
        """(Re)spawn host `i`'s ``serve --spool`` process — shared by
        ``start()`` and the supervisor's restart path, so a restarted
        host comes back with the identical config (budget, state root,
        core pin) it died with."""
        host_dir = self.host_dirs[i]
        os.makedirs(host_dir, exist_ok=True)
        cmd = [sys.executable, "-m", "avenir_tpu_torch", "serve",
               "--spool", host_dir,
               "--workers", str(self.workers),
               "--budget-mb", str(self.budget_bytes / (1 << 20)),
               "--warm-budget-mb", str(self.warm_budget_mb),
               "--state-root", os.path.join(host_dir, "state"),
               "--metrics-interval", str(self.metrics_interval_s),
               "--device", self.device]
        if self.profile_dir:
            # the hosts share one profile store: a fold cost measured on
            # any host informs placement for all of them
            cmd += ["--autotune-dir", self.profile_dir]
        preexec = None
        if self.pin_cores and hasattr(os, "sched_setaffinity"):
            core = self.pin_cores[i % len(self.pin_cores)]
            preexec = (lambda c=core:
                       os.sched_setaffinity(0, {c}))
        with open(self._logs[i], "ab") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                    env=self._host_env(),
                                    cwd=_pkg_parent(),
                                    preexec_fn=preexec)
        with self._lock:
            self._procs[i] = proc
            self._spawned_at[i] = time.time()
            self._spawned_mono[i] = time.monotonic()

    def start(self, timeout: float = 60.0) -> "Fleet":
        for i in range(len(self.host_dirs)):
            self._spawn_host(i)
        deadline = time.perf_counter() + timeout
        for i, host_dir in enumerate(self.host_dirs):
            in_dir = os.path.join(host_dir, "in")
            while not os.path.isdir(in_dir):
                # strict at boot: a host that cannot START is a config
                # error the caller must see, not a runtime fault for
                # the supervisor to mask by restarting forever
                self._check_alive(strict=True)
                if time.perf_counter() > deadline:
                    raise FleetError(
                        f"host {i} did not open its spool within "
                        f"{timeout}s (log: {self._logs[i]})")
                time.sleep(_POLL_SECS)
        if self.fault.supervise:
            self._supervisor = Supervisor(
                self._fault_tick, self.fault.poll_interval_s).start()
        return self

    def _check_alive(self, strict: bool = False) -> None:
        """With supervision on, a dead host is the SUPERVISOR's problem
        (restart/quarantine) and callers only fail when every host is
        quarantined — nothing left to requeue to. ``strict`` (boot, or
        supervision off) keeps the PR-12 behavior: any dead host
        raises."""
        if self.fault.supervise and not strict:
            with self._lock:
                states = list(self._host_state)
            if all(s == fault.QUARANTINED for s in states):
                raise FleetError(
                    "every fleet host is quarantined (died "
                    f"> {self.fault.max_restarts} times inside "
                    f"{self.fault.quarantine_window_s}s); logs: "
                    f"{self._logs}")
            return
        for i, proc in enumerate(self._procs):
            rc = proc.poll() if proc is not None else None
            if rc is not None and rc != 0:
                tail = _tail(self._logs[i])
                raise FleetError(
                    f"fleet host {i} exited rc={rc}; log tail:\n{tail}")

    def host_pid(self, i: int) -> Optional[int]:
        """Host `i`'s live process id (None while dead/quarantined) —
        the chaos harness's SIGKILL target."""
        with self._lock:
            proc = self._procs[i]
        return proc.pid if proc is not None else None

    def host_state(self, i: int) -> str:
        with self._lock:
            return self._host_state[i]

    def reinstate(self, i: int) -> None:
        """Operator reintegration of a quarantined host: clear its
        death record and respawn it. The sticky map is NOT restored —
        the host re-earns affinity through fresh hits, so a flapping
        host cannot yank corpora back and forth."""
        with self._lock:
            if self._host_state[i] != fault.QUARANTINED:
                raise FleetError(
                    f"host {i} is {self._host_state[i]}, not "
                    f"quarantined")
            self._trackers[i] = RestartTracker(self.fault)
        self._spawn_host(i)
        with self._lock:
            self._restart_counts[i] += 1
        self._set_host_state(i, fault.SERVING)

    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ submitting
    def price(self, obj: Dict) -> Tuple[object, int, Optional[float]]:
        """(request, priced bytes, fold cost ms) of one request object
        — the placement inputs. Pricing uses the same oracle the hosts
        admit with; the fold cost comes from the shared profile store
        when one is configured."""
        req = request_from_json(obj)
        memo_key = (req.job, req.mode,
                    tuple(os.path.abspath(p) for p in req.inputs),
                    json.dumps(req.conf, sort_keys=True)
                    if isinstance(req.conf, dict) else str(req.conf))
        now = time.perf_counter()
        with self._lock:
            hit = self._price_memo.get(memo_key)
            if hit is not None and now - hit[2] < _PRICE_MEMO_TTL_SECS:
                return req, hit[0], hit[1]
        priced = self._pricer()(req)
        cost = None
        if self.profile_dir:
            # the fold cost rides the same memo: a profile read per
            # arrival would pay a disk read per request on the hot-corpus
            # path the memo exists for
            from avenir_tpu_torch import tune

            cost = tune.placement_cost_ms(self.profile_dir, req.job,
                                          req.conf, req.inputs)
        with self._lock:
            if len(self._price_memo) >= _PRICE_MEMO_MAX:
                self._price_memo = {
                    k: v for k, v in self._price_memo.items()
                    if now - v[2] < _PRICE_MEMO_TTL_SECS}
                if len(self._price_memo) >= _PRICE_MEMO_MAX:
                    self._price_memo.clear()
            self._price_memo[memo_key] = (priced, cost, now)
        return req, priced, cost

    def _pricer(self):
        """The front's pricing oracle — the SAME one the hosts admit
        with: the residual-corrected tuned pricer when a profile store is
        configured (the hosts get it through --autotune-dir), the bare
        footprint model otherwise. A front that priced lower than a host
        would place work the host then fast-fails."""
        fn = getattr(self, "_pricer_fn", None)
        if fn is not None:
            return fn
        from avenir_tpu_torch.server.jobserver import (DEFAULT_RESERVE_BYTES,
                                                       price_request_bytes)

        if self.profile_dir:
            from avenir_tpu_torch import tune

            base = tune.make_tuned_pricer(self.profile_dir,
                                          base=price_request_bytes)
        else:
            base = price_request_bytes
        self._pricer_fn = fn = \
            lambda req: int(base([req], DEFAULT_RESERVE_BYTES))
        return fn

    def submit(self, obj: Dict, block: bool = True,
               timeout: float = 600.0,
               count_held: bool = True) -> Optional[str]:
        """Route one request object to a host spool; returns the fleet
        request name to ``collect`` on, or None when every host is over
        its budget-vector entry and ``block`` is False. Blocking waits
        for a host to free capacity — the fleet-front analog of the
        single server's admission hold. ``count_held=False`` marks a
        caller-level retry of an arrival already counted held."""
        req, priced, cost = self.price(obj)
        key = affinity_key(req)
        deadline = time.perf_counter() + timeout
        while True:
            placement = self.router.place(key, priced, cost,
                                          count_held=count_held)
            if placement is not None:
                break
            count_held = False        # this arrival is counted now
            # capacity frees only when finished requests are swept off
            # disk — a blocking submit must sweep ITSELF or a saturated
            # single-threaded front would spin the full timeout while
            # every host sits idle with its results already written
            self._sweep()
            if not block:
                return None
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"no host freed budget for a {priced}-byte request "
                    f"within {timeout}s")
            self._check_alive()
            time.sleep(_POLL_SECS)
        return self._spool_to(placement, obj)

    def submit_to(self, host: int, obj: Dict) -> str:
        """Pin one request to `host`, bypassing the router (warmup
        traffic that must touch a SPECIFIC process). Accounted against
        the budget vector like any placement."""
        req, priced, cost = self.price(obj)
        placement = self.router.assign_to(host, affinity_key(req),
                                          priced, cost)
        return self._spool_to(placement, obj)

    def _next_name(self) -> str:
        with self._lock:
            self._seq += 1
            return f"r{self._seq:06d}.json"

    def _write_copy(self, placement: Placement, name: str,
                    obj: Dict) -> _Copy:
        """Spool one copy of `obj` into its placed host's ``in/``
        (atomic tmp+rename) and return the copy record."""
        host_dir = self.host_dirs[placement.host]
        out_name = nonce_result_name(name, obj.get("nonce"))
        out_path = os.path.join(host_dir, "out", out_name)
        publish_json(obj, os.path.join(host_dir, "in", name))
        return _Copy(placement, name, out_path)

    def _spool_to(self, placement: Placement, obj: Dict) -> str:
        name = self._next_name()
        now = time.time()
        lease = Lease(name=name, host=placement.host, claimed_at=now,
                      ttl_s=self.fault.lease_ttl_s,
                      hosts=[placement.host], nonce=obj.get("nonce"))
        # lease BEFORE the spool write: the supervisor must never see a
        # claimed request it has no lease record for
        self._leases.write(lease)
        copy = self._write_copy(placement, name, obj)
        with self._lock:
            self._outstanding[name] = _Outstanding(
                copy, obj, time.monotonic(), lease)
        return name

    # ------------------------------------------------------------ collecting
    def ready(self) -> List[str]:
        """Names of submitted requests whose result row is available
        (already swept, or on disk) — what a non-blocking front sweep
        collects."""
        with self._lock:
            entries = [(n, [c.out_path for c in e.copies])
                       for n, e in self._outstanding.items()]
            banked = list(self._collected)
        return banked + [n for n, paths in entries
                         if any(os.path.exists(p) for p in paths)]

    def _sweep(self) -> int:
        """Move every finished request's row off disk into the
        collected bank and release its router accounting — the FIRST
        copy (original, requeue or mirror) whose row landed wins; the
        others' late identical writes are ignored. Returns how many
        were swept. Idempotent and safe to call from the submit loop,
        the collect loop and the supervisor tick — a banked row waits
        for its named ``collect``."""
        with self._lock:
            entries = [(n, e, list(e.copies))
                       for n, e in self._outstanding.items()]
        swept = 0
        for name, entry, copies in entries:
            row = None
            for copy in copies:
                if not os.path.exists(copy.out_path):
                    continue
                # the publish is atomic, but this reader still races
                # deletion (another sweeper collecting the same name):
                # a vanished/torn row is absent, never a crash
                try:
                    with open(copy.out_path) as fh:
                        row = json.load(fh)
                except (OSError, ValueError):
                    continue
                break                     # first-write-wins
            if row is None:
                continue
            with self._lock:
                if self._outstanding.pop(name, None) is None:
                    continue              # raced another sweeper
                self._collected[name] = row
                copies = list(entry.copies)
            _release_placements(self.router, copies)
            self._leases.remove(name)
            swept += 1
        return swept

    def collect(self, names: Optional[Sequence[str]] = None,
                timeout: float = 600.0) -> Dict[str, Dict]:
        """Block until every named request (default: all submitted,
        uncollected) has a result row; returns {name: row}. Router
        accounting is released as each row is swept off disk."""
        with self._lock:
            wanted = list(names) if names is not None else \
                list(self._outstanding) + list(self._collected)
            unknown = [n for n in wanted
                       if n not in self._outstanding
                       and n not in self._collected]
        if unknown:
            raise KeyError(f"unknown fleet request(s) {unknown}")
        rows: Dict[str, Dict] = {}
        deadline = time.perf_counter() + timeout
        while True:
            self._sweep()
            with self._lock:
                for name in wanted:
                    if name not in rows and name in self._collected:
                        rows[name] = self._collected.pop(name)
            if len(rows) == len(wanted):
                return rows
            self._check_alive()
            if time.perf_counter() > deadline:
                missing = [n for n in wanted if n not in rows]
                raise TimeoutError(
                    f"fleet results {missing} not served within "
                    f"{timeout}s")
            time.sleep(_POLL_SECS)

    # -------------------------------------------------------- fault tolerance
    def _fault_tick(self) -> None:
        """One supervisor pass (fault.Supervisor drives this every
        ``poll_interval_s``): sweep finished results, watch the host
        processes, sweep/renew leases, hedge the hot tail. Two clocks:
        ``wall`` stamps/compares the persisted lease records (cross-
        process file timestamps), ``mono`` drives every in-process
        duration (backoff, boot grace, patience, hedge age)."""
        wall = time.time()
        mono = time.monotonic()
        self._sweep()
        self._supervise_hosts(wall, mono)
        self._sweep_leases(wall, mono)
        if self.fault.hedge:
            self._hedge(mono)

    def _set_host_state(self, i: int, state: str) -> None:
        with self._lock:
            self._host_state[i] = state
        self.router.set_host_state(i, state)

    def _supervise_hosts(self, now: float,
                         mono: Optional[float] = None) -> None:
        """Host supervision for one tick. ``now`` is wall-clock (only
        the heartbeat mtime comparison needs it); ``mono`` drives
        death/backoff/boot-grace arithmetic — restart scheduling must
        not stretch or collapse under an NTP step."""
        mono = time.monotonic() if mono is None else mono
        for i in range(len(self.host_dirs)):
            with self._lock:
                state = self._host_state[i]
                proc = self._procs[i]
                restart_at = self._restart_at[i]
                spawned_mono = self._spawned_mono[i]
            if state in (fault.QUARANTINED, fault.STOPPED):
                continue
            rc = proc.poll() if proc is not None else None
            if proc is not None and rc is not None:
                # death is certain (exit code in hand): requeue its
                # leases NOW — waiting out the TTL buys nothing
                verdict = self._trackers[i].record_death(mono)
                with self._lock:
                    self._procs[i] = None
                if verdict == fault.QUARANTINED:
                    self._set_host_state(i, fault.QUARANTINED)
                    with self._lock:
                        self._fault_stats["quarantined"] += 1
                else:
                    self._set_host_state(i, fault.RESTARTING)
                    with self._lock:
                        self._restart_at[i] = \
                            mono + self._trackers[i].backoff_s()
                continue
            if state == fault.RESTARTING:
                if proc is None and restart_at is not None \
                        and mono >= restart_at:
                    self._spawn_host(i)
                    with self._lock:
                        self._fault_stats["restarts"] += 1
                        self._restart_counts[i] += 1
                        self._restart_at[i] = None
                elif proc is not None:
                    # booted when the spool is back: placements resume;
                    # affinity is re-EARNED through hits, never reset
                    if os.path.isdir(os.path.join(self.host_dirs[i],
                                                  "in")):
                        self._set_host_state(i, fault.SERVING)
                continue
            # alive host: a listener-fronted host heartbeats through
            # /healthz (fault.probe_healthz — "serving"/"draining"
            # answers are live, a refused probe or a quarantined/
            # restarting overlay is not); spool-only hosts heartbeat
            # through the metrics.json mtime. Either way a live
            # process that stopped answering is wedged or stopped
            # (SIGSTOP, hard IO stall) and must not take new
            # placements
            booting = mono - spawned_mono <= self._hb_timeout
            addr = self.listen_addresses.get(i)
            if addr is not None:
                hb_live = self._probe_host(i, addr, mono)
                if state == fault.SERVING and not hb_live \
                        and not booting:
                    self._set_host_state(i, fault.STALLED)
                elif state == fault.STALLED and hb_live:
                    self._set_host_state(i, fault.SERVING)
                continue
            age = fault.heartbeat_age_s(
                os.path.join(self.host_dirs[i], "metrics.json"), now)
            if age is None:
                age = mono - spawned_mono
            if state == fault.SERVING and age > self._hb_timeout \
                    and not booting:
                self._set_host_state(i, fault.STALLED)
            elif state == fault.STALLED and age <= self._hb_timeout:
                self._set_host_state(i, fault.SERVING)

    def _probe_host(self, i: int, addr: str, mono: float) -> bool:
        """Memoized /healthz liveness of a listener-fronted host:
        re-probes at most every hb_timeout/2 with a timeout bounded
        well under the heartbeat budget, so N wedged listeners can
        never stall the supervisor tick past the lease-renewal
        window. The memo ages on the monotonic clock — a wall step
        must not force (or starve) a re-probe."""
        hit = self._probe_memo.get(i)
        if hit is not None and mono - hit[0] < self._hb_timeout / 2.0:
            return hit[1]
        timeout = min(2.0, max(self._hb_timeout / 4.0, 0.25))
        status = fault.probe_healthz(addr, timeout=timeout)
        hb_live = status in ("serving", "draining")
        self._probe_memo[i] = (mono, hb_live)
        return hb_live

    @staticmethod
    def _copy_on(entry: _Outstanding, host: int) -> _Copy:
        """The entry's newest copy spooled AT `host` (the lease host's
        own spool file — requeues and mirrors live elsewhere)."""
        for copy in reversed(entry.copies):
            if copy.placement.host == host:
                return copy
        return entry.copies[-1]

    def _sweep_leases(self, now: float,
                      mono: Optional[float] = None) -> None:
        """Renew the leases of requests sitting on healthy hosts;
        requeue the ones whose host died (immediately) or went
        stale/stalled past the lease TTL. A lease predating its host's
        CURRENT incarnation is stranded even though the host looks
        healthy: a claim taken by the dead process sits in its old
        ``work/`` dir, which a restarted host never re-adopts — those
        requeue too (or re-spool to the restarted host when no other
        host can take them).

        ``now`` is wall-clock — lease claimed_at stamps and the
        incarnation comparison are persisted wall timestamps; ``mono``
        feeds the stranded-patience clock and the hedge's pending-age
        restart (in-process durations)."""
        mono = time.monotonic() if mono is None else mono
        with self._lock:
            entries = list(self._outstanding.items())
        for name, entry in entries:
            lease = entry.lease
            with self._lock:
                state = self._host_state[lease.host]
                dead = self._procs[lease.host] is None
                spawned_at = self._spawned_at[lease.host]
            healthy = state == fault.SERVING and not dead
            if healthy and lease.claimed_at < spawned_at:
                # pre-restart lease: if the spool file still sits in
                # in/, the new incarnation will claim it normally —
                # restamp and move on; otherwise the old process died
                # holding the claim and the request must move
                copy = self._copy_on(entry, lease.host)
                in_path = os.path.join(self.host_dirs[lease.host],
                                       "in", copy.name)
                if os.path.exists(in_path):
                    self._leases.renew(lease, now)
                elif not self._requeue(name, entry, now, mono):
                    self._respool(name, entry, now, mono)
                continue
            if healthy:
                if now - lease.claimed_at > lease.ttl_s / 2.0:
                    self._leases.renew(lease, now)
                continue
            if dead or state in (fault.RESTARTING, fault.QUARANTINED) \
                    or lease.expired(now):
                taken = None
                if not dead and state not in (fault.RESTARTING,
                                              fault.QUARANTINED):
                    # pure TTL expiry: the verdict above came from an
                    # IN-MEMORY stamp, and a concurrent front may have
                    # renewed the lease FILE since — a plain
                    # requeue-on-load would destroy that renewal and
                    # double-place the request. take() is the CAS:
                    # exactly one sweeper owns the file, and whatever
                    # the taken copy says is the truth acted on.
                    taken = self._leases.take(name)
                    if taken is None:
                        continue   # completed or taken under us
                    if not taken.expired(now):
                        self._leases.write(taken)  # renewed under us
                        continue
                    entry.lease = lease = taken    # own the real trail
                if not self._requeue(name, entry, now, mono):
                    if taken is not None:
                        # took the file but could not move the request:
                        # put the trail back on disk before waiting,
                        # so the claim stays operator-visible and the
                        # next tick's take() finds it again
                        self._leases.write(taken)
                    # the requeue found no excluded-compliant host: a
                    # STRANDED request (trail covers every host) must
                    # respool or abandon in-band, never hang until the
                    # caller's collect() timeout
                    self._rescue_stranded(name, entry, now, mono)

    def _requeue(self, name: str, entry: _Outstanding, now: float,
                 mono: Optional[float] = None) -> bool:
        """Move one stranded request to a different healthy host,
        excluding every host it already failed on. Capped at
        ``max_requeues`` attempts — a request that kills every host it
        touches becomes an in-band failure row, never a fleet-wide
        crash loop. Returns True when the request was handled (moved
        or abandoned), False when no excluded-compliant host had
        headroom this tick."""
        lease = entry.lease
        if lease.attempts > self.fault.max_requeues:
            self._abandon(
                name, entry,
                f"request abandoned after {lease.attempts} attempts "
                f"across hosts {lease.hosts} (max_requeues="
                f"{self.fault.max_requeues})")
            return True
        req, priced, cost = self.price(entry.obj)
        placement = self.router.place(affinity_key(req), priced, cost,
                                      count_held=False,
                                      exclude=lease.hosts)
        if placement is None:
            return False           # no healthy headroom yet: next tick
        stranded = self._copy_on(entry, lease.host)
        new_name = self._next_name()
        copy = self._write_copy(placement, new_name, entry.obj)
        with self._lock:
            # append-under-membership: a sweep that popped the entry
            # already released every copy it could SEE, so a late copy
            # must release itself instead of joining the entry
            landed = name not in self._outstanding
            if not landed:
                entry.copies.append(copy)
                self._fault_stats["requeues"] += 1
        if landed:
            self.router.release(placement)
            try:
                os.remove(os.path.join(
                    self.host_dirs[placement.host], "in", new_name))
            except OSError:
                pass
            return True
        # best-effort unspool of the stranded copy: if the old host's
        # in/ file is still unclaimed, removing it stops a restarted
        # host from re-running work that now lives elsewhere (a claimed
        # copy is beyond reach — its late result is a harmless
        # duplicate write)
        try:
            os.remove(os.path.join(self.host_dirs[lease.host], "in",
                                   stranded.name))
        except OSError:
            pass
        lease.host = placement.host
        lease.claimed_at = now
        lease.attempts += 1
        lease.hosts.append(placement.host)
        # the hedge's pending-age clock restarts with the new host: an
        # inherited age would make a fresh requeue target look hot
        entry.submitted_at = \
            time.monotonic() if mono is None else mono
        self._leases.write(lease)
        return True

    def _abandon(self, name: str, entry: _Outstanding,
                 error: str) -> None:
        """Resolve one outstanding request as an in-band failure row:
        the terminal move for a poison request past the requeue cap
        and for a stranded request no host can ever take again. The
        row honors the nonce namespace, every copy's placement is
        released, the lease removed — the caller's collect() returns
        a failure instead of timing out."""
        lease = entry.lease
        row = {"ok": False, "error": error}
        if lease.nonce:
            row["nonce"] = lease.nonce
        with self._lock:
            if self._outstanding.pop(name, None) is None:
                return             # raced a sweep: the result landed
            self._collected[name] = row
            self._fault_stats["abandoned"] += 1
            copies = list(entry.copies)
        _release_placements(self.router, copies)
        self._leases.remove(name)

    def _rescue_stranded(self, name: str, entry: _Outstanding,
                         now: float,
                         mono: Optional[float] = None) -> None:
        """A request the requeue could not move this tick. Distinguish
        'no headroom yet' (an untried SERVING host may still take it —
        wait, capacity frees when results land) from STRANDED: the
        attempt trail covers every host, so no requeue can ever land.
        A stranded request resolves in-band — respooled to a healthy
        trail host (re-execution is safe by the idempotency contract,
        and the respool's attempt bump walks it into the max_requeues
        cap if the failures keep coming) or abandoned with a failure
        row: immediately when every host is quarantined/stopped, and
        after ``stranded_patience_s`` when the only hosts left are
        restarting/stalled (a brief stall recovers; a permanently
        wedged host must not hold the request to the collect()
        timeout — STALLED never respawns, only an exit code does).
        ``attempts`` only grows on moves, so the cap alone can never
        fire for a request nobody can move. The patience clock runs on
        ``mono`` — a wall step must neither abandon a request early
        nor hold it past the bound."""
        mono = time.monotonic() if mono is None else mono
        lease = entry.lease
        with self._lock:
            states = list(self._host_state)
            procs = list(self._procs)
        trail = set(lease.hosts)
        if any(h not in trail and s == fault.SERVING
               for h, s in enumerate(states)):
            entry.stranded_at = None
            return                 # headroom wait: capacity frees
        healthy_trail = [h for h in sorted(trail)
                         if h < len(states)
                         and states[h] == fault.SERVING
                         and procs[h] is not None]
        if healthy_trail:
            entry.stranded_at = None
            self._respool(name, entry, now, mono,
                          host=healthy_trail[0])
            return
        if any(s in (fault.RESTARTING, fault.STALLED) for s in states):
            # a host may yet recover: wait, but only within patience
            if entry.stranded_at is None:
                entry.stranded_at = mono
            if mono - entry.stranded_at \
                    <= self.fault.stranded_patience_s:
                return
        self._abandon(
            name, entry,
            f"request stranded: attempt trail {sorted(trail)} covers "
            f"every host and none is healthy (states {states})")

    def _respool(self, name: str, entry: _Outstanding, now: float,
                 mono: Optional[float] = None,
                 host: Optional[int] = None) -> None:
        """Re-spool a stranded request into a trail host's OWN in/ —
        the fallback when the requeue exclusion leaves no other host.
        Default target: the lease host (the restarted-incarnation
        case: the new process never saw the claim the old one died
        holding); a stranded request whose lease host stays dead
        respools to any healthy trail host instead. Re-execution is
        safe, so handing the request back beats never serving it. The
        copy rides that host's EXISTING placement charge (same host,
        same request — not new load)."""
        lease = entry.lease
        if lease.attempts > self.fault.max_requeues:
            return                 # the requeue cap will abandon it
        host = lease.host if host is None else host
        prior = self._copy_on(entry, host)
        new_name = self._next_name()
        copy = self._write_copy(prior.placement, new_name, entry.obj)
        with self._lock:
            landed = name not in self._outstanding
            if not landed:
                entry.copies.append(copy)
                self._fault_stats["respools"] += 1
        if landed:                 # raced a sweep: just unspool it
            try:
                os.remove(os.path.join(
                    self.host_dirs[host], "in", new_name))
            except OSError:
                pass
            return
        lease.host = host
        lease.claimed_at = now
        lease.attempts += 1
        entry.submitted_at = \
            time.monotonic() if mono is None else mono
        self._leases.write(lease)

    def _rolled_p99(self) -> Dict[int, Tuple[float, int]]:
        """Each host's rolled-up (queue-wait p99 ms, served count)
        from its own metrics snapshot — the hedging signal's served
        half. The count gates hedging: a host that has never finished
        a request has no measured tail to run hot — it is warming up,
        not straggling."""
        out: Dict[int, Tuple[float, int]] = {}
        for i, host_dir in enumerate(self.host_dirs):
            try:
                with open(os.path.join(host_dir, "metrics.json")) as fh:
                    snap = json.load(fh)
                hist = (snap.get("hists") or {}).get("queue_wait_ms",
                                                     {})
                out[i] = (float(hist.get("p99", 0.0)),
                          int(hist.get("count", 0)))
            except (OSError, ValueError):
                out[i] = (0.0, 0)
        return out

    def _hedge(self, mono: float) -> None:
        """Hedged tail dispatch: when one host's queue-wait tail runs
        past ``hedge_multiple``x the fleet median, mirror its queued
        requests onto the least-loaded compatible host and let the
        first result win (module docstring; fault.hot_hosts is the
        decision). The pending-age clock is monotonic: a wall step
        must not make every queued request look instantly hot."""
        with self._lock:
            healthy = [i for i, s in enumerate(self._host_state)
                       if s == fault.SERVING]
            entries = list(self._outstanding.items())
        pending_age: Dict[int, float] = {}
        for _name, entry in entries:
            if entry.mirrored:
                continue
            age_ms = (mono - entry.submitted_at) * 1000.0
            host = entry.lease.host
            pending_age[host] = max(pending_age.get(host, 0.0), age_ms)
        rolled = self._rolled_p99()
        hot = fault.hot_hosts({h: p99 for h, (p99, _n) in rolled.items()},
                              pending_age, self.fault, healthy)
        # only a host with a MEASURED tail (>=1 served request) can be
        # "hot": a host still compiling its first request is cold, and
        # mirroring its queue would just double the warmup bill
        hot = [h for h in hot if rolled.get(h, (0.0, 0))[1] > 0]
        if not hot:
            return
        for name, entry in entries:
            if entry.mirrored or entry.lease.host not in hot:
                continue
            req, priced, cost = self.price(entry.obj)
            placement = self.router.place_mirror(
                affinity_key(req), priced, cost,
                exclude=entry.lease.hosts)
            if placement is None:
                continue           # no headroom: hedging never holds
            mirror_name = self._next_name()
            copy = self._write_copy(placement, mirror_name, entry.obj)
            with self._lock:
                landed = name not in self._outstanding
                if not landed:
                    entry.copies.append(copy)
                    entry.mirrored = True
            if landed:             # raced a sweep: release the mirror
                self.router.release(placement)
                try:
                    os.remove(os.path.join(
                        self.host_dirs[placement.host], "in",
                        mirror_name))
                except OSError:
                    pass
                continue
            entry.lease.hosts.append(placement.host)
            self._leases.write(entry.lease)

    def fault_snapshot(self) -> Dict:
        """The supervision view the merged fleet metrics carry: per-
        host state + restart counts, the requeue/hedge counters, and
        any errors the supervisor loop survived."""
        with self._lock:
            states = list(self._host_state)
            stats = dict(self._fault_stats)
            restarts = list(self._restart_counts)
        return {
            "hosts": [{"host": i, "state": s, "restarts": restarts[i],
                       "recent_deaths":
                           self._trackers[i].recent_deaths}
                      for i, s in enumerate(states)],
            "stats": stats,
            "leases_outstanding": len(self._leases.names()),
            "supervisor_errors": (self._supervisor.errors()
                                  if self._supervisor else []),
        }

    # --------------------------------------------------------------- metrics
    def merged_metrics(self) -> Dict:
        """The fleet snapshot: per-host metrics.json files folded into
        one through the additive histogram merge, with the router's
        placement stats and budget-vector occupancy attached
        (docs/observability.md "Fleet roll-up")."""
        from avenir_tpu_torch.obs.report import merge_snapshots

        snaps = []
        for host_dir in self.host_dirs:
            path = os.path.join(host_dir, "metrics.json")
            try:
                with open(path) as fh:
                    snaps.append(json.load(fh))
            except (OSError, ValueError):
                continue            # host not up yet / mid-rename
        merged = merge_snapshots(snaps)
        merged["router"] = self.router.snapshot()
        merged["supervision"] = self.fault_snapshot()
        return merged

    def write_metrics(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.root, "metrics.json")
        return publish_json(self.merged_metrics(), path)

    # ------------------------------------------------------------- stopping
    def stop(self, timeout: float = 120.0) -> List[Optional[int]]:
        """Graceful fleet shutdown: stop the supervisor (no restarts
        racing the teardown), SIGCONT + SIGTERM every live host (their
        handlers drain: finish claimed work, final per-host
        metrics.json, exit 0 — the SIGCONT first so a stopped/stalled
        host can even SEE the signal), join, write the final merged
        metrics. Returns the per-host exit codes; a host that needed
        SIGKILL reports rc < 0, a host already dead/quarantined reports
        None."""
        if self._supervisor is not None:
            self._supervisor.stop()
            self._supervisor = None
        with self._lock:
            self._host_state = [fault.STOPPED] * len(self.host_dirs)
            procs = list(self._procs)
        for proc in procs:
            if proc is not None and proc.poll() is None:
                try:
                    proc.send_signal(signal.SIGCONT)
                    proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        codes: List[Optional[int]] = []
        deadline = time.perf_counter() + timeout
        for proc in procs:
            if proc is None:
                codes.append(None)
                continue
            remaining = max(deadline - time.perf_counter(), 0.1)
            try:
                codes.append(proc.wait(timeout=remaining))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        with self._lock:
            self._procs = [None] * len(self.host_dirs)
        try:
            self.write_metrics()
        except OSError:
            pass
        return codes


def _release_placements(router: AffinityRouter,
                        copies: Sequence[_Copy]) -> None:
    """Release every DISTINCT placement behind an entry's copies — a
    re-spooled copy shares its predecessor's placement (same host,
    same charge), so releasing per copy would double-credit the
    budget vector."""
    seen: set = set()
    for copy in copies:
        if id(copy.placement) in seen:
            continue
        seen.add(id(copy.placement))
        router.release(copy.placement)


def _tail(path: str, nbytes: int = 800) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(fh.tell() - nbytes, 0))
            return fh.read().decode(errors="replace")
    except OSError:
        return "<no log>"


# --------------------------------------------------------------------------
# the fleet CLI
# --------------------------------------------------------------------------
def fleet_main(argv) -> int:
    """``python -m avenir_tpu_torch fleet --root DIR --hosts N [...]`` — the
    fleet-level spool session (module docstring)."""
    import argparse

    from avenir_tpu_torch.server.spool import (_claim,
                                               install_drain_handlers,
                                               load_claimed)

    ap = argparse.ArgumentParser(prog="avenir_tpu_torch fleet")
    ap.add_argument("--root", required=True,
                    help="fleet root: requests in <root>/in, results in "
                         "<root>/out, hosts under <root>/host<i>")
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1,
                    help="worker threads per host process (default 1)")
    ap.add_argument("--budget-mb", type=float, default=3072.0,
                    help="per-host admission budget — one entry of the "
                         "fleet's budget vector (default 3072)")
    ap.add_argument("--once", action="store_true",
                    help="serve what is spooled, drain, exit")
    ap.add_argument("--profile-dir", default=None,
                    help="autotune profile store consulted for "
                         "fold-cost-weighted placement")
    ap.add_argument("--device", default=None,
                    help="every host's torch device (default cuda; 'cpu' "
                         "runs the plain versions of the kernels)")
    ap.add_argument("--metrics-interval", type=float, default=1.0)
    ap.add_argument("--no-supervise", action="store_true",
                    help="disable host supervision/leases/hedging "
                         "(PR-12 behavior: a dead host is fatal)")
    ap.add_argument("--lease-ttl", type=float,
                    default=FaultPolicy.lease_ttl_s,
                    help="request lease TTL in seconds before an "
                         "unhealthy host's claims requeue (default "
                         f"{FaultPolicy.lease_ttl_s})")
    ap.add_argument("--hedge-multiple", type=float,
                    default=FaultPolicy.hedge_multiple,
                    help="mirror a host's queued requests when its "
                         "queue-wait p99 exceeds this multiple of the "
                         "fleet median (default "
                         f"{FaultPolicy.hedge_multiple}; <=0 disables)")
    args = ap.parse_args(argv)

    in_dir, work_dir, out_dir = spool_dirs(args.root)
    policy = FaultPolicy(
        supervise=not args.no_supervise, lease_ttl_s=args.lease_ttl,
        hedge=args.hedge_multiple > 0,
        hedge_multiple=max(args.hedge_multiple, 0.1))
    fleet = Fleet(args.root, hosts=args.hosts, budget_mb=args.budget_mb,
                  workers=args.workers, profile_dir=args.profile_dir,
                  metrics_interval_s=min(args.metrics_interval, 1.0),
                  fault_policy=policy, device=args.device)
    stop_event = threading.Event()
    should_stop = install_drain_handlers(stop_event)
    failures = 0
    #: fleet request name -> (client name, nonce, work path): the work
    #: file survives until the final out/ row lands (serve_spool's own
    #: discipline), so a front crash never silently loses an accepted
    #: request — the file is still in work/ for recovery
    submitted: Dict[str, Tuple[str, Optional[str], str]] = {}
    #: claimed but not yet placeable (every host over its vector
    #: entry): retried each pass — the front must stay live (writing
    #: rows, refreshing metrics, noticing SIGTERM) while work is held,
    #: so placement is never allowed to block the loop. The bool marks
    #: whether the arrival was already counted held (transition-only).
    backlog: List[Tuple[str, Dict, str, bool]] = []

    def finish(work_path: str) -> None:
        try:
            os.remove(work_path)
        except OSError:
            pass

    def fail_row(name: str, obj, exc: BaseException,
                 work_path: str) -> None:
        row = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        # failure rows honor the nonce namespace too — a nonce-polling
        # client must see its failure, not wait forever on an
        # un-prefixed row
        nonce = obj.get("nonce") if isinstance(obj, dict) else None
        if isinstance(nonce, str) and nonce:
            row["nonce"] = nonce
        _write_row(out_dir, nonce_result_name(
            name, nonce if isinstance(nonce, str) and nonce else None),
            row)
        finish(work_path)

    fleet.start()
    try:
        last_metrics = 0.0
        while True:
            stopping = should_stop()
            if not stopping:
                for name, work_path in _claim(in_dir, work_dir):
                    obj = None
                    try:
                        # torn bytes dead-letter (never re-claimed);
                        # validation runs before routing so a bad
                        # request is reported in-band, not a front
                        # crash
                        obj = load_claimed(args.root, name, work_path)
                        request_from_json(obj)
                        backlog.append((name, obj, work_path, True))
                    except Exception as exc:  # noqa: BLE001 — in-band
                        failures += 1
                        fail_row(name, obj, exc, work_path)
            # place what the budget vector has room for; the rest stays
            # backlogged (claimed work still drains during a stop)
            still: List[Tuple[str, Dict, str, bool]] = []
            for name, obj, work_path, first in backlog:
                try:
                    fname = fleet.submit(obj, block=False,
                                         count_held=first)
                except Exception as exc:  # noqa: BLE001 — in-band
                    failures += 1
                    fail_row(name, obj, exc, work_path)
                    continue
                if fname is None:
                    still.append((name, obj, work_path, False))
                else:
                    submitted[fname] = (name, obj.get("nonce"),
                                        work_path)
            backlog = still
            # non-blocking sweep: collect whatever is ready
            ready = fleet.ready()
            done = fleet.collect(ready, timeout=30.0) if ready else {}
            for fname, row in done.items():
                client_name, nonce, work_path = submitted.pop(
                    fname, (fname, None, ""))
                failures += 0 if row.get("ok") else 1
                _write_row(out_dir,
                           nonce_result_name(client_name, nonce), row)
                if work_path:
                    finish(work_path)
            now = time.perf_counter()
            if now - last_metrics >= args.metrics_interval:
                last_metrics = now
                try:
                    fleet.write_metrics()
                except OSError:
                    pass
            drained = not submitted and not backlog
            try:
                spooled = any(n.endswith(".json")
                              for n in os.listdir(in_dir))
            except OSError:
                spooled = False
            if stopping and drained:
                break
            if args.once and drained and not spooled:
                break
            time.sleep(_POLL_SECS)
    finally:
        fleet.stop()
    print(json.dumps({"fleet": "done", "failed": failures,
                      "router": fleet.router.snapshot()}),
          file=sys.stderr)
    return 1 if failures else 0


def _write_row(out_dir: str, name: str, row: Dict) -> None:
    publish_json(row, os.path.join(out_dir, name), indent=1)
