"""JSON-over-HTTP/1.1 edge for the resident job server. Stdlib only.

The port of `avenir_tpu/net/listener.py`: the edge runs on the CPU; the
jobs and scores it admits run on its JobServer's device.

The spool transports (stdin JSON-lines, maildir directory) are hermetic
but single-host-single-client; this listener is the network front the
ROADMAP's fleet item asks for, deliberately thin: every request body is
the SAME JSON object the spool speaks (``spool.request_from_json``),
every response row the same shape ``spool.result_to_json`` writes, so a
tenant can move between ``--stdin``, ``--spool`` and ``--listen``
without changing a byte of its request.

Surface:

- ``POST /submit`` — submit one request. ``?wait=1`` blocks for the
  result row (200); otherwise 202 with the ``req_id`` to poll.
- ``GET /result/<req_id>`` — 200 with the result row once served
  (fetching releases it), 202 while pending, 404 for unknown ids.
  ``?timeout=S`` long-polls.
- ``GET /metrics`` — the live ``metrics.json`` snapshot
  (``JobServer.metrics_snapshot``) plus an ``edge`` section.
- ``GET /healthz`` — 200 ``{"status": "serving"}`` /
  503 ``{"status": "draining"}``: the drain state a fleet router or
  load balancer health-checks. Supervision can overlay
  ``"quarantined"`` / ``"restarting"`` via :meth:`set_health_state`
  (503 as well) so operators and a fleet front probing the edge see
  the same state the supervisor acted on.

**Backpressure is wired to the admission model, at the edge.** The
single server already refuses to RUN over budget (the priced-bytes
admission gate), but an unbounded accept loop could still queue
requests toward OOM. The edge closes that hole: each request is priced
by the server's own pricer (``JobServer.price`` — the same oracle the
scheduler admits with) and accepted only while the edge's outstanding
priced total stays inside the budget and the tenant's queue inside its
depth bound. Over either limit the edge answers ``429`` with a
``Retry-After`` header (``shed_mode="reject"``, the default) or parks
the accept in the handler thread until capacity frees
(``shed_mode="hold"``). So the server's priced peak can never exceed
its budget AND the queue in front of it is bounded — the two halves of
the OOM-free claim ``tests/test_torch_net.py`` pins.

Thread shape: one accept loop (``ThreadingHTTPServer.serve_forever`` —
per-connection handler threads are the stdlib's, daemonic and bounded
by the request), plus one reaper thread releasing finished requests'
edge accounting; both bound in ``_threads`` and joined by ``stop()``.
"""

from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from avenir_tpu_torch.models.artifact import ModelFormatSkew
from avenir_tpu_torch.server.jobserver import JobServer, ServerClosed, Ticket
from avenir_tpu_torch.server.score import (ScoreError, ScoreTimeout,
                                           score_request_from_json)
from avenir_tpu_torch.server.spool import request_from_json, result_to_json

#: default blocking wait for one /score (override with ?timeout=; a
#: coalesced score answers in ms — this bound only catches wedges)
_SCORE_WAIT_S = 30.0

#: reaper poll bound — how long a finished request's priced bytes can
#: linger before the edge releases them
_REAP_SECS = 0.05


@dataclass
class EdgePolicy:
    """The edge's backpressure knobs.

    ``shed_mode``: "reject" answers 429-with-Retry-After the moment a
    request would breach a bound; "hold" parks the accept until
    capacity frees (bounded by ``hold_timeout_s``, then 429 anyway —
    an edge must never hold forever). ``budget_bytes``: the edge's
    outstanding-priced ceiling, defaulting to the server's own
    admission budget. ``max_tenant_depth``: per-tenant queued-request
    bound. ``retry_after_s``: the 429 Retry-After hint."""

    shed_mode: str = "reject"
    budget_bytes: Optional[int] = None
    max_tenant_depth: int = 64
    #: the 429 Retry-After hint, jittered ±`retry_jitter` per response
    #: so a synchronized cohort of shed clients does not retry in
    #: lockstep and re-stampede the edge at one instant
    retry_after_s: float = 1.0
    retry_jitter: float = 0.2
    hold_timeout_s: float = 30.0
    wait_timeout_s: float = 600.0
    #: a served-but-never-fetched result is dropped after this long —
    #: a fire-and-forget client must not grow a resident edge forever
    result_ttl_s: float = 600.0

    def __post_init__(self):
        if self.shed_mode not in ("reject", "hold"):
            raise ValueError(
                f"unknown shed_mode {self.shed_mode!r} "
                f"(expected 'reject' or 'hold')")


class _EdgeEntry:
    """One accepted request's edge bookkeeping."""

    __slots__ = ("ticket", "priced", "released", "released_at")

    def __init__(self, ticket: Ticket, priced: int):
        self.ticket = ticket
        self.priced = priced
        self.released = False
        self.released_at = 0.0


class _Httpd(ThreadingHTTPServer):
    # handler threads die with their connection; the accept loop itself
    # is joined by NetListener.stop()
    daemon_threads = True
    listener: "NetListener"


class NetListener:
    """The HTTP edge over one :class:`JobServer` (module docstring).

    Construct with ``port=0`` for an ephemeral port (tests and
    single-host fleets MUST — fixed ports are how network tests flake),
    ``start()``, read ``port``, ``stop()`` when done. The listener owns
    only its accept/reaper threads; the JobServer's lifecycle stays the
    caller's."""

    def __init__(self, server: JobServer, host: str = "127.0.0.1",
                 port: int = 0, policy: Optional[EdgePolicy] = None):
        import dataclasses

        self.server = server
        # a COPY: resolving the default budget must not write through
        # to a caller's policy object shared with another listener
        self.policy = dataclasses.replace(policy) if policy \
            else EdgePolicy()
        if self.policy.budget_bytes is None:
            self.policy.budget_bytes = server.budget_bytes
        self._httpd = _Httpd((host, port), _Handler)
        self._httpd.listener = self
        self._lock = threading.Lock()
        self._capacity = threading.Condition(self._lock)
        self._outstanding: Dict[str, _EdgeEntry] = {}
        self._outstanding_priced = 0
        self._draining = False
        self._health_state: Optional[str] = None
        self._stop = threading.Event()
        self._threads: list = []
        self._stats: Dict[str, int] = {
            "accepted": 0, "rejected": 0, "held_accepts": 0,
            "completed": 0,
        }

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "NetListener":
        # daemon + joined-by-stop(): the join in stop() is the real
        # lifecycle; daemon means a listener abandoned by a crashed
        # caller can never wedge interpreter exit
        t = threading.Thread(target=self._httpd.serve_forever,
                             kwargs={"poll_interval": 0.1},
                             name="avenir-net-accept", daemon=True)
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._reaper_loop,
                             name="avenir-net-reaper", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def begin_drain(self) -> None:
        """Flip /healthz to draining and refuse new submissions (503);
        in-flight requests keep serving and stay fetchable."""
        with self._lock:
            self._draining = True
            self._capacity.notify_all()
        self.server.begin_drain()

    def set_health_state(self, state: Optional[str]) -> None:
        """Overlay a supervision state on ``/healthz`` —
        ``"quarantined"`` / ``"restarting"`` (503, new submissions
        refused with the state in-band) or None to return to normal
        serving. This is how a supervisor makes its verdict visible to
        the operators and fleet fronts health-checking the edge."""
        if state is not None and state not in ("quarantined",
                                               "restarting"):
            raise ValueError(
                f"unknown health state {state!r} (expected "
                f"'quarantined', 'restarting' or None)")
        with self._lock:
            self._health_state = state
            self._capacity.notify_all()

    def health_state(self) -> str:
        """The /healthz status string: draining wins (an operator
        decision), then the supervision overlay, then serving."""
        with self._lock:
            if self._draining:
                return "draining"
            return self._health_state or "serving"

    def retry_after_s(self) -> float:
        """One 429's Retry-After hint: the policy value jittered
        ±``retry_jitter`` so shed clients spread their retries instead
        of re-stampeding in lockstep."""
        import random

        jitter = max(min(self.policy.retry_jitter, 1.0), 0.0)
        return self.policy.retry_after_s * random.uniform(1.0 - jitter,
                                                          1.0 + jitter)

    def stop(self) -> None:
        """Stop accepting and join the accept/reaper threads. Does NOT
        shut the JobServer down — callers drain/stop it themselves."""
        self._stop.set()
        self._httpd.shutdown()
        threads, self._threads = self._threads, []
        for t in threads:
            t.join(10.0)
        self._httpd.server_close()

    def __enter__(self) -> "NetListener":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------ edge accounting
    def _reaper_loop(self) -> None:
        while not self._stop.is_set():
            now = time.perf_counter()
            with self._capacity:
                freed = 0
                expired = []
                for entry_id, entry in self._outstanding.items():
                    if not entry.released and entry.ticket.done:
                        entry.released = True
                        entry.released_at = now
                        freed += entry.priced
                        self._stats["completed"] += 1
                    elif entry.released and now - entry.released_at \
                            > self.policy.result_ttl_s:
                        # fetched results pop in take_result; a client
                        # that never polls must not pin its JobResult
                        # (and the reaper's sweep cost) forever
                        expired.append(entry_id)
                for entry_id in expired:
                    self._outstanding.pop(entry_id, None)
                if freed:
                    self._outstanding_priced -= freed
                    self._capacity.notify_all()
                self._capacity.wait(_REAP_SECS)

    def try_accept(self, tenant: str, priced: int) -> Tuple[bool, str]:
        """Reserve edge capacity for one priced request: (accepted,
        reason). Honors the policy's shed mode — "hold" parks here
        until capacity frees or the hold bound passes."""
        deadline = time.perf_counter() + self.policy.hold_timeout_s
        held = False
        with self._capacity:
            while True:
                if self._draining:
                    return False, "draining"
                if self._health_state is not None:
                    # supervision overlay: a quarantined/restarting
                    # edge refuses new work in-band, like draining
                    return False, self._health_state
                reason = self._over_limit_locked(tenant, priced)
                if reason is None:
                    self._outstanding_priced += priced
                    self._stats["accepted"] += 1
                    if held:
                        self._stats["held_accepts"] += 1
                    return True, "accepted"
                if self.policy.shed_mode != "hold":
                    self._stats["rejected"] += 1
                    return False, reason
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self._stats["rejected"] += 1
                    return False, reason
                held = True
                self._capacity.wait(min(remaining, _REAP_SECS * 4))

    def _over_limit_locked(self, tenant: str, priced: int
                           ) -> Optional[str]:
        if self._outstanding_priced + priced > self.policy.budget_bytes:
            return ("priced in-flight bytes "
                    f"{self._outstanding_priced + priced} would exceed "
                    f"the {self.policy.budget_bytes}-byte budget")
        if self.server.queue_depth(tenant) >= self.policy.max_tenant_depth:
            return (f"tenant {tenant!r} queue depth at the "
                    f"{self.policy.max_tenant_depth} bound")
        return None

    def register(self, entry_id: str, ticket: Ticket, priced: int) -> None:
        with self._capacity:
            old = self._outstanding.get(entry_id)
            if old is not None and not old.released:
                # a client reused a req_id while the first submission
                # was still in flight: last-submit-wins for the fetch,
                # but the replaced entry's priced bytes must be freed
                # or the edge budget leaks shut permanently
                old.released = True
                self._outstanding_priced -= old.priced
                self._capacity.notify_all()
            self._outstanding[entry_id] = _EdgeEntry(ticket, priced)

    def release_unsubmitted(self, priced: int) -> None:
        """Undo a try_accept reservation whose submit failed."""
        with self._capacity:
            self._outstanding_priced -= priced
            self._capacity.notify_all()

    def take_result(self, entry_id: str, timeout: float = 0.0
                    ) -> Tuple[Optional[Dict], bool]:
        """(result row or None, known): the row once the ticket is done
        — fetching pops the entry — else (None, True) while pending."""
        with self._lock:
            entry = self._outstanding.get(entry_id)
        if entry is None:
            return None, False
        if not entry.ticket._done.wait(timeout):
            return None, True
        with self._capacity:
            entry = self._outstanding.pop(entry_id, None)
            if entry is None:                  # raced another fetcher
                return None, False
            if not entry.released:
                entry.released = True
                self._outstanding_priced -= entry.priced
                self._stats["completed"] += 1
                self._capacity.notify_all()
        return result_to_json(entry.ticket), True

    def edge_stats(self) -> Dict:
        with self._lock:
            return {
                **{k: int(v) for k, v in self._stats.items()},
                "outstanding_requests": len(self._outstanding),
                "outstanding_priced_bytes": int(self._outstanding_priced),
                "budget_bytes": int(self.policy.budget_bytes),
                "max_tenant_depth": int(self.policy.max_tenant_depth),
                "shed_mode": self.policy.shed_mode,
                "draining": self._draining,
                "health_state": (self._health_state
                                 if not self._draining else "draining")
                or "serving",
            }

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining


class _Handler(BaseHTTPRequestHandler):
    server_version = "avenir-net/1"
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def log_message(self, fmt, *args):      # noqa: D102 — stdlib hook
        pass                                # the metrics surface IS the log

    def _reply(self, code: int, obj: Dict,
               headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _query(self) -> Dict[str, str]:
        q = parse_qs(urlsplit(self.path).query)
        return {k: v[-1] for k, v in q.items()}

    def _query_timeout(self, q: Dict[str, str],
                       default: float) -> Optional[float]:
        """The ?timeout= parameter as a float, or None AFTER answering
        400 — client input must never crash the handler thread. Capped
        at the policy's wait bound: a client-chosen timeout must not
        pin a handler thread and its socket past what the edge would
        grant its own blocking waits."""
        listener: NetListener = self.server.listener
        try:
            timeout = max(float(q.get("timeout", default)), 0.0)
        except (TypeError, ValueError):
            self._reply(400, {"ok": False,
                              "error": f"invalid timeout "
                                       f"{q.get('timeout')!r}"})
            return None
        return min(timeout, listener.policy.wait_timeout_s)

    def _handle_score(self) -> None:
        """``POST /score`` — the query path. Persistent HTTP/1.1
        connections matter here the way they never did for /submit:
        a coalesced score answers in single-digit ms, so per-request
        TCP setup would dominate; ``_reply`` always sends
        Content-Length, which is what keeps the socket reusable.
        Scores bypass the priced-bytes edge (a row costs no scan) but
        respect the drain gate like every submission."""
        listener: NetListener = self.server.listener
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = score_request_from_json(
                json.loads(self.rfile.read(length)))
        except (ValueError, KeyError, TypeError) as exc:
            self._reply(400, {"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"})
            return
        if listener.draining or listener.server.draining:
            self._reply(503, {"ok": False, "status": "draining"})
            return
        timeout = self._query_timeout(self._query(), _SCORE_WAIT_S)
        if timeout is None:
            return
        plane = listener.server.score_plane()
        try:
            if req.action == "reward":
                ack = plane.reward(req)
                self._reply(200, {"ok": True, "req_id": req.req_id,
                                  **ack})
                return
            result = plane.score(req, timeout=timeout)
        except ModelFormatSkew as exc:
            # refuse-and-go-cold: a foreign/torn artifact stamp is the
            # operator's problem, never parsed blind
            self._reply(409, {"ok": False, "error": str(exc)})
            return
        except ScoreTimeout as exc:
            self._reply(504, {"ok": False, "error": str(exc)})
            return
        except (ScoreError, OSError, KeyError, ValueError) as exc:
            self._reply(400, {"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {"ok": True, **result.to_json()})

    # --------------------------------------------------------------- routes
    def do_POST(self) -> None:              # noqa: N802 — stdlib name
        listener: NetListener = self.server.listener
        path = urlsplit(self.path).path
        if path == "/score":
            self._handle_score()
            return
        if path != "/submit":
            self._reply(404, {"error": f"no such route {path}"})
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            req = request_from_json(json.loads(self.rfile.read(length)))
            priced = listener.server.price([req])
        except (ValueError, KeyError, TypeError) as exc:
            self._reply(400, {"ok": False,
                              "error": f"{type(exc).__name__}: {exc}"})
            return
        accepted, reason = listener.try_accept(req.tenant, priced)
        if not accepted:
            if reason in ("draining", "quarantined", "restarting"):
                self._reply(503, {"ok": False, "status": reason})
                return
            retry_s = listener.retry_after_s()
            self._reply(429, {"ok": False, "error": reason,
                              "retry_after_s": round(retry_s, 3)},
                        headers={"Retry-After":
                                 str(max(int(math.ceil(retry_s)), 1))})
            return
        try:
            ticket = listener.server.submit(req)
        except (ServerClosed, KeyError, ValueError) as exc:
            listener.release_unsubmitted(priced)
            code = 503 if isinstance(exc, ServerClosed) else 400
            self._reply(code, {"ok": False,
                               "error": f"{type(exc).__name__}: {exc}"})
            return
        listener.register(req.req_id, ticket, priced)
        q = self._query()
        if q.get("wait") in ("1", "true"):
            timeout = self._query_timeout(
                q, listener.policy.wait_timeout_s)
            if timeout is None:
                return                   # 400 sent; the job still runs
            row, _known = listener.take_result(req.req_id, timeout)
            if row is None:
                self._reply(202, {"req_id": req.req_id,
                                  "status": "pending"})
                return
            self._reply(200 if row["ok"] else 500, row)
            return
        self._reply(202, {"req_id": req.req_id, "status": "queued",
                          "priced_bytes": priced})

    def do_GET(self) -> None:               # noqa: N802 — stdlib name
        listener: NetListener = self.server.listener
        path = urlsplit(self.path).path
        if path == "/healthz":
            status = listener.health_state()
            self._reply(200 if status == "serving" else 503,
                        {"status": status,
                         "queued": listener.server.queue_depth(),
                         "edge": listener.edge_stats()})
            return
        if path == "/metrics":
            snap = listener.server.metrics_snapshot()
            snap["edge"] = listener.edge_stats()
            self._reply(200, snap)
            return
        if path.startswith("/result/"):
            entry_id = path[len("/result/"):]
            timeout = self._query_timeout(self._query(), 0.0)
            if timeout is None:
                return                   # 400 sent
            row, known = listener.take_result(entry_id, timeout)
            if row is not None:
                self._reply(200 if row["ok"] else 500, row)
            elif known:
                self._reply(202, {"req_id": entry_id,
                                  "status": "pending"})
            else:
                self._reply(404, {"error": f"unknown req_id {entry_id}"})
            return
        self._reply(404, {"error": f"no such route {path}"})
