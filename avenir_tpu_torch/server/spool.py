"""Request spool: drive a resident JobServer with no network in the loop.

The port of `avenir_tpu/server/spool.py`; ``serve --device cpu`` runs
the server on the CPU (default cuda).

Two hermetic transports, both JSON request objects with the
:class:`~avenir_tpu_torch.server.jobserver.JobRequest` fields
(``{"job", "conf", "inputs", "output", "tenant", "priority", "mode"}``):

- **stream** — JSON lines on an input stream (stdin for the CLI), one
  result JSON line per request on the output stream, in submission
  order. EOF drains and exits: ``echo '{...}' | python -m avenir_tpu_torch
  serve --stdin`` is a complete hermetic session, which is how tier-1
  drives the server end to end.
- **spool directory** — tenants atomically drop ``*.json`` request
  files into ``<spool>/in/`` (write elsewhere + rename, the usual
  maildir discipline); the server claims each by renaming it into
  ``<spool>/work/``, serves it, and writes the result to
  ``<spool>/out/<name>``. ``--once`` processes what is spooled, drains
  and exits; without it the loop polls until the process is signalled.
  A claimed file whose bytes cannot parse as JSON is moved to
  ``<spool>/dead/`` with a ``.reason`` file (:func:`dead_letter`) —
  never re-claimable, so a torn request cannot crash-loop a restarted
  host — while the in-band failure row still goes out.

Result namespacing: a request may carry a client ``nonce`` token; its
result then lands at ``<spool>/out/<nonce>.<name>`` instead of
``<spool>/out/<name>``, so two clients reusing one filename stem can
never overwrite each other's results (claimed work files are likewise
uniquified, so a re-submitted stem never clobbers one mid-serve).

The CLI: ``python -m avenir_tpu_torch serve [--stdin | --spool DIR |
--listen HOST:PORT] [--once] [--budget-mb N] [--workers N]
[--warm-budget-mb N] [--state-root DIR] [--device cpu]``. Spool and
listen sessions treat SIGTERM/SIGINT as graceful drain: stop accepting,
finish in-flight work, write the final metrics.json, exit 0.
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from avenir_tpu_torch.core.atomic import (publish_bytes, publish_json,
                                          sched_point, sweep_stale_tmps)
from avenir_tpu_torch.server.jobserver import (DEFAULT_BUDGET_BYTES,
                                               DEFAULT_WARM_BUDGET_BYTES,
                                               JobRequest, JobServer, Ticket)

#: spool poll granularity (seconds)
_SPOOL_POLL_SECS = 0.1
#: a client nonce is a filename-safe token — it becomes a result-file
#: prefix, so path separators and dots-at-the-front must be impossible
_NONCE_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def request_from_json(obj: Dict) -> JobRequest:
    """A JobRequest from one spool/stream JSON object; unknown fields
    are rejected so a typo'd key fails loudly instead of silently
    running with a default."""
    known = {"job", "conf", "inputs", "output", "tenant", "priority",
             "mode", "state_dir", "nonce", "req_id"}
    extra = set(obj) - known
    if extra:
        raise ValueError(f"unknown request field(s): {sorted(extra)}")
    kwargs = dict(obj)
    kwargs.setdefault("conf", {})
    kwargs.setdefault("output", "")
    nonce = kwargs.get("nonce")
    if nonce is not None and not _NONCE_RE.match(str(nonce)):
        raise ValueError(
            f"invalid nonce {nonce!r}: expected a filename-safe token "
            f"([A-Za-z0-9][A-Za-z0-9._-]*, at most 64 chars)")
    return JobRequest(**kwargs)


def result_to_json(ticket: Ticket) -> Dict:
    """The served (or failed) ticket as one result JSON object."""
    out = {"req_id": ticket.request.req_id,
           "tenant": ticket.request.tenant,
           "job": ticket.request.job}
    if ticket.request.nonce:
        out["nonce"] = ticket.request.nonce
    try:
        res = ticket.result(timeout=0)
        out.update({"ok": True, "name": res.name,
                    "counters": res.counters, "outputs": res.outputs})
    except BaseException as exc:  # noqa: BLE001 — the result IS the report
        out.update({"ok": False, "error": f"{type(exc).__name__}: {exc}"})
    return out


def serve_stream(server: JobServer, in_stream, out_stream,
                 drain_timeout: float = 86_400.0) -> int:
    """JSON-lines transport: submit every request line, drain, emit one
    result line per request in submission order. Returns the count of
    failed requests (the CLI exit code). The drain bound defaults to a
    day, not the server's 5-minute test-scale default — a session over
    a real corpus legitimately runs for many minutes, and a timeout
    here cancels every in-flight request."""
    tickets: List[Ticket] = []
    for line in in_stream:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            tickets.append(server.submit(request_from_json(
                json.loads(line))))
        except Exception as exc:  # noqa: BLE001 — reported in-band
            failed = Ticket(JobRequest(job="<unparsed>", conf={},
                                       inputs=[], output=""))
            failed._complete(error=exc)
            tickets.append(failed)
    server.drain(timeout=drain_timeout)
    failures = 0
    for ticket in tickets:
        row = result_to_json(ticket)
        failures += 0 if row["ok"] else 1
        out_stream.write(json.dumps(row) + "\n")
    out_stream.flush()
    return failures


def spool_dirs(spool: str) -> Tuple[str, str, str]:
    """(in, work, out) subdirectories of a spool root, created."""
    paths = tuple(os.path.join(spool, d) for d in ("in", "work", "out"))
    for p in paths:
        os.makedirs(p, exist_ok=True)
    return paths


def _claim(in_dir: str, work_dir: str) -> List[Tuple[str, str]]:
    """Atomically claim every spooled request file: (name, work path)
    pairs. The work path carries a per-claim unique suffix, so a
    re-submitted filename stem can never overwrite a same-named claim
    still being served. A rename that loses a race (another claimer, a
    writer still renaming in) is skipped, never an error."""
    claimed = []
    try:
        names = sorted(os.listdir(in_dir))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".json"):
            continue
        src = os.path.join(in_dir, name)
        dst = os.path.join(work_dir, f"{name}.{uuid.uuid4().hex[:8]}")
        sched_point("spool.claim")
        try:
            os.replace(src, dst)
        except OSError:
            continue
        claimed.append((name, dst))
    return claimed


def dead_letter(spool: str, name: str, work_path: str,
                reason: str) -> str:
    """Move a torn/unparseable claimed request to ``<spool>/dead/``
    with a ``.reason`` file beside it, and return the dead path. A
    request whose BYTES cannot even parse must leave the claim loop
    for good — requeueing it (a restarted host re-adopting its work
    dir, a fleet front retrying a lease) would fail identically
    forever, a crash loop with no exit. The payload is preserved for
    the operator (the reason file says why it landed there); the
    in-band failure row still goes out so a polling client sees the
    failure."""
    dead_dir = os.path.join(spool, "dead")
    os.makedirs(dead_dir, exist_ok=True)
    dead_path = os.path.join(dead_dir, os.path.basename(work_path))
    try:
        os.replace(work_path, dead_path)
    except OSError:
        dead_path = work_path          # already gone: report in place
    reason_path = os.path.join(dead_dir, f"{name}.reason")
    try:
        publish_bytes((reason + "\n").encode("utf-8"), reason_path,
                      site="spool.dead_letter")
    except OSError:
        pass
    return dead_path


def load_claimed(spool: str, name: str, work_path: str) -> Dict:
    """Parse one claimed request file — THE torn-request policy, shared
    by ``serve_spool`` and the fleet front's claim loop: bytes that
    cannot parse are dead-lettered (moved out of the claim loop for
    good) and the error re-raised for the caller's in-band failure
    row."""
    try:
        with open(work_path) as fh:
            return json.load(fh)
    except (OSError, ValueError, UnicodeDecodeError) as exc:
        dead_letter(spool, name, work_path,
                    f"{type(exc).__name__}: {exc}")
        raise


def nonce_result_name(name: str, nonce: Optional[str]) -> str:
    """THE (client nonce, id) result-file recipe — the one place the
    ``<nonce>.<name>`` join lives, shared by the host-side spool
    writer, the fleet front's expected-path computation and its
    failure rows (three sites that must agree byte-for-byte or the
    front polls a path the host never writes)."""
    return f"{nonce}.{name}" if nonce else name


def result_name(name: str, ticket: Ticket) -> str:
    """The out/ filename of one served request: the submitted filename,
    prefixed by the request's client nonce when it carried one — the
    namespacing that stops two clients reusing one filename stem from
    overwriting each other's results."""
    return nonce_result_name(name, getattr(ticket.request, "nonce",
                                           None))


def publish_result(out_dir: str, out_name: str, row: Dict) -> str:
    """Atomically publish one result row at ``<out>/<out_name>`` — THE
    spool result commit (a polling client sees no file or a complete
    one, never a torn row). A registered commit site
    (``spool.result``): the crash hooks of ``core.atomic`` can kill on
    either side of the rename."""
    return publish_json(row, os.path.join(out_dir, out_name),
                        site="spool.result", indent=1)


def write_port_file(port_file: str, port: int) -> str:
    """Atomically publish the bound port for scripts that asked for
    port 0 — a reader either sees no port file or a complete one."""
    return publish_bytes(str(port).encode("utf-8"), port_file,
                         site="spool.port")


def serve_spool(server: JobServer, spool: str, once: bool = False,
                should_stop=None) -> int:
    """Filesystem-spool transport (module docstring). Runs in the
    CALLER's thread — the server owns all worker threads — polling the
    in/ directory, submitting claims, and writing each completed
    ticket's result file as it finishes. Returns the failed-request
    count accumulated over the session.

    ``should_stop`` turning true is the graceful-drain signal: the loop
    stops claiming NEW spool files, finishes every claimed request, and
    returns — what SIGTERM/SIGINT mean for a ``serve --spool``
    session."""
    in_dir, work_dir, out_dir = spool_dirs(spool)
    # startup GC: tmp files a hard-killed session left behind (the age
    # gate keeps a concurrent writer's live tmp safe)
    for d in (in_dir, work_dir, out_dir):
        sweep_stale_tmps(d)
    pending: List[Tuple[str, str, Ticket]] = []
    failures = 0
    while True:
        stopping = should_stop is not None and should_stop()
        if not stopping:
            for name, work_path in _claim(in_dir, work_dir):
                obj = None
                try:
                    obj = load_claimed(spool, name, work_path)
                    req = request_from_json(obj)
                    pending.append((name, work_path, server.submit(req)))
                except Exception as exc:  # noqa: BLE001 — reported in-band
                    # the failure row must honor the nonce namespace
                    # too — a nonce-polling client has to SEE its
                    # failure, and an un-namespaced row could clobber
                    # another client's same-stem result
                    nonce = obj.get("nonce") \
                        if isinstance(obj, dict) else None
                    if not (isinstance(nonce, str)
                            and _NONCE_RE.match(nonce)):
                        nonce = None
                    failed = Ticket(JobRequest(job="<unparsed>", conf={},
                                               inputs=[], output="",
                                               nonce=nonce))
                    failed._complete(error=exc)
                    pending.append((name, work_path, failed))
        still = []
        for name, work_path, ticket in pending:
            if not ticket.done:
                still.append((name, work_path, ticket))
                continue
            row = result_to_json(ticket)
            failures += 0 if row["ok"] else 1
            out_name = result_name(name, ticket)
            publish_result(out_dir, out_name, row)
            try:
                os.remove(work_path)
            except OSError:
                pass
        pending = still
        if stopping and not pending:
            # drained what was claimed; unclaimed spool files stay for
            # the next session — the graceful half of a SIGTERM exit
            return failures
        # only *.json files count as spooled work: a stray temp or dotfile
        # in in/ must not keep --once alive forever
        try:
            spooled = any(n.endswith(".json") for n in os.listdir(in_dir))
        except OSError:
            spooled = False
        if once and not pending and not spooled:
            return failures
        time.sleep(_SPOOL_POLL_SECS)


def install_drain_handlers(stop: threading.Event) -> Callable[[], bool]:
    """SIGTERM/SIGINT set `stop` (graceful drain) instead of killing
    the process mid-serve; a SECOND signal restores the default
    disposition and re-raises, so an operator whose drain is wedged on
    a hung job can still escalate (signal once = drain, twice = die)
    without resorting to SIGKILL's no-teardown exit. Returns
    ``stop.is_set`` as the loop predicate. No-op outside the main
    thread (in-process test harnesses), where the caller drives `stop`
    directly."""
    import os
    import signal

    def _graceful(signum, frame):      # noqa: ARG001 — signal signature
        if stop.is_set():               # second signal: stop draining
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
    except ValueError:                  # not the main thread
        pass
    return stop.is_set


def serve_listen(server: JobServer, listen: str, stop: threading.Event,
                 policy=None, port_file: Optional[str] = None) -> int:
    """One ``serve --listen`` session: start the HTTP edge, run until
    `stop` (the signal handlers' event), then drain gracefully — edge
    refuses new work (healthz flips to draining), in-flight requests
    finish, the final metrics snapshot is the caller's shutdown().
    Returns the failed-request count served over the session."""
    from avenir_tpu_torch.net.listener import NetListener

    host, _, port = listen.rpartition(":")
    listener = NetListener(server, host=host or "127.0.0.1",
                           port=int(port or 0), policy=policy)
    listener.start()
    try:
        print(json.dumps({"server": "listening",
                          "address": listener.address}),
              file=sys.stderr, flush=True)
        if port_file:
            write_port_file(port_file, listener.port)
        while not stop.is_set():
            stop.wait(_SPOOL_POLL_SECS)
        listener.begin_drain()
        server.drain(timeout=86_400.0)
    finally:
        listener.stop()
    return int(server.stats()["failed"])


def serve_main(argv) -> int:
    """`python -m avenir_tpu_torch serve ...` — build the server from flags,
    run one transport session, shut down cleanly. Spool and listen
    sessions drain gracefully on SIGTERM/SIGINT: stop accepting,
    finish in-flight, write the final metrics.json, exit 0."""
    import argparse

    ap = argparse.ArgumentParser(prog="avenir_tpu_torch serve")
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--stdin", action="store_true",
                       help="JSON-lines requests on stdin, results on "
                            "stdout; EOF drains and exits")
    group.add_argument("--spool", default=None,
                       help="spool directory: requests in <dir>/in, "
                            "results in <dir>/out")
    group.add_argument("--listen", default=None,
                       help="HOST:PORT for the JSON-over-HTTP edge "
                            "(port 0 binds an ephemeral port, printed "
                            "as a JSON line on stderr)")
    ap.add_argument("--once", action="store_true",
                    help="spool mode: serve what is spooled, drain, exit")
    ap.add_argument("--budget-mb", type=float,
                    default=DEFAULT_BUDGET_BYTES / (1 << 20),
                    help="admission RSS ceiling (default 3072)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--warm-budget-mb", type=float,
                    default=DEFAULT_WARM_BUDGET_BYTES / (1 << 20),
                    help="pinned encoded-block cache budget (default 256)")
    ap.add_argument("--state-root", default=None,
                    help="managed incremental-checkpoint root (default: "
                         "a per-session temp dir)")
    ap.add_argument("--autotune-dir", default=None,
                    help="autotune profile store (tuned pricer + "
                         "fold-cost-balanced batches; the fleet shares "
                         "one across hosts)")
    ap.add_argument("--device", default=None,
                    help="torch device of every job and score (default "
                         "cuda; 'cpu' runs the plain versions of the "
                         "kernels)")
    ap.add_argument("--metrics", default=None,
                    help="metrics.json snapshot path (default: "
                         "<spool>/metrics.json in spool mode; off for "
                         "--stdin/--listen unless given)")
    ap.add_argument("--metrics-interval", type=float, default=2.0,
                    help="seconds between metrics.json refreshes "
                         "(default 2)")
    ap.add_argument("--shed-mode", choices=("reject", "hold"),
                    default="reject",
                    help="listen mode: edge behavior past the priced "
                         "budget or tenant depth bound — 429 with "
                         "Retry-After, or hold the accept (default "
                         "reject)")
    ap.add_argument("--max-tenant-depth", type=int, default=64,
                    help="listen mode: per-tenant queued-request bound "
                         "before the edge sheds (default 64)")
    ap.add_argument("--port-file", default=None,
                    help="listen mode: write the bound port here "
                         "(atomic), for scripts that asked for port 0")
    args = ap.parse_args(argv)
    metrics_path = args.metrics
    if metrics_path is None and args.spool:
        os.makedirs(args.spool, exist_ok=True)
        metrics_path = os.path.join(args.spool, "metrics.json")
    server = JobServer(budget_bytes=int(args.budget_mb * (1 << 20)),
                       workers=args.workers,
                       warm_budget_bytes=int(
                           args.warm_budget_mb * (1 << 20)),
                       state_root=args.state_root,
                       autotune_dir=args.autotune_dir,
                       metrics_path=metrics_path,
                       metrics_interval_s=args.metrics_interval,
                       device=args.device)
    stop = threading.Event()
    # stdin sessions keep the default signal behavior (Ctrl+C/SIGTERM
    # end them; EOF is their graceful drain) — a drain handler there
    # would absorb the signals while serve_stream blocks on a read it
    # cannot be woken from, leaving the session killable only by EOF
    # or SIGKILL
    should_stop = stop.is_set if args.stdin \
        else install_drain_handlers(stop)
    server.start()
    try:
        if args.stdin:
            failures = serve_stream(server, sys.stdin, sys.stdout)
        elif args.listen is not None:
            from avenir_tpu_torch.net.listener import EdgePolicy

            failures = serve_listen(
                server, args.listen, stop,
                policy=EdgePolicy(shed_mode=args.shed_mode,
                                  max_tenant_depth=args.max_tenant_depth),
                port_file=args.port_file)
        else:
            failures = serve_spool(server, args.spool, once=args.once,
                                   should_stop=should_stop)
    finally:
        server.shutdown()
    print(json.dumps({"server": "done", "failed": failures,
                      "drained": stop.is_set(),
                      "stats": server.stats()}), file=sys.stderr)
    return 1 if failures else 0
