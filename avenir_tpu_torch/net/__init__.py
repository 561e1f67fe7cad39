"""avenir-net: the network front half of the resident job server.

The port of `avenir_tpu/net/` (host code: the jobs and scores it routes
run on each JobServer's device).

Three layers over the transport-agnostic server/spool surface that PR 9
deliberately left open (`ROADMAP.md` "networked, multi-host job-server
fleet"):

- **Listener** (:mod:`avenir_tpu_torch.net.listener`): a stdlib-only
  JSON-over-HTTP/1.1 edge wrapping ``JobServer.submit``/``result``.
  Backpressure is wired to the admission model: a request whose priced
  bytes would push the edge's outstanding total past the server budget,
  or whose tenant queue is past its depth bound, is answered
  ``429 Retry-After`` (or held at the edge, per policy) instead of
  being queued toward OOM. ``GET /metrics`` serves the live snapshot,
  ``GET /healthz`` the drain state.
- **Affinity router** (:mod:`avenir_tpu_torch.net.router`): places requests
  across N server processes by corpus affinity — a tenant's corpus
  keeps hitting the process whose WarmStore already pins its encoded
  blocks and managed checkpoints — against a per-host priced-bytes
  budget *vector* (``price_request_bytes`` generalized to a vector of
  per-host ceilings), with spillover to the least-loaded host with
  headroom and per-profile fold-cost weighting from the autotune store.
- **Fleet** (:mod:`avenir_tpu_torch.net.fleet`): N ``serve --spool``
  subprocesses (same host first; the spool is already host-agnostic),
  a front loop routing requests into per-host spools and rolling the
  per-host ``metrics.json`` snapshots up into one fleet view through
  the additive ``LatencyHistogram.merge`` algebra. Surfaced as
  ``python -m avenir_tpu_torch fleet``; load-tested open-loop by
  ``tools/fleet_load.py``; gated by ``bench_scaling.fleet_tripwire``.
"""

from avenir_tpu_torch.net.fleet import Fleet, ScoreFront, fleet_main
from avenir_tpu_torch.net.listener import EdgePolicy, NetListener
from avenir_tpu_torch.net.router import AffinityRouter, RouterError

__all__ = ["AffinityRouter", "RouterError", "EdgePolicy", "NetListener",
           "Fleet", "ScoreFront", "fleet_main"]
