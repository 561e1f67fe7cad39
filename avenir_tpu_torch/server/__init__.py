"""The port's serving half: the resident job server and the score plane.

- `server/jobserver.py`: the multi-tenant job server (batched shared
  scans, the warm store, byte-budget admission) on one device;
- `server/spool.py`: its hermetic transports (`serve --stdin`,
  `serve --spool`) and the `serve` CLI, with `--listen` behind the HTTP
  edge of `net/listener.py`;
- `server/score.py`: the online score plane. A request is one row
  against one trained artifact, answered in milliseconds from a warm
  model on the device; concurrent requests for one model coalesce into
  one vectorized predict a window.

The ports of `avenir_tpu/server/`.
"""

from avenir_tpu_torch.server.jobserver import (AdmissionError, JobRequest,
                                               JobServer, ServerClosed,
                                               Ticket, compat_key,
                                               price_request_bytes)
from avenir_tpu_torch.server.score import (ModelCache, ScoreError,
                                           ScorePlane, ScoreRequest,
                                           ScoreResult, ScoreTimeout,
                                           load_scorer, model_cache_key,
                                           score_once,
                                           score_request_from_json)
from avenir_tpu_torch.server.spool import (serve_main, serve_spool,
                                           serve_stream)

__all__ = ["AdmissionError", "JobRequest", "JobServer", "ServerClosed",
           "Ticket", "compat_key", "price_request_bytes", "serve_main",
           "serve_spool", "serve_stream", "ModelCache", "ScoreError",
           "ScorePlane", "ScoreRequest", "ScoreResult", "ScoreTimeout",
           "load_scorer", "model_cache_key", "score_once",
           "score_request_from_json"]
