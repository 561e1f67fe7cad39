"""The port's serving half: the online score plane (`server/score.py`).

A request is one row against one trained artifact, answered in
milliseconds from a warm model on the device; concurrent requests for one
model coalesce into one vectorized predict a window. The JAX package's
job server, its spool and its HTTP edge are not ported yet.
"""

from avenir_tpu_torch.server.score import (ModelCache, ScoreError,
                                           ScorePlane, ScoreRequest,
                                           ScoreResult, ScoreTimeout,
                                           load_scorer, model_cache_key,
                                           score_once,
                                           score_request_from_json)

__all__ = ["ModelCache", "ScoreError", "ScorePlane", "ScoreRequest",
           "ScoreResult", "ScoreTimeout", "load_scorer", "model_cache_key",
           "score_once", "score_request_from_json"]
