"""The port's score plane (`avenir_tpu_torch/server/score.py`) on the CPU.

The first thirteen tests of `tests/test_score.py` mirrored on
device="cpu" against the port's own batch jobs: every row scored through
the coalescing plane equals the batch job's line and a solo score, the
warm cache (exclusive checkout, digest invalidation, format-skew
refusal), the reward journal (atomic append, nonce exactly-once, fold).
Then the port held against the JAX package on the same artifacts: bayes,
discriminant and markov rows byte for byte, bandit pulls within
`tools.bandit_check`'s rule (a group may differ only where a decision
lies within 2 float32 ULP), `model_cache_key` and every `core/keys.py`
recipe equal, reward journals byte-identical and folded alike by both
packages. A publish that fails leaves the old journal whole, and with no
device given the plane wants `cuda` and raises here. Last, the three edge
tests of `tests/test_score.py` (`:449`, `:491`, `:526`) on the port's
job server: `POST /score` over one keep-alive socket, the fleet's
`ScoreFront` minting a reward nonce and closing every thread's socket,
and the score plane in the server's metrics snapshot and the fleet merge.
"""

import json
import math
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core import keys as jax_keys
from avenir_tpu.models.bandits import GroupBanditData as JaxBanditData
from avenir_tpu.server import score as jax_score
from avenir_tpu_torch.core import keys
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                   generate_churn, generate_elearn,
                                   generate_multiclass, multiclass_schema)
from avenir_tpu_torch.models.artifact import (ModelFormatSkew, rm_stamp,
                                              stamp_path, write_stamp)
from avenir_tpu_torch.models.bandits import GroupBanditData, make_bandit_job
from avenir_tpu_torch.models.discriminant import FisherDiscriminant
from avenir_tpu_torch.runner import run_job
from avenir_tpu_torch.server import score as score_mod
from avenir_tpu_torch.server.score import (ModelCache, ScoreError, ScorePlane,
                                           ScoreRequest, _ModelEntry,
                                           append_reward, fold_rewards,
                                           load_reward_journal, load_scorer,
                                           model_cache_key,
                                           reward_journal_path, score_once,
                                           score_request_from_json)
from avenir_tpu_torch.tools import bandit_check

CPU = "cpu"

MST_CONF = {"mst.model.states": "L,M,H",
            "mst.class.label.field.ord": "1",
            "mst.skip.field.count": "2",
            "mst.class.labels": "T,F"}

MARKOV_SCORE_CONF = {"field.delim": ",", "class.labels": "T,F",
                     "log.odds.threshold": "0", "skip.field.count": "2"}

BANDIT_SCORE_CONF = {"field.delim": ",", "algorithm": "greedyRandomBandit",
                     "batch.size": "2", "round": "50",
                     "random.selection.prob": "0.0"}

#: a pull that draws: logLinear epsilon-greedy, three picks a group
BANDIT_DRAW_CONF = {"field.delim": ",", "algorithm": "greedyRandomBandit",
                    "batch.size": "3", "round": "2",
                    "random.selection.prob": "0.6",
                    "prob.reduction.algorithm": "logLinear"}

#: a bounded wait for every thread a test starts
WAIT_S = 60.0


# ---------------------------------------------------------------- fixtures
def _seq_csv(tmp_path, rows=240, seed=12, name="seq.csv"):
    rng = np.random.default_rng(seed)
    states = ["L", "M", "H"]
    csv = tmp_path / name
    with open(csv, "w") as fh:
        for i in range(rows):
            up = i % 2 == 0
            s, toks = 1, []
            for _ in range(6):
                p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
                s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
                toks.append(states[s])
            fh.write(f"c{i},{'T' if up else 'F'}," + ",".join(toks) + "\n")
    return str(csv)


def _markov_model(tmp_path):
    train = _seq_csv(tmp_path, name="train.csv")
    model = str(tmp_path / "mst_model.txt")
    run_job("markovStateTransitionModel", dict(MST_CONF), [train], model,
            device=CPU)
    return model


def _bandit_stats(tmp_path, name="stats.csv"):
    path = str(tmp_path / name)
    with open(path, "w") as fh:
        for g in ("g1", "g2", "g3"):
            fh.write(f"{g},itemA,10,5.0\n{g},itemB,10,1.0\n"
                     f"{g},itemC,4,3.0\n")
    return path


def _ragged_stats(tmp_path, groups=40, seed=5, name="ragged.csv"):
    """2-8 items a group, a fifth untried, rewards with repeats."""
    rng = np.random.default_rng(seed)
    lines = []
    for g in range(groups):
        for a in range(int(rng.integers(2, 9))):
            count = 0 if rng.random() < 0.2 else int(rng.integers(1, 60))
            reward = float(rng.integers(0, 40)) * 2.5
            lines.append(f"g{g},p{a},{count},{reward}")
    path = tmp_path / name
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _nb_model(tmp_path):
    """(schema path, model path, test rows): bayesianDistr on the port."""
    schema = str(tmp_path / "churn.json")
    churn_schema().save(schema)
    train, test = str(tmp_path / "train.csv"), str(tmp_path / "test.csv")
    with open(train, "w") as fh:
        fh.write(generate_churn(400, seed=3, as_csv=True))
    with open(test, "w") as fh:
        fh.write(generate_churn(40, seed=4, as_csv=True))
    res = run_job("bayesianDistr", {"bad.feature.schema.file.path": schema},
                  [train], str(tmp_path / "distr") + os.sep, device=CPU)
    return schema, res.outputs[0], test


def _fisher_model(tmp_path):
    """(model path, ordinal, train rows): fisherDiscriminant on the port."""
    schema = str(tmp_path / "elearn.json")
    elearn_schema().save(schema)
    train = tmp_path / "train.csv"
    train.write_text(generate_elearn(200, seed=5, as_csv=True))
    model = str(tmp_path / "fisher.txt")
    run_job("fisherDiscriminant", {"fid.feature.schema.file.path": schema},
            [str(train)], model, device=CPU)
    ordinal = sorted(FisherDiscriminant.load(model).boundaries)[0]
    return model, ordinal, train.read_text().splitlines()


def _plane_scores(plane, reqs, timeout=WAIT_S):
    """Fire every request concurrently (so windows actually coalesce)
    and return results in request order."""
    out = [None] * len(reqs)
    errs = []

    def worker(i, req):
        try:
            out[i] = plane.score(req, timeout=timeout)
        except Exception as exc:               # surfaced to the assert
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(i, r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 5.0)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


# ------------------------------------------------------- family parity
def test_markov_score_matches_batch_classifier(tmp_path):
    model = _markov_model(tmp_path)
    test = _seq_csv(tmp_path, rows=40, seed=77, name="test.csv")
    out = str(tmp_path / "batch_out.txt")
    run_job("markovModelClassifier",
            {"mmc.mm.model.path": model, "mmc.class.labels": "T,F",
             "mmc.skip.field.count": "2"}, [test], out, device=CPU)
    batch = Path(out).read_text().splitlines()
    rows = Path(test).read_text().splitlines()

    plane = ScorePlane(window_ms=20.0, batch_max=8, device=CPU)
    try:
        reqs = [ScoreRequest("markov", model, r, dict(MARKOV_SCORE_CONF))
                for r in rows]
        got = [res.row for res in _plane_scores(plane, reqs)]
    finally:
        plane.close()
    # coalesced-window output is BIT-identical to the batch job's lines
    assert got == batch
    # ... and to a cold solo score (window of one)
    assert score_once("markov", model, rows[0], dict(MARKOV_SCORE_CONF),
                      device=CPU) == batch[0]


def test_bayes_score_matches_batch_predictor(tmp_path):
    schema, model, test = _nb_model(tmp_path)
    out = str(tmp_path / "pred.txt")
    run_job("bayesianPredictor",
            {"bap.feature.schema.file.path": schema,
             "bap.bayesian.model.file.path": model}, [test], out, device=CPU)
    batch = Path(out).read_text().splitlines()
    rows = Path(test).read_text().splitlines()

    conf = {"schema.path": schema, "field.delim": ","}
    plane = ScorePlane(window_ms=20.0, batch_max=16, device=CPU)
    try:
        got = [res.row for res in _plane_scores(
            plane, [ScoreRequest("bayes", model, r, dict(conf))
                    for r in rows])]
        assert got == batch
        # a row Dataset.from_csv would silently drop (blank) or split
        # (embedded newline) ERRORS instead of shifting the demux ...
        for bad in ("   ", rows[0] + "\n" + rows[1]):
            with pytest.raises(ScoreError):
                plane.score(ScoreRequest("bayes", model, bad,
                                         dict(conf)), timeout=WAIT_S)
        # ... and the dispatcher survives it: the next score still serves
        again = plane.score(ScoreRequest("bayes", model, rows[0],
                                         dict(conf)), timeout=WAIT_S)
        assert again.row == batch[0]
    finally:
        plane.close()
    for i in (0, 17, len(rows) - 1):
        assert score_once("bayes", model, rows[i], dict(conf),
                          device=CPU) == batch[i]


def test_discriminant_score_matches_batch_predict(tmp_path):
    model, ordinal, lines = _fisher_model(tmp_path)
    fd = FisherDiscriminant.load(model)
    rows = lines[:24]
    x = np.asarray([float(r.split(",")[ordinal]) for r in rows], np.float64)
    want = fd.predict_values(ordinal, x)

    conf = {"field.delim": ",", "ordinal": str(ordinal)}
    plane = ScorePlane(window_ms=20.0, batch_max=8, device=CPU)
    try:
        got = [res.row for res in _plane_scores(
            plane, [ScoreRequest("discriminant", model, r, dict(conf))
                    for r in rows])]
    finally:
        plane.close()
    for row, r_in, side in zip(got, rows, want):
        assert row == r_in + "," + str(int(side))
    assert got[3] == score_once("discriminant", model, rows[3], dict(conf),
                                device=CPU)


def test_bandit_score_matches_batch_job(tmp_path):
    stats = _bandit_stats(tmp_path)
    out = str(tmp_path / "select.txt")
    run_job("greedyRandomBandit",
            {"grb.global.batch.size": "2", "grb.current.round.num": "50",
             "grb.random.selection.prob": "0.0"}, [stats], out, device=CPU)
    by_group = {}
    for ln in Path(out).read_text().splitlines():
        by_group.setdefault(ln.split(",")[0], []).append(ln)

    plane = ScorePlane(window_ms=20.0, batch_max=8, device=CPU)
    try:
        got = _plane_scores(
            plane, [ScoreRequest("bandit", stats, g,
                                 dict(BANDIT_SCORE_CONF))
                    for g in ("g1", "g2", "g3")])
    finally:
        plane.close()
    for g, res in zip(("g1", "g2", "g3"), got):
        assert res.row == "\n".join(by_group[g])
        assert res.row == score_once("bandit", stats, g,
                                     dict(BANDIT_SCORE_CONF), device=CPU)
    with pytest.raises(ScoreError):
        score_once("bandit", stats, "no_such_group",
                   dict(BANDIT_SCORE_CONF), device=CPU)


def test_bandit_draws_coalesced_equal_batch_job_and_solo(tmp_path):
    """A pull that draws (logLinear epsilon at round 2) over ragged
    groups: every coalesced answer equals the batch job's select at the
    same round and the group's solo score."""
    stats = _ragged_stats(tmp_path)
    out = str(tmp_path / "select.txt")
    run_job("greedyRandomBandit",
            {"grb.global.batch.size": "3", "grb.current.round.num": "2",
             "grb.random.selection.prob": "0.6",
             "grb.prob.reduction.algorithm": "logLinear"},
            [stats], out, device=CPU)
    by_group = {}
    for ln in Path(out).read_text().splitlines():
        by_group.setdefault(ln.split(",")[0], []).append(ln)
    groups = sorted(by_group, key=lambda g: int(g[1:]))
    plane = ScorePlane(window_ms=20.0, batch_max=16, device=CPU)
    try:
        got = _plane_scores(plane, [
            ScoreRequest("bandit", stats, g, dict(BANDIT_DRAW_CONF))
            for g in groups])
        snap = plane.snapshot()
    finally:
        plane.close()
    assert [r.row for r in got] == ["\n".join(by_group[g]) for g in groups]
    assert snap["stats"]["model_loads"] == 1
    for g in groups[:3]:
        assert score_once("bandit", stats, g, dict(BANDIT_DRAW_CONF),
                          device=CPU) == "\n".join(by_group[g])


# -------------------------------------------------------- coalescing
def test_concurrent_scores_coalesce_into_bounded_dispatches(tmp_path):
    model = _markov_model(tmp_path)
    rows = Path(_seq_csv(tmp_path, rows=24, seed=9, name="q.csv")
                ).read_text().splitlines()
    solo = [score_once("markov", model, r, dict(MARKOV_SCORE_CONF),
                       device=CPU) for r in rows]

    plane = ScorePlane(window_ms=200.0, batch_max=8, device=CPU)
    try:
        got = [res.row for res in _plane_scores(
            plane, [ScoreRequest("markov", model, r,
                                 dict(MARKOV_SCORE_CONF))
                    for r in rows])]
        calls = plane.predict_calls(model)
        snap = plane.snapshot()
    finally:
        plane.close()
    assert got == solo
    # M concurrent scores for one model coalesce into at most
    # ceil(M / batch_max) vectorized dispatches
    assert calls <= math.ceil(len(rows) / 8)
    assert snap["stats"]["scores"] == len(rows)
    assert snap["stats"]["window_rows"] == len(rows)
    # one load served every window (warm cache, not per-request parse)
    assert snap["stats"]["model_loads"] == 1


def test_short_predict_demuxes_error_and_dispatcher_survives(tmp_path,
                                                             monkeypatch):
    """A predict that returns fewer rows than the window has slots is a
    demuxed per-slot ScoreError — never an escaped IndexError that
    kills the sole dispatcher thread and wedges the plane for good."""
    model = str(tmp_path / "fake_model.txt")
    Path(model).write_text("anything\n")

    class _FlakyScorer:
        short = True
        nbytes = 64

        def __init__(self, model_path, conf, device):
            pass

        def predict_rows(self, rows):
            if _FlakyScorer.short:
                return list(rows)[:-1]          # one row vanishes
            return [r + ",ok" for r in rows]

    monkeypatch.setitem(score_mod._SCORERS, "markov", _FlakyScorer)
    plane = ScorePlane(window_ms=0.0, device=CPU)
    try:
        with pytest.raises(ScoreError, match="demux"):
            plane.score(ScoreRequest("markov", model, "a,b", {}),
                        timeout=WAIT_S)
        # the error was counted, the thread lived, the plane still serves
        assert plane.snapshot()["stats"]["errors"] == 1
        _FlakyScorer.short = False
        res = plane.score(ScoreRequest("markov", model, "a,b", {}),
                          timeout=WAIT_S)
        assert res.row == "a,b,ok"
    finally:
        plane.close()                  # a wedged dispatcher would raise


def test_failed_predict_reaches_its_window_and_is_not_cached(tmp_path,
                                                             monkeypatch):
    """A predict that raises at its read-back (where a device failure
    surfaces) fails only its own window's callers; the scorer does not go
    back warm, so the next window loads the model cold."""
    model = str(tmp_path / "fake_model.txt")
    Path(model).write_text("anything\n")

    class _FailingScorer:
        fail = True
        nbytes = 64

        def __init__(self, model_path, conf, device):
            pass

        def predict_rows(self, rows):
            if _FailingScorer.fail:
                raise RuntimeError("CUDA error: an illegal memory access")
            return [r + ",ok" for r in rows]

    monkeypatch.setitem(score_mod._SCORERS, "markov", _FailingScorer)
    plane = ScorePlane(window_ms=0.0, device=CPU)
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            plane.score(ScoreRequest("markov", model, "a,b", {}),
                        timeout=WAIT_S)
        _FailingScorer.fail = False
        assert plane.score(ScoreRequest("markov", model, "a,b", {}),
                           timeout=WAIT_S).row == "a,b,ok"
        snap = plane.snapshot()
    finally:
        plane.close()
    assert snap["stats"]["model_loads"] == 2
    assert snap["stats"]["errors"] == 1
    assert snap["cache"]["entries"] == 1


def test_score_request_rejects_blank_and_multiline_rows():
    base = {"kind": "markov", "model": "m.txt"}
    assert score_request_from_json({**base, "row": "a,b"}).row == "a,b"
    for bad in ("", "   \t", "a,b\nc,d", "a,b\rc,d"):
        with pytest.raises(ValueError):
            score_request_from_json({**base, "row": bad})
    with pytest.raises(ValueError, match="unknown score request fields"):
        score_request_from_json({**base, "row": "a,b", "device": "cpu"})


# ----------------------------------------------------- warm model cache
def test_model_cache_exclusive_checkout_and_eviction():
    cache = ModelCache(budget_bytes=100)
    a = _ModelEntry(("a",), object(), 60)
    b = _ModelEntry(("b",), object(), 60)
    cache.checkin(a)
    # checkout POPS: a second checkout of the same key misses — the
    # budget sweep can never see (so never unload) a checked-out model
    assert cache.checkout(("a",)) is a
    assert cache.checkout(("a",)) is None
    cache.checkin(b)                   # over budget only once a returns
    assert cache.snapshot()["entries"] == 1
    cache.checkin(a)                   # 120 > 100: LRU (b) evicted
    snap = cache.snapshot()
    assert snap["entries"] == 1 and snap["evictions"] == 1
    assert cache.checkout(("b",)) is None
    assert cache.checkout(("a",)) is a


def test_retrain_changes_cache_key_and_forces_reload(tmp_path):
    model = _markov_model(tmp_path)
    k1 = model_cache_key("markov", model, dict(MARKOV_SCORE_CONF))
    row = Path(_seq_csv(tmp_path, rows=4, seed=9, name="q.csv")
               ).read_text().splitlines()[0]
    plane = ScorePlane(window_ms=0.0, device=CPU)
    try:
        plane.score(ScoreRequest("markov", model, row,
                                 dict(MARKOV_SCORE_CONF)), timeout=WAIT_S)
        # retrain over different data: artifact digest moves -> the
        # warm entry is unreachable (key MISS), never stale
        train2 = _seq_csv(tmp_path, rows=240, seed=99, name="t2.csv")
        run_job("markovStateTransitionModel", dict(MST_CONF), [train2],
                model, device=CPU)
        k2 = model_cache_key("markov", model, dict(MARKOV_SCORE_CONF))
        assert k2 != k1
        got = plane.score(ScoreRequest("markov", model, row,
                                       dict(MARKOV_SCORE_CONF)),
                          timeout=WAIT_S)
        assert plane.snapshot()["stats"]["model_loads"] == 2
        assert got.row == score_once("markov", model, row,
                                     dict(MARKOV_SCORE_CONF), device=CPU)
    finally:
        plane.close()
    # conf dims are key dims too
    assert model_cache_key(
        "markov", model,
        {**MARKOV_SCORE_CONF, "log.odds.threshold": "5"}) != k2


def test_format_skew_refuses_and_unstamped_loads(tmp_path):
    model = _markov_model(tmp_path)
    row = Path(_seq_csv(tmp_path, rows=4, seed=9, name="q.csv")
               ).read_text().splitlines()[0]
    conf = dict(MARKOV_SCORE_CONF)
    want = score_once("markov", model, row, conf, device=CPU)
    # a FOREIGN format_version in the stamp refuses the load outright
    stamp = json.loads(Path(stamp_path(model)).read_text())
    stamp["format_version"] = 99
    Path(stamp_path(model)).write_text(json.dumps(stamp))
    with pytest.raises(ModelFormatSkew):
        score_once("markov", model, row, conf, device=CPU)
    assert model_cache_key("markov", model, conf)[4] == 99
    # an UNSTAMPED artifact (pre-stamp seed data) still loads
    rm_stamp(model)
    rm_stamp(model)                    # an absent stamp is fine
    assert score_once("markov", model, row, conf, device=CPU) == want
    assert model_cache_key("markov", model, conf)[4] == 0
    # restamping at this build's version verifies again
    write_stamp(model)
    assert score_once("markov", model, row, conf, device=CPU) == want
    # a digest mismatch (artifact edited under a valid stamp) refuses
    with open(model, "a") as fh:
        fh.write("\n")
    with pytest.raises(ModelFormatSkew):
        score_once("markov", model, row, conf, device=CPU)


def test_concurrent_scores_and_rewards_lose_no_update(tmp_path):
    """Scores and reward appends from more threads than cores, with the
    interpreter switching threads every microsecond: every score is
    answered and counted, and the journal keeps one entry a distinct
    nonce (a lost read-extend-publish would drop one)."""
    stats = _bandit_stats(tmp_path)
    conf = dict(BANDIT_SCORE_CONF)
    n_threads, n_each = 4 * (os.cpu_count() or 1) + 4, 6
    errs, got = [], []
    old = sys.getswitchinterval()
    plane = ScorePlane(window_ms=1.0, batch_max=8, device=CPU)

    def worker(k):
        try:
            for j in range(n_each):
                if j % 2:
                    plane.reward(ScoreRequest(
                        "bandit", stats, f"g{1 + k % 3},itemC,1.0",
                        conf, action="reward", req_id=f"n{k}-{j % 3}"))
                else:
                    g = f"g{1 + (k + j) % 3}"
                    got.append((g, plane.score(ScoreRequest(
                        "bandit", stats, g, conf), timeout=WAIT_S).row))
        except Exception as exc:               # surfaced to the assert
            errs.append(exc)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(2 * WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        plane.close()
    assert not errs, errs
    snap = plane.snapshot()["stats"]
    n_scores = n_threads * ((n_each + 1) // 2)
    assert snap["scores"] == len(got) == n_scores
    assert snap["rewards"] == n_threads * (n_each // 2)
    nonces = [e["nonce"] for e in load_reward_journal(stats)]
    # j = 1, 3, 5 use nonces n{k}-1, n{k}-0, n{k}-2: three distinct
    assert sorted(nonces) == sorted({f"n{k}-{j % 3}" for k in
                                     range(n_threads) for j in (1, 3, 5)})
    # every answer is its own group's: no slot took another's row
    assert all({ln.split(",")[0] for ln in row.split("\n")} == {g}
               for g, row in got)


# -------------------------------------------------------- reward journal
def test_reward_journal_append_fold_and_nonce(tmp_path):
    stats = _bandit_stats(tmp_path)
    ack = append_reward(stats, "g1", "itemB", 9.0, count=2, nonce="n1")
    assert ack == {"applied": True, "entries": 1}
    # the SAME nonce dedupes: a retried append is exactly-once
    assert append_reward(stats, "g1", "itemB", 9.0, count=2,
                         nonce="n1") == {"applied": False, "entries": 1}
    append_reward(stats, "g2", "itemA", 2.0)
    assert len(load_reward_journal(stats)) == 2

    rows = [[t.strip() for t in ln.split(",")]
            for ln in Path(stats).read_text().splitlines()]
    data = GroupBanditData.from_rows(rows, count_ord=2, reward_ord=3)
    gi = list(data.group_ids).index("g1")
    ai = list(data.item_ids[gi]).index("itemB")
    before = float(data.rewards[gi, ai])
    fold_rewards(data, load_reward_journal(stats))
    # counts add; avg reward re-weights by the observation count
    assert int(data.counts[gi, ai]) == 12
    assert float(data.rewards[gi, ai]) == pytest.approx(
        (before * 10 + 9.0) / 12, rel=1e-6)
    with pytest.raises(ScoreError):
        fold_rewards(data, [{"group": "gX", "item": "i", "reward": 1.0}])


def test_append_refuses_to_publish_over_corrupt_journal(tmp_path):
    stats = _bandit_stats(tmp_path)
    append_reward(stats, "g1", "itemB", 9.0, nonce="n1")
    with open(reward_journal_path(stats), "w") as fh:
        fh.write("{torn")
    # READERS treat unparseable as absent (racing delete/truncation)...
    assert load_reward_journal(stats) == []
    # ...but the WRITER's read-extend-publish must not overwrite reward
    # history it cannot read with a journal of only the new entry
    with pytest.raises(ModelFormatSkew):
        append_reward(stats, "g2", "itemA", 1.0)
    assert Path(reward_journal_path(stats)).read_text() == "{torn"


def test_reward_append_shifts_next_bandit_pull(tmp_path):
    stats = _bandit_stats(tmp_path)
    conf = dict(BANDIT_SCORE_CONF, **{"batch.size": "1"})
    before = score_once("bandit", stats, "g1", conf, device=CPU)
    k1 = model_cache_key("bandit", stats, conf)
    plane = ScorePlane(window_ms=0.0, device=CPU)
    try:
        assert plane.score(ScoreRequest("bandit", stats, "g1", conf),
                           timeout=WAIT_S).row == before
        # a huge observed reward on the cold arm moves the greedy pick;
        # the journal digest is a KEY dim, so the warm stats go
        # unreachable and the next pull folds the new evidence
        plane.reward(ScoreRequest("bandit", stats, "g1,itemB,500,5",
                                  conf, action="reward", req_id="r1"))
        assert model_cache_key("bandit", stats, conf) != k1
        after = plane.score(ScoreRequest("bandit", stats, "g1", conf),
                            timeout=WAIT_S).row
        snap = plane.snapshot()
    finally:
        plane.close()
    assert after != before
    assert after.split(",")[1] == "itemB"
    assert snap["stats"]["model_loads"] == 2
    assert after == score_once("bandit", stats, "g1", conf, device=CPU)


# ------------------------------------------- the port against the JAX package
@pytest.mark.parametrize("case", ["bayes", "bayes_continuous",
                                  "discriminant", "markov"])
def test_score_once_rows_equal_jax(tmp_path, case):
    """The same artifact and rows scored solo by both packages: every
    row byte for byte, and the same rows as one window. NB also with
    three continuous fields, whose log densities sum over the fields."""
    kind = case.split("_")[0]
    if case == "bayes":
        schema, model, test = _nb_model(tmp_path)
        rows = Path(test).read_text().splitlines()
        conf = {"schema.path": schema, "field.delim": ",",
                "predict.class.cost": "2,1",
                "predict.class": "open,closed"}
    elif case == "bayes_continuous":
        schema = str(tmp_path / "multi.json")
        multiclass_schema(5, 3).save(schema)
        train = tmp_path / "train.csv"
        train.write_text(generate_multiclass(600, 5, 3, seed=3, as_csv=True))
        model = run_job("bayesianDistr",
                        {"bad.feature.schema.file.path": schema},
                        [str(train)], str(tmp_path / "distr") + os.sep,
                        device=CPU).outputs[0]
        rows = generate_multiclass(30, 5, 3, seed=4,
                                   as_csv=True).splitlines()
        conf = {"schema.path": schema, "field.delim": ","}
    elif kind == "discriminant":
        model, ordinal, rows = _fisher_model(tmp_path)
        rows = rows[:30]
        conf = {"field.delim": ",", "ordinal": str(ordinal)}
    else:
        model = _markov_model(tmp_path)
        rows = Path(_seq_csv(tmp_path, rows=30, seed=77, name="q.csv")
                    ).read_text().splitlines()
        conf = dict(MARKOV_SCORE_CONF)
    port_scorer = load_scorer(kind, model, dict(conf), device=CPU)
    jax_scorer = jax_score.load_scorer(kind, model, dict(conf))
    args = (dict(conf),) if kind == "discriminant" else ()
    got = [port_scorer.predict_rows([r], *args)[0] for r in rows]
    assert got == [jax_scorer.predict_rows([r], *args)[0] for r in rows]
    # the whole set as one window, and a cold score_once, the same
    assert port_scorer.predict_rows(rows, *args) == got
    assert score_once(kind, model, rows[1], dict(conf), device=CPU) \
        == jax_score.score_once(kind, model, rows[1], dict(conf))


@pytest.mark.parametrize("algo", ["logLinear", "softMaxBandit",
                                  "auerDeterministic"])
def test_bandit_pulls_agree_with_jax(tmp_path, algo):
    """Every group's pull through both packages' scorers: equal but in
    groups where a decision lies within 2 float32 ULP of another
    (`bandit_check.near_tie_groups`)."""
    stats = _ragged_stats(tmp_path, groups=60, seed=11)
    conf = {"logLinear": dict(BANDIT_DRAW_CONF),
            "softMaxBandit": {"field.delim": ",",
                              "algorithm": "softMaxBandit",
                              "batch.size": "3", "round": "4",
                              "temp.constant": "12.5"},
            "auerDeterministic": {"field.delim": ",",
                                  "algorithm": "auerDeterministic",
                                  "batch.size": "2", "round": "10"}}[algo]
    lines = Path(stats).read_text().splitlines()
    groups = list(dict.fromkeys(ln.split(",")[0] for ln in lines))
    port_rows = load_scorer("bandit", stats, dict(conf),
                            device=CPU).predict_rows(groups, dict(conf))
    jax_rows = jax_score.load_scorer("bandit", stats, dict(conf)
                                     ).predict_rows(groups, dict(conf))
    differ = np.array([a != b for a, b in zip(port_rows, jax_rows)])
    data = GroupBanditData.from_lines(lines)
    kw = ({"random_selection_prob": 0.6,
           "prob_reduction_algorithm": "logLinear"}
          if algo == "logLinear" else
          {"temp_constant": 12.5} if algo == "softMaxBandit" else {})
    name = "greedyRandomBandit" if algo == "logLinear" else algo
    batch, rnd = int(conf["batch.size"]), int(conf["round"])
    sel = make_bandit_job(name, batch, device=CPU, **kw).select(data, rnd)
    near = bandit_check.near_tie_groups(
        make_bandit_job(name, batch, device=CPU, **kw), data, rnd, sel)
    assert len(port_rows) == len(groups) == len(near)
    assert not (differ & ~near).any(), (differ.sum(), near.sum())


def test_model_cache_key_equals_jax(tmp_path):
    schema, nb_model, _ = _nb_model(tmp_path)
    markov = _markov_model(tmp_path)
    stats = _bandit_stats(tmp_path)
    cases = [("bayes", nb_model, {"schema.path": schema,
                                  "predict.class.cost": "2,1"}),
             ("markov", markov, dict(MARKOV_SCORE_CONF)),
             ("discriminant", markov, {"field.delim": ";"}),
             ("bandit", stats, dict(BANDIT_SCORE_CONF))]
    for kind, model, conf in cases:
        assert model_cache_key(kind, model, conf) \
            == jax_score.model_cache_key(kind, model, conf)
    append_reward(stats, "g1", "itemA", 3.0, nonce="k")
    rm_stamp(markov)
    for kind, model, conf in cases:
        assert model_cache_key(kind, model, conf) \
            == jax_score.model_cache_key(kind, model, conf)


def test_keys_equal_jax(tmp_path):
    assert keys.VIEW_NEUTRAL_KEYS == jax_keys.VIEW_NEUTRAL_KEYS
    for k in ("fia.incremental.state.dir", "stream.autotune.dir",
              "bad.stream.block.size.mb", ""):
        assert keys.is_view_neutral(k) == jax_keys.is_view_neutral(k)
    assert keys.key_site("score.model") == jax_keys.key_site("score.model")
    schema = tmp_path / "s.json"
    schema.write_text('{"fields": []}\n')
    props = {"bad.feature.schema.file.path": str(schema),
             "bad.stream.block.size.mb": "4",
             "bad.incremental.state.dir": "/x", "field.delim": ","}
    from avenir_tpu.core.config import JobConfig as JaxJobConfig
    for prefix in ("bad", ""):
        assert keys.conf_digest(JobConfig(props, prefix)) \
            == jax_keys.conf_digest(JaxJobConfig(props, prefix))
    gone = {**props, "bad.feature.schema.file.path": str(tmp_path / "no")}
    assert keys.conf_digest(JobConfig(gone, "bad")) \
        == jax_keys.conf_digest(JaxJobConfig(gone, "bad"))
    inputs = ["a.csv", str(tmp_path / "b.csv")]
    assert keys.state_digest("bayesianDistr", inputs) \
        == jax_keys.state_digest("bayesianDistr", inputs)
    assert keys.corpus_digest(inputs) == jax_keys.corpus_digest(inputs)
    for args in ((1, "dataset", ",", 4 << 20, "abc"),
                 (2, "bytes", ";", 1 << 20, 3)):
        assert keys.sidecar_config_digest(*args) \
            == jax_keys.sidecar_config_digest(*args)
    assert keys.compat_tuple("stream", inputs, "dataset", 4.0000001, ",",
                             str(schema)) \
        == jax_keys.compat_tuple("stream", inputs, "dataset", 4.0000001,
                                 ",", str(schema))
    assert keys.source_tuple("apriori", inputs, ",", 1, None, -1) \
        == jax_keys.source_tuple("apriori", inputs, ",", 1, None, -1)
    assert keys.model_tuple("bandit", "m.txt", "d", "", 1, (",", 2, None)) \
        == jax_keys.model_tuple("bandit", "m.txt", "d", "", 1,
                                (",", 2, None))


def test_reward_journals_byte_identical_and_fold_alike(tmp_path):
    """The same appends through each package give the same journal
    bytes, and each package folds the other's journal to the same
    stats."""
    port_stats = _bandit_stats(tmp_path, "port.csv")
    jax_stats = _bandit_stats(tmp_path, "jax.csv")
    appends = [("g1", "itemB", 9.0, 2, "n1"), ("g2", "itemA", 2.5, 1, None),
               ("g1", "itemB", 9.0, 2, "n1"), ("g3", "itemC", 0.1, 7, "n2")]
    for g, it, r, c, nonce in appends:
        assert append_reward(port_stats, g, it, r, count=c, nonce=nonce) \
            == jax_score.append_reward(jax_stats, g, it, r, count=c,
                                       nonce=nonce)
    assert Path(reward_journal_path(port_stats)).read_bytes() \
        == Path(reward_journal_path(jax_stats)).read_bytes()
    rows = [[t.strip() for t in ln.split(",")]
            for ln in Path(port_stats).read_text().splitlines()]
    port_data = GroupBanditData.from_rows(rows)
    jax_data = JaxBanditData.from_rows(rows)
    fold_rewards(port_data, jax_score.load_reward_journal(jax_stats))
    jax_score.fold_rewards(jax_data, load_reward_journal(port_stats))
    np.testing.assert_array_equal(port_data.counts,
                                  np.asarray(jax_data.counts))
    assert port_data.rewards.tobytes() \
        == np.asarray(jax_data.rewards, np.float32).tobytes()


def test_failed_publish_keeps_old_journal_whole(tmp_path, monkeypatch):
    stats = _bandit_stats(tmp_path)
    append_reward(stats, "g1", "itemB", 9.0, nonce="n1")
    before = Path(reward_journal_path(stats)).read_bytes()
    listing = sorted(os.listdir(tmp_path))

    def refuse(src, dst):
        raise OSError("rename refused")

    monkeypatch.setattr(os, "replace", refuse)
    with pytest.raises(OSError, match="rename refused"):
        append_reward(stats, "g2", "itemA", 1.0, nonce="n2")
    monkeypatch.undo()
    assert Path(reward_journal_path(stats)).read_bytes() == before
    assert sorted(os.listdir(tmp_path)) == listing          # no tmp left
    assert [e["nonce"] for e in load_reward_journal(stats)] == ["n1"]


def test_no_device_given_wants_cuda(tmp_path, monkeypatch):
    """With no device the plane and its scorers want `cuda`: where there
    is none they raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = _markov_model(tmp_path)
    row = "c0,T,L,M,H"
    with pytest.raises(RuntimeError, match="CUDA device"):
        ScorePlane()
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_scorer("markov", model, dict(MARKOV_SCORE_CONF))
    with pytest.raises(RuntimeError, match="CUDA device"):
        score_once("markov", model, row, dict(MARKOV_SCORE_CONF))
    assert not [t for t in threading.enumerate()
                if t.name == "score-dispatch"]


# ------------------------------------------------- HTTP edge + metrics
def test_post_score_keepalive_two_requests_one_socket(tmp_path):
    """`POST /score` on the port's NetListener over a CPU JobServer: two
    scores ride one HTTP/1.1 keep-alive socket, each the solo score of
    both packages; an unknown field is a strict 400 on the same socket."""
    import http.client

    from avenir_tpu_torch.net.listener import NetListener
    from avenir_tpu_torch.server import JobServer

    model = _markov_model(tmp_path)
    rows = open(_seq_csv(tmp_path, rows=4, seed=9, name="q.csv")
                ).read().splitlines()
    want = [score_once("markov", model, r, dict(MARKOV_SCORE_CONF),
                       device=CPU) for r in rows[:2]]
    assert want == [jax_score.score_once("markov", model, r,
                                         dict(MARKOV_SCORE_CONF))
                    for r in rows[:2]]
    srv = JobServer(state_root=str(tmp_path / "srv"), workers=1,
                    device=CPU)
    try:
        with NetListener(srv, port=0) as lis:
            conn = http.client.HTTPConnection("127.0.0.1", lis.port,
                                              timeout=60)
            socks = []
            for i, row in enumerate(rows[:2]):
                conn.request(
                    "POST", "/score",
                    json.dumps({"kind": "markov", "model": model,
                                "row": row,
                                "conf": MARKOV_SCORE_CONF}).encode(),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                assert resp.status == 200 and body["row"] == want[i]
                socks.append(conn.sock)
            assert socks[0] is socks[1] and socks[0] is not None
            conn.request("POST", "/score",
                         json.dumps({"kind": "markov", "model": model,
                                     "row": rows[0], "oops": 1}).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 400
            resp.read()
            assert conn.sock is socks[0]
            conn.close()
    finally:
        srv.shutdown()


def test_score_front_mints_reward_nonce_and_closes_all_threads(tmp_path):
    """`net.fleet.ScoreFront` over one port listener: a reward with no
    req_id gets a minted nonce (its retry can never apply twice), and
    close() reaches the keep-alive sockets every thread opened."""
    from avenir_tpu_torch.net.fleet import ScoreFront
    from avenir_tpu_torch.net.listener import NetListener
    from avenir_tpu_torch.server import JobServer

    stats = _bandit_stats(tmp_path)
    srv = JobServer(state_root=str(tmp_path / "srv"), workers=1,
                    device=CPU)
    try:
        with NetListener(srv, port=0) as lis:
            front = ScoreFront([f"http://127.0.0.1:{lis.port}"])
            ack = front.score("bandit", stats, "g1,itemB,9.0,2",
                              conf=dict(BANDIT_SCORE_CONF),
                              action="reward")
            assert ack["applied"] is True
            entries = load_reward_journal(stats)
            assert len(entries) == 1 and entries[0]["nonce"]
            t = threading.Thread(
                target=front.score,
                args=("bandit", stats, "g1"),
                kwargs={"conf": dict(BANDIT_SCORE_CONF)})
            t.start()
            t.join(WAIT_S)
            conns = list(front._all_conns)
            assert len(conns) == 2            # one per (thread, host)
            front.close()
            assert front._all_conns == []
            assert all(c.sock is None for c in conns)
    finally:
        srv.shutdown()


def test_metrics_snapshot_and_fleet_merge_carry_score(tmp_path):
    """The server's metrics snapshot carries the score plane's counters
    and per-model histograms, and the fleet merge (`obs.report`) sums
    the counters and folds the histograms exactly."""
    from avenir_tpu_torch.obs.report import merge_snapshots
    from avenir_tpu_torch.server import JobServer

    model = _markov_model(tmp_path)
    row = open(_seq_csv(tmp_path, rows=4, seed=9, name="q.csv")
               ).read().splitlines()[0]
    srv = JobServer(state_root=str(tmp_path / "srv"), workers=1,
                    device=CPU)
    try:
        plane = srv.score_plane(window_ms=0.0)
        assert plane.device == torch.device(CPU)
        plane.score(ScoreRequest("markov", model, row,
                                 dict(MARKOV_SCORE_CONF)))
        snap = srv.metrics_snapshot()
    finally:
        srv.shutdown()
    assert snap["score"]["stats"]["scores"] == 1
    name = os.path.splitext(os.path.basename(model))[0]
    assert f"score_{name}_total_ms" in snap["hists"]
    assert snap["score"]["per_model_predicts"][name] == 1
    merged = merge_snapshots([snap, snap])
    assert merged["score"]["stats"]["scores"] == 2
    assert merged["score"]["per_model_predicts"][name] == 2
    assert merged["hists"][f"score_{name}_total_ms"]["count"] == 2
