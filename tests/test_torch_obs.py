"""The port's span recorder and latency histograms (`avenir_tpu_torch/obs`),
the cases of tests/test_obs.py on the port's copies: ring overflow, thread
safety, Chrome export, the disabled no-op, spans on an exception,
`record_min`, `capture`, histogram quantiles, merge and JSON round trip.
Then the counterpart of the reference's span-coverage audit
(`avenir_tpu/obs/coverage.py`): each of the six ported jobs, on a tiny
input, records the mandatory spans read/parse/fold/finish inside its
`job.run`.
"""

import json
import threading

import pytest

from avenir_tpu_torch import obs
from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                   generate_churn, generate_elearn)
from avenir_tpu_torch.obs import trace
from avenir_tpu_torch.obs.histogram import LatencyHistogram
from avenir_tpu_torch.obs.trace import SpanRecorder
from avenir_tpu_torch.pipelines import knn_pipeline
from avenir_tpu_torch.runner import run_job

# ------------------------------------------------------------------- ring
def test_ring_overflow_keeps_newest_spans():
    rec = SpanRecorder(capacity=8)
    for i in range(20):
        rec.record(f"s{i}", t0=float(i), dur=0.001)
    assert len(rec) == 8
    assert rec.dropped == 12
    names = [sp.name for sp in rec.spans()]
    assert names == [f"s{i}" for i in range(12, 20)]  # oldest dropped
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0


def test_ring_is_thread_safe_under_concurrent_records():
    rec = SpanRecorder(capacity=64)
    n_threads, per_thread = 8, 500

    def hammer(k):
        for i in range(per_thread):
            rec.record(f"t{k}", t0=0.0, dur=1e-6)

    threads = [threading.Thread(target=hammer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(rec) == 64
    assert rec.dropped == n_threads * per_thread - 64


def test_chrome_export_schema(tmp_path):
    rec = SpanRecorder(capacity=16)
    rec.record("stream.read", t0=1.0, dur=0.25, attrs={"nbytes": 7})
    rec.record("stream.fold", t0=1.25, dur=0.5)
    path = rec.export_chrome(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    events = doc["traceEvents"]
    assert len(events) == 2
    for ev in events:
        # the Chrome-trace complete-event contract: cat/ph/ts/dur with
        # microsecond timestamps
        assert ev["ph"] == "X"
        assert ev["cat"] == "avenir"
        assert isinstance(ev["ts"], float) and isinstance(ev["dur"], float)
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
    assert events[0]["name"] == "stream.read"
    assert events[0]["ts"] == pytest.approx(1.0e6)
    assert events[0]["dur"] == pytest.approx(0.25e6)
    assert events[0]["args"] == {"nbytes": 7}
    assert doc["metadata"]["dropped_spans"] == 0


def test_record_is_noop_when_disabled():
    with trace.capture() as rec:
        trace.record("on", trace.now())
        prev = trace.set_enabled(False)
        try:
            trace.record("off", trace.now())
            trace.observe("off_hist", 1.0)
            with trace.span("off_span"):
                pass
        finally:
            trace.set_enabled(prev)
        trace.record("on2", trace.now())
    names = [sp.name for sp in rec.spans()]
    assert names == ["on", "on2"]


def test_span_context_manager_records_on_exception():
    with trace.capture() as rec:
        with pytest.raises(RuntimeError):
            with trace.span("risky", tag="x"):
                raise RuntimeError("boom")
    spans = rec.spans()
    assert [sp.name for sp in spans] == ["risky"]
    assert spans[0].attrs == {"tag": "x"}


def test_record_min_suppresses_instant_spans():
    with trace.capture() as rec:
        trace.record_min("stall", trace.now(), min_dur=10.0)   # instant
        trace.record_min("stall", trace.now() - 1.0, min_dur=0.5)
    assert len(rec.spans()) == 1
    assert rec.spans()[0].dur >= 0.5


def test_capture_restores_previous_recorder_and_flag():
    outer = trace.recorder()
    prev = trace.set_enabled(False)
    try:
        with trace.capture() as rec:
            assert trace.enabled()                 # forced on inside
            assert trace.recorder() is rec
        assert trace.recorder() is outer
        assert not trace.enabled()                 # flag restored
    finally:
        trace.set_enabled(prev)


# -------------------------------------------------------------- histograms
def test_histogram_quantiles_exact_on_known_inputs():
    h = LatencyHistogram()
    # 100 samples of one value per decade bucket: every quantile lands
    # on a bucket holding ONE distinct value, so it is exact
    for v, n in ((1.0, 50), (100.0, 45), (10_000.0, 5)):
        for _ in range(n):
            h.add(v)
    assert h.count == 100
    assert h.quantile(0) == 1.0
    assert h.quantile(50) == 1.0
    assert h.quantile(51) == 100.0
    assert h.quantile(95) == 100.0
    assert h.quantile(96) == 10_000.0
    assert h.quantile(99) == 10_000.0
    assert h.quantile(100) == 10_000.0
    assert h.mean == pytest.approx((50 + 4500 + 50_000) / 100.0)
    assert h.min_val == 1.0 and h.max_val == 10_000.0
    with pytest.raises(ValueError):
        h.quantile(101)


def test_histogram_merge_is_associative_and_exact():
    import random

    rng = random.Random(7)
    samples = [rng.lognormvariate(2.0, 1.5) for _ in range(3000)]
    whole = LatencyHistogram().add_many(samples)
    a = LatencyHistogram().add_many(samples[:1000])
    b = LatencyHistogram().add_many(samples[1000:2100])
    c = LatencyHistogram().add_many(samples[2100:])

    def merged(*hs):
        out = LatencyHistogram()
        for h in hs:
            out.merge(h)
        return out

    left = merged(merged(a, b), c)      # (a+b)+c
    right = merged(a, merged(b, c))     # a+(b+c)
    for m in (left, right):
        assert m.counts == whole.counts
        assert m.count == whole.count
        assert m.total == pytest.approx(whole.total)
        assert m.min_val == whole.min_val and m.max_val == whole.max_val
        for p in (50, 95, 99):
            assert m.quantile(p) == pytest.approx(whole.quantile(p))


def test_histogram_empty_and_clamped_values():
    h = LatencyHistogram()
    assert h.summary() == {"count": 0, "mean": 0.0, "min": 0.0,
                           "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
    h.add(0.0)          # below the lowest edge: clamps into bucket 0
    h.add(-1.0)
    assert h.count == 2
    assert h.quantile(50) in (-1.0, -0.5)   # bucket mean stays exact-ish
    assert h.min_val == -1.0


def test_histogram_json_round_trip():
    h = LatencyHistogram().add_many([0.5, 3.0, 3.0, 250.0])
    blob = json.dumps(h.to_dict())
    back = LatencyHistogram.from_dict(json.loads(blob))
    assert back.counts == h.counts and back.sums == h.sums
    assert back.count == h.count and back.total == h.total
    assert back.min_val == h.min_val and back.max_val == h.max_val
    assert back.summary() == h.summary()


def test_package_hist_accessor_is_the_function_not_a_module():
    """The histogram submodule is ``histogram``, not ``hist``: a submodule
    named ``hist`` would shadow the ``obs.hist(name)`` accessor."""
    from avenir_tpu_torch import obs

    assert callable(obs.hist)
    trace.reset_hists()
    try:
        obs.observe("t_pkg_ms", 2.0)
        assert obs.hist("t_pkg_ms").count == 1
        assert obs.hist("t_pkg_never") is None
    finally:
        trace.reset_hists()


def test_process_global_histograms():
    trace.reset_hists()
    try:
        trace.observe("t_obs_ms", 5.0)
        trace.observe("t_obs_ms", 15.0)
        h = trace.hist("t_obs_ms")
        assert h.count == 2
        h.add(1.0)                       # a COPY: the global is untouched
        assert trace.hist("t_obs_ms").count == 2
        assert trace.hist_summaries()["t_obs_ms"]["count"] == 2
        assert trace.hist("never_observed") is None
    finally:
        trace.reset_hists()



def test_same_switch_capacity_and_names_as_the_reference():
    import avenir_tpu.obs.trace as ref

    assert trace.DEFAULT_CAPACITY == ref.DEFAULT_CAPACITY
    assert trace.STALL_MIN_SECS == ref.STALL_MIN_SECS
    assert obs.__all__ == __import__("avenir_tpu.obs").obs.__all__


# ---------------------------------------------------------------- coverage
#: the span names every job must record at least once (the reference's
#: obs/coverage.py MANDATORY_SPANS), inside its job.run
MANDATORY_SPANS = ("stream.read", "stream.parse", "stream.fold",
                   "job.finish")


@pytest.fixture(scope="module")
def job_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_jobs")
    churn, elearn = d / "churn.json", d / "elearn.json"
    churn_schema().save(str(churn))
    elearn_schema().save(str(elearn))
    (d / "churn.csv").write_text(generate_churn(200, seed=3, as_csv=True))
    (d / "train.csv").write_text(generate_elearn(120, seed=4, as_csv=True))
    (d / "test.csv").write_text(generate_elearn(40, seed=5, as_csv=True))
    return d


def _covered(rec, job):
    names = [sp.name for sp in rec.spans()]
    missing = [n for n in MANDATORY_SPANS if n not in names]
    assert not missing, f"{job}: no {missing} span; got {sorted(set(names))}"
    runs = [sp for sp in rec.spans() if sp.name == "job.run"]
    assert [sp.attrs["job"] for sp in runs] == [job]
    end = runs[0].t0 + runs[0].dur
    for sp in rec.spans():          # every span lies inside the job's run
        assert runs[0].t0 <= sp.t0 and sp.t0 + sp.dur <= end + 1e-6, sp


def test_every_pipeline_job_records_read_parse_fold_finish(job_files,
                                                           tmp_path):
    """recordSimilarity, bayesianDistr, bayesianPredictor (feature
    posteriors), featureCondProbJoiner and nearestNeighbor, each stage of
    knn_pipeline run alone under a fresh recorder; a small block size
    makes the streamed inputs take several blocks."""
    props = {"nen.top.match.count": "5", "nen.validation.mode": "true",
             "nen.class.condtion.weighted": "true",
             "stream.block.size.mb": "0.001"}
    pipe = knn_pipeline(props, str(job_files / "train.csv"),
                        str(job_files / "test.csv"), str(tmp_path),
                        schema_path=str(job_files / "elearn.json"),
                        device="cpu")
    for st in pipe.stages:
        with obs.capture() as rec:
            pipe.run(only=st.name)
        _covered(rec, pipe.results[st.name].name)
        reads = [sp for sp in rec.spans() if sp.name == "stream.read"]
        assert all(sp.attrs["nbytes"] > 0 for sp in reads)


@pytest.mark.parametrize("job", ["bayesianDistr", "groupedRecordSimilarity"])
def test_other_jobs_record_read_parse_fold_finish(job_files, tmp_path, job):
    props = {"bad.feature.schema.file.path": str(job_files / "churn.json"),
             "grs.feature.schema.file.path": str(job_files / "churn.json"),
             "grs.group.field.ordinals": "4",
             "bad.stream.block.size.mb": "0.001"}
    with obs.capture() as rec:
        run_job(job, props, [str(job_files / "churn.csv")],
                str(tmp_path / "out"), device="cpu")
    _covered(rec, job)
    if job == "bayesianDistr":      # a fold span a block
        folds = sum(sp.name == "stream.fold" for sp in rec.spans())
        reads = sum(sp.name == "stream.read" for sp in rec.spans())
        assert folds == reads > 1


def test_a_job_without_tracing_records_nothing(job_files, tmp_path):
    props = {"bad.feature.schema.file.path": str(job_files / "churn.json")}
    with obs.capture() as rec:
        prev = obs.set_enabled(False)
        try:
            run_job("bayesianDistr", props, [str(job_files / "churn.csv")],
                    str(tmp_path / "out"), device="cpu")
        finally:
            obs.set_enabled(prev)
    assert rec.spans() == []
