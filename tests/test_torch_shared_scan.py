"""The port's shared scan and stream-fold contract on the CPU, mirroring
tests/test_shared_scan.py on the port, and held to the JAX package.

1. Equivalence: `run_shared` (one read and one parse a chunk, N fold
   sinks) writes outputs byte-identical to one scan a job, with equal
   counters; `profile_pipeline(...).run(fuse=True)` scans the corpus once
   and agrees with the plain run and with the JAX package's.
2. Failure: a refused group falls back to one scan a stage, with
   `on_retry("a+b+c", 1, exc)`; the bad-group errors raise; a raising
   sink closes a generator feed; a chunk's cached codes are frozen.
3. The fold contract (`StreamFoldOps`): a fold checkpointed half-way and
   restored finishes to the bytes of an uninterrupted fold; a checkpoint
   written by the JAX package's fold loads into the port's fold and
   finishes to the JAX bytes; merged shard folds equal the whole file.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core.dataset import Dataset as JaxDataset
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.pipelines import profile_pipeline as jax_profile_pipeline
from avenir_tpu.runner import JobConfig as JaxJobConfig
from avenir_tpu.runner import stream_fold_ops as jax_stream_fold_ops
from avenir_tpu_torch import obs
from avenir_tpu_torch.core import stream
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.core.stream import SharedScan, stream_job_inputs
from avenir_tpu_torch.data import churn_schema, generate_churn
from avenir_tpu_torch.pipelines import profile_pipeline
from avenir_tpu_torch.runner import (Pipeline, Stage, run_job, run_shared,
                                     stream_fold_names, stream_fold_ops)
from test_torch_explore import assert_within_one_unit

CPU = "cpu"
CPU_DEV = torch.device(CPU)
JOBS = {"bayesianDistr": "bad", "mutualInformation": "mut",
        "fisherDiscriminant": "fid"}
MI_ALGOS = "mutual.info.maximization,min.redundancy.max.relevance"


def _churn(tmp_path, rows=1200, moments=False):
    csv = tmp_path / "churn.csv"
    csv.write_text(generate_churn(rows, seed=11, as_csv=True))
    schema = tmp_path / "churn.json"
    sch = churn_schema()
    if moments:                 # acctAge unbinned: NB keeps its moments
        sch.field_by_ordinal(5).bucket_width = None
    sch.save(str(schema))
    return str(csv), str(schema)


def _conf(prefix, schema, block="0.005"):
    return {f"{prefix}.feature.schema.file.path": schema,
            f"{prefix}.stream.block.size.mb": block,
            "mut.mutual.info.score.algorithms": MI_ALGOS}


def _scan_counters(res):
    """A result's counters but what the columnar sidecar served and
    `Mem:PeakRSS`, a measurement of the process, not of the job (held
    above zero here); `Mem:PredictedPeakBytes` stays."""
    assert res.counters["Mem:PeakRSS"] > 0
    return {k: v for k, v in res.counters.items()
            if not k.startswith("Sidecar:") and k != "Mem:PeakRSS"}


def _read(res) -> bytes:
    return b"\n".join(open(p, "rb").read() for p in sorted(res.outputs))


# ------------------------------------------------------------- equivalence
@pytest.mark.parametrize("moments", [False, True])
def test_fused_outputs_byte_identical(tmp_path, moments):
    csv, schema = _churn(tmp_path, moments=moments)
    seq = {job: run_job(job, _conf(p, schema), [csv],
                        str(tmp_path / f"{job}.1"), device=CPU)
           for job, p in JOBS.items()}
    fused = run_shared([(job, _conf(p, schema), str(tmp_path / f"{job}.2"))
                        for job, p in JOBS.items()], [csv], device=CPU)
    assert set(fused) == set(seq)
    packed = max(r.counters["Sidecar:DeltaBlocks"] for r in seq.values())
    assert packed > 1
    for name in seq:
        assert _read(fused[name]) == _read(seq[name]), name
        # the first solo run packed the sidecar; the fused scan replays it
        # for every fold, the solo runs after the first did too
        assert _scan_counters(fused[name]) == _scan_counters(seq[name])
        assert fused[name].counters["Sidecar:HitBlocks"] == packed
        assert fused[name].counters["Sidecar:DeltaBlocks"] == 0


class _Counter:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1


def _scans(run):
    """(result of run(), blocks the stream layer read in it)."""
    prev, counter = stream._produce_hook, _Counter()
    stream._produce_hook = counter
    try:
        return run(), counter.n
    finally:
        stream._produce_hook = prev


def test_profile_pipeline_scans_once_and_matches_jax(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    props = {p + ".stream.block.size.mb": "0.005" for p in JOBS.values()}
    props["mut.mutual.info.score.algorithms"] = MI_ALGOS
    # the sidecar off: every plain run reads its blocks, as the fused one
    props.update({p + ".stream.sidecar": "false" for p in JOBS.values()})
    plain = profile_pipeline(props, csv, str(tmp_path / "w1"),
                             schema_path=schema, device=CPU)
    r1, n1 = _scans(plain.run)
    fused = profile_pipeline(props, csv, str(tmp_path / "w2"),
                             schema_path=schema, device=CPU)
    with obs.capture() as rec:
        r2, n2 = _scans(lambda: fused.run(fuse=True))
    assert set(r1) == set(r2) == set(JOBS)
    for name in r1:
        assert _read(r2[name]) == _read(r1[name]), name
    # one scan, not three: the fused run read each block once
    assert n2 > 1 and n1 == 3 * n2, (n1, n2)
    assert fused.attempts == {name: 1 for name in JOBS}
    dispatch = [sp for sp in rec.spans() if sp.name == "job.dispatch"]
    assert len(dispatch) == 1 and dispatch[0].attrs["mode"] == "shared"
    assert dispatch[0].attrs["chunks"] == n2
    folds = Counter(sp.attrs["sink"] for sp in rec.spans()
                    if sp.name == "stream.fold")
    assert folds == {name: n2 for name in JOBS}
    assert Counter(sp.name for sp in rec.spans())["job.finish"] == 3
    assert obs.hist("chunk_latency_ms").count >= n2
    ref = jax_profile_pipeline(props, csv, str(tmp_path / "jax"),
                               schema_path=schema).run(fuse=True)
    for name in ("bayesianDistr", "fisherDiscriminant"):
        assert _read(r2[name]) == _read(ref[name]), name
    assert_within_one_unit(_read(r2["mutualInformation"]).decode(),
                           _read(ref["mutualInformation"]).decode())


def test_fused_outputs_byte_identical_with_tracing_off(tmp_path):
    csv, schema = _churn(tmp_path, rows=600)
    specs = lambda tag: [(job, _conf(p, schema),  # noqa: E731
                          str(tmp_path / f"{job}_{tag}"))
                         for job, p in JOBS.items()]
    prev = obs.set_enabled(False)
    try:
        off = run_shared(specs("off"), [csv], device=CPU)
    finally:
        obs.set_enabled(prev)
    on = run_shared(specs("on"), [csv], device=CPU)
    for name in off:
        assert _read(on[name]) == _read(off[name])


def test_refused_group_falls_back_with_on_retry(tmp_path):
    csv, schema = _churn(tmp_path, rows=400)
    props = {"bad.stream.block.size.mb": "0.005",
             # disagreeing block sizes: run_shared refuses the group
             "mut.stream.block.size.mb": "0.01",
             "fid.stream.block.size.mb": "0.005"}
    retries = []
    pipe = profile_pipeline(props, csv, str(tmp_path / "w"),
                            schema_path=schema, device=CPU)
    pipe.on_retry = lambda name, attempt, exc: retries.append(
        (name, attempt, str(exc)))
    results = pipe.run(fuse=True)
    assert set(results) == set(JOBS)
    assert [r[:2] for r in retries] == [
        ("bayesianDistr+mutualInformation+fisherDiscriminant", 1)]
    assert retries[0][2].startswith(
        "fused jobs disagree on stream.block.size.mb")
    seq = profile_pipeline(props, csv, str(tmp_path / "s"),
                           schema_path=schema, device=CPU).run()
    for name in results:
        assert _read(results[name]) == _read(seq[name])


def test_run_shared_rejects_bad_groups(tmp_path):
    csv, schema = _churn(tmp_path, rows=200)
    conf = {"bad.feature.schema.file.path": schema,
            "mut.feature.schema.file.path": schema}
    out = str(tmp_path / "x")
    assert stream_fold_names() == sorted(
        [*JOBS, "frequentItemsApriori", "candidateGenerationWithSelfJoin",
         "markovStateTransitionModel"])
    with pytest.raises(ValueError, match="not shared-scan capable"):
        run_shared([("nearestNeighbor", {}, out)], [csv], device=CPU)
    with pytest.raises(ValueError, match="appears twice"):
        run_shared([("bayesianDistr", conf, out),
                    ("org.avenir.bayesian.BayesianDistribution", conf, out)],
                   [csv], device=CPU)
    with pytest.raises(ValueError, match="stream.block.size.mb"):
        run_shared([("bayesianDistr", conf, out),
                    ("mutualInformation",
                     {**conf, "mut.stream.block.size.mb": "1"}, out)],
                   [csv], device=CPU)
    with pytest.raises(ValueError, match="field delimiter"):
        run_shared([("bayesianDistr", conf, out),
                    ("mutualInformation",
                     {**conf, "field.delim.regex": ";"}, out)],
                   [csv], device=CPU)
    other = tmp_path / "other.json"
    other.write_text(open(schema).read())
    with pytest.raises(ValueError, match="schema file"):
        run_shared([("bayesianDistr", conf, out),
                    ("mutualInformation",
                     {**conf, "mut.feature.schema.file.path": str(other)},
                     out)], [csv], device=CPU)
    with pytest.raises(KeyError, match="no registered stream fold"):
        stream_fold_ops("nearestNeighbor")
    assert run_shared([], [csv], device=CPU) == {}


def test_pipeline_groups_only_consecutive_fusable_stages(tmp_path):
    """A stage of another job or another input ends a group: such a stage
    runs on its own, and the fused group's outputs equal the sequential
    run's."""
    csv, schema = _churn(tmp_path, rows=400)
    other = tmp_path / "other.csv"
    other.write_text(generate_churn(300, seed=12, as_csv=True))
    props = {"bad.feature.schema.file.path": schema,
             "mut.feature.schema.file.path": schema,
             "fid.feature.schema.file.path": schema,
             "crc.feature.schema.file.path": schema}
    stages = lambda d: [  # noqa: E731
        Stage("distr", "bayesianDistr", [csv], str(d / "distr.csv")),
        Stage("mi", "mutualInformation", [csv], str(d / "mi.txt")),
        Stage("cramer", "cramerCorrelation", [csv], str(d / "crc.txt")),
        Stage("fisher", "fisherDiscriminant", [csv], str(d / "fid.txt")),
        Stage("fisher2", "fisherDiscriminant", [str(other)],
              str(d / "fid2.txt"))]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    with obs.capture() as rec:
        fused = Pipeline(props, stages(tmp_path / "a"), device=CPU).run(
            fuse=True)
    seq = Pipeline(props, stages(tmp_path / "b"), device=CPU).run()
    for name in seq:
        assert _read(fused[name]) == _read(seq[name]), name
    groups = [sp.attrs["jobs"] for sp in rec.spans()
              if sp.name == "job.dispatch"]
    assert groups == ["bayesianDistr,mutualInformation"]


# --------------------------------------------------------------- failure
def test_raising_sink_closes_a_generator_feed():
    closed = []

    def feed():
        try:
            for i in range(100):
                yield i
        finally:
            closed.append(True)

    seen = []

    def sink(chunk):
        seen.append(chunk)
        if len(seen) == 3:
            raise RuntimeError("boom")

    scan = SharedScan(feed())
    scan.add_sink(sink)
    with pytest.raises(RuntimeError, match="boom"):
        scan.run()
    assert closed == [True] and seen == [0, 1, 2]


def test_raising_fold_closes_the_file_feed(tmp_path):
    """A fold that raises mid-scan leaves no stream generator suspended:
    the block reader's file closes before the error reaches the caller."""
    csv, schema = _churn(tmp_path, rows=600)
    cfg = JobConfig(_conf("bad", schema), "bad")
    feed = stream_job_inputs(cfg, [csv], FeatureSchema.from_file(schema))
    scan = SharedScan(feed)
    scan.add_sink(lambda ds: (_ for _ in ()).throw(ValueError("bad fold")))
    with pytest.raises(ValueError, match="bad fold"):
        scan.run()
    assert feed.gi_frame is None          # the generator ran to its close


def test_chunk_codes_are_frozen_and_shared():
    schema = churn_schema()
    ds = Dataset.from_csv(generate_churn(50, seed=3, as_csv=True), schema)
    codes, bins = ds.feature_codes()
    again, _ = ds.feature_codes(ds.encodable_feature_fields())
    assert again is codes                 # one cached matrix for every fold
    with pytest.raises(ValueError, match="read-only"):
        codes[0, 0] = 1
    jds = JaxDataset.from_csv(generate_churn(50, seed=3, as_csv=True),
                              JaxSchema.from_json(schema.to_json()),
                              engine="python")
    jcodes, jbins = jds.feature_codes()
    np.testing.assert_array_equal(codes, jcodes)
    assert bins == jbins
    assert [f.ordinal for f in ds.numeric_feature_fields()] == \
        [f.ordinal for f in jds.numeric_feature_fields()]


# ---------------------------------------------------------- fold contract
def _chunks(cfg, csv, schema_path, jax=False):
    if jax:
        from avenir_tpu.core.stream import stream_job_inputs as jax_inputs

        schema = JaxSchema.from_file(schema_path)
        return schema, list(jax_inputs(cfg, [csv], schema))
    schema = FeatureSchema.from_file(schema_path)
    return schema, list(stream_job_inputs(cfg, [csv], schema))


def _finish_bytes(fold, out) -> bytes:
    res = fold.finish(str(out))
    return _read(res)


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_checkpoint_restore_and_merge(tmp_path, job, moments):
    csv, schema_path = _churn(tmp_path, rows=900, moments=moments)
    conf = _conf(JOBS[job], schema_path)
    cfg = JobConfig(conf, JOBS[job])
    ops = stream_fold_ops(job)
    schema, chunks = _chunks(cfg, csv, schema_path)
    assert len(chunks) >= 4
    whole = ops.factory(cfg, [csv], schema, CPU_DEV)
    for ds in chunks:
        whole.consume(ds)
    want = _finish_bytes(whole, tmp_path / "whole")
    # interrupted half-way, serialized, restored in a fresh fold
    half = len(chunks) // 2
    first = ops.factory(cfg, [csv], schema, CPU_DEV)
    blob_empty = ops.serialize_state(first)
    for ds in chunks[:half]:
        first.consume(ds)
    blob = ops.serialize_state(first)
    resumed = ops.restore_state(cfg, [csv], blob, device=CPU)
    _, rest = _chunks(cfg, csv, schema_path)
    for ds in rest[half:]:
        resumed.consume(ds)
    assert _finish_bytes(resumed, tmp_path / "resumed") == want
    # a checkpoint before any chunk restores to an empty fold
    fresh = ops.restore_state(cfg, [csv], blob_empty, device=CPU)
    for ds in _chunks(cfg, csv, schema_path)[1]:
        fresh.consume(ds)
    assert _finish_bytes(fresh, tmp_path / "fresh") == want
    # shard folds merged equal the whole file
    a = ops.factory(cfg, [csv], schema, CPU_DEV)
    b = ops.factory(cfg, [csv], schema, CPU_DEV)
    for ds in chunks[:half]:
        a.consume(ds)
    for ds in chunks[half:]:
        b.consume(ds)
    merged = ops.merge_states(a, b)
    assert _finish_bytes(merged, tmp_path / "merged") == want


@pytest.mark.parametrize("moments", [False, True])
@pytest.mark.parametrize("job", sorted(JOBS))
def test_jax_checkpoint_loads_into_the_port(tmp_path, job, moments):
    """A carry serialized by the JAX package's fold half-way through
    loads into the port's fold, which finishes the scan to the bytes of
    the JAX package's uninterrupted fold (MI: its values within one unit
    in the 6th decimal)."""
    csv, schema_path = _churn(tmp_path, rows=900, moments=moments)
    conf = _conf(JOBS[job], schema_path)
    jcfg = JaxJobConfig(conf, JOBS[job])
    jops = jax_stream_fold_ops(job)
    jschema, jchunks = _chunks(jcfg, csv, schema_path, jax=True)
    whole = jops.factory(jcfg, [csv], jschema)
    for ds in jchunks:
        whole.consume(ds)
    want = _read(whole.finish(str(tmp_path / "jax_whole")))
    half = len(jchunks) // 2
    jschema, jchunks = _chunks(jcfg, csv, schema_path, jax=True)
    part = jops.factory(jcfg, [csv], jschema)
    for ds in jchunks[:half]:
        part.consume(ds)
    blob = jops.serialize_state(part)
    cfg = JobConfig(conf, JOBS[job])
    resumed = stream_fold_ops(job).restore_state(cfg, [csv], blob,
                                                 device=CPU)
    _, chunks = _chunks(cfg, csv, schema_path)
    for ds in chunks[half:]:
        resumed.consume(ds)
    got = _finish_bytes(resumed, tmp_path / "port")
    if job == "mutualInformation":
        assert_within_one_unit(got.decode(), want.decode())
    else:
        assert got == want

