"""The port's stream layer (`avenir_tpu_torch/core/stream.py`) against the
JAX package's on the CPU.

The prefetch contract of `tests/test_stream.py`, run on both packages
side by side: order kept, a worker's error raised at the next pull,
close() joining the worker and raising a pending error (never from GC),
a dead worker failing the pull, abandonment giving every thread back.
Then the port alone: its stall spans and depth key, `CsvBlockReader`'s
chunks against the JAX package's `iter_csv_chunks` at 512 B to 64 KB,
the schema race made certain (a vocabulary grown in block 2 while the
fold waits on its first chunk must raise every time), `SharedScan`'s
error path under a failed worker, and every streamed job family at
`stream.prefetch.depth` 1 and 8 in blocks of a few KB: each file
byte-identical to the depth-2 run and to `avenir_tpu.runner.run_job`'s
(MI and heterogeneity within one unit in the 6th decimal of it, as in
`tests/test_torch_explore.py`).
"""

import gc
import json
import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.core import stream as jstream
from avenir_tpu.core.schema import FeatureSchema as JaxSchema
from avenir_tpu.runner import JobConfig as JaxJobConfig
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu.runner import run_shared as jax_run_shared
from avenir_tpu_torch import obs, runner
from avenir_tpu_torch.core import stream as pstream
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.schema import FeatureSchema
from avenir_tpu_torch.data import (churn_schema, elearn_schema,
                                   generate_churn, generate_elearn,
                                   generate_loyalty_sequences,
                                   generate_markov_chains)
from avenir_tpu_torch.data.generators import (LOYALTY_OBS, LOYALTY_STATES,
                                              MARKOV_STATES)
from avenir_tpu_torch.runner import run_job, run_shared

CPU = "cpu"
PACKAGES = {"jax": jstream, "port": pstream}


def _boom():
    raise RuntimeError("producer died before the first block")
    yield 1                                     # pragma: no cover


def _wait(cond, secs: float = 5.0) -> bool:
    deadline = time.monotonic() + secs
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# ------------------------------------------------------ prefetch contract
@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_prefetched_keeps_order_and_raises_at_the_next_pull(pkg):
    prefetched = PACKAGES[pkg].prefetched
    assert list(prefetched(range(100), depth=3)) == list(range(100))

    def two_then_fail():
        yield 1
        yield 2
        raise RuntimeError("parse failed")

    it = prefetched(two_then_fail())
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="parse failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_close_joins_the_worker_and_raises_a_pending_error(pkg):
    prefetched = PACKAGES[pkg].prefetched
    it = prefetched(_boom(), depth=1)
    with pytest.raises(RuntimeError, match="producer died"):
        it.close()
    assert it._thread is None                   # joined and released
    # a clean close after abandonment is silent, and close() idempotent
    it = prefetched(iter(range(1000)), depth=1)
    assert next(it) == 0
    thread = it._thread
    it.close()
    it.close()
    assert not thread.is_alive()
    # an error the consumer pulled does not raise again at close
    it = prefetched(_boom(), depth=1)
    with pytest.raises(RuntimeError, match="producer died"):
        for _ in it:
            pass
    it.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_garbage_collected_prefetcher_never_raises(pkg, monkeypatch):
    raised = []
    monkeypatch.setattr(sys, "unraisablehook", raised.append)
    it = PACKAGES[pkg].prefetched(_boom(), depth=1)
    thread = it._thread
    assert _wait(lambda: not thread.is_alive())
    del it
    gc.collect()
    assert raised == []


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_dead_worker_with_an_empty_queue_fails_the_pull(pkg):
    mod = PACKAGES[pkg]
    it = mod.prefetched(iter([]), depth=1)
    thread = it._thread
    assert _wait(lambda: not thread.is_alive())
    it._q.get_nowait()                          # lose the end marker
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited without a result"):
        next(it)
    assert time.monotonic() - t0 < 4 * mod._GET_POLL_SECS
    assert it._thread is None


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_abandoned_csv_feeds_give_their_threads_back(pkg, corpora):
    mod = PACKAGES[pkg]
    schema = (churn_schema() if pkg == "port"
              else JaxSchema.from_json(churn_schema().to_json()))
    before = threading.active_count()
    for _ in range(8):
        it = mod.prefetched(mod.iter_csv_chunks(corpora["churn"],
                                                schema, block_bytes=512),
                            depth=1)
        next(it)          # start both workers, then abandon mid-stream
        it.close()
    assert _wait(lambda: threading.active_count() <= before), \
        (threading.active_count(), before)


def test_stall_spans_name_the_slower_stage():
    def slow_source():
        for i in range(4):
            time.sleep(0.02)
            yield i

    with obs.capture() as rec:
        assert list(pstream.prefetched(slow_source(), depth=2)) == \
            [0, 1, 2, 3]
    names = [sp.name for sp in rec.spans()]
    assert names.count("stream.stall.consumer") >= 3
    assert "stream.stall.producer" not in names
    with obs.capture() as rec:
        it = pstream.prefetched([b"a" * 10] * 4, depth=1)
        time.sleep(0.05)      # the worker waits on the full queue meanwhile
        assert list(it) == [b"a" * 10] * 4
    stalls = [sp for sp in rec.spans() if sp.name == "stream.stall.producer"]
    # a block's put carries its bytes (the end marker's, none)
    assert sum(sp.attrs == {"nbytes": 10} for sp in stalls) >= 1
    assert all(sp.dur >= 0.04 for sp in stalls[:1])
    assert all(sp.tid != threading.get_ident() for sp in stalls)


def test_prefetch_depth_key():
    assert pstream.DEFAULT_PREFETCH_DEPTH == jstream.DEFAULT_PREFETCH_DEPTH
    for props, want in (({}, 2), ({"bad.stream.prefetch.depth": "8"}, 8),
                        ({"stream.prefetch.depth": "0"}, 1),
                        ({"bad.stream.prefetch.depth": "3",
                          "stream.prefetch.depth": "5"}, 3)):
        assert pstream.prefetch_depth(JobConfig(props, "bad")) == want
        assert jstream.prefetch_depth(JaxJobConfig(props, "bad")) == want


@pytest.mark.parametrize("block", [512, 4096, 65536])
def test_csv_block_reader_rows_match_jax(corpora, block):
    schema = FeatureSchema.from_json(corpora["mixed_obj"])
    jschema = JaxSchema.from_json(corpora["mixed_obj"])
    got = list(pstream.iter_csv_chunks(corpora["churn"], schema,
                                       block_bytes=block))
    want = list(jstream.iter_csv_chunks(corpora["churn"], jschema,
                                        block_bytes=block))
    assert [len(c) for c in got] == [len(c) for c in want]
    assert sum(len(c) for c in got) == 900
    for a, b in zip(got, want):
        codes, bins = a.feature_codes()
        jcodes, jbins = b.feature_codes()
        np.testing.assert_array_equal(codes, jcodes)
        np.testing.assert_array_equal(a.labels(), b.labels())
        np.testing.assert_array_equal(a.ids(), b.ids())
    # the parse threads grew the shared vocabulary as the JAX one's did
    pay = next(f for f in schema.fields if f.name == "payment")
    jpay = next(f for f in jschema.fields if f.name == "payment")
    assert pay.cardinality == jpay.cardinality


# --------------------------------------------------------- the schema race
def _race_corpus(tmp_path) -> tuple:
    """Churn rows with payment's vocabulary undeclared: the first block
    (5,243 bytes) holds no `good`; block 2 holds the first one."""
    obj = churn_schema().to_json()
    for fld in obj["fields"]:
        if fld["name"] == "payment":
            del fld["cardinality"]
    schema = tmp_path / "s.json"
    schema.write_text(json.dumps(obj))
    lines = generate_churn(400, seed=9, as_csv=True).splitlines(True)
    head, size = [], 0
    for ln in (ln for ln in lines if ",good," not in ln):
        head.append(ln)
        size += len(ln)
        if size > 5243:
            break
    train = tmp_path / "t.csv"
    train.write_text("".join(head) + "".join(lines) * 4)
    return str(schema), str(train)


def test_vocabulary_grown_in_block_two_raises_every_run(tmp_path,
                                                        monkeypatch):
    """The producer runs ahead, made certain: the fold's first consume
    waits until the reader has read block 5, so the parse thread has
    parsed block 2 (and grown the shared vocabulary) before the model is
    sized. The fold must size from the first chunk's own bins and raise."""
    schema, train = _race_corpus(tmp_path)
    props = {"bad.feature.schema.file.path": schema,
             "bad.stream.block.size.mb": "0.005",
             "bad.stream.prefetch.depth": "8"}
    blocks = len(list(pstream.iter_byte_blocks(train, 5242)))
    assert blocks >= 8
    consume = runner._NBDistrFold.consume
    for run in range(3):
        read, ahead = [0], threading.Event()

        def hook():
            read[0] += 1
            if read[0] >= 5:
                ahead.set()

        def waiting_consume(self, ds):
            if self.model is None:
                assert ahead.wait(10), "the reader never got ahead"
            return consume(self, ds)

        monkeypatch.setattr(pstream, "_produce_hook", hook)
        monkeypatch.setattr(runner._NBDistrFold, "consume", waiting_consume)
        with pytest.raises(ValueError, match="vocabulary grew mid-stream"):
            run_job("bayesianDistr", props, [train],
                    str(tmp_path / f"o{run}"), device=CPU)
        assert ahead.is_set()


# -------------------------------------------------- the shared scan's error
def test_shared_scan_raises_the_sinks_error_and_joins_the_worker():
    """A sink raises while the producer has also failed: the sink's error
    propagates (close() must not mask it with the worker's), and the
    worker is joined."""
    def feed():
        yield 1
        yield 2
        raise RuntimeError("producer failed")

    pf = pstream.prefetched(feed(), depth=4)
    thread = pf._thread

    def job_feed():                     # as stream_job_inputs delegates
        yield from pf

    def sink(chunk):
        assert _wait(lambda: not thread.is_alive())
        raise ValueError("sink failed")

    scan = pstream.SharedScan(job_feed())
    scan.add_sink(sink)
    with pytest.raises(ValueError, match="sink failed"):
        scan.run()
    assert pf._thread is None and not thread.is_alive()


# ---------------------------------------------- job families at each depth
def _seq_rows(rows: int = 600) -> str:
    """The JAX package's tests/test_shared_scan.py `_seq` corpus."""
    rng = np.random.default_rng(12)
    states = ["L", "M", "H"]
    out = []
    for i in range(rows):
        up = i % 2 == 0
        s, toks = 1, []
        for _ in range(6):
            p = [0.1, 0.3, 0.6] if up else [0.6, 0.3, 0.1]
            s = int(np.clip(s + rng.choice([-1, 0, 1], p=p), 0, 2))
            toks.append(states[s])
        out.append(f"c{i},{'T' if up else 'F'}," + ",".join(toks) + "\n")
    return "".join(out)


def _text_rows(rows: int, seed: int) -> str:
    """`text,classVal` lines of 8-20 seeded tokens, each class leaning on
    its own quarter of a 400-word vocabulary."""
    rng = np.random.default_rng(seed)
    classes = ("sports", "tech", "food", "travel")
    lines = []
    for _ in range(rows):
        c = int(rng.integers(0, 4))
        n = int(rng.integers(8, 21))
        lean = rng.random(n) < 0.4
        idx = np.where(lean, c * 100 + rng.integers(0, 100, n),
                       rng.integers(0, 400, n))
        lines.append(" ".join(f"w{i}" for i in idx) + "," + classes[c])
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    out = {"dir": d}
    mixed = churn_schema().to_json()
    for fld in mixed["fields"]:
        if fld["name"] == "payment":
            del fld["cardinality"]
    out["mixed_obj"] = mixed
    files = {"churn": generate_churn(900, seed=21, as_csv=True),
             "churn_test": generate_churn(300, seed=22, as_csv=True),
             "elearn": generate_elearn(600, seed=22, as_csv=True),
             "text": _text_rows(500, 5),
             "seq": _seq_rows(),
             "chains": "\n".join(generate_markov_chains(
                 600, seed=21, n_entities=17)) + "\n",
             "loyalty": "\n".join(generate_loyalty_sequences(
                 600, seed=4, tagged=True)[0]) + "\n",
             "mixed.json": json.dumps(mixed),
             "churn.json": json.dumps(churn_schema().to_json()),
             "elearn.json": json.dumps(elearn_schema().to_json())}
    for name, text in files.items():
        (d / name).write_text(text)
        out[name] = str(d / name)
    model = str(d / "nb_model.csv")
    jax_run_job("bayesianDistr",
                {"bad.feature.schema.file.path": out["churn.json"]},
                [out["churn"]], model)
    out["nb_model"] = model
    return out


KB4 = "0.004"
MI_ALGOS = ("mutual.info.maximization,mutual.info.selection,"
            "joint.mutual.info,double.input.symmetric.relevance,min.redundancy.max.relevance")
BYTES_KIND = {
    "markovStateTransitionModel": {
        "mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
        "mst.skip.field.count": "2", "mst.class.labels": "T,F",
        "mst.stream.block.size.mb": "0.003"},
    "frequentItemsApriori": {
        "fia.support.threshold": "0.3", "fia.item.set.length": "2",
        "fia.skip.field.count": "2", "fia.stream.block.size.mb": "0.003"},
    "candidateGenerationWithSelfJoin": {
        "cgs.support.threshold": "0.3", "cgs.item.set.length": "2",
        "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "0.003"},
}


def _families(c):
    """family -> (jobs [(job, props)], input keys, shared?, the families
    whose last %.6f token may differ from the JAX package's by one)."""
    def schema(prefix, name="mixed.json"):
        return {f"{prefix}.feature.schema.file.path": c[name],
                f"{prefix}.stream.block.size.mb": KB4}

    return {
        "nb_tabular": ([("bayesianDistr", schema("bad"))], ["churn"]),
        "nb_text": ([("bayesianDistr", {"bad.tabular.input": "false",
                                        "bad.stream.block.size.mb": KB4})],
                    ["text"]),
        "nb_predictor": ([("bayesianPredictor", {
            **schema("bap", "churn.json"),
            "bap.bayesian.model.file.path": c["nb_model"],
            "bap.validation.mode": "true",
            "bap.positive.class.value": "closed"})], ["churn_test"]),
        "mutual_info": ([("mutualInformation", {
            **schema("mut"), "mut.mutual.info.score.algorithms": MI_ALGOS})],
            ["churn"]),
        "fisher": ([("fisherDiscriminant", schema("fid"))], ["churn"]),
        "cramer": ([("cramerCorrelation", schema("crc"))], ["churn"]),
        "categorical": ([("categoricalCorrelation", schema("cac"))],
                        ["churn"]),
        "heterogeneity": ([("heterogeneityReduction", schema("hrc"))],
                          ["churn"]),
        "numerical": ([("numericalCorrelation",
                        schema("nuc", "elearn.json"))], ["elearn"]),
        "markov_class": ([("markovStateTransitionModel",
                           BYTES_KIND["markovStateTransitionModel"])],
                         ["seq"]),
        "markov_entity": ([("markovStateTransitionModel", {
            "mst.state.list": ",".join(MARKOV_STATES),
            "mst.id.field.ordinals": "0", "mst.seq.start.ordinal": "2",
            "mst.class.attr.ordinal": "1",
            "mst.stream.block.size.mb": KB4})], ["chains"]),
        "hidden_markov": ([("hiddenMarkovModelBuilder", {
            "hmmb.model.states": ",".join(LOYALTY_STATES),
            "hmmb.model.observations": ",".join(LOYALTY_OBS),
            "hmmb.stream.block.size.mb": KB4})], ["loyalty"]),
        "apriori": ([("frequentItemsApriori",
                      BYTES_KIND["frequentItemsApriori"])], ["seq"]),
        "gsp": ([("candidateGenerationWithSelfJoin",
                  BYTES_KIND["candidateGenerationWithSelfJoin"])], ["seq"]),
        "shared_dataset": ([
            ("bayesianDistr", schema("bad")),
            ("mutualInformation", {**schema("mut"),
                                   "mut.mutual.info.score.algorithms":
                                   MI_ALGOS}),
            ("fisherDiscriminant", schema("fid"))], ["churn"]),
        "shared_bytes": (list(BYTES_KIND.items()), ["seq"]),
    }


#: families whose last `%.6f` token the port keeps within one unit of the
#: JAX package's (XLA's float32 log is not torch's)
ONE_UNIT = {"mutualInformation", "heterogeneityReduction"}
FAMILIES = ("nb_tabular", "nb_text", "nb_predictor", "mutual_info", "fisher",
            "cramer", "categorical", "heterogeneity", "numerical",
            "markov_class", "markov_entity", "hidden_markov", "apriori", "gsp",
            "shared_dataset", "shared_bytes")


def _files(outputs) -> dict:
    """basename -> bytes of each output, and of its stamp where it has
    one."""
    got = {}
    for p in outputs:
        for q in (p, p + ".stamp.json"):
            if os.path.exists(q):
                got[os.path.basename(q)] = Path(q).read_bytes()
    return got


def _run(family, c, depth, package="port"):
    """{job: {file: bytes}} of one run of `family` at `depth` (None: the
    default) in its own directory."""
    jobs, keys = _families(c)[family]
    inputs = [c[k] for k in keys]
    work = c["dir"] / f"{family}_{package}_{depth}"
    work.mkdir(exist_ok=True)
    runs = []
    for job, props in jobs:
        props = dict(props)
        if depth is not None:
            prefix = next(iter(props)).split(".")[0]
            props[f"{prefix}.stream.prefetch.depth"] = str(depth)
        out = str(work / (job + (".txt" if job not in (
            "frequentItemsApriori", "candidateGenerationWithSelfJoin")
            else "")))
        runs.append((job, props, out))
    if len(runs) > 1:
        res = (run_shared(runs, inputs, device=CPU) if package == "port"
               else jax_run_shared(runs, inputs))
        return {job: _files(res[job].outputs) for job, _, _ in runs}
    job, props, out = runs[0]
    res = (run_job(job, props, inputs, out, device=CPU) if package == "port"
           else jax_run_job(job, props, inputs, out))
    return {job: _files(res.outputs)}


def _within_one_unit(got: bytes, ref: bytes) -> bool:
    g_lines, r_lines = got.decode().splitlines(), ref.decode().splitlines()
    if len(g_lines) != len(r_lines):
        return False
    for g, r in zip(g_lines, r_lines):
        gt, rt = g.split(","), r.split(",")
        if gt[:-1] != rt[:-1] or round(abs(float(gt[-1])
                                           - float(rt[-1])) * 1e6) > 1:
            return False
    return True


_REFS: dict = {}


def _references(family, c):
    """(the port's depth-2 run, the JAX package's run) of a family, once
    a module."""
    if family not in _REFS:
        _REFS[family] = (_run(family, c, None), _run(family, c, None, "jax"))
    return _REFS[family]


@pytest.mark.parametrize("depth", [1, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_job_family_files_do_not_depend_on_the_prefetch_depth(corpora,
                                                              family, depth):
    two, jax = _references(family, corpora)
    got = _run(family, corpora, depth)
    assert got == two
    assert set(got) == set(jax)
    for job, files in got.items():
        assert files and set(files) == set(jax[job]), job
        for name, data in files.items():
            if job in ONE_UNIT:
                assert _within_one_unit(data, jax[job][name]), (job, name)
            else:
                assert data == jax[job][name], (job, name)
