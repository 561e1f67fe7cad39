"""`run_sharded` on the CPU (`device="cpu"`, two worker processes), held
against the JAX package: the six stream folds' artifacts byte for byte
(mutual information, markov per class, Apriori with and without its
trans-ids level, and GSP against the port's solo run and the JAX
package's `run_job`; Naive Bayes with float moments and Fisher against
the reference's own `run_sharded` at the same plan, and against the solo
run where the reference's sharded and solo bytes agree), and the
deterministic `Shard:*` and `Cache:*` counters against the reference's.
The chains and baskets are drawn from a seed with skewed state and item
weights and lengths of 2 to 8, so transitions and supports differ from
row to row: a block merged out of order, or lost from a count and its
row total alike, changes the bytes. Every run has its own `timeout_s`."""

import os

import numpy as np
import pytest
import torch_reference_native  # noqa: F401  (settles the reference's native route)

from avenir_tpu_torch.dist import StragglerPolicy, run_sharded
from avenir_tpu_torch.runner import run_job

CPU = "cpu"
#: a quiet policy: no mirroring on a slow first fold of a loaded box
QUIET = dict(mirror_floor_s=60.0)
TIMEOUT_S = 150.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from avenir_tpu.data import churn_schema, generate_churn

    d = tmp_path_factory.mktemp("dist_run")
    csv = str(d / "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(2500, seed=17, as_csv=True))
    schema = str(d / "churn.json")
    churn_schema().save(schema)
    moments = str(d / "churn_moments.json")
    sch = churn_schema()
    sch.field_by_ordinal(5).bucket_width = None     # NB keeps moments
    sch.save(moments)
    rng = np.random.default_rng(23)
    seq, baskets = str(d / "seq.csv"), str(d / "baskets.csv")
    for path, alphabet, weights in (
            (seq, "LMH", [0.5, 0.3, 0.2]),
            (baskets, "ABCDEFGH",
             [0.26, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05, 0.04])):
        with open(path, "w") as fh:
            for i in range(1500):
                toks = rng.choice(len(alphabet), size=int(rng.integers(2, 9)),
                                  p=weights)
                label = "T" if rng.random() < 0.4 else "F"
                fh.write(f"c{i},{label},"
                         + ",".join(alphabet[t] for t in toks) + "\n")
    return {"csv": csv, "schema": schema, "moments": moments, "seq": seq,
            "baskets": baskets}


def _files(res):
    return [open(p, "rb").read() for p in sorted(res.outputs)]


def _sharded(job, conf, inputs, out, **kw):
    kw.setdefault("policy", StragglerPolicy(**QUIET))
    return run_sharded(job, conf, inputs, out, procs=2, factor=2,
                       device=CPU, timeout_s=TIMEOUT_S, **kw)


MARKOV = {"mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
          "mst.skip.field.count": "2", "mst.class.labels": "T,F",
          "mst.stream.block.size.mb": "0.005"}
FIA = {"fia.support.threshold": "0.2", "fia.item.set.length": "3",
       "fia.skip.field.count": "2", "fia.stream.block.size.mb": "0.005"}
CGS = {"cgs.support.threshold": "0.15", "cgs.item.set.length": "3",
       "cgs.skip.field.count": "2", "cgs.stream.block.size.mb": "0.005"}


def test_mutual_information_byte_identical(corpus, tmp_path):
    from avenir_tpu.runner import run_job as jax_run_job

    conf = {"mut.feature.schema.file.path": corpus["schema"],
            "mut.mutual.info.score.algorithms": "mutual.info.maximization"}
    jax_run_job("mutualInformation", conf, [corpus["csv"]],
                str(tmp_path / "jax.txt"))
    solo = run_job("mutualInformation", conf, [corpus["csv"]],
                   str(tmp_path / "solo.txt"), device=CPU)
    res = _sharded("mutualInformation", conf, [corpus["csv"]],
                   str(tmp_path / "sharded.txt"))
    assert _files(res) == _files(solo) == \
        [open(tmp_path / "jax.txt", "rb").read()]
    c = res.counters
    assert (c["Shard:Blocks"], c["Shard:DedupBlocks"], c["Shard:Workers"],
            c["Shard:MirroredBlocks"]) == (4.0, 0.0, 2.0, 0.0)
    assert c["Shard:MergeMs"] > 0 and c["Shard:ScanSeconds"] > 0
    stats = res.payload["workers"]
    assert sorted(s["worker"] for s in stats) == [0, 1]
    assert all(s["device"] == "cpu" and s["scan_s"] > 0 for s in stats)
    assert sum(s["folded"] for s in stats) == 4
    # on the CPU the wrappers run their plain versions: no launch
    assert all(n == 0 for s in stats for n in s["launches"].values())


def test_markov_bytes_family_byte_identical(corpus, tmp_path):
    from avenir_tpu.runner import run_job as jax_run_job

    want = jax_run_job("markovStateTransitionModel", MARKOV, [corpus["seq"]],
                       str(tmp_path / "jax.txt"))
    solo = run_job("markovStateTransitionModel", MARKOV, [corpus["seq"]],
                   str(tmp_path / "solo.txt"), device=CPU)
    res = _sharded("markovStateTransitionModel", MARKOV, [corpus["seq"]],
                   str(tmp_path / "sharded.txt"))
    assert _files(res) == _files(solo) == _files(want)
    assert res.counters["Shard:Blocks"] == 4.0
    assert res.counters["Basic:Records"] == solo.counters["Basic:Records"] \
        == want.counters["Basic:Records"]


@pytest.mark.parametrize("job,conf", [
    ("frequentItemsApriori", FIA),
    ("frequentItemsApriori", {**FIA, "fia.emit.trans.id": "true"}),
    ("candidateGenerationWithSelfJoin", CGS)],
    ids=["apriori", "apriori-tids", "gsp"])
def test_miner_per_k_rounds_byte_identical(corpus, tmp_path, job, conf):
    from avenir_tpu.runner import run_job as jax_run_job

    want = jax_run_job(job, conf, [corpus["baskets"]], str(tmp_path / "jax"))
    solo = run_job(job, conf, [corpus["baskets"]], str(tmp_path / "solo"),
                   device=CPU)
    res = _sharded(job, conf, [corpus["baskets"]], str(tmp_path / "sharded"))
    assert len(res.outputs) == len(solo.outputs) == len(want.outputs) >= 3
    assert [os.path.basename(p) for p in sorted(res.outputs)] == \
        [os.path.basename(p) for p in sorted(solo.outputs)] == \
        [os.path.basename(p) for p in sorted(want.outputs)]
    assert _files(res) == _files(solo) == _files(want)
    c = res.counters
    assert c["Shard:PerKRounds"] >= 1.0
    assert c["Shard:PerKBlocks"] >= c["Shard:Blocks"] == 4.0
    assert c["Cache:SpillBytes"] > 0 and c["Cache:EvictedBytes"] == 0
    stats = res.payload["workers"]
    assert sum(s["perk_folded"] for s in stats) == c["Shard:PerKBlocks"]
    if "fia.emit.trans.id" in conf:
        assert c["Shard:PerKBlocks"] == 4.0 * (c["Shard:PerKRounds"] + 1)


@pytest.mark.parametrize("job,conf,maxlen", [
    ("frequentItemsApriori", FIA, "Apriori:MaxLength"),
    ("candidateGenerationWithSelfJoin", CGS, "GSP:MaxLength")],
    ids=["apriori", "gsp"])
def test_miner_counters_equal_the_reference(corpus, tmp_path, job, conf,
                                            maxlen):
    """The bytes and plan-determined counters of a sharded miner equal the
    JAX package's run_sharded at the same plan. (Cache:SpillBytes is not
    one of them: a block stolen in a per-k round is folded again by its
    thief and spills again, so it varies with the schedule in both
    packages. Each plan block's spill is held to the reference's below.)"""
    from avenir_tpu.dist import StragglerPolicy as JaxPolicy
    from avenir_tpu.dist import run_sharded as jax_run_sharded

    res = _sharded(job, conf, [corpus["baskets"]], str(tmp_path / "port"))
    want = jax_run_sharded(job, conf, [corpus["baskets"]],
                           str(tmp_path / "jax"), procs=2, factor=2,
                           policy=JaxPolicy(**QUIET), timeout_s=TIMEOUT_S)
    assert _files(res) == _files(want)
    for name in ("Shard:Blocks", "Shard:Workers", "Shard:PerKRounds",
                 "Shard:PerKBlocks", "Shard:DedupBlocks",
                 "Cache:EvictedBytes", maxlen, "Basic:Records"):
        assert res.counters[name] == want.counters[name], name


@pytest.mark.parametrize("job,conf", [
    ("frequentItemsApriori", FIA),
    ("candidateGenerationWithSelfJoin", CGS)], ids=["apriori", "gsp"])
def test_plan_block_spill_equals_the_reference(corpus, job, conf):
    """Each plan block folded and sealed as a worker does spills the same
    cache bytes in both packages, so a run without steals sums to the
    same Cache:SpillBytes."""
    from avenir_tpu.dist.plan import plan_shards as jax_plan_shards
    from avenir_tpu.dist.worker import fold_block as jax_fold_block
    from avenir_tpu.runner import _job_cfg as jax_job_cfg
    from avenir_tpu.runner import stream_fold_ops as jax_ops
    from avenir_tpu_torch.dist.plan import plan_shards
    from avenir_tpu_torch.dist.worker import fold_block
    from avenir_tpu_torch.runner import _job_cfg, stream_fold_ops

    path = corpus["baskets"]
    plan = plan_shards([path], 2, 2)
    assert [(b.start, b.end) for b in plan.blocks] == \
        [(b.start, b.end) for b in jax_plan_shards([path], 2, 2).blocks]
    name, cfg = _job_cfg(job, dict(conf))
    jname, _, jcfg = jax_job_cfg(job, dict(conf))
    spills = []
    for b in plan.blocks:
        port = fold_block(name, cfg, stream_fold_ops(name), None, [path],
                          path, b.start, b.end, CPU)
        ref = jax_fold_block(jname, jcfg, jax_ops(jname), None, [path],
                             path, b.start, b.end)
        port._seal()
        ref._seal()
        spills.append((port.src.cache_nbytes, ref.src.cache_nbytes))
        port.src.close()
        ref.src.close()
    assert all(p == r > 0 for p, r in spills), spills


@pytest.mark.parametrize("job,prefix,schema_key", [
    ("bayesianDistr", "bad", "moments"),
    ("fisherDiscriminant", "fid", "schema")])
def test_float_carries_equal_the_reference_sharded(corpus, tmp_path, job,
                                                   prefix, schema_key):
    """NB's moments and Fisher's sums are float carries merged in plan
    order: held to the reference's own run_sharded at the same plan, and
    to the solo run wherever the reference's sharded bytes equal its solo
    bytes."""
    from avenir_tpu.dist import StragglerPolicy as JaxPolicy
    from avenir_tpu.dist import run_sharded as jax_run_sharded
    from avenir_tpu.runner import run_job as jax_run_job

    conf = {f"{prefix}.feature.schema.file.path": corpus[schema_key]}
    res = _sharded(job, conf, [corpus["csv"]], str(tmp_path / "port.txt"))
    want = jax_run_sharded(job, conf, [corpus["csv"]],
                           str(tmp_path / "jax.txt"), procs=2, factor=2,
                           policy=JaxPolicy(**QUIET), timeout_s=TIMEOUT_S)
    assert _files(res) == _files(want)
    jax_solo = jax_run_job(job, conf, [corpus["csv"]],
                           str(tmp_path / "jax_solo.txt"))
    solo = run_job(job, conf, [corpus["csv"]], str(tmp_path / "solo.txt"),
                   device=CPU)
    if _files(want) == _files(jax_solo):
        assert _files(res) == _files(solo)
