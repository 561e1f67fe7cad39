"""The sharded driver's pieces in the port, held against the JAX package:
the planner, the block ledger, the straggler detector, `extract_signals`
and the atomic publish hooks (the counterparts of `tests/test_dist.py`'s
planner, ledger and detector cases), the plan manifest against the
reference's on the same corpus, and block states written by the JAX
package's `serialize_state` restored and merged in the port to the same
artifact bytes. Nothing here starts a worker process."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.dist import plan as jplan
from avenir_tpu.dist.detect import mirror_after_wall_s as jwall
from avenir_tpu.tune import signals as jsignals
from avenir_tpu_torch.core import atomic
from avenir_tpu_torch.dist import (BlockLedger, PlanError, StragglerPolicy,
                                   load_plan, merge_block_states,
                                   mirror_after_s, mirror_after_wall_s,
                                   plan_shards, write_plan)
from avenir_tpu_torch.dist.detect import per_block_seconds
from avenir_tpu_torch.dist.plan import _align_boundaries, _snap_cut
from avenir_tpu_torch.obs.trace import Span
from avenir_tpu_torch.tune import RunSignals, extract_signals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from avenir_tpu.data import churn_schema, generate_churn

    d = tmp_path_factory.mktemp("dist_plan")
    csv = str(d / "churn.csv")
    with open(csv, "w") as fh:
        fh.write(generate_churn(2500, seed=17, as_csv=True))
    schema = str(d / "churn.json")
    churn_schema().save(schema)
    seq = str(d / "seq.csv")
    with open(seq, "w") as fh:
        for i in range(1500):
            fh.write(f"c{i},{'T' if i % 2 else 'F'},L,M,H,M,L\n")
    return {"dir": str(d), "csv": csv, "schema": schema, "seq": seq}


# ---------------------------------------------------------------- planner
def test_blocks_tile_input_newline_aligned(corpus):
    plan = plan_shards([corpus["csv"]], procs=2, factor=4)
    size = os.path.getsize(corpus["csv"])
    assert len(plan.blocks) == 8
    data = open(corpus["csv"], "rb").read()
    pos = 0
    for blk in plan.blocks:
        assert blk.start == pos
        pos = blk.end
        if blk.end < size:
            assert data[blk.end - 1:blk.end] == b"\n"
    assert pos == size


def test_home_runs_are_contiguous(corpus):
    plan = plan_shards([corpus["csv"]], procs=2, factor=4)
    assert [b.home for b in plan.blocks] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert len(plan.blocks_for(0)) == len(plan.blocks_for(1)) == 4


@pytest.mark.parametrize("text,procs,factor", [
    ("a,1\nb,2\nc,3\n", 4, 2),          # fewer lines than blocks
    ("onlyline,42", 2, 2),              # one line, no newline
    ("x,1\n" * 50 + "tail,9", 3, 3),    # last line without newline
])
def test_edge_corpora_tile_and_equal_the_reference(tmp_path, text, procs,
                                                   factor):
    p = str(tmp_path / "e.csv")
    with open(p, "w") as fh:
        fh.write(text)
    plan = plan_shards([p], procs=procs, factor=factor)
    ref = jplan.plan_shards([p], procs=procs, factor=factor)
    pos = 0
    for blk in plan.blocks:
        assert blk.start == pos
        pos = blk.end
    assert pos == os.path.getsize(p)
    assert [b.to_dict() for b in plan.blocks] == \
        [b.to_dict() for b in ref.blocks]


@pytest.mark.parametrize("corpus_key", ["csv", "seq"])
@pytest.mark.parametrize("procs,factor", [(2, 4), (3, 2), (4, 1)])
def test_manifest_equals_the_reference_but_device(corpus, tmp_path,
                                                  corpus_key, procs, factor):
    policy = StragglerPolicy(mirror_floor_s=0.5)
    plan = plan_shards([corpus[corpus_key]], procs=procs, factor=factor,
                       policy=policy.to_dict())
    ref = jplan.plan_shards([corpus[corpus_key]], procs=procs,
                            factor=factor, policy=policy.to_dict())
    for p in (plan, ref):
        p.job, p.prefix, p.per_k = "mutualInformation", "mut", False
        p.props = {"mut.feature.schema.file.path": corpus["schema"]}
    plan.device = "cpu"
    write_plan(plan, str(tmp_path / "port.json"))
    jplan.write_plan(ref, str(tmp_path / "ref.json"))
    port_doc = json.load(open(tmp_path / "port.json"))
    ref_doc = json.load(open(tmp_path / "ref.json"))
    assert port_doc.pop("device") == "cpu"
    assert port_doc == ref_doc
    assert load_plan(str(tmp_path / "port.json")).to_dict() == \
        plan.to_dict()
    assert jplan.load_plan(str(tmp_path / "port.json")).to_dict() == \
        ref.to_dict()


def test_planned_from_offsets_equals_the_reference(corpus):
    """`starts` plans each input from a line-boundary offset on."""
    data = open(corpus["seq"], "rb").read()
    start = data.index(b"\n", len(data) // 3) + 1
    plan = plan_shards([corpus["seq"], corpus["csv"]], procs=2, factor=2,
                       starts=[start, 0])
    ref = jplan.plan_shards([corpus["seq"], corpus["csv"]], procs=2,
                            factor=2, starts=[start, 0])
    assert plan.to_dict() == {**ref.to_dict(), "device": "cuda"}
    assert plan.blocks[0].start == start
    with pytest.raises(PlanError):
        plan_shards([corpus["seq"]], procs=2, starts=[len(data) + 1])
    with pytest.raises(PlanError):
        plan_shards([corpus["seq"]], procs=2, starts=[0, 0])


def test_align_and_snap_equal_the_reference(corpus):
    size = os.path.getsize(corpus["seq"])
    snap = [0, 4000, 9000, 20000, size]
    for n in (1, 3, 7):
        assert _align_boundaries(corpus["seq"], size, n) == \
            jplan._align_boundaries(corpus["seq"], size, n)
        assert _align_boundaries(corpus["seq"], size, n, snap=snap) == \
            jplan._align_boundaries(corpus["seq"], size, n, snap=snap)
    for b in (0, 3900, 6500, 30000):
        assert _snap_cut(b, 0, size, snap) == jplan._snap_cut(b, 0, size,
                                                              snap)


def test_manifest_write_is_atomic(corpus, tmp_path):
    plan = plan_shards([corpus["csv"]], procs=2, factor=2,
                       policy=StragglerPolicy().to_dict())
    path = str(tmp_path / "plan.json")
    write_plan(plan, path)
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert load_plan(path).policy["mirror_multiple"] == 4.0


def test_rejects_bad_args(corpus, tmp_path):
    for args in (([], 2), ([corpus["csv"]], 0)):
        with pytest.raises(PlanError):
            plan_shards(*args)
    with pytest.raises(PlanError):
        plan_shards([corpus["csv"]], procs=2, factor=0)
    with pytest.raises(PlanError):
        plan_shards([str(tmp_path / "none.csv")], procs=2)
    with pytest.raises(PlanError):
        load_plan(str(tmp_path / "none.json"))


# ----------------------------------------------------------------- ledger
def test_exactly_one_claim_winner_under_contention(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    wins = []
    barrier = threading.Barrier(8)

    def racer(w):
        barrier.wait()
        if ledger.claim(7, worker=w):
            wins.append(w)

    threads = [threading.Thread(target=racer, args=(w,)) for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(wins) == 1
    assert ledger.claim_info(7)["worker"] == wins[0]


def test_duplicate_commit_rejected_and_marked(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    assert ledger.commit(3, worker=0, blob=b"first-state")
    assert not ledger.commit(3, worker=1, blob=b"late-duplicate")
    assert ledger.load_state(3) == b"first-state"
    assert ledger.dup_count() == 1
    assert ledger.committed() == [3]
    assert os.listdir(ledger.dups_dir) == ["b3.w1.json"]


@pytest.mark.parametrize("ns", ["", "k3"])
def test_racing_commits_exactly_one_wins(tmp_path, ns):
    """Pass 1 and a per-k level alike: one winner, the rest dup markers."""
    ledger = BlockLedger(str(tmp_path))
    if ns:
        ledger = ledger.level(ns)
    outcomes = {}
    barrier = threading.Barrier(6)

    def committer(w):
        barrier.wait()
        outcomes[w] = ledger.commit(0, w, f"state-{w}".encode())

    threads = [threading.Thread(target=committer, args=(w,))
               for w in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(outcomes.values()) == 1
    winner = next(w for w, won in outcomes.items() if won)
    assert ledger.load_state(0) == f"state-{winner}".encode()
    assert ledger.dup_count() == 5


def test_level_namespaces_are_independent(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    k2 = ledger.level("k2")
    assert ledger.commit(0, worker=0, blob=b"pass1-state")
    assert k2.commit(0, worker=1, blob=b"k2-counts")
    assert ledger.load_state(0) == b"pass1-state"
    assert k2.load_state(0) == b"k2-counts"
    assert not k2.commit(0, worker=0, blob=b"late-dup")
    assert k2.dup_count() == 1 and ledger.dup_count() == 0
    assert ledger.level("k2").committed() == [0]
    for bad in ("k2/../escape", "", "a/b"):
        with pytest.raises(ValueError):
            ledger.level(bad)


def test_torn_claim_treated_as_unclaimed(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    with open(ledger.claim_path(5), "w") as fh:
        fh.write('{"block": 5, "wor')
    assert ledger.claim_info(5) is None
    assert 5 in ledger.unclaimed(8)
    assert ledger.claim(5, worker=1)
    assert ledger.claim_info(5)["worker"] == 1


def test_stale_claims_oldest_first(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    now = time.time()
    ledger.claim(0, worker=0)
    ledger.claim(1, worker=1)
    ledger.commit(1, worker=1, blob=b"s")
    assert ledger.stale_claims(4, older_than_s=0.0, now=now + 10) == [0]
    assert ledger.stale_claims(4, older_than_s=60.0, now=now + 10) == []


def test_ledgers_read_each_others_files(tmp_path):
    """One shard root is readable by either package: the same layout,
    claim records and format marker."""
    from avenir_tpu.dist.ledger import BlockLedger as JaxLedger

    port, ref = BlockLedger(str(tmp_path)), JaxLedger(str(tmp_path))
    assert port.claim(0, worker=0) and not ref.claim(0, worker=1)
    assert ref.claim(1, worker=1) and not port.claim(1, worker=0)
    assert port.commit(0, 0, b"a") and not ref.commit(0, 1, b"b")
    assert ref.level("k2").commit(4, 1, b"c")
    assert port.level("k2").load_state(4) == b"c"
    assert port.claims() == ref.claims()
    assert port.committed() == ref.committed() == [0]
    assert port.dup_count() == ref.dup_count() == 1
    assert json.load(open(os.path.join(port.states_dir, "FORMAT.json"))) \
        == {"format_version": 1}


def test_version_skew_refuses_to_serve(tmp_path):
    ledger = BlockLedger(str(tmp_path))
    assert ledger.commit(0, 0, b"s")
    with open(os.path.join(ledger.states_dir, "FORMAT.json"), "w") as fh:
        json.dump({"format_version": 99}, fh)
    assert ledger.committed() == []
    with pytest.raises(ValueError, match="layout version"):
        ledger.load_state(0)


# --------------------------------------------------------------- detector
def test_per_block_seconds_from_signals():
    sig = RunSignals(read_s=1.0, parse_s=0.5, fold_s=2.5)
    assert per_block_seconds(sig, 4) == pytest.approx(1.0)
    assert per_block_seconds(sig, 0) == 0.0


def test_mirror_threshold_clamped():
    pol = StragglerPolicy(mirror_multiple=4.0, mirror_floor_s=1.0,
                          mirror_cap_s=10.0)
    assert mirror_after_s(pol, RunSignals(read_s=0.01, parse_s=0.01,
                                          fold_s=0.02), 4) == 1.0
    assert mirror_after_s(pol, RunSignals(read_s=40.0, fold_s=40.0),
                          4) == 10.0
    assert mirror_after_s(pol, RunSignals(read_s=2.0, fold_s=2.0),
                          4) == pytest.approx(4.0)
    assert mirror_after_s(pol, RunSignals(), 0) == 1.0


@pytest.mark.parametrize("wall,done", [(0.0, 0), (0.1, 3), (8.0, 2),
                                       (500.0, 1)])
def test_per_k_threshold_equals_the_reference(wall, done):
    from avenir_tpu.dist.detect import StragglerPolicy as JaxPolicy

    kw = dict(mirror_multiple=2.0, mirror_floor_s=0.3, mirror_cap_s=60.0)
    assert mirror_after_wall_s(StragglerPolicy(**kw), wall, done) == \
        jwall(JaxPolicy(**kw), wall, done)


def test_policy_round_trip_equals_the_reference():
    from avenir_tpu.dist.detect import StragglerPolicy as JaxPolicy

    pol = StragglerPolicy(poll_s=0.02, mirror_floor_s=0.5, mirror=False)
    assert pol.to_dict() == JaxPolicy(poll_s=0.02, mirror_floor_s=0.5,
                                      mirror=False).to_dict()
    assert StragglerPolicy.from_dict(pol.to_dict()) == pol


def _spans(seed):
    rng = np.random.default_rng(seed)
    names = ["stream.read", "stream.parse", "stream.fold",
             "stream.stall.consumer", "stream.stall.producer",
             "job.checkpoint", "job.finish"]
    out = []
    for i in range(40):
        name = names[int(rng.integers(0, len(names)))]
        attrs = ({"nbytes": int(rng.integers(1, 1000))}
                 if name == "stream.read" else
                 {"sink": f"s{int(rng.integers(0, 3))}"}
                 if name == "stream.fold" else None)
        out.append((name, 1, float(rng.random() * 10),
                    float(rng.random()), attrs))
    return out


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("wall", [None, 12.5])
def test_extract_signals_equals_the_reference(seed, wall):
    from avenir_tpu.obs.trace import Span as JaxSpan

    rows = _spans(seed)
    got = extract_signals([Span(*r) for r in rows], wall_s=wall)
    want = jsignals.extract_signals([JaxSpan(*r) for r in rows],
                                    wall_s=wall)
    assert got.to_json() == want.to_json()
    assert RunSignals.from_json(got.to_json()).to_json() == got.to_json()
    assert got.producer_bound_share == pytest.approx(
        want.producer_bound_share)


# ----------------------------------------------------------- atomic hooks
def test_hook_contract_equals_the_reference():
    from avenir_tpu.core import atomic as jatomic

    for name in ("CRASH_ENV", "SCHED_ENV", "CRASH_EXIT", "BEFORE_RENAME",
                 "AFTER_RENAME", "STALE_TMP_AGE_S"):
        assert getattr(atomic, name) == getattr(jatomic, name)
    for name in ("x.json", ".x.json.ab12cd34.tmp", "b.tmp.7", "x.tmp.json"):
        assert atomic.is_tmp_name(name) == jatomic.is_tmp_name(name)


@pytest.mark.parametrize("stage,published", [("before-rename", False),
                                             ("after-rename", True)])
def test_crash_point_exits_at_its_site(tmp_path, stage, published):
    target = str(tmp_path / "m.json")
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from avenir_tpu_torch.core.atomic import publish_json;"
            "publish_json({'a': 1}, sys.argv[2], site='plan.manifest');"
            "print('survived')")
    proc = subprocess.run(
        [sys.executable, "-c", code, ROOT, target], capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, AVENIR_PROTO_CRASH=f"plan.manifest:{stage}"))
    assert proc.returncode == atomic.CRASH_EXIT
    assert "survived" not in proc.stdout
    assert os.path.exists(target) == published
    if published:
        assert json.load(open(target)) == {"a": 1}
    # a stage that is not armed, or no arming, leaves the publish alone
    atomic.publish_json({"b": 2}, target, site="plan.manifest")
    assert json.load(open(target)) == {"b": 2}


def test_sched_point_parks_until_granted(tmp_path, monkeypatch):
    turnstile = str(tmp_path)
    monkeypatch.setenv(atomic.SCHED_ENV, f"{turnstile}:3")
    done = threading.Event()

    def actor():
        atomic.sched_point("ledger.claim")
        done.set()

    th = threading.Thread(target=actor)
    th.start()
    ready = os.path.join(turnstile, "ready.3.0000")
    deadline = time.time() + 30
    while not os.path.exists(ready) and time.time() < deadline:
        time.sleep(0.005)
    assert open(ready).read() == "ledger.claim"
    assert not done.wait(0.1)
    open(os.path.join(turnstile, "go.3.0000"), "w").close()
    th.join(30)
    assert done.is_set()


def test_sweep_stale_tmps_removes_only_old_tmps(tmp_path):
    sub = tmp_path / "ledger" / "claims"
    sub.mkdir(parents=True)
    old = sub / ".tmp.b1.abc"
    old.write_text("x")
    young = sub / ".b2.json.12345678.tmp"
    young.write_text("y")
    committed = sub / "b3.json"
    committed.write_text("{}")
    past = time.time() - 2 * atomic.STALE_TMP_AGE_S
    os.utime(old, (past, past))
    os.utime(committed, (past, past))
    assert atomic.sweep_stale_tmps(str(tmp_path)) == [str(old)]
    assert young.exists() and committed.exists()
    assert atomic.sweep_stale_tmps(str(tmp_path / "missing")) == []


def test_publish_failure_leaves_no_tmp(tmp_path):
    with pytest.raises(TypeError):
        atomic.publish_json({"x": object()}, str(tmp_path / "a.json"))
    with pytest.raises(OSError):
        atomic.publish_bytes(b"x", str(tmp_path / "no" / "dir" / "a"))
    assert os.listdir(tmp_path) == []


# ------------------------------------------- block states across packages
def _ref_states(canonical_name, conf, corpus_path, procs, factor):
    """Plan a corpus and fold each block with the JAX package's own
    `fold_block`, serialized by its `serialize_state`."""
    from avenir_tpu.dist.worker import fold_block as jfold
    from avenir_tpu.runner import _job_cfg, _schema, stream_fold_ops

    canonical, _prefix, cfg = _job_cfg(canonical_name, conf)
    ops = stream_fold_ops(canonical)
    schema = _schema(cfg) if ops.kind == "dataset" else None
    plan = jplan.plan_shards([corpus_path], procs, factor)
    states = {}
    for blk in plan.blocks:
        fold = jfold(canonical, cfg, ops, schema, [corpus_path],
                     corpus_path, blk.start, blk.end)
        states[blk.id] = ops.serialize_state(fold)
    return plan, states


@pytest.mark.parametrize("job", ["mutualInformation",
                                 "markovStateTransitionModel"])
def test_reference_block_states_merge_in_the_port(corpus, tmp_path, job):
    from avenir_tpu.runner import run_job as jax_run_job
    from avenir_tpu_torch.runner import (_finish_fold, _job_cfg, _schema,
                                         stream_fold_ops)

    conf, path = {
        "mutualInformation": (
            {"mut.feature.schema.file.path": corpus["schema"],
             "mut.mutual.info.score.algorithms":
                 "mutual.info.maximization"}, corpus["csv"]),
        "markovStateTransitionModel": (
            {"mst.model.states": "L,M,H", "mst.class.label.field.ord": "1",
             "mst.skip.field.count": "2", "mst.class.labels": "T,F"},
            corpus["seq"])}[job]
    want = str(tmp_path / "solo.txt")
    jax_run_job(job, conf, [path], want)
    plan, states = _ref_states(job, conf, path, procs=2, factor=3)
    canonical, cfg = _job_cfg(job, conf)
    ops = stream_fold_ops(canonical)
    schema = _schema(cfg) if ops.kind == "dataset" else None
    merged = merge_block_states(canonical, cfg, ops, plan, states, [path],
                                str(tmp_path), schema=schema, device="cpu")
    got = str(tmp_path / "port.txt")
    _finish_fold(merged, got, canonical)
    assert open(got, "rb").read() == open(want, "rb").read()
    del states[plan.blocks[-1].id]
    from avenir_tpu_torch.dist import ShardError

    with pytest.raises(ShardError, match="no committed state"):
        merge_block_states(canonical, cfg, ops, plan, states, [path],
                           str(tmp_path), schema=schema, device="cpu")
