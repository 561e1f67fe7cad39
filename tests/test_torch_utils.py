"""The port's tabular containers and profiling utilities
(`avenir_tpu_torch/utils/tabular.py`, `utils/profiling.py`) against the
JAX package's on the CPU: every tabular result equal (tolerance 0: both
are the same float64 numpy), `RunningStats` equal to the reference's
float for float, `PhaseTimer`'s counts, order and merges the
reference's, and `trace()` writing a torch.profiler trace and recording
its `torch.profiler.trace` span."""

import json
import math
import os
import threading
import time

import numpy as np
import pytest
import torch

from avenir_tpu.utils import profiling as jprof
from avenir_tpu.utils import tabular as jtab
from avenir_tpu_torch import obs
from avenir_tpu_torch.utils import profiling as tprof
from avenir_tpu_torch.utils import tabular as ttab


# ---------------------------------------------------------------- tabular
@pytest.mark.parametrize("scale,precision", [(100, 3), (1, 3), (1, 1),
                                             (1000, 2)])
def test_state_transition_probability_equal(scale, precision):
    rng = np.random.default_rng(scale)
    labels = ["A", "B", "C"]
    j = jtab.StateTransitionProbability(labels, scale=scale,
                                        float_precision=precision)
    t = ttab.StateTransitionProbability(labels, scale=scale,
                                        float_precision=precision)
    for _ in range(40):
        r, c = rng.choice(labels, 2)
        n = float(rng.integers(1, 5))
        j.add(r, c, n)
        t.add(r, c, n)
    j.set("C", "A", 0.0)
    t.set("C", "A", 0.0)
    assert np.array_equal(j.normalize_rows(), t.normalize_rows())
    assert j.normalize_rows().dtype == t.normalize_rows().dtype
    assert j.serialize() == t.serialize()
    assert j.serialize(";") == t.serialize(";")
    for r in labels:
        for c in labels:
            assert j.prob(r, c) == t.prob(r, c)


def test_state_transition_probability_behaves_as_the_references():
    stp = ttab.StateTransitionProbability(["A", "B"], scale=100)
    stp.add("A", "A", 3)
    stp.add("A", "B", 1)
    stp.add("B", "B", 2)
    m = stp.normalize_rows()
    assert m.dtype == np.int64
    assert list(m[0]) == [75, 25] and list(m[1]) == [0, 100]
    assert stp.prob("A", "B") == pytest.approx(0.25)
    assert "75,25" in stp.serialize()
    empty = ttab.StateTransitionProbability(["A"], ["X", "Y"])
    assert empty.prob("A", "X") == 0.0


@pytest.mark.parametrize("shape", [(2, 2), (3, 4), (1, 5), (4, 1)])
def test_contingency_matrix_equal(shape):
    rng = np.random.default_rng(sum(shape))
    j = jtab.ContingencyMatrix(*shape)
    t = ttab.ContingencyMatrix(*shape)
    for _ in range(50):
        r, c = int(rng.integers(shape[0])), int(rng.integers(shape[1]))
        j.add(r, c)
        t.add(r, c)
    assert j.total() == t.total()
    assert j.chi_squared() == t.chi_squared()
    assert j.cramer_index() == t.cramer_index()
    assert j.serialize() == t.serialize()
    back = ttab.ContingencyMatrix.deserialize(j.serialize(), *shape)
    assert np.array_equal(back.table, j.table)
    other = ttab.ContingencyMatrix(*shape)
    other.accumulate(t)
    other.accumulate(t)
    assert np.array_equal(other.table, 2 * t.table)
    assert ttab.ContingencyMatrix(*shape).chi_squared() == 0.0


def test_contingency_matrix_cramer():
    m = ttab.ContingencyMatrix(2, 2)
    for _ in range(10):
        m.add(0, 0)
        m.add(1, 1)
    assert m.cramer_index() == pytest.approx(1.0)
    assert ttab.ContingencyMatrix(2, 2).cramer_index() == 0.0


def test_cost_schema_equal(tmp_path):
    doc = {"attributes": [
        {"ordinal": 2, "numAttrCost": 1.5},
        {"ordinal": 4, "catAttrCost": {"poor,good": 10.0, "good,poor": 2}},
        {"ordinal": 7},
    ]}
    path = str(tmp_path / "cost.json")
    with open(path, "w") as fh:
        json.dump(doc, fh)
    j = jtab.CostSchema.from_file(path)
    t = ttab.CostSchema.from_file(path)
    assert t.find_cost(2, 4.0) == j.find_cost(2, 4.0) == pytest.approx(6.0)
    for a, b in (("poor", "good"), ("good", "poor"), ("good", "good")):
        assert t.find_cost(4, a, b) == j.find_cost(4, a, b)
    assert t.find_cost(7, 3.0) == j.find_cost(7, 3.0) == 0.0
    assert ttab.CostSchema.from_json(doc).attributes.keys() == \
        j.attributes.keys()
    with pytest.raises(ValueError, match="invalid attribute ordinal 99"):
        t.find_cost(99, 1.0)
    attr = ttab.CostAttribute.from_json({"ordinal": "3", "numAttrCost": "2"})
    assert (attr.ordinal, attr.num_attr_cost, attr.cat_attr_cost) == (
        3, 2.0, {})


def test_class_attribute_counter():
    c = ttab.ClassAttributeCounter()
    c.add(3, 2)
    c.add(1, 0)
    assert (c.pos_count, c.neg_count, c.total) == (4, 2, 6)
    c.update(7, 7)
    assert c.total == 14
    assert ttab.ClassAttributeCounter() == ttab.ClassAttributeCounter(0, 0)


# -------------------------------------------------------------- profiling
def test_phase_timer_accumulates():
    t = tprof.PhaseTimer()
    with t.phase("a"):
        time.sleep(0.01)
    with t.phase("b"):
        time.sleep(0.005)
    with t.phase("a"):
        time.sleep(0.01)
    rep = t.report()
    assert list(rep) == ["a", "b"]
    assert rep["a"] >= 0.018 and rep["b"] >= 0.004
    assert t.counts == {"a": 2, "b": 1}
    assert "a" in t.summary() and "%" in t.summary()
    with pytest.raises(KeyError):
        with t.phase("c"):
            raise KeyError("inside")
    assert t.counts["c"] == 1


def test_phase_timer_is_thread_safe():
    t = tprof.PhaseTimer()
    n_threads, per_thread = 8, 200
    barrier = threading.Barrier(n_threads)

    def worker():
        barrier.wait()
        for _ in range(per_thread):
            with t.phase("hot"):
                pass
            with t.phase("cold"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.counts == {"hot": n_threads * per_thread,
                        "cold": n_threads * per_thread}
    assert sorted(t.report()) == ["cold", "hot"]


def test_phase_timer_merge_matches_the_reference():
    pairs = []
    for mod in (jprof, tprof):
        a, b = mod.PhaseTimer(), mod.PhaseTimer()
        with a.phase("ingest"):
            pass
        with b.phase("ingest"):
            pass
        with b.phase("train"):
            pass
        assert a.merge(b) is a
        pairs.append((a.counts, list(a.report()), b.counts))
    assert pairs[0] == pairs[1]
    assert pairs[1] == ({"ingest": 2, "train": 1}, ["ingest", "train"],
                        {"ingest": 1, "train": 1})


def test_phase_timer_merges_both_ways_at_once():
    """a.merge(b) and b.merge(a) on two threads at once never hold both
    locks: both finish."""
    a, b = tprof.PhaseTimer(), tprof.PhaseTimer()
    with a.phase("x"):
        pass
    with b.phase("y"):
        pass
    done = []

    def run(p, q):
        for _ in range(300):
            p.merge(q)
        done.append(True)

    threads = [threading.Thread(target=run, args=(a, b)),
               threading.Thread(target=run, args=(b, a))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert done == [True, True]


def test_running_stats_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, 1000)
    j = jprof.RunningStats().add_array(x).add(1.5, -2.0)
    t = tprof.RunningStats().add_array(x).add(1.5, -2.0)
    assert (t.count, t.total, t.total_sq, t.min_val, t.max_val) == (
        j.count, j.total, j.total_sq, j.min_val, j.max_val)
    assert (t.mean, t.variance, t.std) == (j.mean, j.variance, j.std)
    assert t.mean == pytest.approx(np.append(x, [1.5, -2.0]).mean())
    a = tprof.RunningStats().add_array(x[:300])
    b = tprof.RunningStats().add_array(x[300:])
    merged = a.merge(b)
    whole = tprof.RunningStats().add_array(x)
    assert merged.count == whole.count
    assert merged.mean == pytest.approx(whole.mean, rel=1e-12)
    assert merged.variance == pytest.approx(whole.variance, rel=1e-9)
    empty = tprof.RunningStats().add_array([])
    assert empty.count == 0 and empty.mean == 0.0 and empty.variance == 0.0
    assert math.isinf(tprof.RunningStats().min_val)


def test_trace_writes_a_profile_and_a_span(tmp_path):
    d = str(tmp_path / "trace")
    with obs.capture() as rec:
        with tprof.trace(d):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    found = [f for _, _, fs in os.walk(d) for f in fs]
    assert found, "no trace files written"
    spans = [sp for sp in rec.spans() if sp.name == "torch.profiler.trace"]
    assert len(spans) == 1
    assert spans[0].attrs == {"log_dir": d, "started": True}


def test_trace_inside_a_running_profiler_does_nothing(tmp_path):
    d = str(tmp_path / "inner")
    with torch.profiler.profile():
        with obs.capture() as rec:
            with tprof.trace(d):
                torch.ones(4) + 1
    spans = [sp for sp in rec.spans() if sp.name == "torch.profiler.trace"]
    assert len(spans) == 1 and spans[0].attrs["started"] is False
    assert not os.path.exists(d) or not any(
        fs for _, _, fs in os.walk(d))


def test_no_compilation_cache_counterpart():
    assert hasattr(jprof, "enable_persistent_compilation_cache")
    assert not hasattr(tprof, "enable_persistent_compilation_cache")


def test_counters_match_reference():
    """`utils/metrics.Counters` takes the reference's increments, sets,
    updates and defaults to the same values and repr."""
    from avenir_tpu.utils.metrics import Counters as JaxCounters
    from avenir_tpu_torch.utils.metrics import Counters

    ops = [("incr", ("Basic:Records",)), ("incr", ("Basic:Records", 41)),
           ("set", ("Validation:Accuracy", 0.875)),
           ("incr", ("Validation:TP", 2.5)),
           ("update", ({"Basic:Records": 7, "Cache:Hits": 3},)),
           ("incr", ("Cache:Hits", -1))]
    port, ref = Counters(), JaxCounters()
    for name, args in ops:
        getattr(port, name)(*args)
        getattr(ref, name)(*args)
    assert port.values == ref.values == {
        "Basic:Records": 7, "Validation:Accuracy": 0.875,
        "Validation:TP": 2.5, "Cache:Hits": 2}
    assert port.get("Missing") == ref.get("Missing") == 0
    assert port.get("Missing", -1.0) == -1.0
    assert repr(port) == repr(ref).replace("JaxCounters", "Counters")
