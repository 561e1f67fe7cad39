"""The port's Markov path against the JAX package on the CPU.

Small sizes (3-5 states, 2-17 classes or entities, under 3,000 rows),
numpy-seeded inputs through both packages: the bigram count exactly
against `_bigram_counts` (entity axes that are no power of two too), every
fit form and merge, the error texts word for word; classifier scores bit
for bit and the same bits alone or batched with a longer sequence; the
HMM builder's counts (per row, CSR, partially tagged) and `finish`;
Viterbi paths on seeded and tie-heavy HMMs and at lengths 1-2; PST, the
CTMC rates, dwell and transition counts and the inter-arrival histogram
(host float64, rtol 1e-12); each of the eight jobs' files byte-identical
to `avenir_tpu.runner.run_job`'s (markov per class and per entity, native
and Python; the builder fully and partially tagged; both rate-file shapes
of the CTMC stats); `run_shared` and `Pipeline.run(fuse=True)` with
markov, Apriori and GSP over one file; fold checkpoints taken mid-scan in
one package and finished in the other; the shard merge; the convert
functions.
"""

import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.models import markov as jm
from avenir_tpu.runner import JobConfig as JaxJobConfig
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu.runner import run_shared as jax_run_shared
from avenir_tpu.runner import stream_fold_ops as jax_stream_fold_ops
from avenir_tpu_torch import obs
from avenir_tpu_torch.core.config import JobConfig
from avenir_tpu_torch.core.stream import stream_job_byte_blocks
from avenir_tpu_torch.data import (generate_event_sequences,
                                   generate_loyalty_sequences,
                                   generate_markov_chains)
from avenir_tpu_torch.data.generators import (LOYALTY_OBS, LOYALTY_STATES,
                                              MARKOV_STATES)
from avenir_tpu_torch.models import convert
from avenir_tpu_torch.models import markov as pm
from avenir_tpu_torch.native import ingest
from avenir_tpu_torch.runner import (Pipeline, Stage, job_names, run_job,
                                     run_shared, stream_fold_names,
                                     stream_fold_ops)
from avenir_tpu_torch.runner import DELTA_COUNTERS, MEM_COUNTERS

CPU = "cpu"
ROUTES = ("native", "python")
STATES3 = ["A", "B", "C"]
MST = {"mst.model.states": ",".join(MARKOV_STATES),
       "mst.skip.field.count": "2", "mst.class.label.field.ord": "1",
       "mst.class.labels": "C,L", "mst.trans.prob.scale": "1000",
       "mst.stream.block.size.mb": "0.004"}


def _job_counters(counters):
    """A result's counters without the delta-scan ones (DELTA_COUNTERS),
    which every streamed result carries and which count what a restore or
    the columnar sidecar served, and without the memory counters
    (MEM_COUNTERS: the tests hold the prediction to the reference's on
    its own; the peak RSS measures the process)."""
    return {k: v for k, v in counters.items()
            if k not in DELTA_COUNTERS and k not in MEM_COUNTERS}


def _same_prediction(port, ref):
    """Mem:PredictedPeakBytes of a port result equals the reference's (both
    absent for a job that is not streamed)."""
    assert port.get("Mem:PredictedPeakBytes") == \
        ref.get("Mem:PredictedPeakBytes")


def _python_route(monkeypatch):
    from avenir_tpu.native import ingest as jax_ingest

    for mod in (ingest, jax_ingest):
        monkeypatch.setattr(mod, "native_seq_ready", lambda delim: False)


def _chains(path: Path, n: int = 1500, seed: int = 21, entities=None,
            crlf: bool = False) -> str:
    """The churn tutorial's chains, with a padded row, a blank line and a
    white-space line among them."""
    lines = generate_markov_chains(n, seed=seed, n_entities=entities)
    lines.insert(n // 3, "")
    lines.insert(n // 2, "  \t ")
    toks = lines[7].split(",")
    lines[7] = " , ".join(toks[:2]) + ",\t" + ",".join(toks[2:]) + " "
    end = "\r\n" if crlf else "\n"
    path.write_text(end.join(lines) + end)
    return str(path)


def _bytes(outputs):
    """Each output file's bytes, and its stamp's where it has one."""
    got = {}
    for p in outputs:
        for q in (p, p + ".stamp.json"):
            if os.path.exists(q):
                got[os.path.basename(q)] = Path(q).read_bytes()
    return got


def _both(tmp_path, job, props, inputs, name="out"):
    """(port files, JAX files) of one job on the same inputs."""
    port = run_job(job, props, inputs, str(tmp_path / "port" / name),
                   device=CPU)
    jax = jax_run_job(job, props, inputs, str(tmp_path / "jax" / name))
    return port, jax, _bytes(port.outputs), _bytes(jax.outputs)


def _random_padded(rng, n, s, max_len):
    lens = rng.integers(0, max_len + 1, n)
    pad = np.full((n, max(max_len, 1)), -1, np.int32)
    for i, ln in enumerate(lens):
        pad[i, :ln] = rng.integers(0, s, ln)
    return pad, lens


# -------------------------------------------------------------- the counts
@pytest.mark.parametrize("k", [1, 2, 3, 5, 17])
@pytest.mark.parametrize("seed", range(2))
def test_bigram_counts_equal_jax(k, seed):
    """The flat-key count against `_bigram_counts` (its class axis padded
    to a power of two and sliced), exactly."""
    rng = np.random.default_rng(seed * 31 + k)
    s = int(rng.integers(3, 6))
    pad, _ = _random_padded(rng, int(rng.integers(1, 400)), s, 12)
    y = rng.integers(0, k, pad.shape[0]).astype(np.int32)
    k_pad = max(1, 1 << (k - 1).bit_length())
    want = np.asarray(jm._bigram_counts(jnp.asarray(pad), jnp.asarray(y), s,
                                        k_pad))[:k]
    got = pm.bigram_counts(torch.from_numpy(pad), torch.from_numpy(y), s, k)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)


def _seqs(rng, n, states, lo=0, hi=10):
    return [list(rng.choice(states, int(rng.integers(lo, hi))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_fit_forms_equal_jax(seed):
    """fit (unlabelled and per class), fit_entities (a growing entity axis
    of no power of two), merge: the counts of both packages equal."""
    rng = np.random.default_rng(seed)
    states = STATES3 + ["D", "E"][:seed]
    seqs = _seqs(rng, 300, states)
    labels = list(rng.choice(["x", "y", "z"], len(seqs)))
    one = pm.MarkovStateTransitionModel(states, device=CPU).fit(seqs)
    assert np.array_equal(one.counts,
                          jm.MarkovStateTransitionModel(states).fit(seqs).counts)
    a = pm.MarkovStateTransitionModel(states, class_labels=["x", "y", "z"],
                                      device=CPU)
    b = jm.MarkovStateTransitionModel(states, class_labels=["x", "y", "z"])
    a.fit(seqs[:150], labels[:150]).fit(seqs[150:], labels[150:])
    b.fit(seqs[:150], labels[:150]).fit(seqs[150:], labels[150:])
    assert np.array_equal(a.counts, b.counts)
    half = pm.MarkovStateTransitionModel(states, class_labels=["x", "y", "z"],
                                         device=CPU).fit(seqs[:150],
                                                         labels[:150])
    rest = pm.MarkovStateTransitionModel(states, class_labels=["x", "y", "z"],
                                         device=CPU).fit(seqs[150:],
                                                         labels[150:])
    assert np.array_equal(half.merge(rest).counts, a.counts)
    keys = [f"e{int(v)}" for v in rng.integers(0, 7 + seed * 5, len(seqs))]
    pe = pm.MarkovStateTransitionModel(states, device=CPU)
    je = jm.MarkovStateTransitionModel(states)
    for lo in range(0, len(seqs), 70):
        pe.fit_entities(seqs[lo:lo + 70], keys[lo:lo + 70])
        je.fit_entities(seqs[lo:lo + 70], keys[lo:lo + 70])
    assert pe.class_labels == je.class_labels
    assert pe.counts.shape[0] not in (1, 2, 4, 8, 16)
    assert np.array_equal(pe.counts, je.counts)
    for cv in pe.class_labels:
        assert np.array_equal(pe.matrix(cv), je.matrix(cv))
        assert np.array_equal(pe.matrix(cv, scaled=False),
                              je.matrix(cv, scaled=False))


def _encoded(lines, vocab):
    data = ("\n".join(lines) + "\n").encode()
    return ingest.seq_encode_native(data, ",", vocab)


@pytest.mark.parametrize("seed", range(3))
def test_fit_csr_equals_jax(seed):
    """fit_csr per class (a label that is also a state shares its code),
    and with caller-resolved entity indices, against the JAX package's."""
    rng = np.random.default_rng(seed)
    states = ["A", "B", "C", "x"][:3 + (seed == 2)]
    vocab = states + [v for v in ("x", "y") if v not in states]
    lines = [",".join([f"r{i}", str(rng.choice(["x", "y"]))]
                      + list(rng.choice(states, int(rng.integers(0, 9)))))
             for i in range(400)]
    codes, offsets = _encoded(lines, vocab)
    label_codes = np.asarray([vocab.index(v) for v in ("x", "y")])
    a = pm.MarkovStateTransitionModel(states, class_labels=["x", "y"],
                                      device=CPU)
    b = jm.MarkovStateTransitionModel(states, class_labels=["x", "y"])
    a.fit_csr(codes, offsets, skip=2, class_ord=1, label_codes=label_codes)
    b.fit_csr(codes, offsets, skip=2, class_ord=1, label_codes=label_codes)
    assert np.array_equal(a.counts, b.counts) and a.counts.sum() > 0
    y = rng.integers(0, 5, offsets.shape[0] - 1)
    a = pm.MarkovStateTransitionModel(states, class_labels=list("abcde"),
                                      device=CPU)
    b = jm.MarkovStateTransitionModel(states, class_labels=list("abcde"))
    a.fit_csr(codes, offsets, skip=2, y=y)
    b.fit_csr(codes, offsets, skip=2, y=y)
    assert np.array_equal(a.counts, b.counts)
    # an empty block changes nothing
    a.fit_csr(np.zeros(0, np.int32), np.zeros(1, np.int64), skip=2, y=y[:0])
    assert np.array_equal(a.counts, b.counts)


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


CSR_FAULTS = {
    "unknown state": (["r0,x,A,B", "r1,y,A,Q,B"], {"class_ord": 1}),
    "no class field": (["r0,x,A,B", "r1"], {"class_ord": 1}),
    "unknown class": (["r0,x,A,B", "r1,z,A,B"], {"class_ord": 1}),
    "no class_ord": (["r0,x,A"], {}),
    "no label_codes": (["r0,x,A"], {"class_ord": 1, "label_codes": None}),
    "bad y": (["r0,x,A", "r1,y,B"], {"y": np.array([0, 7])}),
}


@pytest.mark.parametrize("fault", sorted(CSR_FAULTS))
def test_fit_errors_equal_jax(fault):
    lines, kw = CSR_FAULTS[fault]
    vocab = ["A", "B", "C", "x", "y"]
    codes, offsets = _encoded(lines, vocab)
    kw = {"label_codes": np.array([3, 4]), **kw}
    labels = None if "y" in kw else ["x", "y"]
    if "y" in kw:
        kw.pop("label_codes")
    got = _raised(lambda: pm.MarkovStateTransitionModel(
        ["A", "B", "C"], class_labels=labels or ["a", "b"],
        device=CPU).fit_csr(codes, offsets, skip=2, **kw))
    want = _raised(lambda: jm.MarkovStateTransitionModel(
        ["A", "B", "C"], class_labels=labels or ["a", "b"]).fit_csr(
            codes, offsets, skip=2, **kw))
    assert got == want and got[0] is ValueError


def test_fit_lookup_errors_equal_jax():
    for seqs, labels in (([["A", "Q"]], ["x"]), ([["A", "B"]], ["w"])):
        got = _raised(lambda: pm.MarkovStateTransitionModel(
            STATES3, class_labels=["x"], device=CPU).fit(seqs, labels))
        want = _raised(lambda: jm.MarkovStateTransitionModel(
            STATES3, class_labels=["x"]).fit(seqs, labels))
        assert got == want and got[0] is KeyError
    got = _raised(lambda: pm.MarkovStateTransitionModel(
        STATES3, device=CPU).fit([["A", "B"]]).fit_entities([["A"]], ["k"]))
    want = _raised(lambda: jm.MarkovStateTransitionModel(STATES3).fit(
        [["A", "B"]]).fit_entities([["A"]], ["k"]))
    assert got == want == \
        (ValueError, "fit_entities cannot follow unlabeled fit() counts")


def test_encode_sequences_equals_jax():
    rng = np.random.default_rng(4)
    seqs = _seqs(rng, 50, STATES3) + [[]]
    for a, b in zip(pm.encode_sequences(seqs, STATES3),
                    jm.encode_sequences(seqs, STATES3)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    empty = pm.encode_sequences([], STATES3)
    assert [x.shape for x in empty] == \
        [x.shape for x in jm.encode_sequences([], STATES3)]


# ---------------------------------------------------------- the classifier
def _class_models(seed, states=MARKOV_STATES):
    lines = generate_markov_chains(600, seed=seed)
    rows = [ln.split(",") for ln in lines]
    seqs, labels = [r[2:] for r in rows], [r[1] for r in rows]
    a = pm.MarkovStateTransitionModel(states, class_labels=["C", "L"],
                                      device=CPU).fit(seqs, labels)
    b = jm.MarkovStateTransitionModel(states, class_labels=["C", "L"]).fit(
        seqs, labels)
    return a, b, seqs


@pytest.mark.parametrize("threshold", [0.0, 0.1, -1.5])
@pytest.mark.parametrize("seed", range(3))
def test_classifier_scores_bit_equal_to_jax(seed, threshold):
    a, b, seqs = _class_models(seed)
    pc = pm.MarkovModelClassifier(a, "C", "L", threshold=threshold)
    jc = jm.MarkovModelClassifier(b, "C", "L", threshold=threshold)
    assert np.array_equal(pc.log_odds.view(np.uint32),
                          np.asarray(jc.log_odds).view(np.uint32))
    rng = np.random.default_rng(seed + 50)
    test = seqs[:200] + _seqs(rng, 60, MARKOV_STATES, 0, 30)
    (p_cls, p_s), (j_cls, j_s) = pc.predict(test), jc.predict(test)
    assert p_s.dtype == np.float32
    assert np.array_equal(p_s.view(np.uint32), j_s.view(np.uint32))
    assert list(p_cls) == list(j_cls)
    assert [f"{s:.6f}" for s in p_s] == [f"{s:.6f}" for s in j_s]


def test_classifier_score_is_batch_invariant():
    """A sequence scored alone and inside a batch with longer sequences
    gives the same bits (a sum over the padded axis would not)."""
    a, _, seqs = _class_models(3)
    clf = pm.MarkovModelClassifier(a, "C", "L")
    rng = np.random.default_rng(9)
    long = list(rng.choice(MARKOV_STATES, 400))
    for seq in seqs[:40]:
        alone = clf.predict([seq])[1]
        batched = clf.predict([long, seq, long[:37]])[1]
        assert alone.view(np.uint32)[0] == batched.view(np.uint32)[1]


# ------------------------------------------------------------------ the HMM
def _tagged(rng, n, states, obs, lo=0, hi=12):
    ss = [list(rng.choice(states, int(rng.integers(lo, hi))))
          for _ in range(n)]
    oo = [list(rng.choice(obs, len(s))) for s in ss]
    return ss, oo


@pytest.mark.parametrize("seed", range(3))
def test_hmm_builder_counts_equal_jax(seed):
    """add a row, add_many, add_csr and partially tagged counts, and
    finish, against the JAX builder's."""
    rng = np.random.default_rng(seed)
    states = ["s0", "s1", "s2", "s3"][:3 + seed % 2]
    obs = ["o0", "o1", "o2", "o3", "o4"][:3 + seed]
    ss, oo = _tagged(rng, 200, states, obs)
    want = jm.HiddenMarkovModelBuilder(states, obs)
    for s, o in zip(ss, oo):
        want.add(s, o)
    rows = pm.HiddenMarkovModelBuilder(states, obs, device=CPU)
    for s, o in zip(ss[:20], oo[:20]):
        rows.add(s, o)
    rows.add_many(ss[20:], oo[20:])
    csr = pm.HiddenMarkovModelBuilder(states, obs, device=CPU)
    vocab = [f"{o}:{s}" for s in states for o in obs]
    lines = [",".join([f"r{i}"] + [f"{b}:{a}" for a, b in zip(s, o)])
             for i, (s, o) in enumerate(zip(ss, oo))]
    codes, offsets = _encoded(lines, vocab)
    csr.add_csr(codes, offsets, skip=1)
    jcsr = jm.HiddenMarkovModelBuilder(states, obs)
    jcsr.add_csr(codes, offsets, skip=1)
    for got in (rows, csr, jcsr):
        for name in ("init_counts", "trans_counts", "emis_counts"):
            assert np.array_equal(getattr(got, name), getattr(want, name))
    fin, jfin = rows.finish(), want.finish()
    for name in ("initial", "transition", "emission"):
        assert np.array_equal(getattr(fin, name), getattr(jfin, name))
    wf = [int(v) for v in rng.integers(1, 4, 3)]
    tokens = [list(rng.choice(states + obs, int(rng.integers(0, 15))))
              for _ in range(150)]
    part = pm.HiddenMarkovModelBuilder(states, obs, device=CPU)
    jpart = jm.HiddenMarkovModelBuilder(states, obs)
    for t in tokens:
        part.add_partially_tagged(t, wf)
        jpart.add_partially_tagged(t, wf)
    for name in ("init_counts", "trans_counts", "emis_counts"):
        assert np.array_equal(getattr(part, name), getattr(jpart, name))


def test_hmm_builder_errors_equal_jax():
    vocab = ["x:a", "y:a", "x:b", "y:b"]
    codes, offsets = _encoded(["r0,x:a,y:b", "r1,x:a,z:b"], vocab)
    got = _raised(lambda: pm.HiddenMarkovModelBuilder(
        ["a", "b"], ["x", "y"], device=CPU).add_csr(codes, offsets, 1))
    want = _raised(lambda: jm.HiddenMarkovModelBuilder(
        ["a", "b"], ["x", "y"]).add_csr(codes, offsets, 1))
    assert got == want and "row 1, position 2" in got[1]
    got = _raised(lambda: pm.HiddenMarkovModelBuilder(
        ["a", "b"], ["x", "y"], device=CPU).add(["a", "c"], ["x", "y"]))
    want = _raised(lambda: jm.HiddenMarkovModelBuilder(
        ["a", "b"], ["x", "y"]).add(["a", "c"], ["x", "y"]))
    assert got == want


def _hmm(rng, s, o, ties=False):
    if ties:
        # uniform rows and emissions of two values: most steps tie
        trans = np.full((s, s), 1.0 / s)
        emis = np.where(rng.random((s, o)) < 0.5, 1.0, 2.0)
        emis /= emis.sum(axis=1, keepdims=True)
        init = np.full(s, 1.0 / s)
    else:
        trans = rng.dirichlet(np.ones(s), s)
        emis = rng.dirichlet(np.ones(o), s)
        init = rng.dirichlet(np.ones(s))
    return ([f"s{i}" for i in range(s)], [f"o{j}" for j in range(o)],
            init, trans, emis)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_viterbi_paths_equal_jax(seed, ties):
    """Paths equal element for element on seeded and on tie-heavy HMMs,
    with sequences of lengths 0-2 among longer ones."""
    rng = np.random.default_rng(seed)
    states, obs, init, trans, emis = _hmm(rng, int(rng.integers(3, 6)),
                                          int(rng.integers(3, 7)), ties)
    seqs = [list(rng.choice(obs, int(n)))
            for n in rng.integers(0, 25, 120)]
    seqs += [[obs[0]], [obs[1], obs[2]], [], [obs[2]] * 30]
    hp = pm.HiddenMarkovModel(states, obs, init, trans, emis)
    hj = jm.HiddenMarkovModel(states, obs, init, trans, emis)
    got = pm.ViterbiDecoder(hp, device=CPU).decode(seqs)
    want = jm.ViterbiDecoder(hj).decode(seqs)
    assert got == want


def test_viterbi_uniform_ties_take_the_first_state():
    """All-uniform HMM: every step ties, so jnp.argmax's first maximum
    (state 0) fills every path; torch.argmax must agree."""
    s, o = 4, 3
    args = (["a", "b", "c", "d"], ["x", "y", "z"], np.full(s, 1 / s),
            np.full((s, s), 1 / s), np.full((s, o), 1 / o))
    seqs = [["x", "y", "z", "x"], ["z"], ["y", "y"]]
    got = pm.ViterbiDecoder(pm.HiddenMarkovModel(*args),
                            device=CPU).decode(seqs)
    assert got == jm.ViterbiDecoder(jm.HiddenMarkovModel(*args)).decode(seqs)
    assert got == [["a"] * 4, ["a"], ["a", "a"]]


def test_viterbi_short_batches_decode_where_the_reference_raises():
    """A batch whose longest sequence has one observation (or none), and
    an empty batch: the reference's scan raises IndexError; the port
    decodes each sequence as the reference does inside a longer batch."""
    rng = np.random.default_rng(5)
    states, obs, init, trans, emis = _hmm(rng, 3, 4)
    short = [[obs[int(i)]] for i in rng.integers(0, 4, 10)] + [[]]
    hj = jm.ViterbiDecoder(jm.HiddenMarkovModel(states, obs, init, trans,
                                                emis))
    for batch in (short, []):
        with pytest.raises(IndexError):
            hj.decode(batch)
    dec = pm.ViterbiDecoder(pm.HiddenMarkovModel(states, obs, init, trans,
                                                 emis), device=CPU)
    want = hj.decode(short + [obs[:2]])[:-1]
    assert dec.decode(short) == want
    assert dec.decode([]) == []


def test_viterbi_back_pointers_are_narrow(monkeypatch):
    assert pm._back_dtype(3) == torch.int8
    assert pm._back_dtype(300) == torch.int16
    assert pm._back_dtype(40000) == torch.int32
    # a path does not depend on its batch: cut into batches of 7 rows
    monkeypatch.setattr(pm, "_VITERBI_CAND_BYTES", 7 * 4 * 9)
    rng = np.random.default_rng(8)
    states, obs, init, trans, emis = _hmm(rng, 3, 5)
    seqs = [list(rng.choice(obs, int(n))) for n in rng.integers(0, 20, 50)]
    got = pm.ViterbiDecoder(pm.HiddenMarkovModel(states, obs, init, trans,
                                                 emis), device=CPU)
    assert got.decode(seqs) == jm.ViterbiDecoder(jm.HiddenMarkovModel(
        states, obs, init, trans, emis)).decode(seqs)


# ------------------------------------------------------------ host models
def test_pst_equals_jax():
    rng = np.random.default_rng(2)
    seqs = _seqs(rng, 200, ["a", "b", "c", "d"], 0, 12)
    for depth in (1, 3):
        a = pm.ProbabilisticSuffixTree(["a", "b", "c", "d"], depth).fit(seqs)
        b = jm.ProbabilisticSuffixTree(["a", "b", "c", "d"], depth).fit(seqs)
        assert sorted(a.counts) == sorted(b.counts)
        for ctx in a.counts:
            assert np.array_equal(a.counts[ctx], b.counts[ctx])
        for seq in seqs[:30]:
            assert a.sequence_log_prob(seq) == b.sequence_log_prob(seq)


def test_ctmc_models_equal_jax():
    rng = np.random.default_rng(3)
    states = ["u", "v", "w"]
    seqs = []
    for _ in range(40):
        t = np.cumsum(rng.exponential(2.0, 12), dtype=np.float64)
        seqs.append([(str(rng.choice(states)), float(x)) for x in t])
    a = pm.StateTransitionRate(states).fit(seqs)
    b = jm.StateTransitionRate(states).fit(seqs)
    np.testing.assert_allclose(a.rates(), b.rates(), rtol=1e-12, atol=0)
    assert a.dwell_stats().keys() == b.dwell_stats().keys()
    for k, v in a.dwell_stats().items():
        np.testing.assert_allclose(v, b.dwell_stats()[k], rtol=1e-12)
    q = a.rates()
    for horizon in (0.5, 4.0):
        pc = pm.ContTimeStateTransitionStats(q, states, horizon)
        jc = jm.ContTimeStateTransitionStats(q, states, horizon)
        assert pc.limit == jc.limit
        for init in states:
            for end in (None, "w"):
                np.testing.assert_allclose(
                    pc.dwell_time(init, "v", end),
                    jc.dwell_time(init, "v", end), rtol=1e-12)
                np.testing.assert_allclose(
                    pc.transition_count(init, "u", "v", end),
                    jc.transition_count(init, "u", "v", end), rtol=1e-12)
    with pytest.raises(ValueError, match="no transitions"):
        pm.ContTimeStateTransitionStats(np.zeros((3, 3)), states, 1.0)


def test_event_time_distribution_and_generators_equal_jax():
    rng = np.random.default_rng(6)
    seqs = [sorted(rng.uniform(0, 5e5, int(n)).tolist())
            for n in rng.integers(1, 30, 50)]
    for kw in ({}, {"num_buckets": 7, "bucket_width": 900.0}):
        assert np.array_equal(pm.event_time_distribution(seqs, **kw),
                              jm.event_time_distribution(seqs, **kw))
    assert np.array_equal(pm.event_time_distribution([]),
                          jm.event_time_distribution([]))
    from avenir_tpu.data.generators import generate_event_sequences as jgen

    assert generate_event_sequences(60, seed=4) == jgen(60, seed=4)
    trans = np.array([[0.7, 0.3], [0.4, 0.6]])
    assert pm.generate_markov_sequences(trans, np.array([.5, .5]), ["p", "q"],
                                        20, 6, seed=3) == \
        jm.generate_markov_sequences(trans, np.array([.5, .5]), ["p", "q"],
                                     20, 6, seed=3)


def test_tutorial_generators_follow_their_chains():
    lines = generate_markov_chains(3000, seed=1, n_entities=40)
    rows = [ln.split(",") for ln in lines]
    assert {r[1] for r in rows} == {"C", "L"}
    assert {len(r) - 2 for r in rows} == set(range(6, 14))
    assert len({r[0] for r in rows}) == 40
    assert {t for r in rows for t in r[2:]} == set(MARKOV_STATES)
    rows, hidden, lens = generate_loyalty_sequences(4000, seed=2)
    assert lens.min() >= 1 and lens.max() <= 40
    assert abs(lens.mean() - 10) < 0.3
    toks = rows[0].split(",")
    assert toks[0] == "cust0" and len(toks) == lens[0] + 1
    assert set(toks[1:]) <= set(LOYALTY_OBS)
    # the first hidden state follows the initial distribution
    share = np.bincount(hidden[:, 0], minlength=3) / 4000
    np.testing.assert_allclose(share, [.30, .45, .25], atol=0.03)
    tagged, hid2, _ = generate_loyalty_sequences(5, seed=2, tagged=True)
    first = tagged[0].split(",")[1].split(":")
    assert first[1] == LOYALTY_STATES[hid2[0, 0]]


# ----------------------------------------------------------------- the jobs
@pytest.mark.parametrize("crlf", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_markov_per_class_job_byte_identical(tmp_path, monkeypatch, route,
                                             crlf):
    csv = _chains(tmp_path / "s.csv", crlf=crlf)
    if route == "python":
        _python_route(monkeypatch)
    with obs.capture() as rec:
        port, jax, got, want = _both(tmp_path, "markovStateTransitionModel",
                                     MST, [csv])
    assert got == want and len(got) == 2
    assert _job_counters(port.counters) == {"Basic:Records": 1500} == \
        {k: v for k, v in jax.counters.items() if k == "Basic:Records"}
    _same_prediction(port.counters, jax.counters)
    engines = {sp.attrs.get("engine") for sp in rec.spans()
               if sp.name == "stream.parse"}
    assert engines == {"native" if route == "native" else "lines"}


def test_markov_label_that_is_a_state_byte_identical(tmp_path):
    """A class label named like a state shares its code (native route)."""
    rng = np.random.default_rng(1)
    lines = [",".join([f"r{i}", str(rng.choice(["A", "z"]))]
                      + list(rng.choice(STATES3, 7))) for i in range(500)]
    csv = tmp_path / "s.csv"
    csv.write_text("\n".join(lines) + "\n")
    props = {"mst.model.states": "A,B,C", "mst.skip.field.count": "2",
             "mst.class.label.field.ord": "1", "mst.class.labels": "A,z",
             "mst.stream.block.size.mb": "0.002"}
    _, _, got, want = _both(tmp_path, "markovStateTransitionModel", props, [str(csv)])
    assert got == want


@pytest.mark.parametrize("fault", ["state", "label", "short"])
@pytest.mark.parametrize("route", ROUTES)
def test_markov_job_errors_equal_jax(tmp_path, monkeypatch, route, fault):
    lines = generate_markov_chains(50, seed=3)
    lines[30] = {"state": lines[30] + ",warp", "label": "c30,X,browse,cart",
                 "short": "c30"}[fault]
    csv = tmp_path / "s.csv"
    csv.write_text("\n".join(lines) + "\n")
    if route == "python":
        _python_route(monkeypatch)
    got = _raised(lambda: run_job("markovStateTransitionModel", MST, [str(csv)],
                                  str(tmp_path / "p"), device=CPU))
    want = _raised(lambda: jax_run_job("markovStateTransitionModel", MST, [str(csv)],
                                       str(tmp_path / "j")))
    assert got == want


ENTITY = {"mst.state.list": ",".join(MARKOV_STATES),
          "mst.id.field.ordinals": "0", "mst.seq.start.ordinal": "2",
          "mst.stream.block.size.mb": "0.004"}


@pytest.mark.parametrize("conf", ["id", "id_class", "class_only"])
@pytest.mark.parametrize("route", ROUTES)
def test_markov_per_entity_job_byte_identical(tmp_path, monkeypatch, route,
                                              conf):
    """One matrix an entity key (17 customers, first-seen order across
    blocks), split by class with class.attr.ordinal."""
    csv = _chains(tmp_path / "s.csv", n=1200, entities=17)
    props = dict(ENTITY)
    if conf == "id_class":
        props["mst.class.attr.ordinal"] = "1"
    if conf == "class_only":
        props = {**props, "mst.id.field.ordinals": ",",
                 "mst.class.attr.ordinal": "1"}
        del props["mst.seq.start.ordinal"]
    if route == "python":
        _python_route(monkeypatch)
    port, jax, got, want = _both(tmp_path, "markovStateTransitionModel",
                                 props, [csv])
    assert got == want
    n = {"id": 17, "id_class": 34, "class_only": 2}[conf]
    assert _job_counters(port.counters) == {"Entities:Count": n} == \
        {"Entities:Count": jax.counters["Entities:Count"]}
    _same_prediction(port.counters, jax.counters)
    # with no id column the reference's routes key apart: the Python rows
    # join the empty id list and the class (",C"), the native columns give
    # the class alone ("C"); each route matches its own reference route
    first = {"id": "cust0", "id_class": "cust0,C",
             "class_only": "C" if route == "native" else ",C"}[conf]
    assert f"entity:{first}\n" in Path(port.outputs[0]).read_text()


@pytest.mark.parametrize("route", ROUTES)
def test_markov_per_entity_errors_equal_jax(tmp_path, monkeypatch, route):
    csv = tmp_path / "s.csv"
    csv.write_text("c0,C,browse,cart\nc1\n")
    if route == "python":
        _python_route(monkeypatch)
    props = {**ENTITY, "mst.class.attr.ordinal": "1"}
    got = _raised(lambda: run_job("markovStateTransitionModel", props, [str(csv)],
                                  str(tmp_path / "p"), device=CPU))
    want = _raised(lambda: jax_run_job("markovStateTransitionModel", props, [str(csv)],
                                       str(tmp_path / "j")))
    assert got == want and "row 1 has no id/class field" in got[1]
    csv.write_text("")
    got = _raised(lambda: run_job("markovStateTransitionModel", ENTITY, [str(csv)],
                                  str(tmp_path / "p"), device=CPU))
    want = _raised(lambda: jax_run_job("markovStateTransitionModel", ENTITY, [str(csv)],
                                       str(tmp_path / "j")))
    assert got == want


@pytest.mark.parametrize("validation", [False, True])
def test_markov_classifier_job_byte_identical(tmp_path, validation):
    csv = _chains(tmp_path / "s.csv", n=1400, seed=8)
    model = tmp_path / "mst.txt"
    jax_run_job("markovStateTransitionModel", MST, [csv], str(model))
    props = {"mmc.mm.model.path": str(model), "mmc.class.labels": "C,L",
             "mmc.skip.field.count": "2", "mmc.class.label.field.ord": "1",
             "mmc.validation.mode": str(validation).lower(),
             "mmc.stream.block.size.mb": "0.01",
             "mmc.log.odds.threshold": "0.05"}
    port, jax, got, want = _both(tmp_path, "markovModelClassifier", props,
                                 [csv])
    assert got == want
    assert port.counters == jax.counters
    if validation:
        assert port.counters["Validation:Accuracy"] > 85


@pytest.mark.parametrize("route", ROUTES)
def test_hmm_builder_job_byte_identical(tmp_path, monkeypatch, route):
    rows, _, _ = generate_loyalty_sequences(1200, seed=4, tagged=True)
    csv = tmp_path / "t.csv"
    csv.write_text("\n".join(rows) + "\n")
    props = {"hmmb.model.states": ",".join(LOYALTY_STATES),
             "hmmb.model.observations": ",".join(LOYALTY_OBS),
             "hmmb.stream.block.size.mb": "0.005"}
    if route == "python":
        _python_route(monkeypatch)
    _, _, got, want = _both(tmp_path, "hiddenMarkovModelBuilder", props,
                            [str(csv)])
    assert got == want


def test_hmm_builder_partially_tagged_job_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    states, obs = ["S1", "S2", "S3"], ["a", "b", "c", "d"]
    lines = [",".join([f"r{i}"] + list(rng.choice(
        obs + states, int(rng.integers(1, 16)), p=[.2] * 4 + [.2 / 3] * 3)))
        for i in range(600)]
    csv = tmp_path / "t.csv"
    csv.write_text("\n".join(lines) + "\n")
    props = {"hmmb.model.states": ",".join(states),
             "hmmb.model.observations": ",".join(obs),
             "hmmb.partially.tagged": "true",
             "hmmb.window.function": "3,2,1",
             "hmmb.stream.block.size.mb": "0.003"}
    _, _, got, want = _both(tmp_path, "hiddenMarkovModelBuilder", props, [str(csv)])
    assert got == want


def test_viterbi_job_byte_identical(tmp_path):
    rows, hidden, lens = generate_loyalty_sequences(1500, seed=6)
    csv = tmp_path / "o.csv"
    csv.write_text("\n".join(rows) + "\n")
    from avenir_tpu_torch.data.generators import (LOYALTY_EMISSION,
                                                  LOYALTY_INITIAL,
                                                  LOYALTY_TRANSITION)

    model = tmp_path / "hmm.txt"
    jm.HiddenMarkovModel(LOYALTY_STATES, LOYALTY_OBS,
                         np.array(LOYALTY_INITIAL),
                         np.array(LOYALTY_TRANSITION),
                         np.array(LOYALTY_EMISSION)).save(str(model))
    props = {"vsp.hmm.model.path": str(model)}
    port, _, got, want = _both(tmp_path, "viterbiStatePredictor", props,
                               [str(csv)])
    assert got == want
    decoded = [ln.split(",")[1:] for ln in
               Path(port.outputs[0]).read_text().splitlines()]
    hits = sum(LOYALTY_STATES[hidden[i, t]] == s
               for i, row in enumerate(decoded) for t, s in enumerate(row))
    assert hits / lens.sum() > 0.45


def test_viterbi_job_on_an_empty_file(tmp_path):
    """The reference raises IndexError on an empty file; the port writes
    an empty one."""
    rng = np.random.default_rng(1)
    model = tmp_path / "hmm.txt"
    pm.HiddenMarkovModel(*_hmm(rng, 3, 3)).save(str(model))
    csv = tmp_path / "o.csv"
    csv.write_text("")
    props = {"vsp.hmm.model.path": str(model)}
    with pytest.raises(IndexError):
        jax_run_job("viterbiStatePredictor", props, [str(csv)],
                    str(tmp_path / "j"))
    res = run_job("viterbiStatePredictor", props, [str(csv)],
                  str(tmp_path / "p"), device=CPU)
    assert Path(res.outputs[0]).read_text() == ""


def test_pst_job_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    csv = tmp_path / "s.csv"
    csv.write_text("".join(
        ",".join([f"r{i}"] + list(rng.choice(list("abcd"),
                                              int(rng.integers(1, 12)))))
        + "\n" for i in range(800)))
    for depth in ("2", "3"):
        _, _, got, want = _both(tmp_path, "probabilisticSuffixTree",
                                {"pstg.max.seq.length": depth}, [str(csv)],
                                name=depth)
        assert got == want


def _state_rows(tmp_path, n=2500, seed=5):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(3.6e6, n)).astype(np.int64)
    csv = tmp_path / "events.csv"
    csv.write_text("".join(
        f"k{int(k)},{int(ts)},{s}\n" for k, ts, s in zip(
            rng.integers(0, 6, n), t, rng.choice(["P", "Q", "R"], n))))
    return str(csv)


def test_state_transition_rate_job_byte_identical(tmp_path):
    csv = _state_rows(tmp_path)
    props = {"str.time.field.ordinal": "1", "str.state.field.ordinal": "2",
             "str.state.values": "P,Q,R", "str.rate.time.unit": "day"}
    port, jax, got, want = _both(tmp_path, "stateTransitionRate", props,
                                 [csv])
    assert got == want and port.counters == jax.counters


@pytest.mark.parametrize("stat", ["stateDwellTime", "StateTransitionCount"])
@pytest.mark.parametrize("rates", ["matrix", "per_entity"])
def test_ctmc_stats_job_byte_identical(tmp_path, rates, stat):
    events = _state_rows(tmp_path, n=1500, seed=2)
    rate_file = tmp_path / "rates.txt"
    if rates == "per_entity":
        jax_run_job("stateTransitionRate",
                    {"str.time.field.ordinal": "1",
                     "str.state.field.ordinal": "2",
                     "str.state.values": "P,Q,R"}, [events], str(rate_file))
    else:
        rate_file.write_text("0,0.4,0.1\n0.2,0,0.3\n0.5,0.25,0\n")
    rng = np.random.default_rng(4)
    rows = tmp_path / "rows.csv"
    rows.write_text("".join(
        f"k{int(k)},{a}" + (f",{b}" if int(k) % 2 else "") + "\n"
        for k, a, b in zip(rng.integers(0, 6, 300),
                           rng.choice(["P", "Q", "R"], 300),
                           rng.choice(["P", "Q", "R"], 300))))
    props = {"cts.state.values": "P,Q,R", "cts.time.horizon": "3.0",
             "cts.state.trans.file.path": str(rate_file),
             "cts.state.trans.stat": stat, "cts.target.states": "Q,R"}
    _, _, got, want = _both(tmp_path, "contTimeStateTransitionStats", props,
                            [str(rows)])
    assert got == want


def test_event_time_job_byte_identical(tmp_path):
    rng = np.random.default_rng(8)
    csv = tmp_path / "ev.csv"
    csv.write_text("".join(f"u{int(u)},{float(t):.1f}\n" for u, t in zip(
        rng.integers(0, 30, 2000), rng.uniform(0, 1e6, 2000))))
    for props in ({}, {"etd.num.buckets": "10",
                       "etd.bucket.width": "1800"}):
        port, jax, got, want = _both(tmp_path, "eventTimeDistribution",
                                     props, [str(csv)],
                                     name=str(len(props)))
        assert got == want and port.counters == jax.counters


def test_jobs_are_registered_and_want_a_card(tmp_path, monkeypatch):
    names = set(job_names())
    for canonical, aliases in {
            "markovStateTransitionModel": (
                "org.avenir.markov.MarkovStateTransitionModel",
                "org.avenir.spark.sequence.MarkovStateTransitionModel"),
            "markovModelClassifier": (
                "org.avenir.markov.MarkovModelClassifier",
                "org.avenir.spark.sequence.MarkovModelClassifier"),
            "hiddenMarkovModelBuilder": (
                "org.avenir.markov.HiddenMarkovModelBuilder",),
            "viterbiStatePredictor": (
                "org.avenir.markov.ViterbiStatePredictor",),
            "probabilisticSuffixTree": (
                "org.avenir.markov.ProbabilisticSuffixTreeGenerator",),
            "stateTransitionRate": (
                "org.avenir.spark.markov.StateTransitionRate",),
            "contTimeStateTransitionStats": (
                "org.avenir.spark.markov.ContTimeStateTransitionStats",),
            "eventTimeDistribution": (
                "org.avenir.spark.sequence.EventTimeDistribution",)}.items():
        assert {canonical, *aliases} <= names
    csv = _chains(tmp_path / "s.csv", n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_job("markovStateTransitionModel", MST, [csv], str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.MarkovStateTransitionModel(STATES3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.ViterbiDecoder(pm.HiddenMarkovModel(
            *_hmm(np.random.default_rng(0), 3, 3)))


# ------------------------------------------------------- the shared scan
def _seq_rows(tmp_path, rows=800):
    """The JAX package's tests/test_shared_scan.py `_seq` corpus."""
    rng = np.random.default_rng(12)
    states = ["L", "M", "H"]
    csv = tmp_path / "seq.csv"
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


SHARED = {
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


def _out(tmp_path, tag, job):
    return str(tmp_path / (f"{tag}_mst.txt" if job.startswith("markov")
                           else f"{tag}_{job}"))


@pytest.mark.parametrize("route", ROUTES)
def test_run_shared_markov_apriori_gsp(tmp_path, monkeypatch, route):
    """The JAX package's bytes-kind fused case (tests/test_shared_scan.py
    `test_bytes_fused_outputs_byte_identical`): markov, Apriori and GSP in
    one scan, each job's files equal to its solo run's and to the JAX
    package's fused and solo runs."""
    csv = _seq_rows(tmp_path)
    if route == "python":
        _python_route(monkeypatch)
    assert "markovStateTransitionModel" in stream_fold_names()
    assert stream_fold_ops("markovStateTransitionModel").kind == "bytes"
    def reads(rec):
        return sum(sp.name == "stream.read" for sp in rec.spans())

    # the sidecar off: every run reads the text, so the reads compare
    shared = {j: {**p, next(iter(p)).split(".")[0] + ".stream.sidecar":
                  "false"} for j, p in SHARED.items()}
    with obs.capture() as rec:
        fused = run_shared([(j, p, _out(tmp_path, "fused", j))
                            for j, p in shared.items()], [csv], device=CPU)
    fused_reads, solo_reads = reads(rec), 0
    jfused = jax_run_shared([(j, p, _out(tmp_path, "jfused", j))
                             for j, p in shared.items()], [csv])
    for job, props in shared.items():
        with obs.capture() as rec:
            solo = run_job(job, props, [csv], _out(tmp_path, "solo", job),
                           device=CPU)
        solo_reads += reads(rec)
        jsolo = jax_run_job(job, props, [csv], _out(tmp_path, "jsolo", job))
        files = [sorted(_bytes(r.outputs).values())
                 for r in (fused[job], solo, jfused[job], jsolo)]
        assert files[0] == files[1] == files[2] == files[3], job
    assert _job_counters(fused["markovStateTransitionModel"].counters) == \
        {"Basic:Records": 800}
    for job in fused:
        _same_prediction(fused[job].counters, jfused[job].counters)
    # one scan where the solo runs made three: the miners' later rounds
    # re-read the file in both
    blocks = len(list(stream_job_byte_blocks(
        JobConfig(SHARED["frequentItemsApriori"], "fia"), [csv])))
    assert blocks >= 4
    assert fused_reads == solo_reads - 2 * blocks


def test_pipeline_fuses_markov_with_the_miners(tmp_path):
    csv = _seq_rows(tmp_path, rows=600)
    props = {k: v for p in SHARED.values() for k, v in p.items()}
    stages = [Stage(j, j, [csv], _out(tmp_path, "pipe", j))
              for j in SHARED]
    calls = []
    results = Pipeline(props, stages, device=CPU,
                       on_retry=lambda *a: calls.append(a)).run(fuse=True)
    assert not calls
    for job in SHARED:
        solo = run_job(job, props, [csv], _out(tmp_path, "solo", job),
                       device=CPU)
        assert sorted(_bytes(results[job].outputs).values()) == \
            sorted(_bytes(solo.outputs).values())


def test_per_entity_config_is_not_fusable(tmp_path):
    csv = _chains(tmp_path / "s.csv", n=50)
    with pytest.raises(ValueError, match="not shared-scan fusable"):
        run_shared([("markovStateTransitionModel", ENTITY, str(tmp_path / "o"))], [csv], device=CPU)


def _blocks(csv, props=MST):
    return list(stream_job_byte_blocks(JobConfig(props, "mst"), [csv]))


@pytest.mark.parametrize("source", ["port", "jax"])
def test_checkpoint_mid_scan_crosses_packages(tmp_path, source):
    """A fold checkpointed half-way through the scan in one package
    finishes in the other to the solo run's bytes."""
    csv = _chains(tmp_path / "s.csv", n=2000, seed=4)
    blocks = _blocks(csv)
    assert len(blocks) >= 4
    ops = stream_fold_ops("markovStateTransitionModel")
    jops = jax_stream_fold_ops("markovStateTransitionModel")
    if source == "port":
        first = ops.factory(JobConfig(MST, "mst"), [csv], None,
                            torch.device(CPU))
        blob = ops.serialize_state
    else:
        first = jops.factory(JaxJobConfig(MST, "mst"), [csv])
        blob = jops.serialize_state
    for b in blocks[:len(blocks) // 2]:
        first.consume(b)
    state = blob(first)
    if source == "port":
        fold = jops.restore_state(JaxJobConfig(MST, "mst"), [csv], state)
    else:
        fold = ops.restore_state(JobConfig(MST, "mst"), [csv], state,
                                 device=CPU)
    for b in blocks[len(blocks) // 2:]:
        fold.consume(b)
    got = fold.finish(str(tmp_path / "resumed.txt"))
    want = run_job("markovStateTransitionModel", MST, [csv], str(tmp_path / "solo.txt"), device=CPU)
    assert _bytes(got.outputs) == {
        k.replace("solo", "resumed"): v for k, v in
        _bytes(want.outputs).items()}
    assert got.counters["Basic:Records"] == 2000


def test_fold_checkpoint_refuses_another_config(tmp_path):
    csv = _chains(tmp_path / "s.csv", n=100)
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(
        {"rows": 3, "states": ["x", "y"], "class_labels": ["C", "L"]})),
        counts=np.zeros((2, 2, 2)))
    with pytest.raises(ValueError, match="do not match the job config"):
        stream_fold_ops("markovStateTransitionModel").restore_state(
            JobConfig(MST, "mst"), [csv], buf.getvalue(), device=CPU)
    buf = io.BytesIO()
    np.savez(buf, meta=np.array(json.dumps(
        {"rows": 3, "states": MARKOV_STATES, "class_labels": ["C", "L"]})),
        counts=np.zeros((3, 5, 5)))
    with pytest.raises(ValueError, match="counts shape"):
        stream_fold_ops("markovStateTransitionModel").restore_state(
            JobConfig(MST, "mst"), [csv], buf.getvalue(), device=CPU)


def test_merged_shard_folds_equal_the_whole_file(tmp_path):
    lines = generate_markov_chains(1600, seed=9)
    paths = []
    for i in range(2):
        p = tmp_path / f"part{i}.csv"
        p.write_text("\n".join(lines[i::2]) + "\n")
        paths.append(str(p))
    whole = tmp_path / "whole.csv"
    whole.write_text("".join(Path(p).read_text() for p in paths))
    ops = stream_fold_ops("markovStateTransitionModel")
    folds = []
    for p in paths:
        f = ops.factory(JobConfig(MST, "mst"), [p], None, torch.device(CPU))
        for b in _blocks(p):
            f.consume(b)
        folds.append(f)
    merged = ops.merge_states(folds[0], folds[1])
    got = merged.finish(str(tmp_path / "merged.txt"))
    want = jax_run_job("markovStateTransitionModel", MST, [str(whole)], str(tmp_path / "whole.txt"))
    assert Path(got.outputs[0]).read_bytes() == \
        Path(want.outputs[0]).read_bytes()
    assert got.counters["Basic:Records"] == 1600
    with pytest.raises(ValueError, match="cannot merge"):
        other = ops.factory(JobConfig({**MST, "mst.class.labels": "L,C"},
                                      "mst"), [paths[0]], None,
                            torch.device(CPU))
        ops.merge_states(folds[0], other)


# ----------------------------------------------------------------- convert
def test_convert_markov_and_hmm(tmp_path):
    _, b, seqs = _class_models(5)
    m = convert.markov_model_from_jax_arrays(b.states, b.scale,
                                             b.class_labels, b.counts,
                                             device=CPU)
    b.save(str(tmp_path / "j.txt"))
    m.save(str(tmp_path / "p.txt"))
    assert (tmp_path / "j.txt").read_bytes() == \
        (tmp_path / "p.txt").read_bytes()
    pc = pm.MarkovModelClassifier(m, "C", "L").predict(seqs[:50])[1]
    jc = jm.MarkovModelClassifier(b, "C", "L").predict(seqs[:50])[1]
    assert np.array_equal(pc.view(np.uint32), jc.view(np.uint32))
    with pytest.raises(ValueError, match="counts have shape"):
        convert.markov_model_from_jax_arrays(b.states, b.scale, None,
                                             b.counts, device=CPU)
    rng = np.random.default_rng(2)
    jh = jm.HiddenMarkovModel(*_hmm(rng, 3, 4))
    ph = convert.hmm_from_jax_arrays(jh.states, jh.observations, jh.initial,
                                     jh.transition, jh.emission)
    jh.save(str(tmp_path / "jh.txt"))
    ph.save(str(tmp_path / "ph.txt"))
    assert (tmp_path / "jh.txt").read_bytes() == \
        (tmp_path / "ph.txt").read_bytes()
    obs_seqs = [list(rng.choice(jh.observations, 9)) for _ in range(20)]
    assert pm.ViterbiDecoder(ph, device=CPU).decode(obs_seqs) == \
        jm.ViterbiDecoder(jh).decode(obs_seqs)
    with pytest.raises(ValueError, match="emission has shape"):
        convert.hmm_from_jax_arrays(jh.states, jh.observations[:2],
                                    jh.initial, jh.transition, jh.emission)


def test_model_files_load_across_packages(tmp_path):
    _, b, _ = _class_models(6)
    b.save(str(tmp_path / "m.txt"))
    a = pm.MarkovStateTransitionModel.load(str(tmp_path / "m.txt"),
                                           device=CPU)
    assert a.class_labels == b.class_labels
    assert np.array_equal(a.counts, jm.MarkovStateTransitionModel.load(
        str(tmp_path / "m.txt")).counts)
    (tmp_path / "m.txt").write_text("tampered\n")
    from avenir_tpu_torch.models.artifact import ModelFormatSkew

    with pytest.raises(ModelFormatSkew):
        pm.MarkovStateTransitionModel.load(str(tmp_path / "m.txt"),
                                           device=CPU)
