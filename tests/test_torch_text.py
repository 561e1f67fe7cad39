"""The port's free-text path (`avenir_tpu_torch.models.text`, the
`wordCounter` job and `bayesianDistr`'s `bad.tabular.input=false` mode) on
the CPU against the JAX package, on the same seeded corpus:

- `tokenize` and `WordCounter.count` equal; the `wordCounter` file
  byte-identical, of whole lines and of one field, in one block and in
  many;
- the text-mode model CSV byte-identical, in one block and in many, and
  its counter equal; a row without the delimiter raises as in JAX;
- `TextNaiveBayes.scores` within 1e-5 relative of JAX's (a float32
  product in another summation order: log-likelihoods of tens to
  hundreds, where a float32 step is 4e-6 to 1.5e-5) and `predict` equal;
- `convert.text_nb_from_jax_arrays`: a JAX model's arrays rebuild a port
  model that scores, predicts and saves as it does.
"""

import numpy as np
import pytest

import torch_reference_native  # noqa: F401  (settles the reference's native route)
from avenir_tpu.models import text as jtext
from avenir_tpu.runner import run_job as jax_run_job
from avenir_tpu_torch import obs
from avenir_tpu_torch.models import text as ptext
from avenir_tpu_torch.models.convert import text_nb_from_jax_arrays
from avenir_tpu_torch.runner import DELTA_COUNTERS, run_job

CPU = "cpu"
ROWS = 3000
CLASSES = ("ham", "news", "spam", "sport")


def make_corpus(rows: int, seed: int, vocab_size: int = 600) -> str:
    """`text,classVal` lines: 8-20 tokens each from a seeded vocabulary
    with stop words, capitals, digits, apostrophes and punctuation mixed
    in; each class leans on its own quarter of the vocabulary."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab_size)]
    extra = ["The", "and", "a", "IS", "of", "don't", "it's", "2024",
             "x-ray", "U.S.", "...", "re-run", "O'Neil"]
    lines = []
    for _ in range(rows):
        c = int(rng.integers(0, len(CLASSES)))
        n = int(rng.integers(8, 21))
        lean = rng.random(n) < 0.4
        idx = np.where(lean, c * vocab_size // 4
                       + rng.integers(0, vocab_size // 4, n),
                       rng.integers(0, vocab_size, n))
        toks = [extra[int(rng.integers(0, len(extra)))]
                if rng.random() < 0.15 else words[i] for i in idx]
        lines.append(" ".join(toks) + "," + CLASSES[c])
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("text")
    train = d / "train.txt"
    train.write_text(make_corpus(ROWS, seed=5))
    test = d / "test.txt"
    test.write_text(make_corpus(400, seed=6))
    return {"train": str(train), "test": str(test),
            "block": f"{train.stat().st_size / 3 / (1 << 20):.4f}"}


@pytest.mark.parametrize("drop", [True, False])
def test_tokenize_and_count_match_jax(corpus, drop):
    lines = open(corpus["train"]).read().splitlines()
    for ln in lines[:300] + ["", "   ", "Don't STOP the U.S. x-ray 42!"]:
        assert ptext.tokenize(ln, drop) == jtext.tokenize(ln, drop)
    for ordinal in (-1, 0):
        got = ptext.WordCounter(ordinal, drop_stop_words=drop).count(lines)
        ref = jtext.WordCounter(ordinal, drop_stop_words=drop).count(lines)
        assert got == ref and len(got) > 600
    assert ptext.STOP_WORDS == jtext.STOP_WORDS


@pytest.mark.parametrize("ordinal", [None, "0"])
@pytest.mark.parametrize("blocks", [1, 3])
def test_word_counter_file_matches_jax(corpus, tmp_path, ordinal, blocks):
    props = {}
    if ordinal is not None:
        props["wco.text.field.ordinal"] = ordinal
    if blocks > 1:
        props["wco.stream.block.size.mb"] = corpus["block"]
    ref = jax_run_job("wordCounter", props, [corpus["train"]],
                      str(tmp_path / "jax.txt"))
    with obs.capture() as rec:
        got = run_job("org.avenir.text.WordCounter", props, [corpus["train"]],
                      str(tmp_path / "port.txt"), device=CPU)
    assert got.counters == ref.counters
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    folds = [sp for sp in rec.spans() if sp.name == "stream.fold"]
    assert len(folds) == blocks
    assert {"job.run", "stream.read", "stream.parse", "job.finish"} <= \
        {sp.name for sp in rec.spans()}


@pytest.mark.parametrize("blocks", [1, 3])
def test_text_mode_model_matches_jax(corpus, tmp_path, blocks):
    props = {"bad.tabular.input": "false"}
    if blocks > 1:
        props["bad.stream.block.size.mb"] = corpus["block"]
    ref = jax_run_job("bayesianDistr", props, [corpus["train"]],
                      str(tmp_path / "jax.csv"))
    with obs.capture() as rec:
        got = run_job("bayesianDistr", props, [corpus["train"]],
                      str(tmp_path / "port.csv"), device=CPU)
    # free text reads no sidecar: its delta-scan counters stay 0; the
    # memory model's prediction is the reference's, the peak RSS the
    # process's
    assert got.counters["Mem:PeakRSS"] > 0
    assert {k: v for k, v in got.counters.items() if k != "Mem:PeakRSS"} \
        == {"Distribution Data:Records": ROWS,
            **dict.fromkeys(DELTA_COUNTERS, 0.0),
            "Mem:PredictedPeakBytes": ref.counters["Mem:PredictedPeakBytes"]}
    assert {k: v for k, v in ref.counters.items() if k.startswith("Dist")} \
        == {"Distribution Data:Records": ROWS}
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    folds = [sp for sp in rec.spans() if sp.name == "stream.fold"]
    assert len(folds) == blocks


def test_text_mode_row_without_delimiter_raises_as_jax(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("good words here,spam\nno delimiter at all\n")
    props = {"bad.tabular.input": "false"}
    with pytest.raises(ValueError) as got:
        run_job("bayesianDistr", props, [str(bad)], str(tmp_path / "p"),
                device=CPU)
    with pytest.raises(ValueError) as ref:
        jax_run_job("bayesianDistr", props, [str(bad)], str(tmp_path / "j"))
    assert str(got.value) == str(ref.value)


def _texts_labels(path):
    rows = [ln.rpartition(",") for ln in open(path).read().splitlines()]
    return [t for t, _, _ in rows], [c for _, _, c in rows]


def test_scores_within_1e5_relative_and_predict_equal(corpus):
    texts, labels = _texts_labels(corpus["train"])
    test_texts, _ = _texts_labels(corpus["test"])
    test_texts += ["", "w1 unseen-token zzz", "the and of"]
    model = ptext.TextNaiveBayes(device=CPU).fit(texts, labels)
    ref = jtext.TextNaiveBayes().fit(texts, labels)
    assert model.class_values == ref.class_values == list(CLASSES)
    got_s, ref_s = model.scores(test_texts), ref.scores(test_texts)
    assert got_s.dtype == np.float32 and got_s.shape == ref_s.shape
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-5, atol=0)
    assert model.predict(test_texts) == ref.predict(test_texts)


def test_text_nb_from_jax_arrays(corpus, tmp_path):
    texts, labels = _texts_labels(corpus["train"])
    test_texts, _ = _texts_labels(corpus["test"])
    ref = jtext.TextNaiveBayes(laplace=0.5).fit(texts, labels)
    inv = sorted(ref.vocab, key=ref.vocab.get)
    meta = {"vocab": inv, "class_values": ref.class_values,
            "laplace": ref.laplace, "drop_stop": ref.drop_stop}
    arrays = {"log_prob": ref.log_prob, "log_prior": ref.log_prior,
              "class_counts": ref._class_counts[np.argsort(ref._classes)]}
    model = text_nb_from_jax_arrays(arrays, meta, device=CPU)
    np.testing.assert_allclose(model.scores(test_texts),
                               ref.scores(test_texts), rtol=1e-5, atol=0)
    assert model.predict(test_texts) == ref.predict(test_texts)
    model.save(str(tmp_path / "port.csv"))
    ref.save(str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()
    # a model the JAX package loaded from its file has no class counts
    loaded = jtext.TextNaiveBayes.load(str(tmp_path / "jax.csv"))
    again = text_nb_from_jax_arrays(
        {"log_prob": loaded.log_prob, "log_prior": loaded.log_prior,
         "class_counts": loaded._class_counts},
        {"vocab": sorted(loaded.vocab, key=loaded.vocab.get),
         "class_values": loaded.class_values, "laplace": loaded.laplace,
         "drop_stop": loaded.drop_stop}, device=CPU)
    assert again.predict(test_texts) == loaded.predict(test_texts)
    with pytest.raises(ValueError, match="class_counts"):
        text_nb_from_jax_arrays({**arrays, "class_counts":
                                 arrays["class_counts"][::-1] + 1}, meta,
                                device=CPU)
