"""Text utilities: tokenizer, word counting and free-text Naive Bayes.

The port of `avenir_tpu/models/text.py`. Reference (SURVEY §2.8 text/):
WordCounter.java:54 — an MR job that splits a CSV field (or the whole
line) with a Lucene StandardAnalyzer and counts tokens. The same
tokenizer backs the Naive Bayes free-text mode
(BayesianDistribution.java:186-195).

The StandardAnalyzer's observable behavior — lowercase, split on
non-alphanumerics, keep digits, drop English stop words — is reproduced
with a host regex tokenizer (tokenizing is host string work; the counting
after dictionary-encoding is a host `np.bincount`, as in the JAX
package). Scoring free text is a bag-of-words float32 product on the
device the model was made for (default cuda)."""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

# Lucene StandardAnalyzer's default English stop set
STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such "
    "that the their then there these they this to was will with".split())

_TOKEN_RE = re.compile(r"[a-z0-9]+(?:'[a-z0-9]+)?")


def tokenize(text: str, drop_stop_words: bool = True) -> List[str]:
    """StandardAnalyzer-like tokens: lowercased alphanumeric runs,
    stop words removed."""
    toks = _TOKEN_RE.findall(text.lower())
    if drop_stop_words:
        return [t for t in toks if t not in STOP_WORDS]
    return toks


class WordCounter:
    """Word-count job (WordCounter.java:54): count tokens of one CSV field
    (text_field_ordinal >= 0) or of whole lines (< 0); output rows of
    (token, count)."""

    def __init__(self, text_field_ordinal: int = -1, delim: str = ",",
                 drop_stop_words: bool = True):
        self.ordinal = text_field_ordinal
        self.delim = delim
        self.drop_stop = drop_stop_words

    def count(self, lines: Iterable[str]) -> List[Tuple[str, int]]:
        vocab: Dict[str, int] = {}
        codes: List[int] = []
        for line in lines:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            text = (line.split(self.delim)[self.ordinal]
                    if self.ordinal >= 0 else line)
            for tok in tokenize(text, self.drop_stop):
                codes.append(vocab.setdefault(tok, len(vocab)))
        if not codes:
            return []
        counts = np.bincount(np.asarray(codes, np.int64), minlength=len(vocab))
        inv = list(vocab)
        return sorted(((inv[i], int(c)) for i, c in enumerate(counts)),
                      key=lambda kv: (-kv[1], kv[0]))


class TextNaiveBayes:
    """Free-text Naive Bayes — the reference's text-input mode of
    BayesianDistribution (mapText, BayesianDistribution.java:186-195:
    rows are `text,classVal`; each Lucene token contributes a
    (classVal, token) count) with the matching multinomial predictor.

    Tokens dictionary-encode on the host (string work); training counts
    fold per streamed chunk with a host bincount over class*V+token keys
    (the vocabulary grows chunk to chunk, and the count is string work,
    not arithmetic); scoring is one bag-of-words [n, V] x log P[V, K]
    float32 product on `device` (default cuda)."""

    def __init__(self, laplace: float = 1.0, drop_stop_words: bool = True,
                 device: DeviceLike = None):
        self.laplace = laplace
        self.drop_stop = drop_stop_words
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = {}
        self.class_values: List[str] = []
        self.log_prob: Optional[np.ndarray] = None      # [V, K]
        self.log_prior: Optional[np.ndarray] = None     # [K]
        # streaming accumulator state (first-seen class order; finish()
        # sorts classes so chunked == whole-fit output exactly)
        self._classes: List[str] = []
        self._cidx: Dict[str, int] = {}
        self._counts = np.zeros((0, 0), np.float64)     # [V, K]
        self._class_counts = np.zeros(0, np.float64)    # [K]

    def _encode(self, texts: Sequence[str], grow: bool):
        doc_ids, tok_ids = [], []
        for d, text in enumerate(texts):
            for tok in tokenize(text, self.drop_stop):
                if tok not in self.vocab:
                    if not grow:
                        continue            # unseen test token: skip
                    self.vocab[tok] = len(self.vocab)
                doc_ids.append(d)
                tok_ids.append(self.vocab[tok])
        return (np.asarray(doc_ids, np.int32), np.asarray(tok_ids, np.int32))

    def accumulate(self, texts: Sequence[str], labels: Sequence[str]
                   ) -> "TextNaiveBayes":
        """Fold one chunk of (classVal, token) counts — additive, so the
        free-text mode streams like the tabular one; vocabulary and class
        set grow across chunks (count tables zero-pad)."""
        for lab in labels:
            if lab not in self._cidx:
                self._cidx[lab] = len(self._classes)
                self._classes.append(lab)
        y = np.asarray([self._cidx[v] for v in labels], np.int32)
        doc_ids, tok_ids = self._encode(texts, grow=True)
        v, k = len(self.vocab), len(self._classes)
        if self._counts.shape != (v, k):
            grown = np.zeros((v, k), np.float64)
            grown[: self._counts.shape[0], : self._counts.shape[1]] = \
                self._counts
            self._counts = grown
            self._class_counts = np.pad(
                self._class_counts, (0, k - self._class_counts.shape[0]))
        if len(tok_ids):
            self._counts += np.bincount(
                np.asarray(tok_ids, np.int64) * k + y[doc_ids],
                minlength=v * k).reshape(v, k)
        self._class_counts += np.bincount(y, minlength=k)
        return self

    def finish(self) -> "TextNaiveBayes":
        """Derive the model; classes sort so chunked == whole-fit."""
        order = np.argsort(self._classes)
        self.class_values = [self._classes[i] for i in order]
        counts = self._counts[:, order]
        class_counts = self._class_counts[order]
        smoothed = counts + self.laplace
        self.log_prob = np.log(smoothed / smoothed.sum(axis=0, keepdims=True))
        self.log_prior = np.log(np.maximum(
            class_counts / max(class_counts.sum(), 1.0), 1e-30))
        return self

    def fit(self, texts: Sequence[str], labels: Sequence[str]) -> "TextNaiveBayes":
        # refit from scratch (fit has always been idempotent); streaming
        # callers use accumulate()/finish() directly
        self.vocab = {}
        self._classes, self._cidx = [], {}
        self._counts = np.zeros((0, 0), np.float64)
        self._class_counts = np.zeros(0, np.float64)
        return self.accumulate(texts, labels).finish()

    def _bow(self, texts: Sequence[str]) -> np.ndarray:
        doc_ids, tok_ids = self._encode(texts, grow=False)
        bow = np.zeros((len(texts), len(self.vocab)), np.float32)
        np.add.at(bow, (doc_ids, tok_ids), 1.0)
        return bow

    def scores(self, texts: Sequence[str]) -> np.ndarray:
        """float32 [n, K] log posterior scores: the bag-of-words product on
        the model's device."""
        dev = self.device
        bow = torch.from_numpy(self._bow(texts)).to(dev)
        log_prob = torch.as_tensor(self.log_prob, dtype=torch.float32,
                                   device=dev)
        log_prior = torch.as_tensor(self.log_prior, dtype=torch.float32,
                                    device=dev)
        return (bow @ log_prob + log_prior[None, :]).cpu().numpy()

    def predict(self, texts: Sequence[str]) -> List[str]:
        s = self.scores(texts)
        return [self.class_values[i] for i in s.argmax(axis=1)]

    # ------------------------------------------------------------- file IO
    def save(self, path: str, delim: str = ",") -> None:
        """Model CSV in the reference's count-row spirit:
        a `#params` header (laplace, stop-word setting), then
        classVal,token,logProb rows + prior rows."""
        inv = {i: t for t, i in self.vocab.items()}
        with open(path, "w") as fh:
            fh.write(f"#params{delim}{self.laplace}{delim}"
                     f"{str(self.drop_stop).lower()}\n")
            for ki, cv in enumerate(self.class_values):
                fh.write(f"{cv}{delim}{delim}{self.log_prior[ki]:.6f}\n")
                for vi in range(len(inv)):
                    fh.write(f"{cv}{delim}{inv[vi]}{delim}"
                             f"{self.log_prob[vi, ki]:.6f}\n")

    @classmethod
    def load(cls, path: str, delim: str = ",",
             device: DeviceLike = None) -> "TextNaiveBayes":
        m = cls(device=device)
        rows = []
        with open(path) as fh:
            for ln in fh:
                toks = ln.rstrip("\n").split(delim)
                if toks and toks[0] == "#params":
                    m.laplace = float(toks[1])
                    m.drop_stop = toks[2] == "true"
                    continue
                if len(toks) == 3:
                    rows.append(toks)
        m.class_values = sorted({r[0] for r in rows})
        cidx = {v: i for i, v in enumerate(m.class_values)}
        vocab_rows = [r for r in rows if r[1] != ""]
        m.vocab = {}
        for r in vocab_rows:
            if r[1] not in m.vocab:
                m.vocab[r[1]] = len(m.vocab)
        v, k = len(m.vocab), len(m.class_values)
        m.log_prob = np.zeros((v, k))
        m.log_prior = np.zeros(k)
        for cv, tok, val in rows:
            if tok == "":
                m.log_prior[cidx[cv]] = float(val)
            else:
                m.log_prob[m.vocab[tok], cidx[cv]] = float(val)
        return m
