"""Seedable synthetic datasets with known class structure.

The port's own copy of the churn, e-learning and call-hangup generators
of `avenir_tpu/data/generators.py`: the same numpy draws from the same seed,
so both packages see the same rows. They stand in for the reference's
resource/telecom_churn.py, resource/elearn.py and resource/call_hangup.py
scripts. The
multi-class corpus (`generate_multiclass`) is the port's own: continuous
fields over more than two classes, the shape that shows the order in
which Naive Bayes sums its moments. `generate_event_sequences` copies the
JAX package's draws too; the Markov corpora (`generate_markov_chains`, the
churn tutorial's two class chains, and `generate_loyalty_sequences`, the
loyalty tutorial's HMM) are the port's own, drawn a step at a time across
all rows at once.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np

from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureSchema


def _rows_out(rows: List[List[str]], schema: FeatureSchema,
              as_csv: bool) -> Union[Dataset, str]:
    if as_csv:
        return "\n".join(",".join(r) for r in rows) + "\n"
    return Dataset.from_rows(rows, schema)


def churn_schema() -> FeatureSchema:
    """resource/churn.json-shaped schema (categorical features + binary class)."""
    return FeatureSchema.from_json({
        "fields": [
            {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
            {"name": "minUsed", "ordinal": 1, "dataType": "categorical",
             "cardinality": ["low", "med", "high", "overage"], "feature": True},
            {"name": "dataUsed", "ordinal": 2, "dataType": "categorical",
             "cardinality": ["low", "med", "high"], "feature": True},
            {"name": "CSCalls", "ordinal": 3, "dataType": "categorical",
             "cardinality": ["low", "med", "high"], "feature": True},
            {"name": "payment", "ordinal": 4, "dataType": "categorical",
             "cardinality": ["poor", "average", "good"], "feature": True},
            {"name": "acctAge", "ordinal": 5, "dataType": "int", "feature": True,
             "min": 0, "max": 120, "bucketWidth": 12},
            {"name": "status", "ordinal": 6, "dataType": "categorical",
             "cardinality": ["open", "closed"]},
        ]
    })


def generate_churn(n: int, seed: int = 7,
                   as_csv: bool = False) -> Union[Dataset, str]:
    """Telecom churn rows: 'closed' accounts skew to high CSCalls / poor
    payment / high usage, like resource/telecom_churn.py's weighted draws."""
    rng = np.random.default_rng(seed)
    schema = churn_schema()
    y = (rng.random(n) < 0.3).astype(np.int32)        # 30% churn

    def draw(open_w: List[float], closed_w: List[float]) -> np.ndarray:
        w = np.where(y[:, None] == 0, np.array(open_w), np.array(closed_w))
        c = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
        return (rng.random(n)[:, None] > c).sum(axis=1).astype(np.int32)

    min_used = draw([3, 4, 2, 1], [1, 2, 3, 4])
    data_used = draw([3, 4, 2], [1, 2, 4])
    cs_calls = draw([5, 2, 1], [1, 2, 5])
    payment = draw([1, 3, 5], [5, 3, 1])
    age = np.where(y == 0, rng.integers(12, 120, n),
                   rng.integers(0, 48, n)).astype(np.int32)

    def card(o: int) -> List[str]:
        return schema.field_by_ordinal(o).cardinality

    rows = [[f"C{i:08d}", card(1)[min_used[i]], card(2)[data_used[i]],
             card(3)[cs_calls[i]], card(4)[payment[i]], str(age[i]),
             card(6)[y[i]]]
            for i in range(n)]
    return _rows_out(rows, schema, as_csv)


def elearn_schema(num_numeric: int = 6) -> FeatureSchema:
    """resource/elearnActivity.json-style schema: id + numeric activity
    features + pass/fail class — the KNN workload's dataset shape."""
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"}]
    for i in range(num_numeric):
        fields.append({
            "name": f"act{i}", "ordinal": i + 1, "dataType": "double",
            "feature": True, "min": 0, "max": 100,
        })
    fields.append({
        "name": "grade", "ordinal": num_numeric + 1, "dataType": "categorical",
        "cardinality": ["fail", "pass"],
    })
    return FeatureSchema.from_json({"fields": fields})


def generate_elearn(n: int, num_numeric: int = 6, seed: int = 11,
                    as_csv: bool = False) -> Union[Dataset, str]:
    """Two gaussian clusters in activity space -> separable pass/fail.
    as_csv=True returns the rows as CSV text instead of a Dataset."""
    rng = np.random.default_rng(seed)
    schema = elearn_schema(num_numeric)
    y = (rng.random(n) < 0.5).astype(np.int32)
    centers = np.stack([np.full(num_numeric, 30.0), np.full(num_numeric, 65.0)])
    x = centers[y] + rng.normal(0, 12.0, (n, num_numeric))
    x = np.clip(x, 0, 100)
    rows = [[f"S{i:08d}"] + [f"{v:.3f}" for v in x[i]] + [["fail", "pass"][y[i]]]
            for i in range(n)]
    return _rows_out(rows, schema, as_csv)


def multiclass_schema(num_classes: int, num_cont: int) -> FeatureSchema:
    """id, one categorical feature, `num_cont` unbinned numeric features
    and a class of `num_classes` values."""
    fields = [{"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
              {"name": "color", "ordinal": 1, "dataType": "categorical",
               "cardinality": ["red", "green", "blue"], "feature": True}]
    for i in range(num_cont):
        fields.append({"name": f"x{i}", "ordinal": i + 2,
                       "dataType": "double", "feature": True})
    fields.append({"name": "label", "ordinal": num_cont + 2,
                   "dataType": "categorical",
                   "cardinality": [f"c{i}" for i in range(num_classes)]})
    return FeatureSchema.from_json({"fields": fields})


def generate_multiclass(n: int, num_classes: int, num_cont: int,
                        seed: int = 13, as_csv: bool = False
                        ) -> Union[Dataset, str]:
    """Uniform rows of `multiclass_schema`: the class and the colour drawn
    uniformly, the numeric fields uniform in [0, 120) written to four
    decimals."""
    rng = np.random.default_rng(seed)
    schema = multiclass_schema(num_classes, num_cont)
    y = rng.integers(0, num_classes, n)
    color = rng.integers(0, 3, n)
    x = rng.random((n, num_cont)) * 120.0
    colors = schema.field_by_ordinal(1).cardinality
    rows = [[f"M{i:08d}", colors[color[i]]] + [f"{v:.4f}" for v in x[i]]
            + [f"c{y[i]}"] for i in range(n)]
    return _rows_out(rows, schema, as_csv)


def call_hangup_schema() -> FeatureSchema:
    """resource/call_hangup.json mirror (same ordinals; ordinal 2 = area
    code is present in rows but undeclared, exactly as the reference skips
    it). The class field gets its cardinality declared (deviation: the
    reference file omits it and lets the job infer)."""
    return FeatureSchema.from_json({
        "fields": [
            {"name": "id", "ordinal": 0, "id": True, "dataType": "string"},
            {"name": "customer type", "ordinal": 1, "dataType": "categorical",
             "feature": True, "maxSplit": 2,
             "cardinality": ["business", "residence"]},
            {"name": "issue", "ordinal": 3, "dataType": "categorical",
             "feature": True, "maxSplit": 2,
             "cardinality": ["internet", "cable", "billing", "other"]},
            {"name": "time of day", "ordinal": 4, "dataType": "categorical",
             "feature": True, "maxSplit": 2, "cardinality": ["AM", "PM"]},
            {"name": "hold time", "ordinal": 5, "dataType": "int",
             "feature": True, "bucketWidth": 60, "min": 0, "max": 600,
             "splitScanInterval": 60},
            {"name": "hungup", "ordinal": 6, "dataType": "categorical",
             "cardinality": ["F", "T"]},
        ]
    })


def generate_call_hangup(n: int, seed: int = 13,
                         as_csv: bool = False) -> Union[Dataset, str]:
    """resource/call_hangup.py behavior: Gaussian hold times by time of
    day (AM mean 500/80, PM 400/60), hangup likely above a threshold.
    A row at a time, in the JAX package's order of draws."""
    rng = np.random.default_rng(seed)
    schema = call_hangup_schema()
    rows = []
    for i in range(n):
        cust = "business" if rng.random() < 0.4 else "residence"
        issue = ["internet", "billing", "other"][rng.integers(0, 3)] \
            if cust == "business" else \
            ["internet", "cable", "billing", "other"][rng.integers(0, 4)]
        tod = "AM" if rng.random() < 0.5 else "PM"
        mean, std = (500.0, 80.0) if tod == "AM" else (400.0, 60.0)
        hold = float(np.clip(rng.normal(mean, std), 0, 599))
        threshold = 420.0
        if hold > threshold:
            hungup = "T" if rng.random() < 0.8 else "F"
        else:
            hungup = "F" if rng.random() < 0.9 else "T"
        area = str(rng.choice([408, 607, 336, 646, 206]))
        rows.append([f"{rng.integers(10**9, 10**10)}", cust, area, issue,
                     tod, str(int(hold)), hungup])
    return _rows_out(rows, schema, as_csv)


def generate_token_sequences(n: int, vocab: int = 100, mean_len: float = 10,
                             max_len: int = 40, seed: int = 21
                             ) -> List[str]:
    """n event-token sequences as CSV lines `s<i>,e<j>,...` (the GSP
    input, CandidateGenerationWithSelfJoin's rows): each of Poisson(mean_len)
    tokens, clipped to [2, max_len], drawn from `vocab` tokens with Zipf
    popularity p_j ∝ 1/(j+1), a token free to repeat. The port's own
    corpus, drawn in bulk."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(mean_len, n), 2, max_len)
    pop = 1.0 / np.arange(1, vocab + 1)
    tokens = rng.choice(vocab, size=int(lengths.sum()), p=pop / pop.sum())
    names = [f"e{j}" for j in range(vocab)]
    words = [names[j] for j in tokens.tolist()]
    ends = np.cumsum(lengths).tolist()
    starts = [0] + ends[:-1]
    return [",".join([f"s{i}", *words[a:b]])
            for i, (a, b) in enumerate(zip(starts, ends))]


def generate_event_sequences(n: int, states: Optional[List[str]] = None,
                             mean_len: int = 10, seed: int = 19
                             ) -> List[List[str]]:
    """resource/event_seq.rb-style event sequences: an entity's Markov
    walk over event states with a sticky diagonal (the JAX package's
    draws)."""
    rng = np.random.default_rng(seed)
    states = states or ["login", "browse", "cart", "buy", "logout"]
    s = len(states)
    if s < 2:
        raise ValueError("need at least 2 event states")
    trans = np.full((s, s), 0.5 / (s - 1))
    np.fill_diagonal(trans, 0.5)
    seqs = []
    for _ in range(n):
        length = max(2, int(rng.poisson(mean_len)))
        cur = int(rng.integers(0, s))
        seq = [states[cur]]
        for _ in range(length - 1):
            cur = int(rng.choice(s, p=trans[cur]))
            seq.append(states[cur])
        seqs.append(seq)
    return seqs


#: the churn tutorial's states and its two class chains, converted (C) and
#: lost (L) (docs/tutorial_churn_markov_classifier.md:18-35)
MARKOV_STATES = ["browse", "search", "cart", "support", "leave"]
MARKOV_CLASS_TRANS = {
    "C": [[.2, .3, .4, .05, .05], [.2, .2, .5, .05, .05],
          [.1, .1, .6, .1, .1], [.3, .2, .3, .1, .1], [.2, .2, .4, .1, .1]],
    "L": [[.4, .2, .05, .1, .25], [.3, .3, .05, .1, .25],
          [.2, .2, .1, .2, .3], [.2, .1, .05, .3, .35],
          [.3, .2, .05, .15, .3]],
}

#: the loyalty tutorial's HMM: loyal, neutral and hostile states over
#: (time gap x relative spend) symbols (docs/tutorial_loyalty_viterbi.md:23-36)
LOYALTY_STATES = ["L", "N", "H"]
LOYALTY_OBS = ["SL", "SS", "SM", "ML", "MS", "MM", "LL", "LS", "LM"]
LOYALTY_INITIAL = [.30, .45, .25]
LOYALTY_TRANSITION = [[.35, .40, .25], [.25, .35, .40], [.30, .40, .30]]
LOYALTY_EMISSION = [[.08, .05, .01, .15, .12, .07, .21, .17, .14],
                    [.10, .09, .08, .17, .15, .12, .11, .10, .08],
                    [.13, .18, .21, .08, .12, .14, .03, .04, .07]]


def _draw(rng, cum: np.ndarray) -> np.ndarray:
    """One categorical draw a row of cumulative probabilities [N, K]."""
    u = rng.random(cum.shape[0])
    return np.minimum((u[:, None] >= cum).sum(axis=1), cum.shape[1] - 1)


def _walk(rng, first: np.ndarray, trans: np.ndarray, lengths: np.ndarray
          ) -> np.ndarray:
    """int [N, max length]: Markov walks from `first`, walk i lengths[i]
    states long (-1 past its end), `trans` [N, S, S] the transition rows
    of each walk's chain (or [S, S] for one chain). Step t draws for the
    walks still going."""
    cum = np.cumsum(np.asarray(trans, np.float64), axis=-1)
    out = np.full((first.shape[0], int(lengths.max())), -1, np.int64)
    out[:, 0] = first
    for t in range(1, out.shape[1]):
        live = np.flatnonzero(lengths > t)
        prev = out[live, t - 1]
        out[live, t] = _draw(rng, cum[live, prev] if cum.ndim == 3
                             else cum[prev])
    return out


def _join_rows(heads: List[str], names: List[str], codes: np.ndarray,
               lengths: np.ndarray, sep: str = ",") -> List[str]:
    """`head,names[code],...` a row, of its first lengths[i] codes."""
    live = np.arange(codes.shape[1])[None, :] < lengths[:, None]
    words = list(map(names.__getitem__, codes[live].tolist()))
    ends = np.cumsum(lengths).tolist()
    return [sep.join([head, *words[b - n:b]])
            for head, b, n in zip(heads, ends, lengths.tolist())]


def generate_markov_chains(n: int, seed: int = 21,
                           n_entities: Optional[int] = None) -> List[str]:
    """`cust<i>,<C|L>,state,...` rows of the churn tutorial's chains: the
    class C or L at one half each, a uniform first state, 6 to 13 states,
    each next state drawn from its class's row. With `n_entities`, row i's
    id is `cust<i % n_entities>` (an entity with many sessions)."""
    rng = np.random.default_rng(seed)
    labels = np.where(rng.random(n) < 0.5, 0, 1)
    first = rng.integers(0, len(MARKOV_STATES), n)
    lengths = rng.integers(6, 14, n)
    trans = np.array([MARKOV_CLASS_TRANS["C"], MARKOV_CLASS_TRANS["L"]])
    codes = _walk(rng, first, trans[labels], lengths)
    ids = np.arange(n) if n_entities is None else np.arange(n) % n_entities
    heads = [f"cust{i},{'CL'[c]}" for i, c in zip(ids.tolist(),
                                                 labels.tolist())]
    return _join_rows(heads, MARKOV_STATES, codes, lengths)


def generate_loyalty_sequences(n: int, seed: int = 31, mean_len: float = 10,
                               min_len: int = 1, max_len: int = 40,
                               tagged: bool = False
                               ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(rows, hidden states int [n, max length] (-1 past a row's end),
    lengths) of the loyalty
    tutorial's HMM: Poisson(mean_len) observations a row, clipped to
    [min_len, max_len]; rows `cust<i>,obs,...`, or `cust<i>,obs:state,...`
    when `tagged` (the HMM builder's fully tagged input)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(mean_len, n), min_len, max_len)
    first = _draw(rng, np.cumsum(np.tile(LOYALTY_INITIAL, (n, 1)), axis=1))
    hidden = _walk(rng, first, np.array(LOYALTY_TRANSITION), lengths)
    live = hidden >= 0
    obs = np.full(hidden.shape, -1, np.int64)
    obs[live] = _draw(rng, np.cumsum(np.array(LOYALTY_EMISSION),
                                     axis=1)[hidden[live]])
    names = LOYALTY_OBS
    if tagged:
        names = [f"{o}:{s}" for s in LOYALTY_STATES for o in LOYALTY_OBS]
        obs = hidden * len(LOYALTY_OBS) + obs
    heads = [f"cust{i}" for i in range(n)]
    return _join_rows(heads, names, obs, lengths), hidden, lengths
