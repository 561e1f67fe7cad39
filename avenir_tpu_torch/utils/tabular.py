"""Small tabular model and stat containers, the port's own copy of
`avenir_tpu/utils/tabular.py`.

Host-side model-file and bookkeeping objects in float64 numpy: the
counting that fills them runs in the jobs; these classes only hold,
normalize and serialize results, mirroring the reference's util classes
(SURVEY §2.8).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np


class StateTransitionProbability:
    """Row-normalized scaled transition matrix
    (util/StateTransitionProbability.java:29, extends chombo TabularData):
    counts in, int-scaled (or float-precision) probabilities out."""

    def __init__(self, row_labels: Sequence[str], col_labels: Optional[Sequence[str]] = None,
                 scale: int = 100, float_precision: int = 3):
        self.row_labels = list(row_labels)
        self.col_labels = list(col_labels) if col_labels is not None else list(row_labels)
        self.scale = scale
        self.float_precision = float_precision
        self.table = np.zeros((len(self.row_labels), len(self.col_labels)), np.float64)

    def add(self, row: str, col: str, count: float = 1.0) -> None:
        self.table[self.row_labels.index(row), self.col_labels.index(col)] += count

    def set(self, row: str, col: str, value: float) -> None:
        self.table[self.row_labels.index(row), self.col_labels.index(col)] = value

    def normalize_rows(self) -> np.ndarray:
        """Probabilities scaled by `scale` and rounded (normalizeRows):
        integer matrix when scale > 1, rounded floats at scale 1."""
        prob = self.table / np.maximum(self.table.sum(axis=1, keepdims=True), 1e-12)
        scaled = prob * self.scale
        if self.scale > 1:
            return np.rint(scaled).astype(np.int64)
        return np.round(scaled, self.float_precision)

    def prob(self, row: str, col: str) -> float:
        r = self.table[self.row_labels.index(row)]
        tot = r.sum()
        return float(r[self.col_labels.index(col)] / tot) if tot > 0 else 0.0

    def serialize(self, delim: str = ",") -> str:
        rows = self.normalize_rows()
        return "\n".join(delim.join(str(v) for v in row) for row in rows)


class ContingencyMatrix:
    """Categorical x categorical contingency table with the Cramér index
    (util/ContingencyMatrix.java:28, consumed by CramerCorrelation)."""

    def __init__(self, num_rows: int, num_cols: int):
        self.table = np.zeros((num_rows, num_cols), np.float64)

    def add(self, row: int, col: int, count: float = 1.0) -> None:
        self.table[row, col] += count

    def accumulate(self, other: "ContingencyMatrix") -> None:
        self.table += other.table

    def total(self) -> float:
        return float(self.table.sum())

    def chi_squared(self) -> float:
        n = self.table.sum()
        if n <= 0:
            return 0.0
        expected = np.outer(self.table.sum(axis=1), self.table.sum(axis=0)) / n
        mask = expected > 0
        return float(((self.table - expected)[mask] ** 2 / expected[mask]).sum())

    def cramer_index(self) -> float:
        n = self.table.sum()
        if n <= 0:
            return 0.0
        k = min(self.table.shape) - 1
        if k <= 0:
            return 0.0
        return float(self.chi_squared() / (n * k))

    def serialize(self, delim: str = ",") -> str:
        return delim.join(str(int(v)) for v in self.table.ravel())

    @classmethod
    def deserialize(cls, text: str, num_rows: int, num_cols: int,
                    delim: str = ",") -> "ContingencyMatrix":
        m = cls(num_rows, num_cols)
        vals = [float(t) for t in text.strip().split(delim)]
        m.table = np.asarray(vals, np.float64).reshape(num_rows, num_cols)
        return m


@dataclass
class CostAttribute:
    """Attribute-change cost entry (util/CostAttribute.java:30): numeric
    cost per unit change, or categorical from,to -> cost map."""

    ordinal: int
    num_attr_cost: float = 0.0
    cat_attr_cost: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_json(cls, obj: Dict) -> "CostAttribute":
        return cls(
            ordinal=int(obj["ordinal"]),
            num_attr_cost=float(obj.get("numAttrCost", 0.0)),
            cat_attr_cost={str(k): float(v)
                           for k, v in obj.get("catAttrCost", {}).items()},
        )


class CostSchema:
    """Attribute-change cost schema (util/CostSchema.java:27): the cost of
    moving an entity's attribute value, used for cost-based actionability
    analysis of model outputs."""

    def __init__(self, attributes: Sequence[CostAttribute]):
        self.attributes = {a.ordinal: a for a in attributes}

    @classmethod
    def from_json(cls, obj: Dict) -> "CostSchema":
        return cls([CostAttribute.from_json(a) for a in obj["attributes"]])

    @classmethod
    def from_file(cls, path: str) -> "CostSchema":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    def find_cost(self, ordinal: int, *args) -> float:
        """find_cost(ord, value_change) for numeric attributes;
        find_cost(ord, from_value, to_value) for categorical (missing
        pairs cost 0, CostSchema.java:59-71)."""
        attr = self.attributes.get(ordinal)
        if attr is None:
            raise ValueError(f"invalid attribute ordinal {ordinal}")
        if len(args) == 1:
            return attr.num_attr_cost * float(args[0])
        return attr.cat_attr_cost.get(f"{args[0]},{args[1]}", 0.0)


@dataclass
class ClassAttributeCounter:
    """Pos/neg class count pair (util/ClassAttributeCounter.java:25)."""

    pos_count: int = 0
    neg_count: int = 0

    def add(self, pos: int, neg: int) -> None:
        self.pos_count += pos
        self.neg_count += neg

    def update(self, pos: int, neg: int) -> None:
        self.pos_count = pos
        self.neg_count = neg

    @property
    def total(self) -> int:
        return self.pos_count + self.neg_count
