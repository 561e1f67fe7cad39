"""Validation metrics: confusion matrix + cost-based arbitration.

The port's own copy of `avenir_tpu/utils/metrics.py`'s ConfusionMatrix,
CostBasedArbitrator, throughput_counters and Counters. The reference
validates classifiers in-job by pushing TP/FN/TN/FP, accuracy, recall
and precision into Hadoop counters under a "Validation" group
(util/ConfusionMatrix.java, used at knn/NearestNeighbor.java:300-312);
here they are a plain dict.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class ConfusionMatrix:
    """Multi-class confusion matrix with the reference's binary counter names.

    `pos_class` marks which class index plays the "positive" role for the
    TP/FP/TN/FN counters.
    """

    def __init__(self, class_values: Sequence[str], pos_class: int = 0):
        self.class_values = list(class_values)
        self.k = len(self.class_values)
        self.pos_class = pos_class
        self.matrix = np.zeros((self.k, self.k), dtype=np.int64)  # [actual, predicted]

    def add(self, actual: np.ndarray, predicted: np.ndarray) -> None:
        a = np.asarray(actual).astype(np.int64).ravel()
        p = np.asarray(predicted).astype(np.int64).ravel()
        np.add.at(self.matrix, (a, p), 1)

    # ------------------------------------------------------------- counters
    @property
    def total(self) -> int:
        return int(self.matrix.sum())

    @property
    def true_pos(self) -> int:
        c = self.pos_class
        return int(self.matrix[c, c])

    @property
    def false_neg(self) -> int:
        c = self.pos_class
        return int(self.matrix[c, :].sum() - self.matrix[c, c])

    @property
    def false_pos(self) -> int:
        c = self.pos_class
        return int(self.matrix[:, c].sum() - self.matrix[c, c])

    @property
    def true_neg(self) -> int:
        return self.total - self.true_pos - self.false_neg - self.false_pos

    def accuracy(self) -> float:
        t = self.total
        return float(np.trace(self.matrix)) / t if t else 0.0

    def recall(self) -> float:
        denom = self.true_pos + self.false_neg
        return self.true_pos / denom if denom else 0.0

    def precision(self) -> float:
        denom = self.true_pos + self.false_pos
        return self.true_pos / denom if denom else 0.0

    def counters(self) -> Dict[str, float]:
        """The reference's "Validation" counter group, percent-scaled like
        Hadoop counters (accuracy/recall/precision as int percent)."""
        return {
            "Validation:TruePositive": self.true_pos,
            "Validation:FalseNegative": self.false_neg,
            "Validation:TrueNegative": self.true_neg,
            "Validation:FalsePositive": self.false_pos,
            "Validation:Accuracy": int(100 * self.accuracy()),
            "Validation:Recall": int(100 * self.recall()),
            "Validation:Precision": int(100 * self.precision()),
        }

    def __repr__(self) -> str:
        return f"ConfusionMatrix(k={self.k}, total={self.total})"


class CostBasedArbitrator:
    """Misclassification-cost decision between two classes
    (util/CostBasedArbitrator.java, constructed as (negClass, posClass,
    falseNegCost, falsePosCost)); vectorized over numpy arrays with the
    reference's exact integer decision formulas."""

    def __init__(self, neg_class: str, pos_class: str,
                 false_neg_cost: float, false_pos_cost: float):
        self.neg_class = neg_class
        self.pos_class = pos_class
        self.false_neg_cost = false_neg_cost  # cost of missing a positive
        self.false_pos_cost = false_pos_cost  # cost of a false alarm

    def arbitrate(self, prob_neg: np.ndarray, prob_pos: np.ndarray) -> np.ndarray:
        """True -> positive class: pick pos iff
        falsePosCost*negProb + posProb < falseNegCost*posProb + negProb."""
        pos, neg = np.asarray(prob_pos), np.asarray(prob_neg)
        neg_cost = self.false_neg_cost * pos + neg
        pos_cost = self.false_pos_cost * neg + pos
        return pos_cost < neg_cost

    def classify(self, prob_pos: np.ndarray) -> np.ndarray:
        """True -> positive class: posProb > falsePosCost*100 /
        (falsePosCost + falseNegCost), in integer division."""
        thr = int(self.false_pos_cost * 100) // int(
            self.false_pos_cost + self.false_neg_cost)
        return np.asarray(prob_pos) > thr


def throughput_counters(records: int, seconds: float) -> Dict[str, float]:
    """The Hadoop-style `Basic:Records` of a streamed job and its
    `Basic:RowsPerSec` (0 for a wall clock that is not positive)."""
    rate = records / seconds if seconds > 0 else 0.0
    return {"Basic:Records": int(records),
            "Basic:RowsPerSec": round(rate, 1)}


class Counters:
    """A flat stand-in for Hadoop counter groups: "Group:Name" -> value
    (`avenir_tpu/utils/metrics.py` `Counters`)."""

    def __init__(self) -> None:
        self.values: Dict[str, float] = {}

    def incr(self, key: str, amount: float = 1) -> None:
        self.values[key] = self.values.get(key, 0) + amount

    def set(self, key: str, value: float) -> None:
        self.values[key] = value

    def update(self, other: Dict[str, float]) -> None:
        self.values.update(other)

    def get(self, key: str, default: float = 0) -> float:
        return self.values.get(key, default)

    def __repr__(self) -> str:
        return f"Counters({self.values})"
