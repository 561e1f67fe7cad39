"""Decision tree / random forest: level-wise builder with tensorized splits.

The port of `avenir_tpu/models/tree.py` (org.avenir.tree, SURVEY
§2.3/§3.4). The reference grows a tree one MR job a level: the mapper
routes every record through every candidate split predicate, the reducer
sums a class histogram per (path, split, predicate) and picks the split of
least weighted entropy or gini per parent (DecisionTreeBuilder.java
:258-347, :440-576). Here, as in the JAX package:

- candidate splits are static (schema-driven, `enumerate_splits`, host
  numpy): each split maps a record to a segment, computed once into an
  int8 matrix [n, n_splits] on the host and copied to the device;
- a tree level is one keyed count on the device (`_level_histogram`):
  the histogram [leaves, splits, segments, classes] of every tree of a
  forest at once, the tree folded into the key as the JAX package's vmap
  does. The counts are integers (weights of ones, bootstrap counts or
  0/1), summed exactly in float64 and handed to the host as float32,
  the JAX package's `segment_sum` dtype: the same bits while every cell
  stays under 2^24;
- the host picks the best splits and applies the stopping rules on those
  small tensors (numpy, as the JAX package does), and one gather a level
  moves every row to its child (`_advance_leaves`);
- prediction is the host loop over paths (float64 compares) or the
  device evaluator (`DevicePathEvaluator`, float32 compares in row
  blocks), each as the JAX package has it.

The randomness (the forest's bootstrap, `randomNotUsedYet`'s attribute
draw) is host numpy from the same seeds, called in the JAX package's
order. The model is the DecisionPathList JSON of the reference
(jackson field names), so the files of the reference, of the JAX package
and of the port are interchangeable.

`DecisionTreeBuilder.fit(mesh=)` shards the rows over the ranks of a
`parallel.data_mesh` and sums each level histogram across them.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.dataset import Dataset
from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device
from avenir_tpu_torch.utils.metrics import ConfusionMatrix

ROOT_PATH = "$root"
#: int64 keys a block of one level's keyed count: the key tensor [T, b,
#: n_splits] of a row block stays under 256 MB however many rows
KEY_BLOCK = 1 << 25
#: rows a block of the device path evaluator (the JAX package's)
PREDICT_ROW_BLOCK = 262_144


def _np_bits_entropy(counts: np.ndarray, axis: int = -1) -> np.ndarray:
    """Entropy in bits of the builder's small per-level count tensors, on
    the host."""
    tot = counts.sum(axis=axis, keepdims=True)
    p = counts / np.maximum(tot, 1e-12)
    h = -np.sum(np.where(p > 0, p * np.log(np.maximum(p, 1e-12)), 0.0), axis=axis)
    return h / np.log(2.0)


def _np_gini(counts: np.ndarray, axis: int = -1) -> np.ndarray:
    tot = counts.sum(axis=axis, keepdims=True)
    p = counts / np.maximum(tot, 1e-12)
    return 1.0 - np.sum(p * p, axis=axis)

# ---------------------------------------------------------------------------
# candidate split enumeration (host; SplitManager semantics)
# ---------------------------------------------------------------------------


@dataclass
class Predicate:
    """One predicate of one split segment ("attr op value [other]" form)."""

    attribute: int
    operator: str                       # ge / lt / in  (segment predicates)
    value: Optional[float] = None
    other_bound: Optional[float] = None
    cat_values: List[str] = field(default_factory=list)
    is_int: bool = True

    def to_string(self) -> str:
        if self.operator == "in":
            return f"{self.attribute} in " + ":".join(self.cat_values)
        fmt = (lambda v: str(int(v))) if self.is_int else (lambda v: str(v))
        s = f"{self.attribute} {self.operator} {fmt(self.value)}"
        if self.other_bound is not None:
            s += f" {fmt(self.other_bound)}"
        return s

    def to_json(self) -> Dict:
        obj: Dict = {"attribute": self.attribute, "operator": self.operator,
                     "predicateStr": self.to_string()}
        if self.operator == "in":
            obj["categoricalValues"] = list(self.cat_values)
        elif self.is_int:
            obj["valueInt"] = int(self.value)
            if self.other_bound is not None:
                obj["otherBoundInt"] = int(self.other_bound)
        else:
            obj["valueDbl"] = float(self.value)
            if self.other_bound is not None:
                obj["otherBoundDbl"] = float(self.other_bound)
        return obj


@dataclass
class CandidateSplit:
    """One candidate split of one attribute into `n_segments` segments.

    `segment_of` maps a raw column (numpy) to segment ids; `predicates[s]`
    is the predicate describing segment s."""

    attribute: int
    split_id: int
    n_segments: int
    predicates: List[Predicate]
    _kind: str = "numeric"
    _bounds: Optional[np.ndarray] = None        # numeric: inner boundaries
    _group_of: Optional[np.ndarray] = None      # categorical: code -> group

    def segment_of(self, col: np.ndarray) -> np.ndarray:
        # np.searchsorted puts NaN (a missing numeric) in the last segment
        if self._kind == "numeric":
            return np.searchsorted(self._bounds, col, side="right").astype(np.int8)
        return self._group_of[col.astype(np.int64)].astype(np.int8)


def _numeric_splits(fld: FeatureField, max_split: int) -> List[List[float]]:
    """All partitions of [min, max] into 2..max_split segments with
    boundaries at splitScanInterval steps (SplitManager.java:284-391)."""
    lo, hi = fld.min, fld.max
    interval = fld.split_scan_interval or fld.bucket_width
    if lo is None or hi is None or not interval:
        return []
    points = []
    p = lo + interval
    while p < hi - 1e-9:
        points.append(p)
        p += interval
    out: List[List[float]] = []
    for nseg in range(2, max_split + 1):
        for combo in itertools.combinations(points, nseg - 1):
            out.append(list(combo))
    return out


def _set_partitions(items: Sequence[str], max_groups: int,
                    cap: int = 128) -> List[List[List[str]]]:
    """Partitions of a category set into 2..max_groups groups
    (SplitManager.java:397-561), capped to avoid blow-up."""
    n = len(items)
    results: List[List[List[str]]] = []
    # enumerate by group-assignment vectors in canonical form
    seen = set()
    max_groups = min(max_groups, n)

    def assignments(prefix, next_group):
        if len(results) >= cap:
            return
        if len(prefix) == n:
            ngroups = next_group
            if 2 <= ngroups <= max_groups:
                key = tuple(prefix)
                if key not in seen:
                    seen.add(key)
                    groups: List[List[str]] = [[] for _ in range(ngroups)]
                    for i, g in enumerate(prefix):
                        groups[g].append(items[i])
                    results.append(groups)
            return
        for g in range(next_group + 1):
            if g > max_groups - 1:
                continue
            assignments(prefix + [g], max(next_group, g + 1))

    assignments([], 0)
    return results


def enumerate_splits(schema: FeatureSchema,
                     cat_partition_cap: int = 128) -> List[CandidateSplit]:
    """All candidate splits of all feature attributes, in stable order."""
    splits: List[CandidateSplit] = []
    sid = 0
    for fld in schema.feature_fields:
        max_split = fld.max_split or 2
        if fld.is_numeric:
            for bounds in _numeric_splits(fld, max_split):
                preds = []
                is_int = fld.data_type == "int"
                for s in range(len(bounds) + 1):
                    if s == 0:
                        preds.append(Predicate(fld.ordinal, "lt", bounds[0],
                                               is_int=is_int))
                    elif s == len(bounds):
                        preds.append(Predicate(fld.ordinal, "ge", bounds[-1],
                                               is_int=is_int))
                    else:
                        preds.append(Predicate(fld.ordinal, "ge", bounds[s - 1],
                                               other_bound=bounds[s], is_int=is_int))
                splits.append(CandidateSplit(
                    fld.ordinal, sid, len(bounds) + 1, preds,
                    _kind="numeric", _bounds=np.asarray(bounds),
                ))
                sid += 1
        elif fld.is_categorical and len(fld.cardinality) >= 2:
            for groups in _set_partitions(fld.cardinality, max_split,
                                          cap=cat_partition_cap):
                group_of = np.zeros(len(fld.cardinality), np.int64)
                preds = []
                index = fld.cardinality_index()
                for g, members in enumerate(groups):
                    for m in members:
                        group_of[index[m]] = g
                    preds.append(Predicate(fld.ordinal, "in",
                                           cat_values=list(members)))
                splits.append(CandidateSplit(
                    fld.ordinal, sid, len(groups), preds,
                    _kind="categorical", _group_of=group_of,
                ))
                sid += 1
    return splits


def segment_matrix(splits: Sequence[CandidateSplit], ds: Dataset
                   ) -> np.ndarray:
    """int8 [n, n_splits]: every row's segment under every split (host
    numpy, the JAX package's encode)."""
    return np.stack(
        [sp.segment_of(np.asarray(ds.column(sp.attribute))) for sp in splits],
        axis=1,
    ).astype(np.int8)


# ---------------------------------------------------------------------------
# the level histogram and the advance: one keyed count and one gather
# ---------------------------------------------------------------------------


def _level_histogram_forest(leaf_ids: torch.Tensor, seg_matrix: torch.Tensor,
                            labels: torch.Tensor, weights: torch.Tensor,
                            n_leaves: int, n_splits: int, smax: int, k: int,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """float32 (or `dtype`) [T, L, NS, S, K]: every tree's level histogram
    in one call, on the tensors' device. Trees share the segment matrix
    [n, NS] and the labels [n] and differ in leaf routing and row weights
    ([T, n] each). The key of a (tree, row, split) is the JAX package's
    ((leaf * NS + split) * S + segment) * K + class with the tree in
    front, counted with its row's weight by `torch.bincount` over row
    blocks (each block's int64 keys at most KEY_BLOCK); the weights are
    integers, so the float64 sums are exact, and the float32 cast gives
    the JAX package's float32 `segment_sum` while every cell stays under
    2^24 (dtype=torch.int64 gives the exact counts, which a mesh sums
    across ranks). Counts its calls in `_level_histogram_forest.calls`; a
    profile sees each call as the range `tree::level_histogram`."""
    _level_histogram_forest.calls += 1
    with record_function("tree::level_histogram"):
        t, n = leaf_ids.shape
        cells = n_leaves * n_splits * smax * k
        dev = seg_matrix.device
        split = torch.arange(n_splits, device=dev)
        tree = torch.arange(t, device=dev)[:, None, None] * n_leaves
        counts = torch.zeros(t * cells, dtype=torch.float64, device=dev)
        rows = max(1, KEY_BLOCK // max(t * n_splits, 1))
        for s in range(0, n, rows):
            e = min(s + rows, n)
            base = ((tree + leaf_ids[:, s:e, None].long()) * n_splits
                    + split) * smax                           # [T, b, NS]
            key = ((base + seg_matrix[None, s:e].long()) * k
                   + labels[None, s:e, None].long())
            w = weights[:, s:e, None].to(torch.float64).expand(key.shape)
            counts += torch.bincount(key.reshape(-1), weights=w.reshape(-1),
                                     minlength=t * cells)
        return counts.to(dtype).reshape(t, n_leaves, n_splits, smax, k)


_level_histogram_forest.calls = 0


def _level_histogram(leaf_id: torch.Tensor, seg_matrix: torch.Tensor,
                     labels: torch.Tensor, weights: torch.Tensor,
                     n_leaves: int, n_splits: int, smax: int, k: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """counts[l, s, seg, c] of one tree (leaf ids [n], weights [n]): the
    whole MR shuffle of one tree level, as a forest of one."""
    return _level_histogram_forest(leaf_id[None], seg_matrix, labels,
                                   weights[None], n_leaves, n_splits, smax,
                                   k, dtype)[0]


def _advance_leaves_forest(leaf_ids: torch.Tensor, seg_matrix: torch.Tensor,
                           best_split_of_leaf: torch.Tensor,
                           child_offset: torch.Tensor) -> torch.Tensor:
    """int32 [T, n]: each row's leaf after a level, every tree at once:
    child_offset[leaf] + the row's segment under its leaf's chosen split;
    a leaf without a split (stopped or unsplit, split -1) keeps its id.
    One gather through the segment matrix, never expanded per tree."""
    lid = leaf_ids.long()
    split = torch.gather(best_split_of_leaf.long(), 1, lid)       # [T, n]
    rows = torch.arange(seg_matrix.shape[0], device=seg_matrix.device)
    seg = seg_matrix[rows[None, :], split.clamp(min=0)].long()
    off = torch.gather(child_offset.long(), 1, lid)
    return torch.where(split >= 0, off + seg, lid).to(torch.int32)


def _advance_leaves(leaf_id: torch.Tensor, seg_matrix: torch.Tensor,
                    best_split_of_leaf: torch.Tensor,
                    child_offset: torch.Tensor) -> torch.Tensor:
    """`_advance_leaves_forest` of one tree (leaf ids [n])."""
    return _advance_leaves_forest(leaf_id[None], seg_matrix,
                                  best_split_of_leaf[None],
                                  child_offset[None])[0]


# ---------------------------------------------------------------------------
# model: DecisionPathList-compatible
# ---------------------------------------------------------------------------


@dataclass
class DecisionPath:
    predicates: List[Predicate]        # empty -> root
    population: int
    info_content: float
    stopped: bool
    class_val_pr: Dict[str, float]

    def to_json(self) -> Dict:
        return {
            "predicates": [p.to_json() for p in self.predicates] or None,
            "population": int(self.population),
            "infoContent": float(self.info_content),
            "stopped": bool(self.stopped),
            "classValPr": {k: float(v) for k, v in self.class_val_pr.items()},
        }


class DecisionPathList:
    """The JSON tree model (reference tree/DecisionPathList.java format)."""

    def __init__(self, paths: List[DecisionPath]):
        self.paths = paths

    def to_json(self) -> Dict:
        return {"decisionPaths": [p.to_json() for p in self.paths]}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1)

    @classmethod
    def from_json(cls, obj: Dict) -> "DecisionPathList":
        paths = []
        for p in obj["decisionPaths"]:
            preds = []
            for pr in (p.get("predicates") or []):
                op = pr["operator"]
                if op == "in":
                    pred = Predicate(pr["attribute"], "in",
                                     cat_values=pr.get("categoricalValues", []))
                elif "valueInt" in pr and pr.get("valueInt") is not None:
                    pred = Predicate(pr["attribute"], op,
                                     value=pr["valueInt"],
                                     other_bound=pr.get("otherBoundInt"),
                                     is_int=True)
                else:
                    pred = Predicate(pr["attribute"], op,
                                     value=pr.get("valueDbl"),
                                     other_bound=pr.get("otherBoundDbl"),
                                     is_int=False)
                preds.append(pred)
            paths.append(DecisionPath(
                preds, p.get("population", 0), p.get("infoContent", 0.0),
                p.get("stopped", False), p.get("classValPr", {}) or {},
            ))
        return cls(paths)

    @classmethod
    def load(cls, path: str) -> "DecisionPathList":
        with open(path) as fh:
            return cls.from_json(json.load(fh))

    # ------------------------------------------------------------ prediction
    def predict(self, ds: Dataset, class_values: List[str]) -> np.ndarray:
        """Route every record down its matching path; argmax classValPr.
        Host numpy, comparing in float64 as the JAX package's host loop
        does (the device evaluator compares in float32)."""
        n = len(ds)
        pred = np.zeros(n, np.int32)
        assigned = np.zeros(n, bool)
        for path in self.paths:
            mask = np.ones(n, bool)
            for pr in path.predicates:
                col = ds.column(pr.attribute)
                if pr.operator == "in":
                    fld = ds.schema.field_by_ordinal(pr.attribute)
                    codes = {fld.cardinality_index()[v] for v in pr.cat_values
                             if v in fld.cardinality_index()}
                    mask &= np.isin(col.astype(np.int64), list(codes))
                else:
                    x = col.astype(np.float64)
                    if pr.operator == "ge":
                        m = x >= pr.value
                        if pr.other_bound is not None:
                            m &= x < pr.other_bound
                    elif pr.operator == "lt":
                        m = x < pr.value
                        if pr.other_bound is not None:
                            m &= x >= pr.other_bound
                    elif pr.operator == "gt":
                        m = x > pr.value
                        if pr.other_bound is not None:
                            m &= x <= pr.other_bound
                    else:  # le
                        m = x <= pr.value
                        if pr.other_bound is not None:
                            m &= x > pr.other_bound
                    mask &= m
            if path.class_val_pr:
                best = max(path.class_val_pr.items(), key=lambda kv: kv[1])[0]
                ci = class_values.index(best)
                take = mask & ~assigned
                pred[take] = ci
                assigned |= mask
        return pred


# ---------------------------------------------------------------------------
# device path evaluation (tensorized predict)
# ---------------------------------------------------------------------------

_OP_CODE = {"ge": 0, "lt": 1, "gt": 2, "le": 3}


def _path_match_kernel(x_num: torch.Tensor, x_cat: torch.Tensor,
                       kind: torch.Tensor, col: torch.Tensor,
                       op: torch.Tensor, val: torch.Tensor,
                       other: torch.Tensor, member: torch.Tensor
                       ) -> torch.Tensor:
    """bool [n, T, P]: does row n satisfy every predicate of path P of
    tree T, every row through every path at once (the device twin of the
    reference's pass-through classify, DecisionTreeBuilder.java:700-705).

    x_num float32 [n, An], x_cat int32 [n, Ac]; predicate tables
    [T, P, D] (+ member bool [T, P, D, B]); kind 0 = unused slot (always
    true), 1 numeric, 2 categorical. A slot's column is read by indexing
    the row matrix with the [T, P, D] column table ([n, T, P, D], no
    copy of the rows a slot); its column index is clamped into the
    matrix it reads, as XLA's gather clamps, since a slot of the other
    kind indexes the other matrix. A category code is clipped into
    [0, B - 1] before the member lookup (unknown codes are negative);
    `other` NaN is "no second bound"; every comparison with a NaN
    feature is false. A profile sees each call as the range
    `tree::path_match`."""
    with record_function("tree::path_match"):
        xv = x_num[:, col.clamp(0, x_num.shape[1] - 1)]       # [n, T, P, D]
        v, o = val[None], other[None]
        has_other = torch.isfinite(o)
        opn = op[None]
        num_ok = torch.where(
            opn == 0, (xv >= v) & torch.where(has_other, xv < o, True),
            torch.where(
                opn == 1, (xv < v) & torch.where(has_other, xv >= o, True),
                torch.where(opn == 2,
                            (xv > v) & torch.where(has_other, xv <= o, True),
                            (xv <= v) & torch.where(has_other, xv > o, True))))
        bmax = member.shape[-1]
        code = x_cat[:, col.clamp(0, x_cat.shape[1] - 1)].long()
        slot = torch.arange(col.numel(), device=col.device).reshape(col.shape)
        cat_ok = member.reshape(-1)[slot[None] * bmax
                                    + code.clamp(0, bmax - 1)]
        kn = kind[None]
        ok = torch.where(kn == 1, num_ok, torch.where(kn == 2, cat_ok, True))
        return ok.all(dim=-1)                                 # [n, T, P]


class DevicePathEvaluator:
    """Tensorized application of one or more DecisionPathList models on
    `device` (default cuda).

    Compiles the trees' predicate chains into padded tables [T, P, D]
    (trees x paths x chain depth) so prediction is one batched match a
    row block: every row x every path evaluates as a batched comparison,
    first matching path in path order wins (the host predict's assignment
    order), and a forest majority-votes across the tree axis."""

    def __init__(self, trees: Sequence[DecisionPathList],
                 schema: FeatureSchema, class_values: List[str],
                 device: DeviceLike = None):
        self.schema = schema
        self.class_values = class_values
        self.device = resolve_device(device)
        num_fields = [f for f in schema.feature_fields if f.is_numeric]
        cat_fields = [f for f in schema.feature_fields if f.is_categorical]
        self.num_fields, self.cat_fields = num_fields, cat_fields
        num_col = {f.ordinal: i for i, f in enumerate(num_fields)}
        cat_col = {f.ordinal: i for i, f in enumerate(cat_fields)}
        bmax = max((len(f.cardinality) for f in cat_fields), default=1)
        t = len(trees)
        p = max((len(tr.paths) for tr in trees), default=1) or 1
        d = max((len(pa.predicates) for tr in trees for pa in tr.paths),
                default=1) or 1
        kind = np.zeros((t, p, d), np.int8)
        col = np.zeros((t, p, d), np.int64)
        op = np.zeros((t, p, d), np.int8)
        val = np.zeros((t, p, d), np.float32)
        other = np.full((t, p, d), np.nan, np.float32)
        member = np.ones((t, p, d, bmax), bool)
        path_class = np.zeros((t, p), np.int64)
        path_valid = np.zeros((t, p), bool)
        for ti, tr in enumerate(trees):
            for pi, pa in enumerate(tr.paths):
                if pa.class_val_pr:
                    best = max(pa.class_val_pr.items(), key=lambda kv: kv[1])[0]
                    path_class[ti, pi] = class_values.index(best)
                    path_valid[ti, pi] = True
                for di, pr in enumerate(pa.predicates):
                    if pr.operator == "in":
                        kind[ti, pi, di] = 2
                        col[ti, pi, di] = cat_col[pr.attribute]
                        fld = schema.field_by_ordinal(pr.attribute)
                        idx = fld.cardinality_index()
                        row = np.zeros(bmax, bool)
                        for v in pr.cat_values:
                            if v in idx:
                                row[idx[v]] = True
                        member[ti, pi, di] = row
                    else:
                        kind[ti, pi, di] = 1
                        col[ti, pi, di] = num_col[pr.attribute]
                        op[ti, pi, di] = _OP_CODE[pr.operator]
                        val[ti, pi, di] = pr.value
                        if pr.other_bound is not None:
                            other[ti, pi, di] = pr.other_bound
        self.tables = tuple(torch.from_numpy(a).to(self.device) for a in
                            (kind, col, op, val, other, member))
        self.path_class = torch.from_numpy(path_class).to(self.device)
        self.path_valid = torch.from_numpy(path_valid).to(self.device)
        self.n_trees = t

    def _features(self, ds: Dataset):
        # a dummy column keeps the gather axes non-empty for schemas with
        # no numeric (or no categorical) features; kind masks it out
        x_num = np.stack(
            [ds.column(f.ordinal).astype(np.float32) for f in self.num_fields],
            axis=1) if self.num_fields else np.zeros((len(ds), 1), np.float32)
        x_cat = np.stack(
            [ds.column(f.ordinal).astype(np.int32) for f in self.cat_fields],
            axis=1) if self.cat_fields else np.zeros((len(ds), 1), np.int32)
        # host arrays: per_tree_predict copies one row block at a time,
        # so device memory stays bounded at any corpus size
        return x_num, x_cat

    def per_tree_predict(self, ds: Dataset,
                         row_block: int = PREDICT_ROW_BLOCK) -> np.ndarray:
        """[n, T] predicted class codes, first matching path in path order
        (rows matching no valid path predict class 0, as the host loop).
        Rows evaluate in `row_block` chunks: the match's intermediates are
        O(rows x trees x paths x depth)."""
        x_num, x_cat = self._features(ds)
        out = []
        trees = torch.arange(self.n_trees, device=self.device)[None, :]
        for s in range(0, len(ds), row_block):
            matches = _path_match_kernel(
                torch.from_numpy(x_num[s:s + row_block]).to(self.device),
                torch.from_numpy(x_cat[s:s + row_block]).to(self.device),
                *self.tables)
            matches = matches & self.path_valid[None]
            # argmax takes no bool on the card; it returns the first
            # maximum: the first matching path
            first = torch.argmax(matches.to(torch.int32), dim=-1)   # [b, T]
            pred = self.path_class[trees, first]
            out.append(torch.where(matches.any(dim=-1), pred, 0)
                       .to(torch.int32).cpu().numpy())
        return np.concatenate(out) if out else np.zeros((0, self.n_trees),
                                                        np.int32)

    def predict(self, ds: Dataset) -> np.ndarray:
        """[n] class codes: single tree pass-through, or majority vote
        across trees (RandomForestBuilder.predict semantics)."""
        per_tree = self.per_tree_predict(ds)
        if self.n_trees == 1:
            return per_tree[:, 0]
        k = len(self.class_values)
        votes = np.zeros((per_tree.shape[0], k), np.int64)
        rows = np.arange(per_tree.shape[0], dtype=np.int32)
        for t in range(per_tree.shape[1]):
            votes[rows, per_tree[:, t]] += 1
        return votes.argmax(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


def _leaf_pad(n_leaves: int) -> int:
    """The leaf axis padded to the next power of two, as the JAX package
    pads it (a static shape there); padded ids receive no rows."""
    return 1 << (n_leaves - 1).bit_length()


def _mesh_level_histogram(mesh):
    """`_level_histogram` of rows sharded over the mesh's data axis: the
    exact counts of this rank's rows summed over the ranks
    (`parallel.distributed`'s tree_level family), as float32."""
    from avenir_tpu_torch.parallel.distributed import distributed_tree_level_fn
    from avenir_tpu_torch.parallel.mesh import DATA_AXIS

    def histogram(leaf_id, seg_matrix, labels, weights, n_leaves, n_splits,
                  smax, k):
        return distributed_tree_level_fn(
            mesh, n_leaves, n_splits, smax, k, axes=(DATA_AXIS,))(
            leaf_id, seg_matrix, labels, weights).to(torch.float32)

    return histogram


class DecisionTreeBuilder:
    """dtb.* job equivalent: level-wise tree growth, all state in-process,
    the device work on `device` (default cuda)."""

    def __init__(
        self,
        schema: FeatureSchema,
        split_algorithm: str = "entropy",          # or giniIndex
        max_depth: int = 3,
        min_info_gain: float = -1.0,
        min_population: int = -1,
        stopping_strategy: str = "maxDepth",
        attr_selection_strategy: str = "notUsedYet",
        cat_partition_cap: int = 128,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.schema = schema
        self.algo = split_algorithm
        self.max_depth = max_depth
        self.min_info_gain = min_info_gain
        self.min_population = min_population
        self.stopping = stopping_strategy
        self.attr_strategy = attr_selection_strategy
        self.class_values = schema.class_values()
        self.splits = enumerate_splits(schema, cat_partition_cap)
        self.smax = max((s.n_segments for s in self.splits), default=2)
        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------- fit
    def fit(self, ds: Dataset, row_weights: Optional[np.ndarray] = None,
            mesh=None) -> DecisionPathList:
        """Build the tree: a level histogram, the host's split choice and
        an advance a level (each level one `stream.fold` span), then the
        final histogram for the leaves' class distributions.

        With `mesh` (`parallel.data_mesh`, on `mesh.device`), every rank
        calls fit on the whole dataset and keeps its shard of the rows
        over the data axis (pad rows weigh 0); each level histogram is
        summed over the ranks as exact int64 counts, so every rank picks
        the same splits and the tree equals fit()'s."""
        n = len(ds)
        k = len(self.class_values)
        ns = len(self.splits)
        with obs.span("stream.fold", sink="split_encode", rows=n):
            seg = segment_matrix(self.splits, ds)             # [n, NS]
            labels = ds.labels()
            w_host = (row_weights.astype(np.float32) if row_weights is not None
                      else np.ones(n, np.float32))
            if mesh is None:
                dev = self.device
                seg_d = torch.from_numpy(seg).to(dev)
                labels_d = torch.from_numpy(labels).to(dev)
                w = torch.from_numpy(w_host).to(dev)
            else:
                from avenir_tpu_torch.parallel.mesh import shard_rows
                dev = mesh.device
                seg_d = shard_rows(mesh, seg)
                labels_d = shard_rows(mesh, labels)
                w = shard_rows(mesh, w_host)          # pad rows weigh 0
            leaf_id = torch.zeros(seg_d.shape[0], dtype=torch.int32,
                                  device=dev)
        histogram = _level_histogram if mesh is None else \
            _mesh_level_histogram(mesh)

        # host-side tree state: leaf -> (predicate chain, used attrs)
        leaves: List[Dict] = [{"preds": [], "used": set(), "stopped": False}]

        for depth in range(self.max_depth):
            if not self._active_leaves(leaves):
                break
            with obs.span("stream.fold", sink="tree_level", chunk=depth):
                lpad = _leaf_pad(len(leaves))
                counts = histogram(
                    leaf_id, seg_d, labels_d, w, lpad, ns, self.smax, k
                ).cpu().numpy()[: len(leaves)]                # [L, NS, S, K]
                best_split_of_leaf, child_offset, new_leaves = \
                    self._grow_level(leaves, counts, lpad)
                if not new_leaves:
                    break
                leaf_id = _advance_leaves(
                    leaf_id, seg_d, torch.from_numpy(best_split_of_leaf).to(dev),
                    torch.from_numpy(child_offset).to(dev))
            # children get smax slots per split parent; re-index leaves
            leaves = leaves + new_leaves

        with obs.span("stream.fold", sink="tree_level", chunk="final"):
            counts_final = histogram(
                leaf_id, seg_d, labels_d, w, _leaf_pad(len(leaves)),
                max(ns, 1), self.smax, k
            ).cpu().numpy()[: len(leaves)] if ns else None
        return self._emit_paths(leaves, counts_final)

    @staticmethod
    def _active_leaves(leaves: List[Dict]) -> List[int]:
        return [i for i, lf in enumerate(leaves)
                if not lf["stopped"] and "split" not in lf]

    def _grow_level(self, leaves: List[Dict], counts: np.ndarray, lpad: int
                    ) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
        """Host-side split selection for one level, given the float32
        [L, NS, S, K] class histogram of every (leaf, candidate split,
        segment). Returns (best_split_of_leaf [lpad], child_offset [lpad],
        new_leaves); mutates `leaves` entries (split chosen / stopped)."""
        k = len(self.class_values)
        ns = len(self.splits)
        impurity_fn = (_np_bits_entropy if self.algo in ("entropy", "infoGain")
                       else _np_gini)
        seg_tot = counts.sum(axis=3)                      # [L, NS, S]
        leaf_tot = seg_tot.sum(axis=2)                    # [L, NS] (same per split)

        # weighted impurity per (leaf, split)
        imp = impurity_fn(counts, axis=-1)                # [L,NS,S]
        wimp = (seg_tot * imp).sum(axis=2) / np.maximum(leaf_tot, 1e-9)

        best_split_of_leaf = np.full(lpad, -1, np.int32)
        child_offset = np.full(lpad, -1, np.int32)
        new_leaves: List[Dict] = []

        for li in self._active_leaves(leaves):
            lf = leaves[li]
            pop = float(leaf_tot[li].max())
            # class counts of this leaf: any split column's segment-sum
            cls_counts = (counts[li, 0].sum(axis=0) if ns
                          else np.zeros(k, np.float64))
            node_imp = float(impurity_fn(cls_counts))

            allowed = self._allowed_splits(lf)
            if pop <= 0 or not allowed or node_imp <= 0.0:
                # pure nodes cannot improve; splitting them only burns
                # device passes and bloats the path list
                lf["stopped"] = True
                continue
            cand = wimp[li, allowed]
            bi = int(allowed[int(np.argmin(cand))])
            gain = node_imp - float(wimp[li, bi])

            # stopping strategies (DecisionPathStoppingStrategy.java:57-70;
            # maxDepth is enforced by the level-loop bound itself)
            stop = False
            if self.stopping == "minInfoGain" and self.min_info_gain >= 0:
                stop = gain < self.min_info_gain
            elif self.stopping == "minPopulation" and self.min_population >= 0:
                stop = pop < self.min_population
            if stop:
                lf["stopped"] = True
                continue

            sp = self.splits[bi]
            best_split_of_leaf[li] = bi
            child_offset[li] = len(leaves) + len(new_leaves)
            for s in range(self.smax):
                if s < sp.n_segments:
                    new_leaves.append({
                        "preds": lf["preds"] + [sp.predicates[s]],
                        "used": lf["used"] | {sp.attribute},
                        "stopped": False,
                    })
                else:
                    # pad children so child ids stay contiguous per leaf;
                    # never emitted as paths (no rows can route here)
                    new_leaves.append({"preds": lf["preds"], "used": lf["used"],
                                       "stopped": True, "pad": True})
            lf["split"] = bi           # parent becomes an internal node
        return best_split_of_leaf, child_offset, new_leaves

    def _emit_paths(self, leaves: List[Dict],
                    counts_final: Optional[np.ndarray]) -> DecisionPathList:
        """Final paths: any leaf never split, with class distribution from
        the final level histogram."""
        k = len(self.class_values)
        model_paths: List[DecisionPath] = []
        for li, lf in enumerate(leaves):
            if "split" in lf or lf.get("pad"):
                continue                   # internal node / padded child slot
            cls_counts = (
                counts_final[li, 0].sum(axis=0)
                if counts_final is not None else np.zeros(k, np.float64)
            )
            tot = cls_counts.sum()
            if tot <= 0 and lf["preds"]:
                continue                   # padded/empty child
            pr = {
                self.class_values[c]: (float(cls_counts[c]) / tot if tot else 0.0)
                for c in range(k)
            }
            info = float(
                (_np_bits_entropy if self.algo in ("entropy", "infoGain")
                 else _np_gini)(cls_counts))
            model_paths.append(DecisionPath(
                lf["preds"], int(tot), info, True, pr
            ))
        return DecisionPathList(model_paths)

    def _allowed_splits(self, leaf: Dict) -> List[int]:
        strat = self.attr_strategy
        used = leaf["used"]
        attrs = sorted({sp.attribute for sp in self.splits})
        if strat == "all":
            chosen = set(attrs)
        elif strat == "notUsedYet":
            # exhausted attributes stop the leaf rather than re-splitting on
            # an already-used attribute (which yields duplicate predicates)
            chosen = set(a for a in attrs if a not in used)
        elif strat == "randomAll":
            m = max(1, int(math.sqrt(len(attrs))))
            chosen = set(self.rng.choice(attrs, size=m, replace=False).tolist())
        elif strat == "randomNotUsedYet":
            avail = [a for a in attrs if a not in used]
            if not avail:
                return []
            m = max(1, int(math.sqrt(len(avail))))
            chosen = set(self.rng.choice(avail, size=m, replace=False).tolist())
        else:
            chosen = set(attrs)
        return [i for i, sp in enumerate(self.splits) if sp.attribute in chosen]


# ---------------------------------------------------------------------------
# random forest
# ---------------------------------------------------------------------------


class RandomForestBuilder:
    """RF = trees over bootstrap row weights + random attribute selection
    (reference first-iteration sampling DecisionTreeBuilder.java:200-236 with
    sub.sampling.strategy withReplace/withoutReplace), on `device`
    (default cuda)."""

    def __init__(
        self,
        schema: FeatureSchema,
        num_trees: int = 10,
        sampling: str = "withReplace",
        sample_rate: float = 0.7,
        seed: int = 0,
        device: DeviceLike = None,
        **tree_kwargs,
    ):
        self.schema = schema
        self.num_trees = num_trees
        self.sampling = sampling
        self.sample_rate = sample_rate
        self.seed = seed
        self.device = resolve_device(device)
        tree_kwargs.setdefault("attr_selection_strategy", "randomNotUsedYet")
        self.tree_kwargs = tree_kwargs
        self.trees: List[DecisionPathList] = []
        self.class_values = schema.class_values()
        self._evaluator: Optional[DevicePathEvaluator] = None

    def fit(self, ds: Dataset) -> "RandomForestBuilder":
        """All trees grow together, one histogram call and one advance a
        level for the whole forest: the trees share the segment matrix and
        labels on the device and differ only in bootstrap weights and leaf
        routing (each level one `stream.fold` span)."""
        n = len(ds)
        dev = self.device
        rng = np.random.default_rng(self.seed)
        self.trees = []
        self._evaluator = None
        ws = np.empty((self.num_trees, n), np.float32)
        for t in range(self.num_trees):
            if self.sampling == "withReplace":
                idx = rng.integers(0, n, n)
                ws[t] = np.bincount(idx, minlength=n).astype(np.float32)
            elif self.sampling == "withoutReplace":
                ws[t] = (rng.random(n) < self.sample_rate).astype(np.float32)
            else:
                ws[t] = 1.0
        builders = [
            DecisionTreeBuilder(self.schema, seed=self.seed + t, device=dev,
                                **self.tree_kwargs)
            for t in range(self.num_trees)
        ]
        b0 = builders[0]
        ns, k, smax = len(b0.splits), len(b0.class_values), b0.smax
        with obs.span("stream.fold", sink="split_encode", rows=n):
            seg_d = torch.from_numpy(segment_matrix(b0.splits, ds)).to(dev)
            labels_d = torch.from_numpy(ds.labels()).to(dev)
            ws_d = torch.from_numpy(ws).to(dev)
            leaf_ids = torch.zeros((self.num_trees, n), dtype=torch.int32,
                                   device=dev)
        leaves_t: List[List[Dict]] = [
            [{"preds": [], "used": set(), "stopped": False}]
            for _ in range(self.num_trees)
        ]

        for depth in range(b0.max_depth):
            if not any(DecisionTreeBuilder._active_leaves(lv)
                       for lv in leaves_t):
                break
            with obs.span("stream.fold", sink="forest_level", chunk=depth):
                lpad = _leaf_pad(max(len(lv) for lv in leaves_t))
                counts_all = _level_histogram_forest(
                    leaf_ids, seg_d, labels_d, ws_d, lpad, ns, smax, k
                ).cpu().numpy()
                bests, offsets = [], []
                any_new = False
                for t, b in enumerate(builders):
                    best, child, new_l = b._grow_level(
                        leaves_t[t], counts_all[t][: len(leaves_t[t])], lpad)
                    if new_l:
                        any_new = True
                        leaves_t[t] = leaves_t[t] + new_l
                    bests.append(best)
                    offsets.append(child)
                if not any_new:
                    break
                leaf_ids = _advance_leaves_forest(
                    leaf_ids, seg_d, torch.from_numpy(np.stack(bests)).to(dev),
                    torch.from_numpy(np.stack(offsets)).to(dev))

        with obs.span("stream.fold", sink="forest_level", chunk="final"):
            lpad = _leaf_pad(max(len(lv) for lv in leaves_t))
            counts_fin = _level_histogram_forest(
                leaf_ids, seg_d, labels_d, ws_d, lpad, max(ns, 1), smax, k
            ).cpu().numpy() if ns else None
        self.trees = [
            b._emit_paths(
                leaves_t[t],
                counts_fin[t][: len(leaves_t[t])]
                if counts_fin is not None else None)
            for t, b in enumerate(builders)
        ]
        return self

    def predict(self, ds: Dataset, device: bool = False) -> np.ndarray:
        """Majority vote across trees. device=True routes every row
        through every tree's paths in one batched match a row block on the
        builder's device (DevicePathEvaluator) instead of the host
        per-path loop."""
        if device:
            if self._evaluator is None:
                self._evaluator = DevicePathEvaluator(
                    self.trees, self.schema, self.class_values, self.device)
            return self._evaluator.predict(ds)
        k = len(self.class_values)
        votes = np.zeros((len(ds), k), np.int64)
        rows = np.arange(len(ds), dtype=np.int32)
        for tree in self.trees:
            pred = tree.predict(ds, self.class_values)
            votes[rows, pred] += 1
        return votes.argmax(axis=1).astype(np.int32)

    def validate(self, ds: Dataset, pos_class: int = 1) -> ConfusionMatrix:
        cm = ConfusionMatrix(self.class_values, pos_class=pos_class)
        cm.add(ds.labels(), self.predict(ds))
        return cm


class DataPartitioner:
    """Physically partition rows by the best candidate split — the dap.* MR
    job (tree/DataPartitioner.java:59-131): pick the top split of the given
    (or best) attribute, then write each segment's rows to
    `<base>/split=<splitId>/segment=<j>/data` files for the next pipeline
    stage. The split's histograms are counted on `device` (default
    cuda)."""

    def __init__(self, schema: FeatureSchema, algorithm: str = "giniIndex",
                 split_attribute: Optional[int] = None,
                 cat_partition_cap: int = 128, device: DeviceLike = None):
        self.schema = schema
        self.algorithm = algorithm
        self.split_attribute = split_attribute
        self.cat_partition_cap = cat_partition_cap
        self.device = resolve_device(device)

    def best_split(self, ds: Dataset) -> Tuple[CandidateSplit, float]:
        from avenir_tpu_torch.models.explore import ClassPartitionGenerator

        attrs = ([self.split_attribute]
                 if self.split_attribute is not None else None)
        cpg = ClassPartitionGenerator(ds, attributes=attrs,
                                      algorithm=self.algorithm,
                                      cat_partition_cap=self.cat_partition_cap,
                                      device=self.device)
        return cpg.best_split()

    def partition(self, ds: Dataset, base_path: str, delim: str = ",",
                  split: Optional[CandidateSplit] = None) -> List[str]:
        """Write each segment's rows of `split` (default: the best split,
        `best_split(ds)`); returns the written `.../segment=j/data` file
        paths in segment order (empty segments still get an empty file,
        as one reducer per segment would)."""
        if split is None:
            split, _ = self.best_split(ds)
        seg = split.segment_of(np.asarray(ds.column(split.attribute)))
        paths = []
        for j in range(split.n_segments):
            d = os.path.join(base_path, f"split={split.split_id}",
                             f"segment={j}")
            os.makedirs(d, exist_ok=True)
            p = os.path.join(d, "data")
            sub = ds.take(np.nonzero(seg == j)[0])
            with open(p, "w") as fh:
                fh.write(sub.to_csv(delim) if len(sub) else "")
            paths.append(p)
        return paths
