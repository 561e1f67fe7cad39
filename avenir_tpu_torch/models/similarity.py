"""Pairwise record similarity: the sifarish / spark-similarity role.

The port of `avenir_tpu/models/similarity.py`. The reference computes
all-pairs record distances in an external job (sifarish
SameTypeSimilarity, resource/knn.sh:44-57, `sts.*` keys) and in two Spark
jobs (RecordSimilarity.scala:34, GroupedRecordSimilarity.scala:29), all on
chombo InterRecordDistance's mixed-attribute metric. Here each [bi, bj]
block pair is one `ops.distance.pairwise_distance` call on the device,
and the distance file keeps the reference's rows, `id1,id2,scaledDist`
(sts.distance.scale=1000), which `read_distance_file` reads back.

The writer formats a whole tile at a time, in the order the JAX
generators yield their pairs: tiles by (row block, column block), the
tiles wholly below the diagonal skipped for intra pairs, rows in order.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.core.dataset import Dataset, extract_mixed_features
from avenir_tpu_torch.ops.distance import pairwise_distance
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

# (row0, col0, tile float32 [bi, bj], the first column of each row)
Tile = Tuple[int, int, np.ndarray, np.ndarray]


class Pairs:
    """The (id1, id2, distance) pairs of a tile sweep, in the reference's
    order. Iterating yields the triples one at a time, as the JAX
    generators do; `RecordSimilarity.save` writes a tile at a time."""

    def __init__(self, tiles: Callable[[], Iterator[Tile]],
                 ids1: np.ndarray, ids2: np.ndarray):
        self.tiles = tiles
        self.ids1 = [str(v) for v in ids1]
        self.ids2 = [str(v) for v in ids2]

    def __iter__(self) -> Iterator[Tuple[str, str, float]]:
        for i0, j0, tile, first in self.tiles():
            for ii in range(tile.shape[0]):
                id1 = self.ids1[i0 + ii]
                for jj in range(int(first[ii]), tile.shape[1]):
                    yield id1, self.ids2[j0 + jj], float(tile[ii, jj])


def _scaled(tile: np.ndarray, scale: int) -> np.ndarray:
    """int(round(d * scale)) of every float32 d, in float64 with ties to
    even, as the reference's writer rounds each pair."""
    if not np.isfinite(tile).all():
        raise ValueError("a distance is not finite (a missing feature "
                         "value?); it has no scaled integer")
    return np.rint(tile.astype(np.float64) * scale).astype(np.int64)


class RecordSimilarity:
    """Blocked all-pairs mixed-attribute distances over Datasets, on
    `device` (default cuda).

    The metric and weights follow the reference's distance schema
    (numeric range-normalized, categorical 0/1 mismatch, weight-averaged).
    `intra()` gives the i < j pairs of one dataset; `inter()` the cross
    pairs of two (sts.inter.set.matching=true, KNN's train-vs-test mode).
    """

    def __init__(self, metric: str = "manhattan", scale: int = 1000,
                 block: int = 2048,
                 num_weights: Optional[Sequence[float]] = None,
                 cat_weights: Optional[Sequence[float]] = None,
                 device: DeviceLike = None):
        self.metric = metric
        self.scale = scale
        self.block = block
        self.num_weights = (np.asarray(num_weights, np.float32)
                            if num_weights is not None else None)
        self.cat_weights = (tuple(float(w) for w in cat_weights)
                            if cat_weights is not None else None)
        self.device = resolve_device(device)

    def _tiles(self, a: Dataset, b: Dataset, upper_only: bool
               ) -> Iterator[Tile]:
        """Yield (row0, col0, distance tile, first column of each row)
        over block-pair tiles; with upper_only, the pairs i < j only."""
        dev = self.device

        def on_device(x):
            return None if x is None else torch.from_numpy(x).to(dev)

        a_num, ranges, a_cat, bins = extract_mixed_features(a)
        b_num, _, b_cat, _ = extract_mixed_features(b)
        a_num, a_cat = on_device(a_num), on_device(a_cat)
        b_num, b_cat = on_device(b_num), on_device(b_cat)
        rng, nw = on_device(ranges), on_device(self.num_weights)
        na, nb = len(a), len(b)
        for i0 in range(0, na, self.block):
            i1 = min(i0 + self.block, na)
            for j0 in range(0, nb, self.block):
                if upper_only and j0 + self.block <= i0:
                    continue  # tile entirely below the diagonal
                j1 = min(j0 + self.block, nb)
                d = pairwise_distance(
                    a_num[i0:i1], b_num[j0:j1],
                    a_cat[i0:i1] if a_cat is not None else None,
                    b_cat[j0:j1] if b_cat is not None else None,
                    bins, rng, self.metric, nw, self.cat_weights,
                    divide=True)
                first = np.zeros(i1 - i0, np.int64)
                if upper_only:
                    first = np.maximum(i0 + np.arange(i1 - i0) + 1 - j0, 0)
                yield i0, j0, d.cpu().numpy(), first

    def intra(self, ds: Dataset) -> Pairs:
        """All unordered pairs (i < j) of one dataset."""
        ids = ds.ids()
        return Pairs(lambda: self._tiles(ds, ds, upper_only=True), ids, ids)

    def inter(self, base: Dataset, other: Dataset) -> Pairs:
        """All cross pairs (base x other): the train-vs-test mode."""
        return Pairs(lambda: self._tiles(base, other, upper_only=False),
                     base.ids(), other.ids())

    def save(self, pairs, path: str, delim: str = ",",
             id_first: bool = True) -> int:
        """Write `id1,id2,scaledDist` rows (or `scaledDist,id1,id2`:
        sts.output.id.first and sts.distance.scale). `pairs` is a `Pairs`
        or any iterable of (id1, id2, distance). Returns the pair count."""
        n = 0
        with open(path, "w") as fh:
            if not isinstance(pairs, Pairs):
                for id1, id2, d in pairs:
                    sd = int(round(d * self.scale))
                    fh.write(f"{id1}{delim}{id2}{delim}{sd}\n" if id_first
                             else f"{sd}{delim}{id1}{delim}{id2}\n")
                    n += 1
                return n
            for i0, j0, tile, first in pairs.tiles():
                sd = _scaled(tile, self.scale).tolist()
                ids2 = pairs.ids2[j0:j0 + tile.shape[1]]
                for ii, row in enumerate(sd):
                    id1 = pairs.ids1[i0 + ii]
                    j = int(first[ii])
                    if id_first:
                        head = f"{id1}{delim}"
                        fh.write("".join([f"{head}{id2}{delim}{v}\n"
                                          for id2, v in zip(ids2[j:], row[j:])]))
                    else:
                        tail = f"{delim}{id1}{delim}"
                        fh.write("".join([f"{v}{tail}{id2}\n"
                                          for id2, v in zip(ids2[j:], row[j:])]))
                    n += len(row) - j
        return n


class GroupedRecordSimilarity(RecordSimilarity):
    """Within-group all-pairs distances (GroupedRecordSimilarity.scala:29):
    rows grouped by one or more field ordinals; pairs never cross groups."""

    def __init__(self, group_ordinals: Sequence[int], **kw):
        super().__init__(**kw)
        self.group_ordinals = list(group_ordinals)

    def _group_key(self, ds: Dataset, i: int) -> Tuple:
        key = []
        for o in self.group_ordinals:
            fld = ds.schema.field_by_ordinal(o)
            v = ds.column(o)[i]
            key.append(fld.decode_value(int(v)) if fld.is_categorical
                       else str(v))
        return tuple(key)

    def grouped_intra(self, ds: Dataset
                      ) -> Iterator[Tuple[Tuple, str, str, float]]:
        groups: Dict[Tuple, List[int]] = {}
        for i in range(len(ds)):
            groups.setdefault(self._group_key(ds, i), []).append(i)
        for key in sorted(groups):
            sub = ds.take(np.asarray(groups[key]))
            for id1, id2, d in self.intra(sub):
                yield key, id1, id2, d


def read_distance_file(path: str, delim: str = ",", scale: int = 1000,
                       id_first: bool = True) -> Dict[Tuple[str, str], float]:
    """A distance file as a symmetric pair -> distance map (the
    reference's EntityDistanceMapFileAccessor.java:42). `id_first` is the
    layout the file was written with."""
    out: Dict[Tuple[str, str], float] = {}
    with open(path) as fh:
        for ln in fh:
            toks = [t.strip() for t in ln.rstrip("\n").split(delim)]
            if len(toks) < 3:
                continue
            if id_first:
                id1, id2, sd = toks[0], toks[1], float(toks[2])
            else:
                sd, id1, id2 = float(toks[0]), toks[1], toks[2]
            d = sd / scale
            out[(id1, id2)] = d
            out[(id2, id1)] = d
    return out


def distance_matrix_from_file(path: str, ids: Sequence[str],
                              delim: str = ",", scale: int = 1000,
                              default: float = np.inf,
                              pairs: Optional[Dict[Tuple[str, str], float]]
                              = None) -> np.ndarray:
    """Dense float64 [n, n] matrix over `ids` from a distance file
    (missing pairs `default`, diagonal 0). `pairs` from an earlier
    read_distance_file call skips the parse."""
    if pairs is None:
        pairs = read_distance_file(path, delim, scale)
    n = len(ids)
    m = np.full((n, n), default, np.float64)
    np.fill_diagonal(m, 0.0)
    index = {str(v): i for i, v in enumerate(ids)}
    for (a, b), d in pairs.items():
        ia, ib = index.get(a), index.get(b)
        if ia is not None and ib is not None:
            m[ia, ib] = d
    return m
