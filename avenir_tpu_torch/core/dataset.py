"""Columnar dataset: CSV rows -> host numpy columns.

The port's own copy of the Python row parser of `avenir_tpu/core/dataset.py`
(the native C++ ingest is not ported yet). The reference's unit of data is
a delimited text line whose fields get meaning from the FeatureSchema JSON;
here each CSV split is parsed once on the host into columns:
categoricals dictionary-encoded against the schema's cardinality, numerics
as float32, ids as host-side object arrays. Tensors are made from these
columns by the models, on the device the caller names.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema


class Dataset:
    """Columnar view of one CSV input split against a FeatureSchema."""

    def __init__(self, schema: FeatureSchema, columns: Dict[int, np.ndarray],
                 n_rows: int, raw_rows: Optional[List[List[str]]] = None):
        self.schema = schema
        self.columns = columns          # ordinal -> np array (codes / floats / object)
        self.n_rows = n_rows
        self.raw_rows = raw_rows        # kept when output echoes the input row

    # ------------------------------------------------------------------ load
    @classmethod
    def from_csv(cls, source: Union[str, bytes, Iterable[str]],
                 schema: FeatureSchema, delim: str = ",",
                 keep_raw: bool = False) -> "Dataset":
        """Parse CSV lines (a path, a text blob, raw bytes, or an iterable
        of lines) into columns. Unknown values of a declared categorical
        raise. A string is a file path if such a file exists, otherwise
        content (which must contain a newline or the delimiter). Bytes are
        always content — the block reader (core/stream.py) hands file
        blocks here. keep_raw keeps each row's stripped tokens in
        `raw_rows`."""
        if isinstance(source, (bytes, bytearray)):
            source = io.StringIO(bytes(source).decode())
        if isinstance(source, str):
            if os.path.exists(source):
                lines: Iterable[str] = open(source, "r")
            elif "\n" in source or delim in source:
                lines = io.StringIO(source)
            elif source == "":
                lines = io.StringIO("")
            else:
                raise FileNotFoundError(f"no such CSV file: {source!r}")
        else:
            lines = source
        try:
            rows: List[List[str]] = []
            for line in lines:
                line = line.rstrip("\n").rstrip("\r")
                if not line.strip():
                    continue
                rows.append([tok.strip() for tok in line.split(delim)])
        finally:
            if hasattr(lines, "close") and lines is not source:
                lines.close()
        return cls.from_rows(rows, schema, keep_raw=keep_raw)

    @classmethod
    def from_rows(cls, rows: List[List[str]], schema: FeatureSchema,
                  keep_raw: bool = False) -> "Dataset":
        n = len(rows)
        columns: Dict[int, np.ndarray] = {}
        for fld in schema.fields:
            o = fld.ordinal
            toks = [r[o] if o < len(r) else "" for r in rows]
            if fld.is_categorical:
                _discover_cardinality(fld, toks)
                index = fld.cardinality_index()
                try:
                    columns[o] = np.array([index[t] for t in toks], dtype=np.int32)
                except KeyError as e:
                    raise ValueError(
                        f"value {e.args[0]!r} not in declared cardinality of "
                        f"field {fld.name!r}") from None
            elif fld.is_numeric:
                columns[o] = np.array(
                    [float(t) if t != "" else np.nan for t in toks],
                    dtype=np.float32)
                _discover_numeric_range(fld, columns[o])
            else:  # string / text / id: host-side object column
                columns[o] = np.array(toks, dtype=object)
        return cls(schema, columns, n, raw_rows=rows if keep_raw else None)

    # ----------------------------------------------------------------- views
    def column(self, ordinal: int) -> np.ndarray:
        return self.columns[ordinal]

    def ids(self) -> np.ndarray:
        idf = self.schema.id_field
        if idf is None:
            return np.array([str(i) for i in range(self.n_rows)], dtype=object)
        return self.column(idf.ordinal)

    def labels(self) -> np.ndarray:
        """Encoded class attribute codes, int32 [n]."""
        cf = self.schema.class_field
        if cf is None:
            raise ValueError("schema has no class attribute")
        col = self.column(cf.ordinal)
        if col.dtype == object:  # class field declared as plain string
            index = cf.cardinality_index()
            return np.array([index[v] for v in col], dtype=np.int32)
        return col.astype(np.int32)

    def feature_codes(self, fields: Optional[Sequence[FeatureField]] = None
                      ) -> Tuple[np.ndarray, List[int]]:
        """Dense per-feature states: (codes int32 [n, F], bins list[F]) over
        the dense-encodable feature fields (categoricals and bucketized
        numerics), in ordinal order. Numeric features without bucketWidth
        are skipped: Naive Bayes takes them from feature_matrix()."""
        if fields is None:
            fields = [f for f in self.schema.feature_fields if f.num_bins() > 0]
        cols, bins = [], []
        for fld in fields:
            nb = fld.num_bins()
            if nb <= 0:
                continue
            col = self.column(fld.ordinal)
            if fld.is_categorical:
                cols.append(col.astype(np.int32, copy=False))
            else:
                if np.isnan(col).any():
                    raise ValueError(
                        f"missing value in bucketized numeric field {fld.name!r} "
                        "(empty tokens cannot be dense-encoded)")
                lo = fld.min if fld.min is not None else 0.0
                code = np.floor((col - lo) / fld.bucket_width).astype(np.int32)
                cols.append(np.clip(code, 0, nb - 1))
            bins.append(nb)
        codes = (np.stack(cols, axis=1) if cols
                 else np.zeros((self.n_rows, 0), dtype=np.int32))
        return codes, bins

    def feature_matrix(self, fields: Optional[Sequence[FeatureField]] = None
                       ) -> np.ndarray:
        """float32 [n, D] of numeric feature values (raw, unbinned)."""
        if fields is None:
            fields = [f for f in self.schema.feature_fields if f.is_numeric]
        cols = [self.column(f.ordinal).astype(np.float32, copy=False)
                for f in fields]
        if not cols:
            return np.zeros((self.n_rows, 0), dtype=np.float32)
        return np.stack(cols, axis=1)

    def __len__(self) -> int:
        return self.n_rows

    def __repr__(self) -> str:
        return f"Dataset(n={self.n_rows}, fields={len(self.schema)})"


def _discover_cardinality(fld, tokens) -> None:
    """Categorical fields may ship without a declared cardinality (e.g.
    `status` in the reference's elearnActivity.json rich schema): the value
    set is then discovered from the data, sorted for determinism, and
    recorded on the (shared) schema field so later splits parsed against
    the same schema object encode consistently; unseen values in later
    splits extend the vocabulary instead of raising."""
    if fld.cardinality:
        if fld.discovered_cardinality:
            new = sorted(set(tokens) - set(fld.cardinality))
            if new:
                fld.cardinality.extend(new)
        return
    fld.cardinality = sorted(set(tokens))
    fld.discovered_cardinality = True


def _discover_numeric_range(fld, col: np.ndarray) -> None:
    """Numeric fields with bucketWidth but no declared max: record the
    observed max on the (shared) schema field; it only grows across
    chunks, so earlier codes stay valid."""
    if not fld.bucket_width or (fld.max is not None
                                and not fld.discovered_range):
        return
    finite = col[np.isfinite(col)]
    if finite.size == 0:
        return
    hi = float(finite.max())
    fld.max = hi if fld.max is None else max(fld.max, hi)
    fld.discovered_range = True


def pad_rows(n: int, multiple: int) -> int:
    """Rows padded up to a multiple."""
    return ((n + multiple - 1) // multiple) * multiple


def extract_mixed_features(ds: Dataset):
    """Split a dataset into distance-ready arrays: (x_num float32 [n, Dn],
    ranges float32 [Dn], x_cat int32 [n, Dc] | None, cat_bins tuple | None).

    Ranges come from the schema's declared min/max (1.0 fallback) — the
    normalization the mixed-attribute distance metric uses."""
    num_fields = [f for f in ds.schema.feature_fields if f.is_numeric]
    cat_fields = [f for f in ds.schema.feature_fields if f.is_categorical]
    x_num = ds.feature_matrix(num_fields)
    ranges = np.array(
        [(f.max - f.min) if (f.max is not None and f.min is not None) else 1.0
         for f in num_fields],
        dtype=np.float32)
    if cat_fields:
        x_cat = np.stack(
            [ds.column(f.ordinal).astype(np.int32) for f in cat_fields], axis=1)
        bins = tuple(len(f.cardinality) for f in cat_fields)
    else:
        x_cat, bins = None, None
    return x_num, ranges, x_cat, bins
