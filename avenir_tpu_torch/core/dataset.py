"""Columnar dataset: CSV rows -> host numpy columns.

The port's own copy of `avenir_tpu/core/dataset.py`'s parsers. The
reference's unit of data is a delimited text line whose fields get meaning
from the FeatureSchema JSON; here each CSV split is parsed once on the host
into columns: categoricals dictionary-encoded against the schema's
cardinality, numerics as float32, ids as host-side object arrays (made
lazily by the native parser: most jobs never read them). Two parsers give
the same columns: the native one-pass C++ parser (`native/ingest.py`) and
the Python row parser. Tensors are made from these columns by the models,
on the device the caller names.
"""

from __future__ import annotations

import io
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from avenir_tpu_torch import obs
from avenir_tpu_torch.core.schema import FeatureField, FeatureSchema
from avenir_tpu_torch.native import ingest

ENGINES = ("auto", "native", "python")


class Dataset:
    """Columnar view of one CSV input split against a FeatureSchema."""

    def __init__(self, schema: FeatureSchema, columns: Dict[int, np.ndarray],
                 n_rows: int, raw_rows: Optional[List[List[str]]] = None,
                 lazy: Optional[Dict[int, object]] = None,
                 engine: str = "python",
                 parse_bins: Optional[Tuple[Tuple[int, int], ...]] = None):
        self.schema = schema
        self.columns = columns          # ordinal -> np array (codes / floats / object)
        self.n_rows = n_rows
        self.raw_rows = raw_rows        # kept when output echoes the input row
        # ordinal -> zero-arg thunk of a string column not made yet
        self._lazy = dict(lazy) if lazy else {}
        self.engine = engine            # the parser that made the columns
        # (ordinal, bins) of each field asked for -> (codes, bins)
        self._codes_cache: Dict[tuple, tuple] = {}
        # (ordinal, bins) of every field with bins as this chunk's parse
        # left the shared schema (a Dataset is made at the end of its
        # parse): a later chunk's parse, which a prefetch thread may run
        # ahead of the folds, can grow a discovered vocabulary, and this
        # chunk's codes and sizes must not see it
        self.parse_bins = (_bins_snapshot(schema) if parse_bins is None
                           else parse_bins)
        self._bins = dict(self.parse_bins)

    # ------------------------------------------------------------------ load
    @classmethod
    def from_csv(cls, source: Union[str, bytes, Iterable[str]],
                 schema: FeatureSchema, delim: str = ",",
                 keep_raw: bool = False, engine: str = "auto") -> "Dataset":
        """Parse CSV lines (a path, a text blob, raw bytes, or an iterable
        of lines) into columns. Unknown values of a declared categorical
        raise. A string is a file path if such a file exists, otherwise
        content (which must contain a newline or the delimiter). Bytes are
        always content — the block reader (core/stream.py) hands file
        blocks here. keep_raw keeps each row's stripped tokens in
        `raw_rows`.

        engine: "auto" takes the native parser where it applies (a path,
        text or bytes source, a one-byte delimiter, no keep_raw) and it is
        built, else the Python row parser; "native" requires the native
        parser and raises where it does not apply or is not built;
        "python" forces the row parser. Both give the same columns and
        the same errors. The parse is the span `stream.parse` (attributes
        `nbytes` and `engine`, the parser that ran)."""
        if engine not in ENGINES:
            raise ValueError(f"unknown CSV engine {engine!r} "
                             "(want auto, native, or python)")
        t0 = obs.now()
        ds = cls._parse(source, schema, delim, keep_raw, engine)
        obs.record("stream.parse", t0, nbytes=_nbytes(source),
                   engine=ds.engine)
        return ds

    @classmethod
    def _parse(cls, source, schema, delim, keep_raw, engine) -> "Dataset":
        text = isinstance(source, str)
        path = text and os.path.exists(source)
        if text and not path and not ("\n" in source or delim in source
                                      or source == ""):
            raise FileNotFoundError(f"no such CSV file: {source!r}")
        fits = (not keep_raw and len(delim.encode()) == 1
                and isinstance(source, (str, bytes, bytearray)))
        if engine == "native" and not fits:
            raise ValueError(
                "engine='native' requires a path, text or bytes source, a "
                "one-byte delimiter, and keep_raw=False")
        if engine != "python" and fits:
            if ingest.native_available():
                if path:
                    with open(source, "rb") as fh:
                        data = fh.read()
                else:
                    data = source.encode() if text else bytes(source)
                return cls._from_native(data, schema, delim)
            if engine == "native":
                raise RuntimeError("native CSV ingest unavailable (no g++?)")
        if isinstance(source, (bytes, bytearray)):
            source = bytes(source).decode()
        lines = (open(source, "r") if path else io.StringIO(source)
                 if isinstance(source, str) else source)
        try:
            return cls._from_lines(lines, schema, delim, keep_raw)
        finally:
            if path:
                lines.close()

    @classmethod
    def _from_lines(cls, lines: Iterable[str], schema: FeatureSchema,
                    delim: str, keep_raw: bool) -> "Dataset":
        rows: List[List[str]] = []
        for line in lines:
            line = line.rstrip("\n").rstrip("\r")
            if not line.strip():
                continue
            rows.append([tok.strip() for tok in line.split(delim)])
        return cls.from_rows(rows, schema, keep_raw=keep_raw)

    @classmethod
    def _from_native(cls, data: bytes, schema: FeatureSchema,
                     delim: str) -> "Dataset":
        """The native one-pass parse, with the Python parser's errors.
        Categoricals with a fixed declared vocabulary encode in C; those
        with an undeclared (discovered, growable) one come back as tokens
        and are encoded here after the parse, as from_rows does."""
        numeric = [f.ordinal for f in schema.fields if f.is_numeric]
        declared = [f for f in schema.fields if f.is_categorical
                    and f.cardinality and not f.discovered_cardinality]
        undeclared = [f for f in schema.fields if f.is_categorical
                      and (not f.cardinality or f.discovered_cardinality)]
        strings = [f.ordinal for f in schema.fields
                   if not f.is_numeric and not f.is_categorical]
        try:
            n, columns, lazy = ingest.parse_csv_native(
                data, delim, numeric, [(f.ordinal, f.cardinality)
                                       for f in declared],
                strings + [f.ordinal for f in undeclared], lazy_strings=True)
        except ingest.NativeParseError as e:
            if e.kind == "numeric":
                raise ValueError(f"could not convert string to float: "
                                 f"{e.token!r}") from None
            name = next(f.name for f in schema.fields
                        if f.ordinal == e.ordinal)
            raise ValueError(f"value {e.token!r} not in declared cardinality "
                             f"of field {name!r}") from None
        for fld in undeclared:
            toks = lazy.pop(fld.ordinal)().tolist()
            _discover_cardinality(fld, toks)
            index = fld.cardinality_index()
            columns[fld.ordinal] = np.array([index[t] for t in toks],
                                            dtype=np.int32)
        for fld in schema.fields:
            if fld.is_numeric:
                _discover_numeric_range(fld, columns[fld.ordinal])
        return cls(schema, columns, n, lazy=lazy, engine="native")

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
        if ordinal not in self.columns and ordinal in self._lazy:
            self.columns[ordinal] = self._lazy.pop(ordinal)()
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
            fields = self.encodable_feature_fields()
        # keyed on (ordinal, bins) so a vocabulary discovered after a
        # cached call (a grown num_bins) misses instead of serving codes
        # stacked against the old bin count
        memo_key = tuple((f.ordinal, self.num_bins(f)) for f in fields)
        hit = self._codes_cache.get(memo_key)
        if hit is not None:
            return hit[0], list(hit[1])
        cols, bins = [], []
        for fld in fields:
            nb = self.num_bins(fld)
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
        # the cached matrix is shared by every caller (a SharedScan chunk
        # feeds several folds): frozen, so a fold that writes to it raises
        # instead of corrupting the others' codes
        codes.setflags(write=False)
        self._codes_cache[memo_key] = (codes, tuple(bins))
        return codes, bins

    def feature_matrix(self, fields: Optional[Sequence[FeatureField]] = None
                       ) -> np.ndarray:
        """float32 [n, D] of numeric feature values (raw, unbinned)."""
        if fields is None:
            fields = self.numeric_feature_fields()
        cols = [self.column(f.ordinal).astype(np.float32, copy=False)
                for f in fields]
        if not cols:
            return np.zeros((self.n_rows, 0), dtype=np.float32)
        return np.stack(cols, axis=1)

    def numeric_feature_fields(self) -> List[FeatureField]:
        return [f for f in self.schema.feature_fields if f.is_numeric]

    def encodable_feature_fields(self) -> List[FeatureField]:
        return [f for f in self.schema.feature_fields if self.num_bins(f) > 0]

    def num_bins(self, fld: FeatureField) -> int:
        """fld.num_bins() as this chunk's parse left it (`parse_bins`);
        the live schema's for a field it does not hold."""
        nb = self._bins.get(fld.ordinal)
        return fld.num_bins() if nb is None else nb

    def class_values(self) -> List[str]:
        """The class vocabulary as this chunk's parse left it: a
        discovered vocabulary only grows at its end, so its first
        `parse_bins` values (a class field without bins, such as a
        string-typed one, keeps its declared list)."""
        cf = self.schema.class_field
        if cf is None:
            return []
        nb = self._bins.get(cf.ordinal)
        return list(cf.cardinality if nb is None else cf.cardinality[:nb])

    def num_classes(self) -> int:
        return len(self.class_values())

    def to_csv(self, delim: str = ",") -> str:
        """Rows back as reference-style CSV text: the kept raw rows when
        there are any (byte-identical pass-through), else rebuilt from the
        columns (categorical codes decoded to their cardinality values)."""
        if self.raw_rows is not None:
            return "\n".join(delim.join(r) for r in self.raw_rows) + "\n"
        # tokens land at their declared ordinals; gaps (fields present in
        # the file but undeclared in the schema, e.g. call_hangup's area
        # code) become empty tokens so the row re-parses against the schema
        width = max(f.ordinal for f in self.schema.fields) + 1
        lines = []
        for i in range(self.n_rows):
            toks = [""] * width
            for fld in self.schema.fields:
                col = self.column(fld.ordinal)
                if fld.is_categorical:
                    tok = fld.decode_value(int(col[i]))
                elif fld.is_numeric:
                    v = float(col[i])
                    # NaN is the parsers' missing value: an empty token
                    tok = ("" if not np.isfinite(v)
                           else str(int(v)) if v == int(v) else f"{v:.6g}")
                else:
                    tok = str(col[i])
                toks[fld.ordinal] = tok
            lines.append(delim.join(toks))
        return "\n".join(lines) + "\n"

    def take(self, idx: np.ndarray) -> "Dataset":
        """Row subset (a numpy fancy index); a lazy column stays lazy."""
        idx = np.asarray(idx)
        lazy = {o: (lambda o=o: self.column(o)[idx]) for o in self._lazy}
        cols = {o: c[idx] for o, c in self.columns.items()}
        raw = ([self.raw_rows[i] for i in idx] if self.raw_rows is not None
               else None)
        return Dataset(self.schema, cols, int(idx.shape[0]), raw, lazy=lazy,
                       engine=self.engine, parse_bins=self.parse_bins)

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


def _bins_snapshot(schema: FeatureSchema) -> Tuple[Tuple[int, int], ...]:
    """(ordinal, num_bins) of every field with bins; a bucketized field
    with no max yet is left out (its num_bins raises when asked)."""
    out = []
    for fld in schema.fields:
        try:
            nb = fld.num_bins()
        except ValueError:
            continue
        if nb > 0:
            out.append((fld.ordinal, nb))
    return tuple(out)


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


def _nbytes(source) -> int:
    """Bytes of a parse's source: a file's size, text's or bytes' length,
    -1 for an iterable of lines."""
    if isinstance(source, (bytes, bytearray)):
        return len(source)
    if isinstance(source, str):
        return (os.path.getsize(source) if os.path.exists(source)
                else len(source.encode()))
    return -1


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
        bins = tuple(ds.num_bins(f) for f in cat_fields)
    else:
        x_cat, bins = None, None
    return x_num, ranges, x_cat, bins
