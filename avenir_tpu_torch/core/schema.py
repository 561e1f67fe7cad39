"""FeatureSchema: dataset metadata compatible with the reference JSON format.

The port's own copy of `avenir_tpu/core/schema.py` (the port imports
nothing of the JAX package). The reference consumes per-dataset JSON
schemas (resource/churn.json, resource/elearnActivity.json) through
chombo's FeatureSchema/FeatureField; every job resolves column ordinals,
types, roles (id / feature / class attribute) and categorical
cardinalities from it. This module parses the same JSON files unchanged
and adds stable integer encodings for categorical values.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence


DATA_TYPE_STRING = "string"
DATA_TYPE_CATEGORICAL = "categorical"
DATA_TYPE_INT = "int"
DATA_TYPE_DOUBLE = "double"

NUMERIC_TYPES = (DATA_TYPE_INT, DATA_TYPE_DOUBLE)


@dataclass
class FeatureField:
    """One column of the dataset.

    Mirrors the attributes of the reference schema JSON: name, ordinal,
    dataType, and the role flags / hints used by the jobs.
    """

    name: str
    ordinal: int
    data_type: str = DATA_TYPE_STRING
    # role flags
    id_field: bool = False
    feature: bool = False
    class_attr: bool = False
    # categorical metadata; discovered_cardinality marks a vocabulary that
    # was inferred from data (undeclared in the schema file) and may grow
    cardinality: List[str] = field(default_factory=list)
    discovered_cardinality: bool = False
    # numeric metadata (binning / split hints); discovered_range marks a
    # max that was inferred from data (undeclared bucketWidth extent, the
    # reference's hosp_readmit.json style) and may grow
    min: Optional[float] = None
    max: Optional[float] = None
    discovered_range: bool = False
    bucket_width: Optional[float] = None
    max_split: Optional[int] = None
    split_scan_interval: Optional[float] = None
    # misc passthrough of unrecognized keys (kept for round-tripping)
    extra: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------------ roles
    @property
    def is_categorical(self) -> bool:
        return self.data_type == DATA_TYPE_CATEGORICAL

    @property
    def is_numeric(self) -> bool:
        return self.data_type in NUMERIC_TYPES

    # --------------------------------------------------------------- encoding
    def cardinality_index(self) -> Dict[str, int]:
        """Stable mapping categorical value -> int code (order of declaration)."""
        return {v: i for i, v in enumerate(self.cardinality)}

    def num_bins(self) -> int:
        """Number of discrete states this field takes after encoding.

        Categorical: declared cardinality. Numeric with bucketWidth: number of
        buckets across [min, max] (the reference bins continuous features the
        same way when building count-based distributions). Other: 0 (not
        encodable to a dense state).
        """
        if self.is_categorical:
            return len(self.cardinality)
        if self.is_numeric and self.bucket_width:
            lo = self.min if self.min is not None else 0.0
            hi = self.max
            if hi is None:
                raise ValueError(
                    f"field {self.name!r}: bucketWidth set but no max bound"
                )
            return int(math.floor((hi - lo) / self.bucket_width)) + 1
        return 0

    def encode_value(self, raw: str) -> int:
        """Encode one raw CSV token to its dense integer state."""
        if self.is_categorical:
            return self.cardinality_index()[raw]
        if self.is_numeric and self.bucket_width:
            lo = self.min if self.min is not None else 0.0
            return int((float(raw) - lo) // self.bucket_width)
        raise ValueError(f"field {self.name!r} is not dense-encodable")

    # ------------------------------------------------------------------- json
    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FeatureField":
        known = {
            "name",
            "ordinal",
            "dataType",
            "id",
            "feature",
            "classAttribute",
            "cardinality",
            "min",
            "max",
            "bucketWidth",
            "maxSplit",
            "splitScanInterval",
            "discoveredCardinality",
            "discoveredRange",
        }
        return cls(
            name=obj.get("name", f"field{obj.get('ordinal')}"),
            ordinal=int(obj["ordinal"]),
            data_type=obj.get("dataType", DATA_TYPE_STRING),
            id_field=bool(obj.get("id", False)),
            feature=bool(obj.get("feature", False)),
            class_attr=bool(obj.get("classAttribute", False)),
            cardinality=[str(v) for v in obj.get("cardinality", [])],
            discovered_cardinality=bool(obj.get("discoveredCardinality",
                                                False)),
            min=obj.get("min"),
            max=obj.get("max"),
            discovered_range=bool(obj.get("discoveredRange", False)),
            bucket_width=obj.get("bucketWidth"),
            max_split=obj.get("maxSplit"),
            split_scan_interval=obj.get("splitScanInterval"),
            extra={k: v for k, v in obj.items() if k not in known},
        )

    def to_json(self) -> Dict[str, Any]:
        obj: Dict[str, Any] = {"name": self.name, "ordinal": self.ordinal}
        obj["dataType"] = self.data_type
        if self.id_field:
            obj["id"] = True
        if self.feature:
            obj["feature"] = True
        if self.class_attr:
            obj["classAttribute"] = True
        if self.cardinality:
            obj["cardinality"] = list(self.cardinality)
        if self.discovered_cardinality:
            # keeps a data-discovered vocabulary growable after reload
            obj["discoveredCardinality"] = True
        if self.discovered_range:
            # keeps a data-discovered numeric extent growable after reload
            obj["discoveredRange"] = True
        for key, val in (
            ("min", self.min),
            ("max", self.max),
            ("bucketWidth", self.bucket_width),
            ("maxSplit", self.max_split),
            ("splitScanInterval", self.split_scan_interval),
        ):
            if val is not None:
                obj[key] = val
        obj.update(self.extra)
        return obj


class FeatureSchema:
    """The full dataset schema: an ordered list of FeatureFields.

    Convention kept from the reference: when no field carries an explicit
    `classAttribute` flag, the *last* non-feature, non-id categorical field is
    the class attribute (this is how churn.json's `status` field is used by
    the Bayesian jobs even though it carries no explicit role flag).
    """

    def __init__(self, fields: Sequence[FeatureField],
                 dist_algorithm: Optional[str] = None,
                 entity_name: Optional[str] = None):
        self.fields: List[FeatureField] = sorted(fields, key=lambda f: f.ordinal)
        self._by_ordinal = {f.ordinal: f for f in self.fields}
        self.dist_algorithm = dist_algorithm
        self.entity_name = entity_name

    # --------------------------------------------------------------- loading
    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FeatureSchema":
        """Accepts both the plain FeatureSchema layout ({"fields": [...]},
        resource/churn.json) and the sifarish rich-attribute wrapper
        ({"distAlgorithm", "entity": {"name", "fields"}},
        resource/elearnActivity.json consumed at knn.sh:46)."""
        if "fields" in obj:
            return cls([FeatureField.from_json(f) for f in obj["fields"]])
        if "entity" in obj:
            ent = obj["entity"]
            return cls([FeatureField.from_json(f) for f in ent["fields"]],
                       dist_algorithm=obj.get("distAlgorithm"),
                       entity_name=ent.get("name"))
        raise ValueError("schema JSON has neither 'fields' nor 'entity'")

    @classmethod
    def from_file(cls, path: str) -> "FeatureSchema":
        with open(path, "r") as fh:
            return cls.from_json(json.load(fh))

    def to_json(self) -> Dict[str, Any]:
        return {"fields": [f.to_json() for f in self.fields]}

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=2)

    # --------------------------------------------------------------- lookups
    def field_by_ordinal(self, ordinal: int) -> FeatureField:
        return self._by_ordinal[ordinal]

    @property
    def id_field(self) -> Optional[FeatureField]:
        for f in self.fields:
            if f.id_field:
                return f
        return None

    @property
    def feature_fields(self) -> List[FeatureField]:
        """Fields in the feature role. When no field carries an explicit
        `feature` flag (the sifarish rich schemas, e.g. elearnActivity.json,
        mark only id/class roles), every non-id, non-class field is
        implicitly a feature — the convention SameTypeSimilarity applies."""
        explicit = [f for f in self.fields if f.feature]
        if explicit:
            return explicit
        cf = self.class_field
        cls_ord = cf.ordinal if cf is not None else -1
        return [f for f in self.fields
                if not f.id_field and not f.class_attr
                and f.ordinal != cls_ord]

    @property
    def class_field(self) -> Optional[FeatureField]:
        explicit = [f for f in self.fields if f.class_attr]
        if explicit:
            return explicit[-1]
        # reference convention: trailing categorical non-feature non-id field
        for f in reversed(self.fields):
            if f.is_categorical and not f.feature and not f.id_field:
                return f
        return None

    def class_values(self) -> List[str]:
        cf = self.class_field
        return list(cf.cardinality) if cf is not None else []

    def num_classes(self) -> int:
        return len(self.class_values())

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __repr__(self) -> str:
        return f"FeatureSchema({[f.name for f in self.fields]})"
