"""Job configuration: flat .properties files with per-job key prefixes.

The port's own copy of the .properties half of `avenir_tpu/core/config.py`.
The reference passes a flat properties file to every job via
`-Dconf.path=...`, and jobs read namespaced keys like `nen.*` plus shared
un-prefixed keys (`field.delim.regex`) — see resource/knn.properties.
`JobConfig` is a job's view of it: typed getters with a job prefix that
fall back to the un-prefixed shared key, and assert-variants that raise a
clear error when a required key is missing.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_KEY_VALUE = re.compile(r"([^=:]+)[=:](.*)")


def load_properties(path: str) -> Dict[str, str]:
    """Parse a java-style .properties file into a dict.

    Supports `#`/`!` comments, `key=value` and `key: value`, trailing
    backslash line continuation, and strips whitespace around keys/values.
    Empty values are kept as empty strings.
    """
    props: Dict[str, str] = {}
    with open(path, "r") as fh:
        pending = ""
        for raw in fh:
            line = pending + raw.rstrip("\n")
            pending = ""
            stripped = line.strip()
            if not stripped or stripped.startswith("#") or stripped.startswith("!"):
                continue
            if stripped.endswith("\\"):
                pending = stripped[:-1]
                continue
            m = _KEY_VALUE.match(stripped)
            if not m:
                continue
            props[m.group(1).strip()] = m.group(2).strip()
    return props


_TRUE = {"true", "yes", "1", "on"}


class MissingConfigError(KeyError):
    """A required configuration key is absent (or empty)."""


class JobConfig:
    """A job's typed view over the flat properties, with a key prefix.

    `get*("top.match.count")` on a JobConfig with prefix "nen" resolves
    `nen.top.match.count`, then the bare `top.match.count`, then the default.
    """

    def __init__(self, props: Dict[str, str], prefix: str = ""):
        self.props = dict(props)
        self.prefix = prefix

    @classmethod
    def from_file(cls, path: str, prefix: str = "") -> "JobConfig":
        return cls(load_properties(path), prefix)

    def scoped(self, prefix: str) -> "JobConfig":
        """Same properties viewed under a different job prefix."""
        return JobConfig(self.props, prefix)

    # ------------------------------------------------------------ raw lookup
    def _lookup(self, key: str) -> Optional[str]:
        if self.prefix:
            val = self.props.get(f"{self.prefix}.{key}")
            if val is not None and val != "":
                return val
        val = self.props.get(key)
        if val is not None and val != "":
            return val
        return None

    # --------------------------------------------------------- typed getters
    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        val = self._lookup(key)
        return val if val is not None else default

    def get_int(self, key: str, default: Optional[int] = None) -> Optional[int]:
        val = self._lookup(key)
        return int(val) if val is not None else default

    def get_float(self, key: str, default: Optional[float] = None) -> Optional[float]:
        val = self._lookup(key)
        return float(val) if val is not None else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._lookup(key)
        return val.lower() in _TRUE if val is not None else default

    def get_list(self, key: str, default: Optional[List[str]] = None,
                 delim: str = ",") -> Optional[List[str]]:
        val = self._lookup(key)
        if val is None:
            return default
        return [tok.strip() for tok in val.split(delim) if tok.strip() != ""]

    def get_int_list(self, key: str, default: Optional[List[int]] = None,
                     delim: str = ",") -> Optional[List[int]]:
        toks = self.get_list(key, None, delim)
        return [int(t) for t in toks] if toks is not None else default

    def get_float_list(self, key: str, default: Optional[List[float]] = None,
                       delim: str = ",") -> Optional[List[float]]:
        toks = self.get_list(key, None, delim)
        return [float(t) for t in toks] if toks is not None else default

    # ------------------------------------------------------ required getters
    def _require(self, key: str, val: Any, what: str) -> Any:
        if val is None:
            full = f"{self.prefix}.{key}" if self.prefix else key
            raise MissingConfigError(f"missing required {what} config param: {full}")
        return val

    def assert_get(self, key: str) -> str:
        return self._require(key, self._lookup(key), "string")

    def assert_int(self, key: str) -> int:
        return int(self._require(key, self._lookup(key), "int"))

    def assert_float(self, key: str) -> float:
        return float(self._require(key, self._lookup(key), "float"))

    def assert_list(self, key: str, delim: str = ",") -> List[str]:
        return self._require(key, self.get_list(key, None, delim), "list")

    # ---------------------------------------------------------- shared keys
    @property
    def field_delim(self) -> str:
        return self.props.get("field.delim", self.props.get("field.delim.out", ","))

    @property
    def field_delim_regex(self) -> str:
        return self.props.get("field.delim.regex",
                              self.props.get("field.delim.in", ","))

    def __repr__(self) -> str:
        return f"JobConfig(prefix={self.prefix!r}, {len(self.props)} keys)"
