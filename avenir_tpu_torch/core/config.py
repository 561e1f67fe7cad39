"""Job configuration: flat .properties files with per-job key prefixes.

The port's own copy of `avenir_tpu/core/config.py`: the .properties
files, and the HOCON subset of the reference's Spark layer (one block a
job, read by `JobConfig.from_hocon`).
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
_HOCON_ENTRY = re.compile(r"([^=:{]+?)\s*[=:]\s*(.*)$")


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


def parse_properties_string(text: str) -> Dict[str, str]:
    props: Dict[str, str] = {}
    for stripped in (ln.strip() for ln in text.splitlines()):
        if not stripped or stripped.startswith("#") or stripped.startswith("!"):
            continue
        m = _KEY_VALUE.match(stripped)
        if m:
            props[m.group(1).strip()] = m.group(2).strip()
    return props


def load_hocon(path: str) -> Dict[str, Dict[str, str]]:
    """Parse the HOCON subset the reference's Spark layer uses
    (resource/atmTrans.conf, sup.conf): one `jobName { ... }` block per
    job, `key = value` / `key: value` entries, `//`/`#` comments, quoted or
    bare scalars, and `[a, "b"]` lists. Nested blocks flatten to dotted
    keys. Values normalize to the .properties string convention — lists
    become comma-joined strings — so a JobConfig over a block behaves
    exactly like one over a properties file."""
    blocks: Dict[str, Dict[str, str]] = {}
    stack: List[str] = []
    with open(path) as fh:
        text = fh.read()
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("//") or line.startswith("#"):
            continue
        if line.endswith("{"):
            stack.append(line[:-1].strip())
            continue
        if line == "}":
            if not stack:
                raise ValueError(f"{path}: unbalanced '}}'")
            stack.pop()
            continue
        m = _HOCON_ENTRY.match(line)
        if not m:
            continue
        key, val = m.group(1).strip(), m.group(2).strip()
        if not stack:
            raise ValueError(f"{path}: top-level entry {key!r} outside a job block")
        dotted = ".".join(stack[1:] + [key])
        blocks.setdefault(stack[0], {})[dotted] = _hocon_value(val)
    if stack:
        raise ValueError(f"{path}: unclosed block {stack[-1]!r}")
    return blocks


def _hocon_value(val: str) -> str:
    val = val.strip()
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        if not inner:
            return ""
        return ",".join(_hocon_value(tok) for tok in inner.split(","))
    if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
        return val[1:-1]
    return val


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

    @classmethod
    def from_hocon(cls, path: str, block: str, prefix: str = "") -> "JobConfig":
        """A job's view of one HOCON job block (the Spark-surface config,
        e.g. resource/atmTrans.conf driving contTimeStateTransitionStats)."""
        blocks = load_hocon(path)
        if block not in blocks:
            raise MissingConfigError(
                f"no block {block!r} in {path} (has: {', '.join(sorted(blocks))})")
        return cls(blocks[block], prefix)

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

    @property
    def debug_on(self) -> bool:
        return self.props.get("debug.on", "false").lower() in _TRUE

    def __repr__(self) -> str:
        return f"JobConfig(prefix={self.prefix!r}, {len(self.props)} keys)"
