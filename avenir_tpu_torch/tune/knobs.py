"""The knob registry: every conf key the autotuner may move, with its
safe range and the telemetry signal that drives it.

The port's copy of `avenir_tpu/tune/knobs.py`: the same four keys, kinds,
defaults, ranges and `KnobError` texts, so that a profile written by
either package loads in the other and the CLI and the job server surface
the same errors. A knob not listed here can never be written by a
policy, and a tuned profile naming an unknown or out-of-range key fails
at load (:func:`validate_knobs` raises :class:`KnobError`) instead of
running defaults.

Ranges are safety ranges, not search ranges: the streamed folds are
chunk-invariant (the same bytes at any block size, prefetch depth or
checkpoint interval), so any value in range changes speed, never the
artifact. The clamp keeps a pathological signal from picking an
inadmissible value.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Union

Number = Union[int, float]


class KnobError(ValueError):
    """A tuned profile (or autotune conf) names an unknown knob key or
    an out-of-range/uncoercible value. Deliberately loud: the silent
    alternative is a typo'd key that "tunes" nothing while the operator
    believes it does."""


@dataclass(frozen=True)
class Knob:
    """One tunable conf key: its type, default, safe range, and the
    telemetry signal the policy engine derives its moves from."""

    key: str
    kind: str                 # "int" | "float"
    default: float
    lo: float
    hi: float
    signal: str               # the driving telemetry, for explain/docs
    description: str

    def coerce(self, value) -> Number:
        """`value` as this knob's type, clamped INTO [lo, hi] is NOT
        done here — validation rejects out-of-range instead (a profile
        holding an out-of-range value was written by a buggy policy or
        by hand; clamping would hide that)."""
        try:
            out = float(value)
        except (TypeError, ValueError) as e:
            raise KnobError(
                f"knob {self.key!r}: value {value!r} is not numeric") from e
        if not self.lo <= out <= self.hi:
            raise KnobError(
                f"knob {self.key!r}: value {out!r} outside the safe "
                f"range [{self.lo:g}, {self.hi:g}]")
        return int(out) if self.kind == "int" else out

    def clamp(self, value: float) -> Number:
        """`value` clamped into the safe range (the POLICY side: every
        chosen move passes through here, so a policy bug can at worst
        pick a slow value, never an invalid one)."""
        out = min(max(float(value), self.lo), self.hi)
        return int(out) if self.kind == "int" else out


#: every key the autotuner may write, by conf key
KNOBS: Dict[str, Knob] = {k.key: k for k in (
    Knob("stream.block.size.mb", "float", 64.0, 1.0, 256.0,
         "stream.read/stream.parse vs per-sink stream.fold span balance, "
         "chunk count, chunk_latency_ms",
         "byte-block size of every streamed scan: larger amortizes "
         "read/parse overhead, smaller gives the producer/consumer "
         "pipeline finer overlap"),
    Knob("stream.prefetch.depth", "int", 2.0, 1.0, 8.0,
         "producer-bound stall share (stream.stall.consumer spans: the "
         "consumer waited on an empty queue)",
         "how many produced chunks may queue ahead of the consumer in "
         "every prefetched() feed"),
    Knob("stream.checkpoint.interval.mb", "float", 256.0, 32.0, 4096.0,
         "job.checkpoint span share of wall clock",
         "bytes folded between incremental fold-state checkpoints: "
         "longer intervals spend less wall on serialization, shorter "
         "ones replay less after a kill"),
    Knob("stream.encoded.cache.budget.mb", "float", 1024.0, 64.0, 8192.0,
         "Cache:EvictedBytes / Cache:SpillBytes counters",
         "byte budget of the miners' encoded-block spill cache: big "
         "enough that per-k replays never re-parse, small enough that "
         "a tenant's spill stays bounded"),
)}

#: autotune CONTROL keys (valid conf surface, never themselves tuned)
CONTROL_KEYS = frozenset({
    "stream.autotune",                      # bool: enable the loop
    "stream.autotune.dir",                  # profile-store directory
    "stream.autotune.batch.balance.ratio",  # server batch-balance band
})


def knob_keys() -> list:
    return sorted(KNOBS)


def knob_defaults() -> Dict[str, Number]:
    return {k.key: (int(k.default) if k.kind == "int" else k.default)
            for k in KNOBS.values()}


def validate_knobs(mapping: Mapping[str, object],
                   source: str = "profile") -> Dict[str, Number]:
    """Validate a {conf key: value} mapping against the registry:
    unknown keys and out-of-range/uncoercible values raise
    :class:`KnobError` naming `source` (the profile path, usually).
    Returns the coerced mapping."""
    out: Dict[str, Number] = {}
    for key in sorted(mapping):
        knob = KNOBS.get(key)
        if knob is None:
            raise KnobError(
                f"{source}: unknown knob key {key!r}; tunable keys: "
                f"{', '.join(knob_keys())}")
        out[key] = knob.coerce(mapping[key])
    return out


def format_value(key: str, value: Number) -> str:
    """The .properties string form of a knob value (what the runner
    splices into a JobConfig): ints bare, floats via %g so a tuned
    profile round-trips through the flat string props unchanged."""
    knob = KNOBS[key]
    return str(int(value)) if knob.kind == "int" else f"{float(value):g}"
