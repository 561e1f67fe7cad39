"""Straggler detection: from per-block span telemetry to steal and mirror.

The port of `avenir_tpu/dist/detect.py`. Every block a worker folds
records its ``stream.read`` / ``stream.parse`` / ``stream.fold`` spans,
and :func:`avenir_tpu_torch.tune.signals.extract_signals` rolls them into
totals, so a worker knows from its own telemetry how long one block takes
on this host; that number, not a fixed timeout, decides when a peer's
claim has gone stale:

- **Steal** is the cheap move, always on: a worker with no home blocks
  left claims from the global unclaimed tail.
- **Mirror** is the expensive one (redundant work and a rejected
  duplicate commit when the original finishes), so only a claim older
  than ``mirror_multiple`` x the observed per-block wall, floored at
  ``mirror_floor_s`` and capped at ``mirror_cap_s``, is folded again.
  The first-commit-wins ledger makes the duplicate harmless; this policy
  makes it rare.

Pure functions over :class:`RunSignals` and plain numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from avenir_tpu_torch.tune.signals import RunSignals


@dataclass
class StragglerPolicy:
    """The sharded run's straggler knobs — plan-manifest-serializable
    (plain floats) so the coordinator chooses them once and every
    worker applies the same thresholds."""

    #: worker poll granularity while waiting on peers' commits
    poll_s: float = 0.05
    #: mirror a claim older than this multiple of the observed
    #: per-block wall
    mirror_multiple: float = 4.0
    #: ...but never sooner than this (an idle-ish host's scheduling
    #: jitter — or a peer's one-time jit warmup on its first block —
    #: must not trigger redundant work; chaos tests dial it down)
    mirror_floor_s: float = 5.0
    #: hard ceiling on how long an uncommitted claim can gate the run
    #: even when the local per-block estimate is huge
    mirror_cap_s: float = 120.0
    #: once EVERY block is committed, how long the coordinator waits
    #: for straggling workers to exit on their own (recording their
    #: late rejected commits in the dedup counters) before killing
    #: them — a permanently wedged worker must not hold a finished
    #: scan hostage for the run timeout
    exit_grace_s: float = 60.0
    #: False turns redundant re-dispatch off entirely (steal-only)
    mirror: bool = True

    def to_dict(self) -> Dict[str, float]:
        return {"poll_s": self.poll_s,
                "mirror_multiple": self.mirror_multiple,
                "mirror_floor_s": self.mirror_floor_s,
                "mirror_cap_s": self.mirror_cap_s,
                "exit_grace_s": self.exit_grace_s,
                "mirror": float(self.mirror)}

    @classmethod
    def from_dict(cls, obj: Dict) -> "StragglerPolicy":
        base = cls()
        return cls(
            poll_s=float(obj.get("poll_s", base.poll_s)),
            mirror_multiple=float(obj.get("mirror_multiple",
                                          base.mirror_multiple)),
            mirror_floor_s=float(obj.get("mirror_floor_s",
                                         base.mirror_floor_s)),
            mirror_cap_s=float(obj.get("mirror_cap_s", base.mirror_cap_s)),
            exit_grace_s=float(obj.get("exit_grace_s",
                                       base.exit_grace_s)),
            mirror=bool(obj.get("mirror", True)))


def per_block_seconds(sig: RunSignals, blocks_done: int) -> float:
    """Observed wall per folded block from one worker's extracted
    signals: total read+parse+fold seconds over the blocks it has
    finished. 0.0 until the first block lands (no evidence yet)."""
    if blocks_done < 1:
        return 0.0
    return (sig.read_s + sig.parse_s + sig.fold_s) / blocks_done


def mirror_after_s(policy: StragglerPolicy, sig: RunSignals,
                   blocks_done: int) -> float:
    """Claim age past which a peer's uncommitted block is redundantly
    re-dispatched: ``mirror_multiple`` × the telemetry-observed
    per-block wall, clamped to [floor, cap]. With no local evidence yet
    the floor applies — a worker that has folded nothing has no basis
    to call anyone else slow."""
    est = policy.mirror_multiple * per_block_seconds(sig, blocks_done)
    return min(max(est, policy.mirror_floor_s), policy.mirror_cap_s)


def mirror_after_wall_s(policy: StragglerPolicy, wall_s: float,
                        blocks_done: int) -> float:
    """The per-k variant of :func:`mirror_after_s`: the miners' per-k
    count folds replay the encoded-block cache (no ``stream.read`` /
    ``stream.parse`` spans fire), so the worker prices a per-k block
    from its DIRECTLY measured count wall — total seconds over per-k
    blocks it has finished — instead of the span extractor. Same
    multiple, same floor/cap clamp, same no-evidence rule."""
    est = (policy.mirror_multiple * wall_s / blocks_done
           if blocks_done > 0 else 0.0)
    return min(max(est, policy.mirror_floor_s), policy.mirror_cap_s)
