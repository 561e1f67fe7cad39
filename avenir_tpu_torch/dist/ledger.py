"""Block ledger: filesystem claims and first-commit-wins block states.

The port of `avenir_tpu/dist/ledger.py`. Every stream fold is
non-idempotent (folding a block twice changes the output), so redundant
work (a mirrored straggler) must dedup at block granularity before the
merge. The ledger does it with the same single-writer filesystem
discipline as every atomic publish:

- **Claims** (``claims/b<id>.json``): a worker writes its claim to a tmp
  file and hard-links it into place; ``os.link`` fails with EEXIST when a
  claim exists, so exactly one of N racing workers wins, and since the
  tmp is complete before the link no reader sees a torn claim from this
  path. A claim that is torn anyway (truncated by something else) reads
  as unclaimed: the first worker to notice renames it aside (exactly one
  rename succeeds) and claims again.
- **Commits** (``states/b<id>.npz``): the serialized fold state is the
  commit record, published the same tmp-and-link way. The first commit
  wins; a duplicate commit of the same block id (a mirrored block
  finishing twice, a resumed worker completing work someone re-did) is
  rejected, counted and recorded as a ``dups/`` marker. The coordinator
  merges exactly one state a block id, in plan order.

**Namespaces** (:meth:`BlockLedger.level`): the miners' per-k rounds use
the same discipline once per candidate length: level ``k`` counts block
``b`` under ``ledger/k<k>/b<b>``, so a block claims, commits and dedups
independently a level. Pass 1 is the bare ``ledger/`` root.

No daemon and no lock server: rename and link on one filesystem are the
whole substrate, so the shard root and its tmp files must share one.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

from avenir_tpu_torch.core.atomic import (AFTER_RENAME, BEFORE_RENAME,
                                          crash_point, publish_json,
                                          sched_point, sweep_stale_tmps)
from avenir_tpu_torch.core.keys import key_site

#: ledger record/state layout version. Stamped into every claim and dup
#: record and into a per-states-dir ``states/FORMAT.json`` marker; a
#: marker stamped with a DIFFERENT version makes :meth:`BlockLedger.
#: load_state` / :meth:`BlockLedger.committed` refuse (go cold) — old
#: readers must never silently merge a newer state layout. A MISSING
#: marker is a pre-versioning ledger and still serves.
FORMAT_VERSION = 1

#: per-states-dir layout-version marker file name
STATES_FORMAT = "FORMAT.json"


class BlockLedger:
    """Claim/commit ledger for one sharded run, rooted at
    ``<root>/ledger``. Safe for concurrent use by any number of worker
    processes on one filesystem."""

    def __init__(self, root: str, ns: str = ""):
        self._base = root
        self.ns = ns
        self.root = (os.path.join(root, "ledger", ns) if ns
                     else os.path.join(root, "ledger"))
        self.claims_dir = os.path.join(self.root, "claims")
        self.states_dir = os.path.join(self.root, "states")
        self.dups_dir = os.path.join(self.root, "dups")
        for d in (self.claims_dir, self.states_dir, self.dups_dir):
            os.makedirs(d, exist_ok=True)
        # stamp the states-dir layout version once, first writer wins
        # (deterministic bytes, so racing stampers publish identical
        # content; an existing marker — any version — is left alone)
        marker = os.path.join(self.states_dir, STATES_FORMAT)
        if not os.path.exists(marker):
            publish_json({"format_version": FORMAT_VERSION}, marker,
                         site="ledger.format")
        # startup GC: tmp files a hard-killed worker left behind (the
        # age gate keeps a concurrent writer's live tmp safe)
        sweep_stale_tmps(self.root)

    def level(self, ns: str) -> "BlockLedger":
        """A NAMESPACED sub-ledger under ``ledger/<ns>/`` — the per-k
        rounds' handle (``level("k2")`` scopes block ``b`` at
        ``k2/b<b>``): same first-commit-wins discipline, independent
        claim/commit/dup state per level."""
        if not ns or os.sep in ns or ns != os.path.basename(ns):
            raise ValueError(f"bad ledger namespace {ns!r}")
        return BlockLedger(self._base, ns=ns)

    # ---------------------------------------------------------- claims
    def claim_path(self, block_id: int) -> str:
        return os.path.join(self.claims_dir, f"b{block_id}.json")

    def claim(self, block_id: int, worker: int,
              mirror: bool = False) -> bool:
        """Atomically claim a block; True when THIS call won. ``mirror``
        marks a redundant re-dispatch claim record (informational — a
        mirror does not take the claim, it races the commit; the flag
        only lands in the claim file when the mirrorer claims an
        abandoned, never-claimed block)."""
        path = self.claim_path(block_id)
        tmp = os.path.join(self.claims_dir,
                           f".tmp.b{block_id}.{uuid.uuid4().hex}")
        with open(tmp, "w") as fh:
            json.dump({"format_version": FORMAT_VERSION,
                       "block": block_id, "worker": worker,
                       "claimed_at": time.time(), "mirror": mirror}, fh)
        crash_point("ledger.claim", BEFORE_RENAME)
        try:
            for _ in range(8):
                sched_point("ledger.claim")
                try:
                    os.link(tmp, path)
                    crash_point("ledger.claim", AFTER_RENAME)
                    sched_point("ledger.claim")
                    return True
                except FileExistsError:
                    if self.claim_info(block_id) is not None:
                        return False          # a well-formed claim holds
                    # torn claim: treated as unclaimed. Exactly one
                    # worker wins the rename-aside; the loser re-loads
                    # and either sees the winner's fresh claim or races
                    # the next link round.
                    torn = f"{path}.torn.{uuid.uuid4().hex}"
                    try:
                        os.rename(path, torn)
                    except OSError:
                        pass
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def claim_info(self, block_id: int) -> Optional[Dict]:
        """The claim record, or None when unclaimed OR torn (an
        unparseable claim is by contract not a claim)."""
        try:
            with open(self.claim_path(block_id)) as fh:
                obj = json.load(fh)
            return {"block": int(obj["block"]),
                    "worker": int(obj["worker"]),
                    "claimed_at": float(obj["claimed_at"]),
                    "mirror": bool(obj.get("mirror", False))}
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def claims(self) -> Dict[int, Dict]:
        out: Dict[int, Dict] = {}
        try:
            names = os.listdir(self.claims_dir)
        except OSError:
            return out
        for n in names:
            if not n.startswith("b") or not n.endswith(".json"):
                continue
            try:
                bid = int(n[1:-5])
            except ValueError:
                continue
            info = self.claim_info(bid)
            if info is not None:
                out[bid] = info
        return out

    # --------------------------------------------------------- commits
    def state_path(self, block_id: int) -> str:
        return os.path.join(self.states_dir, f"b{block_id}.npz")

    def fps_path(self, block_id: int) -> str:
        return os.path.join(self.states_dir, f"b{block_id}.fps.json")

    def commit(self, block_id: int, worker: int, blob: bytes,
               fps: Optional[List[Dict]] = None) -> bool:
        """Publish a block's serialized fold state, first commit wins.
        True when this state is the one the coordinator will merge; False
        when the block was already committed: the duplicate is rejected
        (never merged: the fold families are non-idempotent) and recorded
        under ``dups/``.

        ``fps`` (refresh plans) are the fingerprints of the chunks this
        fold consumed; only the winning commit publishes them (a losing
        mirror may have read other bytes), after the state's link. A
        crash between the two leaves a committed block without them,
        which the coordinator takes as the end of its checkpoint's
        extension (the next refresh re-folds from there), never as a
        wrong checkpoint."""
        path = self.state_path(block_id)
        tmp = os.path.join(self.states_dir,
                           f".tmp.b{block_id}.{uuid.uuid4().hex}")
        with open(tmp, "wb") as fh:
            fh.write(blob)
        crash_point("ledger.commit", BEFORE_RENAME)
        try:
            sched_point("ledger.commit")
            os.link(tmp, path)
            crash_point("ledger.commit", AFTER_RENAME)
            sched_point("ledger.commit")
            if fps is not None:
                fptmp = f"{tmp}.fps"
                with open(fptmp, "w") as fh:
                    json.dump(fps, fh)
                os.replace(fptmp, self.fps_path(block_id))
            return True
        except FileExistsError:
            self._mark_dup(block_id, worker)
            return False
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass

    def load_fps(self, block_id: int) -> Optional[List[Dict]]:
        """The winning commit's folded-chunk fingerprints, or None when
        the block committed without them (not a refresh plan, or a crash
        between the state's link and their publish)."""
        try:
            with open(self.fps_path(block_id)) as fh:
                fps = json.load(fh)
            return list(fps) if isinstance(fps, list) else None
        except (OSError, ValueError):
            return None

    def _mark_dup(self, block_id: int, worker: int) -> None:
        """Record one rejected duplicate commit — worker-namespaced so
        concurrent losers never race one file, atomic so the
        coordinator's count never reads a torn marker."""
        path = os.path.join(self.dups_dir, f"b{block_id}.w{worker}.json")
        publish_json({"format_version": FORMAT_VERSION,
                      "block": block_id, "worker": worker,
                      "rejected_at": time.time()}, path,
                     site="ledger.dup")

    def _states_format_ok(self) -> bool:
        """Whether the states dir's layout-version marker matches this
        reader. A missing or torn marker is a pre-versioning ledger and
        still serves; a PRESENT marker with a different version makes
        every state read refuse — merging a newer layout as if it were
        this one is the silent-wrong-answer case the stamp exists for."""
        try:
            with open(os.path.join(self.states_dir, STATES_FORMAT)) as fh:
                marker = json.load(fh)
        except (OSError, ValueError):
            return True
        if not isinstance(marker, dict):
            return True
        return marker.get("format_version",
                          FORMAT_VERSION) == FORMAT_VERSION

    def load_state(self, block_id: int) -> bytes:
        """The winning commit's serialized fold state. The committed
        identity is first-commit-wins per (namespace, block id):
        whichever worker linked ``states/b<id>.npz`` first is the state
        every reader serves — content validity is the link's atomicity
        plus the version marker, never mtime.

        key-covered: all — the path IS the key (ns + block id).
        """
        key_site("ledger.committed")
        if not self._states_format_ok():
            raise ValueError(
                f"ledger states dir {self.states_dir!r}: layout version "
                f"mismatch (reader expects {FORMAT_VERSION}) — refusing "
                f"to serve; start a fresh ledger root")
        with open(self.state_path(block_id), "rb") as fh:
            return fh.read()

    def committed(self) -> List[int]:
        if not self._states_format_ok():
            return []      # version skew: nothing servable, go cold
        try:
            names = os.listdir(self.states_dir)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith("b") and n.endswith(".npz"):
                try:
                    out.append(int(n[1:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def dup_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.dups_dir)
                       if n.endswith(".json"))
        except OSError:
            return 0

    # ------------------------------------------------------- summaries
    def pending(self, n_blocks: int) -> List[int]:
        """Block ids not yet committed."""
        done = set(self.committed())
        return [b for b in range(n_blocks) if b not in done]

    def unclaimed(self, n_blocks: int) -> List[int]:
        """Block ids with neither a (well-formed) claim nor a commit."""
        done = set(self.committed())
        claimed = set(self.claims())
        return [b for b in range(n_blocks)
                if b not in done and b not in claimed]

    def stale_claims(self, n_blocks: int, older_than_s: float,
                     now: Optional[float] = None) -> List[int]:
        """Claimed-but-uncommitted block ids whose claim is older than
        ``older_than_s`` — the straggler detector's candidates for
        redundant re-dispatch, oldest first."""
        now = time.time() if now is None else now
        done = set(self.committed())
        rows = [(info["claimed_at"], bid)
                for bid, info in self.claims().items()
                if bid not in done
                and now - info["claimed_at"] > older_than_s]
        return [bid for _t, bid in sorted(rows)]
