"""Batch multi-armed bandits: the MR bandit jobs, vectorized over groups.

The port of `avenir_tpu/models/bandits.py`. The reference's batch side of
org/avenir/reinforce/ is a set of map-only MR jobs run once a decision
round by a driver loop (resource/price_optimize_tutorial.txt:20-82):
rows (groupID, itemID, trialCount, avgReward) in, `batch_size` items a
group out:

- GreedyRandomBandit.java:148-310: epsilon-greedy, the exploration
  probability decayed linearly (prob*c/count) or log-linearly
  (prob*c*ln(count)/count) in the trial count (round-1)*batch + i + 1 of
  position i, held to [min_prob, prob]; "auerGreedy" scales epsilon by
  the squared relative gap of the two best rewards;
- AuerDeterministic.java:130-175: UCB1, untried items first;
- RandomFirstGreedyBandit.java:55-120: exploration for the first rounds,
  then greedy by rank;
- SoftMaxBandit.java:82-187: Boltzmann draws with a temperature.

A round over all groups is a few torch ops on padded [G, A] tensors
(counts, rewards, validity mask) on `device`; the randomness is the
port's own copy of JAX's threefry (`ops.prng`), so every draw takes the
reference's bits: each job starts from PRNGKey(seed) and splits its key
once a select. `jax.lax.top_k` ranks ties lower index first (untried
items all score +inf): the port ranks by a stable descending sort.

What may differ from the reference: a decision that hangs on a float32
`log` (the gumbel noise of a random draw, UCB1's log t, the logLinear
epsilon), which XLA, PyTorch's CPU build and the card each round their
own way. `tools.bandit_check.near_tie_groups` finds the groups where
such a decision lies within 2 float32 ULP, recomputed in float64; only
there may selections differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from avenir_tpu_torch.ops import prng
from avenir_tpu_torch.utils.devices import DeviceLike, resolve_device

NEG = -1e30


# --------------------------------------------------------------------------
# Group-padded round state (the reward-aggregate file between rounds)
# --------------------------------------------------------------------------
@dataclass
class GroupBanditData:
    """Padded per-group item stats: the round's input and output."""
    group_ids: List[str]
    item_ids: List[List[str]]       # a group's items, in row order
    counts: np.ndarray              # int32 [G, A] trial counts (padded 0)
    rewards: np.ndarray             # float32 [G, A] mean rewards (padded 0)
    mask: np.ndarray                # bool [G, A] valid item slots

    @classmethod
    def from_rows(cls, rows: Iterable[Sequence[str]],
                  count_ord: int = 2, reward_ord: int = 3
                  ) -> "GroupBanditData":
        """Rows of (groupID, itemID, trialCount, avgReward) fields (the
        four read are stripped of white space), a group's rows contiguous
        or not; groups in order of first appearance."""
        rows = list(rows)
        return cls.from_columns([r[0] for r in rows], [r[1] for r in rows],
                                [r[count_ord] for r in rows],
                                [r[reward_ord] for r in rows])

    @classmethod
    def from_lines(cls, lines: Iterable[str], delim: str = ",",
                   count_ord: int = 2, reward_ord: int = 3
                   ) -> "GroupBanditData":
        """from_rows over text lines split on `delim`, a column at a time:
        every field goes into one flat array, so no list a row is kept (a
        million live lists are what Python's cyclic collector would walk
        again and again). A row too short for a field read raises
        IndexError, as from_rows does."""
        lines = list(lines)
        n = len(lines)
        # str.split and str.count both take the non-overlapping matches
        # from the left: a line has count + 1 fields
        nf = np.fromiter((ln.count(delim) for ln in lines), np.int64, n) + 1
        need = max(1, count_ord, reward_ord)
        if n and int(nf.min()) <= need:
            i = int(np.argmax(nf <= need))
            raise IndexError(f"stats row {i} has {int(nf[i])} fields; "
                             f"field {need} is read")
        flat = np.fromiter(chain.from_iterable(ln.split(delim)
                                               for ln in lines),
                           object, int(nf.sum()))
        starts = np.cumsum(nf) - nf
        return cls.from_columns(*(flat[starts + o] for o in
                                  (0, 1, count_ord, reward_ord)))

    @classmethod
    def from_columns(cls, group_col: Sequence[str], item_col: Sequence[str],
                     count_col: Sequence[str], reward_col: Sequence[str]
                     ) -> "GroupBanditData":
        """from_rows from its four columns of fields, one a row."""
        n = len(group_col)
        index: Dict[str, int] = {}
        gi = np.fromiter((index.setdefault(g.strip(), len(index))
                          for g in group_col), np.int64, n)
        cnt = np.fromiter(map(int, count_col), np.int64, n)
        rew = np.fromiter(map(float, reward_col), np.float64, n)
        items = np.array([it.strip() for it in item_col] or [""],
                         dtype=object)
        gn = len(index)
        sizes = np.bincount(gi, minlength=gn)
        a = int(sizes.max(initial=0))
        # each row's slot: its rank among its group's rows, in row order
        by_group = np.argsort(gi, kind="stable")
        starts = np.cumsum(sizes) - sizes
        pos = np.empty(n, np.int64)
        pos[by_group] = np.arange(n) - np.repeat(starts, sizes)
        counts = np.zeros((gn, a), np.int32)
        rewards = np.zeros((gn, a), np.float32)
        mask = np.zeros((gn, a), bool)
        counts[gi, pos] = cnt
        rewards[gi, pos] = rew
        mask[gi, pos] = True
        item_ids = [list(part) for part in
                    np.split(items[by_group], np.cumsum(sizes)[:-1])] \
            if gn else []
        return cls(list(index), item_ids, counts, rewards, mask)

    def tensors(self, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(counts, rewards, mask) on `device` (no copy for stats that are
        there already)."""
        return tuple(torch.as_tensor(x).to(device)
                     for x in (self.counts, self.rewards, self.mask))

    def to_device(self, device: DeviceLike = None) -> "GroupBanditData":
        """A copy whose stats are tensors on `device`, so that a select
        uploads nothing (the reference's `to_device`); the ids stay on
        the host."""
        counts, rewards, mask = self.tensors(resolve_device(device))
        return GroupBanditData(self.group_ids, self.item_ids, counts,
                               rewards, mask)

    def write_selections(self, sel: np.ndarray, fh, delim: str = ",",
                         output_decision_count: bool = False) -> int:
        """Write [G, B] selected indices as the reference's round output
        rows (GreedyRandomBandit.java:148-203); returns the rows written.
        A numpy decode when every group has as many items, else
        selections_to_rows."""
        rect = (isinstance(self.item_ids, np.ndarray)
                and self.item_ids.ndim == 2) or \
            len({len(it) for it in self.item_ids}) == 1
        if output_decision_count or not rect:
            rows = self.selections_to_rows(sel, output_decision_count)
            for row in rows:
                fh.write(delim.join(row) + "\n")
            return len(rows)
        ids_arr = np.asarray(self.item_ids)                    # [G, A]
        g_arr = np.char.add(np.asarray(self.group_ids, dtype=str), delim)
        sel = np.asarray(sel)
        picks = ids_arr[np.arange(g_arr.shape[0])[:, None], sel]  # [G, B]
        lines = np.char.add(g_arr[:, None], picks).ravel()
        fh.write("\n".join(lines.tolist()) + "\n")
        return int(lines.shape[0])

    def selections_to_rows(self, sel: np.ndarray,
                           output_decision_count: bool = False
                           ) -> List[List[str]]:
        """[G, B] selected indices -> (group, item) rows a pick, or
        (group, item, count) rows when counting decisions."""
        out: List[List[str]] = []
        for gi, g in enumerate(self.group_ids):
            picks = [self.item_ids[gi][int(ai)] for ai in sel[gi]
                     if int(ai) < len(self.item_ids[gi])]
            if output_decision_count:
                cnt: Dict[str, int] = {}
                for it in picks:
                    cnt[it] = cnt.get(it, 0) + 1
                out.extend([[g, it, str(c)] for it, c in cnt.items()])
            else:
                out.extend([[g, it] for it in picks])
        return out


# --------------------------------------------------------------------------
# Selection math, vectorized over groups
# --------------------------------------------------------------------------
def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on like's device (XLA's float32 operand)."""
    return torch.tensor(np.float32(x), dtype=torch.float32,
                        device=like.device)


def _eps_greedy(key, rewards: torch.Tensor, mask: torch.Tensor,
                round_num: float, base_prob: float, red_const: float,
                min_prob: float, batch_size: int, log_linear: bool,
                unique: bool) -> torch.Tensor:
    """Epsilon-greedy picks [G, B] (GreedyRandomBandit.linearSelect;
    `_eps_greedy_kernel`, bandits.py:142): position i explores with the
    decayed probability at count (round-1)*B + i + 1, a random pick a
    uniform draw over the available slots, a greedy pick the best
    reward; `unique` keeps a batch from repeating an item (a group that
    runs out draws from all its items again)."""
    g = rewards.shape[0]
    rows = torch.arange(g, device=rewards.device)
    taken = torch.zeros_like(mask)
    base, const = _f32(base_prob, rewards), _f32(red_const, rewards)
    picks = []
    for i in range(batch_size):
        key, k1, k2 = prng.split(key, 3)
        count = _f32((round_num - 1.0) * batch_size + i + 1.0, rewards)
        if log_linear:
            p = base * const * torch.log(count) / count
        else:
            p = base * const / count
        p = torch.clamp(p, _f32(min_prob, p), base)
        explore = prng.uniform(k1, (g,), device=rewards.device) < p
        avail = (mask & ~taken) if unique else mask
        avail = torch.where(avail.any(dim=1, keepdim=True), avail, mask)
        rnd = prng.categorical(k2, torch.where(avail, 0.0, NEG), axis=1)
        greedy = torch.argmax(torch.where(avail, rewards, NEG), dim=1)
        pick = torch.where(explore, rnd, greedy)
        taken[rows, pick] = True
        picks.append(pick)
    return torch.stack(picks, dim=1)


def _ranked_batch(score: torch.Tensor, mask: torch.Tensor,
                  batch_size: int) -> torch.Tensor:
    """The top `batch_size` valid indices a group by score, ties lower
    index first (`jax.lax.top_k`'s order, a stable descending sort); a
    group with fewer valid items repeats its ranking (bandits.py:180)."""
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices
    n_valid = torch.clamp(mask.sum(dim=1), min=1)
    cols = torch.arange(batch_size, device=score.device)[None, :] \
        % n_valid[:, None]
    return torch.take_along_dim(idx, cols, dim=1)


def _ucb1(counts: torch.Tensor, rewards: torch.Tensor, mask: torch.Tensor,
          round_num: float, max_reward: float,
          batch_size: int) -> torch.Tensor:
    """UCB1 (AuerDeterministic; bandits.py:192): untried items first
    (+inf), then reward / max_reward + sqrt(2 ln t / n), t = max(round *
    B, 2), in float32."""
    t = torch.clamp(_f32(round_num, rewards) * batch_size, min=2.0)
    n = counts.to(torch.float32)
    radius = torch.sqrt(2.0 * torch.log(t) / torch.clamp(n, min=1.0))
    score = torch.where(n > 0, rewards / _f32(max_reward, rewards) + radius,
                        float("inf"))
    score = torch.where(mask, score, NEG)
    return _ranked_batch(score, mask, batch_size)


def _softmax(key, rewards: torch.Tensor, mask: torch.Tensor, temp: float,
             batch_size: int) -> torch.Tensor:
    """Boltzmann draws [G, B] with replacement, p ∝ exp(reward / temp)
    over the valid items (SoftMaxBandit.java:187; bandits.py:207)."""
    logits = torch.where(mask, rewards / _f32(temp, rewards), NEG)
    return prng.categorical(key, logits[:, None, :], axis=-1,
                            shape=(rewards.shape[0], batch_size))


def _random_explore(key, mask: torch.Tensor, batch_size: int
                    ) -> torch.Tensor:
    """Uniform draws [G, B] over the valid items (bandits.py:217)."""
    logits = torch.where(mask, 0.0, NEG)
    return prng.categorical(key, logits[:, None, :], axis=-1,
                            shape=(mask.shape[0], batch_size))


# --------------------------------------------------------------------------
# Round jobs (the MR job analogs)
# --------------------------------------------------------------------------
class GreedyRandomBandit:
    """Epsilon-greedy round job (GreedyRandomBandit.java:49). The keys:
    random.selection.prob, prob.reduction.constant,
    prob.reduction.algorithm (linear, logLinear or auerGreedy),
    selection.unique, min.prob, auer.greedy.constant."""

    def __init__(self, batch_size: int, random_selection_prob: float = 0.5,
                 prob_reduction_constant: float = 1.0,
                 prob_reduction_algorithm: str = "linear",
                 selection_unique: bool = False, min_prob: float = 0.0,
                 auer_greedy_constant: float = 1.0, seed: int = 0,
                 device: DeviceLike = None):
        self.batch_size = batch_size
        self.prob = random_selection_prob
        self.const = prob_reduction_constant
        self.algo = prob_reduction_algorithm
        self.unique = selection_unique
        self.min_prob = min_prob
        self.auer_const = auer_greedy_constant
        self.key = prng.PRNGKey(seed)
        self.device = resolve_device(device)

    def select(self, data: GroupBanditData, round_num: int) -> np.ndarray:
        self.key, sub = prng.split(self.key)
        counts, rewards, mask = data.tensors(self.device)
        if self.algo in ("linear", "logLinear"):
            picks = _eps_greedy(sub, rewards, mask, float(round_num),
                                self.prob, self.const, self.min_prob,
                                self.batch_size, self.algo == "logLinear",
                                self.unique)
        elif self.algo == "auerGreedy":
            picks = self._auer_greedy(sub, counts, rewards, mask, round_num)
        else:
            raise ValueError(f"unknown prob reduction algorithm {self.algo}")
        return picks.cpu().numpy()

    def _auer_eps(self, rewards: torch.Tensor, mask: torch.Tensor,
                  round_num: int) -> torch.Tensor:
        """float32 [G]: epsilon = c k / (d^2 t), held at 1, from the
        relative gap d of the two best rewards (1 where d <= 0)."""
        r = torch.where(mask, rewards, float("-inf"))
        if r.shape[1] > 1:
            top2 = torch.topk(r, 2, dim=1).values
            best, second = top2[:, 0], top2[:, 1]
        else:
            best = second = r[:, 0]
        tiny = _f32(1e-9, r)
        d = torch.where(best > 0, (best - second) / torch.maximum(best, tiny),
                        _f32(0.0, r))
        kcnt = mask.sum(dim=1).to(torch.float32)
        t = max((round_num - 1) * self.batch_size, 1)
        dm = torch.maximum(d, tiny)
        eps = torch.minimum(_f32(self.auer_const, r) * kcnt / (dm * dm * t),
                            _f32(1.0, r))
        return torch.where(d <= 0, _f32(1.0, r), eps)

    def _auer_greedy(self, key, counts, rewards, mask, round_num: int):
        """AuerGreedy (greedyAuerSelect): untried items first, then by
        reward, each position replaced by a uniform draw with
        probability epsilon (bandits.py:270)."""
        k1, k2 = prng.split(key)
        rnd = _random_explore(k1, mask, self.batch_size)
        greedy_score = torch.where(counts > 0, rewards, float("inf"))
        greedy_score = torch.where(mask, greedy_score, NEG)
        greedy = _ranked_batch(greedy_score, mask, self.batch_size)
        eps = self._auer_eps(rewards, mask, round_num)
        explore = prng.uniform(k2, (mask.shape[0], self.batch_size),
                               device=mask.device) < eps[:, None]
        return torch.where(explore, rnd, greedy)


class AuerDeterministic:
    """UCB1 round job (AuerDeterministic.java:47); max_reward scales the
    mean rewards into [0, 1]."""

    def __init__(self, batch_size: int, max_reward: float = 100.0,
                 device: DeviceLike = None):
        self.batch_size = batch_size
        self.max_reward = max_reward
        self.device = resolve_device(device)

    def select(self, data: GroupBanditData, round_num: int) -> np.ndarray:
        counts, rewards, mask = data.tensors(self.device)
        return _ucb1(counts, rewards, mask, float(round_num),
                     self.max_reward, self.batch_size).cpu().numpy()


class RandomFirstGreedyBandit:
    """Explore first, then greedy (RandomFirstGreedyBandit.java:47): a
    group explores while the round is at most its exploration rounds,
    factor * items ("simple") or the PAC bound 4/d^2 + ln(2k/delta)
    (getExplorationCount, :71-79)."""

    def __init__(self, batch_size: int, expl_count_strategy: str = "simple",
                 exploration_count_factor: int = 2,
                 reward_diff: float = 0.1, prob_diff: float = 0.2,
                 seed: int = 0, device: DeviceLike = None):
        self.batch_size = batch_size
        self.strategy = expl_count_strategy
        self.factor = exploration_count_factor
        self.reward_diff = reward_diff
        self.prob_diff = prob_diff
        self.key = prng.PRNGKey(seed)
        self.device = resolve_device(device)

    def exploration_rounds(self, item_count: int) -> int:
        if self.strategy == "simple":
            return self.factor * item_count
        return int(4.0 / (self.reward_diff ** 2)
                   + np.log(2.0 * item_count / self.prob_diff))

    def explores(self, data: GroupBanditData, round_num: int) -> np.ndarray:
        """bool [G]: the groups still exploring at this round."""
        return np.array([round_num <= self.exploration_rounds(len(items))
                         for items in data.item_ids], bool)

    def select(self, data: GroupBanditData, round_num: int) -> np.ndarray:
        self.key, sub = prng.split(self.key)
        _counts, rewards, mask = data.tensors(self.device)
        rnd = _random_explore(sub, mask, self.batch_size).cpu().numpy()
        greedy = _ranked_batch(torch.where(mask, rewards, NEG), mask,
                               self.batch_size).cpu().numpy()
        return np.where(self.explores(data, round_num)[:, None], rnd, greedy)


class SoftMaxBandit:
    """Boltzmann round job (SoftMaxBandit.java:49)."""

    def __init__(self, batch_size: int, temp_constant: float = 1.0,
                 seed: int = 0, device: DeviceLike = None):
        self.batch_size = batch_size
        self.temp = temp_constant
        self.key = prng.PRNGKey(seed)
        self.device = resolve_device(device)

    def select(self, data: GroupBanditData, round_num: int) -> np.ndarray:
        self.key, sub = prng.split(self.key)
        _counts, rewards, mask = data.tensors(self.device)
        return _softmax(sub, rewards, mask, self.temp,
                        self.batch_size).cpu().numpy()


BANDIT_JOBS = {
    "greedyRandomBandit": GreedyRandomBandit,
    "auerDeterministic": AuerDeterministic,
    "randomFirstGreedyBandit": RandomFirstGreedyBandit,
    "softMaxBandit": SoftMaxBandit,
}


def make_bandit_job(name: str, batch_size: int, **kw):
    """A round job by the reference's job name (bandits.py:371)."""
    if name not in BANDIT_JOBS:
        raise ValueError(f"invalid bandit job: {name}")
    return BANDIT_JOBS[name](batch_size, **kw)
