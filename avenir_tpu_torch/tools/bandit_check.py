"""Where two routes' bandit selections may rightly differ.

A bandit decision that hangs on a float32 `log` (the gumbel noise of a
categorical draw, UCB1's log t, the logLinear epsilon) rounds its own way
under XLA, PyTorch's CPU build and the card. `near_tie_groups` recomputes
those decisions in float64 from the same threefry bits
(`ops.prng`) and names the groups in which one lies within 2 float32 ULP:
the only groups where a selection of `models.bandits` may differ from
another route's. A check of the tests and of `chip_smoke.py`, not part of
the selection path.
"""

from __future__ import annotations

import numpy as np

from avenir_tpu_torch.models.bandits import (NEG, AuerDeterministic,
                                             GroupBanditData,
                                             RandomFirstGreedyBandit,
                                             SoftMaxBandit)
from avenir_tpu_torch.ops import prng


def _near(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| within 2 float32 ULP of the larger magnitude."""
    m = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.abs(a - b) <= 2.0 * np.spacing(m).astype(np.float64)


def _gumbel64(key, shape) -> np.ndarray:
    """The gumbel noise of `key` in float64, from the same float32
    uniforms."""
    u = prng.uniform(key, shape, prng.TINY, 1.0).numpy().astype(np.float64)
    return -np.log(-np.log(u))


def _draw_near_tie(key, logits: np.ndarray, shape) -> np.ndarray:
    """bool [shape]: where a categorical draw's top two scores (float64
    gumbel noise plus the float32 logits) lie within 2 ULP."""
    score = _gumbel64(key, tuple(shape) + (logits.shape[-1],)) + logits
    top2 = -np.sort(-score, axis=-1)[..., :2]
    if top2.shape[-1] < 2:
        return np.zeros(tuple(shape), bool)
    return _near(top2[..., 0], top2[..., 1])


def near_tie_groups(job, data: GroupBanditData, round_num: int,
                    sel: np.ndarray) -> np.ndarray:
    """bool [G]: the groups of `sel` (the [G, B] picks of a select by a
    job like `job`, which has not selected yet) in which a decision that
    takes a float32 log lies within 2 float32 ULP, recomputed in float64:
    the only groups where two routes' selections may differ."""
    g = len(data.group_ids)
    if g == 0:
        return np.zeros(0, bool)
    b = job.batch_size
    mask = np.asarray(data.mask, bool)
    rewards = np.asarray(data.rewards, np.float32)
    logits0 = np.where(mask, np.float32(0.0), np.float32(NEG))
    out = np.zeros(g, bool)
    if isinstance(job, AuerDeterministic):
        t = np.float64(max(np.float32(round_num) * b, 2.0))
        n = np.asarray(data.counts, np.float64)
        score = np.where(n > 0, rewards / np.float32(job.max_reward)
                         + np.sqrt(2.0 * np.log(t) / np.maximum(n, 1.0)),
                         np.inf)
        score = np.sort(np.where(mask, score, NEG), axis=1)[:, ::-1]
        for j in range(min(b + 1, score.shape[1]) - 1):
            a, c = score[:, j], score[:, j + 1]
            out |= np.isfinite(a) & (a != c) & _near(a, c)
        return out
    _key, sub = prng.split(job.key)
    if isinstance(job, SoftMaxBandit):
        logits = np.where(mask, rewards / np.float32(job.temp),
                          np.float32(NEG))
        return _draw_near_tie(sub, logits[:, None, :].astype(np.float64),
                              (g, b)).any(axis=1)
    if isinstance(job, RandomFirstGreedyBandit):
        near = _draw_near_tie(sub, logits0[:, None, :].astype(np.float64),
                              (g, b)).any(axis=1)
        return near & job.explores(data, round_num)
    if job.algo == "auerGreedy":
        k1, _k2 = prng.split(sub)
        return _draw_near_tie(k1, logits0[:, None, :].astype(np.float64),
                              (g, b)).any(axis=1)
    key = sub
    taken = np.zeros_like(mask)
    for i in range(b):
        key, k1, k2 = prng.split(key, 3)
        count = (round_num - 1.0) * b + i + 1.0
        if job.algo == "logLinear":
            p = job.prob * job.const * np.log(count) / count
            p = min(max(p, job.min_prob), job.prob)
            u = prng.uniform(k1, (g,)).numpy().astype(np.float64)
            out |= _near(u, np.full(g, p))
        avail = (mask & ~taken) if job.unique else mask
        avail = np.where(avail.any(axis=1, keepdims=True), avail, mask)
        lg = np.where(avail, 0.0, NEG)
        out |= _draw_near_tie(k2, lg, (g,))
        taken[np.arange(g), sel[:, i]] = True
    return out
