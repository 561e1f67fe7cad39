"""Streaming reinforcement learners: the Storm/Redis layer rebuilt.

Reference (SURVEY §2.7): org/avenir/reinforce/ — an abstract
ReinforcementLearner (batch-of-actions select + reward intake,
ReinforcementLearner.java:35-166) with ten concrete learners created by
name via ReinforcementLearnerFactory.java:35-63, driven per event by a
Storm bolt that pulls queued rewards and writes selected actions to Redis
(ReinforcementLearnerBolt.java:93-125, RedisSpout.java:86-100).

This module keeps the exact learner hierarchy, factory names, and config
keys, as in-process state machines:

  intervalEstimator        histogram upper-confidence bound with decaying
                           confidence limit (IntervalEstimatorLearner.java:80-127)
  sampsonSampler           Thompson sampling by bootstrap from observed
                           rewards (SampsonSamplerLearner.java)
  optimisticSampsonSampler sampled reward floored at the action mean
  randomGreedy             ε-greedy with none/linear/logLinear ε decay
  upperConfidenceBoundOne  UCB1: avg + sqrt(2 ln t / n)
  upperConfidenceBoundTwo  UCB2 epochs: avg + sqrt((1+α)ln(e t/τ)/2τ)
  softMax                  Boltzmann with linear/logLinear temp decay
  actionPursuit            probability pursuit of the best action
  rewardComparison         preference vs drifting reference reward
  exponentialWeight        EXP3

The port's own copy of `avenir_tpu/models/reinforce.py`, unchanged in
behaviour: the same seed and the same reward stream give the same actions,
and `save_state` writes the same bytes, as the JAX package's learners.

Design note: a streaming learner advances one event at a time over O(A)
scalars, so a device dispatch would cost more than the math and the
per-event path stays host numpy (`np.random.default_rng(seed)`). The
N-proportional twin, one round over many groups, is the device-vectorized
set in avenir_tpu_torch.models.bandits; GroupedLearners below fans a
shared-config learner per group the way ReinforcementLearnerGroup.java:30
does, and the streaming loop in avenir_tpu_torch.streaming replaces the
Storm topology with an async host loop.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


class Action:
    """Action with trial/reward bookkeeping (reinforce/Action.java:24)."""

    def __init__(self, action_id: str):
        self.id = action_id
        self.trial_count = 0
        self.total_reward = 0

    def select(self) -> None:
        self.trial_count += 1

    def reward(self, r: int) -> None:
        self.total_reward += r

    def __repr__(self) -> str:
        return f"Action({self.id}, trials={self.trial_count})"


class _Stat:
    """Running count/sum/avg (chombo SimpleStat role)."""

    __slots__ = ("count", "total")

    def __init__(self):
        self.count = 0
        self.total = 0.0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class ReinforcementLearner:
    """Base: action set, batch select, min-trial forcing, reward intake
    (ReinforcementLearner.java:35-166)."""

    def __init__(self, action_ids: Sequence[str], config: Dict):
        self.actions = [Action(a) for a in action_ids]
        self.action_index = {a.id: i for i, a in enumerate(self.actions)}
        self.min_trial = int(config.get("min.trial", -1))
        self.batch_size = int(config.get("batch.size", 1))
        self.reward_scale = int(config.get("reward.scale", 1))
        self.total_trial_count = 0
        self.reward_stats: Dict[str, _Stat] = {}
        self.rewarded = False
        self.rng = np.random.default_rng(int(config.get("seed", 0)))

    # ----------------------------------------------------------- selection
    def next_actions(self) -> List[Action]:
        return [self.next_action() for _ in range(self.batch_size)]

    def next_action(self) -> Action:
        raise NotImplementedError

    def set_reward(self, action_id: str, reward: int) -> None:
        raise NotImplementedError

    def get_stat(self) -> str:
        return ""

    # ------------------------------------------------------------- helpers
    def find_action(self, action_id: str) -> Action:
        return self.actions[self.action_index[action_id]]

    def find_action_with_min_trial(self) -> Action:
        return min(self.actions, key=lambda a: a.trial_count)

    def select_action_based_on_min_trial(self) -> Optional[Action]:
        """Force round-robin until every action has min.trial trials
        (ReinforcementLearner.selectActionBasedOnMinTrial)."""
        if self.min_trial > 0:
            a = self.find_action_with_min_trial()
            if a.trial_count <= self.min_trial:
                return a
        return None

    def find_best_action(self) -> Action:
        best, best_r = self.actions[0], -1.0
        for a in self.actions:
            st = self.reward_stats.get(a.id)
            if st is not None and st.avg > best_r:
                best, best_r = a, st.avg
        return best

    def _random_action(self) -> Action:
        return self.actions[int(self.rng.integers(len(self.actions)))]

    # ----------------------------------------------------- checkpoint state
    _STATE_SKIP = {"actions", "action_index", "reward_stats", "rng", "config"}

    @staticmethod
    def _encode_state(v):
        """JSON-safe recursive encoding: numpy scalars coerce to Python,
        and int dict keys (histogram bins — possibly np.int64 from reward
        arithmetic) get an explicit marker so decode restores them as ints,
        not the strings JSON would silently make them."""
        enc_one = ReinforcementLearner._encode_state
        if isinstance(v, dict):
            enc = {str(k): enc_one(x) for k, x in v.items()}
            if v and all(isinstance(k, (int, np.integer))
                         and not isinstance(k, bool) for k in v):
                return {"__intkeys__": enc}
            return enc
        if isinstance(v, (list, tuple)):
            return [enc_one(x) for x in v]
        if isinstance(v, np.integer):
            return int(v)
        if isinstance(v, np.floating):
            return float(v)
        if isinstance(v, np.bool_):
            return bool(v)
        return v

    @staticmethod
    def _decode_state(v):
        if isinstance(v, dict):
            if set(v) == {"__intkeys__"}:
                return {int(k): ReinforcementLearner._decode_state(x)
                        for k, x in v["__intkeys__"].items()}
            if set(v) == {"__ndarray__", "dtype"}:
                return np.asarray(v["__ndarray__"], dtype=v["dtype"])
            return {k: ReinforcementLearner._decode_state(x)
                    for k, x in v.items()}
        if isinstance(v, list):
            return [ReinforcementLearner._decode_state(x) for x in v]
        return v

    def save_state(self, path: str) -> None:
        """Checkpoint the learner to JSON: per-action trial/reward counts,
        reward stats, and every numeric attribute of the concrete learner
        (weights, preferences, decayed epsilons, ...). The reference keeps
        this state only inside the Storm bolt's JVM (SURVEY §5 — Redis
        holds queues, not models); a file checkpoint makes the streaming
        loop resumable."""
        import json

        extra = {}
        for k, v in self.__dict__.items():
            if k in self._STATE_SKIP:
                continue
            if isinstance(v, np.ndarray):
                extra[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            else:
                # anything JSON-representable is state worth carrying:
                # scalars, lists, and the dict-valued evidence the samplers
                # keep (reward_samples, histograms, epoch counts, ...)
                enc = self._encode_state(v)
                try:
                    json.dumps(enc)
                except (TypeError, ValueError):
                    # an incomplete checkpoint must be visible, not silent:
                    # resume would otherwise quietly lose this state
                    warnings.warn(
                        f"checkpoint skipping non-serializable state {k!r} "
                        f"of {type(self).__name__}")
                    continue
                extra[k] = enc
        state = {
            "learner": type(self).__name__,
            "actions": [[a.id, int(a.trial_count), self._encode_state(
                a.total_reward)] for a in self.actions],
            "reward_stats": {aid: [int(st.count), float(st.total)]
                             for aid, st in self.reward_stats.items()},
            "extra": extra,
        }
        # atomic replace: a failed dump must not destroy the previous
        # checkpoint at this path
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, path)

    def load_state(self, path: str) -> "ReinforcementLearner":
        """Restore a checkpoint written by save_state into this (same-type,
        same-action-set) learner."""
        import json

        with open(path) as fh:
            state = json.load(fh)
        if state["learner"] != type(self).__name__:
            raise ValueError(
                f"checkpoint is for {state['learner']}, not {type(self).__name__}")
        by_id = {a[0]: a for a in state["actions"]}
        for a in self.actions:
            if a.id not in by_id:
                raise ValueError(f"checkpoint missing action {a.id!r}")
            _, a.trial_count, a.total_reward = by_id[a.id]
        self.reward_stats = {}
        for aid, (count, total) in state["reward_stats"].items():
            st = _Stat()
            st.count, st.total = count, total
            self.reward_stats[aid] = st
        for k, v in state["extra"].items():
            self.__dict__[k] = self._decode_state(v)
        return self


# ---------------------------------------------------------------------------
# Learners
# ---------------------------------------------------------------------------
class RandomGreedyLearner(ReinforcementLearner):
    """ε-greedy with decaying ε (RandomGreedyLearner.java:31)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.random_selection_prob = float(config.get("random.selection.prob", 0.5))
        self.prob_red_algorithm = config.get("prob.reduction.algorithm", "linear")
        self.prob_reduction_constant = float(config.get("prob.reduction.constant", 1.0))
        self.min_prob = float(config.get("min.prob", -1.0))
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            t = self.total_trial_count
            if self.prob_red_algorithm == "none":
                p = self.random_selection_prob
            elif self.prob_red_algorithm == "linear":
                p = self.random_selection_prob * self.prob_reduction_constant / t
            elif self.prob_red_algorithm == "logLinear":
                p = (self.random_selection_prob * self.prob_reduction_constant
                     * math.log(t) / t) if t > 1 else self.random_selection_prob
            else:
                raise ValueError(
                    f"invalid prob reduction algorithm: {self.prob_red_algorithm}")
            if self.min_prob > 0:
                p = max(p, self.min_prob)
            if self.rng.random() < p:
                action = self._random_action()
            else:
                action = self.find_best_action()
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.find_action(action_id).reward(reward)


class UpperConfidenceBoundOneLearner(ReinforcementLearner):
    """UCB1: avg + sqrt(2 ln t / n); untried actions win immediately
    (UpperConfidenceBoundOneLearner.java:31)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.reward_scale = int(config.get("reward.scale", 100))
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def _score(self, a: Action) -> float:
        if a.trial_count == 0:
            return float("inf")
        return (self.reward_stats[a.id].avg
                + math.sqrt(2.0 * math.log(self.total_trial_count)
                            / a.trial_count))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            action = max(self.actions, key=self._score)
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward / self.reward_scale)
        self.find_action(action_id).reward(reward)


class UpperConfidenceBoundTwoLearner(ReinforcementLearner):
    """UCB2: epoch-committed UCB with τ = (1+α)^epochs
    (UpperConfidenceBoundTwoLearner.java:31)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.reward_scale = int(config.get("reward.scale", 100))
        self.alpha = float(config.get("ucb2.alpha", 0.1))
        self.num_epochs = {a.id: 0 for a in self.actions}
        self.current: Optional[Action] = None
        self.epoch_size = 0
        self.epoch_trial_count = 0
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            if self.current is not None and self.epoch_trial_count < self.epoch_size:
                action = self.current
                self.epoch_trial_count += 1
            else:
                if self.current is not None:
                    self.num_epochs[self.current.id] += 1
                best, best_score = None, -float("inf")
                for a in self.actions:
                    if a.trial_count == 0:
                        score = float("inf")
                    else:
                        tao = (1.0 + self.alpha) ** self.num_epochs[a.id] \
                            if self.num_epochs[a.id] else 1.0
                        bonus = ((1 + self.alpha)
                                 * math.log(math.e * self.total_trial_count / tao)
                                 / (2 * tao))
                        score = self.reward_stats[a.id].avg + math.sqrt(max(bonus, 0.0))
                    if score > best_score:
                        best, best_score = a, score
                action = best
                ec = self.num_epochs[action.id]
                self.epoch_size = max(1, round(
                    (1.0 + self.alpha) ** (ec + 1) - (1.0 + self.alpha) ** ec))
                self.epoch_trial_count = 0
                self.current = action
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward / self.reward_scale)
        self.find_action(action_id).reward(reward)


class SampsonSamplerLearner(ReinforcementLearner):
    """Thompson sampling by bootstrap: sample one observed reward per action
    (uniform prior draw below min.sample.size), argmax
    (SampsonSamplerLearner.java:33)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.min_sample_size = int(config.get("min.sample.size", 10))
        self.max_reward = int(config.get("max.reward", 100))
        self.reward_samples: Dict[str, List[int]] = {a.id: [] for a in self.actions}

    def enforce(self, action_id: str, reward: float) -> float:
        return reward

    def next_action(self) -> Action:
        self.total_trial_count += 1
        best_id, best_r = None, -1.0
        for a in self.actions:
            samples = self.reward_samples[a.id]
            if len(samples) > self.min_sample_size:
                r = float(samples[int(self.rng.integers(len(samples)))])
                r = self.enforce(a.id, r)
            else:
                r = self.rng.random() * self.max_reward
            if r > best_r:
                best_id, best_r = a.id, r
        action = self.find_action(best_id)
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_samples[action_id].append(reward)
        self.find_action(action_id).reward(reward)


class OptimisticSampsonSamplerLearner(SampsonSamplerLearner):
    """Sampled reward floored at the action's mean
    (OptimisticSampsonSamplerLearner.java:30)."""

    def enforce(self, action_id: str, reward: float) -> float:
        samples = self.reward_samples[action_id]
        mean = sum(samples) / len(samples) if samples else 0.0
        return max(reward, mean)


class IntervalEstimatorLearner(ReinforcementLearner):
    """Histogram upper-confidence-bound with a decaying confidence limit
    (IntervalEstimatorLearner.java:80-127): random until every action has
    min.reward.distr.sample observations, then pick the max upper percentile
    bound at the current confidence limit; the limit steps down every
    confidence.limit.reduction.round.interval trials."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.bin_width = int(config["bin.width"])
        self.confidence_limit = int(config["confidence.limit"])
        self.min_confidence_limit = int(config["min.confidence.limit"])
        self.cur_confidence_limit = self.confidence_limit
        self.reduction_step = int(config["confidence.limit.reduction.step"])
        self.reduction_interval = int(
            config["confidence.limit.reduction.round.interval"])
        self.min_distr_sample = int(config["min.reward.distr.sample"])
        self.histograms: Dict[str, Dict[int, int]] = {
            a.id: {} for a in self.actions}
        self.sample_counts: Dict[str, int] = {a.id: 0 for a in self.actions}
        self.last_round = 1
        self.low_sample = True
        self.random_select_count = 0
        self.intv_est_select_count = 0

    def _upper_bound(self, action_id: str) -> float:
        """Value at the cur_confidence_limit upper percentile of the binned
        reward distribution (chombo HistogramStat.getConfidenceBounds role)."""
        hist = self.histograms[action_id]
        total = self.sample_counts[action_id]
        if total == 0:
            return 0.0
        upper_pct = (100.0 + self.cur_confidence_limit) / 2.0
        target = total * upper_pct / 100.0
        cum = 0
        for b in sorted(hist):
            cum += hist[b]
            if cum >= target:
                return (b + 1) * self.bin_width
        return (max(hist) + 1) * self.bin_width

    def _adjust_conf_limit(self) -> None:
        if self.cur_confidence_limit > self.min_confidence_limit:
            red_step = (self.total_trial_count - self.last_round) \
                // self.reduction_interval
            if red_step > 0:
                self.cur_confidence_limit = max(
                    self.cur_confidence_limit - red_step * self.reduction_step,
                    self.min_confidence_limit)
                self.last_round = self.total_trial_count

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.low_sample:
            self.low_sample = any(
                self.sample_counts[a.id] < self.min_distr_sample
                for a in self.actions)
            if not self.low_sample:
                self.last_round = self.total_trial_count
        if self.low_sample:
            action = self._random_action()
            self.random_select_count += 1
        else:
            self._adjust_conf_limit()
            action = max(self.actions, key=lambda a: self._upper_bound(a.id))
            self.intv_est_select_count += 1
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        if action_id not in self.histograms:
            raise ValueError(f"invalid action: {action_id}")
        b = reward // self.bin_width
        self.histograms[action_id][b] = self.histograms[action_id].get(b, 0) + 1
        self.sample_counts[action_id] += 1
        self.find_action(action_id).reward(reward)

    def get_stat(self) -> str:
        return (f"randomSelectCount:{self.random_select_count} "
                f"intvEstSelectCount:{self.intv_est_select_count}")


class SoftMaxLearner(ReinforcementLearner):
    """Boltzmann selection with linear/logLinear temperature decay
    (SoftMaxLearner.java:32); distribution recomputed on new reward."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.temp_constant = float(config.get("temp.constant", 100.0))
        self.min_temp_constant = float(config.get("min.temp.constant", -1.0))
        self.temp_red_algorithm = config.get("temp.reduction.algorithm", "linear")
        self.probs = np.full(len(self.actions), 1.0 / len(self.actions))
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        action = self.select_action_based_on_min_trial()
        if action is None:
            if self.rewarded:
                avg = np.array([self.reward_stats[a.id].avg for a in self.actions])
                # temp underflows to 0 under the compounding decay schedule;
                # the zero-temperature limit is argmax selection, not NaN
                t = max(self.temp_constant, 1e-12)
                e = np.exp((avg - avg.max()) / t)
                self.probs = e / e.sum()
                self.rewarded = False
            action = self.actions[
                int(self.rng.choice(len(self.actions), p=self.probs))]
            soft_max_round = self.total_trial_count - max(self.min_trial, 0)
            if soft_max_round > 1:
                if self.temp_red_algorithm == "linear":
                    self.temp_constant /= soft_max_round
                elif self.temp_red_algorithm == "logLinear":
                    self.temp_constant *= math.log(soft_max_round) / soft_max_round
                if 0 < self.min_temp_constant and \
                        self.temp_constant < self.min_temp_constant:
                    self.temp_constant = self.min_temp_constant
                self.temp_constant = max(self.temp_constant, 0.0)
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.find_action(action_id).reward(reward)
        self.rewarded = True


class ActionPursuitLearner(ReinforcementLearner):
    """Pursuit: shift selection probability toward the best-avg action
    (ActionPursuitLearner.java:32)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.learning_rate = float(config.get("pursuit.learning.rate", 0.05))
        self.probs = np.full(len(self.actions), 1.0 / len(self.actions))
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            best = self.find_best_action()
            bi = self.action_index[best.id]
            lr = self.learning_rate
            self.probs = self.probs - lr * self.probs
            self.probs[bi] += lr
            self.probs /= self.probs.sum()
            self.rewarded = False
        action = self.actions[
            int(self.rng.choice(len(self.actions), p=self.probs))]
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.reward_stats[action_id].add(reward)
        self.find_action(action_id).reward(reward)
        self.rewarded = True


class RewardComparisonLearner(ReinforcementLearner):
    """Preference learning vs a drifting reference reward
    (RewardComparisonLearner.java:32): on reward, pref += rate*(mean - ref),
    ref += refRate*(mean - ref); selection ∝ exp(pref)."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.preference_change_rate = float(
            config.get("preference.change.rate", 0.01))
        self.ref_reward_change_rate = float(
            config.get("reference.reward.change.rate", 0.01))
        self.ref_reward = float(config.get("intial.reference.reward", 100.0))
        self.prefs = np.zeros(len(self.actions))
        self.probs = np.full(len(self.actions), 1.0 / len(self.actions))
        for a in self.actions:
            self.reward_stats[a.id] = _Stat()

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            e = np.exp(self.prefs - self.prefs.max())
            self.probs = e / e.sum()
            self.rewarded = False
        action = self.actions[
            int(self.rng.choice(len(self.actions), p=self.probs))]
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        st = self.reward_stats[action_id]
        st.add(reward)
        self.find_action(action_id).reward(reward)
        mean = st.avg
        i = self.action_index[action_id]
        self.prefs[i] += self.preference_change_rate * (mean - self.ref_reward)
        self.ref_reward += self.ref_reward_change_rate * (mean - self.ref_reward)
        self.rewarded = True


class ExponentialWeightLearner(ReinforcementLearner):
    """EXP3 (ExponentialWeightLearner.java:32): p = (1-γ)w/Σw + γ/K,
    w *= exp(γ (r/p)/K) on reward. distr.constant is γ ∈ (0, 1]."""

    def __init__(self, action_ids, config):
        super().__init__(action_ids, config)
        self.gamma = float(config.get("distr.constant", 0.1))
        self.weights = np.ones(len(self.actions))
        self.probs = np.full(len(self.actions), 1.0 / len(self.actions))

    def next_action(self) -> Action:
        self.total_trial_count += 1
        if self.rewarded:
            k = len(self.actions)
            w = self.weights / self.weights.sum()
            self.probs = (1.0 - self.gamma) * w + self.gamma / k
            self.probs /= self.probs.sum()
            self.rewarded = False
        action = self.actions[
            int(self.rng.choice(len(self.actions), p=self.probs))]
        action.select()
        return action

    def set_reward(self, action_id: str, reward: int) -> None:
        self.find_action(action_id).reward(reward)
        i = self.action_index[action_id]
        scaled = reward / self.reward_scale
        k = len(self.actions)
        self.weights[i] *= math.exp(
            min(self.gamma * (scaled / max(self.probs[i], 1e-12)) / k, 700.0))
        # renormalize: only weight ratios matter, and unbounded growth
        # overflows to inf/NaN on long streams
        self.weights /= self.weights.max()
        self.rewarded = True


# ---------------------------------------------------------------------------
# Factory + groups
# ---------------------------------------------------------------------------
_LEARNERS: Dict[str, Callable] = {
    "intervalEstimator": IntervalEstimatorLearner,
    "sampsonSampler": SampsonSamplerLearner,
    "optimisticSampsonSampler": OptimisticSampsonSamplerLearner,
    "randomGreedy": RandomGreedyLearner,
    "upperConfidenceBoundOne": UpperConfidenceBoundOneLearner,
    "upperConfidenceBoundTwo": UpperConfidenceBoundTwoLearner,
    "softMax": SoftMaxLearner,
    "actionPursuit": ActionPursuitLearner,
    "rewardComparison": RewardComparisonLearner,
    "exponentialWeight": ExponentialWeightLearner,
}


def create_learner(learner_type: str, action_ids: Sequence[str],
                   config: Dict) -> ReinforcementLearner:
    """ReinforcementLearnerFactory.create (same type names,
    ReinforcementLearnerFactory.java:35-63)."""
    if learner_type not in _LEARNERS:
        raise ValueError(f"invalid learner type: {learner_type}")
    return _LEARNERS[learner_type](action_ids, config)


class GroupedLearners:
    """One learner per group id, shared config
    (ReinforcementLearnerGroup.java:30)."""

    def __init__(self, learner_type: str, action_ids: Sequence[str],
                 config: Dict):
        self.learner_type = learner_type
        self.action_ids = list(action_ids)
        self.config = dict(config)
        self.learners: Dict[str, ReinforcementLearner] = {}

    def get(self, group_id: str) -> ReinforcementLearner:
        if group_id not in self.learners:
            cfg = dict(self.config)
            cfg["seed"] = int(self.config.get("seed", 0)) + len(self.learners)
            self.learners[group_id] = create_learner(
                self.learner_type, self.action_ids, cfg)
        return self.learners[group_id]
