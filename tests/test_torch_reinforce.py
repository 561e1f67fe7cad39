"""The port's streaming learners and learner loop against the JAX package.

`avenir_tpu_torch/models/reinforce.py` and `avenir_tpu_torch/streaming.py`
are host numpy, as the reference's are. For all ten learner types over a
seeded reward stream the port picks the JAX package's learner's action at
every step, and `save_state` writes byte-identical files (each package
loads the other's and goes on picking alike). Then the learner and
stream tests of `tests/test_reinforce.py` mirrored on the port: the
factory, convergence to the best arm, min-trial forcing, batches, the
interval estimator's phases, grouped learners, `LearnerStream`'s sync
cycle, its async loop, failed-event replay and the wedged-stop raise,
and the Redis reader and writer on a fake client.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

from avenir_tpu.models import reinforce as jax_reinforce
from avenir_tpu.streaming import RedisActionWriter as JaxRedisActionWriter
from avenir_tpu_torch.models.reinforce import (Action, GroupedLearners,
                                               create_learner)
from avenir_tpu_torch.streaming import (LearnerStream, QueueActionWriter,
                                        QueueRewardReader, RedisActionWriter,
                                        RedisRewardReader)

ACTIONS = ["a", "b", "c"]
TRUE_MEANS = {"a": 20, "b": 50, "c": 80}   # c is best

BASE_CONFIG = {
    "batch.size": 1, "reward.scale": 100, "seed": 7,
    # intervalEstimator
    "bin.width": 10, "confidence.limit": 90, "min.confidence.limit": 50,
    "confidence.limit.reduction.step": 5,
    "confidence.limit.reduction.round.interval": 50,
    "min.reward.distr.sample": 20,
    # sampsonSampler
    "min.sample.size": 10, "max.reward": 100,
    # randomGreedy
    "random.selection.prob": 0.5, "prob.reduction.algorithm": "linear",
    # softMax
    "temp.constant": 30.0, "min.temp.constant": 1.0,
    # exponentialWeight
    "distr.constant": 0.2,
    # rewardComparison
    "intial.reference.reward": 50.0, "preference.change.rate": 0.1,
    "reference.reward.change.rate": 0.05,
    # actionPursuit
    "pursuit.learning.rate": 0.05,
}

ALL_LEARNERS = [
    "intervalEstimator", "sampsonSampler", "optimisticSampsonSampler",
    "randomGreedy", "upperConfidenceBoundOne", "upperConfidenceBoundTwo",
    "softMax", "actionPursuit", "rewardComparison", "exponentialWeight",
]

#: a bounded wait for every queue read and thread join
WAIT_S = 10.0


def run_bandit_sim(learner, n_rounds=600, seed=0, noise=8.0):
    rng = np.random.default_rng(seed)
    picks = []
    for _ in range(n_rounds):
        action = learner.next_action()
        picks.append(action.id)
        r = int(np.clip(TRUE_MEANS[action.id] + rng.normal(0, noise), 0, 100))
        learner.set_reward(action.id, r)
    return picks


def _lockstep(port, ref, n_rounds, seed, batch=False):
    """Step both learners on one seeded reward stream; the action ids of
    each step, which must agree."""
    rng = np.random.default_rng(seed)
    for step in range(n_rounds):
        if batch:
            got = [a.id for a in port.next_actions()]
            want = [a.id for a in ref.next_actions()]
        else:
            got, want = [port.next_action().id], [ref.next_action().id]
        assert got == want, (step, got, want)
        for aid in got:
            r = int(np.clip(TRUE_MEANS[aid] + rng.normal(0, 8.0), 0, 100))
            port.set_reward(aid, r)
            ref.set_reward(aid, r)


# ------------------------------------------- the port against the JAX package
@pytest.mark.parametrize("name", ALL_LEARNERS)
def test_actions_and_state_files_equal_jax(tmp_path, name):
    """The same seed and reward stream: the same action at every step,
    state files byte-identical, and each package resumes the other's
    checkpoint and goes on picking alike."""
    cfg = dict(BASE_CONFIG, **{"min.trial": 3, "seed": 11})
    port = create_learner(name, ACTIONS, cfg)
    ref = jax_reinforce.create_learner(name, ACTIONS, cfg)
    _lockstep(port, ref, 300, seed=3)
    port.save_state(str(tmp_path / "port.json"))
    ref.save_state(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() \
        == (tmp_path / "jax.json").read_bytes()
    assert port.get_stat() == ref.get_stat()
    # crossed resume: the port loads the JAX file and vice versa; the
    # rng is not state, so both restart it from the seed
    port2 = create_learner(name, ACTIONS, cfg).load_state(
        str(tmp_path / "jax.json"))
    ref2 = jax_reinforce.create_learner(name, ACTIONS, cfg).load_state(
        str(tmp_path / "port.json"))
    _lockstep(port2, ref2, 100, seed=4)
    port2.save_state(str(tmp_path / "port2.json"))
    ref2.save_state(str(tmp_path / "jax2.json"))
    assert (tmp_path / "port2.json").read_bytes() \
        == (tmp_path / "jax2.json").read_bytes()


@pytest.mark.parametrize("name", ["sampsonSampler", "softMax",
                                  "upperConfidenceBoundTwo"])
def test_batches_and_groups_equal_jax(name):
    cfg = dict(BASE_CONFIG, **{"batch.size": 4})
    _lockstep(create_learner(name, ACTIONS, cfg),
              jax_reinforce.create_learner(name, ACTIONS, cfg), 60, seed=5,
              batch=True)
    port = GroupedLearners(name, ACTIONS, BASE_CONFIG)
    ref = jax_reinforce.GroupedLearners(name, ACTIONS, BASE_CONFIG)
    for g in ("g2", "g0", "g1", "g0"):
        _lockstep(port.get(g), ref.get(g), 20, seed=len(port.learners))


def test_redis_pair_on_a_fake_client():
    """The Redis reader and writer take a client object (nothing imports
    `redis`): rpop drains "actionID,reward" messages (bytes or str), and
    lpush publishes "eventID,action,..." as the JAX package's writer
    does."""

    class FakeRedis:
        def __init__(self):
            self.lists = {}

        def lpush(self, key, value):
            self.lists.setdefault(key, []).insert(0, value)

        def rpop(self, key):
            items = self.lists.get(key)
            return items.pop() if items else None

    client = FakeRedis()
    for msg in (b"a,10", "c,90", b"b,55"):
        client.lpush("rewards", msg)
    stream = LearnerStream("randomGreedy", ACTIONS, BASE_CONFIG,
                           reward_reader=RedisRewardReader(client, "rewards"),
                           action_writer=RedisActionWriter(client, "actions"))
    actions = stream.process_event("e1", 1)
    assert client.lists["rewards"] == []
    assert stream.learner.reward_stats["c"].count == 1
    assert stream.learner.find_action("b").total_reward == 55
    assert client.lists["actions"] == ["e1," + ",".join(a.id for a in actions)]
    ref = FakeRedis()
    JaxRedisActionWriter(ref, "actions").write(
        "e1", [jax_reinforce.Action(a.id) for a in actions])
    assert ref.lists == {"actions": client.lists["actions"]}
    assert RedisRewardReader(client, "rewards").read_rewards() == []


# ------------------------------------------------ the learner hierarchy
class TestLearnerHierarchy:
    @pytest.mark.parametrize("name", ALL_LEARNERS)
    def test_factory_creates(self, name):
        lr = create_learner(name, ACTIONS, BASE_CONFIG)
        a = lr.next_action()
        assert a.id in ACTIONS
        lr.set_reward(a.id, 50)

    def test_factory_rejects_unknown(self):
        with pytest.raises(ValueError, match="invalid learner type"):
            create_learner("nope", ACTIONS, BASE_CONFIG)

    @pytest.mark.parametrize("name", ALL_LEARNERS)
    def test_converges_to_best_arm(self, name):
        lr = create_learner(name, ACTIONS, BASE_CONFIG)
        picks = run_bandit_sim(lr, n_rounds=800)
        late = picks[-200:]
        frac_best = late.count("c") / len(late)
        assert frac_best > 0.5, f"{name}: best-arm rate {frac_best}"

    def test_trial_counts_track_selections(self):
        lr = create_learner("randomGreedy", ACTIONS, BASE_CONFIG)
        run_bandit_sim(lr, n_rounds=100)
        assert sum(a.trial_count for a in lr.actions) == 100

    def test_min_trial_forces_exploration(self):
        cfg = dict(BASE_CONFIG, **{"min.trial": 20})
        lr = create_learner("upperConfidenceBoundOne", ACTIONS, cfg)
        run_bandit_sim(lr, n_rounds=100)
        for a in lr.actions:
            assert a.trial_count >= 20

    def test_batch_size(self):
        cfg = dict(BASE_CONFIG, **{"batch.size": 4})
        lr = create_learner("sampsonSampler", ACTIONS, cfg)
        actions = lr.next_actions()
        assert len(actions) == 4
        assert all(isinstance(a, Action) for a in actions)

    def test_interval_estimator_phases(self):
        lr = create_learner("intervalEstimator", ACTIONS, BASE_CONFIG)
        run_bandit_sim(lr, n_rounds=400)
        assert lr.random_select_count > 0      # warmup phase happened
        assert lr.intv_est_select_count > 0    # UCB phase happened
        assert lr.cur_confidence_limit < lr.confidence_limit  # decayed
        assert "randomSelectCount" in lr.get_stat()

    def test_optimistic_sampler_floors_at_mean(self):
        lr = create_learner("optimisticSampsonSampler", ACTIONS, BASE_CONFIG)
        for _ in range(15):
            lr.set_reward("a", 10)
            lr.set_reward("a", 30)
        assert lr.enforce("a", 5.0) == pytest.approx(20.0)  # mean wins
        assert lr.enforce("a", 25.0) == pytest.approx(25.0)  # sample wins

    def test_grouped_learners_independent(self):
        groups = GroupedLearners("randomGreedy", ACTIONS, BASE_CONFIG)
        g1, g2 = groups.get("g1"), groups.get("g2")
        assert g1 is not g2
        assert groups.get("g1") is g1
        g1.set_reward("a", 99)
        assert g2.reward_stats["a"].count == 0

    def test_load_state_refuses_another_learner(self, tmp_path):
        create_learner("softMax", ACTIONS, BASE_CONFIG).save_state(
            str(tmp_path / "s.json"))
        with pytest.raises(ValueError, match="checkpoint is for"):
            create_learner("randomGreedy", ACTIONS, BASE_CONFIG).load_state(
                str(tmp_path / "s.json"))
        with pytest.raises(ValueError, match="missing action"):
            create_learner("softMax", ACTIONS + ["d"], BASE_CONFIG
                           ).load_state(str(tmp_path / "s.json"))
        assert not Path(str(tmp_path / "s.json") + ".tmp").exists()


# --------------------------------------------------------- the learner loop
class TestLearnerStream:
    def test_sync_event_reward_cycle(self):
        stream = LearnerStream("randomGreedy", ACTIONS, BASE_CONFIG)
        actions = stream.process_event("e1", 1)
        assert len(actions) == 1
        out = stream.action_writer.pop(timeout=WAIT_S)
        assert out.startswith("e1,")
        stream.reward_reader.push(actions[0].id, 60)
        stream.process_event("e2", 2)
        assert stream.learner.actions[
            stream.learner.action_index[actions[0].id]].total_reward == 60

    def test_async_loop(self):
        stream = LearnerStream("softMax", ACTIONS, BASE_CONFIG).start()
        rng = np.random.default_rng(1)
        for i in range(50):
            stream.submit_event(f"e{i}", i)
            msg = stream.action_writer.pop(timeout=WAIT_S)
            assert msg is not None
            event_id, *acts = msg.split(",")
            assert event_id == f"e{i}"
            for a in acts:
                r = int(np.clip(TRUE_MEANS[a] + rng.normal(0, 5), 0, 100))
                stream.reward_reader.push(a, r)
        stream.stop(timeout=WAIT_S)
        assert stream.processed == 50

    def test_failed_event_replays_then_drops(self):
        """A tuple whose processing raises is replayed up to max_replays,
        a persistently failing one lands on the failed list, and the loop
        keeps serving subsequent events."""
        stream = LearnerStream("randomGreedy", ACTIONS, BASE_CONFIG,
                               max_replays=2)
        calls = {"n": 0}
        orig = stream.learner.next_actions

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return orig()

        stream.learner.next_actions = flaky
        stream.start()
        stream.submit_event("e1", 1)          # fails once, replays, succeeds
        msg = stream.action_writer.pop(timeout=WAIT_S)
        assert msg is not None and msg.startswith("e1,")
        assert not stream.failed

        stream.learner.next_actions = lambda: (_ for _ in ()).throw(
            RuntimeError("permanent"))
        stream.submit_event("dead", 2)
        deadline = time.time() + WAIT_S
        while not stream.failed and time.time() < deadline:
            time.sleep(0.01)
        assert stream.failed and stream.failed[0][0] == "dead"
        assert "permanent" in stream.failed[0][1]
        stream.learner.next_actions = orig
        stream.submit_event("e2", 3)          # loop still alive after drop
        msg = stream.action_writer.pop(timeout=WAIT_S)
        assert msg is not None and msg.startswith("e2,")
        stream.stop(timeout=WAIT_S)

    def test_reward_tuples_processed_directly(self):
        stream = LearnerStream("upperConfidenceBoundOne", ACTIONS, BASE_CONFIG)
        stream.process_reward("b", 70)
        assert stream.learner.reward_stats["b"].count == 1

    def test_stop_raises_on_wedged_worker(self):
        """stop() verifies the loop thread actually exited: a worker
        wedged inside process_event raises instead of returning as if the
        stream had drained."""
        stream = LearnerStream("randomGreedy", ACTIONS, BASE_CONFIG)
        stream.process_event("warm", 0)
        release = threading.Event()
        orig = stream.learner.next_actions

        def wedge():
            release.wait(WAIT_S)
            return orig()

        stream.learner.next_actions = wedge
        stream.start()
        stream.submit_event("e1", 1)
        deadline = time.time() + 5          # wait until the worker is
        while stream.events.qsize() and time.time() < deadline:
            time.sleep(0.01)                # actually inside the wedge
        with pytest.raises(RuntimeError, match="failed to stop"):
            stream.stop(timeout=0.3)
        release.set()                       # unwedge; stop now succeeds
        stream.stop(timeout=WAIT_S)
        assert stream.thread is None
        assert stream.processed == 2        # warm-up + the wedged event

    def test_stop_verifies_thread_exit_cleanly(self):
        stream = LearnerStream("randomGreedy", ACTIONS, BASE_CONFIG).start()
        stream.submit_event("e1", 1)
        assert stream.action_writer.pop(timeout=WAIT_S) is not None
        stream.stop(timeout=WAIT_S)         # clean drain: no raise
        assert stream.thread is None
        stream.stop()                       # idempotent on a stopped stream

    def test_queue_pair_formats(self):
        reader, writer = QueueRewardReader(), QueueActionWriter()
        reader.push("a", 5)
        reader.push("b", 7)
        assert reader.read_rewards() == [("a", 5), ("b", 7)]
        assert reader.read_rewards() == []
        writer.write("e9", [Action("c"), Action("a")])
        assert writer.pop(timeout=WAIT_S) == "e9,c,a"
        assert writer.pop(timeout=0.01) is None


class TestLearnerLongStreams:
    def test_softmax_survives_temp_underflow(self):
        lr = create_learner(
            "softMax", ACTIONS,
            dict(BASE_CONFIG, **{"min.temp.constant": -1.0}))
        picks = run_bandit_sim(lr, n_rounds=500)
        assert picks[-1] in ACTIONS          # no NaN crash
        assert np.isfinite(lr.probs).all()

    def test_exp3_survives_long_stream(self):
        lr = create_learner(
            "exponentialWeight", ACTIONS,
            dict(BASE_CONFIG, **{"reward.scale": 1}))
        picks = run_bandit_sim(lr, n_rounds=2000)
        assert np.isfinite(lr.weights).all()
        assert np.isfinite(lr.probs).all()
        assert picks[-200:].count("c") / 200 > 0.4
