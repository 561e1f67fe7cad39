"""Streaming learner loop: the Storm + Redis topology as an async host loop.

Reference (SURVEY §3.5): ReinforcementLearnerTopology.java:42-84 builds a
RedisSpout → shuffleGrouping → ReinforcementLearnerBolt topology; per event
the bolt drains queued rewards into the learner, selects the next action
batch, and pushes (eventID, actions) to a Redis list
(ReinforcementLearnerBolt.java:93-125, RedisActionWriter.java:48,
RedisSpout.java:86-100 rpop of "eventID,roundNum" messages).

Here the topology is a thread + two queues: the event queue feeds
LearnerStream.run(), reward messages interleave exactly as in the bolt
(reward-typed tuples call set_reward directly; event-typed tuples drain the
reward reader first). Reader/writer are small interfaces with in-memory
queue implementations; a Redis pair with the same queue semantics plugs in
when a `redis` client object is handed in (nothing here imports `redis`;
the loop itself never depends on it).

The port's own copy of `avenir_tpu/streaming.py`, unchanged in behaviour.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from avenir_tpu_torch.models.reinforce import Action, create_learner


class RewardReader:
    """RewardReader.java:30 — drain pending (actionID, reward) messages."""

    def read_rewards(self) -> List[Tuple[str, int]]:
        raise NotImplementedError


class ActionWriter:
    """ActionWriter.java:27 — publish selected actions for an event."""

    def write(self, event_id: str, actions: Sequence[Action]) -> None:
        raise NotImplementedError


class QueueRewardReader(RewardReader):
    """In-memory reward queue ("actionID,reward" messages like the Redis
    list payloads, RedisRewardReader.java:46-60)."""

    def __init__(self):
        self.q: "queue.Queue[Tuple[str, int]]" = queue.Queue()

    def push(self, action_id: str, reward: int) -> None:
        self.q.put((action_id, reward))

    def read_rewards(self) -> List[Tuple[str, int]]:
        out = []
        while True:
            try:
                out.append(self.q.get_nowait())
            except queue.Empty:
                return out


class QueueActionWriter(ActionWriter):
    """In-memory action output queue ("eventID,action1,action2,..." payload
    format of RedisActionWriter.java:48-57)."""

    def __init__(self):
        self.q: "queue.Queue[str]" = queue.Queue()

    def write(self, event_id: str, actions: Sequence[Action]) -> None:
        self.q.put(event_id + "," + ",".join(a.id for a in actions))

    def pop(self, timeout: Optional[float] = None) -> Optional[str]:
        try:
            return self.q.get(timeout=timeout)
        except queue.Empty:
            return None


class RedisRewardReader(RewardReader):
    """Redis-list reward reader (RedisRewardReader.java:31). Requires a
    `redis` client object; message format "actionID,reward"."""

    def __init__(self, client, reward_queue: str):
        self.client = client
        self.queue = reward_queue

    def read_rewards(self) -> List[Tuple[str, int]]:
        out = []
        while True:
            msg = self.client.rpop(self.queue)
            if msg is None:
                return out
            if isinstance(msg, bytes):
                msg = msg.decode()
            action_id, reward = msg.split(",")
            out.append((action_id, int(reward)))


class RedisActionWriter(ActionWriter):
    """Redis-list action writer (RedisActionWriter.java:48)."""

    def __init__(self, client, action_queue: str):
        self.client = client
        self.queue = action_queue

    def write(self, event_id: str, actions: Sequence[Action]) -> None:
        self.client.lpush(
            self.queue, event_id + "," + ",".join(a.id for a in actions))


class LearnerStream:
    """The topology: event intake → reward drain → select → action output.

    Synchronous use: process_event() / process_reward() mirror the bolt's
    two tuple types (ReinforcementLearnerBolt.process). Async use: start()
    spawns the loop thread consuming the event queue (the RedisSpout role),
    submit_event() enqueues, stop() joins."""

    #: loop poll granularity: bounds how long the worker blocks on the
    #: event queue before re-checking the shutdown flag, so a lost
    #: sentinel (e.g. consumed by a replay race) can't wedge the thread
    POLL_SECS = 0.2

    def __init__(self, learner_type: str, action_ids: Sequence[str],
                 config: Dict,
                 reward_reader: Optional[RewardReader] = None,
                 action_writer: Optional[ActionWriter] = None,
                 max_replays: int = 3):
        self.learner = create_learner(learner_type, action_ids, config)
        self.reward_reader = reward_reader or QueueRewardReader()
        self.action_writer = action_writer or QueueActionWriter()
        self.events: "queue.Queue[Optional[Tuple[str, int]]]" = queue.Queue()
        self.thread: Optional[threading.Thread] = None
        self.processed = 0
        # Storm ack/replay analog (chombo GenericSpout pendingMsgHolder,
        # RedisSpout.java:39): an event whose processing raises is replayed
        # up to max_replays times, then dropped onto the failed list
        self.max_replays = max_replays
        self.replays: Dict[str, int] = {}
        self.failed: List[Tuple[str, str]] = []   # (event_id, error)
        # guards the caller-visible state the loop thread mutates
        # (processed/replays/failed); the event queue itself is the
        # sanctioned handoff for the tuples
        self._lock = threading.Lock()
        self._stop_requested = threading.Event()

    # ------------------------------------------------------ bolt semantics
    def process_event(self, event_id: str, round_num: int = 0) -> List[Action]:
        for action_id, reward in self.reward_reader.read_rewards():
            self.learner.set_reward(action_id, reward)
        actions = self.learner.next_actions()
        self.action_writer.write(event_id, actions)
        with self._lock:
            self.processed += 1
        return actions

    def process_reward(self, action_id: str, reward: int) -> None:
        self.learner.set_reward(action_id, reward)

    # --------------------------------------------------------- async loop
    def submit_event(self, event_id: str, round_num: int = 0) -> None:
        self.events.put((event_id, round_num))

    def start(self) -> "LearnerStream":
        self._stop_requested = threading.Event()

        def loop():
            while True:
                try:
                    # timeout, not a bare get(): a worker blocked forever
                    # on an empty queue is indistinguishable from a hang,
                    # and a sentinel lost to a replay race would wedge it
                    item = self.events.get(timeout=self.POLL_SECS)
                except queue.Empty:
                    if self._stop_requested.is_set():
                        return
                    continue
                if item is None:
                    # a replayed tuple may have been re-enqueued behind
                    # the stop sentinel: drop the sentinel and keep
                    # draining (NEVER re-enqueue it — two stop() calls
                    # would leave two sentinels ping-ponging forever);
                    # once the queue is quiet the poll timeout sees the
                    # stop flag and exits
                    if self.events.empty():
                        return
                    continue
                try:
                    self.process_event(*item)
                    with self._lock:
                        self.replays.pop(item[0], None)    # acked
                except Exception as exc:
                    with self._lock:
                        n = self.replays.get(item[0], 0) + 1
                        self.replays[item[0]] = n
                    if n <= self.max_replays:
                        self.events.put(item)          # Storm tuple replay
                    else:
                        # clear the counter: a future submission of the same
                        # event id starts with a fresh replay budget
                        with self._lock:
                            self.replays.pop(item[0], None)
                            self.failed.append((item[0], repr(exc)))

        self.thread = threading.Thread(target=loop, daemon=True)
        self.thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Signal shutdown (flag + sentinel), join the loop thread, and
        VERIFY it exited: a worker still alive after `timeout` is wedged
        (e.g. inside a learner call) and raises instead of silently
        truncating the stream on return."""
        if self.thread is None:
            return
        self._stop_requested.set()
        self.events.put(None)
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError(
                f"LearnerStream worker failed to stop within {timeout}s "
                f"(wedged inside process_event?); events pending: "
                f"~{self.events.qsize()}")
        self.thread = None
