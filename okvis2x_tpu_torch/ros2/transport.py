"""Pluggable pub/sub transport for the ROS2 layer.

Counterpart of ``okvis2x_tpu/ros2/transport.py``: the `Transport` base (a
topic registry with local dispatch to subscribers) and `LocalTransport`, the
in-process loopback with per-topic history that makes the whole
publisher/subscriber stack deterministic and runnable without a ROS
installation (the reference cannot run any of okvis_ros2 without a full
ROS2 stack).  The rclpy backend of the JAX package is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List


class TopicPublisher:
    def __init__(self, transport: "Transport", topic: str):
        self._transport = transport
        self.topic = topic

    def publish(self, msg):
        self._transport._dispatch(self.topic, msg)


class Transport:
    """Base: topic registry + local dispatch to subscribers."""

    def __init__(self):
        self._subs: Dict[str, List[Callable]] = {}
        self._lock = threading.Lock()

    def advertise(self, topic: str, msg_type=None) -> TopicPublisher:
        return TopicPublisher(self, topic)

    def subscribe(self, topic: str, callback: Callable, msg_type=None):
        with self._lock:
            self._subs.setdefault(topic, []).append(callback)

    def _dispatch(self, topic: str, msg):
        with self._lock:
            subs = list(self._subs.get(topic, ()))
        for cb in subs:
            cb(msg)


class LocalTransport(Transport):
    """In-process transport recording full per-topic history."""

    def __init__(self, keep_history: bool = True):
        super().__init__()
        self.keep_history = keep_history
        self.history: Dict[str, List[Any]] = {}

    def _dispatch(self, topic: str, msg):
        if self.keep_history:
            with self._lock:
                self.history.setdefault(topic, []).append(msg)
        super()._dispatch(topic, msg)

    # test helpers ---------------------------------------------------------
    def last(self, topic: str):
        h = self.history.get(topic)
        return h[-1] if h else None

    def count(self, topic: str) -> int:
        return len(self.history.get(topic, ()))
