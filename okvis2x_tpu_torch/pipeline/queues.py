"""Bounded thread-safe queues, the frame synchroniser, the threaded runner and
the latest-value publisher.

Counterpart of ``okvis2x_tpu/pipeline/queues.py``, the host-side dataflow of
the reference's orchestration:
  * `Queue` — the reference's `okvis::threadsafe::Queue` semantics
    (okvis_multisensor_processing/include/okvis/threadsafe/
    ThreadsafeQueue.hpp:41-212): blocking/non-blocking push with
    drop-if-full variants, blocking/timeout pop, shutdown;
  * `FrameSynchronizer` — multi-camera timestamp bundling with tolerance
    (≙ okvis's frame synchronisation, tested by FrameSynchronizer_test.cpp:
    missing / double / out-of-order frames);
  * `ThreadedRunner` — a reader thread streaming sensor events through a
    queue into the synchronous pipeline (the `ThreadedSlam` input side);
    device work stays on the consumer thread, the reader thread overlaps
    image decoding and disk reads with it, and the native loader's worker
    pool (``io/native_loader.py``) decodes the images ahead of the reader;
  * `LatestValuePublisher` — the reference's `ThreadedPublisher`.

Host Python and numpy throughout.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional

import numpy as np


class ShutDown(Exception):
    pass


class Queue:
    """Condition-variable MPMC queue with the reference's push/pop variants."""

    def __init__(self, maxsize: int = 0):
        self._dq = collections.deque()
        self._maxsize = maxsize
        self._cv = threading.Condition()
        self._shutdown = False

    def __len__(self):
        with self._cv:
            return len(self._dq)

    def push_blocking_if_full(self, item):
        with self._cv:
            while self._maxsize and len(self._dq) >= self._maxsize:
                if self._shutdown:
                    raise ShutDown
                self._cv.wait(0.1)
            self._dq.append(item)
            self._cv.notify()

    def push_nonblocking(self, item) -> bool:
        with self._cv:
            self._dq.append(item)
            self._cv.notify()
            return True

    def push_nonblocking_dropping_if_full(self, item) -> bool:
        """Returns False if the oldest element was dropped to make room."""
        with self._cv:
            dropped = False
            if self._maxsize and len(self._dq) >= self._maxsize:
                self._dq.popleft()
                dropped = True
            self._dq.append(item)
            self._cv.notify()
            return not dropped

    def _pop(self):
        # wake a push waiting for room (the JAX package's pops do not, so
        # there a full queue's producer sleeps out its 0.1 s wait)
        self._cv.notify_all()
        return self._dq.popleft()

    def pop_blocking(self):
        with self._cv:
            while not self._dq:
                if self._shutdown:
                    raise ShutDown
                self._cv.wait(0.1)
            return self._pop()

    def pop_timeout(self, timeout: float):
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._dq:
                if self._shutdown:
                    raise ShutDown
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            return self._pop()

    def pop_nonblocking(self):
        with self._cv:
            return self._pop() if self._dq else None

    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()


class FrameSynchronizer:
    """Bundle per-camera images into synchronised multi-frames.

    Frames whose timestamps agree within `tolerance` form a bundle; a bundle
    is emitted when complete, or flushed incomplete once a newer bundle
    completes (missing-frame handling).  Duplicate (camera, t) pairs replace
    the previous image; out-of-order arrivals join their bundle by time.
    """

    def __init__(self, num_cams: int, tolerance: float = 0.005):
        self.num_cams = num_cams
        self.tol = tolerance
        self._bundles: List[dict] = []  # {t, images{cam: img}}

    def add(self, cam: int, t: float, image) -> List[dict]:
        """Returns zero or more completed bundles (time-ordered)."""
        for b in self._bundles:
            if abs(b["t"] - t) <= self.tol:
                b["images"][cam] = image
                break
        else:
            self._bundles.append({"t": t, "images": {cam: image}})
            self._bundles.sort(key=lambda b: b["t"])

        out = []
        # emit all complete bundles from the front; flush stale incomplete
        # ones that are older than a completed newer bundle
        newest_complete = None
        for b in self._bundles:
            if len(b["images"]) == self.num_cams:
                newest_complete = b["t"]
        if newest_complete is None:
            return out
        remaining = []
        for b in self._bundles:
            if len(b["images"]) == self.num_cams and b["t"] <= newest_complete:
                out.append(b)
            elif b["t"] < newest_complete - self.tol:
                out.append(b)  # flushed incomplete (missing camera)
            else:
                remaining.append(b)
        self._bundles = remaining
        out.sort(key=lambda b: b["t"])
        return out


class ThreadedRunner:
    """Reader thread streaming dataset events into the pipeline.

    The producer loads and decodes images ahead of the consumer;
    IMU/GPS/LiDAR events pass through in timestamp order.
    """

    def __init__(self, dataset, pipeline, queue_size: int = 8,
                 frame_fn: Optional[Callable] = None):
        self.ds = dataset
        self.pipe = pipeline
        self.q = Queue(maxsize=queue_size)
        self.frame_fn = frame_fn
        self.results: List[dict] = []
        self._producer = threading.Thread(target=self._produce, daemon=True)

    def _produce(self):
        # native worker-pool prefetch of every camera image, delivered in
        # event order (native/dataloader.cpp); without the library each
        # image is decoded here by io/png.py, as load_image does
        from okvis2x_tpu_torch.io.native_loader import ImagePrefetcher

        prefetch = None
        try:
            prefetch = ImagePrefetcher([p for kind, ev in self.ds.events()
                                        if kind == "frames" and ev.paths[0]
                                        for p in ev.paths if p])
            for kind, ev in self.ds.events():
                if kind == "frames":
                    if not ev.paths[0]:
                        continue
                    images = [next(prefetch).astype(np.float32) / 255.0
                              for p in ev.paths if p]
                    self.q.push_blocking_if_full(("frames", (ev.t, images)))
                else:
                    self.q.push_blocking_if_full((kind, ev))
            self.q.push_blocking_if_full(("end", None))
        except ShutDown:
            pass
        except Exception as e:  # raised again on the consumer's thread
            self.q.push_nonblocking(("error", e))
        finally:
            if prefetch is not None:
                prefetch.close()

    def run(self, max_frames: int = 0) -> List[dict]:
        self._producer.start()
        n = 0
        try:
            while True:
                kind, ev = self.q.pop_blocking()
                if kind == "end":
                    break
                if kind == "error":
                    raise ev
                if kind == "imu":
                    self.pipe.add_imu_measurement(*ev)
                elif kind == "gps":
                    self.pipe.add_gps_measurement(*ev)
                elif kind == "lidar" and hasattr(self.pipe, "process_lidar_sweep"):
                    self.pipe.process_lidar_sweep(ev)
                elif kind == "frames":
                    t, images = ev
                    info = (self.frame_fn or self.pipe.process_frame)(t, images)
                    self.results.append(info)
                    n += 1
                    if max_frames and n >= max_frames:
                        break
        finally:
            # the reader thread blocked on a full queue ends here too
            self.q.shutdown()
        return self.results


class LatestValuePublisher:
    """Type-erased latest-value publisher thread (≙ okvis::ThreadedPublisher,
    okvis_util/include/okvis/ThreadedPublisher.hpp:56-64): producers call
    `publish(value)` from any thread; a dedicated consumer thread invokes
    the callback with the MOST RECENT value only — intermediate values are
    dropped, decoupling slow consumers (visualisation, ROS2 publishing)
    from the realtime pipeline."""

    def __init__(self, callback: Callable):
        self._callback = callback
        self._cv = threading.Condition()
        self._latest = None
        self._has_value = False
        self._shutdown = False
        self.n_published = 0
        self.n_delivered = 0
        self._thread = threading.Thread(
            target=self._loop, name="latest-value-publisher", daemon=True
        )
        self._thread.start()

    def publish(self, value):
        with self._cv:
            self._latest = value
            self._has_value = True
            self.n_published += 1
            self._cv.notify()

    def _loop(self):
        while True:
            with self._cv:
                while not self._has_value and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._has_value:
                    return
                value = self._latest
                self._has_value = False
            try:
                self._callback(value)
            finally:
                self.n_delivered += 1

    def shutdown(self, wait: bool = True):
        with self._cv:
            self._shutdown = True
            self._cv.notify()
        if wait:
            self._thread.join(timeout=10.0)
