"""Realsense live-sensor driver (optional hardware dependency).

Counterpart of ``okvis2x_tpu/io/realsense.py``, the reference's
`Realsense`/`RealsenseRgbd` drivers (okvis_multisensor_processing/src/
Realsense.cpp, RealsenseRgbd.cpp): wraps pyrealsense2 streaming into the
same callback protocol the dataset readers use (imu / frames / depth
events), so the dataset app's consumers work unchanged against live
hardware.

Without pyrealsense2 the live driver raises ImportError at construction;
`FakeRealsense` provides the same interface for dataflow tests (≙ the
reference's mocked-sensor tests, okvis_multisensor_processing/test/
testDataFlow.cpp).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np


class RealsenseBase:
    """Callback registry shared by live + fake drivers
    (≙ ViSensorBase, okvis_multisensor_processing/include/okvis/
    ViSensorBase.hpp:36-133)."""

    def __init__(self):
        self.imu_cb: Optional[Callable] = None
        self.images_cb: Optional[Callable] = None
        self.depth_cb: Optional[Callable] = None

    def set_imu_callback(self, cb):
        self.imu_cb = cb

    def set_images_callback(self, cb):
        self.images_cb = cb

    def set_depth_callback(self, cb):
        self.depth_cb = cb


class Realsense(RealsenseBase):
    """Live D4xx driver over pyrealsense2 (ir stereo + imu; rgbd=True adds
    the aligned depth stream, ≙ RealsenseRgbd)."""

    def __init__(self, rgbd: bool = False, width=640, height=480, fps=30):
        super().__init__()
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "pyrealsense2 is required for the live Realsense driver; "
                "it is not part of this environment. Use FakeRealsense for "
                "tests or a dataset reader for offline runs."
            ) from e
        self._rs = rs
        self.rgbd = rgbd
        self.width, self.height, self.fps = width, height, fps
        self._pipe = None
        self._thread = None
        self._running = False

    def start_streaming(self):
        rs = self._rs
        cfg = rs.config()
        cfg.enable_stream(rs.stream.infrared, 1, self.width, self.height,
                          rs.format.y8, self.fps)
        cfg.enable_stream(rs.stream.infrared, 2, self.width, self.height,
                          rs.format.y8, self.fps)
        if self.rgbd:
            cfg.enable_stream(rs.stream.depth, self.width, self.height,
                              rs.format.z16, self.fps)
        cfg.enable_stream(rs.stream.accel)
        cfg.enable_stream(rs.stream.gyro)
        self._pipe = rs.pipeline()
        self._pipe.start(cfg)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while self._running:
            frames = self._pipe.wait_for_frames()
            t = frames.get_timestamp() * 1e-3
            imgs: List[np.ndarray] = []
            depth = None
            for f in frames:
                if f.is_motion_frame():
                    m = f.as_motion_frame().get_motion_data()
                    if self.imu_cb:
                        self.imu_cb(t, [m.x, m.y, m.z], [0, 0, 0])
                elif f.is_depth_frame():
                    depth = np.asanyarray(f.get_data()).astype(np.float32) * 1e-3
                elif f.is_video_frame():
                    imgs.append(
                        np.asanyarray(f.get_data()).astype(np.float32) / 255.0
                    )
            if imgs and self.images_cb:
                self.images_cb(t, imgs)
            if depth is not None and self.depth_cb:
                self.depth_cb(t, depth)

    def stop_streaming(self):
        self._running = False
        if self._thread:
            self._thread.join()
        if self._pipe:
            self._pipe.stop()


class FakeRealsense(RealsenseBase):
    """Deterministic fake sensor: streams a synthetic dataset through the
    live-driver callback protocol (for dataflow/threading tests)."""

    def __init__(self, dataset, realtime: bool = False):
        super().__init__()
        self.ds = dataset
        self.realtime = realtime
        self._thread = None
        self._running = False

    def start_streaming(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        prev_t = None
        for kind, data in self.ds.events():
            if not self._running:
                break
            if self.realtime and prev_t is not None:
                t_now = data[0] if kind == "imu" else data.t
                time.sleep(max(0.0, min(t_now - prev_t, 0.1)))
                prev_t = t_now
            if kind == "imu":
                if self.imu_cb:
                    self.imu_cb(*data)
                prev_t = data[0] if prev_t is None else prev_t
            elif kind == "frames":
                if self.images_cb and data.paths[0]:
                    imgs = [self.ds.load_image(p) for p in data.paths if p]
                    self.images_cb(data.t, imgs)
                prev_t = data.t if prev_t is None else prev_t

    def wait_done(self, timeout: float = 300.0):
        """Block until the replay finished naturally (recorder use)."""
        if self._thread:
            self._thread.join(timeout=timeout)

    def stop_streaming(self):
        self._running = False
        if self._thread:
            self._thread.join(timeout=5.0)
