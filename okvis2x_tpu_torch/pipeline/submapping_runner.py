"""Asynchronous submapping runner (two worker threads and queues).

Counterpart of ``okvis2x_tpu/pipeline/submapping_runner.py``, the
orchestration of the reference's `SubmappingInterface` threading
(okvis_multisensor_processing/src/SubmappingInterface.cpp): sensor callbacks
push depth images / LiDAR sweeps into a queue (`addDepthMeasurement` :381 /
`addLidarMeasurement` :351), the **assembly thread** replays the estimator's
optimised-graph callbacks into a client-side `api.Trajectory` and waits
until the trajectory covers a measurement's timestamp before interpolating
its pose (`integrationLoop` + `checkForAvailableData` :489/:1028), and the
**integration thread** consumes assembled work items: submap life-cycle
decisions, occupancy integration, re-anchoring on loop-closure corrections
(`processSupereightFrames` :710-963).

The integration itself is `pipeline/submapping.py`'s, on the interface's
device; the threads overlap host-side assembly with the device work.  The
sensor pose is composed on the host in float64 (``core/se3.py``).
`finish()` is the JAX package's (ROADMAP.md C-R17): it joins each thread
with a 5 s timeout, so it can return before an integration has ended, and a
measurement that the assembly thread holds when `finish()` finds both queues
empty is never integrated; a caller that needs every result waits for
`n_integrated` before `finish()` and joins the threads itself.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch import api
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.pipeline.queues import Queue, ShutDown
from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface

IDENTITY = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)


@dataclasses.dataclass
class _Measurement:
    t: float
    kind: str  # "depth" | "lidar"
    payload: dict


@dataclasses.dataclass
class _WorkItem:
    kf_fid: int
    T_WK: np.ndarray
    kind: str
    pose: np.ndarray  # T_WC (depth) or T_WS (lidar) at measurement time
    payload: dict


class AsyncSubmapping:
    """Queue-fed asynchronous wrapper around a SubmappingInterface."""

    def __init__(
        self,
        si: SubmappingInterface,
        cam=None,  # depth camera intrinsics
        T_SC: Optional[np.ndarray] = None,  # depth camera extrinsics (7,)
        T_SL: Optional[np.ndarray] = None,  # LiDAR extrinsics (7,)
        imu_params: api.ImuParams = api.ImuParams(),
        queue_size: int = 32,
    ):
        self.si = si
        self.cam = cam
        self.T_SC = np.asarray(T_SC if T_SC is not None else IDENTITY)
        self.T_SL = np.asarray(T_SL if T_SL is not None else IDENTITY)
        self.trajectory = api.Trajectory(imu_params)
        self._meas = Queue(maxsize=queue_size)
        self._work = Queue(maxsize=queue_size)
        self._state_event = threading.Event()
        self._kf: Optional[tuple] = None  # (fid, T_WK)
        self._lock = threading.Lock()
        self._done = False
        self.n_integrated = 0
        self.n_dropped = 0
        self._t_assembly = threading.Thread(
            target=self._assembly_loop, name="submap-assembly", daemon=True)
        self._t_integrate = threading.Thread(
            target=self._integration_loop, name="submap-integration", daemon=True)
        self._t_assembly.start()
        self._t_integrate.start()

    # ----------------------------------------------------------- producers
    def add_depth_measurement(self, t: float, depth: np.ndarray, sigma=None):
        """(≙ SubmappingInterface::addDepthMeasurement)"""
        self._meas.push_blocking_if_full(
            _Measurement(t, "depth", dict(depth=depth, sigma=sigma)))

    def add_lidar_measurement(self, t: float, pts_L: np.ndarray):
        """(≙ SubmappingInterface::addLidarMeasurement) — points in the
        LiDAR frame, one (already deskewed) bundle per call."""
        self._meas.push_blocking_if_full(_Measurement(t, "lidar", dict(pts=pts_L)))

    def state_update_callback(self, state: api.State,
                              updated_states: Optional[List[api.State]] = None):
        """(≙ stateUpdateCallback -> stateUpdates_ queue): feed optimised
        states; loop-closure corrections arrive as `updated_states` and
        trigger submap re-anchoring."""
        with self._lock:
            self.trajectory.update(state)
            if state.is_keyframe:
                self._kf = (state.id, state.T_WS.copy())
            if updated_states:
                for s in updated_states:
                    self.trajectory.update(s)
                self.si.on_state_update({s.id: s.T_WS for s in updated_states})
        self._state_event.set()

    # ------------------------------------------------------------- threads
    def _pose_at(self, t: float) -> Optional[np.ndarray]:
        with self._lock:
            st = self.trajectory.get_state(t)
            ids = self.trajectory.state_ids()
            newest_ok = bool(ids) and self.trajectory.get_state_by_id(ids[-1]).timestamp >= t
        if st is None or not newest_ok:
            return None
        return st.T_WS

    def _assembly_loop(self):
        while True:
            try:
                m = self._meas.pop_blocking()
            except ShutDown:
                self._work.shutdown()
                return
            # wait until the trajectory reaches the measurement time
            # (≙ checkForAvailableData: newest state >= oldest measurement)
            while True:
                T_WS = self._pose_at(m.t)
                if T_WS is not None:
                    break
                if self._done:
                    break
                self._state_event.clear()
                self._state_event.wait(timeout=0.5)
            with self._lock:
                kf = self._kf
            if T_WS is None or kf is None:
                self.n_dropped += 1
                continue
            ext = self.T_SC if m.kind == "depth" else self.T_SL
            pose = se3.se3_multiply(torch.as_tensor(np.asarray(T_WS, np.float64)),
                                    torch.as_tensor(np.asarray(ext, np.float64))).numpy()
            self._work.push_blocking_if_full(_WorkItem(kf[0], kf[1], m.kind, pose, m.payload))

    def _integration_loop(self):
        while True:
            try:
                w = self._work.pop_blocking()
            except ShutDown:
                return
            if w.kind == "depth":
                self.si.integrate_depth(w.kf_fid, w.T_WK, w.pose, self.cam,
                                        w.payload["depth"], w.payload.get("sigma"))
            else:
                self.si.integrate_lidar(w.kf_fid, w.T_WK, w.pose, w.payload["pts"])
            self.n_integrated += 1

    # ------------------------------------------------------------ shutdown
    def finish(self, timeout: float = 30.0):
        """Drain both queues and stop the threads (≙ the app waiting for the
        integrator at dataset end); each join gives up after 5 s (C-R17)."""
        t0 = time.monotonic()
        while (len(self._meas) or len(self._work)) and time.monotonic() - t0 < timeout:
            self._state_event.set()
            time.sleep(0.01)
        self._done = True
        self._state_event.set()
        self._meas.shutdown()
        self._work.shutdown()
        self._t_assembly.join(timeout=5.0)
        self._t_integrate.join(timeout=5.0)
