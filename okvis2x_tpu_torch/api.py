"""Public estimator API types: State, TrackingState, Trajectory.

Counterpart of ``okvis2x_tpu/api.py``, the re-exposure of the reference's
``okvis::ViInterface`` surface (okvis_common/include/okvis/ViInterface.hpp:
170-342): the published state struct, tracking quality, and the client-side
`Trajectory` store that answers `get_state(t)` at any timestamp by IMU
propagation from the nearest estimator state.  Host numpy throughout.

The estimator/pipeline pushes updates through `Trajectory.update()`.
"""

from __future__ import annotations

import bisect
import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.imu.preintegration import ImuParams


class TrackingQuality(enum.Enum):
    GOOD = 0
    MARGINAL = 1
    LOST = 2


@dataclasses.dataclass
class State:
    """Published estimator state (≙ okvis::State, ViInterface.hpp:170-188)."""

    id: int
    timestamp: float
    T_WS: np.ndarray  # (7,)
    v_W: np.ndarray  # (3,)
    b_g: np.ndarray  # (3,)
    b_a: np.ndarray  # (3,)
    omega_S: np.ndarray  # (3,)
    is_keyframe: bool = False
    covisible_frame_ids: Tuple[int, ...] = ()
    T_GW: Optional[np.ndarray] = None


@dataclasses.dataclass
class TrackingState:
    """(≙ okvis::TrackingState, ViInterface.hpp:191-206)."""

    id: int
    is_keyframe: bool
    quality: TrackingQuality
    current_keyframe_id: int
    recognised_place: bool = False
    is_fully_initialised: bool = False


class Trajectory:
    """Client-side state store with IMU propagation for arbitrary-time
    queries (≙ okvis::Trajectory, ViInterface.hpp:239-342)."""

    def __init__(self, imu_params: ImuParams = ImuParams()):
        self.imu = imu_params
        self._ts: List[float] = []
        self._states: List[State] = []
        self._by_id: Dict[int, State] = {}
        # raw IMU buffer for propagation beyond the newest state
        self._imu_t: List[float] = []
        self._imu_gyr: List[np.ndarray] = []
        self._imu_acc: List[np.ndarray] = []

    def update(self, state: State):
        """Consume an (updated) estimator state; replaces by id."""
        if state.id in self._by_id:
            old = self._by_id[state.id]
            i = self._ts.index(old.timestamp)
            self._states[i] = state
            self._ts[i] = state.timestamp
        else:
            i = bisect.bisect(self._ts, state.timestamp)
            self._ts.insert(i, state.timestamp)
            self._states.insert(i, state)
        self._by_id[state.id] = state

    def add_imu_measurement(self, t: float, gyr, acc):
        self._imu_t.append(float(t))
        self._imu_gyr.append(np.asarray(gyr, np.float64))
        self._imu_acc.append(np.asarray(acc, np.float64))

    def state_ids(self) -> List[int]:
        return [s.id for s in self._states]

    def get_state_by_id(self, sid: int) -> Optional[State]:
        return self._by_id.get(sid)

    def get_state(self, t: float) -> Optional[State]:
        """State at time t: nearest estimator state, IMU-propagated (Euler
        midpoint over the raw buffer) or constant-velocity extrapolated."""
        if not self._states:
            return None
        i = bisect.bisect(self._ts, t)
        if i == 0:
            return self._states[0]
        base = self._states[i - 1]
        if abs(base.timestamp - t) < 1e-9:
            return base
        return self._propagate(base, t)

    def _propagate(self, base: State, t: float) -> State:
        # pure-numpy Euler-midpoint sweep (se3np): one host call per IMU
        # sample — the jnp version would round-trip the device per sample
        g_W = np.array([0.0, 0.0, -self.imu.g])
        v = base.v_W.copy()
        p = base.T_WS[:3].copy()
        q = np.asarray(base.T_WS[3:7], np.float64)
        t_cur = base.timestamp
        omega = np.zeros(3)

        idx = bisect.bisect(self._imu_t, base.timestamp)
        while t_cur < t:
            if idx < len(self._imu_t) and self._imu_t[idx] <= t:
                t_next = self._imu_t[idx]
                gyr = self._imu_gyr[idx] - base.b_g
                acc = self._imu_acc[idx] - base.b_a
                idx += 1
            else:
                t_next = t
                gyr = omega
                acc = se3np.quat_to_matrix(q).T @ (-g_W)  # hover assumption
            dt = t_next - t_cur
            if dt > 0:
                C = se3np.quat_to_matrix(q)
                a_W = C @ acc + g_W
                p = p + v * dt + 0.5 * a_W * dt * dt
                v = v + a_W * dt
                q = se3np.quat_normalize(
                    se3np.quat_multiply(q, se3np.delta_q(gyr * dt))
                )
            omega = gyr
            t_cur = t_next
        T_WS = np.concatenate([p, q])
        return State(
            id=base.id,
            timestamp=t,
            T_WS=T_WS,
            v_W=v,
            b_g=base.b_g,
            b_a=base.b_a,
            omega_S=omega,
            is_keyframe=False,
        )

    def clear_imu_before(self, t: float):
        i = bisect.bisect(self._imu_t, t)
        del self._imu_t[: max(i - 1, 0)]
        del self._imu_gyr[: max(i - 1, 0)]
        del self._imu_acc[: max(i - 1, 0)]

    def propagate_batch(self, times: np.ndarray) -> np.ndarray:
        """Poses T_WS (N, 7) at a batch of timestamps — the client-side
        equivalent of the reference's `BatchedLidarPropagator`
        (ViInterface.hpp:208-230), used to deskew per-ray LiDAR / rolling
        sensor data.  Each query propagates from the nearest earlier
        estimator state through the raw IMU buffer; consecutive queries
        share the incremental propagation (one sweep, not N restarts)."""
        times = np.asarray(times, np.float64)
        order = np.argsort(times)
        out = np.zeros((len(times), 7))
        # consecutive sorted timestamps usually share the same base state;
        # propagate incrementally inside each base segment
        prev_base = None
        prev_state: Optional[State] = None
        for idx in order:
            t = float(times[idx])
            if not self._states:
                out[idx] = np.array([0, 0, 0, 0, 0, 0, 1.0])
                continue
            i = bisect.bisect(self._ts, t)
            base = self._states[max(i - 1, 0)]
            if (
                prev_base is not None
                and base.id == prev_base.id
                and prev_state is not None
                and prev_state.timestamp <= t
            ):
                s = self._propagate_from(prev_state, base, t)
            else:
                s = self._propagate(base, t) if t > base.timestamp else base
            out[idx] = s.T_WS
            prev_base, prev_state = base, s
        return out

    def _propagate_from(self, start: State, bias_source: State,
                        t: float) -> State:
        """Continue Euler-midpoint propagation from an already-propagated
        state (biases taken from the underlying estimator state)."""
        tmp = Trajectory(self.imu)
        tmp._ts = [start.timestamp]
        tmp._states = [
            dataclasses.replace(
                start, b_g=bias_source.b_g, b_a=bias_source.b_a
            )
        ]
        tmp._by_id = {start.id: tmp._states[0]}
        tmp._imu_t = self._imu_t
        tmp._imu_gyr = self._imu_gyr
        tmp._imu_acc = self._imu_acc
        return tmp._propagate(tmp._states[0], t)


class ConstantVelocityPropagator:
    """No-IMU fallback: propagate a state forward assuming constant linear
    and angular velocity (≙ okvis::ConstantVelocityPropagator,
    ViInterface.hpp:208-230 — used when the rig has no IMU and the backend
    runs PseudoImuError factors)."""

    def __init__(self, state: State):
        self.state = state

    def propagate(self, t: float) -> State:
        s = self.state
        dt = t - s.timestamp
        p = s.T_WS[:3] + s.v_W * dt
        q = se3np.quat_normalize(
            se3np.quat_multiply(s.T_WS[3:7], se3np.delta_q(s.omega_S * dt))
        )
        return dataclasses.replace(
            s, timestamp=t, T_WS=np.concatenate([p, q])
        )


class QueuedTrajectory:
    """Bounded timestamp-interpolated pose buffer (≙ okvis::
    QueuedTrajectory, okvis_multisensor_processing QueuedTrajectory.hpp):
    push (t, T_WS) samples, query poses at arbitrary times by SE(3)
    interpolation between the bracketing samples.  Used by consumers that
    only need smooth poses (visualisation, depth registration), not the
    full IMU-propagated Trajectory."""

    def __init__(self, max_samples: int = 1000):
        self.max_samples = max_samples
        self._ts: List[float] = []
        self._T: List[np.ndarray] = []

    def push(self, t: float, T_WS: np.ndarray):
        i = bisect.bisect(self._ts, t)
        self._ts.insert(i, float(t))
        self._T.insert(i, np.asarray(T_WS, np.float64))
        if len(self._ts) > self.max_samples:
            del self._ts[0], self._T[0]

    def get(self, t: float) -> Optional[np.ndarray]:
        """Interpolated pose at t, or None when t is outside the buffer."""
        if not self._ts or t < self._ts[0] - 1e-9 or t > self._ts[-1] + 1e-9:
            return None
        i = bisect.bisect(self._ts, t)
        if i == 0:
            return self._T[0].copy()
        if i >= len(self._ts):
            return self._T[-1].copy()
        t0, t1 = self._ts[i - 1], self._ts[i]
        alpha = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)
        return se3np.se3_interpolate(self._T[i - 1], self._T[i], alpha)
