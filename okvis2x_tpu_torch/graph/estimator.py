"""Sliding-window VIO estimator (torch counterpart of the VIO subset of
``okvis2x_tpu/graph/estimator.py``).

Graph structure (frames, landmarks, observations, window policy,
marginalisation) lives on the host as numpy arrays and Python lists, as in
the JAX package; the numerics (the gated LM window solve, the two-pose
marginalisation edges) run as torch code on the estimator's device.

Window policy (the reference's applyStrategy):
  * the newest `num_imu_frames` frames are always kept;
  * older non-keyframes are eliminated by IMU-chain merge;
  * keyframes beyond `num_keyframes` become frozen pose-graph frames whose
    co-observation information is kept as two-pose edges chosen by a
    maximum spanning tree over covisibility;
  * the oldest pose-graph frames leave the window beyond its capacity;
  * landmarks without observations are deleted.

IMU links are chained, cached f64 host preintegrations re-propagated only
when the bias moved past the redo thresholds.

Long-term state for loop closure and the final BA: frames that leave the
window go to `archive_frames` with their edges, their observations to an
observation archive, pruned landmarks to `arch_lm`, and trimmed raw IMU
samples to an IMU archive.  Loop closure brings an archived keyframe back
as an "expanded" pose-graph frame (held, damped towards its pre-hold pose),
merges landmarks, and solves the pose graph in line (`close_loop`).
`final_ba` re-expands the whole history into one bundle adjustment with
re-propagated IMU links, or into a pose graph plus overlapping segments
beyond `max_nodes` keyframes.

GNSS fusion: fixes arrive through `add_gps_measurement`; once enough of them
pair with estimated positions over at least 1 m of horizontal motion, the
4-dof world-to-GNSS alignment T_GW is estimated in closed form
("Initialised"), and the window solve then carries the newest fixes as
asynchronous position rows (host frame, IMU bridge to the fix time) with
T_GW free.  A gap of more than 2 s between fixes holds T_GW ("ReInitialising")
until the fixes return and it is realigned.  As in the JAX package, the final
BA and the background full graph carry no GNSS rows.  Online extrinsics
calibration (`do_extrinsics`, `do_extrinsics_final_ba`) frees T_SC under a
prior around the initial calibration.

RGB-D: an observation may carry a per-keypoint depth prior (`obs_depth`,
`obs_depth_sigma`; a sigma of 0 leaves it off), kept through every filter,
the archive and the re-expansion of archived keyframes; the window solves
carry its rows whenever one is live.  As in the JAX package, the final BA
and the background full graph carry none.

LiDAR: with `cap_icp` > 0 the live frame-to-map points of the newest sweep
(`set_live_icp_points`) enter the window solves as per-point rows against the
active submap (`set_icp_map`), with both the anchor keyframe's and the
owner frame's poses free; the previous sweep's rows are dropped.  As in the
JAX package, the final BA and the background full graph carry none.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.factors import imu_factor
from okvis2x_tpu_torch.factors.reprojection import residual as reprojection_residual
from okvis2x_tpu_torch.graph import posegraph
from okvis2x_tpu_torch.graph.marginalization import two_pose_edge
from okvis2x_tpu_torch.graph.posegraph import max_spanning_tree
from okvis2x_tpu_torch.imu import preintegration as pre
from okvis2x_tpu_torch.imu import preintegration_np as pre_np
from okvis2x_tpu_torch.parallel import dist_posegraph
from okvis2x_tpu_torch.solver import gauss_newton as gn
from okvis2x_tpu_torch.solver import problem as prb
from okvis2x_tpu_torch.utils import timing


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    num_keyframes: int = 5
    num_imu_frames: int = 3
    cap_frames: int = 12
    cap_landmarks: int = 768
    cap_obs: int = 6144
    cap_imu_links: int = 11
    cap_imu_samples: int = 512
    # chained-preintegration cache: re-propagate a link from raw samples
    # when the bias moved past these thresholds from its linearisation point
    imu_bias_redo_g: float = 0.01  # [rad/s]
    imu_bias_redo_a: float = 0.05  # [m/s^2]
    imu_redo_max_samples: int = 4096
    cap_rel_edges: int = 16
    cap_gps: int = 8
    cap_icp: int = 0
    keypoint_sigma_px: float = 0.8
    max_iterations: int = 10
    # realtime solve budget: > 0 steps the iteration count of the pipelined
    # window solve down a bucket (max -> midpoint -> min_iterations) while
    # the EMA of the measured solve wall time overruns it, and back up on
    # slack (`adapt_realtime_budget`)
    realtime_time_limit: float = 0.0
    min_iterations: int = 3
    # > 0: early exit of the LM loop on converged accepted steps
    early_exit_rel: float = 0.0
    imu: pre.ImuParams = pre.ImuParams()
    dtype: torch.dtype = torch.float64
    # online extrinsics calibration: T_SC free under a pose prior of these
    # stdevs around the initial calibration (the window's, the final BA's)
    do_extrinsics: bool = False
    do_extrinsics_final_ba: bool = False
    extrinsics_sigma_r: float = 0.001  # [m]
    extrinsics_sigma_alpha: float = 0.005  # [rad]
    extrinsics_sigma_r_final_ba: float = 0.001
    extrinsics_sigma_alpha_final_ba: float = 0.005
    init_pos_sigma: float = 1e-4
    init_yaw_sigma: float = 1e-4
    init_rollpitch_sigma: float = 0.03
    init_v_sigma: float = 0.1


@dataclasses.dataclass
class FrameState:
    fid: int
    timestamp: float
    T_WS: np.ndarray  # (7,)
    sb: np.ndarray  # (9,)
    is_keyframe: bool = False
    pose_fixed: bool = False
    sb_fixed: bool = False
    # marginalised keyframe kept as a frozen pose-graph anchor: its
    # observations became two-pose edges; no speed/bias, no IMU links
    pose_graph_frame: bool = False
    # pose-graph frame whose observations were re-expanded into the window
    # (loop closure): its pose optimises again, still without IMU links
    expanded: bool = False
    # pose when a loop closure brought the frame back (anchor of its
    # damping prior and of the writeback clamp)
    pre_hold_T: Optional[np.ndarray] = None


_OBS_COLS = ("obs_fid", "obs_cam", "obs_lid", "obs_uv", "obs_sigma", "obs_depth",
             "obs_depth_sigma", "obs_uid")


class SlidingWindowEstimator:
    """Keyframe-based sliding-window visual-inertial estimator."""

    def __init__(self, config: EstimatorConfig, cameras, T_SC: np.ndarray, device=None):
        """`device` None is the first CUDA device; without one this raises
        (pass device="cpu" to run on the CPU)."""
        self.cfg = config
        self.device = default_device() if device is None else torch.device(device)
        self.cams = gn.stack_cameras(cameras).to(self.device, config.dtype)
        self.T_SC = np.asarray(T_SC, dtype=np.float64)  # (C, 7)
        self.C = self.T_SC.shape[0]
        # the online-calibration prior is anchored at the initial calibration
        self.T_SC_prior = self.T_SC.copy()

        self.frames: List[FrameState] = []
        self._next_fid = 0
        self._next_lid = 0

        # realtime budget controller: iteration bucket of the next pipelined
        # solve, EMA of the solve wall time, overrun count
        self._rt_iters = config.max_iterations
        self._rt_ema = 0.0
        self.n_budget_overruns = 0

        # landmark store: lid -> row index in the dense arrays
        self.lm_ids: List[int] = []
        self.lm_index: Dict[int, int] = {}
        self.hp_W = np.zeros((0, 4))

        # observations as numpy columns; uids are persistent row ids
        self.obs_fid = np.zeros((0,), np.int64)
        self.obs_cam = np.zeros((0,), np.int64)
        self.obs_lid = np.zeros((0,), np.int64)
        self.obs_uv = np.zeros((0, 2))
        self.obs_sigma = np.zeros((0,))
        self.obs_depth = np.zeros((0,))  # per-keypoint depth prior [m]
        self.obs_depth_sigma = np.zeros((0,))  # 0: no prior
        self.obs_uid = np.zeros((0,), np.int64)
        self._obs_uid_next = 0

        # IMU raw buffer: amortised growable array + start offset; trimmed
        # samples move to the archive buffer, which the final BA reads to
        # re-propagate IMU links over archived keyframe spans
        self._imu_buf = np.zeros((4096, 7))  # [t, gyr(3), acc(3)]
        self._imu_start = 0
        self._imu_n = 0
        self._arch_imu_buf = np.zeros((4096, 7))
        self._arch_imu_n = 0

        # bumped by every applied global correction (loop-closure pose
        # graph, final-BA writeback)
        self.correction_epoch = 0
        # loop-closure frames held in the window: protected from archival
        # by the frame cap while the pipeline holds them
        self.lc_protected: set = set()

        # chained per-link preintegration cache: (fid_a, fid_b) ->
        # (Preintegrated f64 numpy, sqrt_info (15, 15) f64)
        self.imu_links: Dict[tuple, tuple] = {}

        # deferred marginalisation edges (the deferred frontend): the
        # two-pose edges of a marginalised keyframe are launched and kept as
        # jobs, which the pipeline reads back one cycle later and folds in
        # with `apply_pending_edges`
        self.defer_edge_jobs = False
        self.pending_edge_jobs: List[dict] = []

        # relative-pose (marginalisation) edges between frame ids, and the
        # long-term pose graph of frames/edges that left the window
        self.rel_edges: List[dict] = []
        self.archive_frames: Dict[int, FrameState] = {}
        self.archive_edges: List[dict] = []
        # observations of frames that left the window (growable stores read
        # through the arch_obs_* views) and landmark positions snapshotted
        # when pruned
        self._arch_obs_i = np.zeros((1024, 3), np.int64)  # fid, cam, lid
        self._arch_obs_f = np.zeros((1024, 5))  # uv(2), sigma, depth, depth sigma
        self._arch_obs_n = 0
        self.arch_lm: Dict[int, np.ndarray] = {}

        # GNSS status machine: "Off" until the first fix, "Idle" until the
        # alignment succeeds, then "Initialised"; "ReInitialising" while the
        # fixes are out for longer than gps_timeout (T_GW held)
        self.gps_status = "Off"
        self.gps_meas: List[tuple] = []  # (t, pos_G (3,), err (3,))
        self.T_GW = np.array([0, 0, 0, 0, 0, 0, 1.0])
        self.gps_r_SA = np.zeros(3)  # antenna position in S
        self.gps_min_fixes = 6
        self.gps_min_span = 1.0  # [m] horizontal extent before alignment
        self.gps_timeout = 2.0  # [s]
        # window solves built with at least one valid GNSS row
        self.n_gps_solves = 0

        # live per-point submap ICP rows: one refreshed set per sweep
        # (anchor fid, owner fid, points in the owner's body frame (n, 3),
        # sigma) against `icp_map`, a submap of grid config `icp_grid_cfg`
        self.icp_live: Optional[tuple] = None
        self.icp_map = None
        self.icp_grid_cfg = None

        # priors on the first state
        self.prior_fid: Optional[int] = None
        self.prior_T: Optional[np.ndarray] = None
        self.prior_sqrt_info: Optional[np.ndarray] = None
        self.prior_sb: Optional[np.ndarray] = None
        self.prior_sb_sqrt_info: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ imu
    @property
    def imu_t(self):
        return self._imu_buf[self._imu_start:self._imu_n, 0]

    @property
    def imu_gyr(self):
        return self._imu_buf[self._imu_start:self._imu_n, 1:4]

    @property
    def imu_acc(self):
        return self._imu_buf[self._imu_start:self._imu_n, 4:7]

    @property
    def arch_imu_t(self):
        return self._arch_imu_buf[:self._arch_imu_n, 0]

    @property
    def arch_imu_gyr(self):
        return self._arch_imu_buf[:self._arch_imu_n, 1:4]

    @property
    def arch_imu_acc(self):
        return self._arch_imu_buf[:self._arch_imu_n, 4:7]

    def add_imu_measurement(self, t: float, gyr, acc):
        if self._imu_n == len(self._imu_buf):
            # compact the trimmed prefix away, then double if still full
            live = self._imu_buf[self._imu_start:self._imu_n]
            cap = len(self._imu_buf)
            if len(live) > cap // 2:
                cap *= 2
            buf = np.zeros((cap, 7))
            buf[: len(live)] = live
            self._imu_buf = buf
            self._imu_n = len(live)
            self._imu_start = 0
        self._imu_buf[self._imu_n, 0] = t
        self._imu_buf[self._imu_n, 1:4] = gyr
        self._imu_buf[self._imu_n, 4:7] = acc
        self._imu_n += 1

    def _imu_span(self, t0: float, t1: float):
        """Measurements covering [t0, t1] incl. one sample beyond each end."""
        i0 = max(int(np.searchsorted(self.imu_t, t0, "right")) - 1, 0)
        i1 = min(int(np.searchsorted(self.imu_t, t1, "left")) + 1, len(self.imu_t))
        return i0, i1

    def _trim_imu_buffer(self):
        if not self.frames:
            return
        keep = self.imu_t >= self.frames[0].timestamp - 0.5
        first = int(np.argmax(keep)) if keep.any() else len(self.imu_t)
        first = max(first - 1, 0)
        if first > 0:
            rows = self._imu_buf[self._imu_start:self._imu_start + first]
            need = self._arch_imu_n + first
            if need > len(self._arch_imu_buf):
                buf = np.zeros((max(need, 2 * len(self._arch_imu_buf)), 7))
                buf[: self._arch_imu_n] = self._arch_imu_buf[: self._arch_imu_n]
                self._arch_imu_buf = buf
            self._arch_imu_buf[self._arch_imu_n:need] = rows
            self._arch_imu_n = need
            self._imu_start += first

    def _full_imu_arrays(self):
        """(t, gyr, acc) over the archive and live buffers, time-ordered."""
        return (
            np.append(self.arch_imu_t, self.imu_t),
            np.vstack([self.arch_imu_gyr, self.imu_gyr]),
            np.vstack([self.arch_imu_acc, self.imu_acc]),
        )

    # ---------------------------------------------------------------- states
    def add_state(self, timestamp: float) -> int:
        """Create a new state.  First call: gravity-aligned initialisation
        from the accelerometer mean with strong priors; later calls: IMU
        propagation from the newest state."""
        cfg = self.cfg
        if not self.frames:
            i0, i1 = self._imu_span(timestamp - 0.2, timestamp + 0.01)
            acc_mean = self.imu_acc[i0:i1].mean(axis=0)
            gyr_mean = self.imu_gyr[i0:i1].mean(axis=0)
            T0 = pre.init_pose_from_accel(
                torch.from_numpy(acc_mean), torch.from_numpy(gyr_mean)
            ).numpy()
            sb0 = np.zeros(9)
            sb0[3:6] = gyr_mean  # stationary assumption: gyro mean = bias
            f = FrameState(self._next_fid, timestamp, T0, sb0, is_keyframe=True)
            self.frames.append(f)
            self._next_fid += 1
            self.prior_fid = f.fid
            self.prior_T = T0.copy()
            si = np.zeros((6, 6))
            si[0:3, 0:3] = np.eye(3) / cfg.init_pos_sigma
            si[3, 3] = si[4, 4] = 1.0 / cfg.init_rollpitch_sigma
            si[5, 5] = 1.0 / cfg.init_yaw_sigma
            self.prior_sqrt_info = si
            self.prior_sb = sb0.copy()
            self.prior_sb_sqrt_info = np.diag(
                [1.0 / cfg.init_v_sigma] * 3
                + [1.0 / cfg.imu.sigma_bg] * 3
                + [1.0 / cfg.imu.sigma_ba] * 3
            )
            return f.fid

        last = self.frames[-1]
        if timestamp <= last.timestamp:
            raise ValueError("states must be added in time order")
        i0, i1 = self._imu_span(last.timestamp, timestamp)
        T1, v1 = pre_np.predict_state(
            cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
            self.imu_acc[i0:i1], last.timestamp, timestamp,
            last.T_WS, last.sb[0:3], last.sb[3:6], last.sb[6:9],
        )
        f = FrameState(self._next_fid, timestamp, T1, np.concatenate([v1, last.sb[3:9]]))
        self.frames.append(f)
        self._next_fid += 1
        return f.fid

    def _preintegrate_batch(self, spans, n_rows: int, S: Optional[int] = None,
                            imu_arrays=None):
        """spans: list of (t0, t1, bg, ba); returns (Preintegrated batched to
        n_rows, W (n_rows, 15, 15)) on the device, invalid rows padded with
        identity.  Spans longer than S samples are uniformly subsampled.
        `imu_arrays` = (t, gyr, acc) replaces the live buffer as the sample
        source (the final BA passes the archive + live samples)."""
        cfg = self.cfg
        S = S or cfg.cap_imu_samples
        if imu_arrays is None:
            t_arr, gyr_arr, acc_arr = self.imu_t, self.imu_gyr, self.imu_acc
        else:
            t_arr, gyr_arr, acc_arr = imu_arrays
        if len(spans) > n_rows:
            raise ValueError(f"{len(spans)} spans exceed {n_rows} rows")
        tB = np.zeros((n_rows, S))
        gyrB = np.zeros((n_rows, S, 3))
        accB = np.zeros((n_rows, S, 3))
        maskB = np.zeros((n_rows, S), bool)
        t0B = np.zeros(n_rows)
        t1B = np.ones(n_rows) * 1e-3
        bgB = np.zeros((n_rows, 3))
        baB = np.zeros((n_rows, 3))
        valid = np.zeros(n_rows, bool)
        for r, (t0, t1, bg, ba) in enumerate(spans):
            i0 = max(int(np.searchsorted(t_arr, t0, "right")) - 1, 0)
            i1 = min(int(np.searchsorted(t_arr, t1, "left")) + 1, len(t_arr))
            n = i1 - i0
            if n > S:
                logging.warning("IMU span %d samples exceeds capacity %d — subsampling", n, S)
                idx = np.unique(np.linspace(i0, i1 - 1, S).astype(int))
                n = len(idx)
            else:
                idx = np.arange(i0, i1)
            tB[r] = t1 + 1.0
            tB[r, :n] = t_arr[idx]
            gyrB[r, :n] = gyr_arr[idx]
            accB[r, :n] = acc_arr[idx]
            maskB[r, :n] = True
            t0B[r], t1B[r] = t0, t1
            bgB[r], baB[r] = bg, ba
            valid[r] = True
        dt = dict(dtype=cfg.dtype, device=self.device)
        T = lambda x: torch.as_tensor(x, **dt)  # noqa: E731
        batch = pre.ImuBatch(t=T(tB), gyr=T(gyrB), acc=T(accB),
                             mask=torch.as_tensor(maskB, device=self.device))
        P = pre.preintegrate(cfg.imu, batch, T(t0B), T(t1B), T(bgB), T(baB))
        v = torch.as_tensor(valid, device=self.device)[:, None, None]
        eye15 = torch.eye(15, **dt)
        W = imu_factor.sqrt_information(torch.where(v, P.P, eye15))
        return P, torch.where(v, W, eye15)

    def repredict_after(self, fid: int):
        """Re-run the IMU prediction of every chain state newer than `fid`
        (the newest frame of a just-collected solve), so that the next
        problem linearises around predictions rolled forward from the
        corrected states; no solved pose is overwritten."""
        chain = self._chain_frames()
        idx = None
        for i, f in enumerate(chain):
            if f.fid <= fid:
                idx = i
        if idx is not None:
            self.repredict_latest(tail=len(chain) - 1 - idx)

    def repredict_latest(self, tail: int = 1):
        """Re-run the IMU prediction of the newest `tail` chain states from
        their (just-corrected) predecessors."""
        if tail <= 0:
            return
        chain = self._chain_frames()
        for k in range(max(len(chain) - tail, 1), len(chain)):
            a, b = chain[k - 1], chain[k]
            i0, i1 = self._imu_span(a.timestamp, b.timestamp)
            if i1 - i0 < 2:
                continue
            T1, v1 = pre_np.predict_state(
                self.cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
                self.imu_acc[i0:i1], a.timestamp, b.timestamp,
                a.T_WS, a.sb[0:3], a.sb[3:6], a.sb[6:9],
            )
            b.T_WS = T1
            b.sb = np.concatenate([v1, a.sb[3:9]])

    # -------------------------------------------------- chained imu links
    def _chain_frames(self) -> List[FrameState]:
        """Frames on the live IMU chain (non-pose-graph), in time order."""
        return [f for f in self.frames if not f.pose_graph_frame]

    def _link_for(self, a: FrameState, b: FrameState):
        """Cached chained preintegration + sqrt-info for chain link a->b,
        re-propagated from raw samples only past the bias redo thresholds
        and while the raw span is short enough to re-scan."""
        cfg = self.cfg
        key = (a.fid, b.fid)
        ent = self.imu_links.get(key)
        bg, ba = a.sb[3:6], a.sb[6:9]
        if ent is not None:
            e = ent[0]
            if (np.linalg.norm(bg - e.lin_bg) < cfg.imu_bias_redo_g
                    and np.linalg.norm(ba - e.lin_ba) < cfg.imu_bias_redo_a):
                return ent
            i0, i1 = self._imu_span(a.timestamp, b.timestamp)
            if i1 - i0 > cfg.imu_redo_max_samples or not self._imu_covers(
                    i0, i1, a.timestamp, b.timestamp):
                return ent
        ent = self._host_preintegrate_link(a.timestamp, b.timestamp, bg, ba)
        self.imu_links[key] = ent
        return ent

    def _imu_covers(self, i0: int, i1: int, t0: float, t1: float) -> bool:
        if i1 - i0 < 2:
            return False
        return self.imu_t[i0] <= t0 + 1e-6 and self.imu_t[i1 - 1] >= t1 - 1e-6

    def _host_preintegrate_link(self, t0: float, t1: float, bg, ba):
        """f64 host preintegration, degrading to a weak factor when the
        samples do not cover the span."""
        i0, i1 = self._imu_span(t0, t1)
        e = pre_np.preintegrate_full(
            self.cfg.imu, self.imu_t[i0:i1], self.imu_gyr[i0:i1],
            self.imu_acc[i0:i1], t0, t1, np.asarray(bg, float), np.asarray(ba, float),
        )
        span = max(t1 - t0, 1e-3)
        if e.dt < 0.5 * span:
            logging.warning("IMU link [%0.3f, %0.3f] covered %0.3fs of %0.3fs — "
                            "weak-factor fallback", t0, t1, e.dt, span)
            e = e._replace(dt=span, P=np.eye(15) * 1e6)
        return e, pre_np.sqrt_information(e.P)

    def _merge_chain_link(self, mid_fid: int):
        """Compose the two cached links around `mid_fid` before it leaves the
        IMU chain, then drop links touching it."""
        chain = self._chain_frames()
        idx = next((i for i, f in enumerate(chain) if f.fid == mid_fid), None)
        if idx is not None and 0 < idx < len(chain) - 1:
            a, m, b = chain[idx - 1], chain[idx], chain[idx + 1]
            ea, _ = self._link_for(a, m)
            eb, _ = self._link_for(m, b)
            merged = pre_np.compose(ea, eb)
            self.imu_links[(a.fid, b.fid)] = (merged, pre_np.sqrt_information(merged.P))
        self.imu_links = {k: v for k, v in self.imu_links.items() if mid_fid not in k}

    def _prune_imu_links(self):
        chain_fids = {f.fid for f in self._chain_frames()}
        self.imu_links = {
            k: v for k, v in self.imu_links.items()
            if k[0] in chain_fids and k[1] in chain_fids
        }

    @staticmethod
    def _stack_links(entries, Mcap: int):
        """Batch per-link (Preintegrated, W) into numpy (Preintegrated[Mcap],
        W (Mcap, 15, 15)) with identity-padded invalid rows."""
        z3 = np.zeros((Mcap, 3))
        z33 = np.zeros((Mcap, 3, 3))
        out = pre.Preintegrated(
            dq=np.tile(np.array([0.0, 0, 0, 1.0]), (Mcap, 1)), dp=z3.copy(),
            dv=z3.copy(), dp_dbg=z33.copy(), dp_dba=z33.copy(),
            dv_dbg=z33.copy(), dv_dba=z33.copy(), dq_dbg=z33.copy(),
            P=np.tile(np.eye(15), (Mcap, 1, 1)), dt=np.full(Mcap, 1e-3),
            lin_bg=z3.copy(), lin_ba=z3.copy(),
        )
        W = np.tile(np.eye(15), (Mcap, 1, 1))
        for m, (e, w) in enumerate(entries):
            for fld in pre.Preintegrated._fields:
                getattr(out, fld)[m] = getattr(e, fld)
            W[m] = w
        return out, W

    # ------------------------------------------------------------------ gps
    def add_gps_measurement(self, t: float, pos_G, err):
        """A position fix `pos_G` (3,) in the GNSS frame at time `t` with
        per-axis stdevs `err` (3,); the first fix switches GNSS on."""
        self.gps_meas.append((float(t), np.asarray(pos_G, float), np.asarray(err, float)))
        if self.gps_status == "Off":
            self.gps_status = "Idle"
        if self.gps_status == "Idle":
            self._attempt_gps_alignment()

    def _gps_state_pos(self, t: float) -> Optional[np.ndarray]:
        """Estimated position at time t, interpolated between the archived
        and window frames around it; None more than 0.2 s outside them."""
        frames = sorted(list(self.archive_frames.values()) + self.frames,
                        key=lambda f: f.timestamp)
        if not frames or t < frames[0].timestamp - 0.2 or t > frames[-1].timestamp + 0.2:
            return None
        ts = np.array([f.timestamp for f in frames])
        i = int(np.clip(np.searchsorted(ts, t), 1, len(ts) - 1))
        a, b = frames[i - 1], frames[i]
        dt = max(b.timestamp - a.timestamp, 1e-9)
        w = np.clip((t - a.timestamp) / dt, 0.0, 1.0)
        return (1 - w) * a.T_WS[:3] + w * b.T_WS[:3]

    def _attempt_gps_alignment(self):
        """Closed-form yaw + translation fit of T_GW over the (estimated
        position, fix) pairs; needs gps_min_fixes pairs spread over
        gps_min_span of horizontal motion (yaw is unobservable without)."""
        pairs = []
        for t, pg, _ in self.gps_meas:
            pw = self._gps_state_pos(t)
            if pw is not None:
                pairs.append((pw, pg))
        if len(pairs) < self.gps_min_fixes:
            return
        PW = np.stack([q[0] for q in pairs])
        PG = np.stack([q[1] for q in pairs])
        if np.ptp(PW, axis=0)[:2].max() < self.gps_min_span:
            return
        # yaw maximising sum cos(yaw) (x.x' + y.y') + sin(yaw) (x.y' - y.x')
        cw = PW - PW.mean(0)
        cg = PG - PG.mean(0)
        a = float(np.sum(cw[:, 0] * cg[:, 0] + cw[:, 1] * cg[:, 1]))
        b = float(np.sum(cw[:, 0] * cg[:, 1] - cw[:, 1] * cg[:, 0]))
        q = se3np.delta_q(np.array([0.0, 0.0, np.arctan2(b, a)]))
        tr = PG.mean(0) - se3np.quat_to_matrix(q) @ PW.mean(0)
        self.T_GW = np.concatenate([tr, q])
        self.gps_status = "Initialised"

    def _check_gps_dropout(self, t_now: float):
        """Before each window solve: an Initialised alignment whose newest
        fix is older than gps_timeout is held (ReInitialising); once fixes
        are fresh again it is realigned."""
        if self.gps_status == "Initialised" and self.gps_meas:
            if t_now - self.gps_meas[-1][0] > self.gps_timeout:
                self.gps_status = "ReInitialising"
        elif self.gps_status == "ReInitialising" and self.gps_meas:
            if t_now - self.gps_meas[-1][0] < self.gps_timeout:
                self._attempt_gps_alignment()

    def _gps_rows(self, nf: int):
        """The window's GNSS rows: each of the newest `cap_gps` fixes since
        the oldest window frame on the newest frame at or before it, with
        the IMU bridge span from that frame to the fix.  Zero rows while
        GNSS is off, so a GNSS-free solve carries no GNSS family."""
        Gcap = self.cfg.cap_gps if self.gps_status != "Off" else 0
        gps_frame = np.zeros(Gcap, np.int64)
        gps_p_G = np.zeros((Gcap, 3))
        gps_si = np.tile(np.eye(3), (Gcap, 1, 1))
        gps_valid = np.zeros(Gcap, bool)
        spans = []
        if self.gps_status in ("Initialised", "ReInitialising") and nf:
            t_lo = self.frames[0].timestamp
            for t_g, pos_G, err in [m for m in self.gps_meas if m[0] >= t_lo][-Gcap:]:
                host = next((i for i in range(nf - 1, -1, -1)
                             if self.frames[i].timestamp <= t_g + 1e-9), None)
                if host is None:
                    continue
                hf = self.frames[host]
                g = len(spans)
                gps_frame[g] = host
                gps_p_G[g] = pos_G
                gps_si[g] = np.diag(1.0 / np.maximum(err, 1e-3))
                gps_valid[g] = True
                spans.append((hf.timestamp, max(t_g, hf.timestamp), hf.sb[3:6], hf.sb[6:9]))
        return gps_frame, gps_p_G, gps_si, gps_valid, spans

    def _ext_prior_si(self, final_ba: bool) -> np.ndarray:
        cfg = self.cfg
        sr, sa = ((cfg.extrinsics_sigma_r_final_ba, cfg.extrinsics_sigma_alpha_final_ba)
                  if final_ba else (cfg.extrinsics_sigma_r, cfg.extrinsics_sigma_alpha))
        return np.diag(np.concatenate([np.full(3, 1.0 / max(sr, 1e-9)),
                                       np.full(3, 1.0 / max(sa, 1e-9))]))

    # ------------------------------------------------------------- landmarks
    def add_landmark(self, hp_W) -> int:
        """New landmark id, or -1 when the capacity table is full."""
        if len(self.lm_ids) >= self.cfg.cap_landmarks:
            return -1
        lid = self._next_lid
        self._next_lid += 1
        self.lm_index[lid] = len(self.lm_ids)
        self.lm_ids.append(lid)
        self.hp_W = np.vstack([self.hp_W, np.asarray(hp_W, np.float64)[None]])
        return lid

    def add_observations_batch(self, fid: int, cam, lid, uv, sigma=None, depth=None,
                               depth_sigma=None):
        """Vectorised multi-observation add; `depth` with a positive
        `depth_sigma` attaches depth priors."""
        n = len(lid)
        if n == 0:
            return
        self.obs_fid = np.append(self.obs_fid, np.full(n, fid, np.int64))
        self.obs_cam = np.append(self.obs_cam, np.broadcast_to(np.asarray(cam, np.int64), (n,)))
        self.obs_lid = np.append(self.obs_lid, np.asarray(lid, np.int64))
        self.obs_uv = np.vstack([self.obs_uv, np.asarray(uv, np.float64).reshape(n, 2)])
        self.obs_sigma = np.append(
            self.obs_sigma,
            np.full(n, self.cfg.keypoint_sigma_px) if sigma is None
            else np.asarray(sigma, np.float64),
        )
        self.obs_depth = np.append(
            self.obs_depth, np.zeros(n) if depth is None else np.asarray(depth, np.float64))
        self.obs_depth_sigma = np.append(
            self.obs_depth_sigma,
            np.zeros(n) if depth_sigma is None else np.asarray(depth_sigma, np.float64))
        self.obs_uid = np.append(
            self.obs_uid, np.arange(self._obs_uid_next, self._obs_uid_next + n)
        )
        self._obs_uid_next += n

    def _keep_obs(self, keep: np.ndarray):
        for k in _OBS_COLS:
            setattr(self, k, getattr(self, k)[keep])

    def set_keyframe(self, fid: int, is_kf: bool = True):
        self._frame_by_id(fid).is_keyframe = is_kf

    def _frame_by_id(self, fid: int) -> FrameState:
        for f in self.frames:
            if f.fid == fid:
                return f
        raise KeyError(fid)

    # ------------------------------------------------------------- optimise
    def _build_problem(self):
        """Assemble the window problem on the device; returns (problem,
        fid -> slot, obs uids per problem row, whether a depth prior is
        live)."""
        cfg = self.cfg
        K, L, C = cfg.cap_frames, cfg.cap_landmarks, self.C
        Ncap, Mcap, Rcap = cfg.cap_obs, cfg.cap_imu_links, cfg.cap_rel_edges
        nf, nl = len(self.frames), len(self.lm_ids)
        if nf > K or nl > L:
            raise RuntimeError(f"{nf} frames / {nl} landmarks exceed capacity {K} / {L}")
        fid2slot = {f.fid: i for i, f in enumerate(self.frames)}

        T_full = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        sb_full = np.zeros((K, 9))
        if nf:
            T_full[:nf] = np.stack([f.T_WS for f in self.frames])
            sb_full[:nf] = np.stack([f.sb for f in self.frames])
        frame_valid = np.zeros(K, bool)
        frame_valid[:nf] = True
        pose_fixed = np.zeros(K, bool)
        pose_fixed[:nf] = [f.pose_fixed or (f.pose_graph_frame and not f.expanded)
                           for f in self.frames]
        sb_fixed = np.ones(K, bool)
        sb_fixed[:nf] = [f.pose_graph_frame or f.sb_fixed for f in self.frames]

        # observations whose frame and landmark are both live
        # (frame ids imported from elsewhere may lie beyond _next_fid)
        n_fid = max(self._next_fid, max(fid2slot, default=0) + 1,
                    int(self.obs_fid.max(initial=0)) + 1)
        slot_of = np.full(n_fid, -1, np.int64)
        for fid, s in fid2slot.items():
            slot_of[fid] = s
        row_of = np.full(max(self._next_lid, int(self.obs_lid.max(initial=0)) + 1), -1, np.int64)
        row_of[np.asarray(self.lm_ids, np.int64)] = np.arange(nl)
        obs_slot = slot_of[self.obs_fid]
        obs_row = row_of[self.obs_lid]
        live = (obs_slot >= 0) & (obs_row >= 0)
        obs_src = np.nonzero(live)[0]
        if len(obs_src) > Ncap:
            logging.warning("window observations %d exceed capacity %d — dropping oldest",
                            len(obs_src), Ncap)
            obs_src = obs_src[-Ncap:]
        n_obs = len(obs_src)
        obs_frame = np.zeros(Ncap, np.int64)
        obs_cam = np.zeros(Ncap, np.int64)
        obs_lm = np.zeros(Ncap, np.int64)
        obs_uv = np.zeros((Ncap, 2))
        obs_si = np.ones(Ncap)
        obs_valid = np.zeros(Ncap, bool)
        obs_frame[:n_obs] = obs_slot[obs_src]
        obs_cam[:n_obs] = self.obs_cam[obs_src]
        obs_lm[:n_obs] = obs_row[obs_src]
        obs_uv[:n_obs] = self.obs_uv[obs_src]
        obs_si[:n_obs] = 1.0 / self.obs_sigma[obs_src]
        obs_valid[:n_obs] = True
        obs_depth = np.ones(Ncap)
        obs_depth_si = np.ones(Ncap)
        obs_depth_valid = np.zeros(Ncap, bool)
        dsig = self.obs_depth_sigma[obs_src]
        has_d = dsig > 0
        obs_depth[:n_obs] = np.where(has_d, self.obs_depth[obs_src], 1.0)
        obs_depth_si[:n_obs] = np.where(has_d, 1.0 / np.maximum(dsig, 1e-12), 1.0)
        obs_depth_valid[:n_obs] = has_d

        # IMU links between consecutive chain frames, from the link cache
        chain = [i for i, f in enumerate(self.frames) if not f.pose_graph_frame]
        imu_i = np.zeros(Mcap, np.int64)
        imu_j = np.zeros(Mcap, np.int64)
        imu_valid = np.zeros(Mcap, bool)
        link_rows = []
        for m, (ia, ib) in enumerate(zip(chain[:-1], chain[1:])):
            if m >= Mcap:
                raise RuntimeError(f"more than {Mcap} IMU links in the window")
            link_rows.append(self._link_for(self.frames[ia], self.frames[ib]))
            imu_i[m], imu_j[m], imu_valid[m] = ia, ib, True
        imu_pre_b, imu_W_b = self._stack_links(link_rows, Mcap)

        hp = np.tile(np.array([0, 0, 0, 1.0]), (L, 1))
        hp[:nl] = self.hp_W
        lm_valid = np.zeros(L, bool)
        lm_valid[:nl] = True

        pose_prior_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        pose_prior_si = np.tile(np.eye(6), (K, 1, 1))
        pose_prior_valid = np.zeros(K, bool)
        sb_prior = np.zeros((K, 9))
        sb_prior_si = np.tile(np.eye(9), (K, 1, 1))
        sb_prior_valid = np.zeros(K, bool)
        if self.prior_fid is not None and self.prior_fid in fid2slot:
            s = fid2slot[self.prior_fid]
            pose_prior_T[s] = self.prior_T
            pose_prior_si[s] = self.prior_sqrt_info
            pose_prior_valid[s] = True
            sb_prior[s] = self.prior_sb
            sb_prior_si[s] = self.prior_sb_sqrt_info
            sb_prior_valid[s] = True
        # weak damping prior (sigma 10 m / 3.3 rad) on every held
        # loop-closure frame, anchored at its pre-hold pose: such a frame has
        # no IMU chain, only restored observations, and once merges or
        # outlier cuts leave it under-constrained the robust loss lets the
        # solver scatter it for almost no cost (the JAX package measured
        # frames parked up to 1394 m out); constrained frames refine
        # through a prior orders of magnitude weaker than their observations
        damp_si = np.diag([0.1, 0.1, 0.1, 0.3, 0.3, 0.3])
        for sl, fr in enumerate(self.frames):
            if (fr.pose_graph_frame and fr.expanded and not fr.pose_fixed
                    and not pose_prior_valid[sl]):
                pose_prior_T[sl] = fr.pre_hold_T if fr.pre_hold_T is not None else fr.T_WS
                pose_prior_si[sl] = damp_si
                pose_prior_valid[sl] = True

        # relative pose edges (weakest dropped beyond capacity)
        if len(self.rel_edges) > Rcap:
            self.rel_edges.sort(key=lambda e: -float(np.trace(e["sqrt_info"])))
            self.rel_edges = self.rel_edges[:Rcap]
        rel_i = np.zeros(Rcap, np.int64)
        rel_j = np.zeros(Rcap, np.int64)
        rel_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (Rcap, 1))
        rel_si = np.tile(np.eye(6), (Rcap, 1, 1))
        rel_valid = np.zeros(Rcap, bool)
        nrel = 0
        for e in self.rel_edges:
            if e["i"] in fid2slot and e["j"] in fid2slot:
                rel_i[nrel], rel_j[nrel] = fid2slot[e["i"]], fid2slot[e["j"]]
                rel_T[nrel] = e["T_ij"]
                rel_si[nrel] = e["sqrt_info"]
                rel_valid[nrel] = True
                nrel += 1

        gps_frame, gps_p_G, gps_si, gps_valid, gps_spans = self._gps_rows(nf)
        Gcap = len(gps_valid)
        self.n_gps_solves += bool(gps_spans)

        dev = self.device
        F = lambda x: torch.as_tensor(x, dtype=cfg.dtype, device=dev)  # noqa: E731
        I = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        p = prb.empty_problem(K=K, L=L, C=C, N=Ncap, M=Mcap, R=Rcap, G=Gcap, Q=cfg.cap_icp,
                              dtype=cfg.dtype, device=dev)
        if Gcap:
            p = p._replace(
                T_GW=F(self.T_GW), tgw_fixed=I(np.asarray(self.gps_status != "Initialised")),
                gps_frame=I(gps_frame), gps_p_G=F(gps_p_G), gps_r_SA=F(self.gps_r_SA),
                gps_sqrt_info=F(gps_si), gps_valid=I(gps_valid),
            )
        if gps_spans:
            # the bridges preintegrate on the device, without whitening (rows
            # without a fix keep the identity: they are masked).  The JAX
            # package pads each bridge to cap_imu_samples; masked steps are
            # exact no-ops, so the buffer is fitted to the longest bridge (a
            # bridge spans at most a frame gap), which gives the same result
            # with a fraction of the per-sample launches
            n_max = max(i1 - i0 for i0, i1 in (self._imu_span(t0, t1)
                                               for t0, t1, _, _ in gps_spans))
            S = 8
            while S < min(n_max, cfg.cap_imu_samples):
                S *= 2
            gps_pre, _ = self._preintegrate_batch(gps_spans, Gcap, S=min(S, cfg.cap_imu_samples))
            p = p._replace(gps_pre=gps_pre)
        if cfg.do_extrinsics:
            p = p._replace(
                ext_fixed=I(np.zeros(C, bool)), ext_prior_T=F(self.T_SC_prior),
                ext_prior_sqrt_info=F(np.tile(self._ext_prior_si(False), (C, 1, 1))),
                ext_prior_valid=I(np.ones(C, bool)),
            )
        if cfg.cap_icp and self.icp_map is not None and self.icp_live:
            a_fid, b_fid, pts_S, sig = self.icp_live
            if a_fid in fid2slot and b_fid in fid2slot:
                Qc = cfg.cap_icp
                n = min(len(pts_S), Qc)
                icp_p = np.zeros((Qc, 3))
                icp_p[:n] = np.asarray(pts_S)[:n]
                icp_valid = np.zeros(Qc, bool)
                icp_valid[:n] = True
                p = p._replace(
                    icp_a=I(np.full(Qc, fid2slot[a_fid], np.int64)),
                    icp_b=I(np.full(Qc, fid2slot[b_fid], np.int64)),
                    icp_p_B=F(icp_p), icp_si=F(np.full(Qc, 1.0 / max(sig, 1e-3))),
                    icp_valid=I(icp_valid), icp_map=self.icp_map)
        p = p._replace(
            T_WS=F(T_full), sb=F(sb_full), frame_valid=I(frame_valid),
            pose_fixed=I(pose_fixed), sb_fixed=I(sb_fixed), T_SC=F(self.T_SC),
            hp_W=F(hp), lm_valid=I(lm_valid),
            obs_frame=I(obs_frame), obs_cam=I(obs_cam), obs_lm=I(obs_lm),
            obs_uv=F(obs_uv), obs_sqrt_info=F(obs_si), obs_valid=I(obs_valid),
            obs_depth=F(obs_depth), obs_depth_si=F(obs_depth_si),
            obs_depth_valid=I(obs_depth_valid), imu_i=I(imu_i), imu_j=I(imu_j),
            imu_valid=I(imu_valid),
            imu_pre=pre.Preintegrated(*[F(x) for x in imu_pre_b]),
            imu_sqrt_info=F(imu_W_b),
            pose_prior_T=F(pose_prior_T), pose_prior_sqrt_info=F(pose_prior_si),
            pose_prior_valid=I(pose_prior_valid), sb_prior=F(sb_prior),
            sb_prior_sqrt_info=F(sb_prior_si), sb_prior_valid=I(sb_prior_valid),
            rel_i=I(rel_i), rel_j=I(rel_j), rel_T=F(rel_T),
            rel_sqrt_info=F(rel_si), rel_valid=I(rel_valid),
        )
        return p, fid2slot, self.obs_uid[obs_src], bool(has_d.any())

    def set_icp_map(self, sm, grid_cfg):
        """Register the active submap (and its grid config) as the target of
        the live ICP rows."""
        self.icp_map = sm
        self.icp_grid_cfg = grid_cfg

    def set_live_icp_points(self, anchor_fid: int, owner_fid: int, pts_S: np.ndarray,
                            sigma: float):
        """Replace the live frame-to-map points (the previous sweep's rows are
        dropped, as the reference refreshes its live factors each frame)."""
        self.icp_live = (anchor_fid, owner_fid, np.asarray(pts_S), sigma)

    def _solver_config(self, iters: int, use_depth: bool = False,
                       use_icp: bool = False) -> gn.SolverConfig:
        return gn.SolverConfig(
            max_iterations=iters, imu_params=self.cfg.imu,
            early_exit_rel=self.cfg.early_exit_rel,
            use_ext_priors=self.cfg.do_extrinsics, use_depth=use_depth,
            icp_cfg=self.icp_grid_cfg if use_icp else None,
        )

    def _clamp_held(self, fr: FrameState, T_new: np.ndarray) -> np.ndarray:
        """Writeback guard for held loop-closure frames: a result more than
        8 m from the pre-hold anchor is scatter of an under-constrained pose,
        not a correction, so the anchor is kept."""
        if fr.pre_hold_T is not None and np.linalg.norm(
                np.asarray(T_new)[:3] - fr.pre_hold_T[:3]) > 8.0:
            return np.asarray(fr.pre_hold_T, np.float64).copy()
        return T_new

    def _writeback_calibration(self, p_opt):
        """The calibrated extrinsics (online calibration) and the GNSS
        alignment (while Initialised) of a solved window."""
        if self.cfg.do_extrinsics:
            self.T_SC = p_opt.T_SC.cpu().numpy().astype(np.float64)
        if self.gps_status == "Initialised":
            self.T_GW = p_opt.T_GW.cpu().numpy().astype(np.float64)

    def _writeback(self, p_opt, fid2slot):
        T = p_opt.T_WS.cpu().numpy().astype(np.float64)
        sb = p_opt.sb.cpu().numpy().astype(np.float64)
        hp = p_opt.hp_W.cpu().numpy().astype(np.float64)
        for fr_id, slot in fid2slot.items():
            fr = self._frame_by_id(fr_id)
            fr.T_WS = self._clamp_held(fr, T[slot])
            fr.sb = sb[slot]
        self.hp_W = hp[: len(self.lm_ids)]
        self._writeback_calibration(p_opt)

    def optimise(self, iterations: Optional[int] = None, pose_only: bool = False) -> float:
        """Ungated window solve with writeback (after a loop closure; with
        `pose_only` the inline pose refinement between association and the
        window solve: landmarks held, poses and speed/bias free); returns
        the final cost."""
        iters = iterations or self.cfg.max_iterations
        if self.frames:
            self._check_gps_dropout(self.frames[-1].timestamp)
        with timing.Timer("3.1 BuildProblem"):
            p, fid2slot, _, use_depth = self._build_problem()
        cfg = self._solver_config(iters, use_depth, p.icp_map is not None)._replace(
            estimate_landmarks=not pose_only)
        with timing.Timer("3.2 SolveDevice"):
            p_opt, cost = gn.optimize(p, self.cams, cfg)
            cost = float(cost)
        with timing.Timer("3.3 Readback"):
            self._writeback(p_opt, fid2slot)
        return cost

    def optimise_gated_dispatch(self, fid: int, gate_px: float,
                                iterations: Optional[int] = None, iterations2: int = 2) -> dict:
        """Build the gated window solve of frame `fid` and return its handle
        for `optimise_gated_collect`; `iterations` None is the realtime
        budget's current bucket (`_rt_iters`).

        The handle keeps the problem as built here, the frame slots, the
        observation uid of each problem row and the landmark ids of its
        rows; the solve itself runs when the handle is collected.  Between
        the two the host may only append frames, landmarks and observations
        (association does): the writeback goes by frame id, landmark id and
        observation uid."""
        iters = iterations or self._rt_iters
        if self.frames:
            self._check_gps_dropout(self.frames[-1].timestamp)
        with timing.Timer("3.1 BuildProblem"):
            p, fid2slot, obs_uids, use_depth = self._build_problem()
        return dict(p=p, fid2slot=fid2slot, obs_uids=obs_uids, use_depth=use_depth,
                    use_icp=p.icp_map is not None, fid=fid,
                    gate_px=float(gate_px),
                    iters=iters, iters2=iterations2,
                    lm_lids=np.array(self.lm_ids, np.int64))

    def optimise_gated_collect(self, h: dict):
        """Solve a dispatched handle: window solve, chi2 gate on the
        observations of its frame, short re-solve without the flagged rows;
        then write back the poses and speed/bias of the frames still in the
        window, the landmarks by id, and remove the flagged observations by
        uid.  Returns (cost, n_outliers)."""
        p, fid2slot = h["p"], h["fid2slot"]
        with timing.Timer("3.2 SolveDevice"):
            p1, _ = gn.optimize(p, self.cams, self._solver_config(h["iters"], h["use_depth"],
                                                                  h["use_icp"]))
            f, c, l = p1.obs_frame, p1.obs_cam, p1.obs_lm
            r, proj_ok = reprojection_residual(
                self.cams.at(c), p1.T_WS[f], p1.T_SC[c], p1.hp_W[l], p1.obs_uv,
                p1.obs_sqrt_info,
            )
            err_px = torch.linalg.norm(r, dim=-1) / torch.clamp(p1.obs_sqrt_info, min=1e-12)
            out = (p1.obs_valid & (f == fid2slot.get(h["fid"], -1))
                   & (~proj_ok | (err_px > h["gate_px"])))
            p2 = p1._replace(obs_valid=p1.obs_valid & ~out)
            p3, cost = gn.optimize(p2, self.cams,
                                   self._solver_config(h["iters2"], h["use_depth"],
                                                       h["use_icp"]))
        with timing.Timer("3.3 Readback"):
            T = p3.T_WS.cpu().numpy().astype(np.float64)
            sb = p3.sb.cpu().numpy().astype(np.float64)
            hp = p3.hp_W.cpu().numpy().astype(np.float64)
            out_rows = np.nonzero(out.cpu().numpy())[0]
            cost = float(cost)
            live = {fr.fid for fr in self.frames}
            for fr_id, slot in fid2slot.items():
                if fr_id not in live:
                    continue
                fr = self._frame_by_id(fr_id)
                fr.T_WS = self._clamp_held(fr, T[slot])
                fr.sb = sb[slot]
            # landmarks by id: rows map through the dispatch-time ids, so a
            # landmark pruned or moved since lands in its row or nowhere
            snap = h["lm_lids"]
            if len(snap):
                tgt = np.array([self.lm_index.get(int(lid), -1) for lid in snap], np.int64)
                ok = tgt >= 0
                self.hp_W[tgt[ok]] = hp[:len(snap)][ok]
            self._writeback_calibration(p3)
        obs_uids = h["obs_uids"]
        if len(out_rows):
            # outliers by uid: row indices shift, uids do not
            bad = obs_uids[out_rows[out_rows < len(obs_uids)]]
            self._keep_obs(~np.isin(self.obs_uid, bad))
        return cost, len(out_rows)

    def optimise_gated(self, fid: int, gate_px: float, iterations: Optional[int] = None,
                       iterations2: int = 2):
        """Window solve, chi2 gate on the observations of frame `fid`, short
        re-solve without the flagged rows; writes poses, speed/bias and
        landmarks back and removes the flagged observations.  Returns
        (cost, n_outliers)."""
        return self.optimise_gated_collect(
            self.optimise_gated_dispatch(fid, gate_px, iterations, iterations2))

    def adapt_realtime_budget(self, solve_wall_s: float) -> bool:
        """Feed one measured realtime-solve wall time into the budget
        controller: while the EMA of the times overruns
        `realtime_time_limit`, the next solves step down an iteration bucket
        (max -> midpoint -> min_iterations); on sustained slack (EMA under
        half the limit) they step back up.  Returns whether this sample
        overran the limit; a limit of 0 disables the controller."""
        cfg = self.cfg
        limit = cfg.realtime_time_limit
        if not limit:
            return False
        self._rt_ema = 0.7 * self._rt_ema + 0.3 * solve_wall_s
        over = solve_wall_s > limit
        if over:
            self.n_budget_overruns += 1
        buckets = sorted({cfg.min_iterations, (cfg.min_iterations + cfg.max_iterations) // 2,
                          cfg.max_iterations})
        i = min(range(len(buckets)), key=lambda k: abs(buckets[k] - self._rt_iters))
        if self._rt_ema > limit and i > 0:
            self._rt_iters = buckets[i - 1]
        elif self._rt_ema < 0.5 * limit and i < len(buckets) - 1:
            self._rt_iters = buckets[i + 1]
        return over

    # -------------------------------------------------------- marginalisation
    def _drop_frame(self, fid: int):
        idx = next(i for i, f in enumerate(self.frames) if f.fid == fid)
        self.frames.pop(idx)
        self._keep_obs(self.obs_fid != fid)

    def _prune_landmarks(self):
        """Remove landmarks with no remaining observations (their positions
        are snapshotted)."""
        seen = set(self.obs_lid.tolist())
        keep_rows = []
        for i, lid in enumerate(self.lm_ids):
            if lid in seen:
                keep_rows.append(i)
            else:
                self.arch_lm[lid] = self.hp_W[i].copy()
        self.lm_ids = [self.lm_ids[i] for i in keep_rows]
        self.hp_W = self.hp_W[keep_rows]
        self.lm_index = {lid: i for i, lid in enumerate(self.lm_ids)}

    def marginalise(self):
        """Apply the window policy:
          1. drop surplus old non-keyframes (IMU-chain merge);
          2. convert surplus keyframes into frozen pose-graph frames with
             two-pose edges (victim: least covisible with the newest);
          3. archive the oldest pose-graph frames beyond frame capacity;
          4. prune landmarks without observations."""
        cfg = self.cfg
        while True:
            old = self.frames[: -cfg.num_imu_frames] if cfg.num_imu_frames else self.frames
            candidates = [f for f in old if not f.is_keyframe and not f.pose_graph_frame]
            if not candidates:
                break
            self._merge_chain_link(candidates[0].fid)
            self._drop_frame(candidates[0].fid)

        while True:
            kfs = [
                f for f in self.frames[: -cfg.num_imu_frames]
                if f.is_keyframe and not f.pose_graph_frame
            ]
            if len(kfs) <= cfg.num_keyframes:
                break
            cov = self._covis_matrix([f.fid for f in kfs])
            ref_i = len(kfs) - 1
            scores = cov[:ref_i, ref_i]
            victim = kfs[int(np.argmin(scores))] if len(scores) else kfs[0]
            self._marginalise_keyframe(victim)

        while len(self.frames) > cfg.cap_frames - 1:
            pg = [f for f in self.frames
                  if f.pose_graph_frame and f.fid not in self.lc_protected]
            if not pg:
                # only held loop-closure frames left: release the oldest
                # rather than overflow the fixed capacities
                pg = [f for f in self.frames if f.pose_graph_frame]
                if not pg:
                    break
                self.lc_protected.discard(pg[0].fid)
            self._archive_frame(pg[0])

        self._prune_landmarks()
        self._prune_imu_links()
        self._trim_imu_buffer()

    def _covis_matrix(self, fids):
        """(n, n) covisibility counts among `fids` over the live observations."""
        n = len(fids)
        idx = {f: i for i, f in enumerate(fids)}
        sel = np.isin(self.obs_fid, list(fids))
        if not sel.any():
            return np.zeros((n, n))
        fi = np.array([idx[int(f)] for f in self.obs_fid[sel]])
        pairs = np.unique(np.stack([fi, self.obs_lid[sel]], axis=1), axis=0)
        _, lm_inv = np.unique(pairs[:, 1], return_inverse=True)
        M = np.zeros((n, lm_inv.max() + 1), np.float32)
        M[pairs[:, 0], lm_inv] = 1.0
        return M @ M.T

    def _dispatch_two_pose_edges(self, victim: FrameState, targets) -> Optional[dict]:
        """Launch the TwoPoseGraphError-style edges victim -> target for up
        to 3 targets on the estimator's device without reading them back.
        Co-observations are capped at 128 landmarks and subsampled to 512
        observations an edge.  Returns a job, dict(victim_fid, target_fids,
        out), whose `out` is a (3, 44) tensor of rows [T_ab (7) | sqrt_info
        (36) | strength] (zeros where `target_fids` is None), or None."""
        B, ncap, lcap = 3, 512, 128
        targets = list(targets)[:B]
        if not targets:
            return None
        dev, dtype = self.device, self.cfg.dtype
        F = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
        I = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)  # noqa: E731
        va = self.obs_fid == victim.fid
        zero = torch.zeros(44, dtype=dtype, device=dev)
        rows, target_fids = [], []
        for target in targets:
            vb = self.obs_fid == target.fid
            shared = set(self.obs_lid[va]) & set(self.obs_lid[vb])
            shared = [l for l in shared if l in self.lm_index][:lcap]
            if not shared:
                rows.append(zero)
                target_fids.append(None)
                continue
            lrow = {l: i for i, l in enumerate(shared)}
            sel = np.nonzero((va | vb) & np.isin(self.obs_lid, list(shared)))[0]
            if len(sel) > ncap:
                sel = sel[:: len(sel) // ncap + 1][:ncap]
            T_ab, W, strength = two_pose_edge(
                self.cams, F(victim.T_WS), F(target.T_WS), F(self.T_SC),
                F(self.hp_W[[self.lm_index[l] for l in shared]]),
                torch.ones(len(shared), dtype=torch.bool, device=dev),
                I(self.obs_fid[sel] == target.fid), I(self.obs_cam[sel]),
                I([lrow[l] for l in self.obs_lid[sel]]), F(self.obs_uv[sel]),
                F(1.0 / self.obs_sigma[sel]),
                torch.ones(len(sel), dtype=torch.bool, device=dev),
            )
            rows.append(torch.cat([T_ab, W.reshape(36), strength.reshape(1)]))
            target_fids.append(target.fid)
        if all(t is None for t in target_fids):
            return None
        rows += [zero] * (B - len(rows))
        return dict(victim_fid=victim.fid, target_fids=target_fids, out=torch.stack(rows))

    def _collect_two_pose_edges(self, job: dict, out_np: Optional[np.ndarray] = None
                                ) -> List[dict]:
        """The edges of a dispatched job (read back here unless `out_np`,
        its rows on the host, is given); edges of strength below 1e-3 are
        dropped."""
        out = job["out"].cpu().numpy() if out_np is None else np.asarray(out_np)
        edges = []
        for r, target_fid in enumerate(job["target_fids"]):
            if target_fid is None:
                continue
            strength = float(out[r, 43])
            if not np.isfinite(strength) or strength < 1e-3:
                continue
            edges.append(dict(
                i=job["victim_fid"], j=target_fid,
                T_ij=out[r, :7].astype(np.float64),
                sqrt_info=out[r, 7:43].reshape(6, 6).astype(np.float64),
                marg=True,
            ))
        return edges

    def _compute_two_pose_edges(self, victim: FrameState, targets) -> List[dict]:
        """The two-pose edges victim -> target for up to 3 targets, at once."""
        job = self._dispatch_two_pose_edges(victim, targets)
        return [] if job is None else self._collect_two_pose_edges(job)

    def apply_pending_edges(self, job: dict, out_np: np.ndarray) -> int:
        """Fold a deferred edge job, its rows `out_np` read back, into the
        graph: edges whose endpoints left the window meanwhile go to the
        archive.  Returns how many edges were added."""
        edges = self._collect_two_pose_edges(job, out_np)
        live = {f.fid for f in self.frames}
        for e in edges:
            (self.rel_edges if e["i"] in live and e["j"] in live else self.archive_edges).append(e)
        return len(edges)

    def _marginalise_keyframe(self, victim: FrameState):
        """Summarise the keyframe into relative-pose edges along the maximum
        spanning tree of {victim ∪ surviving keyframes} weighted by
        covisibility, then freeze it as a pose-graph frame."""
        kfs = [
            f for f in self.frames
            if f.is_keyframe and not f.pose_graph_frame and f.fid != victim.fid
        ]
        nodes = [victim] + kfs
        fids = [f.fid for f in nodes]
        C = self._covis_matrix(fids)
        cov_edges = [
            (fids[a], fids[b], float(C[a, b]))
            for a in range(len(nodes)) for b in range(a + 1, len(nodes))
            if C[a, b] >= 3
        ]
        mst = max_spanning_tree(cov_edges)
        targets = [j if i == victim.fid else i for (i, j, _) in mst if victim.fid in (i, j)]
        by_fid = {f.fid: f for f in kfs}
        edge_targets = [by_fid[t] for t in targets[:3]]
        if not edge_targets and len(nodes) > 1:
            bi = int(np.argmax(C[0, 1:])) + 1
            if C[0, bi] >= 3:
                edge_targets = [nodes[bi]]
        if self.defer_edge_jobs:
            # launched only: the pipeline folds the edges in one cycle later,
            # so the solve in between runs without them (and without the
            # retry below, which needs their strengths)
            job = self._dispatch_two_pose_edges(victim, edge_targets)
            if job is not None:
                self.pending_edge_jobs.append(job)
        else:
            edges = self._compute_two_pose_edges(victim, edge_targets)
            if not edges and len(nodes) > 1:
                bi = int(np.argmax(C[0, 1:])) + 1
                if C[0, bi] >= 3:
                    edges = self._compute_two_pose_edges(victim, [nodes[bi]])
            self.rel_edges.extend(edges)
        self._merge_chain_link(victim.fid)
        victim.pose_graph_frame = True
        # the edges summarise the observations in the window; the final BA
        # and loop closure re-expand them from the archive
        gone = self.obs_fid == victim.fid
        self._archive_obs(gone)
        self._keep_obs(~gone)

    def _archive_frame(self, victim: FrameState):
        """Move a window pose-graph frame and its edges to the long-term
        graph; a held (expanded) frame first returns its live observations
        to the archive and freezes again."""
        if victim.expanded:
            self._archive_obs(self.obs_fid == victim.fid)
            victim.expanded = False
            victim.pose_fixed = True
        self.archive_frames[victim.fid] = victim
        self._drop_frame(victim.fid)
        keep = []
        for e in self.rel_edges:
            if victim.fid in (e["i"], e["j"]):
                self.archive_edges.append(e)
            else:
                keep.append(e)
        self.rel_edges = keep

    # -- archived observations (growable stores read through views) ------
    @property
    def arch_obs_fid(self):
        return self._arch_obs_i[:self._arch_obs_n, 0]

    @property
    def arch_obs_cam(self):
        return self._arch_obs_i[:self._arch_obs_n, 1]

    @property
    def arch_obs_lid(self):
        return self._arch_obs_i[:self._arch_obs_n, 2]

    @property
    def arch_obs_uv(self):
        return self._arch_obs_f[:self._arch_obs_n, 0:2]

    @property
    def arch_obs_sigma(self):
        return self._arch_obs_f[:self._arch_obs_n, 2]

    @property
    def arch_obs_depth(self):
        return self._arch_obs_f[:self._arch_obs_n, 3]

    @property
    def arch_obs_depth_sigma(self):
        return self._arch_obs_f[:self._arch_obs_n, 4]

    def _arch_obs_reserve(self, need: int):
        if need > len(self._arch_obs_i):
            cap = max(need, 2 * len(self._arch_obs_i))
            bi = np.zeros((cap, 3), np.int64)
            bf = np.zeros((cap, 5))
            bi[: self._arch_obs_n] = self._arch_obs_i[: self._arch_obs_n]
            bf[: self._arch_obs_n] = self._arch_obs_f[: self._arch_obs_n]
            self._arch_obs_i, self._arch_obs_f = bi, bf

    def _archive_obs(self, mask: np.ndarray):
        """Append the live observations selected by `mask` to the archive
        (the live rows are left for the caller to drop)."""
        k = int(mask.sum())
        if k == 0:
            return
        need = self._arch_obs_n + k
        self._arch_obs_reserve(need)
        sl = slice(self._arch_obs_n, need)
        self._arch_obs_i[sl, 0] = self.obs_fid[mask]
        self._arch_obs_i[sl, 1] = self.obs_cam[mask]
        self._arch_obs_i[sl, 2] = self.obs_lid[mask]
        self._arch_obs_f[sl, 0:2] = self.obs_uv[mask]
        self._arch_obs_f[sl, 2] = self.obs_sigma[mask]
        self._arch_obs_f[sl, 3] = self.obs_depth[mask]
        self._arch_obs_f[sl, 4] = self.obs_depth_sigma[mask]
        self._arch_obs_n = need

    def archive_observation(self, fid: int, cam: int, lid: int, uv, sigma: float = 1.0,
                            depth: float = 0.0, depth_sigma: float = 0.0):
        """Append one row to the archived-observation store (map import and
        tests; the runtime path archives in bulk with `_archive_obs`)."""
        n = self._arch_obs_n
        self._arch_obs_reserve(n + 1)
        self._arch_obs_i[n] = (fid, cam, lid)
        self._arch_obs_f[n, 0:2] = uv
        self._arch_obs_f[n, 2:5] = (sigma, depth, depth_sigma)
        self._arch_obs_n = n + 1

    def _arch_obs_compact(self, keep: np.ndarray):
        """Drop archived observation rows where `keep` is False."""
        n = self._arch_obs_n
        k = int(keep.sum())
        self._arch_obs_i[:k] = self._arch_obs_i[:n][keep]
        self._arch_obs_f[:k] = self._arch_obs_f[:n][keep]
        self._arch_obs_n = k

    # ----------------------------------------------------- loop closure
    def pose_graph(self):
        """All known keyframe poses (archived and windowed) and relative
        edges, time-ordered: the long-term pose graph."""
        nodes: List[FrameState] = sorted(
            list(self.archive_frames.values())
            + [f for f in self.frames if f.is_keyframe or f.pose_graph_frame],
            key=lambda f: f.timestamp,
        )
        return nodes, list(self.archive_edges) + list(self.rel_edges)

    def add_loop_edge(self, fid_cur: int, fid_cand: int, T_cand_cur: np.ndarray,
                      sqrt_info: np.ndarray) -> bool:
        """Persist an accepted loop-closure constraint as a long-term
        pose-graph edge."""
        known = {f.fid for f in self.frames} | set(self.archive_frames)
        if fid_cur not in known or fid_cand not in known:
            return False
        self.archive_edges.append(dict(
            i=fid_cand, j=fid_cur, T_ij=np.asarray(T_cand_cur, np.float64),
            sqrt_info=np.asarray(sqrt_info, np.float64), loop=True,
        ))
        return True

    def _restore_landmark(self, lid: int) -> bool:
        """Bring an archived landmark back into the live store (refused at
        capacity: the caller then restores fewer observations)."""
        if lid in self.lm_index:
            return True
        if len(self.lm_ids) >= self.cfg.cap_landmarks:
            return False
        hp = self.arch_lm.pop(lid, None)
        if hp is None:
            return False
        self.lm_index[lid] = len(self.lm_ids)
        self.lm_ids.append(lid)
        self.hp_W = np.vstack([self.hp_W, np.asarray(hp)[None]])
        return True

    def expand_keyframe(self, fid: int, max_restore: Optional[int] = None) -> int:
        """Turn a window pose-graph frame's summary back into live
        observations: restore its archived observations and landmarks, drop
        the marginalisation edges that summarised them, and let the pose
        optimise again.  Returns the number of observations restored."""
        f = self._frame_by_id(fid)
        take = np.nonzero(self.arch_obs_fid == fid)[0]
        # never restore past the observation capacity (headroom is kept for
        # the next frame's associations)
        headroom = (self.cfg.cap_obs - len(self.obs_fid)
                    - min(1024, self.cfg.cap_obs // 4))
        max_restore = min(max_restore if max_restore is not None else len(take),
                          max(headroom, 0))
        if len(take) > max_restore:
            # prefer observations of landmarks already live: they couple the
            # expanded frame to the window
            live_first = sorted(
                take.tolist(), key=lambda i: int(self.arch_obs_lid[i]) not in self.lm_index)
            take = np.asarray(live_first[:max_restore], np.int64)
        keep_idx = [int(i) for i in take
                    if self._restore_landmark(int(self.arch_obs_lid[i]))]
        if keep_idx:
            ki = np.asarray(keep_idx)
            n = len(ki)
            self.obs_fid = np.append(self.obs_fid, self.arch_obs_fid[ki])
            self.obs_cam = np.append(self.obs_cam, self.arch_obs_cam[ki])
            self.obs_lid = np.append(self.obs_lid, self.arch_obs_lid[ki])
            self.obs_uv = np.vstack([self.obs_uv, self.arch_obs_uv[ki]])
            self.obs_sigma = np.append(self.obs_sigma, self.arch_obs_sigma[ki])
            self.obs_depth = np.append(self.obs_depth, self.arch_obs_depth[ki])
            self.obs_depth_sigma = np.append(self.obs_depth_sigma, self.arch_obs_depth_sigma[ki])
            self.obs_uid = np.append(
                self.obs_uid, np.arange(self._obs_uid_next, self._obs_uid_next + n))
            self._obs_uid_next += n
        if len(take):
            inv = np.ones(self._arch_obs_n, bool)
            inv[take] = False
            self._arch_obs_compact(inv)
        # the summarising two-pose edges would count the observations twice
        drop = lambda e: e.get("marg") and fid in (e["i"], e["j"])  # noqa: E731
        self.rel_edges = [e for e in self.rel_edges if not drop(e)]
        self.archive_edges = [e for e in self.archive_edges if not drop(e)]
        if f.pose_graph_frame:
            f.expanded = True
            f.pose_fixed = False
        return len(keep_idx)

    def add_loopclosure_frame(self, fid: int, max_restore: Optional[int] = None) -> bool:
        """Bring an archived keyframe back into the window as an expanded
        pose-graph frame, so that its landmarks can be re-observed and
        merged."""
        if any(f.fid == fid for f in self.frames):
            self.expand_keyframe(fid, max_restore)
            return True
        f = self.archive_frames.pop(fid, None)
        if f is None:
            return False
        f.pre_hold_T = f.T_WS.copy()
        # the window may sit at capacity (marginalise trims only at frame
        # boundaries): archive the oldest unprotected pose-graph frame
        # first, and refuse when there is none
        while len(self.frames) >= self.cfg.cap_frames - 1:
            pg = [fr for fr in self.frames
                  if fr.pose_graph_frame and fr.fid not in self.lc_protected]
            if not pg:
                self.archive_frames[fid] = f
                return False
            self._archive_frame(pg[0])
        f.pose_graph_frame = True
        f.pose_fixed = False
        self.frames.append(f)
        self.frames.sort(key=lambda fr: fr.timestamp)
        self.lc_protected.add(fid)
        self.expand_keyframe(fid, max_restore)
        return True

    def remove_loopclosure_frame(self, fid: int) -> bool:
        """Re-archive a held loop-closure frame: its observations return to
        the archive and it leaves the window.  False when the frame is no
        longer in the window."""
        try:
            f = self._frame_by_id(fid)
        except KeyError:
            return False
        gone = self.obs_fid == fid
        self._archive_obs(gone)
        self._keep_obs(~gone)
        f.expanded = False
        f.pose_fixed = True
        if f.pre_hold_T is not None:
            moved = float(np.linalg.norm(f.T_WS[:3] - f.pre_hold_T[:3]))
            if moved > 8.0:
                # the held frame scattered in the window: re-archiving that
                # pose would poison every later pose-graph solve, and a
                # real correction is bounded by the drift budget
                logging.warning("loop-closure frame %d re-archived with pre-hold pose:"
                                " window moved it %.1f m", fid, moved)
                f.T_WS = f.pre_hold_T.copy()
            f.pre_hold_T = None
        self.frames.remove(f)
        self.archive_frames[fid] = f
        self.lc_protected.discard(fid)
        self._prune_landmarks()
        return True

    def merge_landmarks(self, lid_keep: int, lid_drop: int) -> bool:
        """Merge two landmarks recognised as one point after a loop closure:
        every live and archived observation of `lid_drop` re-points to
        `lid_keep`."""
        if lid_keep == lid_drop:
            return False
        if lid_keep not in self.lm_index and not self._restore_landmark(lid_keep):
            return False
        self.obs_lid = np.where(self.obs_lid == lid_drop, lid_keep, self.obs_lid)
        alid = self.arch_obs_lid  # a view into the backing store
        alid[alid == lid_drop] = lid_keep
        if lid_drop in self.lm_index:
            row = self.lm_index.pop(lid_drop)
            self.lm_ids.pop(row)
            self.hp_W = np.delete(self.hp_W, row, 0)
            self.lm_index = {lid: i for i, lid in enumerate(self.lm_ids)}
        self.arch_lm.pop(lid_drop, None)
        return True

    def snapshot_pose_graph(self) -> Optional[dict]:
        """The long-term pose graph as arrays: every keyframe pose, the
        relative and loop edges, and an odometry edge between consecutive
        nodes that no edge connects."""
        nodes, edges = self.pose_graph()
        if len(nodes) < 2:
            return None
        fids = [f.fid for f in nodes]
        idx = {fid: i for i, fid in enumerate(fids)}
        connected = {(min(e["i"], e["j"]), max(e["i"], e["j"])) for e in edges}
        all_edges = [e for e in edges if e["i"] in idx and e["j"] in idx]
        for a, b in zip(nodes[:-1], nodes[1:]):
            if (a.fid < 0) != (b.fid < 0):
                continue
            if (min(a.fid, b.fid), max(a.fid, b.fid)) not in connected:
                T_ij = se3np.se3_multiply(se3np.se3_inverse(a.T_WS), b.T_WS)
                # an implausibly long step (a corrupted node pose) must not
                # become high-confidence odometry
                w = 50.0 if np.linalg.norm(T_ij[:3]) < 10.0 else 1.0
                all_edges.append(dict(i=a.fid, j=b.fid, T_ij=T_ij, sqrt_info=np.eye(6) * w))
        fixed = np.array([f.pose_fixed for f in nodes], bool)
        fixed[0] = True
        return dict(
            fids=fids, epoch=self.correction_epoch,
            T=np.stack([f.T_WS for f in nodes]), fixed=fixed,
            ei=np.array([idx[e["i"]] for e in all_edges], np.int64),
            ej=np.array([idx[e["j"]] for e in all_edges], np.int64),
            eT=np.stack([e["T_ij"] for e in all_edges]),
            eS=np.stack([e["sqrt_info"] for e in all_edges]),
        )

    def apply_pose_graph_result(self, fids: List[int], T_opt: np.ndarray,
                                backlog: bool = True) -> bool:
        """Write an optimised pose graph back: snapshot nodes still known
        take their optimised poses, archived landmarks move with their host
        keyframes, and (with `backlog`) every other window frame and live
        landmark moves rigidly by the change of the newest window frame that
        was in the snapshot.  Partial snapshots (final-BA segments) pass
        backlog=False so a mid-history correction does not drag the live
        window.  Corrections that move the anchor or any node by more than
        8 m are rejected."""
        T_opt = np.asarray(T_opt)
        if not np.all(np.isfinite(T_opt)):
            return False
        idx = {fid: i for i, fid in enumerate(fids)}
        anchor = None
        if backlog:
            anchor = next((f for f in reversed(self.frames) if f.fid in idx), None)
        dT = None
        if anchor is not None:
            dT = se3np.se3_multiply(T_opt[idx[anchor.fid]], se3np.se3_inverse(anchor.T_WS))
            dt_mag = float(np.linalg.norm(dT[:3]))
            if dt_mag > 8.0:
                logging.warning("pose-graph sync rejected: rigid backlog delta %.1f m "
                                "(anchor fid %d)", dt_mag, anchor.fid)
                return False
            if dt_mag > 1.0:
                logging.warning("pose-graph sync: large rigid backlog delta %.2f m "
                                "(anchor fid %d)", dt_mag, anchor.fid)
        window = {f.fid: f for f in self.frames}
        T_old_nodes = np.zeros_like(T_opt)
        node_known = np.zeros(len(fids), bool)
        for k, fid in enumerate(fids):
            f = self.archive_frames.get(fid) or window.get(fid)
            if f is not None:
                T_old_nodes[k] = f.T_WS
                node_known[k] = True
        if node_known.any():
            node_move = np.linalg.norm(
                T_opt[node_known, :3] - T_old_nodes[node_known, :3], axis=1).max()
            if node_move > 8.0:
                logging.warning("pose-graph result rejected: max node movement %.1f m",
                                node_move)
                return False
        for fid, Tn in zip(fids, T_opt):
            f = self.archive_frames.get(fid) or window.get(fid)
            if f is not None:
                f.T_WS = np.asarray(Tn).copy()
                if f.pre_hold_T is not None:
                    f.pre_hold_T = np.asarray(Tn).copy()
        self._correct_archived_landmarks(idx, node_known, T_old_nodes, T_opt, dT)
        self.correction_epoch += 1
        if dT is None:
            return True
        dR = se3np.quat_to_matrix(dT[3:7])
        for f in self.frames:
            if f.fid in idx or f.pose_graph_frame:
                continue
            f.T_WS = se3np.se3_multiply(dT, f.T_WS)
            f.sb = np.concatenate([dR @ f.sb[0:3], f.sb[3:9]])
        if len(self.hp_W):
            self.hp_W = se3np.se3_apply_homogeneous(dT, self.hp_W)
        return True

    def _correct_archived_landmarks(self, idx, node_known, T_old, T_new, dT):
        """Move each archived landmark by its host keyframe's pose change
        (host = newest archived observer); landmarks whose host is not a
        snapshot node take the rigid backlog delta `dT`."""
        n = self._arch_obs_n
        if not self.arch_lm or (n == 0 and dT is None):
            return
        host_of = {}
        if n:
            lid_rev = self._arch_obs_i[:n, 2][::-1]
            fid_rev = self._arch_obs_i[:n, 0][::-1]
            u, first = np.unique(lid_rev, return_index=True)
            host_of = dict(zip(u.tolist(), fid_rev[first].tolist()))
        items = list(self.arch_lm.items())
        hp = np.stack([p for _, p in items])
        deltas = np.zeros((len(items), 7))
        deltas[:, 6] = 1.0
        have = np.zeros(len(items), bool)
        node_dT = se3np.se3_multiply(T_new, se3np.se3_inverse(T_old))
        for k, (lid, _) in enumerate(items):
            g = idx.get(host_of.get(lid))
            if g is not None and node_known[g]:
                deltas[k] = node_dT[g]
                have[k] = True
            elif dT is not None:
                deltas[k] = dT
                have[k] = True
        if not have.any():
            return
        hp2 = se3np.se3_apply_homogeneous(deltas, hp)
        for k, (lid, _) in enumerate(items):
            if have[k]:
                self.arch_lm[lid] = hp2[k]

    # ------------------------------------------------------ multi-session
    def rigid_transform(self, dT: np.ndarray, session_only: bool = True):
        """Move the estimate rigidly by dT (a world-frame correction, left
        multiplied): poses, velocities, landmarks and the prior.  With
        `session_only` the frames of loaded components (fid < 0) stay put:
        the first relocalisation aligns the running session onto a loaded
        map so.  An optimisation in flight becomes stale."""
        dT_n = np.asarray(dT, np.float64)
        dR = se3np.quat_to_matrix(dT_n[3:7])
        for f in list(self.frames) + list(self.archive_frames.values()):
            if session_only and f.fid < 0:
                continue
            f.T_WS = se3np.se3_multiply(dT_n, f.T_WS)
            if f.pre_hold_T is not None:
                f.pre_hold_T = se3np.se3_multiply(dT_n, f.pre_hold_T)
            f.sb = np.concatenate([dR @ f.sb[0:3], f.sb[3:9]])
        if len(self.hp_W):
            self.hp_W = se3np.se3_apply_homogeneous(dT_n, self.hp_W)
        for lid in list(self.arch_lm.keys()):
            self.arch_lm[lid] = se3np.se3_apply_homogeneous(dT_n, self.arch_lm[lid])
        if self.prior_T is not None:
            self.prior_T = se3np.se3_multiply(dT_n, self.prior_T)
        self.correction_epoch += 1

    def import_component_frames(self, frame_fids, frame_ts, frame_T_WS, edges,
                                fixed: bool = True) -> Dict[int, int]:
        """Add a loaded session's keyframes and pose-graph edges as archived
        nodes (fixed by default) with negative frame ids, below those of any
        component loaded before (≙ Frontend::loadComponent keeping components
        apart from the live graph, okvis_frontend/src/Frontend.cpp:163-201).
        Their timestamps are shifted to precede every session state, so the
        time order of the pose graph holds.  Returns the old -> new fid map."""
        existing_neg = [f for f in self.archive_frames if f < 0]
        base = (min(existing_neg) if existing_neg else 0) - 1
        fid_map = {int(old): base - k for k, old in enumerate(frame_fids)}
        ts = np.asarray(frame_ts, np.float64)
        session_t0 = min([f.timestamp for f in self.frames]
                         + [f.timestamp for f in self.archive_frames.values()] + [0.0])
        shift = session_t0 - float(ts.max()) - 1e6
        for old, t, T in zip(frame_fids, ts, frame_T_WS):
            fid = fid_map[int(old)]
            self.archive_frames[fid] = FrameState(
                fid=fid, timestamp=float(t) + shift, T_WS=np.asarray(T, np.float64).copy(),
                sb=np.zeros(9), is_keyframe=True, pose_fixed=fixed, pose_graph_frame=True)
        for e in edges:
            self.archive_edges.append(dict(
                i=fid_map[int(e["i"])], j=fid_map[int(e["j"])],
                T_ij=np.asarray(e["T_ij"], np.float64),
                sqrt_info=np.asarray(e["sqrt_info"], np.float64)))
        return fid_map

    def close_loop(self, fid_cur: int, fid_cand: int, T_cand_cur: np.ndarray,
                   sqrt_info: np.ndarray, iterations: int = 10) -> bool:
        """Accepted loop closure, synchronous path: persist the loop edge,
        solve the whole pose graph in line and write the result back."""
        if not self.add_loop_edge(fid_cur, fid_cand, T_cand_cur, sqrt_info):
            return False
        snap = self.snapshot_pose_graph()
        if snap is None:
            self.archive_edges.pop()
            return False
        T_opt, _ = posegraph.optimize_pose_graph(
            snap["T"], snap["fixed"], snap["ei"], snap["ej"], snap["eT"], snap["eS"],
            iterations=iterations, dtype=self.cfg.dtype, device=self.device,
        )
        if not np.all(np.isfinite(T_opt)):
            self.archive_edges.pop()
            return False
        return self.apply_pose_graph_result(snap["fids"], T_opt)

    # --------------------------------------------------------------- final BA
    def _full_problem(self, use_imu: bool, node_slice=None, fix_margin: int = 0):
        """The whole-history BA problem: archived and live observations
        re-expanded, marginalisation edges dropped (their information
        returns as the observations), loop edges kept, and with `use_imu`
        IMU links between consecutive keyframes re-propagated from the raw
        samples at the current biases.  `node_slice=(i0, i1)` restricts it
        to a node range whose first and last `fix_margin` nodes are held
        fixed.  With `do_extrinsics_final_ba` the extrinsics are free under
        the final BA's prior.  As in the JAX package, it has no GNSS rows.
        Returns (problem, aux) or None.

        Capacities are padded as the JAX package pads them (K to a power of
        two from 16, L from 64, N from 256, R from 16, M from 8), so the
        solver takes the same branch: the reduced system is inverted up to
        K = 64 and solved by conjugate gradients from K = 128."""
        nodes, edges = self.pose_graph()
        if node_slice is not None:
            nodes = nodes[node_slice[0]:node_slice[1]]
        if len(nodes) < 2:
            return None
        edges = [e for e in edges if not e.get("marg")]
        fid2slot = {f.fid: i for i, f in enumerate(nodes)}
        nf = len(nodes)

        obs_fid = np.append(self.arch_obs_fid, self.obs_fid)
        obs_cam = np.append(self.arch_obs_cam, self.obs_cam)
        obs_lid = np.append(self.arch_obs_lid, self.obs_lid)
        obs_uv = np.vstack([self.arch_obs_uv, self.obs_uv])
        obs_sigma = np.append(self.arch_obs_sigma, self.obs_sigma)
        live = np.isin(obs_fid, np.fromiter(fid2slot, np.int64, nf))
        obs_fid, obs_cam, obs_lid = obs_fid[live], obs_cam[live], obs_lid[live]
        obs_uv, obs_sigma = obs_uv[live], obs_sigma[live]

        # landmarks (live or archived) with at least two observations
        lids, counts = np.unique(obs_lid, return_counts=True)
        lid2row, hps = {}, []
        for lid in lids[counts >= 2].tolist():
            if lid in self.lm_index:
                hp = self.hp_W[self.lm_index[lid]]
            elif lid in self.arch_lm:
                hp = self.arch_lm[lid]
            else:
                continue
            lid2row[lid] = len(hps)
            hps.append(hp)
        nl = len(hps)
        ok = np.isin(obs_lid, np.fromiter(lid2row, np.int64, nl))
        obs_fid, obs_cam, obs_lid = obs_fid[ok], obs_cam[ok], obs_lid[ok]
        obs_uv, obs_sigma = obs_uv[ok], obs_sigma[ok]
        n_obs = len(obs_fid)
        if n_obs > 32768:
            logging.warning("final BA: subsampling %d observations to 32768", n_obs)
            keep = np.linspace(0, n_obs - 1, 32768).astype(int)
            obs_fid, obs_cam, obs_lid = obs_fid[keep], obs_cam[keep], obs_lid[keep]
            obs_uv, obs_sigma = obs_uv[keep], obs_sigma[keep]
            n_obs = len(obs_fid)
        if n_obs < 10 or nl < 5:
            return None

        # IMU links between consecutive nodes whose span the raw samples
        # cover; odometry edges for the rest
        imu_links = []  # (slot_a, slot_b, (t0, t1, bg, ba))
        S_final = 0
        imu_arrays = self._full_imu_arrays() if use_imu else None
        if use_imu:
            t_arr = imu_arrays[0]
            for a, b in zip(nodes[:-1], nodes[1:]):
                if a.fid < 0 or b.fid < 0 or len(t_arr) == 0:
                    continue
                if t_arr[0] > a.timestamp or t_arr[-1] < b.timestamp:
                    continue
                i0 = max(int(np.searchsorted(t_arr, a.timestamp, "right")) - 1, 0)
                i1 = min(int(np.searchsorted(t_arr, b.timestamp, "left")) + 1, len(t_arr))
                if i1 - i0 < 2 or i1 - i0 > 4096:
                    continue
                imu_links.append((fid2slot[a.fid], fid2slot[b.fid],
                                  (a.timestamp, b.timestamp, a.sb[3:6], a.sb[6:9])))
                S_final = max(S_final, i1 - i0)
        imu_pairs = {(l[0], l[1]) for l in imu_links}
        connected = {(min(e["i"], e["j"]), max(e["i"], e["j"])) for e in edges}
        all_edges = list(edges)
        for a, b in zip(nodes[:-1], nodes[1:]):
            if (a.fid < 0) != (b.fid < 0):
                continue
            if (fid2slot[a.fid], fid2slot[b.fid]) in imu_pairs:
                continue
            if (min(a.fid, b.fid), max(a.fid, b.fid)) not in connected:
                T_ij = se3np.se3_multiply(se3np.se3_inverse(a.T_WS), b.T_WS)
                all_edges.append(dict(i=a.fid, j=b.fid, T_ij=T_ij, sqrt_info=np.eye(6) * 20.0))
        all_edges = [e for e in all_edges if e["i"] in fid2slot and e["j"] in fid2slot]

        bucket = dist_posegraph.bucket
        K, L, N = bucket(nf, 16), bucket(nl, 64), bucket(n_obs, 256)
        R = bucket(len(all_edges), 16)
        M = bucket(len(imu_links), 8) if imu_links else 1

        T_WS = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        T_WS[:nf] = np.stack([f.T_WS for f in nodes])
        sb_full = np.zeros((K, 9))
        sb_full[:nf] = np.stack([f.sb for f in nodes])
        frame_valid = np.zeros(K, bool)
        frame_valid[:nf] = True
        pose_fixed = np.zeros(K, bool)
        pose_fixed[0] = True  # gauge
        if node_slice is not None and fix_margin:
            pose_fixed[:min(fix_margin, nf)] = True
            pose_fixed[max(nf - fix_margin, 0):nf] = True
        # IMU-linked frames estimate speed/bias, softly anchored at the
        # current values (keeps unobserved bias directions bounded)
        sb_fixed = np.ones(K, bool)
        sb_prior = np.zeros((K, 9))
        sb_prior_si = np.tile(np.eye(9), (K, 1, 1))
        sb_prior_valid = np.zeros(K, bool)
        sb_si = np.diag(np.concatenate([np.full(3, 1.0), np.full(3, 1.0 / 0.05),
                                        np.full(3, 1.0 / 0.2)]))
        for sa, sb_, _ in imu_links:
            for slot in (sa, sb_):
                sb_fixed[slot] = False
                sb_prior[slot] = sb_full[slot]
                sb_prior_si[slot] = sb_si
                sb_prior_valid[slot] = True

        hp = np.tile(np.array([0, 0, 0, 1.0]), (L, 1))
        hp[:nl] = np.stack(hps)
        lm_valid = np.zeros(L, bool)
        lm_valid[:nl] = True

        node_fids = np.fromiter(fid2slot, np.int64, nf)
        order = np.argsort(node_fids)
        o_frame = np.zeros(N, np.int64)
        o_frame[:n_obs] = order[np.searchsorted(node_fids[order], obs_fid)]
        row_lids = np.fromiter(lid2row, np.int64, nl)
        lorder = np.argsort(row_lids)
        o_lm = np.zeros(N, np.int64)
        o_lm[:n_obs] = lorder[np.searchsorted(row_lids[lorder], obs_lid)]
        o_cam = np.zeros(N, np.int64)
        o_cam[:n_obs] = obs_cam
        o_uv = np.zeros((N, 2))
        o_uv[:n_obs] = obs_uv
        o_si = np.ones(N)
        o_si[:n_obs] = 1.0 / obs_sigma
        o_valid = np.zeros(N, bool)
        o_valid[:n_obs] = True

        r_i = np.zeros(R, np.int64)
        r_j = np.zeros(R, np.int64)
        r_T = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (R, 1))
        r_si = np.tile(np.eye(6), (R, 1, 1))
        r_valid = np.zeros(R, bool)
        for m, e in enumerate(all_edges):
            r_i[m], r_j[m] = fid2slot[e["i"]], fid2slot[e["j"]]
            r_T[m], r_si[m], r_valid[m] = e["T_ij"], e["sqrt_info"], True

        dev, dtype = self.device, self.cfg.dtype
        p = prb.empty_problem(K=K, L=L, C=self.C, N=N, M=M, R=R, dtype=dtype, device=dev)
        imu_i = np.zeros(M, np.int64)
        imu_j = np.zeros(M, np.int64)
        imu_valid = np.zeros(M, bool)
        imu_pre, imu_si = p.imu_pre, p.imu_sqrt_info
        if imu_links:
            for m, (sa, sb_, _) in enumerate(imu_links):
                imu_i[m], imu_j[m], imu_valid[m] = sa, sb_, True
            S_cap = 128
            while S_cap < S_final:
                S_cap *= 2
            imu_pre, imu_si = self._preintegrate_batch(
                [l[2] for l in imu_links], M, S=S_cap, imu_arrays=imu_arrays)

        F = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        I = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        p = p._replace(
            T_WS=F(T_WS), sb=F(sb_full), frame_valid=I(frame_valid),
            pose_fixed=I(pose_fixed), sb_fixed=I(sb_fixed),
            sb_prior=F(sb_prior), sb_prior_sqrt_info=F(sb_prior_si),
            sb_prior_valid=I(sb_prior_valid),
            imu_i=I(imu_i), imu_j=I(imu_j), imu_pre=imu_pre, imu_sqrt_info=imu_si,
            imu_valid=I(imu_valid), T_SC=F(self.T_SC), hp_W=F(hp), lm_valid=I(lm_valid),
            obs_frame=I(o_frame), obs_cam=I(o_cam), obs_lm=I(o_lm), obs_uv=F(o_uv),
            obs_sqrt_info=F(o_si), obs_valid=I(o_valid),
            rel_i=I(r_i), rel_j=I(r_j), rel_T=F(r_T), rel_sqrt_info=F(r_si),
            rel_valid=I(r_valid),
        )
        do_ext = self.cfg.do_extrinsics_final_ba
        if do_ext:
            C = self.C
            p = p._replace(
                ext_fixed=I(np.zeros(C, bool)), ext_prior_T=F(self.T_SC_prior),
                ext_prior_sqrt_info=F(np.tile(self._ext_prior_si(True), (C, 1, 1))),
                ext_prior_valid=I(np.ones(C, bool)),
            )
        aux = dict(fid2slot=fid2slot, lid2row=lid2row, fids=[f.fid for f in nodes],
                   do_ext=do_ext)
        return p, aux

    def _full_ba_run_fn(self, p, iterations: int, do_ext: bool = False):
        """The whole-history LM solve of a `_full_problem` (`do_ext`: its
        aux's, the extrinsics prior rows): (problem, cost)."""
        cfg = gn.SolverConfig(max_iterations=iterations, imu_params=self.cfg.imu,
                              use_ext_priors=do_ext)
        return gn.optimize(p, self.cams, cfg)

    def apply_full_ba_result(self, aux, p_opt, backlog: bool = True) -> bool:
        """Write a full-BA solution back: node poses through
        `apply_pose_graph_result` (with its backlog replay), speed/bias of
        the IMU-linked nodes, and every landmark of the problem (live rows
        or archive snapshots).  Pass backlog=False for segments."""
        nf = len(aux["fids"])
        T_out = p_opt.T_WS.cpu().numpy().astype(np.float64)
        if not np.all(np.isfinite(T_out[:nf])):
            return False
        self.apply_pose_graph_result(aux["fids"], T_out[:nf], backlog=backlog)
        sb_out = p_opt.sb.cpu().numpy().astype(np.float64)
        sb_fixed = p_opt.sb_fixed.cpu().numpy()
        window = {f.fid: f for f in self.frames}
        for fid, slot in aux["fid2slot"].items():
            fr = self.archive_frames.get(fid) or window.get(fid)
            if fr is not None and not sb_fixed[slot]:
                fr.sb = sb_out[slot].copy()
        hp_out = p_opt.hp_W.cpu().numpy().astype(np.float64)
        for lid, row in aux["lid2row"].items():
            if lid in self.lm_index:
                self.hp_W[self.lm_index[lid]] = hp_out[row]
            else:
                self.arch_lm[lid] = hp_out[row]
        if aux["do_ext"]:
            self.T_SC = p_opt.T_SC.cpu().numpy().astype(np.float64)
        return True

    def snapshot_full_ba(self, iterations: int = 15) -> Optional[dict]:
        """The complete-history BA (`_full_problem` with re-propagated IMU)
        for the background full-graph optimiser: dict(problem, aux,
        iterations, epoch), or None when there is too little to solve.  The
        problem is built here, on the caller's thread and stream; the worker
        only solves it (`_full_ba_run_fn`).

        Capacities are the content's buckets.  The JAX package pins them
        (64 nodes, 4096 landmarks, 16384 observations, 128 edges, 64 IMU
        links) only to reuse one XLA compile; up to its 64-node threshold
        both take the inverse branch of the reduced solve, and the results
        agree (tests/test_torch_full_ba.py)."""
        out = self._full_problem(use_imu=True)
        if out is None:
            return None
        p, aux = out
        return dict(problem=p, aux=aux, iterations=iterations, epoch=self.correction_epoch)

    def final_ba(self, iterations: int = 15, redo_imu: bool = True,
                 max_nodes: int = 128) -> float:
        """Full-batch bundle adjustment over the whole history: archived
        observations re-expanded, every keyframe pose free, IMU links
        re-propagated from the raw samples, one joint solve written back.

        Beyond `max_nodes` keyframes it alternates a global pose-graph solve
        (which distributes the loop corrections) with overlapping exact-BA
        segments of `max_nodes` nodes anchored at their margins, until the
        pose graph moves no node by 1 cm (at most 3 sweeps), and ends on a
        pose-graph polish.  Returns the final cost."""
        nodes, _ = self.pose_graph()
        n_nodes = len(nodes)
        if n_nodes <= max_nodes:
            out = self._full_problem(use_imu=redo_imu)
            if out is None:
                return 0.0
            p, aux = out
            p_opt, cost = self._full_ba_run_fn(p, iterations, aux["do_ext"])
            self.apply_full_ba_result(aux, p_opt)
            return float(cost)

        def _pg_stage() -> float:
            """Global pose-graph solve and writeback; returns the largest
            node movement (m)."""
            snap = self.snapshot_pose_graph()
            moved = 0.0
            if snap is not None:
                # above 256 nodes the matrix-free PCG solver, as the
                # background full graph switches to it
                solve = (dist_posegraph.optimize_pose_graph_pcg if snap["T"].shape[0] > 256
                         else posegraph.optimize_pose_graph)
                T_opt, _ = solve(
                    snap["T"], snap["fixed"], snap["ei"], snap["ej"], snap["eT"],
                    snap["eS"], iterations=iterations, dtype=self.cfg.dtype,
                    device=self.device,
                )
                if np.all(np.isfinite(T_opt)):
                    moved = float(np.max(np.linalg.norm(T_opt[:, :3] - snap["T"][:, :3],
                                                        axis=1)))
                    self.apply_pose_graph_result(snap["fids"], T_opt)
            return moved

        cost = 0.0
        for sweep in range(3):
            moved = _pg_stage()
            if sweep > 0 and moved < 0.01:
                return cost
            step = max(max_nodes * 3 // 4, 1)
            margin = max(max_nodes // 16, 2)
            cost = 0.0
            i0 = 0
            while i0 < n_nodes:
                i1 = min(i0 + max_nodes, n_nodes)
                out = self._full_problem(use_imu=redo_imu, node_slice=(i0, i1),
                                         fix_margin=margin if i0 > 0 else 0)
                if out is not None:
                    p, aux = out
                    p_opt, seg_cost = self._full_ba_run_fn(p, iterations, aux["do_ext"])
                    if np.isfinite(float(seg_cost)):
                        # only the newest segment replays the backlog
                        self.apply_full_ba_result(aux, p_opt, backlog=i1 >= n_nodes)
                        cost += float(seg_cost)
                    else:
                        logging.warning("final BA: segment [%d,%d) sweep %d diverged "
                                        "(cost %s); writeback skipped", i0, i1, sweep + 1,
                                        seg_cost)
                if i1 >= n_nodes:
                    break
                i0 += step
        _pg_stage()
        return cost

    # ------------------------------------------------------------- outputs
    def get_state(self, fid: Optional[int] = None) -> FrameState:
        return self.frames[-1] if fid is None else self._frame_by_id(fid)

    def trajectory(self):
        return {f.fid: (f.timestamp, f.T_WS.copy()) for f in self.frames}

    def full_trajectory(self):
        """Time-ordered (timestamps, T_WS) over archived and window frames."""
        frames = sorted(list(self.archive_frames.values()) + self.frames,
                        key=lambda f: f.timestamp)
        return (
            np.array([f.timestamp for f in frames]),
            np.stack([f.T_WS for f in frames]) if frames else np.zeros((0, 7)),
        )

