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
when the bias moved past the redo thresholds.  GNSS, online extrinsics,
live submap-ICP rows, depth priors, loop-closure surgery and the final BA
are not part of the port yet; the options that would enable them raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch.factors import imu_factor
from okvis2x_tpu_torch.factors.reprojection import residual as reprojection_residual
from okvis2x_tpu_torch.graph.marginalization import two_pose_edge
from okvis2x_tpu_torch.graph.posegraph import max_spanning_tree
from okvis2x_tpu_torch.imu import preintegration as pre
from okvis2x_tpu_torch.imu import preintegration_np as pre_np
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
    cap_icp: int = 0
    keypoint_sigma_px: float = 0.8
    max_iterations: int = 10
    realtime_time_limit: float = 0.0
    # > 0: early exit of the LM loop on converged accepted steps
    early_exit_rel: float = 0.0
    imu: pre.ImuParams = pre.ImuParams()
    dtype: torch.dtype = torch.float64
    do_extrinsics: bool = False
    do_extrinsics_final_ba: bool = False
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


_OBS_COLS = ("obs_fid", "obs_cam", "obs_lid", "obs_uv", "obs_sigma", "obs_uid")


class SlidingWindowEstimator:
    """Keyframe-based sliding-window visual-inertial estimator."""

    def __init__(self, config: EstimatorConfig, cameras, T_SC: np.ndarray, device="cpu"):
        if config.do_extrinsics or config.do_extrinsics_final_ba:
            raise NotImplementedError("online extrinsics calibration is not ported yet")
        if config.realtime_time_limit:
            raise NotImplementedError("the realtime budget controller is not ported yet")
        if config.cap_icp:
            raise NotImplementedError("live submap ICP factors are not ported yet")
        self.cfg = config
        self.device = torch.device(device)
        self.cams = gn.stack_cameras(cameras).to(self.device, config.dtype)
        self.T_SC = np.asarray(T_SC, dtype=np.float64)  # (C, 7)
        self.C = self.T_SC.shape[0]

        self.frames: List[FrameState] = []
        self._next_fid = 0
        self._next_lid = 0

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
        self.obs_uid = np.zeros((0,), np.int64)
        self._obs_uid_next = 0

        # IMU raw buffer: amortised growable array + start offset
        self._imu_buf = np.zeros((4096, 7))  # [t, gyr(3), acc(3)]
        self._imu_start = 0
        self._imu_n = 0

        # chained per-link preintegration cache: (fid_a, fid_b) ->
        # (Preintegrated f64 numpy, sqrt_info (15, 15) f64)
        self.imu_links: Dict[tuple, tuple] = {}

        # relative-pose (marginalisation) edges between frame ids, and the
        # long-term pose graph of frames/edges that left the window
        self.rel_edges: List[dict] = []
        self.archive_frames: Dict[int, FrameState] = {}
        self.archive_edges: List[dict] = []
        # landmark positions snapshotted when pruned
        self.arch_lm: Dict[int, np.ndarray] = {}

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
        self._imu_start += max(first - 1, 0)

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

    def _preintegrate_batch(self, spans, n_rows: int, S: Optional[int] = None):
        """spans: list of (t0, t1, bg, ba) over the live buffer; returns
        (Preintegrated batched to n_rows, W (n_rows, 15, 15)) on the device,
        invalid rows padded with identity.  Spans longer than S samples are
        uniformly subsampled."""
        cfg = self.cfg
        S = S or cfg.cap_imu_samples
        t_arr, gyr_arr, acc_arr = self.imu_t, self.imu_gyr, self.imu_acc
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

    def add_observations_batch(self, fid: int, cam, lid, uv, sigma=None):
        """Vectorised multi-observation add."""
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
        fid -> slot, obs uids per problem row)."""
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
        pose_fixed[:nf] = [f.pose_fixed or f.pose_graph_frame for f in self.frames]
        sb_fixed = np.ones(K, bool)
        sb_fixed[:nf] = [f.pose_graph_frame or f.sb_fixed for f in self.frames]

        # observations whose frame and landmark are both live
        slot_of = np.full(max(self._next_fid, 1), -1, np.int64)
        for fid, s in fid2slot.items():
            slot_of[fid] = s
        row_of = np.full(max(self._next_lid, 1), -1, np.int64)
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

        dev = self.device
        F = lambda x: torch.as_tensor(x, dtype=cfg.dtype, device=dev)  # noqa: E731
        I = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        p = prb.empty_problem(K=K, L=L, C=C, N=Ncap, M=Mcap, R=Rcap, G=0,
                              dtype=cfg.dtype, device=dev)
        p = p._replace(
            T_WS=F(T_full), sb=F(sb_full), frame_valid=I(frame_valid),
            pose_fixed=I(pose_fixed), sb_fixed=I(sb_fixed), T_SC=F(self.T_SC),
            hp_W=F(hp), lm_valid=I(lm_valid),
            obs_frame=I(obs_frame), obs_cam=I(obs_cam), obs_lm=I(obs_lm),
            obs_uv=F(obs_uv), obs_sqrt_info=F(obs_si), obs_valid=I(obs_valid),
            imu_i=I(imu_i), imu_j=I(imu_j), imu_valid=I(imu_valid),
            imu_pre=pre.Preintegrated(*[F(x) for x in imu_pre_b]),
            imu_sqrt_info=F(imu_W_b),
            pose_prior_T=F(pose_prior_T), pose_prior_sqrt_info=F(pose_prior_si),
            pose_prior_valid=I(pose_prior_valid), sb_prior=F(sb_prior),
            sb_prior_sqrt_info=F(sb_prior_si), sb_prior_valid=I(sb_prior_valid),
            rel_i=I(rel_i), rel_j=I(rel_j), rel_T=F(rel_T),
            rel_sqrt_info=F(rel_si), rel_valid=I(rel_valid),
        )
        return p, fid2slot, self.obs_uid[obs_src]

    def _solver_config(self, iters: int) -> gn.SolverConfig:
        return gn.SolverConfig(
            max_iterations=iters, imu_params=self.cfg.imu,
            early_exit_rel=self.cfg.early_exit_rel,
        )

    def optimise_gated(self, fid: int, gate_px: float, iterations: Optional[int] = None,
                       iterations2: int = 2):
        """Window solve, chi2 gate on the observations of frame `fid`, short
        re-solve without the flagged rows; writes poses, speed/bias and
        landmarks back and removes the flagged observations.  Returns
        (cost, n_outliers)."""
        iters = iterations or self.cfg.max_iterations
        with timing.Timer("3.1 BuildProblem"):
            p, fid2slot, obs_uids = self._build_problem()
        with timing.Timer("3.2 SolveDevice"):
            p1, _ = gn.optimize(p, self.cams, self._solver_config(iters))
            f, c, l = p1.obs_frame, p1.obs_cam, p1.obs_lm
            r, proj_ok = reprojection_residual(
                self.cams.at(c), p1.T_WS[f], p1.T_SC[c], p1.hp_W[l], p1.obs_uv,
                p1.obs_sqrt_info,
            )
            err_px = torch.linalg.norm(r, dim=-1) / torch.clamp(p1.obs_sqrt_info, min=1e-12)
            out = p1.obs_valid & (f == fid2slot.get(fid, -1)) & (~proj_ok | (err_px > gate_px))
            p2 = p1._replace(obs_valid=p1.obs_valid & ~out)
            p3, cost = gn.optimize(p2, self.cams, self._solver_config(iterations2))
        with timing.Timer("3.3 Readback"):
            T = p3.T_WS.cpu().numpy().astype(np.float64)
            sb = p3.sb.cpu().numpy().astype(np.float64)
            hp = p3.hp_W.cpu().numpy().astype(np.float64)
            out_rows = np.nonzero(out.cpu().numpy())[0]
            cost = float(cost)
        for fr_id, slot in fid2slot.items():
            fr = self._frame_by_id(fr_id)
            fr.T_WS = T[slot]
            fr.sb = sb[slot]
        self.hp_W = hp[: len(self.lm_ids)]
        if len(out_rows):
            bad = obs_uids[out_rows[out_rows < len(obs_uids)]]
            self._keep_obs(~np.isin(self.obs_uid, bad))
        return cost, len(out_rows)

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
            pg = [f for f in self.frames if f.pose_graph_frame]
            if not pg:
                break
            victim = pg[0]
            self.archive_frames[victim.fid] = victim
            self._drop_frame(victim.fid)
            keep = []
            for e in self.rel_edges:
                if victim.fid in (e["i"], e["j"]):
                    self.archive_edges.append(e)
                else:
                    keep.append(e)
            self.rel_edges = keep

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

    def _compute_two_pose_edges(self, victim: FrameState, targets) -> List[dict]:
        """TwoPoseGraphError-style edges victim->target for up to 3 targets;
        co-observations are capped at 128 landmarks and subsampled to 512
        observations per edge."""
        ncap, lcap = 512, 128
        dev, dtype = self.device, self.cfg.dtype
        va = self.obs_fid == victim.fid
        edges = []
        for target in list(targets)[:3]:
            vb = self.obs_fid == target.fid
            shared = set(self.obs_lid[va]) & set(self.obs_lid[vb])
            shared = [l for l in shared if l in self.lm_index][:lcap]
            if not shared:
                continue
            lrow = {l: i for i, l in enumerate(shared)}
            sel = np.nonzero((va | vb) & np.isin(self.obs_lid, list(shared)))[0]
            if len(sel) > ncap:
                sel = sel[:: len(sel) // ncap + 1][:ncap]
            F = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
            I = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)  # noqa: E731
            T_ab, W, strength = two_pose_edge(
                self.cams, F(victim.T_WS), F(target.T_WS), F(self.T_SC),
                F(self.hp_W[[self.lm_index[l] for l in shared]]),
                torch.ones(len(shared), dtype=torch.bool, device=dev),
                I(self.obs_fid[sel] == target.fid), I(self.obs_cam[sel]),
                I([lrow[l] for l in self.obs_lid[sel]]), F(self.obs_uv[sel]),
                F(1.0 / self.obs_sigma[sel]),
                torch.ones(len(sel), dtype=torch.bool, device=dev),
            )
            strength = float(strength)
            if not np.isfinite(strength) or strength < 1e-3:
                continue
            edges.append(dict(
                i=victim.fid, j=target.fid,
                T_ij=T_ab.cpu().numpy().astype(np.float64),
                sqrt_info=W.cpu().numpy().astype(np.float64),
                marg=True,
            ))
        return edges

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
        edges = self._compute_two_pose_edges(victim, edge_targets)
        if not edges and len(nodes) > 1:
            bi = int(np.argmax(C[0, 1:])) + 1
            if C[0, bi] >= 3:
                edges = self._compute_two_pose_edges(victim, [nodes[bi]])
        self.rel_edges.extend(edges)
        self._merge_chain_link(victim.fid)
        victim.pose_graph_frame = True
        self._keep_obs(self.obs_fid != victim.fid)

    # ------------------------------------------------------------- outputs
    def get_state(self, fid: Optional[int] = None) -> FrameState:
        return self.frames[-1] if fid is None else self._frame_by_id(fid)


