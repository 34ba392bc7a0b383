"""Per-frame VIO pipeline: detection -> association -> estimation ->
marginalisation (torch counterpart of the synchronous VIO subset of
``okvis2x_tpu/pipeline/vio.py``).

Stages per frame:
  1. add_state: IMU propagation to the frame time (estimator, host);
  2. detect & describe every camera (device);
  3. association (device): match-to-map per camera with a projection gate,
     rig-stereo initialisation with an epipolar gate, motion stereo against
     the last keyframe; every Hamming distance comes from the packed
     descriptor kernel (``ops.hamming``);
  4. keyframe decision by disc-coverage overlap (host);
  5. gated window solve (estimator);
  6. synchronous loop closure on keyframes: vocabulary words and a tf-idf
     query (``frontend/bow.py``), mutual matching against up to three
     candidates on the Hamming kernel, batched non-central RANSAC
     (``frontend/ransac.py``), a drift-budget gate, then the loop edge and
     an in-line pose-graph solve, the candidate held in the window,
     landmark merges and a window re-solve (estimator);
  7. marginalisation.

After the last frame, `finish()` and `est.final_ba()` give the refined
trajectory (`est.full_trajectory()`).

The asynchronous place-recognition worker and background full graph,
online vocabulary training, relocalisation against loaded maps, the
deferred fused frontend, the pipelined solve, the inline pose refinement,
semantic weighting and depth input are not part of the port yet; enabling
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.api import TrackingQuality
from okvis2x_tpu_torch.cameras import pinhole, pinhole_np
from okvis2x_tpu_torch.core import se3, se3np
from okvis2x_tpu_torch.frontend import bow, descriptor, detector, matcher, ransac, triangulation
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, SlidingWindowEstimator
from okvis2x_tpu_torch.ops import hamming
from okvis2x_tpu_torch.utils import timing


@dataclasses.dataclass
class PipelineConfig:
    max_keypoints: int = 512
    octaves: int = 2
    detection_cell: int = 32
    detection_per_cell: int = 8
    harris_threshold: float = 1e-7
    matching_threshold: float = 60.0
    match_radius_px: float = 40.0
    stereo_max_dist: float = 60.0
    epipolar_px: float = 3.0
    chi2_px: float = 3.0  # outlier gate in sigma-normalised px
    keyframe_match_fraction: float = 0.55
    keyframe_overlap: float = 0.55
    keyframe_use_overlap: bool = True
    min_triangulation_depth: float = 0.1
    max_triangulation_depth: float = 50.0
    quality_lost: float = 0.01
    quality_marginal: float = 0.3
    quality_grid: int = 8
    # loop closure (synchronous): the shipped vocabulary when vocab_path is
    # None; candidates are the top BoW retrievals (a third one only above
    # p_dbow or p_prominence x the retrieval mean), verified by RANSAC with
    # loop_min_inliers, accepted within drift_percentage of the path since
    # the candidate, and at most one per loop_cooldown_m of path
    do_loop_closures: bool = False
    vocab_path: Optional[str] = None
    p_dbow: float = 0.4
    p_prominence: float = 1.15
    loop_min_gap_s: float = 5.0
    loop_min_inliers: int = 15
    loop_cooldown_m: float = 3.0
    drift_percentage: float = 1.35  # % of the distance travelled
    num_loopclosure_frames: int = 3  # held in the window for merging
    # features of the JAX package that the port does not have yet: each
    # must stay at its "off" value
    async_place_recognition: bool = True
    async_loop_closure: bool = False
    pose_refine: bool = False
    pipelined_solve: bool = False
    deferred_frontend: bool = False
    segmentation: str = "off"

    def check_ported(self):
        for name in ("pose_refine", "pipelined_solve", "deferred_frontend"):
            if getattr(self, name):
                raise NotImplementedError(f"PipelineConfig.{name} is not ported yet")
        if self.segmentation != "off":
            raise NotImplementedError("semantic keypoint weighting is not ported yet")
        if self.do_loop_closures:
            if self.async_place_recognition:
                raise NotImplementedError(
                    "the asynchronous place-recognition worker is not ported yet: "
                    "set async_place_recognition=False")
            if self.async_loop_closure:
                raise NotImplementedError(
                    "the background full-graph optimiser is not ported yet: "
                    "set async_loop_closure=False")
            if self.vocab_path == "":
                raise NotImplementedError("online vocabulary training is not ported yet")


# stereo / motion-stereo initialisations accepted per frame (the first
# ASSOC_CAP in keypoint order)
ASSOC_CAP = 256


class FrameData:
    """Per-frame detection results, host side."""

    def __init__(self, uv, valid, packed):
        self.uv = uv  # (N, 2) float64
        self.valid = valid  # (N,) bool
        self.packed = packed  # (N, 12) int32
        self.lid = np.full(uv.shape[0], -1, np.int64)  # landmark assignment


def _f32(x: torch.Tensor) -> torch.Tensor:
    """Round to float32 and back: association constants the JAX package
    builds as float32 arrays."""
    return x.to(torch.float32).to(x.dtype)


class VioPipeline:
    def __init__(
        self,
        cameras,
        T_SC: np.ndarray,
        est_config: EstimatorConfig,
        cfg: Optional[PipelineConfig] = None,
        device=None,
    ):
        """`device` None is the first CUDA device; without one this raises
        (pass device="cpu" to run on the CPU)."""
        cfg = cfg or PipelineConfig()
        cfg.check_ported()
        self.cfg = cfg
        self.device = default_device() if device is None else torch.device(device)
        dtype = est_config.dtype
        self.cameras = [c.to(self.device, dtype) for c in cameras]
        self.np_cameras = [pinhole_np.to_numpy(c) for c in cameras]
        self.T_SC = np.asarray(T_SC, np.float64)
        self.est = SlidingWindowEstimator(est_config, cameras, T_SC, device=self.device)
        self.num_cams = len(cameras)
        self.frames: Dict[int, List[FrameData]] = {}
        self.last_kf_fid: Optional[int] = None
        self.lm_desc: Dict[int, np.ndarray] = {}  # lid -> packed descriptor
        self.states_log = []  # (t, T_WS) after each frame
        self.last_quality_fraction = 0.0
        self.path_length = 0.0
        self._last_solved_T = None

        # loop closure: keyframe records (descriptors, landmark snapshot,
        # pose), the vocabulary and its database, held loop-closure frames
        self.kf_records: Dict[int, dict] = {}
        self.lc_frames: List[int] = []
        self.n_loop_closures = 0
        self.n_landmarks_merged = 0
        self._lc_last_path = -1e9
        self.vocab = None
        self.bow_db = None
        if cfg.do_loop_closures:
            path = cfg.vocab_path or bow.DEFAULT_VOCAB
            if not os.path.exists(path):
                raise NotImplementedError(
                    f"vocabulary {path} not found; online vocabulary training is "
                    "not ported yet")
            self.vocab = bow.HierVocabulary.load(path, device=self.device)
            self.bow_db = bow.BowDatabase(k=self.vocab.n_words)

    # ---------------------------------------------------------------- stages
    @staticmethod
    def _pad_width(img: np.ndarray) -> np.ndarray:
        """Edge-replicate the image width up to a multiple of 128.  Kept from
        the JAX package because it moves the detector's border mask and cell
        grid, and so which keypoints are found."""
        pad = (-img.shape[1]) % 128
        if pad == 0:
            return img
        return np.pad(img, ((0, 0), (0, pad)), mode="edge")

    def _gravity_angles(self, n_cams: int, T_WS_pred: np.ndarray):
        """Per-camera descriptor extraction directions from projected gravity."""
        angles = []
        for c in range(n_cams):
            T_WC = se3np.se3_multiply(np.asarray(T_WS_pred), self.T_SC[c])
            C_CW = se3np.quat_to_matrix(T_WC[3:7]).T
            g_C = C_CW @ np.array([0.0, 0.0, -1.0])
            if np.hypot(g_C[0], g_C[1]) > 0.2:
                angles.append(float(np.arctan2(g_C[1], g_C[0])))
            else:
                e_C = C_CW @ np.array([1.0, 0.0, 0.0])
                angles.append(float(np.arctan2(e_C[1], e_C[0])))
        return angles

    def detect_and_describe(self, images: List[np.ndarray], T_WS_pred: np.ndarray):
        """Stage 2: detection + description of every camera on the device;
        returns one FrameData per camera."""
        cfg = self.cfg
        imgs = np.stack([self._pad_width(im) for im in images])
        if imgs.dtype != np.uint8:
            imgs = np.clip(imgs * 255.0, 0, 255).astype(np.uint8)
        angles = self._gravity_angles(len(images), T_WS_pred)
        imgs_d = torch.from_numpy(imgs).to(self.device).to(torch.float32) * (1.0 / 255.0)
        out = []
        for c in range(len(images)):
            kp = detector.detect(
                imgs_d[c], max_keypoints=cfg.max_keypoints, octaves=cfg.octaves,
                cell=cfg.detection_cell, per_cell=cfg.detection_per_cell,
                threshold=cfg.harris_threshold,
            )
            ang = torch.full((cfg.max_keypoints,), angles[c], dtype=torch.float32,
                             device=self.device)
            packed = descriptor.extract(imgs_d[c], kp.uv, ang, kp.level, kp.valid)
            out.append(FrameData(
                uv=kp.uv.cpu().numpy().astype(np.float64),
                valid=kp.valid.cpu().numpy(),
                packed=packed.cpu().numpy(),
            ))
        return out

    def _assoc_stage(self, T_WS: np.ndarray) -> dict:
        """Host staging of the association inputs: landmark table and the
        motion-stereo keyframe around the pose estimate `T_WS`."""
        est = self.est
        nl = len(est.lm_ids)
        Lcap = est.cfg.cap_landmarks
        lids = np.array(est.lm_ids, np.int64)
        hp = np.tile(np.array([0, 0, 0, 1.0]), (Lcap, 1))
        packs = np.zeros((Lcap, 12), np.int32)
        lm_valid = np.zeros(Lcap, bool)
        if nl:
            hp[:nl] = est.hp_W
            zero_d = np.zeros(12, np.int32)
            packs[:nl] = np.stack([self.lm_desc.get(l, zero_d) for l in lids])
            lm_valid[:nl] = True
        N = self.cfg.max_keypoints
        kfd, kf_fid = None, None
        if self.last_kf_fid is not None and self.last_kf_fid in self.frames:
            try:
                fk = est.get_state(self.last_kf_fid)
                kfd = self.frames[self.last_kf_fid][0]
                kf_fid = self.last_kf_fid
            except KeyError:
                kfd = None
        if kfd is not None:
            T_WCk = se3np.se3_multiply(fk.T_WS, self.T_SC[0])
            T_WC = se3np.se3_multiply(T_WS, self.T_SC[0])
            T_CkC = se3np.se3_multiply(se3np.se3_inverse(T_WCk), T_WC)
            motion_on = bool(np.linalg.norm(T_CkC[:3]) >= 0.02)
            kf = dict(uv=kfd.uv, un=(kfd.lid < 0) & kfd.valid, packs=kfd.packed, valid=kfd.valid)
        else:
            T_WCk = np.array([0, 0, 0, 0, 0, 0, 1.0])
            T_CkC = np.array([0, 0, 0, 0, 0, 0, 1.0])
            motion_on = False
            kf = dict(uv=np.zeros((N, 2)), un=np.zeros(N, bool),
                      packs=np.zeros((N, 12), np.int32), valid=np.zeros(N, bool))
        return dict(nl=nl, lids=lids, hp=hp, packs=packs, lm_valid=lm_valid,
                    kf_fid=kf_fid, T_WCk=T_WCk, T_CkC=T_CkC, motion_on=motion_on, kf=kf)

    def _assoc_core(self, T_WS, st: dict, frame_data: List[FrameData]) -> dict:
        """Stages 3 and 6 on the device: map matching for every camera with
        one keypoint kept per landmark, rig-stereo and motion-stereo
        initialisations.  Returns host arrays."""
        cfg = self.cfg
        dev, dtype = self.device, self.est.cfg.dtype
        C = self.num_cams
        N = cfg.max_keypoints
        Lcap = self.est.cfg.cap_landmarks
        F = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
        B = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.bool, device=dev)  # noqa: E731
        P = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)  # noqa: E731
        T_WS = F(T_WS)
        hp, lm_valid, lm_packs = F(st["hp"]), B(st["lm_valid"]), P(st["packs"])
        kp_uv = F(np.stack([fd.uv for fd in frame_data]))
        kp_valid = B(np.stack([fd.valid for fd in frame_data]))
        kp_packs = [P(fd.packed) for fd in frame_data]
        T_SC = F(self.T_SC)
        ar = torch.arange(N, device=dev)

        # ---- map matching per camera, one keypoint kept per landmark
        map_rows, assigned = [], []
        for c in range(C):
            T_CW = se3.se3_multiply(se3.se3_inverse(T_SC[c]), se3.se3_inverse(T_WS))
            uv_pred, vis = pinhole.project_homogeneous(
                self.cameras[c], se3.se3_apply_homogeneous(T_CW, hp)
            )
            d2 = ((kp_uv[c][:, None, :] - uv_pred[None, :, :]) ** 2).sum(-1)
            allowed = (
                (d2 < cfg.match_radius_px ** 2) & (vis & lm_valid)[None, :]
                & kp_valid[c][:, None]
            )
            m = matcher.match_masked(kp_packs[c], kp_valid[c], lm_packs, lm_valid,
                                     allowed, max_dist=cfg.matching_threshold)
            # unique tie-break by keypoint index folded into the key
            keyv = torch.where(m.valid, m.dist * float(N + 1) + ar.to(torch.float32),
                               torch.full_like(m.dist, float("inf")))
            best = torch.full((Lcap,), float("inf"), device=dev).scatter_reduce(
                0, m.idx_b, keyv, reduce="amin", include_self=True
            )
            keep = m.valid & (keyv == best[m.idx_b])
            map_rows.append(torch.where(keep, m.idx_b, torch.full_like(m.idx_b, -1)))
            assigned.append(keep)

        # ---- rig stereo initialisation
        cam0 = self.cameras[0]
        r0, v0 = pinhole.back_project(cam0, kp_uv[0])
        st_rows = torch.zeros((0,), dtype=torch.int64, device=dev)
        st_i0 = st_rows
        st_hp = torch.zeros((0, 4), dtype=dtype, device=dev)
        stereo_assigned0 = torch.zeros((N,), dtype=torch.bool, device=dev)
        if C >= 2:
            T_C1C0 = se3np.se3_multiply(se3np.se3_inverse(self.T_SC[1]), self.T_SC[0])
            T_C0C1 = se3np.se3_inverse(T_C1C0)
            E = _f32(F(se3np.cross_matrix(T_C1C0[:3]) @ se3np.quat_to_matrix(T_C1C0[3:7])))
            fpx = float(self.np_cameras[1].fxfycxcy[1])
            p_B = _f32(F(T_C0C1[:3]))
            R_C0C1 = _f32(F(se3np.quat_to_matrix(T_C0C1[3:7])))
            un0 = kp_valid[0] & ~assigned[0]
            un1 = kp_valid[1] & ~assigned[1]
            r1, v1 = pinhole.back_project(self.cameras[1], kp_uv[1])
            lines = r0 @ E.T
            num = (r1 @ lines.T).abs()
            denom = torch.linalg.norm(lines[:, :2], dim=1)[None, :] + 1e-12
            epi_px = num / denom * fpx
            st_allowed = (
                (epi_px < cfg.epipolar_px * 3) & (v1 & un1)[:, None] & (v0 & un0)[None, :]
            )
            mst = matcher.match_masked(kp_packs[1], kp_valid[1], kp_packs[0], kp_valid[0],
                                       st_allowed, max_dist=cfg.stereo_max_dist)
            x0 = r0[mst.idx_b]
            e_A = x0 / torch.linalg.norm(x0, dim=-1, keepdim=True)
            eb = r1 @ R_C0C1.T
            e_B = eb / torch.linalg.norm(eb, dim=-1, keepdim=True)
            tri = triangulation.triangulate(torch.zeros_like(e_A), e_A, p_B.expand(N, 3), e_B)
            depth = tri.hp_A[:, 2] / torch.clamp(tri.hp_A[:, 3], min=1e-12)
            st_ok = (
                mst.valid & tri.valid & ~tri.parallel
                & (depth > cfg.min_triangulation_depth) & (depth < cfg.max_triangulation_depth)
            )
            T_WC0 = se3.se3_multiply(T_WS, T_SC[0])
            st_rows = torch.nonzero(st_ok)[:ASSOC_CAP, 0]
            st_i0 = mst.idx_b[st_rows]
            st_hp = se3.se3_apply_homogeneous(T_WC0, tri.hp_A[st_rows])
            stereo_assigned0[mst.idx_b[st_ok]] = True

        # ---- motion stereo against the last keyframe, cam0
        kf = st["kf"]
        kf_valid = B(kf["valid"])
        un_c = kp_valid[0] & ~assigned[0] & ~stereo_assigned0
        r_k, v_k = pinhole.back_project(cam0, F(kf["uv"]))
        mo_allowed = (
            (un_c & v0)[:, None] & (B(kf["un"]) & v_k)[None, :] & bool(st["motion_on"])
        )
        mmo = matcher.match_masked(kp_packs[0], kp_valid[0], P(kf["packs"]), kf_valid,
                                   mo_allowed, max_dist=cfg.stereo_max_dist, mutual=True)
        mo_idx, mo_val = mmo.idx_b, mmo.valid
        T_CkC = F(st["T_CkC"])
        R_k = _f32(se3.quat_to_matrix(se3.se3_q(T_CkC)))
        p_Bk = _f32(se3.se3_t(T_CkC))
        xk = r_k[mo_idx]
        e_A = xk / torch.linalg.norm(xk, dim=-1, keepdim=True)
        eb = r0 @ R_k.T
        e_B = eb / torch.linalg.norm(eb, dim=-1, keepdim=True)
        tri = triangulation.triangulate(torch.zeros_like(e_A), e_A, p_Bk.expand(N, 3), e_B)
        depth = tri.hp_A[:, 2] / torch.clamp(tri.hp_A[:, 3], min=1e-12)
        mo_ok = (
            mo_val & tri.valid & ~tri.parallel
            & (depth > cfg.min_triangulation_depth) & (depth < cfg.max_triangulation_depth)
        )
        mo_rows = torch.nonzero(mo_ok)[:ASSOC_CAP, 0]
        mo_hp = se3.se3_apply_homogeneous(F(st["T_WCk"]), tri.hp_A[mo_rows])

        host = lambda x: x.cpu().numpy()  # noqa: E731
        return dict(
            map_rows=host(torch.stack(map_rows)),
            st_i1=host(st_rows), st_i0=host(st_i0), st_hp=host(st_hp),
            mo_ic=host(mo_rows), mo_ik=host(mo_idx[mo_rows]), mo_hp=host(mo_hp),
        )

    def _assoc_consume(self, fid: int, frame_data: List[FrameData], st: dict, res: dict):
        """Assign landmark ids, add observations, create stereo/motion
        landmarks; returns (n_map, n_stereo, n_motion)."""
        est = self.est
        nl, lids, kf_fid = st["nl"], st["lids"], st["kf_fid"]
        map_rows = res["map_rows"]

        n_map = 0
        for c, fd in enumerate(frame_data):
            ks = np.nonzero(map_rows[c] >= 0)[0]
            ks = ks[(map_rows[c][ks] < nl) & (fd.lid[ks] < 0)]
            if len(ks) == 0:
                continue
            fd.lid[ks] = lids[map_rows[c][ks]]
            est.add_observations_batch(fid, c, fd.lid[ks], fd.uv[ks])
            n_map += len(ks)

        n_stereo = 0
        if self.num_cams >= 2:
            fd0, fd1 = frame_data[0], frame_data[1]
            used0 = set()
            new_lid, new_i0, new_i1 = [], [], []
            for r in range(len(res["st_i1"])):
                i1, i0 = int(res["st_i1"][r]), int(res["st_i0"][r])
                if i0 in used0 or fd0.lid[i0] >= 0 or fd1.lid[i1] >= 0:
                    continue
                used0.add(i0)
                lid = est.add_landmark(res["st_hp"][r])
                if lid < 0:
                    continue
                self.lm_desc[lid] = fd0.packed[i0]
                fd0.lid[i0] = lid
                fd1.lid[i1] = lid
                new_lid.append(lid)
                new_i0.append(i0)
                new_i1.append(i1)
                n_stereo += 1
            if new_lid:
                est.add_observations_batch(fid, 0, new_lid, fd0.uv[np.asarray(new_i0)])
                est.add_observations_batch(fid, 1, new_lid, fd1.uv[np.asarray(new_i1)])

        n_motion = 0
        kfd = self.frames[kf_fid][0] if kf_fid in self.frames else None
        kf_live = kfd is not None and any(f.fid == kf_fid for f in est.frames)
        if kf_live and st["motion_on"]:
            fd = frame_data[0]
            used_k = set()
            new_lid, new_ic, new_ik = [], [], []
            for r in range(len(res["mo_ic"])):
                i_c, i_k = int(res["mo_ic"][r]), int(res["mo_ik"][r])
                if i_k in used_k or fd.lid[i_c] >= 0 or kfd.lid[i_k] >= 0:
                    continue
                used_k.add(i_k)
                lid = est.add_landmark(res["mo_hp"][r])
                if lid < 0:
                    continue
                self.lm_desc[lid] = kfd.packed[i_k]
                fd.lid[i_c] = lid
                kfd.lid[i_k] = lid
                new_lid.append(lid)
                new_ic.append(i_c)
                new_ik.append(i_k)
                n_motion += 1
            if new_lid:
                est.add_observations_batch(kf_fid, 0, new_lid, kfd.uv[np.asarray(new_ik)])
                est.add_observations_batch(fid, 0, new_lid, fd.uv[np.asarray(new_ic)])
        return n_map, n_stereo, n_motion

    def associate(self, fid: int, frame_data: List[FrameData]):
        """Stages 3 + 6; returns (n_map, n_stereo, n_motion) and updates the
        estimator tables."""
        f = self.est.get_state(fid)
        st = self._assoc_stage(f.T_WS)
        res = self._assoc_core(f.T_WS, st, frame_data)
        return self._assoc_consume(fid, frame_data, st, res)

    # ------------------------------------------------------- keyframe policy
    @staticmethod
    def _dilate_disc(m: np.ndarray, r: int) -> np.ndarray:
        """Binary dilation with a disc structuring element via shifts."""
        out = m.copy()
        H, W = m.shape
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dx * dx + dy * dy > r * r or (dx == 0 and dy == 0):
                    continue
                src = m[max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)]
                out[max(0, dy):H - max(0, -dy), max(0, dx):W - max(0, -dx)] |= src
        return out

    def _coverage_masks(self, fd: FrameData, cam_np, sel_match: np.ndarray):
        """Detection/match disc-coverage masks at 1/10 resolution."""
        h, w = max(cam_np.height // 10, 1), max(cam_np.width // 10, 1)
        r = max(int(min(h, w) * 0.09), 1)
        cx = np.clip((fd.uv[:, 0] * 0.1).astype(int), 0, w - 1)
        cy = np.clip((fd.uv[:, 1] * 0.1).astype(int), 0, h - 1)
        det = np.zeros((h, w), bool)
        det[cy[fd.valid], cx[fd.valid]] = True
        mat = np.zeros((h, w), bool)
        sm = sel_match & fd.valid
        mat[cy[sm], cx[sm]] = True
        return self._dilate_disc(det, r), self._dilate_disc(mat, r)

    def need_keyframe(self, frame_data: List[FrameData]) -> bool:
        """Disc-coverage IoU of matched vs detected keypoints, minimised with
        the best shared-landmark coverage in any held keyframe; keyframe when
        the overlap drops to `keyframe_overlap` or below."""
        matched = sum(int((fd.lid >= 0).sum()) for fd in frame_data)
        total = sum(int(fd.valid.sum()) for fd in frame_data)
        if total == 0:
            return True
        if not self.cfg.keyframe_use_overlap:
            return matched / total < self.cfg.keyframe_match_fraction
        if len(self.est.frames) < 4:
            return True
        if total < 7 * len(frame_data):
            return False
        inter = union = 0
        lm_ids = set()
        for c, fd in enumerate(frame_data):
            det, mat = self._coverage_masks(fd, self.np_cameras[c], fd.lid >= 0)
            inter += int((det & mat).sum())
            union += int((det | mat).sum())
            lm_ids.update(fd.lid[fd.lid >= 0].tolist())
        overlap = inter / max(union, 1)
        others = 0.0
        kf_fids = [f.fid for f in self.est.frames if f.is_keyframe and f.fid in self.frames]
        lm_arr = np.fromiter(lm_ids, np.int64, len(lm_ids))
        for ofid in kf_fids:
            o_inter = o_union = 0
            for c, ofd in enumerate(self.frames[ofid]):
                det, mat = self._coverage_masks(ofd, self.np_cameras[c], np.isin(ofd.lid, lm_arr))
                o_inter += int((det & mat).sum())
                o_union += int((det | mat).sum())
            others = max(others, o_inter / max(o_union, 1))
        return min(overlap, others) <= self.cfg.keyframe_overlap

    def _tracking_quality(self, frame_data) -> TrackingQuality:
        """Fraction of grid cells holding at least one matched keypoint."""
        g = self.cfg.quality_grid
        covered = 0
        total = 0
        for c, fd in enumerate(frame_data):
            cam = self.cameras[min(c, len(self.cameras) - 1)]
            total += g * g
            sel = fd.lid >= 0
            if not np.any(sel):
                continue
            uv = fd.uv[sel]
            cx = np.clip((uv[:, 0] / cam.width * g).astype(int), 0, g - 1)
            cy = np.clip((uv[:, 1] / cam.height * g).astype(int), 0, g - 1)
            covered += len(set(zip(cx.tolist(), cy.tolist())))
        frac = covered / max(total, 1)
        self.last_quality_fraction = frac
        if frac < self.cfg.quality_lost:
            return TrackingQuality.LOST
        if frac < self.cfg.quality_marginal:
            return TrackingQuality.MARGINAL
        return TrackingQuality.GOOD

    # ---------------------------------------------------------- loop closure
    _LC_MAX_CAND = 3

    def _lm_snapshot(self, fd: FrameData) -> np.ndarray:
        """(N, 3) world positions of the keypoints' landmarks, NaN where a
        keypoint has none."""
        lm_pos = np.full((len(fd.uv), 3), np.nan)
        for k in np.nonzero(fd.lid >= 0)[0]:
            lid = fd.lid[k]
            if lid in self.est.lm_index:
                hp = self.est.hp_W[self.est.lm_index[lid]]
                if abs(hp[3]) > 1e-9:
                    lm_pos[k] = hp[:3] / hp[3]
        return lm_pos

    def _record_keyframe(self, fid: int, t: float, frame_data: List[FrameData]):
        """Keep what place recognition needs of a keyframe.  Its descriptors
        go to the device here, once: the vocabulary descent and every later
        match against it read them there."""
        dev = self.device
        rec = dict(t=t, T_WS=self.est.get_state(fid).T_WS.copy(), path=self.path_length)
        for c, fd in enumerate(frame_data[:2]):
            sfx = "" if c == 0 else str(c)
            rec.update({
                f"packed{sfx}": fd.packed.copy(), f"valid{sfx}": fd.valid.copy(),
                f"uv{sfx}": fd.uv.copy(), f"lm_pos{sfx}": self._lm_snapshot(fd),
                f"lid{sfx}": fd.lid.copy(),
                f"packed{sfx}_d": torch.as_tensor(np.ascontiguousarray(fd.packed, np.int32),
                                                  device=dev),
                f"valid{sfx}_d": torch.as_tensor(fd.valid, device=dev),
            })
        self.kf_records[fid] = rec

    def _keyframe_words(self, rec: dict) -> np.ndarray:
        """Vocabulary words of a record's cam-0 descriptors (kept in it)."""
        words = bow.assign_packed(rec["packed_d"], rec["valid_d"], self.vocab).cpu().numpy()
        rec["words"] = words
        return words

    def _attempt_loop_closure(self, fid: int, t: float) -> bool:
        """Propose (BoW query + RANSAC) and accept (graph surgery) in line."""
        rec = self.kf_records[fid]
        exclude = {f for f, r in self.kf_records.items() if t - r["t"] < self.cfg.loop_min_gap_s}
        try:
            cur_p = self.est.get_state(fid).T_WS[:3]
        except KeyError:
            cur_p = rec["T_WS"][:3]
        prop = self._lc_propose(fid, rec, exclude, cur_p)
        return prop is not None and self._lc_accept(prop)

    def _lc_propose(self, fid: int, rec: dict, exclude: set, cur_p):
        """Place-recognition proposal: words, BoW query and database add,
        candidate policy, RANSAC verification.  BoW proposes, geometry
        decides: the top two retrievals are always verified, a third only
        when its score clears p_dbow or stands out from the retrieval bulk.
        Returns a proposal dict or None."""
        cfg = self.cfg
        words = self._keyframe_words(rec)
        res = self.bow_db.query(words, rec["valid"], exclude=exclude, top=8)
        self.bow_db.add(fid, words, rec["valid"])
        if not res:
            return None
        bulk = float(np.mean([s for _, s in res]))
        sel = []
        for rank, (cf, score) in enumerate(res[:3]):
            if rank >= 2 and not (score >= cfg.p_dbow
                                  or (score >= cfg.p_prominence * bulk and score >= 0.05)):
                continue
            cand = self.kf_records.get(cf)
            if cand is not None:
                sel.append((cf, cand))
        if not sel:
            return None
        ver = self._geometric_verify_batch(fid, rec, sel, cur_p)
        if ver is None:
            return None
        cand_fid, T_WS_est, n_inl, pairs = ver
        cand = next(cd for cf, cd in sel if cf == cand_fid)
        # the candidate pose of the epoch the RANSAC ran in
        return dict(fid=fid, cand_fid=cand_fid, T_WS_est=T_WS_est, n_inl=n_inl,
                    pairs=pairs, cand_T_WS=np.asarray(cand["T_WS"]).copy())

    def _lc_accept(self, prop: dict) -> bool:
        """Drift-budget gate against the current estimate, then the loop
        edge and in-line pose-graph solve, the held candidate frame and the
        landmark merges."""
        cfg = self.cfg
        fid, cand_fid = prop["fid"], prop["cand_fid"]
        rec = self.kf_records.get(fid)
        cand = self.kf_records.get(cand_fid)
        if rec is None or cand is None:
            return False
        T_cand_cur = se3np.se3_multiply(se3np.se3_inverse(prop["cand_T_WS"]),
                                        np.asarray(prop["T_WS_est"]))
        try:
            T_WS_cur = self.est.get_state(fid).T_WS
        except KeyError:
            T_WS_cur = rec["T_WS"]
        T_pred = se3np.se3_multiply(np.asarray(cand["T_WS"]), T_cand_cur)
        correction = np.linalg.norm(T_pred[:3] - T_WS_cur[:3])
        dist = max(self.path_length - cand["path"], 0.5)
        if correction > cfg.drift_percentage / 100.0 * dist + 0.2:
            return False
        sqrt_info = np.eye(6) * (10.0 * np.sqrt(prop["n_inl"]))
        if not self.est.close_loop(fid, cand_fid, T_cand_cur, sqrt_info):
            return False
        self._hold_loopclosure_frame(cand_fid)
        self._merge_loop_landmarks(rec, cand, prop["pairs"])
        self.n_loop_closures += 1
        self._lc_last_path = self.path_length
        self._refresh_kf_poses()
        return True

    def _hold_loopclosure_frame(self, cand_fid: int):
        """Bring the recognised keyframe and its landmarks back into the
        window, holding at most num_loopclosure_frames of them.  The restore
        budget is bounded by the observation headroom and a quarter of the
        landmark table, so old-map landmarks cannot starve the frontier."""
        if cand_fid in self.lc_frames:
            return
        ecfg = self.est.cfg
        budget = max(64, min(ecfg.cap_obs // 8, ecfg.cap_landmarks // 4))
        rec = self.kf_records.get(cand_fid)
        if rec is not None:
            for key_l, key_p in (("lid", "packed"), ("lid1", "packed1")):
                lid_arr = rec.get(key_l)
                if lid_arr is None:
                    continue
                for k in np.nonzero(lid_arr >= 0)[0]:
                    self.lm_desc.setdefault(int(lid_arr[k]), rec[key_p][k])
        if self.est.add_loopclosure_frame(cand_fid, max_restore=budget):
            self.lc_frames.append(cand_fid)
            while len(self.lc_frames) > self.cfg.num_loopclosure_frames:
                self.est.remove_loopclosure_frame(self.lc_frames.pop(0))

    def _merge_loop_landmarks(self, rec: dict, cand: dict, pairs) -> int:
        """Merge current landmarks into the re-observed old ones along the
        RANSAC inliers (cam, current keypoint, candidate keypoint): the old
        id survives."""
        merged = 0
        for c, k_cur, k_cand in pairs:
            key = "lid" if c == 0 else f"lid{c}"
            cand_lid, cur_lid = cand.get(key), rec.get(key)
            if cand_lid is None or cur_lid is None:
                continue
            lo, ln = int(cand_lid[k_cand]), int(cur_lid[k_cur])
            if lo < 0 or ln < 0 or lo == ln:
                continue
            if self.est.merge_landmarks(lo, ln):
                merged += 1
        self.n_landmarks_merged += merged
        return merged

    def _refresh_kf_poses(self):
        """After a correction, move every record's pose and landmark
        snapshot rigidly by its keyframe's pose change, so later loop edges
        do not embed the correction as error."""
        for f2, r2 in self.kf_records.items():
            st = self.est.archive_frames.get(f2)
            if st is None:
                try:
                    st = self.est.get_state(f2)
                except KeyError:
                    continue
            T_old = np.asarray(r2["T_WS"])
            T_new = st.T_WS.copy()
            if np.allclose(T_old, T_new, atol=1e-12):
                continue
            dT = se3np.se3_multiply(T_new, se3np.se3_inverse(T_old))
            R = se3np.quat_to_matrix(dT[3:7])
            for key in ("lm_pos", "lm_pos1"):
                lm = r2.get(key)
                if lm is None:
                    continue
                ok = np.isfinite(lm[:, 0])
                lm[ok] = lm[ok] @ R.T + dT[:3]
            r2["T_WS"] = T_new

    def _lc_cam_keys(self, rec: dict):
        return [0, 1] if "packed1" in rec else [0]

    def _lc_match(self, rec: dict, sel):
        """Mutual best matching of the query keyframe against up to
        _LC_MAX_CAND candidate records, per camera: ONE launch of the fused
        match kernel against the candidates concatenated along the database
        axis, one segment a candidate, which gives the row argmins per
        candidate and the column argmins.  Invalid rows and columns, and
        empty candidate slots, are masked to 1e9 as in the JAX package.
        Returns numpy (idx (B, C, N), ok (B, C, N))."""
        dev = self.device
        Bc, N = self._LC_MAX_CAND, self.cfg.max_keypoints
        thr = float(self.cfg.matching_threshold)
        cams = self._lc_cam_keys(rec)
        zp = torch.zeros((N, hamming.WORDS), dtype=torch.int32, device=dev)
        zv = torch.zeros((N,), dtype=torch.bool, device=dev)
        ar = torch.arange(N, device=dev)
        first = torch.arange(Bc, device=dev)[:, None] * N  # first column of each block
        mis, oks = [], []
        for c in cams:
            sfx = "" if c == 0 else str(c)
            q, qv = rec[f"packed{sfx}_d"], rec[f"valid{sfx}_d"]
            db, dv = [], []
            for b in range(Bc):
                cand = sel[b][1] if b < len(sel) else {}
                db.append(cand.get(f"packed{sfx}_d", zp))
                dv.append(cand.get(f"valid{sfx}_d", zv))
            dv = torch.stack(dv)  # (B, M)
            md, mi, back = hamming.hamming_match(
                q, qv, torch.cat(db), dv.reshape(-1), seg=N, fill_invalid=10 ** 9,
                want_cols=True, site="lc_match")
            mi = mi.T - first  # (B, N) columns within each candidate
            mutual = torch.gather(back.reshape(Bc, N), 1, mi) == ar
            ok = mutual & (md.T <= thr) & qv[None] & torch.gather(dv, 1, mi)
            mis.append(mi)
            oks.append(ok)
        return (torch.stack(mis, 1).cpu().numpy(), torch.stack(oks, 1).cpu().numpy())

    def _geometric_verify_batch(self, fid: int, rec: dict, sel, cur_p):
        """Verify up to _LC_MAX_CAND candidates: packed matching, then ONE
        batched non-central RANSAC of the rig's rays (body frame, per-camera
        origins) against each candidate's landmark snapshot, depth prior
        from the current position.  The candidate with the most inliers
        wins.  Returns (cand_fid, T_WS in the candidate's epoch, inliers,
        inlier (cam, cur kp, cand kp) pairs) or None.

        Hypotheses are drawn from a torch.Generator seeded with the frame id
        (the JAX package seeds jax.random with it; the two streams differ)."""
        cfg = self.cfg
        Bc = self._LC_MAX_CAND
        cams = self._lc_cam_keys(rec)
        mi, ok = self._lc_match(rec, sel)
        cap = 2 * cfg.max_keypoints
        rays_b = np.zeros((Bc, cap, 3))
        orig_b = np.zeros((Bc, cap, 3))
        pts_b = np.zeros((Bc, cap, 3))
        mask_b = np.zeros((Bc, cap), bool)
        depth_b = np.ones((Bc, cap))
        pairs_b = [[] for _ in range(Bc)]
        for b, (_cf, cand) in enumerate(sel[:Bc]):
            rays_l, orig_l, pts_l, pair_l = [], [], [], []
            for c, ci in enumerate(cams):
                sfx = "" if ci == 0 else str(ci)
                lk = f"lm_pos{sfx}"
                if lk not in cand:
                    continue
                has_lm = np.isfinite(cand[lk][:, 0])
                keep = np.nonzero(ok[b, c] & has_lm[mi[b, c]])[0]
                if len(keep) == 0:
                    continue
                rays_C, okp = pinhole_np.back_project_unit(self.np_cameras[ci],
                                                           rec[f"uv{sfx}"][keep])
                keep, rays_C = keep[okp], rays_C[okp]
                R_SC = se3np.quat_to_matrix(self.T_SC[ci][3:7])
                rays_l.append(rays_C @ R_SC.T)
                orig_l.append(np.tile(self.T_SC[ci][:3], (len(keep), 1)))
                pts_l.append(cand[lk][mi[b, c][keep]])
                pair_l.extend((ci, int(kc), int(kd)) for kc, kd in zip(keep, mi[b, c][keep]))
            if len(pair_l) < cfg.loop_min_inliers:
                continue
            n = min(len(pair_l), cap)
            rays_b[b, :n] = np.concatenate(rays_l)[:n]
            orig_b[b, :n] = np.concatenate(orig_l)[:n]
            p3 = np.concatenate(pts_l)[:n]
            pts_b[b, :n] = p3
            mask_b[b, :n] = True
            depth_b[b, :n] = np.linalg.norm(p3 - cur_p, axis=-1)
            pairs_b[b] = pair_l[:n]
        if not mask_b.any():
            return None
        dev, dtype = self.device, self.est.cfg.dtype
        F = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        res = ransac.absolute_pose_noncentral(
            F(rays_b), F(orig_b), F(pts_b), torch.as_tensor(mask_b, device=dev), F(depth_b),
            n_hyp=512, generator=torch.Generator().manual_seed(int(fid)),
        )
        n_inl_b = res.num_inliers.cpu().numpy()
        best = int(np.argmax(n_inl_b))
        if not pairs_b[best] or int(n_inl_b[best]) < cfg.loop_min_inliers:
            return None
        inl = res.inliers[best].cpu().numpy()[: len(pairs_b[best])]
        pairs = [pairs_b[best][i] for i in np.nonzero(inl)[0]]
        T = res.T[best].cpu().numpy().astype(np.float64)
        return sel[best][0], T, int(n_inl_b[best]), pairs

    # ------------------------------------------------------------ frame loop
    def add_imu_measurement(self, t, gyr, acc):
        self.est.add_imu_measurement(t, gyr, acc)

    def _finish_frame(self, fid: int, t: float, is_kf: bool) -> bool:
        """Post-solve stages: descriptor refresh, path length, loop closure
        on keyframes (then a window re-solve), marginalisation, release of
        held loop-closure frames the window has moved past, pruning of dead
        per-frame data.  Returns whether a loop closed."""
        est = self.est
        frame_data = self.frames.get(fid)
        if frame_data is not None:
            # refresh landmark descriptors with the freshest observation
            for fd in frame_data:
                for k in np.nonzero(fd.lid >= 0)[0]:
                    self.lm_desc[fd.lid[k]] = fd.packed[k]
        f = est.get_state(fid)
        if self._last_solved_T is not None:
            self.path_length += float(np.linalg.norm(f.T_WS[:3] - self._last_solved_T[:3]))
        self._last_solved_T = f.T_WS.copy()

        looped = False
        if is_kf and self.cfg.do_loop_closures and frame_data is not None:
            # in the cooldown after a closure keyframes are recorded and
            # indexed, but not queried
            in_cooldown = self.path_length - self._lc_last_path < self.cfg.loop_cooldown_m
            with timing.Timer("2.8 LoopClosure"):
                self._record_keyframe(fid, t, frame_data)
                if not in_cooldown:
                    looped = self._attempt_loop_closure(fid, t)
                else:
                    rec = self.kf_records[fid]
                    self.bow_db.add(fid, self._keyframe_words(rec), rec["valid"])
        if looped:
            est.optimise()

        with timing.Timer("2.9 Marginalise"):
            est.marginalise()
        # a held frame pins its restored observations and landmarks: once
        # it shares fewer than 5 landmarks with the current frame it goes
        # back to the archive
        if self.lc_frames:
            cur_lids = np.unique(est.obs_lid[est.obs_fid == fid])
            for old_fid in list(self.lc_frames):
                m_lc = est.obs_fid == old_fid
                shared = int(np.isin(est.obs_lid[m_lc], cur_lids).sum()) if m_lc.any() else 0
                if shared < 5:
                    self.lc_frames.remove(old_fid)
                    est.remove_loopclosure_frame(old_fid)
        live = {fr.fid for fr in est.frames}
        self.frames = {k: v for k, v in self.frames.items() if k in live}
        self.lm_desc = {l: d for l, d in self.lm_desc.items() if l in est.lm_index}
        return looped

    def process_frame(self, t: float, images: List[np.ndarray], depth_images=None):
        if depth_images is not None:
            raise NotImplementedError("depth input is not ported yet")
        est = self.est
        with timing.Timer("2.1 AddState"):
            fid = est.add_state(t)
        f = est.get_state(fid)
        with timing.Timer("2.2 DetectDescribe"):
            frame_data = self.detect_and_describe(images, f.T_WS)
        self.frames[fid] = frame_data
        with timing.Timer("2.3 Associate"):
            n_map, n_stereo, n_motion = self.associate(fid, frame_data)
        quality = self._tracking_quality(frame_data)
        is_kf = self.need_keyframe(frame_data)
        est.set_keyframe(fid, is_kf)
        if is_kf:
            self.last_kf_fid = fid
        est.repredict_latest()
        gate_px = self.cfg.chi2_px * est.cfg.keypoint_sigma_px * 3
        with timing.Timer("2.6 OptimiseGated"):
            est.optimise_gated(fid, gate_px)
        looped = self._finish_frame(fid, t, is_kf)
        f = est.get_state(fid)
        self.states_log.append((t, f.T_WS.copy()))
        return dict(
            fid=fid, is_keyframe=is_kf, keyframe_fid=fid if is_kf else None,
            n_map=n_map, n_stereo=n_stereo, n_motion=n_motion, T_WS=f.T_WS.copy(),
            loop_closure=looped, tracking_quality=quality,
        )

    def load_component(self, path: str, fixed: bool = True) -> bool:
        raise NotImplementedError("multi-session relocalisation is not ported yet")

    def finish(self):
        """Dataset end.  The synchronous path keeps no solve, recognition
        result or background optimisation in flight, so there is nothing to
        collect; `est.final_ba()` may follow."""
