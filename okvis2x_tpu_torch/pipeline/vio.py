"""Per-frame VIO pipeline: detection -> association -> estimation ->
marginalisation (torch counterpart of ``okvis2x_tpu/pipeline/vio.py``).

Stages per frame:
  1. add_state: IMU propagation to the frame time (estimator, host);
  2. detect & describe every camera (device);
  3. association (device): match-to-map per camera with a projection gate,
     rig-stereo initialisation with an epipolar gate, motion stereo against
     the last keyframe; every Hamming distance comes from the fused match
     kernel (``ops.hamming``);
  4. pose refinement (`pose_refine`): a 3-iteration pose-only solve with
     the landmarks held, then the chi2 outlier cut of the frame's
     observations (`reject_outliers`);
  5. keyframe decision by disc-coverage overlap (host);
  6. gated window solve (estimator).  With `pipelined_solve` it is built
     here and collected one frame later (`_collect_pending`): the next
     frame associates against the one-frame-stale map, and the state log
     entry, the IMU prediction until then, is corrected when it lands;
  7. loop closure on keyframes: vocabulary words and a tf-idf query
     (``frontend/bow.py``), mutual matching against up to three candidates
     on the fused match kernel, batched non-central RANSAC
     (``frontend/ransac.py``), then on the frame thread a drift-budget
     gate, the loop edge, the candidate held in the window and landmark
     merges.  With `async_place_recognition` the query and verification
     run on a worker thread (its own CUDA stream on a card) and their
     proposals are applied on a later frame; with `async_loop_closure` the
     whole history is optimised on a background thread
     (``graph/fullgraph.py``: the complete factor graph up to
     `full_ba_threshold` keyframes, else the pose graph) and synchronised on
     a later frame, else the pose graph is solved in line, followed by a
     window re-solve;
  8. marginalisation.

With `deferred_frontend` (the flagship configuration of
tools/slam_bench.py) stages 2 and 3 of a frame are one chain of launches on
the frame's CUDA stream with no host sync (`frontend_dispatch`), consumed
`pipeline_depth` frames later (one during the first
`pipeline_ramp_frames`).  Each cycle copies its results to pinned host
memory behind CUDA events: the critical block (keypoints and association)
first, then the rows of the deferred marginalisation edges, then the
descriptors, which only the next frames' tables and the keyframe records
need (`_drain_desc`).  A call waits on the critical event of the oldest
cycle ("2.0 PrefetchWait", the realtime budget's signal), applies the
previous solve and the edges, then the association and keyframe decision,
launches this frame's frontend, then builds the window solve of the frame
just consumed.  So association runs against a map one solve stale, the
keyframe decision is reported one call later, and the edges of a
marginalised keyframe join the graph one cycle late, as in the JAX package.

After the last frame, `finish()` (drain the cycles in flight, collect the
pending solve, drain the worker, join the background optimisation) and
`est.final_ba()` give the refined trajectory (`est.full_trajectory()`).

Without a vocabulary file (`vocab_path=""`, or a path that does not exist)
a flat vocabulary is trained online once `vocab_min_desc` keyframe
descriptors are recorded (`_maybe_train_vocab`); place recognition then
stays on the frame thread.  Multi-session: `save_component` writes the
session, `load_component` brings a saved one in as fixed archived nodes
with negative frame ids and a BoW database of its own, and each keyframe
is first queried against the loaded components (`_attempt_relocalisation`:
the first verified hit moves the session rigidly onto the map frame, then
a loop edge to the component's keyframe); components also keep place
recognition on the frame thread.  `save_map` exports the pose graph and
map in the reference's text layout.

GNSS fixes (`add_gps_measurement`) go to the estimator.  Under online
extrinsics calibration each frame's post-solve stage copies the calibrated
extrinsics into the host-side projections.

RGB-D: `process_frame(..., depth_images=[...])` samples each camera's depth
image (metres, registered to that camera) at the frame's observations and
attaches per-keypoint depth priors (`attach_depth_priors`, sigma =
`depth_sigma0` + `depth_sigma_scale` d^2), and creates landmarks for the
keypoints left unassigned straight from their depth (`depth_initialize`),
after the keyframe decision, on the synchronous, pipelined and deferred
paths alike (the deferred path once the frame's critical block is consumed).

Semantic weighting (also inside the fused frontend) is not part of the port
yet; enabling it raises ``NotImplementedError``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.api import TrackingQuality
from okvis2x_tpu_torch.cameras import pinhole, pinhole_np
from okvis2x_tpu_torch.core import se3, se3np
from okvis2x_tpu_torch.frontend import bow, descriptor, detector, matcher, ransac, triangulation
from okvis2x_tpu_torch.graph import component
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, SlidingWindowEstimator
from okvis2x_tpu_torch.graph.fullgraph import FullGraphOptimizer
from okvis2x_tpu_torch.io import debug_csv
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
    # loop closure: the shipped vocabulary when vocab_path is None; with
    # vocab_path "" or a missing file a flat vocabulary of vocab_k words is
    # trained online once vocab_min_desc keyframe descriptors are recorded;
    # candidates are the top BoW retrievals (a third one only above p_dbow
    # or p_prominence x the retrieval mean), verified by RANSAC with
    # loop_min_inliers, accepted within drift_percentage of the path since
    # the candidate, and at most one per loop_cooldown_m of path
    do_loop_closures: bool = True
    vocab_k: int = 256
    vocab_min_desc: int = 4000
    vocab_path: Optional[str] = None
    p_dbow: float = 0.4
    p_prominence: float = 1.15
    # RGB-D: per-keypoint depth priors from depth images, sigma(d) =
    # depth_sigma0 + depth_sigma_scale * d^2 for depth_min < d < depth_max
    depth_sigma0: float = 0.02
    depth_sigma_scale: float = 0.0025
    depth_min: float = 0.1
    depth_max: float = 25.0
    loop_min_gap_s: float = 5.0
    loop_min_inliers: int = 15
    loop_cooldown_m: float = 3.0
    drift_percentage: float = 1.35  # % of the distance travelled
    num_loopclosure_frames: int = 3  # held in the window for merging
    # keyframe query and verification on a worker thread; proposals are
    # applied on the frame thread at a later frame
    async_place_recognition: bool = True
    # the pose graph of an accepted closure solved on a background thread
    # and synchronised on a later frame (else in line)
    async_loop_closure: bool = False
    full_graph_iterations: int = 15
    # the background optimisation solves the complete factor graph up to
    # this many keyframes, the pose graph above (0: always the pose graph)
    full_ba_threshold: int = 0
    # 3-iteration pose-only solve and outlier cut before the window solve
    pose_refine: bool = True
    # the window solve collected one frame later
    pipelined_solve: bool = True
    # the deferred fused frontend: detection, description and association
    # launched as one chain without a host sync and consumed
    # `pipeline_depth` frames later (depth 1 during the first
    # `pipeline_ramp_frames`); pose refinement does not run in this mode
    deferred_frontend: bool = False
    pipeline_depth: int = 1
    pipeline_ramp_frames: int = 25
    # semantic keypoint weighting: not ported, must stay "off"
    segmentation: str = "off"

    def check_ported(self):
        if self.segmentation != "off":
            raise NotImplementedError("semantic keypoint weighting is not ported yet "
                                      "(neither in the synchronous nor in the fused frontend)")


# stereo / motion-stereo initialisations accepted per frame (the first
# ASSOC_CAP in keypoint order)
ASSOC_CAP = 256


class FrameData:
    """Per-frame detection results, host side.  Under the deferred frontend
    `packed` is None until the frame's descriptor block lands
    (`_drain_desc`); the landmark descriptors assigned meanwhile wait in
    `desc_todo` as (landmark id, keypoint)."""

    def __init__(self, uv, valid, packed):
        self.uv = uv  # (N, 2) float64
        self.valid = valid  # (N,) bool
        self.packed = packed  # (N, 12) int32, or None while in flight
        self.lid = np.full(uv.shape[0], -1, np.int64)  # landmark assignment
        self.desc_todo: list = []


# the association's outputs, in the order of the critical block
ASSOC_KEYS = ("map_rows", "st_i1", "st_i0", "st_hp", "mo_ic", "mo_ik", "mo_hp")


def _first_true(ok: torch.Tensor, S: int) -> torch.Tensor:
    """(S,) indices of the first S true entries of `ok`, in order, then -1:
    a compaction of fixed size that needs no host sync (unlike nonzero)."""
    pos = torch.cumsum(ok.to(torch.int64), 0) - 1
    slot = torch.where(ok & (pos < S), pos, torch.full_like(pos, S))
    out = torch.full((S + 1,), -1, dtype=torch.int64, device=ok.device)
    return out.scatter_(0, slot, torch.arange(ok.shape[0], device=ok.device))[:S]


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
        # debug CSV writers (≙ ViInterface::setImuCsvFile/setTracksCsvFile)
        self._imu_csv = None
        self._tracks_csv: Dict[int, debug_csv.TracksCsvWriter] = {}
        self.last_quality_fraction = 0.0
        self.path_length = 0.0
        self._last_solved_T = None
        # pipelined solve: the handle of the previous frame's window solve
        self._pending = None

        # loop closure: keyframe records (descriptors, landmark snapshot,
        # pose), the vocabulary and its database, held loop-closure frames
        self.kf_records: Dict[int, dict] = {}
        self.lc_frames: List[int] = []
        self.n_loop_closures = 0
        self.n_landmarks_merged = 0
        self._lc_last_path = -1e9
        # the vocabulary: the file when there is one, else trained online
        # (`_vocab_pretrained` False keeps place recognition synchronous)
        self.vocab = None
        self.bow_db = None
        self._vocab_pretrained = False
        if cfg.do_loop_closures and cfg.vocab_path != "":
            path = cfg.vocab_path or bow.DEFAULT_VOCAB
            if os.path.exists(path):
                self.vocab = bow.HierVocabulary.load(path, device=self.device)
                self.bow_db = bow.BowDatabase(k=self.vocab.n_words)
                self._vocab_pretrained = True
            else:
                logging.warning(
                    "BoW vocabulary %s not found — falling back to online "
                    "flat-vocab training (loop-closure recall degrades "
                    "until ~%d descriptors are seen)", path, cfg.vocab_min_desc)
        # asynchronous place recognition: the worker takes keyframes from
        # _lc_queue and puts proposals on _lc_results; _lc_active is held
        # while it runs an item, so the frame thread never moves record
        # snapshots under a verification
        self._lc_active = threading.Lock()
        self._lc_thread = None
        self._lc_queue = None
        self._lc_results = None
        self._lc_stream = None
        self._lc_skipped = 0  # keyframes demoted to index-only under backlog
        if cfg.do_loop_closures and cfg.async_place_recognition:
            self._lc_queue = queue.Queue()
            self._lc_results = queue.Queue()
            if self.device.type == "cuda":
                self._lc_stream = torch.cuda.Stream(self.device)
            self._lc_thread = threading.Thread(target=self._lc_worker_loop,
                                               name="place-recognition", daemon=True)
            self._lc_thread.start()
        # multi-session: loaded components (each with its own BoW database,
        # ≙ Frontend::componentDBows_) and the relocalisation status
        self.components: List[dict] = []
        self.relocalised = False
        self.n_relocalisations = 0
        self.full_graph = FullGraphOptimizer(iterations=cfg.full_graph_iterations,
                                             dtype=dtype,
                                             full_ba_threshold=cfg.full_ba_threshold)

        # deferred frontend: the cycles in flight (oldest first), the solve
        # handle waiting to ride the next cycle, the frame whose solve is
        # still to be built, what the last consume reported, the descriptor
        # blocks not folded in yet (fid -> (cycle, frame data)) and the
        # keyframes whose loop-closure record waits on them
        self._inflight = collections.deque()
        self._next_solve = None
        self._solve_todo = None
        self._n_frames_seen = 0
        self._last_counts = (0, 0, 0)
        self._last_quality = None
        self._kf_event = (None, False)
        self._desc_pending: Dict[int, tuple] = {}
        self._kf_lc_todo: Dict[int, float] = {}
        self.n_desc_late = 0  # descriptor blocks still in flight at a _drain_desc()
        if cfg.deferred_frontend:
            self.est.defer_edge_jobs = True

        # constants of the association on the device, made once: a copy from
        # the host inside the frame's launch chain would be a host sync.
        # Under online calibration the association keeps these initial
        # extrinsics while the host-side projections follow the calibrated
        # ones: the JAX package's association programs capture T_SC when they
        # are first built and are cached (ROADMAP.md C-R11); kept for parity
        F = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)  # noqa: E731
        self._T_SC_d = F(self.T_SC)
        if self.num_cams >= 2:
            T_C1C0 = se3np.se3_multiply(se3np.se3_inverse(self.T_SC[1]), self.T_SC[0])
            T_C0C1 = se3np.se3_inverse(T_C1C0)
            self._rig = dict(
                E=_f32(F(se3np.cross_matrix(T_C1C0[:3]) @ se3np.quat_to_matrix(T_C1C0[3:7]))),
                fpx=float(self.np_cameras[1].fxfycxcy[1]),
                p_B=_f32(F(T_C0C1[:3])), R_C0C1=_f32(F(se3np.quat_to_matrix(T_C0C1[3:7]))))
        descriptor.pattern(self.device)

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

    def _pack_images(self, images: List[np.ndarray]) -> np.ndarray:
        """(C, H, W') uint8: every image padded to a width of 128k."""
        imgs = np.stack([self._pad_width(im) for im in images])
        if imgs.dtype != np.uint8:
            imgs = np.clip(imgs * 255.0, 0, 255).astype(np.uint8)
        return imgs

    def _upload(self, x: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the pipeline's device; on a card through pinned
        memory and an asynchronous copy on the current stream, so that the
        host does not wait for the device."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _detect_describe_device(self, imgs_d: torch.Tensor, angles):
        """Stage 2 on the device for every camera of the (C, H, W') uint8
        images: (uv (C, N, 2) float32, valid (C, N), packed (C, N, 12)
        int32)."""
        cfg = self.cfg
        imgs = imgs_d.to(torch.float32) * (1.0 / 255.0)
        uv, valid, packed = [], [], []
        for c in range(imgs.shape[0]):
            kp = detector.detect(
                imgs[c], max_keypoints=cfg.max_keypoints, octaves=cfg.octaves,
                cell=cfg.detection_cell, per_cell=cfg.detection_per_cell,
                threshold=cfg.harris_threshold,
            )
            ang = torch.full((cfg.max_keypoints,), angles[c], dtype=torch.float32,
                             device=self.device)
            packed.append(descriptor.extract(imgs[c], kp.uv, ang, kp.level, kp.valid))
            uv.append(kp.uv)
            valid.append(kp.valid)
        return torch.stack(uv), torch.stack(valid), torch.stack(packed)

    def detect_and_describe(self, images: List[np.ndarray], T_WS_pred: np.ndarray):
        """Stage 2 of the synchronous path: detection and description of
        every camera on the device, read back; one FrameData per camera."""
        imgs_d = torch.from_numpy(self._pack_images(images)).to(self.device)
        uv, valid, packed = self._detect_describe_device(
            imgs_d, self._gravity_angles(len(images), T_WS_pred))
        uv = uv.cpu().numpy().astype(np.float64)
        valid, packed = valid.cpu().numpy(), packed.cpu().numpy()
        return [FrameData(uv=uv[c], valid=valid[c], packed=packed[c])
                for c in range(len(images))]

    def _assoc_stage(self, T_WS: np.ndarray) -> dict:
        """Host staging of the association inputs: landmark table and the
        motion-stereo keyframe around the pose estimate `T_WS`.  Landmarks
        without a descriptor yet (deferred frontend, loop-closure restores)
        get zero words, which match nothing; a keyframe whose descriptor
        block is still in flight gives no motion stereo."""
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
                if kfd.packed is None:
                    kfd, kf_fid = None, None
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

    def _stage_device(self, T_WS: np.ndarray, st: dict) -> dict:
        """The staged association inputs on the device (`_upload`)."""
        f, kf = self.est.cfg.dtype, st["kf"]
        up = self._upload
        return dict(
            T_WS=up(T_WS, f), hp=up(st["hp"], f), lm_valid=up(st["lm_valid"]),
            lm_packs=up(st["packs"].astype(np.int32)), T_CkC=up(st["T_CkC"], f),
            T_WCk=up(st["T_WCk"], f), kf_uv=up(kf["uv"], f), kf_un=up(kf["un"]),
            kf_packs=up(np.asarray(kf["packs"], np.int32)), kf_valid=up(kf["valid"]),
            motion_on=st["motion_on"])

    def _assoc_core(self, kp_uv, kp_valid, kp_packs, s: dict) -> dict:
        """Stages 3 and 6 on the device, without a host sync: map matching
        for every camera with one keypoint kept per landmark, rig-stereo and
        motion-stereo initialisations.  kp_uv (C, N, 2) in the estimator's
        dtype, kp_valid (C, N), kp_packs (C, N, 12) int32; `s` is
        `_stage_device`'s.  The initialisations are compacted into blocks
        of S = min(ASSOC_CAP, N) rows: the first S accepted in keypoint
        order, then -1 (their points are then undefined).  Returns the
        device tensors of ASSOC_KEYS: map_rows (C, N) (-1: unmatched);
        st_i1, st_i0 (S,) cam-1 and cam-0 keypoints with st_hp (S, 4) world
        points; mo_ic, mo_ik (S,) current and keyframe keypoints with mo_hp
        (S, 4)."""
        cfg = self.cfg
        dev, dtype = self.device, self.est.cfg.dtype
        C, N = kp_uv.shape[:2]
        S = min(ASSOC_CAP, N)
        Lcap = self.est.cfg.cap_landmarks
        T_WS, hp, lm_valid, lm_packs = s["T_WS"], s["hp"], s["lm_valid"], s["lm_packs"]
        T_SC = self._T_SC_d
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

        def compact(ok, idx, hp_all):
            rows = _first_true(ok, S)
            safe = rows.clamp(min=0)
            return rows, torch.where(rows >= 0, idx[safe], rows), hp_all[safe]

        # ---- rig stereo initialisation
        cam0 = self.cameras[0]
        r0, v0 = pinhole.back_project(cam0, kp_uv[0])
        stereo_assigned0 = torch.zeros((N,), dtype=torch.bool, device=dev)
        if C >= 2:
            rig = self._rig
            un0 = kp_valid[0] & ~assigned[0]
            un1 = kp_valid[1] & ~assigned[1]
            r1, v1 = pinhole.back_project(self.cameras[1], kp_uv[1])
            lines = r0 @ rig["E"].T
            num = (r1 @ lines.T).abs()
            denom = torch.linalg.norm(lines[:, :2], dim=1)[None, :] + 1e-12
            epi_px = num / denom * rig["fpx"]
            st_allowed = (
                (epi_px < cfg.epipolar_px * 3) & (v1 & un1)[:, None] & (v0 & un0)[None, :]
            )
            mst = matcher.match_masked(kp_packs[1], kp_valid[1], kp_packs[0], kp_valid[0],
                                       st_allowed, max_dist=cfg.stereo_max_dist)
            x0 = r0[mst.idx_b]
            e_A = x0 / torch.linalg.norm(x0, dim=-1, keepdim=True)
            eb = r1 @ rig["R_C0C1"].T
            e_B = eb / torch.linalg.norm(eb, dim=-1, keepdim=True)
            tri = triangulation.triangulate(torch.zeros_like(e_A), e_A,
                                            rig["p_B"].expand(N, 3), e_B)
            depth = tri.hp_A[:, 2] / torch.clamp(tri.hp_A[:, 3], min=1e-12)
            st_ok = (
                mst.valid & tri.valid & ~tri.parallel
                & (depth > cfg.min_triangulation_depth) & (depth < cfg.max_triangulation_depth)
            )
            T_WC0 = se3.se3_multiply(T_WS, T_SC[0])
            st_i1, st_i0, st_hp = compact(st_ok, mst.idx_b,
                                          se3.se3_apply_homogeneous(T_WC0, tri.hp_A))
            # every cam-0 keypoint a stereo match took (not only the first S)
            stereo_assigned0 = torch.zeros((N + 1,), dtype=torch.bool, device=dev).index_fill_(
                0, torch.where(st_ok, mst.idx_b, N), True)[:N]
        else:
            st_i1 = st_i0 = torch.full((S,), -1, dtype=torch.int64, device=dev)
            st_hp = torch.zeros((S, 4), dtype=dtype, device=dev)

        # ---- motion stereo against the last keyframe, cam0
        un_c = kp_valid[0] & ~assigned[0] & ~stereo_assigned0
        r_k, v_k = pinhole.back_project(cam0, s["kf_uv"])
        mo_allowed = (
            (un_c & v0)[:, None] & (s["kf_un"] & v_k)[None, :] & bool(s["motion_on"])
        )
        mmo = matcher.match_masked(kp_packs[0], kp_valid[0], s["kf_packs"], s["kf_valid"],
                                   mo_allowed, max_dist=cfg.stereo_max_dist, mutual=True)
        T_CkC = s["T_CkC"]
        R_k = _f32(se3.quat_to_matrix(se3.se3_q(T_CkC)))
        p_Bk = _f32(se3.se3_t(T_CkC))
        xk = r_k[mmo.idx_b]
        e_A = xk / torch.linalg.norm(xk, dim=-1, keepdim=True)
        eb = r0 @ R_k.T
        e_B = eb / torch.linalg.norm(eb, dim=-1, keepdim=True)
        tri = triangulation.triangulate(torch.zeros_like(e_A), e_A, p_Bk.expand(N, 3), e_B)
        depth = tri.hp_A[:, 2] / torch.clamp(tri.hp_A[:, 3], min=1e-12)
        mo_ok = (
            mmo.valid & tri.valid & ~tri.parallel
            & (depth > cfg.min_triangulation_depth) & (depth < cfg.max_triangulation_depth)
        )
        mo_ic, mo_ik, mo_hp = compact(mo_ok, mmo.idx_b,
                                      se3.se3_apply_homogeneous(s["T_WCk"], tri.hp_A))
        return dict(map_rows=torch.stack(map_rows), st_i1=st_i1, st_i0=st_i0, st_hp=st_hp,
                    mo_ic=mo_ic, mo_ik=mo_ik, mo_hp=mo_hp)

    def _assoc_consume(self, fid: int, frame_data: List[FrameData], st: dict, res: dict):
        """Consume the association's results (host arrays of ASSOC_KEYS):
        assign landmark ids, add observations, create stereo/motion
        landmarks; returns (n_map, n_stereo, n_motion).  Matched landmarks
        pruned since the staging are skipped; under the deferred frontend a
        new stereo or motion landmark is identified with an existing one
        that reprojects onto its cam-0 keypoint within 3 px at a consistent
        range (cycles in flight cannot see landmarks born after their
        dispatch)."""
        est = self.est
        nl, lids, kf_fid = st["nl"], st["lids"], st["kf_fid"]
        ix = lambda k: np.asarray(res[k]).astype(np.int64)  # noqa: E731
        map_rows = ix("map_rows")
        st_i1, st_i0, mo_ic, mo_ik = ix("st_i1"), ix("st_i0"), ix("mo_ic"), ix("mo_ik")
        st_hp, mo_hp = np.asarray(res["st_hp"]), np.asarray(res["mo_hp"])

        n_map = 0
        live_lids = np.fromiter(est.lm_index.keys(), np.int64, len(est.lm_index))
        for c, fd in enumerate(frame_data):
            ks = np.nonzero(map_rows[c] >= 0)[0]
            ks = ks[(map_rows[c][ks] < nl) & (fd.lid[ks] < 0)]
            cand = lids[map_rows[c][ks]]
            alive = np.isin(cand, live_lids)
            ks, cand = ks[alive], cand[alive]
            if len(ks) == 0:
                continue
            fd.lid[ks] = cand
            est.add_observations_batch(fid, c, fd.lid[ks], fd.uv[ks])
            n_map += len(ks)

        dedup = None
        if self.cfg.deferred_frontend and est.lm_ids:
            try:
                uv_pred, vis_pred = self._project_landmarks(0, est.get_state(fid).T_WS, est.hp_W)
                w = np.where(np.abs(est.hp_W[:, 3]) > 1e-9, est.hp_W[:, 3], 1.0)
                dedup = (np.array(est.lm_ids, np.int64), est.hp_W[:, :3] / w[:, None],
                         uv_pred, vis_pred)
            except KeyError:
                dedup = None
        claimed = set()
        for fd in frame_data:
            claimed.update(fd.lid[fd.lid >= 0].tolist())

        def dedup_nn(kp_uvs, hps):
            """The landmark reprojecting nearest each candidate's keypoint
            (within 3 px, at a range within 10%), else -1."""
            out = np.full(len(kp_uvs), -1, np.int64)
            if dedup is None or len(kp_uvs) == 0:
                return out
            lids_t, p_t, uv_t, vis_t = dedup
            dpx = np.linalg.norm(uv_t[None, :, :] - kp_uvs[:, None, :], axis=2)
            dpx[:, ~vis_t] = np.inf
            j = np.argmin(dpx, axis=1)
            best = dpx[np.arange(len(j)), j]
            w = np.where(np.abs(hps[:, 3]) > 1e-9, hps[:, 3], 1.0)
            p_new = hps[:, :3] / w[:, None]
            d3 = np.linalg.norm(p_t[j] - p_new, axis=1)
            ok = (best < 3.0) & (d3 < 0.1 * np.maximum(np.linalg.norm(p_new, axis=1), 1.0))
            out[ok] = lids_t[j[ok]]
            return out

        def dedup_or_add(nn_lid, hp_new):
            if nn_lid >= 0 and nn_lid not in claimed and nn_lid in est.lm_index:
                return int(nn_lid)
            return est.add_landmark(hp_new)

        n_stereo = 0
        if self.num_cams >= 2:
            fd0, fd1 = frame_data[0], frame_data[1]
            used0 = set()
            new_lid, new_i0, new_i1 = [], [], []
            rows = np.nonzero(st_i1 >= 0)[0]
            nn = np.full(len(st_i1), -1, np.int64)
            nn[rows] = dedup_nn(fd0.uv[st_i0[rows]], st_hp[rows])
            for r in rows:
                i1, i0 = int(st_i1[r]), int(st_i0[r])
                if i0 in used0 or fd0.lid[i0] >= 0 or fd1.lid[i1] >= 0:
                    continue
                used0.add(i0)
                lid = dedup_or_add(nn[r], st_hp[r])
                if lid < 0:
                    continue
                claimed.add(lid)
                self._set_landmark_desc(lid, fd0, i0)
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
            rows = np.nonzero(mo_ic >= 0)[0]
            nn = np.full(len(mo_ic), -1, np.int64)
            nn[rows] = dedup_nn(fd.uv[mo_ic[rows]], mo_hp[rows])
            for r in rows:
                i_c, i_k = int(mo_ic[r]), int(mo_ik[r])
                if i_k in used_k or fd.lid[i_c] >= 0 or kfd.lid[i_k] >= 0:
                    continue
                used_k.add(i_k)
                lid = dedup_or_add(nn[r], mo_hp[r])
                if lid < 0:
                    continue
                claimed.add(lid)
                self._set_landmark_desc(lid, kfd, i_k)
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

    def _set_landmark_desc(self, lid: int, fd: FrameData, k: int):
        """Give a landmark keypoint k's descriptor of `fd`, or queue the
        assignment while the frame's descriptor block is in flight."""
        if fd.packed is not None:
            self.lm_desc[lid] = fd.packed[k]
        else:
            fd.desc_todo.append((lid, k))

    def associate(self, fid: int, frame_data: List[FrameData]):
        """Stages 3 + 6 of the synchronous path: the association core on
        the frame's keypoints, read back at once; returns (n_map, n_stereo,
        n_motion) and updates the estimator tables."""
        f = self.est.get_state(fid)
        st = self._assoc_stage(f.T_WS)
        dtype = self.est.cfg.dtype
        kp_uv = self._upload(np.stack([fd.uv for fd in frame_data]), dtype)
        kp_valid = self._upload(np.stack([fd.valid for fd in frame_data]))
        kp_packs = self._upload(np.stack([fd.packed for fd in frame_data]).astype(np.int32))
        res = self._assoc_core(kp_uv, kp_valid, kp_packs, self._stage_device(f.T_WS, st))
        return self._assoc_consume(fid, frame_data, st,
                                   {k: v.cpu().numpy() for k, v in res.items()})
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
        match against it read them there.  On a card, the event `ready`
        marks their copies on the frame thread's stream, which the worker's
        stream waits for (records are made in order on one stream, so one
        wait covers every earlier record too)."""
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
        if dev.type == "cuda":
            rec["ready"] = torch.cuda.Event()
            rec["ready"].record()
        self.kf_records[fid] = rec

    def _keyframe_words(self, rec: dict) -> np.ndarray:
        """Vocabulary words of a record's cam-0 descriptors (kept in it)."""
        words = bow.assign_packed(rec["packed_d"], rec["valid_d"], self.vocab).cpu().numpy()
        rec["words"] = words
        return words

    def _use_async_pr(self) -> bool:
        """Place recognition on the worker: only with the worker running
        (until finish() stops it), a vocabulary from a file (a vocabulary
        trained mid-session had its database filled on the frame thread)
        and no loaded component (relocalisation mutates the estimator)."""
        return (self._lc_thread is not None and self.vocab is not None
                and self._vocab_pretrained and not self.components)

    def _maybe_train_vocab(self):
        """Train the flat vocabulary once the keyframe records hold
        `vocab_min_desc` valid descriptors (their valid rows in record
        order, vocab_k words, 6 iterations), then index every record."""
        if self.vocab is not None:
            return
        total = sum(int(r["valid"].sum()) for r in self.kf_records.values())
        if total < self.cfg.vocab_min_desc:
            return
        packs = torch.cat([r["packed_d"][r["valid_d"]] for r in self.kf_records.values()])
        self.vocab = bow.train_vocabulary(packs, k=self.cfg.vocab_k, iters=6)
        self.bow_db = bow.BowDatabase(k=bow.n_words(self.vocab))
        for f, r in self.kf_records.items():
            self.bow_db.add(f, self._keyframe_words(r), r["valid"])

    def _attempt_loop_closure(self, fid: int, t: float) -> bool:
        """Propose (BoW query + RANSAC, or a relocalisation against a loaded
        component) and accept (graph surgery) in line."""
        self._maybe_train_vocab()
        if self.vocab is None or fid not in self.kf_records:
            return False
        rec = self.kf_records[fid]
        exclude = {f for f, r in self.kf_records.items() if t - r["t"] < self.cfg.loop_min_gap_s}
        try:
            cur_p = self.est.get_state(fid).T_WS[:3]
        except KeyError:
            cur_p = rec["T_WS"][:3]
        prop = self._lc_propose(fid, rec, exclude, cur_p)
        if prop == "relocalised":
            return True
        return prop is not None and self._lc_accept(prop)

    def _lc_propose(self, fid: int, rec: dict, exclude: set, cur_p, worker: bool = False):
        """Place-recognition proposal: words, BoW query and database add,
        candidate policy, RANSAC verification.  BoW proposes, geometry
        decides: the top two retrievals are always verified, a third only
        when its score clears p_dbow or stands out from the retrieval bulk.
        Apart from a relocalisation against a loaded component, which only
        the frame thread tries, it touches no estimator state (`cur_p`, the
        position when the keyframe was queued, only sets the RANSAC depth
        prior), so it runs on the recognition worker as well.  Returns a
        proposal dict, "relocalised" (a relocalisation was applied) or
        None."""
        cfg = self.cfg
        words = self._keyframe_words(rec)
        res = self.bow_db.query(words, rec["valid"], exclude=exclude, top=8)
        self.bow_db.add(fid, words, rec["valid"])
        # a worker item queued before load_component() must not move the
        # estimator off the frame thread
        if not worker and self.components and self._attempt_relocalisation(fid, words, rec):
            return "relocalised"
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
        if self.cfg.async_loop_closure:
            # keep the loop edge now, solve the pose graph in the
            # background, synchronise on a later frame
            if not self.est.add_loop_edge(fid, cand_fid, T_cand_cur, sqrt_info):
                return False
            self._hold_loopclosure_frame(cand_fid)
            self._merge_loop_landmarks(rec, cand, prop["pairs"])
            self.full_graph.dispatch(self.est)
        else:
            if not self.est.close_loop(fid, cand_fid, T_cand_cur, sqrt_info):
                return False
            self._hold_loopclosure_frame(cand_fid)
            self._merge_loop_landmarks(rec, cand, prop["pairs"])
            self._refresh_kf_poses()
        self.n_loop_closures += 1
        self._lc_last_path = self.path_length
        return True

    # -- asynchronous place recognition: the keyframe query and verification
    # run on a worker thread; the graph surgery stays on the frame thread
    def _lc_worker_loop(self):
        """Take keyframes off `_lc_queue` until None; put proposals on
        `_lc_results`.  On a card every launch goes to the worker's stream.
        A failed item is logged and the worker goes on, as in the JAX
        package."""
        with torch.cuda.stream(self._lc_stream):
            while True:
                item = self._lc_queue.get()
                if item is None:
                    return
                try:
                    with self._lc_active, timing.Timer("4.2 PlaceRecognition"):
                        rec = self.kf_records.get(item["fid"])
                        if rec is None:
                            continue
                        if self._lc_stream is not None:
                            self._lc_stream.wait_event(rec["ready"])
                        if item["query"]:
                            prop = self._lc_propose(item["fid"], rec, item["exclude"],
                                                    item["cur_p"], worker=True)
                        else:  # backlog: index the keyframe, skip the verification
                            self.bow_db.add(item["fid"], self._keyframe_words(rec),
                                            rec["valid"])
                            prop = None
                        if prop is not None:
                            self._lc_results.put(prop)
                except Exception:  # noqa: BLE001 — logged; recognition must not stop SLAM
                    logging.exception("place-recognition worker failed")

    def _lc_enqueue(self, fid: int, t: float, index_only: bool = False):
        """Queue a recorded keyframe for the worker.  Under a backlog of 6
        items a keyframe is only indexed, but never more than 2 in a row:
        dropping every query under sustained load would switch loop closure
        off."""
        exclude = {f for f, r in self.kf_records.items() if t - r["t"] < self.cfg.loop_min_gap_s}
        try:
            cur_p = self.est.get_state(fid).T_WS[:3].copy()
        except KeyError:
            cur_p = self.kf_records[fid]["T_WS"][:3].copy()
        query = not index_only and (self._lc_queue.qsize() < 6 or self._lc_skipped >= 2)
        if not index_only and not query:
            self._lc_skipped += 1
        elif query:
            self._lc_skipped = 0
        self._lc_queue.put(dict(fid=fid, t=t, exclude=exclude, cur_p=cur_p, query=query))

    def _lc_poll(self) -> bool:
        """Apply the proposals the worker finished (frame thread)."""
        looped = False
        while True:
            try:
                prop = self._lc_results.get_nowait()
            except queue.Empty:
                return looped
            looped = self._lc_accept(prop) or looped

    def _lc_drain(self):
        """Let the worker finish every queued keyframe, then stop it."""
        if self._lc_thread is None:
            return
        self._lc_queue.put(None)
        self._lc_thread.join(timeout=60.0)
        if self._lc_thread.is_alive():
            # keep the handle: finish() must not apply results while the
            # worker may still touch the records
            logging.warning("place-recognition worker did not drain within 60 s; "
                            "skipping its remaining results")
            return
        self._lc_thread = None

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
        do not embed the correction as error.  Never under a verification
        running on the worker (it would read snapshots of mixed epochs)."""
        with self._lc_active:
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

    def synchronise_full_graph(self, wait: bool = False) -> bool:
        """Apply a finished background pose-graph optimisation, if any (with
        `wait`, after joining the one in flight)."""
        if wait:
            self.full_graph.join()
        if not self.full_graph.is_loop_closure_available:
            return False
        if self.full_graph.synchronise(self.est):
            self._refresh_kf_poses()
            return True
        return False

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
    # ------------------------------------------------------------------ RGB-D
    def _sample_depth(self, depth_img: np.ndarray, uv: np.ndarray):
        """Nearest-pixel depth lookup (numpy's round, half to even);
        returns (d (n,), valid (n,))."""
        cfg = self.cfg
        h, w = depth_img.shape[:2]
        x = np.clip(np.round(uv[:, 0]).astype(int), 0, w - 1)
        y = np.clip(np.round(uv[:, 1]).astype(int), 0, h - 1)
        d = np.asarray(depth_img)[y, x].astype(np.float64)
        valid = np.isfinite(d) & (d > cfg.depth_min) & (d < cfg.depth_max)
        return d, valid

    def _depth_sigma(self, d: np.ndarray) -> np.ndarray:
        return self.cfg.depth_sigma0 + self.cfg.depth_sigma_scale * d * d

    def attach_depth_priors(self, fid: int, depth_images) -> int:
        """Sample each camera's depth image at frame `fid`'s observation
        pixels and activate their depth priors; returns how many."""
        est = self.est
        n = 0
        for c, dimg in enumerate(depth_images):
            if dimg is None:
                continue
            sel = np.nonzero((est.obs_fid == fid) & (est.obs_cam == c))[0]
            if len(sel) == 0:
                continue
            d, ok = self._sample_depth(dimg, est.obs_uv[sel])
            rows = sel[ok]
            est.obs_depth[rows] = d[ok]
            est.obs_depth_sigma[rows] = self._depth_sigma(d[ok])
            n += len(rows)
        return n

    def depth_initialize(self, fid: int, frame_data: List[FrameData], depth_images) -> int:
        """Create landmarks for the valid keypoints without one from their
        depth (the ray scaled to the sampled depth, in the world), keypoint
        by keypoint up to the landmark capacity, each with its observation
        and depth prior; returns how many."""
        est = self.est
        T_WS = est.get_state(fid).T_WS
        n_new = 0
        cap_left = est.cfg.cap_landmarks - len(est.lm_ids)
        for c, (fd, dimg) in enumerate(zip(frame_data, depth_images)):
            if dimg is None:
                continue
            un = np.nonzero((fd.lid < 0) & fd.valid)[0]
            if len(un) == 0:
                continue
            d, ok = self._sample_depth(dimg, fd.uv[un])
            un, d = un[ok], d[ok]
            if len(un) == 0:
                continue
            rays, rv = pinhole_np.back_project(self.np_cameras[c], fd.uv[un])
            T_WC = se3np.se3_multiply(T_WS, self.T_SC[c])
            new_lid, new_k, new_d = [], [], []
            for k in range(len(un)):
                if n_new >= cap_left or not rv[k]:
                    continue
                lid = est.add_landmark(np.r_[se3np.se3_apply(T_WC, rays[k] * d[k]), 1.0])
                if lid < 0:
                    continue
                fd.lid[un[k]] = lid
                self._set_landmark_desc(lid, fd, int(un[k]))
                new_lid.append(lid)
                new_k.append(un[k])
                new_d.append(d[k])
                n_new += 1
            if new_lid:
                new_d = np.asarray(new_d)
                est.add_observations_batch(fid, c, new_lid, fd.uv[np.asarray(new_k)],
                                           depth=new_d, depth_sigma=self._depth_sigma(new_d))
        return n_new

    def add_imu_measurement(self, t, gyr, acc):
        if self._imu_csv is not None:
            self._imu_csv.add(t, gyr, acc)
        self.est.add_imu_measurement(t, gyr, acc)

    def add_gps_measurement(self, t, pos_G, err):
        self.est.add_gps_measurement(t, pos_G, err)

    def set_imu_csv_file(self, path: str):
        self._imu_csv = debug_csv.ImuCsvWriter(path)

    def set_tracks_csv_file(self, cam: int, path: str):
        self._tracks_csv[cam] = debug_csv.TracksCsvWriter(path)

    def _write_tracks_csv(self, t: float, frame_data):
        for c, w in self._tracks_csv.items():
            if c >= len(frame_data):
                continue
            fd = frame_data[c]
            sel = fd.lid >= 0
            if not np.any(sel) or fd.packed is None:
                continue
            w.add_frame(t, fd.lid[sel], fd.uv[sel], np.full(int(sel.sum()), 1.0),
                        fd.packed[sel])

    def _project_landmarks(self, cam_idx: int, T_WS: np.ndarray, hp: np.ndarray):
        """Host projection of homogeneous world landmarks into camera
        `cam_idx` at body pose `T_WS`: (uv (n, 2), visible (n,))."""
        T_CW = se3np.se3_multiply(se3np.se3_inverse(self.T_SC[cam_idx]),
                                  se3np.se3_inverse(np.asarray(T_WS)))
        hp_C = se3np.se3_apply_homogeneous(T_CW, np.asarray(hp))
        return pinhole_np.project_homogeneous(self.np_cameras[cam_idx], hp_C)

    def reject_outliers(self, fid: int) -> int:
        """Drop the observations of frame `fid` that project outside their
        camera or farther than the chi2 gate from their keypoint; returns
        how many."""
        est = self.est
        f = est.get_state(fid)
        idxs = np.nonzero(est.obs_fid == fid)[0]
        if len(idxs) == 0:
            return 0
        gate = self.cfg.chi2_px * est.cfg.keypoint_sigma_px * 3
        bad = []
        for c in range(self.num_cams):
            sel = idxs[est.obs_cam[idxs] == c]
            if len(sel) == 0:
                continue
            rows = np.array([est.lm_index[lid] for lid in est.obs_lid[sel]])
            uv_pred, vis = self._project_landmarks(c, f.T_WS, est.hp_W[rows])
            err = np.linalg.norm(uv_pred - est.obs_uv[sel], axis=-1)
            bad.extend(sel[(~vis) | (err > gate)].tolist())
        if bad:
            keep = np.ones(len(est.obs_fid), bool)
            keep[bad] = False
            est._keep_obs(keep)
        return len(bad)

    def _collect_pending(self):
        """Collect the previous frame's window solve, feed its wall time to
        the realtime budget, fold in a finished background optimisation
        (after the window writeback, so the two corrections stay ordered)
        and run the frame's post-solve stages.  No-op when nothing is
        pending."""
        if self._pending is None:
            return
        pend, self._pending = self._pending, None
        t0 = time.perf_counter()
        with timing.Timer("2.5 CollectSolve"):
            self.est.optimise_gated_collect(pend["h"])
        self.est.adapt_realtime_budget(time.perf_counter() - t0)
        self.synchronise_full_graph()
        self._finish_frame(pend["fid"], pend["t"], pend["is_kf"], pend["log_idx"])

    def _finish_frame(self, fid: int, t: float, is_kf: bool, log_idx: Optional[int] = None) -> bool:
        """Post-solve stages: descriptor refresh, path length, the solved
        pose into state-log entry `log_idx` (a pipelined frame logged its
        prediction), loop closure (recognition results applied; keyframes
        recorded, then queued for the worker or proposed in line; a window
        re-solve after a closure), marginalisation, release of held
        loop-closure frames the window has moved past, pruning of dead
        per-frame data.  Returns whether a loop closed."""
        est = self.est
        cfg = self.cfg
        if est.cfg.do_extrinsics:
            # the host-side projections follow the calibrated extrinsics
            self.T_SC = est.T_SC.copy()
        frame_data = self.frames.get(fid)
        if frame_data is not None:
            # refresh landmark descriptors with the freshest observation (a
            # block in flight does it when it lands, `_drain_desc`)
            for fd in frame_data:
                if fd.packed is None:
                    continue
                for k in np.nonzero(fd.lid >= 0)[0]:
                    self.lm_desc[fd.lid[k]] = fd.packed[k]
        try:
            f = est.get_state(fid)
        except KeyError:
            f = None
        if f is not None:
            if self._last_solved_T is not None:
                self.path_length += float(np.linalg.norm(f.T_WS[:3] - self._last_solved_T[:3]))
            self._last_solved_T = f.T_WS.copy()
            if log_idx is not None and log_idx < len(self.states_log):
                self.states_log[log_idx] = (t, f.T_WS.copy())

        looped = False
        use_async_pr = self._use_async_pr()
        if use_async_pr:
            # proposals land a few frames after their keyframe was queued
            with timing.Timer("2.8 LoopClosure"):
                looped = self._lc_poll()
        if is_kf and cfg.do_loop_closures and frame_data is not None:
            # in the cooldown after a closure keyframes are recorded and
            # indexed, but not queried
            in_cooldown = self.path_length - self._lc_last_path < cfg.loop_cooldown_m
            with timing.Timer("2.8 LoopClosure"):
                if frame_data[0].packed is None:
                    # recorded and queued when the descriptor block lands
                    self._kf_lc_todo[fid] = t
                else:
                    self._record_keyframe(fid, t, frame_data)
                    if use_async_pr:
                        self._lc_enqueue(fid, t, index_only=in_cooldown)
                    elif not in_cooldown:
                        looped = self._attempt_loop_closure(fid, t) or looped
                    elif self.vocab is not None:  # index without querying
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
        """One stereo frame, with an optional depth image (metres) or None
        per camera.  Returns the frame's info; with `pipelined_solve` its
        pose is the IMU prediction (the solved pose replaces it in
        `states_log` when the solve is collected) and `loop_closure` is
        False (closures are applied while collecting the previous frame).
        With `deferred_frontend` see `_process_frame_deferred`."""
        if self.cfg.deferred_frontend:
            return self._process_frame_deferred(t, images, depth_images)
        est = self.est
        if self._pending is None:
            # fold a finished background optimisation in before the window
            # grows (with a solve pending this happens in _collect_pending)
            self.synchronise_full_graph()
        with timing.Timer("2.1 AddState"):
            fid = est.add_state(t)
        f = est.get_state(fid)
        with timing.Timer("2.2 DetectDescribe"):
            frame_data = self.detect_and_describe(images, f.T_WS)
        self.frames[fid] = frame_data
        # with a solve pending, association matches against the map of one
        # frame ago; the 40 px match radius absorbs the prediction error
        with timing.Timer("2.3 Associate"):
            n_map, n_stereo, n_motion = self.associate(fid, frame_data)
        if n_map >= 8 and self.cfg.pose_refine:
            self._collect_pending()  # the inline solve needs the window fresh
            with timing.Timer("2.4 PoseOptimise"):
                est.optimise(iterations=3, pose_only=True)
                self.reject_outliers(fid)
        quality = self._tracking_quality(frame_data)
        is_kf = self.need_keyframe(frame_data)
        est.set_keyframe(fid, is_kf)
        if is_kf:
            self.last_kf_fid = fid
        if depth_images is not None:
            self.attach_depth_priors(fid, depth_images)
            n_stereo += self.depth_initialize(fid, frame_data, depth_images)
        # the previous frame's solve, then this frame's prediction again from
        # the corrected state
        self._collect_pending()
        est.repredict_latest()
        gate_px = self.cfg.chi2_px * est.cfg.keypoint_sigma_px * 3
        looped = False
        if self.cfg.pipelined_solve:
            with timing.Timer("2.6 DispatchSolve"):
                h = est.optimise_gated_dispatch(fid, gate_px)
            self._pending = dict(h=h, fid=fid, t=t, is_kf=is_kf, log_idx=len(self.states_log))
        else:
            with timing.Timer("2.6 OptimiseGated"):
                est.optimise_gated(fid, gate_px)
            looped = self._finish_frame(fid, t, is_kf)
        f = est.get_state(fid)
        self.states_log.append((t, f.T_WS.copy()))
        if self._tracks_csv:
            self._write_tracks_csv(t, frame_data)
        return dict(
            fid=fid, is_keyframe=is_kf, keyframe_fid=fid if is_kf else None,
            n_map=n_map, n_stereo=n_stereo, n_motion=n_motion, T_WS=f.T_WS.copy(),
            loop_closure=looped, tracking_quality=quality,
        )

    # ---------------------------------------------- deferred frontend cycle
    def _stage_images(self, images: List[np.ndarray]) -> torch.Tensor:
        """Pack the frame's images and start their upload (`_upload`), so
        that it streams while the host waits on the previous cycle."""
        return self._upload(self._pack_images(images))

    def frontend_dispatch(self, fid: int, t: float, imgs_d: torch.Tensor,
                          T_WS_pred: np.ndarray, depth_images=None) -> dict:
        """Launch this frame's fused frontend, `imgs_d` from
        `_stage_images`: detection, description and association of every
        camera as one chain of launches on the current stream with no host
        sync (the staging uploads go through pinned memory).  Returns the
        handle that `frontend_consume` takes once the cycle's critical block
        has landed: the critical block `crit`, a float64 vector [uv (C, N,
        2) | valid (C, N) | ASSOC_KEYS], and the descriptor block `desc`
        (C, N, 12) int32, both on the device; the frame's depth images ride
        along to the consume."""
        st = self._assoc_stage(T_WS_pred)
        s = self._stage_device(T_WS_pred, st)
        uv, valid, packed = self._detect_describe_device(
            imgs_d, self._gravity_angles(imgs_d.shape[0], T_WS_pred))
        res = self._assoc_core(uv.to(self.est.cfg.dtype), valid, packed, s)
        crit = torch.cat([uv.reshape(-1).to(torch.float64), valid.reshape(-1).to(torch.float64)]
                         + [res[k].reshape(-1).to(torch.float64) for k in ASSOC_KEYS])
        return dict(fid=fid, t=t, crit=crit, desc=packed, stage=st, log_idx=len(self.states_log),
                    depth_images=depth_images)

    def frontend_consume(self, h: dict, crit: np.ndarray):
        """Consume a landed critical block: the frame's keypoints (its
        descriptors land later, `_drain_desc`) and its association.  Returns
        (frame_data, (n_map, n_stereo, n_motion))."""
        C, N = self.num_cams, self.cfg.max_keypoints
        S = min(ASSOC_CAP, N)
        shapes = dict(map_rows=(C, N), st_i1=(S,), st_i0=(S,), st_hp=(S, 4), mo_ic=(S,),
                      mo_ik=(S,), mo_hp=(S, 4))
        uv = crit[:C * N * 2].reshape(C, N, 2)
        valid = crit[C * N * 2:C * N * 3].reshape(C, N) > 0
        res, o = {}, C * N * 3
        for k in ASSOC_KEYS:
            n = int(np.prod(shapes[k]))
            res[k] = crit[o:o + n].reshape(shapes[k])
            o += n
        frame_data = [FrameData(uv=uv[c].copy(), valid=valid[c].copy(), packed=None)
                      for c in range(C)]
        self.frames[h["fid"]] = frame_data
        return frame_data, self._assoc_consume(h["fid"], frame_data, h["stage"], res)

    def _to_host(self, x: torch.Tensor) -> torch.Tensor:
        """Start the copy of a device result into pinned host memory on the
        current stream (on the CPU: the tensor itself)."""
        if x.device.type != "cuda":
            return x
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return out.copy_(x, non_blocking=True)

    def _mark(self):
        """A CUDA event after the work queued so far on the current stream
        (None on the CPU, where everything has happened)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def _submit_item(self, item: dict):
        """Start the host copies of a cycle: the critical block first (event
        `crit_ev`), then the rows of the deferred edge jobs (`ev`), then the
        descriptor block (`desc_ev`), which does not gate the frame path.
        The frame thread waits on these events; no thread is involved."""
        item["crit"] = self._to_host(item["front"]["crit"])
        item["crit_ev"] = self._mark()
        item["edges"] = [self._to_host(job["out"]) for job in item["edge_jobs"]]
        item["ev"] = self._mark()
        item["desc"] = self._to_host(item["front"]["desc"])
        item["desc_ev"] = self._mark()
        self._inflight.append(item)

    @staticmethod
    def _wait(ev):
        if ev is not None:
            ev.synchronize()

    def _pop_item(self) -> dict:
        item = self._inflight.popleft()
        self._wait(item["ev"])
        return item

    def _drain_desc(self, wait: bool = False):
        """Fold the descriptor blocks that have landed (all, with `wait`)
        into their frames: fill `FrameData.packed`, apply the queued
        landmark descriptors, refresh the matched landmarks' descriptors,
        and run the keyframe record and place-recognition step that waited
        on them.  A block still in flight counts in `n_desc_late`."""
        done = []
        for fid, (item, frame_data) in self._desc_pending.items():
            ev = item["desc_ev"]
            if wait:
                self._wait(ev)
            elif ev is not None and not ev.query():
                self.n_desc_late += 1
                continue
            desc = item["desc"].numpy()
            for c, fd in enumerate(frame_data):
                fd.packed = desc[c].copy()
                for lid, k in fd.desc_todo:
                    if lid in self.est.lm_index:
                        self.lm_desc[lid] = fd.packed[k]
                fd.desc_todo = []
                for k in np.nonzero(fd.lid >= 0)[0]:
                    if fd.lid[k] in self.est.lm_index:
                        self.lm_desc[fd.lid[k]] = fd.packed[k]
            kf_t = self._kf_lc_todo.pop(fid, None)
            if kf_t is not None and self.cfg.do_loop_closures:
                in_cooldown = self.path_length - self._lc_last_path < self.cfg.loop_cooldown_m
                use_async_pr = self._use_async_pr()
                self._record_keyframe(fid, kf_t, frame_data)
                if use_async_pr:
                    self._lc_enqueue(fid, kf_t, index_only=in_cooldown)
                elif not in_cooldown and self._attempt_loop_closure(fid, kf_t):
                    self.est.optimise()
            done.append(fid)
        for fid in done:
            del self._desc_pending[fid]

    def _consume_crit(self, item: dict):
        """The critical block of a cycle: the frame's association and
        keyframe decision (reported by the next info dict); the frame's
        window solve is built after the next frontend launch
        (`_dispatch_pending_solve`)."""
        est = self.est
        front = item["front"]
        fid, t = front["fid"], front["t"]
        with timing.Timer("2.3 AssocConsume"):
            frame_data, counts = self.frontend_consume(front, item["crit"].numpy())
        self._desc_pending[fid] = (item, frame_data)
        self._last_counts = counts
        self._last_quality = self._tracking_quality(frame_data)
        is_kf = self.need_keyframe(frame_data)
        est.set_keyframe(fid, is_kf)
        self._kf_event = (fid, is_kf)
        if is_kf:
            self.last_kf_fid = fid
        if front["depth_images"] is not None:
            self.attach_depth_priors(fid, front["depth_images"])
            self.depth_initialize(fid, frame_data, front["depth_images"])
        self._solve_todo = dict(fid=fid, t=t, is_kf=is_kf, log_idx=front["log_idx"])

    def _consume_rest(self, item: dict):
        """The rest of a cycle, before the next problem is built: the
        deferred marginalisation edges, then the window solve the cycle
        carried (solved here), the background synchronisation, the frame's
        post-solve stages, and the prediction of the newer states from the
        corrected ones."""
        est = self.est
        for job, out in zip(item["edge_jobs"], item["edges"]):
            est.apply_pending_edges(job, out.numpy())
        if item["solve"] is None:
            return
        meta = item["solve_meta"]
        with timing.Timer("2.5 CollectSolve"):
            est.optimise_gated_collect(item["solve"])
        self.synchronise_full_graph()
        self._finish_frame(meta["fid"], meta["t"], meta["is_kf"], meta["log_idx"])
        live = {fr.fid for fr in est.frames}
        solved = [f2 for f2 in item["solve"]["fid2slot"] if f2 in live]
        if solved:
            est.repredict_after(max(solved))

    def _process_frame_deferred(self, t: float, images: List[np.ndarray],
                                depth_images=None) -> dict:
        """One frame under the deferred frontend.  Consume the cycles due
        (`pipeline_depth` stay in flight; one while the map is empty or in
        the first `pipeline_ramp_frames` frames), strictly in order: the
        rest of the payload (solve, edges, marginalisation, background
        synchronisation) before the critical block (association), so that
        no surgery lands between a staging and its association.  Then fold
        in the landed descriptor blocks, launch this frame's frontend, build
        the solve of the frame just consumed, and start the cycle's copies.

        Returns the JAX package's deferred info: the pose is the IMU
        prediction (corrected in `states_log` when its solve lands); the
        counts, quality and keyframe decision (`keyframe_fid`) are those of
        the frame consumed in this call; `loop_closure` is False;
        `budget_overrun` and `realtime_iterations` come from the budget
        controller, fed with the wait on the critical block."""
        cfg, est = self.cfg, self.est
        with timing.Timer("2.1 AddState"):
            fid = est.add_state(t)
        f = est.get_state(fid)
        imgs_d = self._stage_images(images)
        self._n_frames_seen += 1
        depth = 1 if self._n_frames_seen <= cfg.pipeline_ramp_frames else cfg.pipeline_depth
        budget_overrun = False
        while len(self._inflight) >= depth or (self._inflight and not est.lm_ids):
            t0 = time.perf_counter()
            with timing.Timer("2.0 PrefetchWait"):
                item = self._inflight.popleft()
                self._wait(item["crit_ev"])
            budget_overrun = est.adapt_realtime_budget(time.perf_counter() - t0) or budget_overrun
            self._wait(item["ev"])
            self._consume_rest(item)
            self._consume_crit(item)
            f = est.get_state(fid)
        self._drain_desc()
        with timing.Timer("2.2 FrontDispatch"):
            h_front = self.frontend_dispatch(fid, t, imgs_d, f.T_WS, depth_images)
        self._dispatch_pending_solve()
        nxt = self._next_solve or {}
        self._next_solve = None
        item = dict(front=h_front, solve=nxt.get("solve"), solve_meta=nxt.get("solve_meta"),
                    edge_jobs=est.pending_edge_jobs)
        est.pending_edge_jobs = []
        self._submit_item(item)
        self.states_log.append((t, f.T_WS.copy()))
        if self._tracks_csv and fid in self.frames:
            self._write_tracks_csv(t, self.frames[fid])
        n_map, n_stereo, n_motion = self._last_counts
        kf_fid, kf_flag = self._kf_event
        self._kf_event = (None, False)
        return dict(
            fid=fid, is_keyframe=bool(kf_flag), keyframe_fid=kf_fid if kf_flag else None,
            n_map=n_map, n_stereo=n_stereo, n_motion=n_motion, T_WS=f.T_WS.copy(),
            loop_closure=False, tracking_quality=self._last_quality,
            budget_overrun=budget_overrun, realtime_iterations=est._rt_iters,
        )

    def _dispatch_pending_solve(self):
        """Build the gated window solve of the frame the last consume
        finished; its handle rides the cycle submitted next."""
        todo, self._solve_todo = self._solve_todo, None
        if todo is None:
            return
        gate_px = self.cfg.chi2_px * self.est.cfg.keypoint_sigma_px * 3
        with timing.Timer("2.6 DispatchSolve"):
            h = self.est.optimise_gated_dispatch(todo["fid"], gate_px)
        self._next_solve = dict(solve=h, solve_meta=todo)

    def _drain_deferred(self):
        """Dataset end: consume every cycle in flight (critical block, then
        the rest), then collect the solves built meanwhile in the order they
        were built (newer estimates are never overwritten by older ones),
        and fold in the edge jobs still pending (the final BA's archive
        needs them)."""
        if not self.cfg.deferred_frontend:
            return
        pending = []
        if self._next_solve is not None:
            pending.append(self._next_solve)
            self._next_solve = None
        while self._inflight:
            item = self._pop_item()
            self._consume_crit(item)
            self._consume_rest(item)
            self._dispatch_pending_solve()
            if self._next_solve is not None:
                pending.append(self._next_solve)
                self._next_solve = None
        self._drain_desc(wait=True)
        for nxt in pending:
            self.est.optimise_gated_collect(nxt["solve"])
            self.synchronise_full_graph()
            m = nxt["solve_meta"]
            self._finish_frame(m["fid"], m["t"], m["is_kf"], m["log_idx"])
        for job in self.est.pending_edge_jobs:
            self.est.apply_pending_edges(job, job["out"].cpu().numpy())
        self.est.pending_edge_jobs = []

    # ------------------------------------------------------ multi-session
    def _geometric_verify(self, fid: int, rec: dict, cand: dict, cur_p=None):
        """Verify one candidate record (a loaded component's keyframe): per
        camera that both records have, mutual matching on the fused match
        kernel (site "reloc"), then ONE non-central RANSAC of the rig's rays
        against the candidate's landmark snapshot (≙ verifyRecognisedPlace,
        Frontend.cpp:258-604).  Hypotheses are drawn from a torch.Generator
        seeded with the frame id.  Returns (T_WS in the candidate's world
        frame, inliers, inlier (cam, cur kp, cand kp) pairs) or None."""
        cfg = self.cfg
        cam_keys = [(0, "")] + ([(1, "1")] if "packed1" in rec and "packed1" in cand else [])
        rays_l, orig_l, pts_l, pair_l = [], [], [], []
        for c, sfx in cam_keys:
            mi, _md, mok = hamming.match_packed_mutual(
                rec[f"packed{sfx}_d"], rec[f"valid{sfx}_d"], cand[f"packed{sfx}_d"],
                cand[f"valid{sfx}_d"], max_dist=float(cfg.matching_threshold), site="reloc")
            mv, mi = mok.cpu().numpy(), mi.cpu().numpy().astype(np.int64)
            lm = cand[f"lm_pos{sfx}"]
            keep = np.nonzero(mv & np.isfinite(lm[:, 0])[mi])[0]
            if len(keep) == 0:
                continue
            rays_C, ok = pinhole_np.back_project_unit(self.np_cameras[c], rec[f"uv{sfx}"][keep])
            keep, rays_C = keep[ok], rays_C[ok]
            rays_l.append(rays_C @ se3np.quat_to_matrix(self.T_SC[c][3:7]).T)
            orig_l.append(np.tile(self.T_SC[c][:3], (len(keep), 1)))
            pts_l.append(lm[mi[keep]])
            pair_l.extend((c, int(kc), int(kd)) for kc, kd in zip(keep, mi[keep]))
        if len(pair_l) < cfg.loop_min_inliers:
            return None
        pts = np.concatenate(pts_l)
        if cur_p is None:
            cur_p = self.est.get_state(fid).T_WS[:3]
        depth = np.linalg.norm(pts - cur_p, axis=-1)
        # the JAX package's fixed capacity: the first `cap` rows, padded
        cap = 2 * cfg.max_keypoints
        n = min(len(pts), cap)
        dev, dtype = self.device, self.est.cfg.dtype

        def pad(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill)
            out[:n] = a[:n]
            return torch.as_tensor(out, dtype=dtype, device=dev)

        mask = torch.arange(cap, device=dev) < n
        res = ransac.absolute_pose_noncentral(
            pad(np.concatenate(rays_l)), pad(np.concatenate(orig_l)), pad(pts), mask,
            pad(depth, 1.0), n_hyp=512, generator=torch.Generator().manual_seed(int(fid)))
        n_inl = int(res.num_inliers)
        if n_inl < cfg.loop_min_inliers:
            return None
        inl = res.inliers.cpu().numpy()[:n]
        pairs = [pair_l[i] for i in np.nonzero(inl)[0]]
        return res.T.cpu().numpy().astype(np.float64), n_inl, pairs

    def load_component(self, path: str, fixed: bool = True) -> bool:
        """Load a previous session's map for relocalisation
        (≙ Frontend::loadComponent, okvis_frontend/src/Frontend.cpp:163-201):
        its keyframes join the pose graph as (fixed) nodes with negative
        frame ids and its keyframe records get a BoW database of their own.
        Without a vocabulary one is trained on the component's descriptors
        (at least 256 of them).  Returns False for a file without records
        or too few descriptors."""
        # components keep recognition on the frame thread: drop the queued
        # worker items and wait out the one in flight
        if self._lc_queue is not None:
            while True:
                try:
                    self._lc_queue.get_nowait()
                except queue.Empty:
                    break
            with self._lc_active:
                pass
        comp = component.load_component(path)
        if "records" not in comp:
            return False
        fid_map = self.est.import_component_frames(
            comp["frame_fids"], comp["frame_ts"], comp["frame_T_WS"], comp["edges"],
            fixed=fixed)
        dev = self.device
        records = {}
        for old, r in comp["records"].items():
            if old in fid_map:
                r["packed_d"] = torch.as_tensor(
                    np.ascontiguousarray(r["packed"]).view(np.int32), device=dev)
                r["valid_d"] = torch.as_tensor(r["valid"], device=dev)
                records[fid_map[old]] = r
        if self.vocab is None:
            packs = torch.cat([r["packed_d"][r["valid_d"]] for r in records.values()])
            if len(packs) < 256:
                return False
            self.vocab = bow.train_vocabulary(packs, k=self.cfg.vocab_k, iters=6)
            self.bow_db = bow.BowDatabase(k=bow.n_words(self.vocab))
        comp_db = bow.BowDatabase(k=bow.n_words(self.vocab))
        for cfid, r in records.items():
            comp_db.add(cfid, self._keyframe_words(r), r["valid"])
        self.components.append(dict(db=comp_db, records=records))
        return True

    def _attempt_relocalisation(self, fid: int, words, rec) -> bool:
        """Query the loaded components; on a geometrically verified hit,
        align the session onto the map frame (the first hit moves the whole
        session rigidly; later hits pass the drift gate of loop closures)
        and add a pose-graph edge to the component's keyframe
        (≙ Frontend.cpp:813-857 and the backend's loop-closure machinery)."""
        cfg = self.cfg
        for comp in self.components:
            res = comp["db"].query(words, rec["valid"], top=3)
            if not res or res[0][1] < cfg.p_dbow:
                continue
            cand_fid, _ = res[0]
            ver = self._geometric_verify(fid, rec, comp["records"][cand_fid])
            if ver is None:
                continue
            T_WS_est, n_inl, _ = ver
            T_WS_cur = self.est.get_state(fid).T_WS
            if self.relocalised:
                correction = np.linalg.norm(T_WS_est[:3] - T_WS_cur[:3])
                budget = cfg.drift_percentage / 100.0 * max(self.path_length, 0.5) + 0.2
                if correction > budget:
                    continue
            else:
                # the offset between sessions is unbounded
                self.est.rigid_transform(
                    se3np.se3_multiply(T_WS_est, se3np.se3_inverse(T_WS_cur)),
                    session_only=True)
                self.relocalised = True
            T_WK = self.est.archive_frames[cand_fid].T_WS  # the map-frame pose
            T_cand_cur = se3np.se3_multiply(se3np.se3_inverse(T_WK), T_WS_est)
            sqrt_info = np.eye(6) * (10.0 * np.sqrt(n_inl))
            if cfg.async_loop_closure:
                if self.est.add_loop_edge(fid, cand_fid, T_cand_cur, sqrt_info):
                    self.full_graph.dispatch(self.est)
                    self.n_relocalisations += 1
                    return True
            elif self.est.close_loop(fid, cand_fid, T_cand_cur, sqrt_info):
                self.n_relocalisations += 1
                self._refresh_kf_poses()
                return True
        return False

    def save_map(self, path: str) -> str:
        """Export the long-term map and a .g2o pose graph
        (≙ ViSlamBackend::saveMap); returns the .g2o path."""
        return component.save_map(path, self.est, self.kf_records)

    def save_component(self, path: str):
        """Write this session for a later relocalisation
        (≙ ViSlamBackend::saveComponent)."""
        component.save_component(path, self.est, self.kf_records)

    def finish(self):
        """Dataset end: collect the pending window solve, consume the
        deferred frontend's cycles in flight, let the recognition worker
        finish its queue and stop, apply its last
        proposals (then a window re-solve and a background dispatch),
        join and apply the background optimisation, and flush the debug
        CSVs; `est.final_ba()` may follow."""
        self._collect_pending()
        self._drain_deferred()
        self._lc_drain()
        worker_live = self._lc_thread is not None and self._lc_thread.is_alive()
        if self._lc_results is not None and not worker_live and self._lc_poll():
            self.est.optimise()
            self.full_graph.dispatch(self.est)
        self.synchronise_full_graph(wait=True)
        for w in [self._imu_csv, *self._tracks_csv.values()]:
            if w is not None:
                w.flush()
