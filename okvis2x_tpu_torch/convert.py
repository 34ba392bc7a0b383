"""Carry state between the JAX package and the port, through numpy.

Inputs are the JAX package's NamedTuples, dataclasses and configs with numpy
leaves (callers ``np.asarray`` each field first); nothing here imports JAX.
Floating fields become tensors of the requested dtype on the requested
device, integer index fields int64, masks bool.  `to_numpy` turns the
port's results back into numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from okvis2x_tpu_torch.cameras.pinhole import Camera
from okvis2x_tpu_torch.frontend.bow import HierVocabulary
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, FrameState, SlidingWindowEstimator
from okvis2x_tpu_torch.imu.preintegration import ImuParams, Preintegrated
from okvis2x_tpu_torch.io import config
from okvis2x_tpu_torch.mapping import submap
from okvis2x_tpu_torch.models import stereo_net
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig
from okvis2x_tpu_torch.solver.gauss_newton import StackedCameras
from okvis2x_tpu_torch.solver.problem import BAProblem

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a numpy/JAX dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[np.dtype(dtype).name]


def tensor(x, dtype=torch.float64, device=None) -> torch.Tensor:
    """numpy -> tensor: floating arrays take `dtype`, integer arrays int64,
    booleans stay bool."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def camera(cam, dtype=torch.float64, device=None) -> Camera:
    return Camera(
        fxfycxcy=tensor(cam.fxfycxcy, dtype, device),
        dist_params=tensor(cam.dist_params, dtype, device),
        width=int(cam.width), height=int(cam.height), model=cam.model,
    )


def stacked_cameras(cams, dtype=torch.float64, device=None) -> StackedCameras:
    return StackedCameras(
        fxfycxcy=tensor(cams.fxfycxcy, dtype, device),
        dist_params=tensor(cams.dist_params, dtype, device),
        width=int(cams.width), height=int(cams.height), model=cams.model,
    )


def imu_params(params) -> ImuParams:
    return ImuParams(**{k: float(getattr(params, k)) for k in ImuParams._fields})


def vi_config(vi) -> config.ViConfig:
    """JAX `ViConfig` -> port `ViConfig`: the same values in the port's
    dataclasses, cameras as float64 `Camera`s, the IMU as `ImuParams`."""

    def conv(v, name=""):
        if name == "imu":
            return imu_params(v)
        if name == "camera" and hasattr(v, "fxfycxcy"):  # not the CameraParams
            return camera(v)
        if dataclasses.is_dataclass(v):
            cls = getattr(config, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name), f.name)
                          for f in dataclasses.fields(cls)})
        if isinstance(v, list):
            return [conv(x) for x in v]
        return np.array(v) if isinstance(v, np.ndarray) else v

    return conv(vi)


def preintegrated(pre, dtype=torch.float64, device=None) -> Preintegrated:
    return Preintegrated(*[tensor(getattr(pre, k), dtype, device)
                           for k in Preintegrated._fields])


def submap_config(cfg):
    """JAX `SubmapConfig` or brick-sparse `BrickConfig` -> the port's (same
    fields)."""
    if hasattr(cfg, "table_dim"):
        from okvis2x_tpu_torch.mapping import brick

        return brick.BrickConfig(**cfg._asdict())
    return submap.SubmapConfig(**cfg._asdict())


def submap_grid(sm, device=None):
    """JAX dense `Submap` or `BrickSubmap` -> the port's, each array keeping
    its dtype (the brick table, slot coordinates and count int32)."""
    cls = submap.Submap
    if hasattr(sm, "table"):
        from okvis2x_tpu_torch.mapping import brick

        cls = brick.BrickSubmap
    return cls(*[torch.as_tensor(np.array(x), device=device) for x in sm])


def ba_problem(p, dtype=torch.float64, device=None) -> BAProblem:
    """JAX `BAProblem` (numpy leaves; the submap of the ICP rows may keep
    its arrays) -> port `BAProblem`."""
    out = {}
    for k in BAProblem._fields:
        v = getattr(p, k)
        if k in ("imu_pre", "gps_pre"):
            out[k] = preintegrated(v, dtype, device)
        elif k == "icp_map":
            out[k] = None if v is None else submap_grid(v, device)
        elif v is None:
            out[k] = None
        else:
            out[k] = tensor(v, dtype, device)
    return BAProblem(**out)


def estimator_config(cfg) -> EstimatorConfig:
    """JAX `EstimatorConfig` -> port `EstimatorConfig` (same field names)."""
    kw = {}
    for f in dataclasses.fields(EstimatorConfig):
        v = getattr(cfg, f.name)
        if f.name == "imu":
            v = imu_params(v)
        elif f.name == "dtype":
            v = torch_dtype(v)
        kw[f.name] = v
    return EstimatorConfig(**kw)


def pipeline_config(cfg) -> PipelineConfig:
    """JAX `PipelineConfig` -> port `PipelineConfig` (the fields the port
    has; the unported features keep their values, so enabling them raises
    when the pipeline is built)."""
    return PipelineConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(PipelineConfig)})


def pack_pm1(pm1) -> np.ndarray:
    """(n, 384) ±1 rows -> (n, 12) int32 words, bit k of a row at bit k % 32
    of word k // 32 (the packed-descriptor layout)."""
    bits = (np.asarray(pm1, np.float32) > 0).astype(np.uint8)
    words = np.packbits(bits, axis=1, bitorder="little").reshape(bits.shape[0], -1, 4)
    return np.ascontiguousarray(words).view(np.uint32)[:, :, 0].view(np.int32)


def flat_vocabulary(vocab, device=None) -> torch.Tensor:
    """JAX flat vocabulary ((k, 384) ±1 bfloat16 rows, as
    `train_vocabulary` returns it) -> the port's (k, 12) int32 words."""
    return torch.from_numpy(pack_pm1(np.asarray(vocab, np.float32))).to(device)


def hier_vocabulary(vocab, device=None) -> HierVocabulary:
    """JAX `HierVocabulary` (±1 bfloat16 rows) -> the port's packed words."""
    return HierVocabulary(torch.from_numpy(pack_pm1(vocab.branches)).to(device),
                          torch.from_numpy(pack_pm1(vocab.leaves)).to(device))


def _frame(f) -> FrameState:
    return FrameState(
        fid=int(f.fid), timestamp=float(f.timestamp), T_WS=np.array(f.T_WS, np.float64),
        sb=np.array(f.sb, np.float64), is_keyframe=bool(f.is_keyframe),
        pose_fixed=bool(f.pose_fixed), sb_fixed=bool(f.sb_fixed),
        pose_graph_frame=bool(f.pose_graph_frame), expanded=bool(f.expanded),
        pre_hold_T=None if f.pre_hold_T is None else np.array(f.pre_hold_T, np.float64),
    )


def _edge(e: dict) -> dict:
    return {k: (np.array(v, np.float64) if k in ("T_ij", "sqrt_info") else v)
            for k, v in e.items()}


def estimator_state(src, dst: SlidingWindowEstimator) -> SlidingWindowEstimator:
    """Copy a JAX estimator's whole state into the port's `dst` (built with
    the converted config, cameras and extrinsics): window and archived
    frames and edges, live and archived observations and landmarks, both
    IMU buffers, the chained IMU links, the priors, the held loop-closure
    frames, the correction epoch, the extrinsics and their calibration
    prior, the GNSS state (status, fixes, T_GW, antenna offset), and the
    depth priors of the live and archived observations, and the live
    submap-ICP points with their submap and grid config; the frames and
    edges of loaded map components (negative frame ids) come along with
    the archive."""
    dst.T_SC = np.array(src.T_SC, np.float64)
    dst.T_SC_prior = np.array(src.T_SC_prior, np.float64)
    dst.gps_status = str(src.gps_status)
    dst.gps_meas = [(float(t), np.array(pg, np.float64), np.array(err, np.float64))
                    for t, pg, err in src.gps_meas]
    dst.T_GW = np.array(src.T_GW, np.float64)
    dst.gps_r_SA = np.array(src.gps_r_SA, np.float64)
    for k in ("gps_min_fixes", "gps_min_span", "gps_timeout"):
        setattr(dst, k, getattr(src, k))
    dst.frames = [_frame(f) for f in src.frames]
    dst.archive_frames = {int(k): _frame(f) for k, f in src.archive_frames.items()}
    dst.rel_edges = [_edge(e) for e in src.rel_edges]
    dst.archive_edges = [_edge(e) for e in src.archive_edges]
    dst._next_fid, dst._next_lid = int(src._next_fid), int(src._next_lid)
    dst.lm_ids = [int(l) for l in src.lm_ids]
    dst.lm_index = {l: i for i, l in enumerate(dst.lm_ids)}
    dst.hp_W = np.array(src.hp_W, np.float64).reshape(-1, 4)
    for k in ("obs_fid", "obs_cam", "obs_lid", "obs_uid"):
        setattr(dst, k, np.array(getattr(src, k), np.int64))
    dst.obs_uv = np.array(src.obs_uv, np.float64).reshape(-1, 2)
    for k in ("obs_sigma", "obs_depth", "obs_depth_sigma"):
        setattr(dst, k, np.array(getattr(src, k), np.float64))
    dst._obs_uid_next = int(src._obs_uid_next)
    dst._arch_obs_n = 0
    dst._arch_obs_reserve(len(src.arch_obs_fid))
    for fid, cam, lid, uv, sig, d, dsig in zip(
            src.arch_obs_fid, src.arch_obs_cam, src.arch_obs_lid, src.arch_obs_uv,
            src.arch_obs_sigma, src.arch_obs_depth, src.arch_obs_depth_sigma):
        dst.archive_observation(int(fid), int(cam), int(lid), uv, float(sig), float(d),
                                float(dsig))
    dst.arch_lm = {int(k): np.array(v, np.float64) for k, v in src.arch_lm.items()}
    live = np.concatenate([np.asarray(src.imu_t)[:, None], src.imu_gyr, src.imu_acc], 1)
    arch = np.concatenate(
        [np.asarray(src.arch_imu_t)[:, None], src.arch_imu_gyr, src.arch_imu_acc], 1)
    dst._imu_buf = np.zeros((max(4096, 2 * len(live)), 7))
    dst._imu_buf[: len(live)] = live
    dst._imu_start, dst._imu_n = 0, len(live)
    dst._arch_imu_buf = np.zeros((max(4096, len(arch)), 7))
    dst._arch_imu_buf[: len(arch)] = arch
    dst._arch_imu_n = len(arch)
    dst.imu_links = {
        (int(a), int(b)): (Preintegrated(*[np.array(getattr(e, k)) for k in Preintegrated._fields]),
                           np.array(W, np.float64))
        for (a, b), (e, W) in src.imu_links.items()
    }
    dst.prior_fid = None if src.prior_fid is None else int(src.prior_fid)
    for k in ("prior_T", "prior_sqrt_info", "prior_sb", "prior_sb_sqrt_info"):
        v = getattr(src, k)
        setattr(dst, k, None if v is None else np.array(v, np.float64))
    dst.lc_protected = {int(f) for f in src.lc_protected}
    dst.correction_epoch = int(src.correction_epoch)
    dst.icp_live = None
    if src.icp_live is not None:
        a_fid, b_fid, pts, sig = src.icp_live
        dst.icp_live = (int(a_fid), int(b_fid), np.array(pts), float(sig))
    dst.icp_map = None if src.icp_map is None else submap_grid(src.icp_map, dst.device)
    dst.icp_grid_cfg = None if src.icp_grid_cfg is None else submap_config(src.icp_grid_cfg)
    return dst


def _flatten(tree, prefix="") -> dict:
    """A nested flax parameter tree -> {'/'-joined path: array}; a flat
    mapping passes through."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def stereo_net_params(params) -> dict:
    """JAX `StereoNet` or `MvsNet` parameters (the nested tree that
    `okvis2x_tpu.models.*_net.load_params` returns, or the flat npz paths
    params/FeatureNet_0/Conv_0/kernel, ...) -> the port's ``state_dict``:
    the modules carry the flax names, so one converter serves both nets."""
    return stereo_net.state_dict_from_flax(_flatten(params))


mvs_net_params = stereo_net_params


def to_numpy(x):
    """Tensors -> numpy arrays, recursively through tuples, NamedTuples,
    lists, dicts and the port's dataclasses."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_numpy(v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: to_numpy(getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)
        })
    return x
