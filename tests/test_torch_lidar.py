"""The port's LiDAR-visual-inertial path against the JAX package: LiDAR
integration into the submaps with the alignment edge of a closing submap,
the pipeline's plumbing (deskew, filter, live edges, the keyframe trigger)
and the drift-recovery scenario of tests/test_lidar_vio.py with per-point
ICP rows and with the compressed edge; the port's versions of the cases of
tests/test_lidar_vio.py.  Both dataset apps in lidar mode are held against
each other in tests/test_torch_lidar_app.py.

Run as a script (`python tests/test_torch_lidar.py [n_frames [dataset_frames]]`,
default chip_smoke.LIDAR_FRAMES of LIDAR_DATASET_FRAMES) it runs the JAX app on
the chip phase's LiDAR dataset (`chip_smoke.lidar_dataset`) and prints
`chip_smoke.lidar_metrics`, the bounds of that phase (`chip_smoke.JAX_LIDAR`).

Tolerances: grids as tests/test_torch_submapping.py holds them (counts
exactly, log-odds to 1e-6) where the anchors carry no rotation; the edges'
information H = sqrt_info^T sqrt_info and its trace (the strength) to
EDGE_H_TOL relative (float32), T_ij to 1e-6; the drifted frame's pose after the solve to 1e-7 m
(float64 solves of the same rows)."""

import json
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from okvis2x_tpu.cameras import pinhole as jpin  # noqa: E402
from okvis2x_tpu.graph import EstimatorConfig as JEstimatorConfig  # noqa: E402
from okvis2x_tpu.graph import FrameState as JFrameState  # noqa: E402
from okvis2x_tpu.io.xdataset import LidarSweep as JLidarSweep  # noqa: E402
from okvis2x_tpu.mapping import submap as jsm  # noqa: E402
from okvis2x_tpu.pipeline import submapping as jsub  # noqa: E402
from okvis2x_tpu.pipeline.lidar_vio import LidarVioPipeline as JLidarVio  # noqa: E402
from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig  # noqa: E402
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline  # noqa: E402
from okvis2x_tpu_torch.cameras import pinhole  # noqa: E402
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, FrameState  # noqa: E402
from okvis2x_tpu_torch.io.xdataset import LidarSweep  # noqa: E402
from okvis2x_tpu_torch.mapping import submap  # noqa: E402
from okvis2x_tpu_torch.pipeline.lidar_vio import LidarVioPipeline  # noqa: E402
from okvis2x_tpu_torch.pipeline.submapping import (SubmappingConfig,  # noqa: E402
                                                    SubmappingInterface)
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline  # noqa: E402

torch.set_num_threads(1)

I7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
# the edges' information, relative to its largest entry: float32 sums of up
# to 200 float32 Jacobian rows, 1.1e-5 apart between the packages on the
# closing-submap edge below (whose float32 H is itself 9% from the float64
# one: some points sit near cell boundaries of the trilinear field)
EDGE_H_TOL = 3e-5


def box_sweep(rng, T_WS, n=600, half=4.0):
    """Points of a 8 m box room (walls, floor at -1.5 m, ceiling at 2.5 m)
    seen from pose T_WS, in the sensor frame, 1 cm noise."""
    from okvis2x_tpu_torch.core import se3np

    d = rng.normal(0, 1, (n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = T_WS[:3]
    d_W = d @ se3np.quat_to_matrix(T_WS[3:7]).T
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.min(np.stack([np.where(d_W[:, k] > 0, (hi - o[k]) / d_W[:, k],
                                      (lo - o[k]) / d_W[:, k])
                             for k, (lo, hi) in enumerate([(-half, half), (-half, half),
                                                           (-1.5, 2.5)])]), axis=0)
    p_W = o + s[:, None] * d_W + rng.normal(0, 0.01, (n, 3))
    return se3np.se3_apply(se3np.se3_inverse(T_WS), p_W)


def yawed(x, y, yaw):
    return np.array([x, y, 0.0, 0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def compare_grids(a, b, atol=1e-6):
    np.testing.assert_array_equal(a.weight.cpu().numpy(), np.asarray(b.weight))
    np.testing.assert_allclose(a.logodds.cpu().numpy(), np.asarray(b.logodds), rtol=0, atol=atol)


def compare_edges(ea, eb):
    assert len(ea) == len(eb) >= 1
    for a, b in zip(ea, eb):
        assert (a["i"], a["j"], a.get("live")) == (b["i"], b["j"], b.get("live"))
        np.testing.assert_allclose(a["T_ij"], np.asarray(b["T_ij"]), rtol=0, atol=1e-6)
        Ha = a["sqrt_info"].T @ a["sqrt_info"]
        Hb = np.asarray(b["sqrt_info"]).T @ np.asarray(b["sqrt_info"])
        assert np.abs(Ha - Hb).max() <= EDGE_H_TOL * np.abs(Hb).max()
        assert abs(np.trace(Ha) - np.trace(Hb)) <= EDGE_H_TOL * np.trace(Hb)


def test_integrate_lidar_and_alignment_edges_match_jax():
    """Both interfaces on a sweep sequence through a box room (sensor poses
    yawed, anchors unrotated and apart by no multiple of the voxel, which
    would put every alignment point on a cell boundary of the trilinear
    field): submaps of two keyframes, so the third and fifth keyframes start
    new ones and the second submap's closing hands over an alignment edge;
    the same submaps, grids, overlap decisions and edges."""
    rng = np.random.default_rng(0)
    kw = dict(new_submap_kf_count=1, min_frames_integrated=2, align_points=128,
              sensor_sigma=0.2)
    edges_t, edges_j = [], []
    tsi = SubmappingInterface(SubmappingConfig(submap=submap.SubmapConfig(dim=64, res=0.2), **kw),
                              align_callback=edges_t.append, device="cpu")
    jsi = jsub.SubmappingInterface(jsub.SubmappingConfig(submap=jsm.SubmapConfig(dim=64, res=0.2),
                                                         **kw), align_callback=edges_j.append)
    seq = [(0, 0.0), (0, 0.1), (1, 0.2), (1, 0.3), (2, 0.4), (2, 0.5), (3, 0.6), (3, 0.7),
           (4, 0.8), (4, 0.9)]
    for kf, x in seq:
        T_WK = yawed(0.13 * kf, 0.07 * kf, 0.0)
        T_WS = yawed(x, 0.05 * x, 0.3 * x)
        pts = box_sweep(rng, T_WS)
        tsi.integrate_lidar(kf, T_WK, T_WS, pts)
        jsi.integrate_lidar(kf, T_WK, T_WS, pts)
    assert len(tsi.maps) == len(jsi.maps) == 3
    for a, b in zip(tsi.maps, jsi.maps):
        assert (a.anchor_fid, a.n_frames, a.kf_ids, a.finished) == \
            (b.anchor_fid, b.n_frames, b.kf_ids, b.finished)
        np.testing.assert_array_equal(a.sm.T_WK.numpy(), np.asarray(b.sm.T_WK))
        compare_grids(a.sm, b.sm)
    compare_edges(edges_t, edges_j)
    # the alignment of the first two submaps, asked for directly
    compare_edges([tsi.make_alignment_edge(tsi.maps[0], tsi.maps[1])],
                  [jsi.make_alignment_edge(jsi.maps[0], jsi.maps[1])])


def seeded_pipes(n_frames):
    """tests/test_lidar_vio.py's pipeline in both packages with `n_frames`
    keyframes seeded 2 cm apart."""
    kw = dict(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96, model="none")
    est_kw = dict(cap_frames=8, num_keyframes=3, num_imu_frames=2, cap_landmarks=64, cap_obs=256,
                  cap_imu_links=7, cap_rel_edges=8)
    sub = dict(min_frames_integrated=1, align_points=128)
    tp = LidarVioPipeline(VioPipeline([pinhole.make_pinhole(**kw)], np.array([I7]),
                                      EstimatorConfig(**est_kw), PipelineConfig(
                                          do_loop_closures=False), device="cpu"),
                          SubmappingConfig(submap=submap.SubmapConfig(dim=64, res=0.2), **sub))
    jp = JLidarVio(JVioPipeline([jpin.make_pinhole(**kw)], np.array([I7]),
                                JEstimatorConfig(**est_kw), JPipelineConfig(
                                    do_loop_closures=False)),
                   jsub.SubmappingConfig(submap=jsm.SubmapConfig(dim=64, res=0.2), **sub))
    for pipe, FS in ((tp, FrameState), (jp, JFrameState)):
        for k in range(n_frames):
            pipe.est.frames.append(FS(fid=k, timestamp=0.1 * k,
                                      T_WS=np.array([0.02 * k, 0, 0, 0, 0, 0, 1.0]),
                                      sb=np.zeros(9), is_keyframe=True))
        pipe.vio.last_kf_fid = 0
    return tp, jp


def wall_sweep(rng, t, n=400, z=3.0, offset=np.zeros(3)):
    xy = rng.uniform(-2.5, 2.5, (n, 2))
    pts = np.concatenate([xy, np.full((n, 1), z)], -1) - offset
    return dict(t=t, t_point=np.linspace(t - 0.1, t, n), pts=pts, intensity=np.ones(n))


def test_lidar_pipeline_matches_jax():
    """tests/test_lidar_vio.py's plumbing in both packages: the same sweeps
    (two-state deskew: the pipelines have no IMU samples) give the same
    outcomes, submap, live edges (replaced, not accumulated, and the wall
    constraining z strongly), and keyframe requests."""
    tp, jp = seeded_pipes(3)
    rng = np.random.default_rng(23)
    for t in (0.15, 0.25, 0.3, 0.35):
        sw = wall_sweep(rng, t)
        out_t = tp.process_lidar_sweep(LidarSweep(**sw))
        out_j = jp.process_lidar_sweep(JLidarSweep(**sw))
        assert out_t == out_j and out_t["integrated"]
        live_t = [e for e in tp.est.rel_edges if e.get("live")]
        live_j = [e for e in jp.est.rel_edges if e.get("live")]
        assert len(live_t) == len(live_j) <= 1
        if live_t:
            compare_edges(live_t, live_j)
            H = live_t[0]["sqrt_info"].T @ live_t[0]["sqrt_info"]
            assert H[2, 2] > H[0, 0]
    assert out_t["live_edge"]
    assert len(tp.submapper.maps) == 1 and tp.submapper.active.n_frames == 4
    compare_grids(tp.submapper.active.sm, jp.submapper.active.sm)
    assert tp.request_keyframe == jp.request_keyframe


def test_lidar_keyframe_trigger():
    """A sweep of a wall the submap has not observed asks for a keyframe."""
    tp, _ = seeded_pipes(2)
    for f in tp.est.frames:
        f.T_WS = I7.copy()
    rng = np.random.default_rng(23)
    tp.process_lidar_sweep(LidarSweep(**wall_sweep(rng, 0.15)))
    tp.process_lidar_sweep(LidarSweep(**wall_sweep(rng, 0.2)))
    assert not tp.request_keyframe
    tp.process_lidar_sweep(LidarSweep(**wall_sweep(rng, 0.25, offset=np.array([0, 0, 9.0]))))
    assert tp.request_keyframe


def jax_drift_recovery(cap_icp):
    m = types.SimpleNamespace(
        pinhole=jpin, EstimatorConfig=JEstimatorConfig, FrameState=JFrameState,
        LidarSweep=JLidarSweep, SubmapConfig=jsm.SubmapConfig,
        LidarVioPipeline=JLidarVio, SubmappingConfig=jsub.SubmappingConfig,
        PipelineConfig=JPipelineConfig, VioPipeline=JVioPipeline, vio_kw={})
    return chip_smoke.drift_recovery(cap_icp, m=m)


@pytest.fixture(scope="module")
def drift_poses():
    """The drifted frame's pose after the solve, per package and `cap_icp`
    (128: per-point rows; 0: the compressed live edge)."""
    return {(pkg, cap): np.array((chip_smoke.drift_recovery(cap) if pkg == "port"
                                  else jax_drift_recovery(cap)).est.frames[-1].T_WS)
            for pkg in ("port", "jax") for cap in (128, 0)}


@pytest.mark.parametrize("cap_icp", [128, 0])
def test_drift_recovery_matches_jax(drift_poses, cap_icp):
    """One sweep of the drifted frame, then `optimise`: the port's solve
    (per-point rows, or the live edge) lands where JAX's does."""
    a, b = drift_poses["port", cap_icp], drift_poses["jax", cap_icp]
    assert float(np.abs(a[:3] - b[:3]).max()) <= 1e-7, (a, b)
    assert abs(abs(float(np.dot(a[3:], b[3:]))) - 1.0) <= 1e-12


def test_perpoint_icp_beats_compressed_edge(drift_poses):
    """The per-point rows recover the 8 cm drift better than the compressed
    edge, which pins it at its linearisation point (the port's version of
    tests/test_lidar_vio.py's case)."""
    err_live = abs(float(drift_poses["port", 128][2]))
    err_edge = abs(float(drift_poses["port", 0][2]))
    assert err_live < 0.03, (err_live, err_edge)
    assert err_live < 0.5 * err_edge, (err_live, err_edge)


def jax_app_rehearsal(n_frames, dataset_frames, root):
    """The JAX app in lidar mode on the first `n_frames` frames of
    `chip_smoke.lidar_dataset`'s dataset of `dataset_frames` frames (written
    by the port's generator and writer, whose files are the JAX package's),
    recorded as the chip phase records the port's app; returns
    `chip_smoke.lidar_metrics` and the wall time."""
    import runpy
    import time

    ds_dir, app_argv = chip_smoke.lidar_dataset(root, n_frames, dataset_frames)
    out = os.path.join(root, "out")
    argv = sys.argv
    sys.argv = ["okvis2x_app.py", *app_argv]
    t0 = time.perf_counter()
    try:
        with chip_smoke.LidarRecorder(JLidarVio) as rec:
            runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"), run_name="__main__")
    finally:
        sys.argv = argv
    m = chip_smoke.lidar_metrics(rec, ds_dir, out)
    m["wall_s"] = time.perf_counter() - t0
    return m


if __name__ == "__main__":
    jax.config.update("jax_enable_x64", True)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.LIDAR_FRAMES
    n_data = int(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.LIDAR_DATASET_FRAMES
    res = jax_app_rehearsal(n, max(n, n_data), os.path.join(REPO, "build", "lidar_rehearsal"))
    print(json.dumps(res, default=float))
