"""Parity of the port's pose refinement, pipelined solve and realtime budget
controller with the JAX package, from one estimator state
(`convert.estimator_state`), and the pipeline configuration defaults."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.graph import EstimatorConfig as JEstimatorConfig
from okvis2x_tpu.graph import SlidingWindowEstimator as JEstimator
from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, SlidingWindowEstimator
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline
from test_torch_final_ba import jax_copy
from test_torch_loopclosure import port_of

torch.set_num_threads(1)

GATE_PX = 3.0 * 0.8 * 3  # chi2_px x keypoint_sigma_px x 3, the pipeline's gate


@pytest.fixture(scope="module")
def window():
    """The VIO simulation of tests/test_estimator.py over 2 s (keyframe
    every third frame) run by the JAX estimator, then a new frame whose
    observations carry six outliers of 20 px: (estimator, rig, new fid,
    outlier uids)."""
    from test_estimator import make_landmarks, make_rig, simulate

    cams, T_SC = make_rig()
    sim = simulate(duration=2.3)
    pts = make_landmarks()
    cfg = JEstimatorConfig(cap_frames=10, num_keyframes=4, num_imu_frames=3, cap_landmarks=256,
                           cap_obs=2048, cap_imu_links=9, max_iterations=5)
    est = JEstimator(cfg, cams, T_SC)
    rng = np.random.default_rng(13)
    lid_by_pt = {}
    imu_idx = 0

    def frame(k):
        nonlocal imu_idx
        tf = sim["t_frames"][k]
        while imu_idx < len(sim["t_imu"]) and sim["t_imu"][imu_idx] <= tf + 0.005:
            est.add_imu_measurement(sim["t_imu"][imu_idx], sim["gyr"][imu_idx],
                                    sim["acc"][imu_idx])
            imu_idx += 1
        fid = est.add_state(tf)
        for c in range(2):
            T_CW = jse3.se3_multiply(jse3.se3_inverse(jnp.asarray(T_SC[c])),
                                     jse3.se3_inverse(jnp.asarray(sim["T_WS_gt"][k])))
            p_C = np.asarray(jax.vmap(lambda pt: jse3.se3_apply(T_CW, pt))(jnp.asarray(pts)))
            uv, valid = jpin.project(cams[0], jnp.asarray(p_C))
            uv, valid = np.asarray(uv), np.asarray(valid)
            for i in np.nonzero(valid)[0][:30]:
                if i not in lid_by_pt:
                    lid_by_pt[i] = est.add_landmark(
                        np.concatenate([pts[i] + rng.normal(0, 0.05, 3), [1.0]]))
                est.add_observation(fid, c, lid_by_pt[i], uv[i] + rng.normal(0, 0.5, 2))
        est.set_keyframe(fid, k % 3 == 0)
        return fid

    n = len(sim["t_frames"])
    for k in range(n - 1):
        frame(k)
        est.optimise()
        est.marginalise()
    fid = frame(n - 1)
    rows = np.nonzero(est.obs_fid == fid)[0][::7][:6]
    est.obs_uv[rows] += np.array([20.0, -14.0])
    return est, (cams, T_SC), fid, est.obs_uid[rows].copy()


def pair(window):
    """Fresh JAX and port copies of the window state."""
    jest = jax_copy(window[0])
    return jest, port_of(jest)


def assert_same_window(test, jest, atol):
    assert [f.fid for f in test.frames] == [f.fid for f in jest.frames]
    for a, b in zip(test.frames, jest.frames):
        np.testing.assert_allclose(a.T_WS, b.T_WS, rtol=0, atol=atol)
        np.testing.assert_allclose(a.sb, b.sb, rtol=0, atol=atol)
    assert test.lm_ids == [int(lid) for lid in jest.lm_ids]
    np.testing.assert_allclose(test.hp_W, jest.hp_W, rtol=0, atol=atol)
    np.testing.assert_array_equal(test.obs_uid, jest.obs_uid)


def test_pose_only_optimise_matches_jax(window):
    """Three pose-only LM iterations from one state, the newest pose pushed
    5 cm off: poses and speed/bias within 1e-8, landmarks untouched, the
    cost within 1e-8 relative."""
    jest, test = pair(window)
    for est in (jest, test):
        est.frames[-1].T_WS = est.frames[-1].T_WS + np.array([0.05, -0.03, 0.02, 0, 0, 0, 0])
    hp0 = test.hp_W.copy()
    cost_j = jest.optimise(iterations=3, pose_only=True)
    cost_t = test.optimise(iterations=3, pose_only=True)
    assert abs(cost_t - cost_j) <= 1e-8 * max(1.0, abs(cost_j)), (cost_t, cost_j)
    assert_same_window(test, jest, atol=1e-8)
    np.testing.assert_array_equal(test.hp_W, hp0)


def test_reject_outliers_matches_jax(window):
    """The chi2 cut of the newest frame's observations removes the same
    uids in both, the six injected outliers among them."""
    jest, test = pair(window)
    _, (cams, T_SC), fid, bad = window
    pcfg = dict(max_keypoints=64, do_loop_closures=False)
    jpipe = JVioPipeline(cams, T_SC, jest.cfg, JPipelineConfig(**pcfg))
    tpipe = VioPipeline([convert.camera(jax.tree.map(np.asarray, c)) for c in cams], T_SC,
                        test.cfg, convert.pipeline_config(JPipelineConfig(**pcfg)), device="cpu")
    jpipe.est, tpipe.est = jest, test
    before = set(test.obs_uid.tolist())
    n_j, n_t = jpipe.reject_outliers(fid), tpipe.reject_outliers(fid)
    assert n_t == n_j >= len(bad)
    np.testing.assert_array_equal(test.obs_uid, jest.obs_uid)
    assert set(bad.tolist()) <= before - set(test.obs_uid.tolist())


def test_gated_dispatch_collect_matches_jax(window):
    """Dispatch the gated solve of the newest frame, append a landmark and
    observations of it (what the next frame's association does), collect:
    poses and speed/bias (1e-8), landmarks by id (1e-8), the same outlier
    uids removed (the injected ones among them) and the appended rows kept."""
    jest, test = pair(window)
    fid, bad = window[2], window[3]
    hs = [est.optimise_gated_dispatch(fid, GATE_PX) for est in (jest, test)]
    for est in (jest, test):
        lid = est.add_landmark(np.array([1.0, 2.5, 6.0, 1.0]))
        est.add_observations_batch(fid, 0, [lid, lid], np.array([[300.0, 200.0], [310, 205]]))
    (cost_j, n_j), (cost_t, n_t) = (est.optimise_gated_collect(h)
                                    for est, h in zip((jest, test), hs))
    assert n_t == n_j >= len(bad)
    assert abs(cost_t - cost_j) <= 1e-8 * max(1.0, abs(cost_j)), (cost_t, cost_j)
    assert_same_window(test, jest, atol=1e-8)
    assert not set(bad.tolist()) & set(test.obs_uid.tolist())
    assert test.obs_uid[-1] == test._obs_uid_next - 1  # the appended rows stay


def test_optimise_gated_is_dispatch_then_collect(window):
    """The synchronous gated solve equals its dispatch and collect."""
    _, a = pair(window)
    _, b = pair(window)
    fid = window[2]
    assert a.optimise_gated(fid, GATE_PX) == b.optimise_gated_collect(
        b.optimise_gated_dispatch(fid, GATE_PX))
    assert_same_window(a, b, atol=0)


@pytest.mark.parametrize("lims", [(0.035, 6, 10), (0.035, 3, 10), (0.05, 4, 4), (0.0, 3, 10)])
def test_realtime_budget_matches_jax(lims):
    """A fixed list of solve wall times through both controllers: the same
    iteration bucket, overrun flag, overrun count and EMA after every
    sample; `_rt_iters` feeds the next dispatch."""
    limit, lo, hi = lims
    kw = dict(realtime_time_limit=limit, min_iterations=lo, max_iterations=hi)
    cam = convert.camera(jax.tree.map(np.asarray, jpin.make_pinhole(
        400.0, 400.0, 320.0, 240.0, 640, 480, model="none")))
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0]])
    jest = JEstimator(JEstimatorConfig(**kw), [jpin.make_pinhole(
        400.0, 400.0, 320.0, 240.0, 640, 480, model="none")], T_SC)
    test = SlidingWindowEstimator(convert.estimator_config(jest.cfg), [cam], T_SC, device="cpu")
    walls = [0.8, 0.9, 0.7, 0.012, 0.01, 0.011, 0.02, 0.009, 0.008, 0.006, 0.007, 0.01, 0.2,
             0.01, 0.005, 0.004, 0.004, 0.003, 0.03, 0.036]
    for w in walls:
        assert test.adapt_realtime_budget(w) == jest.adapt_realtime_budget(w)
        assert (test._rt_iters, test.n_budget_overruns) == (jest._rt_iters,
                                                           jest.n_budget_overruns)
        assert test._rt_ema == jest._rt_ema
    if limit:
        assert test.n_budget_overruns > 0
    assert test.optimise_gated_dispatch(0, GATE_PX)["iters"] == test._rt_iters


def test_pipeline_config_defaults_equal_jax():
    """Every field of the port's PipelineConfig and EstimatorConfig has the
    JAX package's default, and the JAX default configuration with loop
    closure builds a port pipeline on the CPU (its worker thread started,
    then stopped by `finish()`)."""
    jcfg, tcfg = JPipelineConfig(), PipelineConfig()
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    je, te = JEstimatorConfig(), EstimatorConfig()
    for f in dataclasses.fields(te):
        if f.name not in ("dtype", "imu"):
            assert getattr(te, f.name) == getattr(je, f.name), f.name
    cam = convert.camera(jax.tree.map(np.asarray, jpin.make_pinhole(
        460.0, 460.0, 376.0, 240.0, 752, 480)))
    pipe = VioPipeline([cam, cam], np.array([[-0.055, 0, 0, 0, 0, 0, 1.0],
                                             [0.055, 0, 0, 0, 0, 0, 1.0]]), te,
                       convert.pipeline_config(JPipelineConfig(do_loop_closures=True)),
                       device="cpu")
    worker = pipe._lc_thread
    assert pipe.cfg.pose_refine and pipe.cfg.pipelined_solve and worker.is_alive()
    pipe.finish()
    worker.join(timeout=10.0)
    assert not worker.is_alive() and pipe._lc_thread is None
