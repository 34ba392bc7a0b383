"""Parity of the port's final BA with the JAX package: the joint and the
segmented `final_ba` of tests/test_estimator.py, run by both estimators
from one state (`convert.estimator_state`)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.graph import SlidingWindowEstimator as JEstimator
from test_torch_loopclosure import port_of

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vio_state():
    """The VIO simulation of tests/test_estimator.py (5 s, keyframe every
    third frame) run by the JAX estimator, then copied twice."""
    from test_estimator import make_landmarks, make_rig, simulate

    cams, T_SC = make_rig()
    sim = simulate(duration=5.0)
    pts = make_landmarks()
    cfg = EstimatorConfig(cap_frames=10, num_keyframes=4, num_imu_frames=3, cap_landmarks=256,
                          cap_obs=2048, cap_imu_links=9, max_iterations=5)
    est = JEstimator(cfg, cams, T_SC)
    for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"]):
        if t > sim["t_frames"][0] + 0.01:
            break
        est.add_imu_measurement(t, w, a)
    lid_by_pt = {}
    rng = np.random.default_rng(13)
    imu_idx = np.searchsorted(sim["t_imu"], sim["t_frames"][0] + 0.01)
    for k, tf in enumerate(sim["t_frames"]):
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
        est.optimise()
        est.marginalise()
    return est, sim


def jax_copy(est):
    cache, est._jit_cache = est._jit_cache, {}
    out = copy.deepcopy(est)
    est._jit_cache = out._jit_cache = cache
    return out


@pytest.mark.parametrize("max_nodes", [128, 10])
def test_final_ba_matches_jax(vio_state, max_nodes):
    """Joint (max_nodes 128) and segmented (10 nodes: pose graph plus three
    or more overlapping segments) final BA from one state: every keyframe
    position within 1e-6 m of the JAX package (LM steps through inverses
    and pose-graph CG in float64 agree to rounding), the cost within 1e-6
    relative, and the trajectory within 0.2 m of the ground truth."""
    jest0, sim = vio_state
    jest = jax_copy(jest0)
    test = port_of(jest)
    assert len(jest.archive_frames) + len(jest.frames) > 10
    assert len(jest.arch_obs_fid) > 100 and len(jest.arch_imu_t) > 100
    cost_j = jest.final_ba(iterations=8, max_nodes=max_nodes)
    cost_t = test.final_ba(iterations=8, max_nodes=max_nodes)
    assert np.isfinite(cost_t) and abs(cost_t - cost_j) <= 1e-6 * max(1.0, abs(cost_j))
    ft, fT = test.full_trajectory()
    jt, jT = jest.full_trajectory()
    np.testing.assert_array_equal(ft, jt)
    np.testing.assert_allclose(fT, jT, rtol=0, atol=1e-6)
    errs = [np.linalg.norm(T[:3] - sim["T_WS_gt"][int(np.argmin(np.abs(sim["t_frames"] - t)))][:3])
            for t, T in zip(ft, fT)]
    assert max(errs) < 0.2, errs
