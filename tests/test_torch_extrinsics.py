"""Online extrinsics calibration of the port against the JAX package, on the
same numpy-seeded inputs in float64 on the CPU: the extrinsics prior rows of
the solver, `two_pose_extrinsics_edge` (with the two cases of
tests/test_marginalization.py), tests/test_solver.py's online calibration
case, and the window solve and the final BA of an estimator with the
extrinsics free.

Tolerances: the prior rows to 1e-10 (elementwise maths); the edge's sqrt
information to 1e-5 of its largest entry, as `two_pose_edge` in
tests/test_torch_solver.py (a pseudo-inverse of a gauge block amplifies
rounding); estimator states to 1e-6 m on positions and 1e-7 on T_SC (LM
steps through matrix inverses, frames chained)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu import testing as jtesting
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.factors import priors as jpri
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.graph import SlidingWindowEstimator as JEstimator
from okvis2x_tpu.graph import marginalization as jmarg
from okvis2x_tpu.solver import gauss_newton as jgn
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.factors import priors
from okvis2x_tpu_torch.graph import marginalization
from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator
from okvis2x_tpu_torch.solver import gauss_newton as gn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_estimator import make_landmarks, make_rig, simulate  # noqa: E402
from test_marginalization import build_pair  # noqa: E402
from test_torch_loopclosure import port_of  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-10
POS_M = 1e-6
T_SC_TOL = 1e-7


def close(a, b, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b), rtol=rtol, atol=atol)


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def calibration_problem():
    """tests/test_solver.py's online calibration problem: the synthetic window
    (K=6, L=128, N=1024) with camera 1's extrinsics 2 cm and about 1.7 deg
    off, free under a loose prior (5 m, 5 rad) at the wrong value; camera 0
    fixes the gauge.  Returns (JAX problem, JAX cameras, true T_SC, wrong)."""
    p, cams = jtesting.synthetic_window_problem(K=6, L=128, N=1024, dtype=jnp.float64,
                                                noise_px=0.1)
    T_SC_true = np.asarray(p.T_SC)
    d = np.array([0.02, -0.015, 0.01, 0.02, -0.015, 0.01])
    T_SC_bad = T_SC_true.copy()
    T_SC_bad[1] = np.asarray(jse3.retract(jnp.asarray(T_SC_true[1]), jnp.asarray(d)))
    si = np.diag(np.full(6, 1 / 5.0))
    p = p._replace(
        T_SC=jnp.asarray(T_SC_bad), ext_fixed=jnp.array([True, False]),
        ext_prior_T=jnp.asarray(T_SC_bad),
        ext_prior_sqrt_info=jnp.asarray(np.tile(si, (2, 1, 1))),
        ext_prior_valid=jnp.ones(2, bool),
    )
    return p, cams, T_SC_true, T_SC_bad


def test_linearize_ext_priors_matches_jax():
    """The extrinsics prior rows: residuals and the 6x6 blocks at the columns
    K * 15 + 6 * c of JAX's dense rows, with a prior away from T_SC."""
    p, _, _, _ = calibration_problem()
    rng = np.random.default_rng(3)
    prior = np.asarray(p.T_SC) + np.concatenate([rng.normal(0, 0.01, (2, 3)),
                                                 np.zeros((2, 4))], 1)
    p = p._replace(ext_prior_T=jnp.asarray(prior),
                   ext_prior_sqrt_info=jnp.asarray(np.tile(np.diag([1e3] * 3 + [200.0] * 3),
                                                           (2, 1, 1))))
    r_j, Jrow_j, v_j = jax.jit(jgn._linearize_ext_priors)(p)
    pt = convert.ba_problem(np_tree(p))
    r_t, [(J_t, c0)], v_t = gn._linearize_ext_priors(pt)
    close(r_t, r_j)
    K = p.K
    np.testing.assert_array_equal(c0.numpy(), K * 15 + 6 * np.arange(2))
    for c in range(2):
        close(J_t[c], np.asarray(Jrow_j)[c, :, K * 15 + 6 * c:K * 15 + 6 * c + 6],
              atol=1e-9)
    assert np.abs(np.asarray(Jrow_j)).sum() == pytest.approx(np.abs(J_t.numpy()).sum())
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    close(priors.pose_prior_residual(pt.ext_prior_T, pt.T_SC, pt.ext_prior_sqrt_info),
          jax.vmap(jpri.pose_prior_residual)(p.ext_prior_T, p.T_SC, p.ext_prior_sqrt_info))


# --------------------------------------- tests/test_marginalization.py


def _both_edges(d):
    ct = convert.stacked_cameras(np_tree(d["cams"]))
    args = [d[k] for k in ("T_a", "T_b", "T_SC", "hp", "lm_mask", "obs_pose", "obs_cam",
                           "obs_lm", "obs_uv", "obs_sqrt_info", "obs_mask")]
    targs = [convert.tensor(np.asarray(a)) for a in args]
    ext_t = marginalization.two_pose_extrinsics_edge(ct, *targs)
    ext_j = jax.jit(lambda *a: jmarg.two_pose_extrinsics_edge(d["cams"], *a))(*args)
    fixed_t = marginalization.two_pose_edge(ct, *targs)
    return ext_t, ext_j, fixed_t


def test_extrinsics_edge_matches_jax():
    (Tt, Wt, st), (Tj, Wj, sj), _ = _both_edges(build_pair())
    close(Tt, Tj)
    close(Wt, Wj, atol=1e-5 * float(np.abs(Wj).max()))
    close(st, sj, rtol=1e-6, atol=0)


def test_extrinsics_edge_zero_residual_and_psd():
    """Measurement = current relative pose, information PSD."""
    d = build_pair()
    (T_ab, sqrt_info, strength), _, _ = _both_edges(d)
    r = priors.relative_pose_residual(T_ab, convert.tensor(np.asarray(d["T_a"])),
                                      convert.tensor(np.asarray(d["T_b"])), sqrt_info)
    close(r, np.zeros(6), atol=1e-8)
    H = sqrt_info.numpy() @ sqrt_info.numpy()
    assert np.linalg.eigvalsh(0.5 * (H + H.T)).min() > -1e-6
    assert float(strength) > 0


def test_extrinsics_edge_weaker_than_fixed_extrinsics():
    """Marginalising the extrinsics too can only remove information."""
    (_, si_ext, s_ext), _, (_, si_fixed, s_fixed) = _both_edges(build_pair())
    H_fixed = si_fixed.numpy() @ si_fixed.numpy()
    H_ext = si_ext.numpy() @ si_ext.numpy()
    assert float(s_ext) <= float(s_fixed) + 1e-6
    ev = np.linalg.eigvalsh(0.5 * ((H_fixed - H_ext) + (H_fixed - H_ext).T))
    assert ev.min() > -1e-5 * max(1.0, ev.max())


# ------------------------------------------------ tests/test_solver.py


def test_online_extrinsics_calibration():
    """The perturbed camera-1 extrinsics are pulled back towards the truth
    (to under 0.3 of the error in the 15 iterations of the JAX package's
    test); JAX's solve agrees after 5 iterations (T_SC to 1e-7: the cost has
    converged there, and the further steps on its flat floor amplify
    rounding, 2e-6 apart after 15); with calibration off the extrinsics do
    not move."""
    p, cams, T_SC_true, T_SC_bad = calibration_problem()
    pt, ct = convert.ba_problem(np_tree(p)), convert.stacked_cameras(np_tree(cams))
    o5, _ = gn.optimize(pt, ct, gn.SolverConfig(max_iterations=5, use_ext_priors=True))
    oj, _ = jax.jit(lambda q: jgn.optimize(
        q, cams, jgn.SolverConfig(max_iterations=5, use_ext_priors=True)))(p)
    close(o5.T_SC, oj.T_SC, atol=T_SC_TOL)
    close(o5.T_WS, oj.T_WS, atol=POS_M)
    ot, _ = gn.optimize(pt, ct, gn.SolverConfig(max_iterations=15, use_ext_priors=True))
    err_before = np.linalg.norm(T_SC_bad[1][:3] - T_SC_true[1][:3])
    err_after = np.linalg.norm(ot.T_SC.numpy()[1][:3] - T_SC_true[1][:3])
    assert err_after < 0.3 * err_before, (err_before, err_after)
    off, _ = gn.optimize(pt._replace(ext_fixed=torch.ones(2, dtype=torch.bool)), ct,
                         gn.SolverConfig(max_iterations=3))
    close(off.T_SC, T_SC_bad, atol=1e-12)


# ------------------------------------------------------- the estimator


@pytest.fixture(scope="module")
def calibrated_vio():
    """tests/test_estimator.py's VIO simulation (3 s, keyframe every third
    frame) run by the JAX estimator with `do_extrinsics` and
    `do_extrinsics_final_ba` on, given extrinsics 1 cm and 0.01 rad off the
    rig that made the observations; the port's estimator runs the same feed
    in lockstep.  Returns (JAX estimator, port estimator, true T_SC, given)."""
    cams, T_SC = make_rig()
    T_SC_given = np.stack([se3np.retract(T, np.array([0.01, -0.005, 0.005, 0.01, 0.0, -0.01]))
                           for T in T_SC])
    sim = simulate(duration=3.0)
    pts = make_landmarks()
    cfg = EstimatorConfig(cap_frames=10, num_keyframes=4, num_imu_frames=3, cap_landmarks=96,
                          cap_obs=768, cap_imu_links=9, max_iterations=5, do_extrinsics=True,
                          do_extrinsics_final_ba=True, extrinsics_sigma_r=0.02,
                          extrinsics_sigma_alpha=0.02, extrinsics_sigma_r_final_ba=0.01,
                          extrinsics_sigma_alpha_final_ba=0.01)
    jest = JEstimator(cfg, cams, T_SC_given)
    test = SlidingWindowEstimator(convert.estimator_config(cfg),
                                  [convert.camera(c) for c in cams], T_SC_given, device="cpu")
    lids = ({}, {})
    rng = np.random.default_rng(13)
    i_imu = 0
    for k, tf in enumerate(sim["t_frames"]):
        lim = tf + (0.01 if k == 0 else 0.005)
        while i_imu < len(sim["t_imu"]) and sim["t_imu"][i_imu] <= lim:
            for est in (jest, test):
                est.add_imu_measurement(sim["t_imu"][i_imu], sim["gyr"][i_imu],
                                        sim["acc"][i_imu])
            i_imu += 1
        fids = [est.add_state(tf) for est in (jest, test)]
        for c in range(2):
            T_CW = jse3.se3_multiply(jse3.se3_inverse(jnp.asarray(T_SC[c])),
                                     jse3.se3_inverse(jnp.asarray(sim["T_WS_gt"][k])))
            p_C = np.asarray(jax.vmap(lambda pt: jse3.se3_apply(T_CW, pt))(jnp.asarray(pts)))
            uv, valid = (np.asarray(x) for x in jpin.project(cams[0], jnp.asarray(p_C)))
            for i in np.nonzero(valid)[0][:30]:
                hp = None
                if i not in lids[0]:
                    hp = np.concatenate([pts[i] + rng.normal(0, 0.05, 3), [1.0]])
                uv_i = uv[i] + rng.normal(0, 0.5, 2)
                for est, lid, fid in zip((jest, test), lids, fids):
                    if hp is not None:
                        lid[i] = est.add_landmark(hp)
                    est.add_observations_batch(fid, c, [lid[i]], uv_i[None])
        for est, fid in zip((jest, test), fids):
            est.set_keyframe(fid, k % 3 == 0)
            est.optimise()
            est.marginalise()
        np.testing.assert_allclose(test.T_SC, jest.T_SC, rtol=0, atol=T_SC_TOL,
                                   err_msg=f"frame {k}")
        np.testing.assert_allclose(test.frames[-1].T_WS[:3], jest.frames[-1].T_WS[:3], rtol=0,
                                   atol=POS_M, err_msg=f"frame {k}")
    return jest, test, T_SC, T_SC_given


def test_window_calibration_matches_jax(calibrated_vio):
    """Frame by frame in lockstep (the fixture asserts T_SC and the newest
    position each frame); the calibration moved T_SC and kept its prior."""
    jest, test, _, T_SC_given = calibrated_vio
    assert np.abs(test.T_SC - T_SC_given).max() > 1e-5
    np.testing.assert_array_equal(test.T_SC_prior, T_SC_given)
    port_copy = port_of(jest)
    np.testing.assert_array_equal(port_copy.T_SC, jest.T_SC)
    np.testing.assert_array_equal(port_copy.T_SC_prior, jest.T_SC_prior)


def test_final_ba_with_extrinsics_matches_jax(calibrated_vio):
    """`final_ba` with `do_extrinsics_final_ba` from one state (the JAX
    estimator's, copied into the port): T_SC to 1e-7, every keyframe
    position to 1e-6 m, the cost to 1e-6 relative."""
    jest, _, _, _ = calibrated_vio
    test = port_of(jest)
    T_SC_before = test.T_SC.copy()
    cost_j = jest.final_ba(iterations=8)
    cost_t = test.final_ba(iterations=8)
    assert np.isfinite(cost_t) and abs(cost_t - cost_j) <= 1e-6 * max(1.0, abs(cost_j))
    np.testing.assert_allclose(test.T_SC, jest.T_SC, rtol=0, atol=T_SC_TOL)
    assert np.abs(test.T_SC - T_SC_before).max() > 1e-7
    ft, fT = test.full_trajectory()
    jt, jT = jest.full_trajectory()
    np.testing.assert_array_equal(ft, jt)
    np.testing.assert_allclose(fT, jT, rtol=0, atol=POS_M)
