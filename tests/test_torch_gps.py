"""GNSS fusion of the port against the JAX package, on the same numpy-seeded
inputs in float64 on the CPU.

Tolerances: the factor functions and their Jacobians agree to 1e-10
absolute (elementwise maths); the linearisation's H and b to 1e-9 of their
largest entry and the cost to 1e-10 relative (sums over rows taken in
another order); the estimators in lockstep to 1e-6 m and 1e-8 on T_GW (each
frame's 5 LM iterations go through a matrix inverse, and the frames chain).

Run as a script, this file runs the JAX app on the first GNSS_FRAMES frames
of the GNSS phase of `chip_smoke.py` on the CPU and prints, as one JSON
line, the T_GW errors and global ATE that phase's bounds are set from; with
--count-aten it counts the aten calls of one `linearize` of
`gnss_window_problem` without and with the GNSS and extrinsics rows:

    JAX_PLATFORMS=cpu python tests/test_torch_gps.py [n_frames]
    JAX_PLATFORMS=cpu python tests/test_torch_gps.py --count-aten
"""

import json
import os
import runpy
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # run as a script, too
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from okvis2x_tpu.cameras import pinhole as jpin  # noqa: E402
from okvis2x_tpu.core import se3 as jse3  # noqa: E402
from okvis2x_tpu.factors import gps as jgps  # noqa: E402
from okvis2x_tpu.graph.estimator import EstimatorConfig  # noqa: E402
from okvis2x_tpu.graph.estimator import SlidingWindowEstimator as JEstimator  # noqa: E402
from okvis2x_tpu.imu import preintegration as jpre  # noqa: E402
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline  # noqa: E402
from okvis2x_tpu.solver import gauss_newton as jgn  # noqa: E402
from okvis2x_tpu_torch import convert  # noqa: E402
from okvis2x_tpu_torch.cameras import pinhole  # noqa: E402
from okvis2x_tpu_torch.core import se3, se3np  # noqa: E402
from okvis2x_tpu_torch.factors import gps  # noqa: E402
from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator  # noqa: E402
from okvis2x_tpu_torch.imu import preintegration as pre  # noqa: E402
from okvis2x_tpu_torch.solver import gauss_newton as gn  # noqa: E402
from okvis2x_tpu_torch.solver import problem as prb  # noqa: E402
from test_estimator import make_landmarks, make_rig, simulate  # noqa: E402
from test_torch_solver import full_window_problem  # noqa: E402

torch.set_num_threads(1)

F64_ATOL = 1e-10
LOCK_POS_M = 1e-6  # lockstep estimators: positions
LOCK_TGW = 1e-8  # lockstep estimators: T_GW entries
TRUE_TGW_POS = np.array([10.0, -5.0, 2.0])


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def close(a, b, rtol=0.0, atol=F64_ATOL):
    np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b), rtol=rtol, atol=atol)


def yaw_tgw(yaw, t):
    """A yaw-only T_GW (7,) in numpy."""
    return np.concatenate([t, [0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)]])


def random_poses(rng, n, scale=2.0):
    q = rng.normal(size=(n, 4))
    q[:, 3] = np.abs(q[:, 3])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.normal(0, scale, (n, 3)), q], axis=1)


def _bridges(rng, n, S=24):
    """Preintegrated bridge spans (n rows) from both packages on the same
    samples: (port Preintegrated, JAX Preintegrated)."""

    t = np.sort(rng.uniform(0, 0.1, (n, S)), axis=1)
    gyr = rng.normal(0, 0.5, (n, S, 3))
    acc = rng.normal(0, 1.0, (n, S, 3)) + [0, 0, 9.81]
    mask = np.ones((n, S), bool)
    t0, t1 = t[:, 1] - 0.001, t[:, -3] + 0.0005
    bg, ba = rng.normal(0, 0.01, (n, 3)), rng.normal(0, 0.05, (n, 3))
    pt = pre.preintegrate(pre.ImuParams(), pre.ImuBatch(T(t), T(gyr), T(acc),
                                                        torch.from_numpy(mask)),
                          T(t0), T(t1), T(bg), T(ba))
    pj = jax.vmap(lambda *a: jpre.preintegrate(jpre.ImuParams(), jpre.ImuBatch(*a[:4]),
                                               *a[4:]))(t, gyr, acc, mask, t0, t1, bg, ba)
    return pt, pj


# ---------------------------------------------------------------- factors


def test_factor_functions_match_jax():
    """retract_4dof, residual_sync, residual_async and the Jacobians of
    residual_async_on_manifold on 16 random fixes, against JAX's (1e-10)."""

    rng = np.random.default_rng(21)
    n = 16
    T_GW = yaw_tgw(0.7, TRUE_TGW_POS)
    d4 = rng.normal(0, 0.3, (n, 4))
    close(torch.stack([gps.retract_4dof(T(T_GW), T(d)) for d in d4]),
          jax.vmap(lambda d: jgps.retract_4dof(jnp.asarray(T_GW), d))(d4))
    T_WS = random_poses(rng, n)
    sb = rng.normal(0, 0.2, (n, 9))
    p_G = rng.normal(0, 3.0, (n, 3)) + TRUE_TGW_POS
    r_SA = rng.normal(0, 0.1, 3)
    si = np.tril(rng.normal(size=(n, 3, 3))) + 20 * np.eye(3)
    close(gps.residual_sync(T(T_GW), T(T_WS), T(p_G), T(r_SA), T(si)),
          jax.vmap(lambda *a: jgps.residual_sync(T_GW, a[0], a[1], r_SA, a[2]))(T_WS, p_G, si),
          atol=1e-9)
    pt, pj = _bridges(rng, n)
    params_t, params_j = pre.ImuParams(), jpre.ImuParams()
    close(gps.residual_async(params_t, pt, T(T_GW), T(T_WS), T(sb), T(p_G), T(r_SA), T(si)),
          jax.vmap(lambda p, *a: jgps.residual_async(params_j, p, T_GW, a[0], a[1], a[2], r_SA,
                                                     a[3]))(pj, T_WS, sb, p_G, si),
          atol=1e-9)

    z6, z9, z4 = np.zeros(6), np.zeros(9), np.zeros(4)

    def jac_t(p, Tw, s, pg, w):
        def f(dp, ds, dg):
            return gps.residual_async_on_manifold(params_t, p, T(T_GW), Tw, s, pg, T(r_SA), w,
                                                  dp, ds, dg)

        return torch.func.jacfwd(f, argnums=(0, 1, 2))(T(z6), T(z9), T(z4))

    def jac_j(p, Tw, s, pg, w):
        def f(dp, ds, dg):
            return jgps.residual_async_on_manifold(params_j, p, T_GW, Tw, s, pg, r_SA, w,
                                                   dp, ds, dg)

        return jax.jacfwd(f, argnums=(0, 1, 2))(z6, z9, z4)

    Jt = torch.func.vmap(jac_t)(pt, T(T_WS), T(sb), T(p_G), T(si))
    Jj = jax.jit(jax.vmap(jac_j))(pj, T_WS, sb, p_G, si)
    for a, b in zip(Jt, Jj):
        close(a, b, atol=1e-8 * max(1.0, float(np.abs(b).max())))


# ----------------------------------------- tests/test_gps.py on the port


def test_residual_zero_at_truth_sync():

    T_GW = T(yaw_tgw(0.7, TRUE_TGW_POS))
    T_WS = T(random_poses(np.random.default_rng(1), 1)[0])
    r_SA = T([0.1, 0.0, 0.05])
    p_W = se3.se3_t(T_WS) + se3.quat_rotate(se3.se3_q(T_WS), r_SA)
    r = gps.residual_sync(T_GW, T_WS, se3.se3_apply(T_GW, p_W), r_SA,
                          torch.eye(3, dtype=torch.float64))
    close(r, np.zeros(3), atol=1e-12)


def test_retract_4dof_yaw_only():

    T_GW = T(yaw_tgw(0.7, TRUE_TGW_POS))
    d = T([0.1, -0.2, 0.3, 0.05])
    T2 = gps.retract_4dof(T_GW, d)
    close(T2[:3] - T_GW[:3], d[:3].numpy(), atol=1e-15)
    assert abs(float(se3.quat_to_matrix(T2[3:7])[2, 2]) - 1.0) < 1e-12


def test_async_jacobians_finite_diff():
    """The autodiff Jacobians of the asynchronous factor against central
    differences (step 1e-7, atol 1e-4, as the JAX package's test)."""
    T_GW = T(yaw_tgw(0.7, TRUE_TGW_POS))
    T_WS = T(random_poses(np.random.default_rng(2), 1)[0])
    sb = T(np.concatenate([[0.3, -0.1, 0.05], 1e-3 * np.ones(6)]))
    bridge = pre.Preintegrated(*[x[0] for x in prb.empty_pre(1, torch.float64)])
    bridge = bridge._replace(dt=T(0.05))
    r_SA, p_G = T([0.1, 0.0, 0.05]), T([9.0, -4.0, 2.5])
    si = torch.eye(3, dtype=torch.float64) / 0.05

    def f(dpose, dsb, d4):
        return gps.residual_async_on_manifold(pre.ImuParams(), bridge, T_GW, T_WS, sb, p_G,
                                              r_SA, si, dpose, dsb, d4)

    zs = [torch.zeros(k, dtype=torch.float64) for k in (6, 9, 4)]
    J = torch.func.jacfwd(f, argnums=(0, 1, 2))(*zs)
    eps = 1e-7
    for ai, dim in [(0, 6), (1, 9), (2, 4)]:
        for i in range(dim):
            args = [z.clone() for z in zs]
            args[ai][i] = eps
            rp = f(*args)
            args[ai][i] = -eps
            num = (rp - f(*args)) / (2 * eps)
            close(J[ai][:, i], num.numpy(), atol=1e-4)


def _cams():
    return gn.stack_cameras([pinhole.make_pinhole(1.0, 1.0, 0, 0, 2, 2, model="none")])


def test_solver_recovers_tgw_alignment():
    """Known states and GNSS fixes: the solve with only T_GW free recovers
    the alignment (0.02 m, 0.01 rad, as the JAX package's test)."""
    K = 4
    T_GW_true = T(yaw_tgw(0.7, TRUE_TGW_POS))
    rng = np.random.default_rng(4)
    p = prb.empty_problem(K=K, L=1, C=1, N=1, M=1, R=1, G=K)
    T_WS = np.zeros((K, 7))
    T_WS[:, 6] = 1
    T_WS[:, 0] = np.arange(K) * 1.0
    T_WS[:, 1] = np.arange(K) * 0.3
    p_G = se3.se3_apply(T_GW_true, T(T_WS[:, :3])).numpy() + rng.normal(0, 0.01, (K, 3))
    p = p._replace(
        T_WS=T(T_WS), frame_valid=torch.ones(K, dtype=torch.bool),
        pose_fixed=torch.ones(K, dtype=torch.bool), sb_fixed=torch.ones(K, dtype=torch.bool),
        T_GW=gps.retract_4dof(T_GW_true, T([0.5, -0.4, 0.3, 0.1])),
        tgw_fixed=torch.tensor(False), gps_frame=torch.arange(K), gps_p_G=T(p_G),
        gps_sqrt_info=(torch.eye(3, dtype=torch.float64) / 0.01).repeat(K, 1, 1),
        gps_valid=torch.ones(K, dtype=torch.bool),
    )
    p_opt, _ = gn.optimize(p, _cams(), gn.SolverConfig(max_iterations=10,
                                                       estimate_landmarks=False))
    close(p_opt.T_GW[:3], T_GW_true[:3].numpy(), atol=0.02)
    dq = se3.quat_multiply(se3.quat_conjugate(p_opt.T_GW[3:7]), T_GW_true[3:7])
    assert float(torch.linalg.norm(se3.quat_log(dq))) < 0.01


# ---------------------------------------------------------------- solver


def gnss_window_problem(ext=True):
    """tests/test_torch_solver.py's full window problem (every VIO family on)
    with 3 GNSS rows on frames 1, 3 and 3 (the last one invalid), T_GW free
    and a 0.3 m antenna offset; with `ext`, the extrinsics of camera 1 free
    under a prior.  Returns (JAX problem, JAX cameras)."""
    p, cams = full_window_problem()
    rng = np.random.default_rng(31)
    _, pj = _bridges(rng, 3)
    T_GW = yaw_tgw(0.6, TRUE_TGW_POS)
    fr = np.array([1, 3, 3], np.int32)
    p_W = np.asarray(p.T_WS)[fr, :3] + rng.normal(0, 0.1, (3, 3))
    Rz = np.array([[np.cos(0.6), -np.sin(0.6), 0], [np.sin(0.6), np.cos(0.6), 0], [0, 0, 1]])
    p = p._replace(
        T_GW=jnp.asarray(yaw_tgw(0.55, TRUE_TGW_POS + [0.2, -0.1, 0.05])),
        tgw_fixed=jnp.asarray(False), gps_frame=jnp.asarray(fr), gps_pre=pj,
        gps_p_G=jnp.asarray(p_W @ Rz.T + T_GW[:3]),
        gps_r_SA=jnp.asarray([0.0, 0.1, 0.3]),
        gps_sqrt_info=jnp.asarray(np.tile(np.eye(3) / 0.05, (3, 1, 1))),
        gps_valid=jnp.asarray([True, True, False]),
    )
    if ext:
        T_SC = np.asarray(p.T_SC)
        prior = T_SC + np.concatenate([rng.normal(0, 0.005, (2, 3)), np.zeros((2, 4))], 1)
        p = p._replace(
            ext_fixed=jnp.asarray([True, False]), ext_prior_T=jnp.asarray(prior),
            ext_prior_sqrt_info=jnp.asarray(np.tile(np.diag([1e3] * 3 + [200.0] * 3),
                                                    (2, 1, 1))),
            ext_prior_valid=jnp.asarray([True, True]))
    return p, cams


@pytest.mark.parametrize("ext", [False, True])
def test_linearize_gps_rows_match_jax(ext):
    """H, b and cost of `linearize` with the GNSS rows (T_GW free), with and
    without the extrinsics prior rows, and `compute_cost`, against JAX's;
    then, with both, 5 LM iterations: T_WS, T_GW and T_SC to 1e-7."""

    p, cams = gnss_window_problem(ext)
    pn = jax.tree.map(np.asarray, p)
    pt, ct = convert.ba_problem(pn), convert.stacked_cameras(jax.tree.map(np.asarray, cams))
    cfg = gn.SolverConfig(imu_params=pre.ImuParams(), use_ext_priors=ext)
    jcfg = jgn.SolverConfig(use_ext_priors=ext)
    lt = gn.linearize(pt, ct, cfg)
    lj = jax.jit(lambda q, c: jgn.linearize(q, c, jcfg))(p, cams)
    for k in ("H_ff", "b_f", "W"):
        ref = np.asarray(getattr(lj, k))
        close(getattr(lt, k), ref, rtol=1e-9, atol=1e-9 * float(np.abs(ref).max()))
    # the GNSS rows reach the T_GW block and its cross terms with frames 1, 3
    Hg = np.asarray(lj.H_ff)[-4:]
    assert np.abs(Hg[:, -4:]).max() > 1.0 and np.abs(Hg[:, 15:30]).max() > 1.0
    close(lt.cost, lj.cost, rtol=1e-10, atol=0)
    close(gn.compute_cost(pt, ct, cfg),
          jax.jit(lambda q, c: jgn.compute_cost(q, c, jcfg))(p, cams), rtol=1e-10, atol=0)
    if not ext:
        return
    ot, c_t = gn.optimize(pt, ct, cfg._replace(max_iterations=5))
    oj, cj = jax.jit(lambda q, c: jgn.optimize(q, c, jcfg._replace(max_iterations=5)))(p, cams)
    for k in ("T_WS", "T_GW", "T_SC"):
        close(getattr(ot, k), getattr(oj, k), atol=1e-7)
    close(c_t, cj, rtol=1e-7, atol=0)
    assert bool((ot.T_SC[1] != pt.T_SC[1]).any()) and bool((ot.T_SC[0] == pt.T_SC[0]).all())
    assert torch.isfinite(ot.T_GW).all()


# -------------------------------------------- the estimator's GNSS rows


def _sim_feed(duration, frame_rate, dropout=None, seed=17):
    """The feed of tests/test_gps.py's estimator scenario (tests/test_estimator.py's
    simulation, 30 stereo observations a camera a frame, 5 Hz GNSS fixes of the
    ground truth in a frame yawed 0.5 rad and moved (10, -5, 2) m), computed
    once so that two estimators get identical inputs: a list of frames, each
    dict(imu, t, obs [(cam, point, new landmark hp or None, uv)], gps)."""
    rng = np.random.default_rng(seed)
    cams, T_SC = make_rig()
    sim = simulate(duration=duration, frame_rate=frame_rate)
    pts = make_landmarks()
    T_GW_true = yaw_tgw(0.5, TRUE_TGW_POS)
    feed, seen = [], set()
    imu = [(t, w, a) for t, w, a in zip(sim["t_imu"], sim["gyr"], sim["acc"])]
    i_imu = 0
    next_gps = 0.0
    for k, tf in enumerate(sim["t_frames"]):
        lim = tf + (0.01 if k == 0 else 0.005)
        chunk = []
        while i_imu < len(imu) and imu[i_imu][0] <= lim:
            chunk.append(imu[i_imu])
            i_imu += 1
        obs = []
        for c in range(2):
            T_CW = jse3.se3_multiply(jse3.se3_inverse(jnp.asarray(T_SC[c])),
                                     jse3.se3_inverse(jnp.asarray(sim["T_WS_gt"][k])))
            p_C = np.asarray(jax.vmap(lambda pt: jse3.se3_apply(T_CW, pt))(jnp.asarray(pts)))
            uv, valid = (np.asarray(x) for x in jpin.project(cams[0], jnp.asarray(p_C)))
            for i in np.nonzero(valid)[0][:30]:
                hp = None
                if i not in seen:
                    seen.add(i)
                    hp = np.concatenate([pts[i] + rng.normal(0, 0.05, 3), [1.0]])
                obs.append((c, int(i), hp, uv[i] + rng.normal(0, 0.5, 2)))
        fix = None
        if tf >= next_gps:
            p_G = (jse3.se3_apply(jnp.asarray(T_GW_true), jnp.asarray(sim["T_WS_gt"][k][:3]))
                   + rng.normal(0, 0.02, 3))
            next_gps = tf + 0.2
            if dropout is None or not dropout[0] <= tf < dropout[1]:
                fix = (tf, np.asarray(p_G), np.full(3, 0.02))
        feed.append(dict(imu=chunk, t=tf, obs=obs, gps=fix, kf=k % 3 == 0))
    return cams, T_SC, T_GW_true, feed


# tests/test_gps.py's window with the landmark and observation tables cut to
# what the feed fills (under 40 landmarks and 600 observations live)
EST_CFG = EstimatorConfig(cap_frames=10, num_keyframes=4, num_imu_frames=3, cap_landmarks=96,
                          cap_obs=768, cap_imu_links=9, max_iterations=5)


def _step(est, fr, lids, batch):
    """Feed one frame to an estimator and solve; returns its state after."""
    for t, w, a in fr["imu"]:
        est.add_imu_measurement(t, w, a)
    fid = est.add_state(fr["t"])
    for c, i, hp, uv in fr["obs"]:
        if hp is not None:
            lids[i] = est.add_landmark(hp)
        if batch:
            est.add_observations_batch(fid, c, [lids[i]], np.asarray(uv)[None])
        else:
            est.add_observation(fid, c, lids[i], uv)
    if fr["gps"] is not None:
        est.add_gps_measurement(*fr["gps"])
    est.set_keyframe(fid, fr["kf"])
    est.optimise()
    est.marginalise()
    return est.gps_status, np.array(est.T_GW, np.float64), est.frames[-1].T_WS[:3].copy()


def test_estimator_gps_alignment_state_machine():
    """The port's version of tests/test_gps.py's estimator case (marked slow
    there), run in lockstep with the JAX estimator at a Tier-1 size: one 5 Hz
    feed with the fixes withheld from 3.4 s to 5.7 s.  The status of every
    frame is the same in both (Off, Idle, Initialised, ReInitialising after
    the 2 s timeout, Initialised again on realignment), and so are T_GW and
    the newest position (LOCK_TGW, LOCK_POS_M); at the end the port's T_GW
    is the true alignment within 0.15 m and 0.1 rad, as in the JAX test."""
    cams, T_SC, T_GW_true, feed = _sim_feed(6.2, 5.0, dropout=(3.4, 5.7))
    ej = JEstimator(EST_CFG, cams, T_SC)
    et = SlidingWindowEstimator(convert.estimator_config(EST_CFG),
                                [convert.camera(c) for c in cams], T_SC, device="cpu")
    lj, lt = {}, {}
    seen = []
    for k, fr in enumerate(feed):
        sj, gj, pj = _step(ej, fr, lj, batch=False)
        st, gt, pt = _step(et, fr, lt, batch=True)
        assert st == sj, (k, st, sj)
        np.testing.assert_allclose(gt, gj, rtol=0, atol=LOCK_TGW, err_msg=f"frame {k}")
        np.testing.assert_allclose(pt, pj, rtol=0, atol=LOCK_POS_M, err_msg=f"frame {k}")
        if not seen or seen[-1] != st:
            seen.append(st)
    assert seen == ["Idle", "Initialised", "ReInitialising", "Initialised"], seen
    assert et.n_gps_solves > 0
    np.testing.assert_allclose(et.T_GW[:3], T_GW_true[:3], atol=0.15)
    dq = se3np.quat_multiply(se3np.quat_conjugate(et.T_GW[3:7]), T_GW_true[3:7])
    assert float(np.linalg.norm(se3np.quat_log(dq))) < 0.1


def jax_app_rehearsal(n_frames, root):
    """The JAX app in slam mode on `chip_smoke.gnss_dataset`'s dataset of
    `n_frames` frames (written by the port's generator, whose files are the
    JAX package's), recorded as the chip phase records the port's app;
    returns `chip_smoke.gnss_metrics`, the status by frame and the wall
    time."""
    ds_dir, cfg, T_SC_true = chip_smoke.gnss_dataset(root, n_frames)
    out = os.path.join(root, "out")
    argv = sys.argv
    sys.argv = ["okvis2x_app.py", "--dataset", ds_dir, "--config", cfg, "--mode", "slam",
                "--reader", "xdataset", "--output", out, "--max-frames", str(n_frames)]
    t0 = time.perf_counter()
    try:
        with chip_smoke.GnssRecorder(JVioPipeline, JEstimator) as rec:
            runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"), run_name="__main__")
    finally:
        sys.argv = argv
    m = chip_smoke.gnss_metrics(rec, ds_dir, out, T_SC_true)
    m["wall_s"] = time.perf_counter() - t0
    m["status_by_frame"] = rec.status
    return m


def count_aten():
    """aten calls (with the nested ones, as torch.profiler lists them on the
    CPU) of one `linearize` of `gnss_window_problem`: without GNSS rows,
    with them, and with the extrinsics prior rows too."""
    jax.config.update("jax_enable_x64", True)
    p, cams = gnss_window_problem(True)
    pt = convert.ba_problem(jax.tree.map(np.asarray, p))
    ct = convert.stacked_cameras(jax.tree.map(np.asarray, cams))
    none = pt._replace(gps_frame=pt.gps_frame[:0],
                       gps_pre=pre.Preintegrated(*[x[:0] for x in pt.gps_pre]),
                       gps_p_G=pt.gps_p_G[:0], gps_sqrt_info=pt.gps_sqrt_info[:0],
                       gps_valid=pt.gps_valid[:0])
    cfg = gn.SolverConfig(imu_params=pre.ImuParams())
    out = {}
    for name, q, c in (("base", none, cfg), ("gnss", pt, cfg),
                       ("gnss+ext", pt, cfg._replace(use_ext_priors=True))):
        gn.linearize(q, ct, c)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            gn.linearize(q, ct, c)
        out[name] = sum(e.name.startswith("aten::") for e in prof.events())
    out["torch"] = torch.__version__
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--count-aten"]:
        print(json.dumps(count_aten()))
    else:
        n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.GNSS_FRAMES
        res = jax_app_rehearsal(n, os.path.join(REPO, "build", "gnss_rehearsal"))
        print(json.dumps(res, default=float))
