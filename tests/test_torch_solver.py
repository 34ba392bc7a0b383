"""Parity of the port's numerics (okvis2x_tpu_torch core, cameras, IMU,
factors, solver and marginalisation) with the JAX package on the same seeded
numpy inputs, in float64.

Tolerances: elementwise maths (SE(3), cameras, factors, preintegration)
agree to 1e-10 absolute; assembled normal equations to 1e-9 relative (sums
over thousands of rows are taken in another order); 10 LM iterations to
1e-7 on poses and cost (the steps go through a matrix inverse).  The
two-pose edge's sqrt information is held to 1e-5 of its largest entry: its
absolute-pose block is a gauge null space, and the pseudo-inverse of that
block amplifies rounding, so the JAX function's own jitted and eager runs
differ by 4e-6 of the largest entry on the test input."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu import testing as jtesting
from okvis2x_tpu.cameras import distortion as jdist
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.factors import imu_factor as jimu
from okvis2x_tpu.factors import priors as jpri
from okvis2x_tpu.factors import reprojection as jrep
from okvis2x_tpu.factors import robust as jrob
from okvis2x_tpu.graph import EstimatorConfig as JEstimatorConfig
from okvis2x_tpu.graph import marginalization as jmarg
from okvis2x_tpu.graph import posegraph as jpg
from okvis2x_tpu.imu import preintegration as jpre
from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig
from okvis2x_tpu.solver import gauss_newton as jgn
from okvis2x_tpu.solver import problem as jprb
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.cameras import distortion, pinhole
from okvis2x_tpu_torch.core import se3
from okvis2x_tpu_torch.factors import imu_factor, priors, reprojection, robust
from okvis2x_tpu_torch.graph import marginalization, posegraph
from okvis2x_tpu_torch.imu import preintegration as pre
from okvis2x_tpu_torch.solver import gauss_newton as gn

# The suite runs in several worker processes; torch's intra-op thread pool
# stalls badly when they oversubscribe the cores, and the port's many small
# ops gain nothing from it.
torch.set_num_threads(1)

F64 = torch.float64
ATOL = 1e-10


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def close(a, b, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b), rtol=rtol, atol=atol)


def random_quats(rng, n):
    q = rng.normal(size=(n, 4))
    q[:, 3] = np.abs(q[:, 3])
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def random_poses(rng, n, scale=2.0):
    return np.concatenate([rng.normal(0, scale, (n, 3)), random_quats(rng, n)], axis=1)


# ---------------------------------------------------------------- core/se3


def test_se3_ops():
    rng = np.random.default_rng(0)
    n = 64
    q1, q2 = random_quats(rng, n), random_quats(rng, n)
    A, B = random_poses(rng, n), random_poses(rng, n)
    v = rng.normal(size=(n, 3))
    d = rng.normal(0, 0.3, (n, 6))
    d[:4] *= 1e-9  # tiny increments take the Taylor branches
    hp = np.concatenate([rng.normal(size=(n, 3)), rng.uniform(0, 1, (n, 1))], axis=1)
    V = jax.vmap
    cases = [
        (se3.quat_multiply(T(q1), T(q2)), V(jse3.quat_multiply)(q1, q2)),
        (se3.quat_rotate(T(q1), T(v)), V(jse3.quat_rotate)(q1, v)),
        (se3.quat_to_matrix(T(q1)), V(jse3.quat_to_matrix)(q1)),
        (se3.delta_q(T(d[:, 3:])), V(jse3.delta_q)(d[:, 3:])),
        (se3.quat_log(T(q1)), V(jse3.quat_log)(q1)),
        (se3.cross_matrix(T(v)), V(jse3.cross_matrix)(v)),
        (se3.se3_multiply(T(A), T(B)), V(jse3.se3_multiply)(A, B)),
        (se3.se3_inverse(T(A)), V(jse3.se3_inverse)(A)),
        (se3.se3_apply(T(A), T(v)), V(jse3.se3_apply)(A, v)),
        (se3.se3_apply_homogeneous(T(A), T(hp)), V(jse3.se3_apply_homogeneous)(A, hp)),
        (se3.retract(T(A), T(d)), V(jse3.retract)(A, d)),
        (se3.local_delta(T(A), T(B)), V(jse3.local_delta)(A, B)),
    ]
    for got, ref in cases:
        close(got, ref)


# ---------------------------------------------------------------- cameras

MODELS = [(jdist.RADTAN, [-0.25, 0.06, 1e-4, -1e-4]),
          (jdist.RADTAN8, [-0.2, 0.05, 1e-4, -1e-4, 0.01, 0.002, -0.001, 1e-4]),
          (jdist.EQUIDISTANT, [0.01, -0.02, 0.003, -0.001]),
          (jdist.NONE, [])]


@pytest.mark.parametrize("model,params", MODELS)
def test_distortion_and_pinhole(model, params):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-0.7, 0.7, (200, 2))
    p = np.asarray(params, np.float64)
    close(distortion.distort(model, T(p), T(xy)), jdist.distort(model, jnp.asarray(p), xy))
    close(distortion.undistort(model, T(p), T(xy)), jdist.undistort(model, jnp.asarray(p), xy))

    jc = jpin.make_pinhole(460.0, 455.0, 376.0, 240.0, 752, 480, model=model, dist_params=params)
    tc = pinhole.make_pinhole(460.0, 455.0, 376.0, 240.0, 752, 480, model=model,
                              dist_params=params)
    pts = np.concatenate([rng.uniform(-3, 3, (200, 2)), rng.uniform(-1, 8, (200, 1))], axis=1)
    hp = np.concatenate([pts, rng.choice([0.0, 0.5, 1.0, -1.0], (200, 1))], axis=1)
    uv = rng.uniform([-20, -20], [770, 500], (200, 2))
    for got, ref in [(pinhole.project(tc, T(pts)), jpin.project(jc, pts)),
                     (pinhole.project_homogeneous(tc, T(hp)), jpin.project_homogeneous(jc, hp)),
                     (pinhole.back_project(tc, T(uv)), jpin.back_project(jc, uv))]:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        close(got[0], ref[0])


def test_eucm_camera():
    rng = np.random.default_rng(2)
    jc = jpin.make_pinhole(350.0, 350.0, 376.0, 240.0, 752, 480, model="eucm",
                           dist_params=[0.6, 1.1])
    tc = pinhole.make_pinhole(350.0, 350.0, 376.0, 240.0, 752, 480, model="eucm",
                              dist_params=[0.6, 1.1])
    pts = np.concatenate([rng.uniform(-3, 3, (200, 2)), rng.uniform(-1, 8, (200, 1))], axis=1)
    uv = rng.uniform([-20, -20], [770, 500], (200, 2))
    for got, ref in [(pinhole.project(tc, T(pts)), jpin.project(jc, pts)),
                     (pinhole.back_project(tc, T(uv)), jpin.back_project(jc, uv))]:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
        close(got[0], ref[0])


# ---------------------------------------------------------------- factors


@pytest.mark.parametrize("loss", [jrob.CAUCHY, jrob.HUBER, jrob.TUKEY, jrob.NONE])
def test_robust_losses(loss):
    s = np.random.default_rng(3).uniform(0, 30, 500)
    for f_t, f_j in [(robust.rho, jrob.rho), (robust.weight, jrob.weight),
                     (robust.rho_prime, jrob.rho_prime)]:
        close(f_t(loss, T(s), 2.0), f_j(loss, jnp.asarray(s), 2.0))


def _obs_inputs(rng, n):
    T_WS = random_poses(rng, n, 0.3)
    T_SC = np.tile([0.055, 0, 0, 0, 0, 0, 1.0], (n, 1))
    hp = np.concatenate([rng.uniform([-2, -2, 3], [2, 2, 8], (n, 3)), np.ones((n, 1))], axis=1)
    hp[::7, 3] = 0.0  # points at infinity
    uv = rng.uniform([0, 0], [752, 480], (n, 2))
    si = rng.uniform(0.5, 2.0, n)
    return T_WS, T_SC, hp, uv, si


def test_reprojection_residual_and_jacobians():
    rng = np.random.default_rng(4)
    args = _obs_inputs(rng, 128)
    params = [-0.25, 0.06, 1e-4, -1e-4]
    jc = jpin.make_pinhole(460.0, 460.0, 376.0, 240.0, 752, 480, dist_params=params)
    tc = pinhole.make_pinhole(460.0, 460.0, 376.0, 240.0, 752, 480, dist_params=params)
    r_t, v_t = reprojection.residual(tc, *map(T, args))
    r_j, v_j = jax.vmap(lambda *a: jrep.residual(jc, *a))(*args)
    close(r_t, r_j)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    lin_t = torch.func.vmap(lambda *a: reprojection.linearize(tc, *a))(*map(T, args))
    lin_j = jax.jit(jax.vmap(lambda *a: jrep.linearize(jc, *a)))(*args)
    for a, b in zip(lin_t[:4], lin_j[:4]):
        close(a, b, atol=1e-8 * max(1.0, float(np.abs(b).max())))
    np.testing.assert_array_equal(lin_t[4].numpy(), np.asarray(lin_j[4]))


def _imu_batch(rng, n_rows, S):
    t = np.sort(rng.uniform(0, 0.2, (n_rows, S)), axis=1)
    gyr = rng.normal(0, 0.5, (n_rows, S, 3))
    acc = rng.normal(0, 1.0, (n_rows, S, 3)) + [0, 0, 9.81]
    mask = np.ones((n_rows, S), bool)
    mask[0, S - 5:] = False  # padded tail
    t0 = t[:, 1] - 0.001
    t1 = t[:, -3] + 0.0005
    bg = rng.normal(0, 0.01, (n_rows, 3))
    ba = rng.normal(0, 0.05, (n_rows, 3))
    return (t, gyr, acc, mask), t0, t1, bg, ba


def _preintegrate_both(rng, n_rows=4, S=40):
    (t, gyr, acc, mask), t0, t1, bg, ba = _imu_batch(rng, n_rows, S)
    pt = pre.preintegrate(pre.ImuParams(), pre.ImuBatch(T(t), T(gyr), T(acc), torch.from_numpy(mask)),
                          T(t0), T(t1), T(bg), T(ba))
    pj = jax.vmap(lambda *a: jpre.preintegrate(
        jpre.ImuParams(), jpre.ImuBatch(*a[:4]), *a[4:]))(t, gyr, acc, mask, t0, t1, bg, ba)
    return pt, pj


def test_preintegrate():
    pt, pj = _preintegrate_both(np.random.default_rng(5))
    for k in jpre.Preintegrated._fields:
        ref = np.asarray(getattr(pj, k))
        close(getattr(pt, k), ref, atol=ATOL * max(1.0, float(np.abs(ref).max())))


def test_init_pose_from_accel():
    rng = np.random.default_rng(11)
    for acc in [rng.normal(0, 3, 3) + [0, 0, 9.8], np.array([0.0, 0.0, 9.81]),
                np.array([0.0, 0.0, -9.81])]:
        gyr = rng.normal(0, 0.01, 3)
        close(pre.init_pose_from_accel(T(acc), T(gyr)),
              jpre.init_pose_from_accel(jnp.asarray(acc), jnp.asarray(gyr)))


def test_imu_factor_and_priors():
    rng = np.random.default_rng(6)
    pt, pj = _preintegrate_both(rng)
    n = pt.dt.shape[0]
    W_t = imu_factor.sqrt_information(pt.P)
    W_j = jax.vmap(jimu.sqrt_information)(pj.P)
    close(W_t, W_j, rtol=1e-9, atol=0)
    T0, T1 = random_poses(rng, n, 0.5), random_poses(rng, n, 0.5)
    sb0, sb1 = rng.normal(0, 0.2, (n, 9)), rng.normal(0, 0.2, (n, 9))
    r_t = imu_factor.residual(pre.ImuParams(), pt, W_t, T(T0), T(sb0), T(T1), T(sb1))
    r_j = jax.vmap(lambda p, w, *a: jimu.residual(jpre.ImuParams(), p, w, *a))(
        pj, W_j, T0, sb0, T1, sb1)
    close(r_t, r_j, rtol=1e-9, atol=1e-8)

    si6 = np.tril(rng.normal(size=(n, 6, 6))) + 3 * np.eye(6)
    si9 = np.tril(rng.normal(size=(n, 9, 9))) + 3 * np.eye(9)
    close(priors.pose_prior_residual(T(T0), T(T1), T(si6)),
          jax.vmap(jpri.pose_prior_residual)(T0, T1, si6))
    close(priors.speed_bias_prior_residual(T(sb0), T(sb1), T(si9)),
          jax.vmap(jpri.speed_bias_prior_residual)(sb0, sb1, si9))
    Trel = random_poses(rng, n, 0.5)
    close(priors.relative_pose_residual(T(Trel), T(T0), T(T1), T(si6)),
          jax.vmap(jpri.relative_pose_residual)(Trel, T0, T1, si6))
    hp0, hp1, si3 = rng.normal(size=(n, 4)), rng.normal(size=(n, 4)), si6[:, :3, :3]
    close(priors.homogeneous_point_prior_residual(T(hp0), T(hp1), T(si3)),
          jax.vmap(jpri.homogeneous_point_prior_residual)(hp0, hp1, si3))
    r_t, Ji_t, Jj_t = gn.rel_residual_jacobians(T(T0), T(T1), T(Trel), T(si6))
    r_j, Ji_j, Jj_j = jax.vmap(jgn.rel_residual_jacobians)(T0, T1, Trel, si6)
    for a, b in [(r_t, r_j), (Ji_t, Ji_j), (Jj_t, Jj_j)]:
        close(a, b)


# ---------------------------------------------------------------- solver


def _np_problem(p):
    """The JAX problem with numpy leaves, as convert.py takes it."""
    return jax.tree.map(np.asarray, p)


def full_window_problem():
    """The JAX package's synthetic window problem (K=4, L=64, N=512, f64)
    with every factor family of the VIO window switched on: IMU links with
    free speed/bias, a relative-pose edge and first-frame priors."""
    p, cams = jtesting.synthetic_window_problem(K=4, L=64, N=512, dtype=jnp.float64, seed=0)
    rng = np.random.default_rng(8)
    K = p.K
    (t, gyr, acc, mask), t0, t1, bg, ba = _imu_batch(rng, K - 1, 40)
    imu_pre = jax.vmap(lambda *a: jpre.preintegrate(
        jpre.ImuParams(), jpre.ImuBatch(*a[:4]), *a[4:]))(t, gyr, acc, mask, t0, t1, bg, ba)
    W = jax.vmap(jimu.sqrt_information)(imu_pre.P)
    si6 = np.diag([50.0, 50, 50, 200, 200, 200])
    p = p._replace(
        sb=jnp.asarray(rng.normal(0, 0.1, (K, 9))),
        sb_fixed=jnp.zeros(K, bool),
        imu_i=jnp.arange(K - 1, dtype=jnp.int32), imu_j=jnp.arange(1, K, dtype=jnp.int32),
        imu_pre=imu_pre, imu_sqrt_info=W, imu_valid=jnp.ones(K - 1, bool),
        rel_i=jnp.array([1], jnp.int32), rel_j=jnp.array([3], jnp.int32),
        rel_T=jnp.asarray(random_poses(rng, 1, 0.2)), rel_sqrt_info=jnp.asarray(si6[None]),
        rel_valid=jnp.array([True]),
        pose_prior_T=p.pose_prior_T.at[0].set(p.T_WS[0]),
        pose_prior_sqrt_info=p.pose_prior_sqrt_info.at[0].set(jnp.eye(6) * 1e3),
        pose_prior_valid=p.pose_prior_valid.at[0].set(True),
        sb_prior_valid=p.sb_prior_valid.at[0].set(True),
    )
    return p, cams


@pytest.fixture(scope="module")
def window():
    p, cams = full_window_problem()
    return p, cams, convert.ba_problem(_np_problem(p)), convert.stacked_cameras(_np_problem(cams))


def test_linearize_and_solve(window):
    p, cams, pt, ct = window
    cfg = gn.SolverConfig(imu_params=pre.ImuParams())
    lt = gn.linearize(pt, ct, cfg)
    lj = jax.jit(lambda p, c: jgn.linearize(p, c, jgn.SolverConfig()))(p, cams)
    for k in ("H_ff", "b_f", "H_ll", "b_l", "W"):
        ref = np.asarray(getattr(lj, k))
        close(getattr(lt, k), ref, rtol=1e-9, atol=1e-9 * float(np.abs(ref).max()))
    np.testing.assert_array_equal(lt.lm_free.numpy(), np.asarray(lj.lm_free))
    close(lt.cost, lj.cost, rtol=1e-10, atol=0)
    close(gn.compute_cost(pt, ct, cfg), jgn.compute_cost(p, cams, jgn.SolverConfig()),
          rtol=1e-10, atol=0)
    dx_t, dl_t = gn.solve_normal_equations(lt, torch.tensor(1e-4, dtype=F64))
    dx_j, dl_j = jax.jit(jgn.solve_normal_equations)(lj, jnp.asarray(1e-4))
    close(dx_t, dx_j, rtol=1e-7, atol=1e-7 * float(np.abs(dx_j).max()))
    close(dl_t, dl_j, rtol=1e-7, atol=1e-7 * float(np.abs(dl_j).max()))


@pytest.mark.parametrize("early_exit_rel", [0.0, 5e-4])
def test_optimize_matches(early_exit_rel):
    p, cams = jtesting.synthetic_window_problem(K=4, L=64, N=512, dtype=jnp.float64, seed=0)
    pt = convert.ba_problem(_np_problem(p))
    ct = convert.stacked_cameras(_np_problem(cams))
    oj, cj = jgn.optimize(p, cams, jgn.SolverConfig(max_iterations=10,
                                                     early_exit_rel=early_exit_rel))
    ot, c_t = gn.optimize(pt, ct, gn.SolverConfig(max_iterations=10,
                                                  early_exit_rel=early_exit_rel))
    close(ot.T_WS, oj.T_WS, atol=1e-7)
    close(ot.hp_W, oj.hp_W, atol=1e-6)
    close(c_t, cj, rtol=1e-7, atol=0)
    assert float(c_t) < float(jgn.compute_cost(p, cams, jgn.SolverConfig()))


def test_optimize_full_window(window):
    p, cams, pt, ct = window
    oj, cj = jgn.optimize(p, cams, jgn.SolverConfig(max_iterations=5))
    ot, c_t = gn.optimize(pt, ct, gn.SolverConfig(max_iterations=5))
    close(ot.T_WS, oj.T_WS, atol=1e-7)
    close(ot.sb, oj.sb, atol=1e-7)
    close(c_t, cj, rtol=1e-7, atol=0)


# ---------------------------------------------------------------- marginalisation


def test_two_pose_edge():
    p, cams = jtesting.synthetic_window_problem(K=4, L=64, N=512, dtype=jnp.float64, seed=1)
    f = np.asarray(p.obs_frame)
    sel = np.nonzero(((f == 1) | (f == 2)) & np.asarray(p.obs_valid))[0]
    args = (p.T_WS[1], p.T_WS[2], p.T_SC, p.hp_W, jnp.ones(p.L, bool),
            jnp.asarray((f[sel] == 2).astype(np.int32)), p.obs_cam[sel], p.obs_lm[sel],
            p.obs_uv[sel], p.obs_sqrt_info[sel], jnp.ones(len(sel), bool))
    # jitted, as the estimator runs it
    Tj, Wj, sj = jax.jit(lambda *a: jmarg.two_pose_edge(cams, *a))(*args)
    ct = convert.stacked_cameras(_np_problem(cams))
    Tt, Wt, st = marginalization.two_pose_edge(ct, *[convert.tensor(np.asarray(a)) for a in args])
    close(Tt, Tj)
    close(Wt, Wj, atol=1e-5 * float(np.abs(Wj).max()))
    close(st, sj, rtol=1e-6, atol=0)
    assert float(st) > 1.0


def test_max_spanning_tree():
    rng = np.random.default_rng(9)
    edges = [(int(a), int(b), float(w)) for a, b, w in
             zip(rng.integers(0, 12, 40), rng.integers(0, 12, 40), rng.integers(3, 60, 40))
             if a != b]
    assert posegraph.max_spanning_tree(edges) == jpg.max_spanning_tree(edges)


# ---------------------------------------------------------------- convert.py


def test_convert_round_trips(window):
    p, cams, pt, ct = window
    back = convert.to_numpy(pt)
    for k in jprb.BAProblem._fields:
        if k in ("icp_a", "icp_b", "icp_p_B", "icp_si", "icp_valid", "icp_map"):
            continue
        ref = jax.tree.leaves(getattr(p, k))
        got = jax.tree.leaves(tuple(getattr(back, k))) if k.endswith("_pre") else [getattr(back, k)]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(convert.to_numpy(ct).fxfycxcy, np.asarray(cams.fxfycxcy))

    jcfg = JEstimatorConfig(num_keyframes=4, cap_landmarks=512, early_exit_rel=5e-4)
    tcfg = convert.estimator_config(jcfg)
    assert tcfg.dtype == torch.float64
    for f in dataclasses.fields(tcfg):
        if f.name not in ("dtype", "imu"):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tuple(tcfg.imu) == tuple(float(x) for x in jcfg.imu)
    pcfg = convert.pipeline_config(JPipelineConfig(max_keypoints=256, do_loop_closures=False,
                                                   pose_refine=False, pipelined_solve=False))
    assert pcfg.max_keypoints == 256 and not pcfg.do_loop_closures
    with pytest.raises(NotImplementedError):
        convert.pipeline_config(JPipelineConfig()).check_ported()
