"""The port's LiDAR and submap-ICP functions against the JAX package: the
sweep deskew (two-state and IMU), both voxel filters, the ICP residuals and
their Jacobians, the alignment, the alignment edge, the per-point ICP rows of
the window solver (linearisation, cost, LM iterations) and their conversion;
and the port's versions of the cases of tests/test_mapping.py (LiDAR and
ICP) and tests/test_icp_solver.py.

Tolerances: the float32 deskew to 1e-6 m (the same float32 arithmetic; XLA
contracts products into fused multiply-adds, a few ulps at these ranges), the
float64 IMU deskew to 1e-9 m, the voxel filters exactly, float64 residuals
and Jacobians to 1e-8 relative to their largest entry, float32 ones to 1e-5,
the alignment edge's information H = sqrt_info^T sqrt_info and strength to
1e-5 relative in float32 (not the eigenvectors: a plane constrains one of the
six dofs, so eigenvalues repeat near zero), the solver's linearisation and
cost to 1e-8 relative and the poses after 5 LM iterations to 1e-8."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.graph import EstimatorConfig as JEstimatorConfig
from okvis2x_tpu.graph import SlidingWindowEstimator as JEstimator
from okvis2x_tpu.imu import preintegration_np as jpre_np
from okvis2x_tpu.imu.preintegration import ImuParams as JImuParams
from okvis2x_tpu.mapping import icp_factor as jicp
from okvis2x_tpu.mapping import lidar as jlidar
from okvis2x_tpu.mapping import submap as jsm
from okvis2x_tpu.solver import gauss_newton as jgn
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.core import se3, se3np
from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator
from okvis2x_tpu_torch.imu import preintegration_np as pre_np
from okvis2x_tpu_torch.imu.preintegration import ImuParams
from okvis2x_tpu_torch.mapping import icp_factor, lidar
from okvis2x_tpu_torch.mapping import submap as sm_mod
from okvis2x_tpu_torch.solver import gauss_newton as gn
import test_icp_solver
from test_icp_solver import CFG_GRID as J_CFG_GRID

torch.set_num_threads(1)

F32 = torch.float32
I7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
CFG = sm_mod.SubmapConfig(dim=64, res=0.2)
# 5 cm grid: the 0.3 m band spans several voxels, so the normalised residual
# is informative on both sides of the surface (tests/test_icp_solver.py)
CFG_FINE = sm_mod.SubmapConfig(dim=96, res=0.05, band_samples=16)


def wall(cfg, n=40, extent=3.0, dtype=F32):
    """Rays from the origin hitting the plane z = 2 m, integrated three
    times (tests/test_mapping.py's wall)."""
    sm = sm_mod.new_submap(I7, cfg, dtype)
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    end = torch.as_tensor(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 2.0)], -1),
                          dtype=dtype)
    for _ in range(3):
        sm = sm_mod.integrate_rays(sm, cfg, torch.zeros(3, dtype=dtype), end,
                                   torch.ones(len(end), dtype=torch.bool), 0.05)
    return sm


def jax_of(sm):
    return jsm.Submap(*[jnp.asarray(x.numpy()) for x in sm])


def jcfg(cfg):
    return jsm.SubmapConfig(**cfg._asdict())


def surface_points(rng, n, z=1.95, extent=2.0):
    return np.stack([rng.uniform(-extent, extent, n), rng.uniform(-extent, extent, n),
                     np.full(n, z)], -1)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ----------------------------------------------------------------- deskew


def test_se3_interpolate_matches_jax():
    rng = np.random.default_rng(0)
    Ta = se3np.normalize(np.r_[rng.normal(0, 1, 3), rng.normal(0, 1, 4)])
    Tb = se3np.normalize(np.r_[rng.normal(0, 1, 3), rng.normal(0, 1, 4)])
    for a in (0.0, 0.3, 1.0):
        got = se3.se3_interpolate(torch.tensor(Ta), torch.tensor(Tb), a).numpy()
        want = np.asarray(jse3.se3_interpolate(jnp.asarray(Ta), jnp.asarray(Tb), a))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_deskew_matches_jax():
    """A sweep of 300 rays between two poses 5 cm and 0.1 rad apart."""
    rng = np.random.default_rng(1)
    T0 = np.array([0.3, 0.1, -0.2, 0, 0, 0.05, 0.99875], np.float32)
    T1 = se3np.retract(T0.astype(np.float64), np.array([0.03, -0.04, 0.0, 0.0, 0.02, 0.1]))
    T1 = T1.astype(np.float32)
    frac = np.linspace(0, 1, 300, dtype=np.float32)
    pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    got = lidar.deskew(*(torch.from_numpy(x) for x in (T0, T1, frac, pts))).numpy()
    want = np.asarray(jax.jit(jlidar.deskew)(*(jnp.asarray(x) for x in (T0, T1, frac, pts))))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_deskew_imu_matches_jax():
    """Per-ray IMU deskew under a ramping yaw rate and noisy accelerations,
    from a moving state with biases, into the frame of a later time."""
    rng = np.random.default_rng(2)
    n = 61
    t = np.linspace(0.0, 0.3, n)
    gyr = np.stack([rng.normal(0, 0.1, n), rng.normal(0, 0.1, n), 10.0 * t], -1)
    acc = rng.normal(0, 1.0, (n, 3)) + np.array([0, 0, 9.81007])

    class FA:
        timestamp = 0.01
        T_WS = np.array([0.2, -0.1, 0.5, 0, 0, 0.1, 0.99498744])
        sb = np.r_[0.5, -0.2, 0.1, 0.01, -0.02, 0.005, 0.05, 0.02, -0.03]

    t_point = np.sort(rng.uniform(0.05, 0.25, 200))
    pts = rng.uniform(-8, 8, (200, 3))
    got, T_end = lidar.deskew_imu(ImuParams(), t, gyr, acc, FA, t_point, pts, t_end=0.27)
    want, T_end_j = jlidar.deskew_imu(JImuParams(), t, gyr, acc, FA, t_point, pts, t_end=0.27)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(T_end, T_end_j, rtol=0, atol=1e-12)


@pytest.mark.parametrize("where", ["host", "device"])
def test_voxel_filters_match_jax(where):
    """Both filters keep the same points: first-come per voxel on the host
    (two per voxel as well), the hash-slot election (including negative
    keys, whose hash wraps and takes Python's remainder) on the device."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-3.0, 3.0, (2000, 3))
    if where == "host":
        for k in (1, 2):
            np.testing.assert_array_equal(lidar.voxel_downsample(pts, 0.3, k),
                                          jlidar.voxel_downsample(pts, 0.3, k))
        return
    pts32 = pts.astype(np.float32)
    valid = rng.uniform(size=len(pts)) < 0.9
    for table in (1 << 14, 257):
        _, keep = lidar.voxel_downsample_device(torch.from_numpy(pts32), torch.from_numpy(valid),
                                                0.25, table)
        _, keep_j = jlidar.voxel_downsample_device(jnp.asarray(pts32), jnp.asarray(valid), 0.25,
                                                   table)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(keep_j))
        assert 10 < int(keep.sum()) < int(valid.sum())


# -- the port's versions of tests/test_mapping.py's LiDAR cases


def test_deskew_identity_when_static():
    rng = np.random.default_rng(9)
    T = torch.tensor([0.3, 0.1, -0.2, 0, 0, 0.1, 0.995], dtype=F32)
    pts = torch.as_tensor(rng.uniform(-5, 5, (20, 3)), dtype=F32)
    out = lidar.deskew(T, T, torch.linspace(0, 1, 20), pts)
    np.testing.assert_allclose(out.numpy(), pts.numpy(), atol=1e-4)


def test_predict_states_batch_matches_restarts():
    """One incremental pass equals independent `predict_state` restarts."""
    params = ImuParams()
    rng = np.random.default_rng(7)
    n = 81
    t = np.linspace(0.0, 0.4, n)
    gyr = rng.normal(0, 0.6, (n, 3))
    acc = rng.normal(0, 2.0, (n, 3)) + np.array([0, 0, params.g])
    T0 = np.array([0.2, -0.1, 0.5, 0, 0, 0, 1.0])
    v0, bg, ba = np.array([0.5, -0.2, 0.1]), np.array([0.01, -0.02, 0.005]), np.array(
        [0.05, 0.02, -0.03])
    tq = np.sort(rng.uniform(0.02, 0.38, 25))
    batch = pre_np.predict_states_batch(params, t, gyr, acc, 0.0, tq, T0, v0, bg, ba)
    np.testing.assert_array_equal(
        batch, jpre_np.predict_states_batch(JImuParams(), t, gyr, acc, 0.0, tq, T0, v0, bg, ba))
    for i, t1 in enumerate(tq):
        T_ref, _ = pre_np.predict_state(params, t, gyr, acc, 0.0, float(t1), T0, v0, bg, ba)
        np.testing.assert_allclose(batch[i, :3], T_ref[:3], atol=2e-3)
        assert abs(np.dot(batch[i, 3:7], T_ref[3:7])) > 1 - 1e-5


def test_deskew_imu_beats_interpolation_under_angular_accel():
    """Under a ramping yaw rate the per-ray IMU deskew recovers the static
    world points; the two-state interpolation leaves centimetres."""
    params = ImuParams()
    n, dt_total = 41, 0.2
    t = np.linspace(0.0, dt_total, n)
    gyr = np.stack([np.zeros(n), np.zeros(n), 20.0 * t], -1)
    acc = np.tile(np.array([0, 0, params.g]), (n, 1))
    T0 = np.array([0, 0, 0, 0, 0, 0, 1.0])

    class FA:
        timestamp = 0.0
        T_WS = T0
        sb = np.zeros(9)

    world_pts = np.array([[5.0, 1.0, 0.5], [2.0, -3.0, 1.0], [4.0, 4.0, -1.0]])
    t_point = np.repeat(np.linspace(0.0, dt_total, 10), 3)
    pts_raw = np.zeros((len(t_point), 3))
    for i, tp in enumerate(t_point):
        T_i, _ = pre_np.predict_state(params, t, gyr, acc, 0.0, float(tp), T0, np.zeros(3),
                                      np.zeros(3), np.zeros(3))
        pts_raw[i] = se3np.quat_to_matrix(T_i[3:7]).T @ (world_pts[i % 3] - T_i[:3])
    out, T_end = lidar.deskew_imu(params, t, gyr, acc, FA, t_point, pts_raw)
    rebuilt = out @ se3np.quat_to_matrix(T_end[3:7]).T + T_end[:3]
    truth = world_pts[np.arange(len(t_point)) % 3]
    err_imu = np.linalg.norm(rebuilt - truth, axis=1)
    assert err_imu.max() < 5e-3
    T1, _ = pre_np.predict_state(params, t, gyr, acc, 0.0, dt_total, T0, np.zeros(3),
                                 np.zeros(3), np.zeros(3))
    interp = lidar.deskew(torch.as_tensor(T0, dtype=F32), torch.as_tensor(T1, dtype=F32),
                          torch.as_tensor(t_point / dt_total, dtype=F32),
                          torch.as_tensor(pts_raw, dtype=F32)).numpy()
    rebuilt_i = interp @ se3np.quat_to_matrix(T1[3:7]).T + T1[:3]
    assert np.linalg.norm(rebuilt_i - truth, axis=1).max() > 5 * err_imu.max()


def test_voxel_downsample():
    pts = np.random.default_rng(9).uniform(0, 1.0, (500, 3))
    out = lidar.voxel_downsample(pts, voxel=0.25, max_per_voxel=1)
    assert len(out) <= 4 * 4 * 4
    assert len(np.unique(np.floor(out / 0.25).astype(int), axis=0)) == len(out)


def test_voxel_downsample_device():
    pts = torch.as_tensor(np.random.default_rng(9).uniform(0, 1.0, (512, 3)), dtype=F32)
    _, keep = lidar.voxel_downsample_device(pts, torch.ones(512, dtype=torch.bool), 0.25)
    kept = pts.numpy()[keep.numpy()]
    assert len(np.unique(np.floor(kept / 0.25).astype(int), axis=0)) == len(kept) > 10


# -------------------------------------------------------------------- ICP


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_icp_linearize_matches_jax(dtype):
    """Residuals, use masks and both Jacobians of 300 points around the
    wall (some outside the grid, some on the flat free space where the
    gradient is uninformative), against JAX at the same precision; the
    grid stays float32, so the float64 poses mix precisions as the window
    solve does."""
    rng = np.random.default_rng(4)
    sm = wall(CFG)
    pts = np.concatenate([surface_points(rng, 200, extent=2.5), rng.uniform(-8, 8, (100, 3))])
    valid = rng.uniform(size=300) < 0.95
    T_WA = np.array([0.05, 0.0, -0.02, 0, 0, 0.02, 0.9998])
    T_WB = np.array([0.1, -0.05, 0.02, 0.01, 0, 0, 0.99995])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    args_t = [torch.as_tensor(x, dtype=dtype) for x in (T_WA, T_WB, pts)]
    args_j = [jnp.asarray(x, jdt) for x in (T_WA, T_WB, pts)]
    got = icp_factor.linearize_icp(sm, CFG, *args_t, torch.from_numpy(valid))
    want = jax.jit(lambda *a: jicp.linearize_icp(jax_of(sm), jcfg(CFG), *a))(
        *args_j, jnp.asarray(valid))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert 100 < int(got[3].sum()) < 250
    tol = 1e-5 if dtype == torch.float32 else 1e-8
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == dtype and np.asarray(w).dtype == np.dtype(jdt)
        assert rel_err(g.numpy(), w) <= tol
    r, use = icp_factor.icp_residuals(sm, CFG, *args_t, torch.from_numpy(valid))
    np.testing.assert_array_equal(r.numpy(), got[0].numpy())
    np.testing.assert_array_equal(use.numpy(), got[3].numpy())


def test_icp_align_and_edge_match_jax():
    """The alignment of a pose 15 cm off in z on the 5 cm wall, and the
    alignment edge of the same points (float32, as the submapper calls
    it), against JAX."""
    rng = np.random.default_rng(5)
    sm = wall(CFG_FINE, n=72, extent=1.8)
    pts = surface_points(rng, 200, z=1.85, extent=1.5).astype(np.float32)
    valid = np.ones(200, bool)
    valid[-20:] = False
    T_WA = np.array(I7, np.float32)
    T_WB = np.array([0.02, -0.01, 0.0, 0, 0, 0, 1.0], np.float32)
    args_t = [torch.from_numpy(x) for x in (T_WA, T_WB, pts, valid)]
    args_j = [jnp.asarray(x) for x in (T_WA, T_WB, pts, valid)]
    T, cost = icp_factor.icp_align(sm, CFG_FINE, *args_t, iterations=10)
    Tj, cost_j = jax.jit(lambda *a: jicp.icp_align(jax_of(sm), jcfg(CFG_FINE), *a,
                                                    iterations=10))(*args_j)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0, atol=2e-5)
    assert abs(float(T[2]) - 0.15) < 0.05
    assert abs(float(cost) - float(cost_j)) <= 1e-4 * float(cost_j)
    for cfg, smx in ((CFG_FINE, sm), (CFG, wall(CFG))):
        T_AB, si, strength = icp_factor.make_alignment_edge(smx, cfg, *args_t)
        T_ABj, sij, strength_j = jax.jit(
            lambda *a, c=cfg, s=smx: jicp.make_alignment_edge(jax_of(s), jcfg(c), *a))(*args_j)
        np.testing.assert_allclose(T_AB.numpy(), np.asarray(T_ABj), rtol=0, atol=1e-7)
        H = si.double().T @ si.double()
        Hj = np.asarray(sij, np.float64).T @ np.asarray(sij, np.float64)
        assert rel_err(H.numpy(), Hj) <= 1e-5
        assert abs(float(strength) - float(strength_j)) <= 1e-5 * float(strength_j)
        assert float(strength) > 1.0  # clear of the submapper's gate


# -- the port's versions of tests/test_mapping.py's ICP cases


def test_icp_jacobian_finite_diff():
    rng = np.random.default_rng(9)
    sm = wall(CFG)
    T_WA = torch.tensor(I7, dtype=F32)
    T_WB = torch.tensor([0.1, -0.05, 0.02, 0, 0, 0, 1.0], dtype=F32)
    pts = torch.as_tensor(surface_points(rng, 50), dtype=F32)
    valid = torch.ones(50, dtype=torch.bool)
    r, Ja, Jb, use = icp_factor.linearize_icp(sm, CFG, T_WA, T_WB, pts, valid)
    assert int(use.sum()) > 30
    eps = 1e-3
    for i in range(6):
        d = torch.zeros(6, dtype=F32)
        d[i] = eps
        rp, _ = icp_factor.icp_residuals(sm, CFG, T_WA, se3.retract(T_WB, d), pts, valid)
        rm, _ = icp_factor.icp_residuals(sm, CFG, T_WA, se3.retract(T_WB, -d), pts, valid)
        num = ((rp - rm) / (2 * eps)).numpy()
        sel = use.numpy()
        np.testing.assert_allclose(Jb.numpy()[sel, i], num[sel], atol=0.1, rtol=0.15)


def test_icp_align_recovers_offset():
    rng = np.random.default_rng(9)
    sm = wall(CFG_FINE, n=72, extent=1.8)
    dz_true = 0.15
    pts = torch.as_tensor(surface_points(rng, 200, z=2.0 - dz_true, extent=1.5), dtype=F32)
    T, _ = icp_factor.icp_align(sm, CFG_FINE, torch.tensor(I7, dtype=F32),
                                torch.tensor(I7, dtype=F32), pts,
                                torch.ones(200, dtype=torch.bool), iterations=10)
    assert abs(float(T[2]) - dz_true) < 0.05, T


def test_alignment_edge_informative():
    rng = np.random.default_rng(9)
    sm = wall(CFG)
    pts = torch.as_tensor(surface_points(rng, 150, z=2.0), dtype=F32)
    _, sqrt_info, strength = icp_factor.make_alignment_edge(
        sm, CFG, torch.tensor(I7, dtype=F32), torch.tensor(I7, dtype=F32), pts,
        torch.ones(150, dtype=torch.bool))
    H = sqrt_info.double().T @ sqrt_info.double()
    # the wall constrains z strongly, x and y weakly
    assert H[2, 2] > 100 * max(float(H[0, 0]), float(H[1, 1]), 1e-9)
    assert float(strength) > 10.0


# ------------------------------------------------------ the window solver


_j_wall = functools.lru_cache(test_icp_solver.make_wall)


def port_problem(dz, Q):
    """tests/test_icp_solver.py's problem (two frames, the wall as the
    float64 grid of frame 0's submap, Q points of frame 1 offset by dz) in
    both packages; the wall is integrated once."""
    with mock.patch.object(test_icp_solver, "make_wall", _j_wall):
        pj, cj = test_icp_solver.make_problem(dz=dz, Q=Q)
    pt = convert.ba_problem(jax.tree.map(np.asarray, pj))
    ct = convert.stacked_cameras(jax.tree.map(np.asarray, cj))
    return pj, cj, pt, ct


def test_ba_problem_carries_icp_rows():
    pj, _, pt, _ = port_problem(-0.1, 16)
    assert pt.icp_map.logodds.dtype == torch.float64
    for k in ("icp_a", "icp_b", "icp_p_B", "icp_si", "icp_valid"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)))
    for a, b in zip(pt.icp_map, pj.icp_map):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert convert.ba_problem(jax.tree.map(np.asarray, pj._replace(
        icp_a=None, icp_b=None, icp_p_B=None, icp_si=None, icp_valid=None,
        icp_map=None))).icp_map is None


def test_icp_solver_matches_jax():
    """`linearize` (H, b, cost) and `compute_cost` with the ICP rows, the
    rows themselves, and 5 LM iterations, against JAX on
    tests/test_icp_solver.py's problem."""
    pj, cj, pt, ct = port_problem(-0.06, 64)
    cfg_j = jgn.SolverConfig(icp_cfg=J_CFG_GRID, estimate_landmarks=False, max_iterations=5)
    cfg_t = gn.SolverConfig(icp_cfg=convert.submap_config(J_CFG_GRID), estimate_landmarks=False,
                            max_iterations=5)
    r, blocks, use = gn._linearize_icp(pt, cfg_t)
    rj, Jrow_j, use_j = jax.jit(lambda p: jgn._linearize_icp(p, cfg_j))(pj)
    np.testing.assert_array_equal(use.numpy(), np.asarray(use_j))
    assert int(use.sum()) > 40
    assert rel_err(r.numpy(), rj) <= 1e-8
    (Ja, ca), (Jb, cb) = blocks
    Jrow = np.zeros(np.asarray(Jrow_j).shape)
    for J, c0 in ((Ja, ca), (Jb, cb)):
        for q in range(J.shape[0]):
            Jrow[q, :, int(c0[q]):int(c0[q]) + 15] += J[q].numpy()
    assert rel_err(Jrow, Jrow_j) <= 1e-8
    lin = gn.linearize(pt, ct, cfg_t)
    lin_j = jax.jit(lambda p, c: jgn.linearize(p, c, cfg_j))(pj, cj)
    assert rel_err(lin.H_ff.numpy(), lin_j.H_ff) <= 1e-8
    assert rel_err(lin.b_f.numpy(), lin_j.b_f) <= 1e-8
    assert abs(float(lin.cost) - float(lin_j.cost)) <= 1e-8 * float(lin_j.cost)
    cost = float(gn.compute_cost(pt, ct, cfg_t))
    cost_j = float(jax.jit(lambda p, c: jgn.compute_cost(p, c, cfg_j))(pj, cj))
    assert abs(cost - cost_j) <= 1e-8 * cost
    assert abs(cost - float(lin.cost)) <= 1e-10 * cost
    p_opt, c_opt = gn.optimize(pt, ct, cfg_t)
    pj_opt, cj_opt = jax.jit(lambda p, c: jgn.optimize(p, c, cfg_j))(pj, cj)
    np.testing.assert_allclose(p_opt.T_WS.numpy(), np.asarray(pj_opt.T_WS), rtol=0, atol=1e-8)
    assert abs(float(c_opt) - float(cj_opt)) <= 1e-8 * max(float(cj_opt), 1e-12)
    assert abs(float(p_opt.T_WS[1, 2])) < abs(float(pt.T_WS[1, 2]))


# -- the port's versions of tests/test_icp_solver.py


def test_icp_jacobian_matches_fd():
    _, _, p, _ = port_problem(-0.05, 8)
    cfg = gn.SolverConfig(icp_cfg=convert.submap_config(J_CFG_GRID), estimate_landmarks=False)
    r, blocks, use = gn._linearize_icp(p, cfg)
    assert int(use.sum()) > 4
    eps = 1e-6
    for ax in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[ax] = eps
        rs = []
        for s in (1, -1):
            T = p.T_WS.clone()
            T[1] = se3.retract(p.T_WS[1], s * d)
            rs.append(gn._linearize_icp(p._replace(T_WS=T), cfg)[0])
        num = ((rs[0] - rs[1])[:, 0] / (2 * eps)).numpy()
        Jb, c0 = blocks[1]
        assert (c0 == 15).all()
        m = use.numpy()
        np.testing.assert_allclose(Jb[:, 0, ax].numpy()[m], num[m], rtol=1e-3, atol=1e-4)


def test_icp_rows_pull_pose_to_surface():
    _, _, p, cams = port_problem(-0.10, 64)
    cfg = gn.SolverConfig(max_iterations=8, icp_cfg=convert.submap_config(J_CFG_GRID),
                          estimate_landmarks=False)
    p_opt, cost = gn.optimize(p, cams, cfg)
    assert abs(float(p_opt.T_WS[1, 2])) < 0.05, (float(p_opt.T_WS[1, 2]), float(cost))
    assert float(p_opt.T_WS[0, :3].abs().max()) < 1e-6


def test_icp_rows_beat_frozen_edge():
    """Per-point rows pull the drifted pose onto the surface; the same
    points compressed into a relative-pose edge at the drifted state freeze
    the drift."""
    _, _, p, cams = port_problem(-0.10, 64)
    grid = convert.submap_config(J_CFG_GRID)
    p_live, _ = gn.optimize(p, cams, gn.SolverConfig(max_iterations=8, icp_cfg=grid,
                                                     estimate_landmarks=False))
    err_live = abs(float(p_live.T_WS[1, 2]))
    T_AB, sqrt_info, _ = icp_factor.make_alignment_edge(
        p.icp_map, grid, p.T_WS[0], p.T_WS[1], p.icp_p_B,
        torch.ones(p.icp_p_B.shape[0], dtype=torch.bool), sigma=0.1)
    p_edge = p._replace(icp_valid=torch.zeros_like(p.icp_valid),
                        rel_i=torch.zeros(1, dtype=torch.int64),
                        rel_j=torch.ones(1, dtype=torch.int64), rel_T=T_AB[None],
                        rel_sqrt_info=sqrt_info[None], rel_valid=torch.ones(1, dtype=torch.bool))
    p_cmp, _ = gn.optimize(p_edge, cams, gn.SolverConfig(max_iterations=8,
                                                         estimate_landmarks=False))
    err_edge = abs(float(p_cmp.T_WS[1, 2]))
    assert err_live < 0.03, err_live
    assert err_edge > 0.05, err_edge
    assert err_live < 0.5 * err_edge, (err_live, err_edge)


def test_estimator_state_carries_live_icp():
    """A JAX estimator's live ICP points, their submap and grid config reach
    the port's, and its window problem then carries the same rows."""
    jcfg_est = JEstimatorConfig(cap_frames=4, cap_landmarks=8, cap_obs=16, cap_imu_links=3,
                                cap_rel_edges=4, cap_icp=32)
    from okvis2x_tpu.cameras import pinhole as jpin
    from okvis2x_tpu.graph import FrameState as JFrameState

    jcam = jpin.make_pinhole(100.0, 100.0, 64.0, 48.0, 128, 96, model="none", dtype=jnp.float64)
    je = JEstimator(jcfg_est, [jcam], np.array([I7]))
    for k in range(2):
        je.frames.append(JFrameState(fid=k, timestamp=0.1 * k, T_WS=np.r_[0.02 * k, 0, 0, I7[3:]],
                                     sb=np.zeros(9), is_keyframe=True))
    sm = wall(CFG)
    je.set_icp_map(jax_of(sm), jcfg(CFG))
    je.set_live_icp_points(0, 1, surface_points(np.random.default_rng(6), 20), 0.4)
    te = SlidingWindowEstimator(convert.estimator_config(jcfg_est), [convert.camera(jcam)],
                                np.array([I7]), device="cpu")
    convert.estimator_state(je, te)
    assert te.icp_grid_cfg == CFG and te.icp_live[:2] == (0, 1) and te.icp_live[3] == 0.4
    for a, b in zip(te.icp_map, sm):
        assert torch.equal(a, b)
    pt = te._build_problem()[0]
    pj = je._build_problem()[0]
    for k in ("icp_a", "icp_b", "icp_p_B", "icp_si", "icp_valid"):
        np.testing.assert_array_equal(getattr(pt, k).numpy(), np.asarray(getattr(pj, k)))
