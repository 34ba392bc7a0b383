"""The port's RGB-D path against the JAX package: the depth factor, the
solver's depth rows, the depth-map helpers, the estimator state with live
and archived depth priors, and both `VioPipeline`s in lockstep on frames
with a cam0 depth stream.

Tolerances: the factor's residuals and Jacobians agree to 1e-10 absolute
(float64 elementwise); the normal equations with depth rows to 1e-9
relative (sums in another order), as tests/test_torch_solver.py holds them;
the depth-map helpers exactly where they select pixels (z-buffer winners,
masks) and to 1e-6 m where they compute float32 depths; the lockstep run's
depth-prior and landmark counts exactly and its positions to 1e-6 m."""

import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # run as a script, too

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from okvis2x_tpu import testing as jtesting  # noqa: E402
from okvis2x_tpu.cameras import pinhole as jpin  # noqa: E402
from okvis2x_tpu.core import se3 as jse3  # noqa: E402
from okvis2x_tpu.factors import depth as jdepth  # noqa: E402
from okvis2x_tpu.graph import EstimatorConfig  # noqa: E402
from okvis2x_tpu.io import synthetic as jsyn  # noqa: E402
from okvis2x_tpu.io import xdataset as jxd  # noqa: E402
from okvis2x_tpu.pipeline import depth_utils as jdu  # noqa: E402
from okvis2x_tpu.pipeline.vio import PipelineConfig  # noqa: E402
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline  # noqa: E402
from okvis2x_tpu.solver import gauss_newton as jgn  # noqa: E402
from okvis2x_tpu_torch import convert  # noqa: E402
from okvis2x_tpu_torch.cameras import pinhole  # noqa: E402
from okvis2x_tpu_torch.core import se3  # noqa: E402
from okvis2x_tpu_torch.factors import depth  # noqa: E402
from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator  # noqa: E402
from okvis2x_tpu_torch.pipeline import depth_utils as du  # noqa: E402
from okvis2x_tpu_torch.pipeline.vio import VioPipeline  # noqa: E402
from okvis2x_tpu_torch.solver import gauss_newton as gn  # noqa: E402
from okvis2x_tpu_torch.solver import problem as prb  # noqa: E402

torch.set_num_threads(1)

F64 = torch.float64
ATOL = 1e-10
LOCKSTEP_FRAMES = 6
LOCKSTEP_TOL_M = 1e-6


def T(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def close(a, b, rtol=0.0, atol=ATOL):
    np.testing.assert_allclose(convert.to_numpy(a), np.asarray(b), rtol=rtol, atol=atol)


def random_poses(rng, n, scale=1.0):
    w = rng.standard_normal((n, 3)) * 0.3
    t = rng.standard_normal((n, 3)) * scale
    return np.stack([np.asarray(jse3.retract(jse3.se3_identity(jnp.float64),
                                             jnp.asarray(np.r_[ti, wi]))) for ti, wi in zip(t, w)])


def depth_rows(rng, n=24):
    """Poses, extrinsics and points with measured depths around the
    predicted ones (so both gates fire), two points at infinity."""
    T_WS, T_SC = random_poses(rng, n), random_poses(rng, n, 0.1)
    hp = np.concatenate([rng.standard_normal((n, 3)) * 2 + [0, 0, 6], np.ones((n, 1))], 1)
    hp[:2, 3] = 0.0
    z, w = jax.vmap(jdepth.predicted_depth)(jnp.asarray(T_WS), jnp.asarray(T_SC), jnp.asarray(hp))
    z, w = np.asarray(z), np.asarray(w)
    pz = np.divide(z, w, out=z.copy(), where=np.abs(w) >= 1e-16)
    d = pz + rng.normal(0, 0.3, n)
    si = rng.uniform(1.0, 10.0, n)
    return T_WS, T_SC, hp, d, si


@pytest.mark.parametrize("onesided", [True, False])
def test_factor_matches_jax(onesided):
    """`predicted_depth`, `residual` and `linearize` on rows of both gates and
    at infinity; ignored rows have exactly zero Jacobians."""
    T_WS, T_SC, hp, d, si = depth_rows(np.random.default_rng(3))
    jargs = [jnp.asarray(x) for x in (T_WS, T_SC, hp, d, si)]
    targs = [T(x) for x in (T_WS, T_SC, hp, d, si)]
    zj, wj = jax.vmap(jdepth.predicted_depth)(*jargs[:3])
    zt, wt = depth.predicted_depth(*targs[:3])
    close(zt, zj)
    close(wt, wj)
    rj = jax.vmap(lambda *a: jdepth.residual(*a, onesided))(*jargs)
    close(depth.residual(*targs, onesided), rj)
    lj = jax.vmap(lambda *a: jdepth.linearize(*a, onesided))(*jargs)
    lt = torch.func.vmap(lambda *a: depth.linearize(*a, onesided))(*targs)
    for a, b in zip(lt, lj):
        close(a, b)
    ignored = np.asarray(rj) == 0
    assert ignored[:2].all() and (ignored.sum() > 2) == onesided
    assert (lt[1][torch.from_numpy(ignored)] == 0).all()


def test_depth_jacobians_match_finite_differences():
    """The port's case of tests/test_depth_factor.py: the minimal Jacobians
    against forward differences of the residual through the retraction."""
    rng = np.random.default_rng(0)
    T_WS, T_SC = (T(x) for x in random_poses(rng, 2))
    hp_W = T(np.r_[rng.standard_normal(3) * 2 + [0, 0, 5], 1.0])
    z, w = depth.predicted_depth(T_WS, T_SC, hp_W)
    d_meas = float(z / w) + 0.2  # one-sided: predicted < measured, active
    si = 10.0
    r, Jp, Jl, Je = depth.linearize(T_WS, T_SC, hp_W, T(d_meas), T(si), True)
    assert abs(float(r) - si * (d_meas - float(z / w))) < 1e-9
    eps = 1e-7
    for k, (J, dim) in enumerate(((Jp, 6), (Jl, 3), (Je, 6))):
        for i in range(dim):
            dlt = torch.zeros(dim, dtype=F64)
            dlt[i] = eps
            args = [T_WS, T_SC, hp_W]
            if k == 0:
                args[0] = se3.retract(T_WS, dlt)
            elif k == 1:
                args[2] = torch.cat([hp_W[:3] + dlt, hp_W[3:]])
            else:
                args[1] = se3.retract(T_SC, dlt)
            num = (float(depth.residual(*args, T(d_meas), T(si), True)) - float(r)) / eps
            assert abs(num - float(J[i])) < 1e-4, (k, i, num, float(J[i]))


def test_depth_onesided_gating():
    """The port's case of tests/test_depth_factor.py: a predicted depth
    beyond the measurement is ignored one-sided and active two-sided; points
    at infinity are ignored in both."""
    I = se3.se3_identity()
    hp = T([0.0, 0.0, 5.0, 1.0])
    assert float(depth.residual(I, I, hp, T(3.0), T(1.0), True)) == 0.0
    assert abs(float(depth.residual(I, I, hp, T(3.0), T(1.0), False)) + 2.0) < 1e-12
    rj, Jp, Jl, Je = depth.linearize(I, I, hp, T(3.0), T(1.0), True)
    assert float(rj) == 0.0 and float(Jl.abs().sum()) == 0.0
    hpinf = T([0.0, 0.0, 1.0, 0.0])
    assert float(depth.residual(I, I, hpinf, T(3.0), T(1.0), False)) == 0.0


def test_depth_priors_pull_landmarks_in_solver():
    """The port's case of tests/test_depth_factor.py: landmarks seen from one
    fixed pose converge to their two-sided depth measurements along their
    rays."""
    cam = pinhole.make_pinhole(200.0, 200.0, 160.0, 120.0, 320, 240)
    cams = gn.stack_cameras([cam])
    p = prb.empty_problem(K=2, L=4, C=1, N=8, M=1)
    true_depths = np.array([4.0, 5.0, 6.0, 7.0])
    uv0 = np.array([[160.0, 120.0], [180.0, 100.0], [140.0, 130.0], [200.0, 90.0]])
    ray, _ = pinhole.back_project(cam, T(uv0))
    hp = torch.cat([ray * T(true_depths)[:, None], torch.ones(4, 1, dtype=F64)], 1)
    hp_init = hp.clone()
    hp_init[:, 2] *= 1.3
    p = p._replace(
        frame_valid=torch.tensor([True, False]), pose_fixed=torch.tensor([True, True]),
        sb_fixed=torch.tensor([True, True]), hp_W=hp_init, lm_valid=torch.ones(4, dtype=bool),
        obs_frame=torch.zeros(8, dtype=torch.int64), obs_cam=torch.zeros(8, dtype=torch.int64),
        obs_lm=torch.as_tensor(np.r_[np.arange(4), np.zeros(4)], dtype=torch.int64),
        obs_uv=T(np.r_[uv0, np.zeros((4, 2))]),
        obs_valid=torch.as_tensor(np.r_[np.ones(4), np.zeros(4)] > 0),
        obs_depth=T(np.r_[true_depths, np.ones(4)]),
        obs_depth_si=torch.full((8,), 100.0, dtype=F64),
        obs_depth_valid=torch.as_tensor(np.r_[np.ones(4), np.zeros(4)] > 0),
    )
    cfg = gn.SolverConfig(max_iterations=10, use_depth=True, depth_onesided=False)
    out, _ = gn.optimize(p, cams, cfg)
    np.testing.assert_allclose((out.hp_W[:, 2] / out.hp_W[:, 3]).numpy(), true_depths, atol=1e-3)


def depth_window_problem():
    """The JAX package's synthetic window problem (K=4, L=64, N=512, f64)
    with depth priors on two thirds of the observations: measured depths
    around the predicted ones, so that the one-sided gate drops some."""
    p, cams = jtesting.synthetic_window_problem(K=4, L=64, N=512, dtype=jnp.float64, seed=0)
    rng = np.random.default_rng(5)
    z, w = jax.vmap(lambda f, c, l: jdepth.predicted_depth(p.T_WS[f], p.T_SC[c], p.hp_W[l]))(
        p.obs_frame, p.obs_cam, p.obs_lm)
    d = np.asarray(z / w) + rng.normal(0, 0.05, 512)
    p = p._replace(obs_depth=jnp.asarray(d), obs_depth_si=jnp.asarray(rng.uniform(5, 50, 512)),
                   obs_depth_valid=jnp.asarray(rng.uniform(size=512) < 0.67))
    return p, cams


@pytest.mark.parametrize("onesided", [True, False])
def test_linearize_with_depth_rows_matches_jax(onesided):
    """H, b, the landmark blocks and the cost with depth rows, the cost
    without Jacobians, and a 5-iteration solve against the JAX solver."""
    p, cams = depth_window_problem()
    npp = jax.tree.map(np.asarray, p)
    pt, ct = convert.ba_problem(npp), convert.stacked_cameras(jax.tree.map(np.asarray, cams))
    jcfg = jgn.SolverConfig(use_depth=True, depth_onesided=onesided)
    cfg = gn.SolverConfig(use_depth=True, depth_onesided=onesided)
    lj = jax.jit(lambda p, c: jgn.linearize(p, c, jcfg))(p, cams)
    lt = gn.linearize(pt, ct, cfg)
    for k in ("H_ff", "b_f", "H_ll", "b_l", "W"):
        ref = np.asarray(getattr(lj, k))
        close(getattr(lt, k), ref, rtol=1e-9, atol=1e-9 * float(np.abs(ref).max()))
    close(lt.cost, lj.cost, rtol=1e-10, atol=0)
    close(gn.compute_cost(pt, ct, cfg), jgn.compute_cost(p, cams, jcfg), rtol=1e-10, atol=0)
    # the depth rows changed the system
    assert float(lt.cost) > float(gn.linearize(pt, ct, gn.SolverConfig()).cost)
    if not onesided:
        return
    oj, cj = jgn.optimize(p, cams, jcfg._replace(max_iterations=5))
    ot, c_t = gn.optimize(pt, ct, cfg._replace(max_iterations=5))
    close(ot.T_WS, oj.T_WS, atol=1e-7)
    close(c_t, cj, rtol=1e-7, atol=0)


# ----------------------------------------------------------- depth utils


def _cams(w=64, h=48, f=40.0):
    kw = dict(fx=f, fy=f, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h, model="none",
              dist_params=())
    return jpin.make_pinhole(**kw), pinhole.make_pinhole(**kw)


def test_raw_metric_roundtrip():
    raw = np.array([[0, 1000, 65535]], np.uint16)
    m = du.input_depth_to_meters(torch.from_numpy(raw.astype(np.int32)))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jdu.input_depth_to_meters(raw)))
    np.testing.assert_allclose(m.numpy(), [[0.0, 1.0, 65.535]], atol=1e-6)
    back = du.meters_to_input_depth(m)
    np.testing.assert_array_equal(back.numpy(), raw)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdu.meters_to_input_depth(
        jdu.input_depth_to_meters(raw))))


def test_disparity_depth_and_sigma():
    fx, b = 400.0, 0.1
    disp = np.array([0.0, 4.0, 40.0], np.float32)
    z = du.disparity_to_depth(torch.from_numpy(disp), fx, b)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jdu.disparity_to_depth(disp, fx, b)))
    np.testing.assert_allclose(z.numpy(), [0.0, 10.0, 1.0], atol=1e-6)
    s = du.depth_sigma_from_disparity(torch.from_numpy(disp), torch.ones(3), fx, b)
    np.testing.assert_array_equal(s.numpy(), np.asarray(
        jdu.depth_sigma_from_disparity(disp, np.ones(3, np.float32), fx, b)))
    np.testing.assert_allclose(s[1].item(), 100.0 / 40.0, rtol=1e-5)
    assert float(s[0]) == 0.0


def test_depth_to_points_z_convention():
    jcam, cam = _cams()
    depth = np.full((cam.height, cam.width), 2.0, np.float32)
    pts, valid = du.depth_to_points(torch.from_numpy(depth), cam)
    jpts, jvalid = jdu.depth_to_points(jnp.asarray(depth), jcam)
    assert bool(valid.all())
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pts[:, 2].numpy(), 2.0, atol=1e-6)


def _register_both(depth, T_dst_src):
    jcam, cam = _cams()
    out = du.register_depth(torch.from_numpy(depth), cam, cam, T(T_dst_src)).numpy()
    ref = np.asarray(jdu.register_depth(jnp.asarray(depth), jcam, jcam, jnp.asarray(T_dst_src)))
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    return out


def test_register_depth_identity():
    out = _register_both(np.full((48, 64), 3.0, np.float32), np.r_[0, 0, 0, 0, 0, 0, 1.0])
    inner = out[1:-1, 1:-1]
    filled = inner[inner > 0]
    assert filled.size > 0.9 * inner.size
    np.testing.assert_allclose(filled, 3.0, atol=1e-5)


def test_register_depth_translation_shifts_depth():
    out = _register_both(np.full((48, 64), 3.0, np.float32), np.r_[0, 0, 1.0, 0, 0, 0, 1.0])
    np.testing.assert_allclose(out[out > 0], 4.0, atol=1e-5)


def test_register_depth_zbuffer_keeps_nearest():
    depth = np.full((48, 64), 4.0, np.float32)
    depth[24, 32] = 1.0
    T_rot = np.asarray(jse3.retract(jse3.se3_identity(jnp.float64),
                                    jnp.asarray([0.05, -0.02, 0.1, 0.02, 0.03, 0.01])))
    _register_both(depth, T_rot)
    out = _register_both(depth, np.r_[0, 0, 0, 0, 0, 0, 1.0])
    assert abs(out[24, 32] - 1.0) < 1e-5
    # the sigma map follows the winners
    jcam, cam = _cams()
    sig = np.random.default_rng(0).uniform(0.01, 0.2, depth.shape).astype(np.float32)
    st = du.warp_depth_sigma(torch.from_numpy(sig), torch.from_numpy(depth), cam, cam, T(T_rot))
    sj = jdu.warp_depth_sigma(jnp.asarray(sig), jnp.asarray(depth), jcam, jcam, jnp.asarray(T_rot))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_sparse_depth_from_landmarks():
    jcam, cam = _cams()
    hp = np.array([[0.0, 0.0, 2.0, 1.0], [0.0, 0.0, -1.0, 1.0], [0.3, -0.2, 3.0, 1.0],
                   [0.31, -0.2, 2.5, 1.0]])
    valid = np.array([True, True, True, True])
    I = np.r_[0, 0, 0, 0, 0, 0, 1.0]
    for stride in (1, 4):
        out = du.sparse_depth_from_landmarks(T(hp), torch.from_numpy(valid), T(I), cam,
                                             stride).numpy()
        ref = np.asarray(jdu.sparse_depth_from_landmarks(jnp.asarray(hp), jnp.asarray(valid),
                                                         jnp.asarray(I), jcam, stride))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    out = du.sparse_depth_from_landmarks(T(hp[:2]), torch.from_numpy(valid[:2]), T(I), cam).numpy()
    cy, cx = int(cam.fxfycxcy[3] + 0.5), int(cam.fxfycxcy[2] + 0.5)
    assert abs(out[cy, cx] - 2.0) < 1e-5
    assert (out > 0).sum() == 1  # the landmark behind the camera is rejected


# ----------------------------------------------------------- the pipelines


@pytest.fixture(scope="module")
def lockstep(tmp_path_factory):
    """Both pipelines (JAX defaults: pose refinement, pipelined solve) on
    LOCKSTEP_FRAMES frames at 320x240 with cam0 depth from the JAX
    generator's depth0/ stream, frame by frame.  Returns (JAX pipeline, port
    pipeline, per-frame records of both)."""
    out = str(tmp_path_factory.mktemp("rgbd") / "ds")
    cam, T_SC, _ = jsyn.generate(out, duration=0.3 + LOCKSTEP_FRAMES / 10.0, frame_rate=10.0,
                                 width=320, height=240, with_depth=True)
    ds = jxd.XDataset(out)
    est_cfg = EstimatorConfig(num_keyframes=4, num_imu_frames=3, cap_frames=10,
                              cap_landmarks=512, cap_obs=4096, cap_imu_links=9,
                              cap_imu_samples=128, max_iterations=5, keypoint_sigma_px=1.0)
    pipe_cfg = PipelineConfig(max_keypoints=256, octaves=1, harris_threshold=1e-6,
                              keyframe_match_fraction=0.5, do_loop_closures=False)
    jp = JVioPipeline([cam, cam], T_SC, est_cfg, pipe_cfg)
    tp = VioPipeline([convert.camera(cam)] * 2, T_SC, convert.estimator_config(est_cfg),
                     convert.pipeline_config(pipe_cfg), device="cpu")
    depth_by_t = dict(ds.depth_frames)
    recs = {"jax": [], "port": []}
    for kind, data in ds.events():
        if kind == "imu":
            jp.add_imu_measurement(*data)
            tp.add_imu_measurement(*data)
        elif kind == "frames" and len(recs["port"]) < LOCKSTEP_FRAMES:
            imgs = [ds.load_image(p) for p in data.paths]
            dimgs = [ds.load_depth(depth_by_t[data.t]), None]
            for k, pipe in (("jax", jp), ("port", tp)):
                info = pipe.process_frame(data.t, imgs, depth_images=dimgs)
                recs[k].append((info["T_WS"][:3].copy(), int((pipe.est.obs_depth_sigma > 0).sum()),
                                len(pipe.est.lm_ids), info["n_stereo"]))
    return jp, tp, recs, ds


def test_rgbd_lockstep_matches_jax(lockstep):
    """Every frame: the depth-prior and landmark counts and the stereo plus
    depth-initialised landmark count equal, positions within
    LOCKSTEP_TOL_M; depth priors attached from the first frame on."""
    _, _, recs, _ = lockstep
    assert len(recs["port"]) == len(recs["jax"]) == LOCKSTEP_FRAMES
    for k, (a, b) in enumerate(zip(recs["port"], recs["jax"])):
        assert a[1:] == b[1:], (k, a[1:], b[1:])
        assert np.abs(a[0] - b[0]).max() < LOCKSTEP_TOL_M, k
    assert recs["port"][0][1] > 50


def test_estimator_state_carries_depth_priors(lockstep):
    """`convert.estimator_state` with live and archived depth priors: the
    columns equal, and the problem built from the converted state carries
    the same depth rows as the one the port's own estimator builds."""
    jp, tp, _, _ = lockstep
    je = jp.est
    # an archived observation with a prior, as marginalisation leaves them
    je.archive_observation(int(je.frames[0].fid), 0, int(je.lm_ids[0]), np.array([10.0, 20.0]),
                           1.0, 4.5, 0.07)
    dst = SlidingWindowEstimator(convert.estimator_config(je.cfg), [convert.camera(c)
                                 for c in jp.cameras], jp.T_SC, device="cpu")
    convert.estimator_state(je, dst)
    for k in ("obs_depth", "obs_depth_sigma", "arch_obs_depth", "arch_obs_depth_sigma"):
        np.testing.assert_array_equal(getattr(dst, k), np.asarray(getattr(je, k)))
    assert (dst.obs_depth_sigma > 0).sum() > 50 and (dst.arch_obs_depth_sigma > 0).any()
    p_dst, _, _, use_dst = dst._build_problem()
    p_own, _, _, use_own = tp.est._build_problem()
    assert use_dst and use_own
    np.testing.assert_array_equal(p_dst.obs_depth_valid.numpy(), p_own.obs_depth_valid.numpy())
    close(p_dst.obs_depth, p_own.obs_depth.numpy(), atol=1e-12)
    close(p_dst.obs_depth_si, p_own.obs_depth_si.numpy(), atol=1e-9)
    # an archived keyframe's priors come back with its observations
    n = dst._arch_obs_n
    dst.archive_observation(int(dst.frames[0].fid), 0, int(dst.lm_ids[0]), np.array([10.0, 20.0]),
                            1.0, 4.5, 0.07)
    assert dst._arch_obs_n == n + 1
    dst.frames[0].pose_graph_frame = True
    n_live = len(dst.obs_fid)
    dst.expand_keyframe(int(dst.frames[0].fid))
    assert len(dst.obs_fid) > n_live and 0.07 in dst.obs_depth_sigma[n_live:]


def test_deferred_frontend_attaches_depth(lockstep):
    """The deferred fused frontend carries a frame's depth images to the
    consume of its critical block: the port's deferred pipeline on the same
    frames attaches depth priors and initialises landmarks from depth, in
    the counts of the synchronous path within 10%."""
    jp, tp, recs, ds = lockstep
    dp = VioPipeline(tp.cameras, tp.T_SC, tp.est.cfg,
                     dataclasses.replace(tp.cfg, deferred_frontend=True, pose_refine=False),
                     device="cpu")
    depth_by_t = dict(ds.depth_frames)
    n, priors, n_init = 0, [], 0
    init = dp.depth_initialize

    def counted(*a):
        nonlocal n_init
        k = init(*a)
        n_init += k
        return k

    dp.depth_initialize = counted
    for kind, data in ds.events():
        if kind == "imu":
            dp.add_imu_measurement(*data)
        elif kind == "frames" and n < LOCKSTEP_FRAMES:
            dp.process_frame(data.t, [ds.load_image(p) for p in data.paths],
                             depth_images=[ds.load_depth(depth_by_t[data.t]), None])
            priors.append(int((dp.est.obs_depth_sigma > 0).sum()))
            n += 1
    dp.finish()
    assert n_init > 50
    # consumed one frame late: the last frame's priors land in finish()
    assert abs(priors[-1] - recs["port"][-2][1]) <= 0.1 * recs["port"][-2][1]


def jax_app_rehearsal(mode, n_frames, root):
    """The JAX app in `mode` (rgbd or depth) on `chip_smoke.depth_dataset`'s
    dataset of `n_frames` frames (written by the port's generator, whose files
    are the JAX package's), or (fine) on the first `n_frames` of the depth
    mode's dataset under `chip_smoke.FINE_SE2`, recorded as the chip phase
    records the port's app; returns `chip_smoke.depth_metrics` and the wall
    time, and for fine also `chip_smoke.export_stats` at log-odds 0."""
    import runpy
    import time

    from okvis2x_tpu.pipeline.submapping import SubmappingInterface as JSubmapping

    import chip_smoke

    if mode == "fine":  # the first n_frames of the depth phase's dataset at 0.025 m
        ds_dir, _ = chip_smoke.depth_dataset(root, "depth", chip_smoke.DEPTH_FRAMES)
        app_argv = chip_smoke.fine_args(ds_dir, os.path.join(root, "fine"), n_frames)
        out = os.path.join(root, "fine", "out")
    else:
        ds_dir, app_argv = chip_smoke.depth_dataset(root, mode, n_frames)
        out = os.path.join(root, "out")
    argv = sys.argv
    sys.argv = ["okvis2x_app.py", *app_argv]
    t0 = time.perf_counter()
    try:
        with chip_smoke.DepthRecorder(JVioPipeline, JSubmapping) as rec:
            runpy.run_path(os.path.join(REPO, "apps", "okvis2x_app.py"), run_name="__main__")
    finally:
        sys.argv = argv
    m = chip_smoke.depth_metrics(rec, ds_dir, out)
    m["wall_s"] = time.perf_counter() - t0
    if mode == "fine":
        m.update(chip_smoke.export_stats(rec.submapping, os.path.join(out, "map_evidence.ply"),
                                         chip_smoke.FINE_EXPORT_THRESHOLD))
    return m


def count_aten():
    """aten calls (with the nested ones, as torch.profiler lists them on the
    CPU) of one `linearize` of `depth_window_problem` without and with its
    depth rows."""
    import torch.profiler as tp

    p, cams = depth_window_problem()
    pt = convert.ba_problem(jax.tree.map(np.asarray, p))
    ct = convert.stacked_cameras(jax.tree.map(np.asarray, cams))
    out = {}
    for name, cfg in (("base", gn.SolverConfig()), ("depth", gn.SolverConfig(use_depth=True))):
        gn.linearize(pt, ct, cfg)
        with tp.profile(activities=[tp.ProfilerActivity.CPU]) as prof:
            gn.linearize(pt, ct, cfg)
        out[name] = sum(e.name.startswith("aten::") for e in prof.events())
    out["torch"] = torch.__version__
    return out


if __name__ == "__main__":
    import json

    jax.config.update("jax_enable_x64", True)
    if sys.argv[1:] == ["--count-aten"]:
        print(json.dumps(count_aten()))
    else:
        mode = sys.argv[1]
        n = int(sys.argv[2])
        res = jax_app_rehearsal(mode, n, os.path.join(REPO, "build", f"{mode}_rehearsal"))
        print(json.dumps(res, default=float))
