"""Parity of the port's loop-closure back end with the JAX package: the
pose-graph optimiser, the estimator surgery of tests/test_loopclosure.py
and the loop-closure matcher (the final BA is in test_torch_final_ba.py).

Estimator tests build the state in the JAX package, copy it into the port
(`convert.estimator_state`) and run the same operation on both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import distortion as jdist
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.graph import EstimatorConfig, FrameState
from okvis2x_tpu.graph import SlidingWindowEstimator as JEstimator
from okvis2x_tpu.graph import posegraph as jpg
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.graph import posegraph
from okvis2x_tpu_torch.graph.estimator import SlidingWindowEstimator
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

torch.set_num_threads(1)


def port_of(jest):
    """A port estimator holding a copy of the JAX estimator's state."""
    cams = [convert.camera(jax.tree.map(np.asarray, jest.cams.at(c))) for c in range(jest.C)]
    est = SlidingWindowEstimator(convert.estimator_config(jest.cfg), cams, jest.T_SC,
                                 device="cpu")
    return convert.estimator_state(jest, est)


def assert_same_state(t, j, atol):
    """Poses, landmarks, archive sizes and edges of both estimators."""
    assert [f.fid for f in t.frames] == [f.fid for f in j.frames]
    assert sorted(t.archive_frames) == sorted(j.archive_frames)
    for a, b in zip(t.frames + [t.archive_frames[k] for k in sorted(t.archive_frames)],
                    j.frames + [j.archive_frames[k] for k in sorted(j.archive_frames)]):
        np.testing.assert_allclose(a.T_WS, b.T_WS, rtol=0, atol=atol)
        assert (a.expanded, a.pose_fixed, a.pose_graph_frame) == (
            b.expanded, b.pose_fixed, b.pose_graph_frame)
    assert t.lm_ids == [int(l) for l in j.lm_ids]
    np.testing.assert_allclose(t.hp_W, j.hp_W, rtol=0, atol=atol)
    assert sorted(t.arch_lm) == sorted(int(k) for k in j.arch_lm)
    for k, v in t.arch_lm.items():
        np.testing.assert_allclose(v, j.arch_lm[k], rtol=0, atol=atol)
    assert t._arch_obs_n == j._arch_obs_n
    np.testing.assert_array_equal(t._arch_obs_i[:t._arch_obs_n], j._arch_obs_i[:j._arch_obs_n])
    np.testing.assert_array_equal(t.obs_fid, j.obs_fid)
    np.testing.assert_array_equal(t.obs_lid, j.obs_lid)
    for te, je in ((t.rel_edges, j.rel_edges), (t.archive_edges, j.archive_edges)):
        assert [(e["i"], e["j"], bool(e.get("loop"))) for e in te] == [
            (e["i"], e["j"], bool(e.get("loop"))) for e in je]
    assert t.lc_protected == j.lc_protected
    assert t.correction_epoch == j.correction_epoch


# --------------------------------------------------------------- pose graph
def drifted_circle(K, rng, radius=5.0):
    """K keyframes on a circle with drifting estimates, noisy odometry edges
    to the next two keyframes (as marginalisation's spanning tree gives) and
    loop edges from the last quarter to the first."""
    gt, est = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        T = np.concatenate([[radius * np.cos(th), radius * np.sin(th), 0.0],
                            se3np.delta_q(np.array([0.0, 0.0, th + np.pi / 2]))])
        gt.append(T)
        d = np.concatenate([np.array([1.0, 0.5, 0.1]), [0, 0, 1.0]]) * 0.8 * k / K
        est.append(se3np.retract(T, d))
    ei, ej, eT, eS = [], [], [], []

    def edge(a, b, w, noise):
        T_ab = se3np.se3_multiply(se3np.se3_inverse(gt[a]), gt[b])
        ei.append(a)
        ej.append(b)
        eT.append(se3np.retract(T_ab, rng.normal(0, noise, 6)))
        eS.append(np.eye(6) * w)

    for k in range(K - 1):
        edge(k, k + 1, 100.0, 1e-3)
        if k + 2 < K:
            edge(k, k + 2, 100.0, 1e-3)
    for k in range(K - K // 4, K):
        edge(k % 4, k, 50.0, 2e-3)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return np.stack(est), fixed, np.array(ei), np.array(ej), np.stack(eT), np.stack(eS), gt


@pytest.mark.parametrize("K,iters,atol,cost_rtol",
                         [(40, 10, 1e-8, 1e-8), (66, 4, 1e-8, 1e-8), (200, 4, 1e-4, 1e-5)])
def test_optimize_pose_graph_matches_jax(K, iters, atol, cost_rtol):
    """K = 40 pads to 64 nodes (inverse); 66 and 200 pad to 256 (conjugate
    gradients) in both packages: poses within 1e-8 at 40 and 66.  At 200
    nodes the 256 CG steps stop short of convergence and rounding decides
    the last digits: the JAX function alone moves its poses by 4.1e-5 and
    its cost by 7e-7 relative when only the order of the edges changes, so
    the port is held to 1e-4 there."""
    args = drifted_circle(K, np.random.default_rng(K))
    ref, cost_j = jpg.optimize_pose_graph(*args[:6], iterations=iters)
    got, cost_t = posegraph.optimize_pose_graph(*args[:6], iterations=iters,
                                           device="cpu")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=atol)
    assert abs(cost_t - cost_j) <= cost_rtol * max(1.0, abs(cost_j))
    if K == 40:  # the loop closes: the drift is gone
        err = np.linalg.norm(got[:, :3] - np.stack(args[6])[:, :3], axis=1)
        assert err.max() < 0.05, err.max()


# ------------------------------------------------- surgery (test_loopclosure)
def make_jest(**kw):
    cam = jpin.make_pinhole(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
                            model=jdist.NONE)
    cfg = EstimatorConfig(**(dict(cap_frames=6, cap_landmarks=8, cap_obs=16, cap_imu_links=5,
                                  cap_rel_edges=8) | kw))
    return JEstimator(cfg, [cam], np.array([[0, 0, 0, 0, 0, 0, 1.0]])), cam


def test_close_loop_corrects_drift_matches_jax():
    jest, _ = make_jest()
    n = 12
    gt = [np.concatenate([[5 * np.cos(th), 5 * np.sin(th), 0.0],
                          se3np.delta_q(np.array([0.0, 0.0, th + np.pi / 2]))])
          for th in 2 * np.pi * np.arange(n) / n]
    for k in range(n):
        d = np.concatenate([np.array([1.0, 0.5, 0.1]) * 0.02 * k, [0, 0, 0.02 * k]])
        f = FrameState(fid=k, timestamp=float(k), T_WS=se3np.retract(gt[k], d), sb=np.zeros(9),
                       is_keyframe=True, pose_graph_frame=k < n - 2)
        (jest.archive_frames.__setitem__(k, f) if k < n - 4 else jest.frames.append(f))
    for k in range(n - 1):
        e = dict(i=k, j=k + 1, T_ij=se3np.se3_multiply(se3np.se3_inverse(gt[k]), gt[k + 1]),
                 sqrt_info=np.eye(6) * 100.0)
        (jest.archive_edges if k < n - 4 else jest.rel_edges).append(e)
    test = port_of(jest)
    T_loop = se3np.se3_multiply(se3np.se3_inverse(gt[0]), gt[n - 1])
    assert jest.close_loop(n - 1, 0, T_loop, np.eye(6) * 500.0, iterations=15)
    assert test.close_loop(n - 1, 0, T_loop, np.eye(6) * 500.0, iterations=15)
    assert_same_state(test, jest, atol=1e-8)
    err = [np.linalg.norm(f.T_WS[:3] - gt[f.fid][:3]) for f in test.pose_graph()[0]]
    assert max(err) < 0.05, err


def test_close_loop_rejects_unknown_frames_matches_jax():
    jest, _ = make_jest()
    jest.frames.append(FrameState(fid=0, timestamp=0.0, T_WS=np.array([0, 0, 0, 0, 0, 0, 1.0]),
                                  sb=np.zeros(9), is_keyframe=True))
    test = port_of(jest)
    args = (0, 99, np.array([0, 0, 0, 0, 0, 0, 1.0]), np.eye(6))
    assert not jest.close_loop(*args)
    assert not test.close_loop(*args)
    assert_same_state(test, jest, atol=0)


@pytest.mark.parametrize("merge", [True, False])
def test_expand_merge_recovers_drift_matches_jax(merge):
    """An archived keyframe re-enters the window, its observations
    re-expand, duplicated landmarks merge, and the window solve recovers the
    drift (merged) or keeps it (not merged), identically in both."""
    jest, cam = make_jest(cap_frames=8, cap_landmarks=128, cap_obs=512, cap_imu_links=7,
                          max_iterations=25)
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-1.5, 1.5, 40),
                    rng.uniform(4, 7, 40)], -1)
    T_true = np.array([0, 0, 0, 0, 0, 0, 1.0])
    drift = np.array([0.05, -0.03, 0.02])

    def project(T_WS, pt):
        p_C = se3np.se3_apply(se3np.se3_inverse(T_WS), pt)
        uv, ok = jpin.project(cam, jnp.asarray(p_C))
        return np.asarray(uv), bool(ok)

    jest.archive_frames[100] = FrameState(fid=100, timestamp=0.0, T_WS=T_true.copy(),
                                          sb=np.zeros(9), is_keyframe=True, pose_fixed=True,
                                          pose_graph_frame=True)
    lidsA = []
    for pt in pts:
        lid = jest._next_lid
        jest._next_lid += 1
        jest.arch_lm[lid] = np.concatenate([pt, [1.0]])
        lidsA.append(lid)
        uv, ok = project(T_true, pt)
        if ok:
            jest.archive_observation(100, 0, lid, uv, 1.0, 1.0, 0.0)
    lidsB = {}
    for k, fid in enumerate((200, 201)):
        T_drift = T_true.copy()
        T_drift[:3] += drift
        T_drift[0] += 0.02 * k
        jest.frames.append(FrameState(fid=fid, timestamp=1.0 + 0.1 * k, T_WS=T_drift,
                                      sb=np.zeros(9), is_keyframe=True, sb_fixed=True,
                                      pose_graph_frame=True, expanded=True))
        for i, pt in enumerate(pts):
            true_Tk = T_true.copy()
            true_Tk[0] += 0.02 * k
            uv, ok = project(true_Tk, pt)
            if not ok:
                continue
            if i not in lidsB:
                lidsB[i] = jest.add_landmark(np.concatenate([pt + drift, [1.0]]))
            jest.add_observation(fid, 0, lidsB[i], uv)
    test = port_of(jest)
    for est in (jest, test):
        assert est.add_loopclosure_frame(100)
        est._frame_by_id(100).pose_fixed = True
        if merge:
            for i, lid_new in lidsB.items():
                assert est.merge_landmarks(lidsA[i], lid_new)
    assert_same_state(test, jest, atol=0)
    cost_j, cost_t = jest.optimise(), test.optimise()
    assert abs(cost_t - cost_j) <= 1e-8 * max(1.0, cost_j)
    assert_same_state(test, jest, atol=1e-8)
    err = np.linalg.norm(test.frames[-1].T_WS[:3] - np.array([0.02, 0, 0]))
    assert (err < 0.01) if merge else (err > 0.04), err
    f100 = test._frame_by_id(100)
    assert f100.expanded and f100.pose_graph_frame and (test.obs_fid == 100).sum() > 20
    assert jest.remove_loopclosure_frame(100) and test.remove_loopclosure_frame(100)
    assert_same_state(test, jest, atol=1e-8)
    assert (test.arch_obs_fid == 100).sum() > 20


def test_pose_graph_sync_moves_archived_landmarks_matches_jax():
    jest, _ = make_jest()
    Ta_old = np.array([1.0, 2.0, 0.0, 0, 0, 0, 1.0])
    jest.archive_frames[100] = FrameState(fid=100, timestamp=0.0, T_WS=Ta_old.copy(),
                                          sb=np.zeros(9), is_keyframe=True,
                                          pose_graph_frame=True)
    p_S = np.array([0.5, -0.2, 3.0])
    jest.arch_lm[7] = np.concatenate([se3np.se3_apply(Ta_old, p_S), [1.0]])
    jest.archive_observation(100, 0, 7, np.array([320.0, 240.0]))
    jest.arch_lm[8] = np.array([9.0, 9.0, 9.0, 1.0])
    Tb_old = np.array([2.0, 2.0, 0.0, 0, 0, 0, 1.0])
    jest.frames.append(FrameState(fid=200, timestamp=1.0, T_WS=Tb_old.copy(), sb=np.zeros(9),
                                  is_keyframe=True))
    test = port_of(jest)
    Ta_new = se3np.retract(Ta_old, np.array([0.3, -0.1, 0.05, 0.0, 0.0, 0.2]))
    Tb_new = Tb_old.copy()
    Tb_new[0] += 0.1
    for est in (jest, test):
        assert est.apply_pose_graph_result([100, 200], np.stack([Ta_new, Tb_new]))
    assert_same_state(test, jest, atol=1e-12)
    np.testing.assert_allclose(test.arch_lm[7][:3], se3np.se3_apply(Ta_new, p_S), atol=1e-9)
    np.testing.assert_allclose(test.arch_lm[8][:3], [9.1, 9.0, 9.0], atol=1e-9)


# ------------------------------------------------------- loop-closure matcher
def test_lc_match_matches_jax():
    """Mutual matching of a 2-camera keyframe record against two candidate
    records and one empty slot: indices and masks exactly equal; the empty
    slot matches nothing."""
    rng = np.random.default_rng(11)
    N, C = 256, 2
    words = lambda n: rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)  # noqa: E731
    rec_pk = words(C * N).reshape(C, N, 12)
    rec_v = rng.random((C, N)) > 0.15
    cands = []
    for _ in range(2):
        pk = words(C * N).reshape(C, N, 12)
        # a third of the candidate rows are the query's descriptors with a
        # few flipped bits, in another order
        src = rng.permutation(N)[: N // 3]
        dst = rng.permutation(N)[: N // 3]
        flips = (rng.random((C, N // 3, 12, 32)) < 0.02) << np.arange(32, dtype=np.uint32)
        pk[:, dst] = rec_pk[:, src] ^ flips.sum(-1).astype(np.uint32)
        cands.append((pk, rng.random((C, N)) > 0.15))
    jpipe = JVioPipeline([jpin.make_pinhole(280.0, 280.0, 160.0, 120.0, 320, 240)] * 2,
                         np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]]),
                         EstimatorConfig(),
                         PipelineConfig(max_keypoints=N, do_loop_closures=False,
                                        async_place_recognition=False, pose_refine=False,
                                        pipelined_solve=False))
    cand_pk = np.zeros((3, C, N, 12), np.uint32)
    cand_v = np.zeros((3, C, N), bool)
    for b, (pk, v) in enumerate(cands):
        cand_pk[b], cand_v[b] = pk, v
    mi_j, ok_j = jpipe._lc_match_fn()(jnp.asarray(rec_pk), jnp.asarray(rec_v),
                                      jnp.asarray(cand_pk), jnp.asarray(cand_v))
    tpipe = VioPipeline([convert.camera(jax.tree.map(np.asarray, jpipe.cameras[0]))] * 2,
                        jpipe.T_SC, convert.estimator_config(EstimatorConfig()),
                        convert.pipeline_config(jpipe.cfg), device="cpu")

    def record(pk, v):
        return {f"{k}{'' if c == 0 else c}_d": torch.as_tensor(x[c])
                for c in range(C) for k, x in (("packed", pk.view(np.int32)), ("valid", v))} | {
            "packed1": pk[1]}

    mi_t, ok_t = tpipe._lc_match(record(rec_pk, rec_v),
                                 [(b, record(pk, v)) for b, (pk, v) in enumerate(cands)])
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(mi_t[ok_j], np.asarray(mi_j)[ok_j])
    np.testing.assert_array_equal(mi_t[:2], np.asarray(mi_j)[:2])
    assert ok_t[:2].sum() > 100 and not ok_t[2].any()


# ------------------------------------------------------- what is not ported
@pytest.mark.parametrize("unported", [
    dict(segmentation="net"), dict(segmentation="heuristic"),
    dict(deferred_frontend=True, segmentation="net"),
    dict(pipelined_solve=False, segmentation="net"),
])
def test_unported_loop_closure_features_raise(unported):
    """Semantic keypoint weighting (the learned and the heuristic weights on
    the pipelined path, the learned ones on the synchronous path and inside
    the deferred fused frontend) raises instead of running something else."""
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig as TPipelineConfig

    cam = convert.camera(jax.tree.map(np.asarray, make_jest()[1]))
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0]])
    sync = dict(do_loop_closures=True, async_place_recognition=False, async_loop_closure=False)
    est_cfg = convert.estimator_config(EstimatorConfig())
    with pytest.raises(NotImplementedError):
        VioPipeline([cam], T_SC, est_cfg, TPipelineConfig(**(sync | unported)), device="cpu")
