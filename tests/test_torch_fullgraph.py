"""The port's background full-graph optimiser: the six cases of
tests/test_fullgraph.py on the port, and the JAX package's and the port's
`FullGraphOptimizer` on the same converted state (its background full BA is
held to the JAX package's in test_torch_full_ba.py)."""

import numpy as np
import pytest
import torch

from okvis2x_tpu.graph import FrameState as JFrameState
from okvis2x_tpu.graph.fullgraph import FullGraphOptimizer as JFullGraphOptimizer
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, FrameState, SlidingWindowEstimator
from okvis2x_tpu_torch.graph.fullgraph import FullGraphOptimizer

from test_torch_dist_posegraph import fullgraph_circle
from test_torch_loopclosure import make_jest, port_of

torch.set_num_threads(1)
N = 12
# a hang guard only: `join` returns whether the solve finished, which is what
# the tests check; the JAX optimiser's first solve includes an XLA compile,
# which took more than 120 s under the whole suite's load
JOIN_TIMEOUT_S = 1200.0


def make_est():
    """The estimator of tests/test_loopclosure.py, on the CPU."""
    cam = pinhole.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480, model="none",
                               device="cpu")
    cfg = EstimatorConfig(cap_frames=6, cap_landmarks=8, cap_obs=16, cap_imu_links=5,
                          cap_rel_edges=8)
    return SlidingWindowEstimator(cfg, [cam], np.array([[0, 0, 0, 0, 0, 0, 1.0]]), device="cpu")


def build(est, frame_state=FrameState, n=N):
    """`_build` of tests/test_fullgraph.py: n keyframes of the drifted circle,
    the oldest n - 4 archived, chain edges of information 100 (the last three
    in the window).  Returns the ground-truth poses."""
    T0, _, _, _, eT, _, gt = fullgraph_circle(n)
    for k in range(n):
        f = frame_state(fid=k, timestamp=float(k), T_WS=T0[k].copy(), sb=np.zeros(9),
                        is_keyframe=True, pose_graph_frame=k < n - 2)
        if k < n - 4:
            est.archive_frames[k] = f
        else:
            est.frames.append(f)
    for k in range(n - 1):
        e = dict(i=k, j=k + 1, T_ij=eT[k], sqrt_info=np.eye(6) * 100.0)
        (est.archive_edges if k < n - 4 else est.rel_edges).append(e)
    return gt


def loop_edge(gt, n=N):
    return se3np.se3_multiply(se3np.se3_inverse(gt[0]), gt[n - 1])


def poses(est):
    return [f.T_WS.copy() for f in est.pose_graph()[0]]


def test_background_matches_synchronous():
    """dispatch + join + synchronise reproduces close_loop exactly when the
    window is quiet between snapshot and synchronisation."""
    est_sync, est_bg = make_est(), make_est()
    gt = build(est_sync)
    build(est_bg)
    assert est_sync.close_loop(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0, iterations=15)
    opt = FullGraphOptimizer(iterations=15, dtype=est_bg.cfg.dtype)
    assert est_bg.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    assert opt.dispatch(est_bg)
    assert not opt.dispatch(est_bg)  # one optimisation in flight
    assert opt.join(timeout=JOIN_TIMEOUT_S)
    assert opt.is_loop_closure_available
    assert opt.synchronise(est_bg)
    assert not opt.is_loop_closure_available  # the result is consumed
    assert (opt.n_dispatched, opt.n_synchronised, opt.n_stale_discarded) == (1, 1, 0)
    for a, b in zip(poses(est_sync), poses(est_bg)):
        np.testing.assert_allclose(a, b, atol=1e-9)


def test_backlog_replay_after_snapshot():
    """A state added between dispatch and synchronise moves rigidly with
    the anchor keyframe's correction, its velocity rotated with it."""
    est = make_est()
    gt = build(est)
    opt = FullGraphOptimizer(iterations=15, dtype=est.cfg.dtype)
    assert est.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    assert opt.dispatch(est)
    T_rel = np.array([0.3, 0.0, 0.0, 0, 0, 0, 1.0])
    anchor_before = est.frames[-1].T_WS.copy()
    v_before = np.array([1.0, 0.0, 0.0])
    est.frames.append(FrameState(fid=N, timestamp=float(N),
                                 T_WS=se3np.se3_multiply(anchor_before, T_rel),
                                 sb=np.concatenate([v_before, np.zeros(6)])))
    assert opt.join(timeout=JOIN_TIMEOUT_S)
    assert opt.synchronise(est)
    anchor_after = est.frames[-2].T_WS
    assert (np.linalg.norm(anchor_after[:3] - gt[N - 1][:3])
            < np.linalg.norm(anchor_before[:3] - gt[N - 1][:3]))
    T_rel_after = se3np.se3_multiply(se3np.se3_inverse(anchor_after), est.frames[-1].T_WS)
    np.testing.assert_allclose(T_rel_after[:3], T_rel[:3], atol=1e-6)
    dq = se3np.se3_multiply(anchor_after, se3np.se3_inverse(anchor_before))[3:7]
    np.testing.assert_allclose(est.frames[-1].sb[0:3], se3np.quat_to_matrix(dq) @ v_before,
                               atol=1e-6)


def test_loop_edge_persists_in_pose_graph():
    est = make_est()
    gt = build(est)
    assert est.close_loop(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    assert any(e.get("loop") for e in est.pose_graph()[1])
    snap = est.snapshot_pose_graph()
    fid2i = {fid: i for i, fid in enumerate(snap["fids"])}
    assert (fid2i[0], fid2i[N - 1]) in set(zip(snap["ei"].tolist(), snap["ej"].tolist()))


def test_dispatch_rejects_tiny_graph():
    est = make_est()
    est.frames.append(FrameState(fid=0, timestamp=0.0, T_WS=np.array([0, 0, 0, 0, 0, 0, 1.0]),
                                 sb=np.zeros(9), is_keyframe=True))
    opt = FullGraphOptimizer()
    assert not opt.dispatch(est)
    assert not opt.is_loop_closure_available
    assert not opt.synchronise(est)
    assert opt.n_dispatched == 0


def test_background_pcg_path_matches_dense():
    """With pcg_threshold=0 the worker solves on the matrix-free PCG solver;
    the result agrees with the dense solve to 1e-6."""
    results = []
    for thresh in (256, 0):
        est = make_est()
        gt = build(est)
        opt = FullGraphOptimizer(iterations=15, dtype=est.cfg.dtype, pcg_threshold=thresh)
        assert est.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
        assert opt.dispatch(est)
        assert opt.join(timeout=JOIN_TIMEOUT_S)
        assert opt.synchronise(est)
        results.append(poses(est))
    for a, b in zip(*results):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_stale_result_discarded_after_correction():
    """A correction applied between dispatch and synchronise (here a
    pose-graph writeback, which bumps the correction epoch as the JAX
    test's rigid transform does) makes the pending result stale: it is
    discarded and the state left untouched; the next dispatch applies."""
    est = make_est()
    gt = build(est)
    opt = FullGraphOptimizer(iterations=15, dtype=est.cfg.dtype)
    assert est.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    assert opt.dispatch(est)
    assert opt.join(timeout=JOIN_TIMEOUT_S)
    nodes = est.pose_graph()[0]
    shifted = np.stack([f.T_WS for f in nodes]) + np.array([0.5, 0, 0, 0, 0, 0, 0])
    epoch = est.correction_epoch
    assert est.apply_pose_graph_result([f.fid for f in nodes], shifted)
    assert est.correction_epoch == epoch + 1
    after_correction = poses(est)
    assert not opt.synchronise(est)  # stale: discarded
    assert opt.n_stale_discarded == 1
    assert not opt.is_loop_closure_available  # consumed, not retried
    for a, b in zip(after_correction, poses(est)):
        np.testing.assert_array_equal(a, b)
    assert opt.dispatch(est)
    assert opt.join(timeout=JOIN_TIMEOUT_S)
    assert opt.synchronise(est)
    assert opt.n_synchronised == 1


@pytest.mark.parametrize("pcg_threshold", [256, 0])
def test_full_graph_matches_jax(pcg_threshold):
    """The JAX package's and the port's optimiser from one converted state,
    with the loop edge added: the same poses within 1e-8, dense and PCG."""
    jest, _ = make_jest()
    gt = build(jest, JFrameState)
    test = port_of(jest)
    for est in (jest, test):
        assert est.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    # the default full_ba_threshold (64) would try the background full BA
    # first; with no observations it falls back to the pose graph, which 0
    # selects directly
    jopt = JFullGraphOptimizer(iterations=15, dtype=jest.cfg.dtype, full_ba_threshold=0,
                               pcg_threshold=pcg_threshold)
    topt = FullGraphOptimizer(iterations=15, dtype=test.cfg.dtype, full_ba_threshold=0,
                              pcg_threshold=pcg_threshold)
    for opt, est in ((jopt, jest), (topt, test)):
        assert opt.dispatch(est) and opt.join(timeout=JOIN_TIMEOUT_S) and opt.synchronise(est)
    for a, b in zip(poses(test), poses(jest)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
    assert test.correction_epoch == jest.correction_epoch


def test_unported_full_ba_threshold_raises():
    """The background full BA is ported: the optimiser no longer raises on
    a threshold, and its default equals the JAX package's (64); the
    pipeline's default stays the JAX package's 0 (the pose graph only)."""
    from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig

    assert FullGraphOptimizer().full_ba_threshold == JFullGraphOptimizer().full_ba_threshold == 64
    assert PipelineConfig().full_ba_threshold == JPipelineConfig().full_ba_threshold == 0


def test_worker_failure_is_logged(caplog, monkeypatch):
    """A solve that raises on the worker is logged at ERROR (what
    chip_smoke.py fails a run on) and leaves no result."""
    from okvis2x_tpu_torch.graph import posegraph

    def boom(*a, **k):
        raise RuntimeError("injected")
    monkeypatch.setattr(posegraph, "optimize_pose_graph", boom)
    est = make_est()
    gt = build(est)
    opt = FullGraphOptimizer()
    assert est.add_loop_edge(N - 1, 0, loop_edge(gt), np.eye(6) * 500.0)
    with caplog.at_level("ERROR"):
        assert opt.dispatch(est) and opt.join(timeout=JOIN_TIMEOUT_S)
    assert not opt.is_loop_closure_available
    assert any(r.levelname == "ERROR" and "pose-graph solve failed" in r.getMessage()
               for r in caplog.records)

