"""The port's matrix-free pose-graph solver against the JAX package's
`optimize_pose_graph_pcg` (single device, `mesh=None`), against the port's
dense pose-graph solve, and as the final BA's pose-graph stage above 256
nodes."""

import numpy as np
import pytest
import torch

from okvis2x_tpu.parallel import dist_posegraph as jdpg
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.graph import posegraph
from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, FrameState, SlidingWindowEstimator
from okvis2x_tpu_torch.parallel import dist_posegraph

from test_torch_loopclosure import drifted_circle

torch.set_num_threads(1)


def fullgraph_circle(n=12, radius=5.0, drift_rate=0.02):
    """The drifted circle of tests/test_fullgraph.py: exact odometry edges of
    information 100 along the chain and one loop edge of 500 from the first
    node to the last."""
    gt = [np.concatenate([[radius * np.cos(th), radius * np.sin(th), 0.0],
                          se3np.delta_q(np.array([0.0, 0.0, th + np.pi / 2]))])
          for th in 2 * np.pi * np.arange(n) / n]
    T0 = np.stack([se3np.retract(T, np.concatenate([np.array([1.0, 0.5, 0.1]) * drift_rate * k,
                                                    [0, 0, drift_rate * k]]))
                   for k, T in enumerate(gt)])
    rel = lambda a, b: se3np.se3_multiply(se3np.se3_inverse(gt[a]), gt[b])  # noqa: E731
    ei = list(range(n - 1)) + [0]
    ej = list(range(1, n)) + [n - 1]
    eT = np.stack([rel(a, b) for a, b in zip(ei, ej)])
    eS = np.stack([np.eye(6) * 100.0] * (n - 1) + [np.eye(6) * 500.0])
    fixed = np.zeros(n, bool)
    fixed[0] = True
    return T0, fixed, np.array(ei), np.array(ej), eT, eS, np.stack(gt)


@pytest.mark.parametrize("case", ["fullgraph circle 12", "drifted circle 300, loop edges"])
def test_pcg_matches_jax(case):
    """Poses within 1e-6 (the tolerance of the JAX package's own PCG tests)
    and costs within 1e-6 relative, at 12 nodes (one 64-node bucket, 128 CG
    iterations) and at 300 nodes with 75 loop edges (512 nodes, 512 CG
    iterations, 1024 edges)."""
    if case.startswith("fullgraph"):
        args, iters = fullgraph_circle()[:6], 15
    else:
        args, iters = drifted_circle(300, np.random.default_rng(300))[:6], 10
    ref, cost_j = jdpg.optimize_pose_graph_pcg(*args, iterations=iters)
    got, cost_t = dist_posegraph.optimize_pose_graph_pcg(*args, iterations=iters, device="cpu")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-6)
    assert abs(cost_t - cost_j) <= 1e-6 * max(1.0, abs(cost_j)), (cost_t, cost_j)
    assert np.array_equal(got[0], args[0][0])  # the gauge node stays


def test_pcg_matches_dense_and_closes_the_loop():
    """At 12 nodes the PCG and the port's dense solve reach the same poses
    (1e-6) and both remove the drift."""
    T0, fixed, ei, ej, eT, eS, gt = fullgraph_circle()
    dense, _ = posegraph.optimize_pose_graph(T0, fixed, ei, ej, eT, eS, iterations=15,
                                             device="cpu")
    pcg, _ = dist_posegraph.optimize_pose_graph_pcg(T0, fixed, ei, ej, eT, eS, iterations=15,
                                                    device="cpu")
    np.testing.assert_allclose(pcg, dense, rtol=0, atol=1e-6)
    assert np.abs(pcg[:, :3] - gt[:, :3]).max() < 0.05


def test_pcg_keeps_fixed_poses_and_refuses_a_mesh():
    T0, fixed, ei, ej, eT, eS, _ = fullgraph_circle(n=8)
    fixed = fixed.copy()
    fixed[3] = True
    got, _ = dist_posegraph.optimize_pose_graph_pcg(T0, fixed, ei, ej, eT, eS, iterations=6,
                                                    cg_iterations=48, device="cpu")
    np.testing.assert_array_equal(got[[0, 3]], T0[[0, 3]])
    assert not np.array_equal(got[5], T0[5])
    with pytest.raises(NotImplementedError):
        dist_posegraph.optimize_pose_graph_pcg(T0, fixed, ei, ej, eT, eS, mesh=object(),
                                               device="cpu")


@pytest.mark.parametrize("n_nodes,pcg", [(60, False), (300, True)])
def test_final_ba_pose_graph_stage_takes_pcg_above_256_nodes(monkeypatch, n_nodes, pcg):
    """A pose-graph-only state (archived keyframes and edges, no
    observations): `final_ba` runs its pose-graph stage on the PCG solver
    above 256 nodes and on the dense solve up to 256, and writes back."""
    T0, _, ei, ej, eT, eS, gt = drifted_circle(n_nodes, np.random.default_rng(1))
    est = _pose_graph_estimator(T0, ei, ej, eT, eS)
    calls = []
    for mod, name in ((dist_posegraph, "optimize_pose_graph_pcg"),
                      (posegraph, "optimize_pose_graph")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, len(a[0])))
            return _real(*a, **(kw | dict(iterations=2)))
        monkeypatch.setattr(mod, name, spy)
    before = np.stack([est.archive_frames[k].T_WS for k in range(n_nodes)])
    est.final_ba(max_nodes=32)
    after = np.stack([est.archive_frames[k].T_WS for k in range(n_nodes)])
    want = "optimize_pose_graph_pcg" if pcg else "optimize_pose_graph"
    assert calls and {c[0] for c in calls} == {want} and calls[0][1] == n_nodes, calls
    err = lambda T: np.linalg.norm(T[:, :3] - np.stack(gt)[:, :3], axis=1).max()  # noqa: E731
    assert err(after) < err(before), (err(after), err(before))


def _pose_graph_estimator(T0, ei, ej, eT, eS):
    """An estimator whose whole state is an archived pose graph."""
    from okvis2x_tpu_torch.cameras import pinhole

    cam = pinhole.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480, device="cpu")
    est = SlidingWindowEstimator(EstimatorConfig(), [cam], np.array([[0, 0, 0, 0, 0, 0, 1.0]]),
                                 device="cpu")
    for k, T in enumerate(T0):
        est.archive_frames[k] = FrameState(fid=k, timestamp=float(k), T_WS=T.copy(),
                                           sb=np.zeros(9), is_keyframe=True,
                                           pose_graph_frame=True)
    est.archive_edges = [dict(i=int(a), j=int(b), T_ij=T, sqrt_info=S)
                         for a, b, T, S in zip(ei, ej, eT, eS)]
    est._next_fid = len(T0)
    return est
