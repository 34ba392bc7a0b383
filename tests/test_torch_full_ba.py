"""The background complete-factor-graph BA (`full_ba_threshold`) of the
port against the JAX package: `snapshot_full_ba`, the solve on the
`FullGraphOptimizer`'s worker and `apply_full_ba_result`, from one
converted state with observations (the VIO simulation of
tests/test_estimator.py), and the discarding of a stale result.

The JAX package pins the problem's capacities (`FULL_BA_PIN`) to reuse one
XLA compile; the port pads to the content's buckets.  Up to the 64-node
threshold both take the inverse branch of the reduced solve, and the
results agree to rounding."""

import numpy as np
import pytest
import torch

from okvis2x_tpu.graph.fullgraph import FullGraphOptimizer as JFullGraphOptimizer
from okvis2x_tpu_torch.graph.fullgraph import FullGraphOptimizer
from test_torch_final_ba import jax_copy, vio_state  # noqa: F401 — the module's fixture
from test_torch_fullgraph import JOIN_TIMEOUT_S
from test_torch_loopclosure import port_of

torch.set_num_threads(1)

TOL = 1e-8
# LM iterations of the parity solve: the JAX package's pinned problem (16384
# observation rows, 64 nodes) is its slowest CPU program; 5 iterations keep
# the test inside the suite's budget (the pipeline's default is 15)
ITERATIONS = 5


def state_of(est):
    """Poses and speed/biases of every node (window and archive) by frame
    id, and landmarks (live and archived) by id."""
    frames = {f.fid: f for f in est.frames} | {int(k): f for k, f in est.archive_frames.items()}
    lms = {int(l): np.asarray(est.hp_W[i], np.float64) for i, l in enumerate(est.lm_ids)}
    lms |= {int(k): np.asarray(v, np.float64) for k, v in est.arch_lm.items()}
    return ({k: (np.asarray(f.T_WS, np.float64), np.asarray(f.sb, np.float64))
             for k, f in frames.items()}, lms)


def assert_states_close(a, b, tol):
    (fa, la), (fb, lb) = a, b
    assert sorted(fa) == sorted(fb) and sorted(la) == sorted(lb)
    for k in fa:
        np.testing.assert_allclose(fa[k][0], fb[k][0], rtol=0, atol=tol)
        np.testing.assert_allclose(fa[k][1], fb[k][1], rtol=0, atol=tol)
    for k in la:
        np.testing.assert_allclose(la[k], lb[k], rtol=0, atol=tol)


def run_background(opt, est):
    assert opt.dispatch(est)
    assert opt.join(timeout=JOIN_TIMEOUT_S) and not opt.is_loop_closing
    return opt


def test_full_ba_matches_jax(vio_state):  # noqa: F811
    """Both optimisers at their default threshold (64) take the full BA on
    the 5 s simulation's history: the same nodes, then after the
    synchronisation every pose, speed/bias and landmark within 1e-8 of the
    JAX package's, both counted as a full BA."""
    jest = jax_copy(vio_state[0])
    test = port_of(jest)
    n_nodes = len(test.pose_graph()[0])
    assert 2 < n_nodes <= 64
    jopt = JFullGraphOptimizer(iterations=ITERATIONS, dtype=jest.cfg.dtype)
    topt = FullGraphOptimizer(iterations=ITERATIONS, dtype=test.cfg.dtype)
    assert topt.full_ba_threshold == jopt.full_ba_threshold == 64
    before = state_of(test)
    run_background(jopt, jest)
    run_background(topt, test)
    assert topt.is_loop_closure_available and jopt.is_loop_closure_available
    assert topt._full_snap["aux"]["fids"] == [int(f) for f in jopt._full_snap["aux"]["fids"]]
    assert topt.synchronise(test) and jopt.synchronise(jest)
    for opt in (topt, jopt):
        assert (opt.n_dispatched, opt.n_synchronised, opt.n_full_ba, opt.n_stale_discarded) == (
            1, 1, 1, 0)
    assert test.correction_epoch == jest.correction_epoch
    after = state_of(test)
    assert_states_close(after, state_of(jest), TOL)
    moved = max(np.abs(after[0][k][0] - before[0][k][0]).max() for k in after[0])
    assert moved > 1e-4  # the solve did move the history


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stale_full_ba_discarded(vio_state, package):  # noqa: F811
    """A correction between the snapshot and the synchronisation (the
    epoch moves) makes the full result stale in both packages: discarded,
    the state untouched, and the next dispatch applies.  (The JAX
    estimator's capacities are left unpinned here, which makes its CPU
    solve several times faster; test_full_ba_matches_jax keeps them.)"""
    jest = jax_copy(vio_state[0])
    jest.FULL_BA_PIN = None
    est, opt = ((jest, JFullGraphOptimizer(iterations=15, dtype=jest.cfg.dtype))
                if package == "jax" else
                (port_of(jest), FullGraphOptimizer(iterations=15, dtype=torch.float64)))
    run_background(opt, est)
    est.correction_epoch += 1
    frozen = state_of(est)
    assert not opt.synchronise(est)
    assert (opt.n_stale_discarded, opt.n_synchronised, opt.n_full_ba) == (1, 0, 0)
    assert not opt.is_loop_closure_available
    assert_states_close(state_of(est), frozen, 0.0)
    run_background(opt, est)
    assert opt.synchronise(est) and opt.n_full_ba == 1
