"""The port's asynchronous SLAM path against the JAX package: both
`VioPipeline`s with the JAX package's default configuration (pose
refinement, pipelined solve, place recognition on a worker thread) plus the
background full graph, on the small circuit of test_torch_lc_slice.py that
closes a loop, then `finish()` and the final BA.

Threads make the order of events depend on timing.  The parity run makes
both packages deterministic from outside, with no change to either: after
every frame it waits until the recognition worker asks for its next item
(a queue whose `get` marks the previous item done, installed before the
worker starts, so `queue.join()` returns then) and until the background
pose graph has joined.  RANSAC draws as in test_torch_lc_slice.py.  A
second, free-running run of the port checks only what holds whatever the
timing."""

import multiprocessing
import queue
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.frontend import ransac
from okvis2x_tpu_torch.io import trajectory_io
from okvis2x_tpu_torch.pipeline.vio import VioPipeline
from test_torch_lc_slice import EST, cameras, jax_sample_indices, pin_to_cores, render

torch.set_num_threads(1)

# the JAX defaults (async_place_recognition, pose_refine, pipelined_solve)
# with the background full graph and the frontend of test_torch_lc_slice.py
PIPE = dict(max_keypoints=256, octaves=1, harris_threshold=1e-6, keyframe_match_fraction=0.5,
            do_loop_closures=True, loop_min_gap_s=3.0, async_loop_closure=True)
FREE_FRAMES = 12
FINISH_LIMIT_S = 120.0


class StepQueue(queue.Queue):
    """A queue whose consumer marks an item done when it asks for the next
    one: `join()` returns once the consumer is idle."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._taken = False

    def get(self, block=True, timeout=None):
        if self._taken:
            self._taken = False
            self.task_done()
        item = super().get(block, timeout)
        self._taken = True
        return item


def _run(pipe, seq):
    """The lockstep run: after each frame, wait for the idle worker and the
    joined background optimisation."""
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
            continue
        pipe.process_frame(data[0], data[1])
        pipe._lc_queue.join()
        pipe.full_graph.join()
    pipe.finish()
    ts = np.array([s[0] for s in pipe.states_log])
    ps = np.stack([s[1][:3] for s in pipe.states_log])
    ate_online = trajectory_io.ate_rmse(ts, ps, seq.gt[:, 0], seq.gt[:, 1:4])
    fg = pipe.full_graph
    counts = dict(dispatched=fg.n_dispatched, synchronised=fg.n_synchronised,
                  stale=fg.n_stale_discarded)
    pipe.est.final_ba()
    ft, fT = pipe.est.full_trajectory()
    ate_final = trajectory_io.ate_rmse(ft, fT[:, :3], seq.gt[:, 0], seq.gt[:, 1:4])
    closures = sorted((int(e["j"]), int(e["i"])) for e in pipe.est.archive_edges
                      if e.get("loop"))
    return dict(closures=closures, merged=pipe.n_landmarks_merged, keyframes=len(ft),
                ate_online=float(ate_online), ate_final=float(ate_final), full_graph=counts)


def jax_run():
    """The JAX pipeline's lockstep run, in a process of its own (a fresh
    interpreter: the CPU platform and float64 are set here), on two cores."""
    import jax

    pin_to_cores(1)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    queue.Queue = StepQueue
    seq = render()
    return _run(JVioPipeline(cameras(seq, jpin), seq.T_SC, EstimatorConfig(**EST),
                             PipelineConfig(**PIPE)), seq)


@pytest.fixture(scope="module")
def runs():
    """The lockstep runs of both packages at once: the JAX pipeline in a
    spawned process, the port in this one."""
    seq = render()
    est_cfg = convert.estimator_config(EstimatorConfig(**EST))
    pipe_cfg = convert.pipeline_config(PipelineConfig(**PIPE))
    ctx = multiprocessing.get_context("spawn")
    with pytest.MonkeyPatch.context() as mp, ProcessPoolExecutor(1, mp_context=ctx) as pool:
        ref = pool.submit(jax_run)
        mp.setattr(ransac, "sample_indices", jax_sample_indices)
        mp.setattr(queue, "Queue", StepQueue)
        got = _run(VioPipeline(cameras(seq, pinhole), seq.T_SC, est_cfg, pipe_cfg,
                               device="cpu"), seq)
        return got, ref.result(timeout=1200)


def test_async_slice_same_closures(runs):
    """The same closures as (frame, candidate) pairs, the same keyframes,
    and the background full graph synchronised at least once in both."""
    got, ref = runs
    assert ref["closures"] and got["closures"] == ref["closures"], (got, ref)
    assert got["keyframes"] == ref["keyframes"], (got, ref)
    assert got["full_graph"]["synchronised"] >= 1, got
    assert got["full_graph"] == ref["full_graph"], (got, ref)


def test_async_slice_merges(runs):
    """Merged-landmark counts within 10% of each other.  (Under this
    configuration the closure lands on keyframe 0 and both packages merge
    no landmark there.)"""
    got, ref = runs
    assert abs(got["merged"] - ref["merged"]) <= 0.1 * ref["merged"], (got, ref)


def test_async_slice_ate(runs):
    """Online and final ATE within 1 cm of the JAX package's, and the final
    trajectory within 5 cm of the ground truth."""
    got, ref = runs
    assert abs(got["ate_online"] - ref["ate_online"]) < 0.01, (got, ref)
    assert abs(got["ate_final"] - ref["ate_final"]) < 0.01, (got, ref)
    assert got["ate_final"] < 0.05, got


def test_async_slice_free_running():
    """The port on its own, threads left to their timing, over the first
    frames of the circuit: `finish()` returns within its limit and stops the
    worker and the background optimisation, every logged pose is finite and
    the online ATE stays within 0.25 m."""
    seq = render()
    pipe = VioPipeline(cameras(seq, pinhole), seq.T_SC, convert.estimator_config(
        EstimatorConfig(**EST)), convert.pipeline_config(PipelineConfig(**PIPE)), device="cpu")
    worker = pipe._lc_thread
    n = 0
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
            continue
        if n == FREE_FRAMES:
            break
        pipe.process_frame(data[0], data[1])
        n += 1
    t0 = time.perf_counter()
    pipe.finish()
    assert time.perf_counter() - t0 < FINISH_LIMIT_S
    assert not worker.is_alive() and pipe._lc_thread is None
    assert not pipe.full_graph.is_loop_closing
    ts = np.array([s[0] for s in pipe.states_log])
    Ts = np.stack([s[1] for s in pipe.states_log])
    assert len(ts) == FREE_FRAMES and np.isfinite(Ts).all()
    assert trajectory_io.ate_rmse(ts, Ts[:, :3], seq.gt[:, 0], seq.gt[:, 1:4]) <= 0.25
