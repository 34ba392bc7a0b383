"""The port's flagship pipeline settings (tools/slam_bench.py: the deferred
fused frontend at depth 1, place recognition on the worker thread, the
background optimisation of the history, no pose refinement) against the
JAX package's on the loop-closing circuit of test_torch_lc_slice.py, up to
the closure, then `finish()` and the final BA.

Both runs are held in lockstep (test_torch_async_slice.py): after every
frame the test waits until the recognition worker is idle and the
background optimisation has joined, RANSAC draws what the JAX pipeline
draws, and the JAX pipeline's `_drain_desc` always waits for the descriptor
blocks (its non-blocking check is a race; test_torch_deferred.py)."""

import multiprocessing
import queue
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
from test_torch_async_slice import StepQueue
from test_torch_deferred import drain_waiting
from test_torch_lc_slice import EST, cameras, jax_sample_indices, pin_to_cores, render

torch.set_num_threads(1)

# the closure lands at frame 62 (to keyframe 0): the fewest frames that close it
N_FRAMES = 64
# tools/slam_bench.py's pipeline settings on the frontend of test_torch_lc_slice.py
PIPE = dict(max_keypoints=256, octaves=1, harris_threshold=1e-6, keyframe_match_fraction=0.5,
            do_loop_closures=True, loop_min_gap_s=3.0, async_loop_closure=True,
            pose_refine=False, deferred_frontend=True, pipeline_depth=1)


def _run(pipe, seq):
    infos = []
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
            continue
        if len(infos) == N_FRAMES:
            break
        info = pipe.process_frame(data[0], data[1])
        pipe._lc_queue.join()
        pipe.full_graph.join()
        q = info["tracking_quality"]
        infos.append(dict(counts=[info["n_map"], info["n_stereo"], info["n_motion"]],
                          kf=info["keyframe_fid"], quality=None if q is None else q.name))
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
    return dict(infos=infos, positions=ps, closures=closures, merged=pipe.n_landmarks_merged,
                keyframes=len(ft), ate_online=float(ate_online), ate_final=float(ate_final),
                full_graph=counts)


def jax_run():
    """The JAX pipeline's lockstep run, in a process of its own, on two
    cores."""
    import jax

    pin_to_cores(2)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    queue.Queue = StepQueue
    seq = render()
    pipe = JVioPipeline(cameras(seq, jpin), seq.T_SC, EstimatorConfig(**EST),
                        PipelineConfig(**PIPE))
    return _run(drain_waiting(pipe), seq)


@pytest.fixture(scope="module")
def runs():
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


def test_flagship_lockstep_closures(runs):
    """The same closures as (frame, candidate) pairs, the same keyframes,
    merges and background-optimisation counts."""
    got, ref = runs
    assert ref["closures"] and got["closures"] == ref["closures"], (got["closures"], ref)
    assert got["keyframes"] == ref["keyframes"]
    assert got["merged"] == ref["merged"]
    assert got["full_graph"] == ref["full_graph"] and got["full_graph"]["synchronised"] >= 1


def test_flagship_lockstep_frames(runs):
    """Every frame's reported keyframe, tracking quality and association
    counts equal, and the logged positions within 1e-4 m (measured
    4.8e-8 m; an unconverged window solve can turn relative 1e-7 of its
    inputs into 6e-5 m, test_torch_deferred.py).  Over these 64 frames
    every frame's counts were equal, in this fixture and with the JAX
    reference run in the test process; over 67 the last one differed by
    one map match."""
    got, ref = runs
    assert len(got["infos"]) == len(ref["infos"])
    assert [i["kf"] for i in got["infos"]] == [i["kf"] for i in ref["infos"]]
    assert [i["quality"] for i in got["infos"]] == [i["quality"] for i in ref["infos"]]
    a = np.array([i["counts"] for i in got["infos"]])
    b = np.array([i["counts"] for i in ref["infos"]])
    same = (a == b).all(axis=1)
    assert same.all(), (np.nonzero(~same)[0], a[~same], b[~same])
    gap = float(np.abs(got["positions"] - ref["positions"]).max())
    assert gap < 1e-4, gap


def test_flagship_lockstep_ate(runs):
    """Online and final ATE within 1 mm of the JAX package's, and within
    5 cm of the ground truth."""
    got, ref = runs
    assert abs(got["ate_online"] - ref["ate_online"]) < 1e-3, (got, ref)
    assert abs(got["ate_final"] - ref["ate_final"]) < 1e-3, (got, ref)
    assert got["ate_online"] < 0.05 and got["ate_final"] < 0.05, got
