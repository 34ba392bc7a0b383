"""The port's loop-closure slice against the JAX package: both
`VioPipeline`s with synchronous loop closure on a small circuit that closes
a loop, then `finish()` and the final BA.

The JAX package draws its RANSAC hypotheses from `jax.random`, which torch
cannot reproduce, and a closure whose inlier count sits near the threshold
is accepted or not by the draw.  So the port's sampler is replaced here by
the JAX package's `_sample_indices` under the keys the JAX pipeline uses
(frame id + candidate slot): both pipelines then verify the same
hypotheses, and the comparison isolates everything else on the path."""

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.frontend import ransac as jransac
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.frontend import ransac
from okvis2x_tpu_torch.io import synthetic, trajectory_io
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

torch.set_num_threads(1)

# A 0.8 m circle at 1 rad/s mean yaw rate.  speed_mod = -w / wm (wm =
# 2 pi 0.07) starts the body at rest, as the estimator's stationary
# initialisation assumes.  The lap ends near 6.2 s: on the revisit, frame
# 63 (of 67) closes a loop to keyframe 1 and merges 32 landmarks.
TRAJ = dict(radius=0.8, speed=0.8, speed_mod=-1.0 / (2 * np.pi * 0.07))
DURATION = 7.0
# the configuration of tests/test_torch_slice.py with 3 LM iterations
# instead of 5, which keeps both runs inside the suite's time budget
EST = dict(num_keyframes=4, num_imu_frames=3, cap_frames=10, cap_landmarks=512, cap_obs=4096,
           cap_imu_links=9, cap_imu_samples=128, max_iterations=3, keypoint_sigma_px=1.0)
PIPE = dict(max_keypoints=256, octaves=1, harris_threshold=1e-6, keyframe_match_fraction=0.5,
            do_loop_closures=True, async_place_recognition=False, async_loop_closure=False,
            loop_min_gap_s=3.0, deferred_frontend=False, pipelined_solve=False,
            pose_refine=False)


def render():
    return synthetic.render_sequence(duration=DURATION, frame_rate=10.0, width=320, height=240,
                                     trajectory="circuit", traj_kwargs=TRAJ)


def jax_sample_indices(generator, n_hyp, sample_size, n, device=None):
    """The port's sampler drawing what the JAX pipeline draws: the port
    seeds its generator with the frame id, the JAX pipeline keys candidate
    slot b with PRNGKey(frame id + b)."""
    fid = generator.initial_seed()
    n = jnp.asarray(np.asarray(n))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n.shape[0], dtype=jnp.uint32)
                                        + jnp.uint32(fid))
    idx = jax.vmap(lambda k, m: jransac._sample_indices(k, n_hyp, sample_size, m))(keys, n)
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def pin_to_cores(slot: int, n: int = 2):
    """Run this process, every thread it has and every thread it starts
    later, on `n` cores of its own (`slot` picks which: the last n, the n
    before, ...).  The spawned JAX reference runs XLA's CPU thread pool at
    the width of its affinity, and its idle threads spin: alone on an
    8-core host this file's reference took 567 s of CPU time in 143 s at
    the full width, and 268 s in 156 s on 2 cores, with the same closures
    and ATEs to 1e-10; beside the suite's workers the spinning took their
    cores.  Call it before JAX's first computation."""
    cores = sorted(os.sched_getaffinity(0))
    pick = set(cores[-n * (slot + 1):][:n]) or set(cores)
    for tid in os.listdir("/proc/self/task"):
        os.sched_setaffinity(int(tid), pick)


def run_cache_dir(tmp_path_factory):
    """The persistent compile cache of this test run's spawned JAX
    processes: a directory under the run's base temporary directory (the
    xdist workers' own lie in it), so that it starts cold with every run
    and the references and apps spawned within one run compile each XLA
    program once between them."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "jax_cache"
    path.mkdir(exist_ok=True)
    return str(path)


def use_compile_cache(cache_dir):
    """Give this spawned reference the run's persistent compile cache
    `cache_dir` (`run_cache_dir`), with tests/conftest.py's thresholds."""
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


def _run(pipe, seq):
    closures = []
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
            continue
        info = pipe.process_frame(data[0], data[1])
        if info["loop_closure"]:
            closures.append(info["fid"])
    pipe.finish()
    ts = np.array([s[0] for s in pipe.states_log])
    ps = np.stack([s[1][:3] for s in pipe.states_log])
    ate_online = trajectory_io.ate_rmse(ts, ps, seq.gt[:, 0], seq.gt[:, 1:4])
    pipe.est.final_ba()
    ft, fT = pipe.est.full_trajectory()
    ate_final = trajectory_io.ate_rmse(ft, fT[:, :3], seq.gt[:, 0], seq.gt[:, 1:4])
    loops = {int(e["j"]): int(e["i"]) for e in pipe.est.archive_edges if e.get("loop")}
    return dict(closures=[(f, loops.get(f)) for f in closures], merged=pipe.n_landmarks_merged,
                keyframes=len(ft), ate_online=float(ate_online), ate_final=float(ate_final))


def cameras(seq, pinhole_module):
    c = seq.camera
    cam = pinhole_module.make_pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                                      c["height"], model=c["model"],
                                      dist_params=c["dist_params"])
    return [cam, cam]


def jax_run(cache_dir=None):
    """The JAX pipeline's run, in a process of its own (a fresh interpreter:
    the CPU platform, float64 and the compile cache `cache_dir` are set here,
    as tests/conftest.py sets them for the test process), on two cores."""
    pin_to_cores(0)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    use_compile_cache(cache_dir)
    seq = render()
    return _run(JVioPipeline(cameras(seq, jpin), seq.T_SC, EstimatorConfig(**EST),
                             PipelineConfig(**PIPE)), seq)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The slice with synchronous loop closure on, run by both packages at
    once: the JAX pipeline in a spawned process, the port in this one."""
    seq = render()
    est_cfg = convert.estimator_config(EstimatorConfig(**EST))
    pipe_cfg = convert.pipeline_config(PipelineConfig(**PIPE))
    ctx = multiprocessing.get_context("spawn")
    with pytest.MonkeyPatch.context() as mp, ProcessPoolExecutor(1, mp_context=ctx) as pool:
        ref = pool.submit(jax_run, run_cache_dir(tmp_path_factory))
        mp.setattr(ransac, "sample_indices", jax_sample_indices)
        got = _run(VioPipeline(cameras(seq, pinhole), seq.T_SC, est_cfg, pipe_cfg,
                               device="cpu"), seq)
        return got, ref.result(timeout=1200)


def test_loop_closure_slice_same_closures(runs):
    """The same closures as (frame, candidate) pairs and the same keyframes."""
    got, ref = runs
    assert ref["closures"] and got["closures"] == ref["closures"], (got, ref)
    assert got["keyframes"] == ref["keyframes"], (got, ref)


def test_loop_closure_slice_merges(runs):
    """Merged-landmark counts within 10%, and the closure merged some."""
    got, ref = runs
    assert ref["merged"] > 0 and abs(got["merged"] - ref["merged"]) <= 0.1 * ref["merged"], (
        got, ref)


def test_loop_closure_slice_ate(runs):
    """Online and final ATE within 1 cm of each other, and the final
    trajectory within 5 cm of the ground truth."""
    got, ref = runs
    assert abs(got["ate_online"] - ref["ate_online"]) < 0.01, (got, ref)
    assert abs(got["ate_final"] - ref["ate_final"]) < 0.01, (got, ref)
    assert got["ate_final"] < 0.05, got
