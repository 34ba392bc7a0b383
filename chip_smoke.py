#!/usr/bin/env python3
"""Smoke run of okvis2x_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its `nvidia-smi` name and power limit;
2. builds the Hamming CUDA kernel from csrc/hamming.cu and holds it against
   its plain PyTorch version for exact int32 equality at the per-frame
   association shapes and others, and times both;
3. renders 120 frames (6 s) of the synthetic circuit at the EuRoC operating
   point (752x480 stereo at 20 Hz, 200 Hz IMU, 704 keypoints) in memory and
   feeds them to `VioPipeline` on the GPU: every pose must be finite, the
   kernel must have been launched by the pipeline, and the online position
   ATE must be at most 0.25 m; the first frames are also run on the CPU
   (plain Hamming version) and must agree with the GPU run.

The second-to-last line is a JSON object describing the kernel; the last
line is `{"ok": true, "device": {...}}`.  Any failure raises, and the script
exits non-zero without printing a result.
"""

import json
import subprocess
import sys
import time

import numpy as np

SHAPES = [(1, 1), (37, 53), (257, 513), (704, 704), (704, 1024), (768, 16384)]
TIMED = [(704, 1024), (768, 16384)]
N_FRAMES = 120
ATE_LIMIT_M = 0.25
CPU_FRAMES = 3
CPU_GPU_TOL_M = 1e-3


def random_words(rng, n):
    """(n, 12) int32 words with the all-ones and sign-bit patterns mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.05] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.05] = 0x80000000
    return w.view(np.int32)


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(dev, card):
    """Kernel vs plain version, exact, at every shape; times at TIMED."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    rng = np.random.default_rng(0)
    max_err = 0
    times = {}
    for nq, nd in SHAPES:
        q = torch.from_numpy(random_words(rng, nq)).to(dev)
        d = torch.from_numpy(random_words(rng, nd)).to(dev)
        k = hamming.hamming_matrix_packed(q, d)
        p = hamming.hamming_matrix_plain(q, d)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        if not torch.equal(k, p):
            raise RuntimeError(f"hamming kernel != plain at {nq}x{nd}: max err {err}")
        max_err = max(max_err, err)
        if (nq, nd) == (37, 53):
            qn, dn = q.cpu().numpy().view(np.uint32), d.cpu().numpy().view(np.uint32)
            ref = np.unpackbits((qn[:, None] ^ dn[None]).view(np.uint8), axis=-1)
            if not np.array_equal(k.cpu().numpy(), ref.reshape(nq, nd, -1).sum(-1)):
                raise RuntimeError("hamming kernel != numpy popcount at 37x53")
        if (nq, nd) in TIMED:
            t_k = time_ms(lambda: hamming.hamming_matrix_packed(q, d), 200)
            t_p = time_ms(lambda: hamming.hamming_matrix_plain(q, d), 20)
            t_k2 = time_ms(lambda: hamming.hamming_matrix_packed(q, d), 200)
            times[(nq, nd)] = (min(t_k, t_k2), t_p)
            print(f"hamming {nq}x{nd}: kernel {min(t_k, t_k2):.4f} ms, plain "
                  f"{t_p:.4f} ms ({card})")
        print(f"hamming {nq}x{nd}: kernel == plain, exact")
    if hamming.KERNEL.build_log:
        print("nvcc:", " | ".join(l.strip() for l in hamming.KERNEL.build_log.splitlines()
                                  if "registers" in l or "spill" in l))
    return max_err, times


def run_pipeline(seq, device, n_frames, record_times=False):
    """Feed `n_frames` frames of `seq` to a fresh VioPipeline on `device`."""
    import torch
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline

    c = seq.camera
    cam = pinhole.make_pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                               model=c["model"], dist_params=c["dist_params"],
                               dtype=torch.float64, device=device)
    est_cfg = EstimatorConfig(cap_landmarks=1024, cap_obs=8192, max_iterations=10,
                              early_exit_rel=5e-4)
    vio = VioPipeline([cam, cam], seq.T_SC, est_cfg, PipelineConfig(max_keypoints=704),
                      device=device)
    infos, wall = [], []
    n = 0
    for kind, data in seq.events():
        if kind == "imu":
            vio.add_imu_measurement(*data)
            continue
        if n >= n_frames:
            break
        t0 = time.perf_counter()
        infos.append(vio.process_frame(data[0], data[1]))
        if record_times and device.type == "cuda":
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        n += 1
    return vio, infos, wall


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from okvis2x_tpu_torch.io import synthetic, trajectory_io
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- phase 2: the kernel against its plain version
    t0 = time.perf_counter()
    max_err, times = check_kernel(dev, card)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")

    # ---- phase 3: the main path
    t0 = time.perf_counter()
    seq = synthetic.render_sequence(
        duration=0.3 + N_FRAMES / 20.0, frame_rate=20.0, imu_rate=200.0, width=752,
        height=480, fx=460.0, density=22.0, seed=3, trajectory="circuit", scene_version=2,
    )
    if len(seq.frame_t) < N_FRAMES:
        raise RuntimeError(f"rendered {len(seq.frame_t)} frames, need {N_FRAMES}")
    print(f"rendered {N_FRAMES} frames at 752x480: {time.perf_counter() - t0:.1f} s")

    timing.reset()
    hamming.hamming_matrix_packed.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    vio, infos, wall = run_pipeline(seq, dev, N_FRAMES, record_times=True)
    t_run = time.perf_counter() - t0
    launches = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ts = np.array([s[0] for s in vio.states_log])
    Ts = np.stack([s[1] for s in vio.states_log])
    if len(ts) != N_FRAMES or not np.isfinite(Ts).all():
        raise RuntimeError("non-finite or missing poses on the main path")
    if launches <= 0:
        raise RuntimeError("the main path never launched the Hamming kernel")
    ate = trajectory_io.ate_rmse(ts, Ts[:, :3], seq.gt[:, 0], seq.gt[:, 1:4])
    if ate is None or not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"online ATE {ate} m exceeds {ATE_LIMIT_M} m")
    ms = np.asarray(wall) * 1e3
    counts = np.array([[i["n_map"], i["n_stereo"], i["n_motion"]] for i in infos])
    p50 = np.median(counts, axis=0)
    print(f"main path: {N_FRAMES} frames in {t_run:.1f} s, dtype "
          f"{vio.est.cfg.dtype}, online ATE {ate:.4f} m, ms/frame p50 "
          f"{np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} "
          f"(first frame {ms[0]:.1f}), peak allocated {peak / 2**20:.1f} MiB, "
          f"hamming launches {launches} ({card})")
    print(f"main path counts p50: map {p50[0]:.0f} stereo {p50[1]:.0f} motion "
          f"{p50[2]:.0f}; keyframes {sum(i['is_keyframe'] for i in infos)} ({card})")
    print(timing.report())

    # ---- the same first frames on the CPU (plain Hamming version)
    t0 = time.perf_counter()
    vio_c, _, _ = run_pipeline(seq, torch.device("cpu"), CPU_FRAMES)
    p_cpu = np.stack([s[1][:3] for s in vio_c.states_log])
    gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
    print(f"cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m "
          f"({time.perf_counter() - t0:.1f} s)")
    if not gap <= CPU_GPU_TOL_M:
        raise RuntimeError(f"GPU and CPU runs disagree by {gap} m")

    k704 = times[(704, 1024)]
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix_packed", "route": "cuda",
        "source": "okvis2x_tpu_torch/csrc/hamming.cu",
        "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
        "launches": launches, "max_abs_err": max_err,
        "ms": k704[0], "plain_ms": k704[1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
