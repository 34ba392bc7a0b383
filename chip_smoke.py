#!/usr/bin/env python3
"""Smoke run of okvis2x_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires a CUDA device and prints its `nvidia-smi` name and power limit;
2. builds the two Hamming CUDA kernels (csrc/hamming.cu, the distance matrix,
   and csrc/hamming_match.cu, the fused match) into one library and holds
   each against its plain PyTorch version for exact equality: the matrix at
   nine shapes, the fused match in the form of every site that calls it
   (matcher fills with a random mask, mutual check, 385 fills, segments with
   column argmins and an empty candidate, per-row segments, ragged edges),
   on inputs with duplicated rows so that ties occur;
3. times both kernels at the main path's shapes: the device time of a launch
   (100 launches captured in a CUDA graph, the replay timed with CUDA
   events), the time of a Python call, the plain version, one library
   formulation (a bfloat16 matmul of the +-1 descriptors, unpacked before
   the clock starts) and the bound (the larger of bytes over the memory rate
   and popcounts over the card's popcount rate); and two whole sites,
   `matcher.match_masked` at 704x1024 and `bow.assign_packed` at 704
   descriptors, as they were composed on the matrix kernel and as they are;
4. VIO: renders 40 frames (2 s) of the synthetic circuit at the EuRoC
   operating point (752x480 stereo at 20 Hz, 200 Hz IMU, 704 keypoints) in
   memory and feeds them to `VioPipeline` on the GPU: every pose must be
   finite, the fused kernel must have been launched 4 times a frame, and the
   online position ATE must be at most 0.25 m; the first frames are also run
   on the CPU (plain versions) and must agree with the GPU run;
5. ratio-test matching: the cam-0 descriptors of the last two frames of that
   run through `matcher.match` with Lowe's ratio test and the mutual check,
   the caller that wants the distance matrix: the matrix kernel must have
   been launched and the matches must equal the CPU's;
6. loop closure: the same operating point on a circuit of radius 2 m (one
   lap in about 230 frames) with synchronous loop closure (BoW place
   recognition on the shipped vocabulary, loop matching, non-central RANSAC,
   pose-graph solve), then `finish()` and the final BA: at least one closure
   must be accepted, the fused kernel must have been launched from the
   vocabulary descent and the loop matching, every pose must be finite, and
   the online and final ATE must both be at most 0.25 m.

The second-to-last line is a JSON object describing the kernels; the last
line is `{"ok": true, "device": {...}}`.  Any failure raises, and the script
exits non-zero without printing a result.
"""

import json
import subprocess
import sys
import time

import numpy as np

# association (704x704, 704x1024), vocabulary branches and leaves (704x64,
# 704x4096), loop matching against three candidates (704x2112)
SHAPES = [(1, 1), (37, 53), (257, 513), (704, 64), (704, 704), (704, 1024), (704, 2112),
          (704, 4096), (768, 16384)]
TIMED = [(704, 64), (704, 704), (704, 1024), (704, 2112), (704, 4096), (768, 16384)]
MEMORY_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# NVIDIA's table of arithmetic instruction throughput, compute capability 9.0
POPC_PER_CLOCK_PER_SM = 16
GRAPH_LAUNCHES = 100
N_FRAMES = 40
LC_FRAMES = 260
LC_RADIUS_M = 2.0
ATE_LIMIT_M = 0.25
CPU_FRAMES = 3
CPU_GPU_TOL_M = 1e-3


def random_words(rng, n):
    """(n, 12) int32 words with the all-ones and sign-bit patterns mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.05] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.05] = 0x80000000
    return w.view(np.int32)


def tied_words(rng, nq, nd):
    """Queries and a database with duplicated rows on both sides and shared
    rows between them, so that ties occur on both axes."""
    q, d = random_words(rng, nq), random_words(rng, nd)
    d[nd // 2:nd // 2 + nd // 8] = d[:nd // 8]
    q[nq // 2:nq // 2 + nq // 8] = q[:nq // 8]
    q[:min(nq, nd) // 4] = d[:min(nq, nd) // 4]
    return q, d


def time_ms(fn, reps):
    """Time of a Python call of `fn`, CUDA events around `reps` calls."""
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


def device_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Device time of one call of `fn`: `launches` calls captured in a CUDA
    graph, the replay timed with CUDA events (no host work between the
    kernels); the median of `replays`.  Every capture uses one stream, so
    that cuBLAS keeps one workspace for the library yardstick and not one a
    capture."""
    import torch

    if device_ms.stream is None:
        device_ms.stream = torch.cuda.Stream()
    side = device_ms.stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the stream the first call ran on
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


device_ms.stream = None


def popc_per_s():
    """The card's popcount rate: 16 a clock on each SM at the maximum SM clock."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * mhz * 1e6, sms, mhz


def bound(n_bytes, n_popc, rate):
    """(bound in ms, what sets it): bytes once over the memory rate against
    popcounts over the popcount rate."""
    t_bytes, t_ops = n_bytes / MEMORY_BYTES_PER_S, n_popc / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def unpack_pm1(packed):
    """(N, 384) bfloat16 +-1 rows of packed descriptors (the JAX matcher's
    operands), for the library yardstick only."""
    import torch

    bits = (packed[:, :, None] >> torch.arange(32, device=packed.device)) & 1
    return (bits.reshape(packed.shape[0], -1) * 2 - 1).to(torch.bfloat16)


def match_forms(rng, dev):
    """The fused kernel's call in the form of each site, as (name, q, vq, d,
    vd, keywords)."""
    import torch

    def flags(n, p=0.15):
        return torch.from_numpy(rng.random(n) > p).to(dev)

    def make(nq, nd, validity=True, allowed=False, row_seg=None, **kw):
        q, d = (torch.from_numpy(x).to(dev) for x in tied_words(rng, nq, nd))
        vq, vd = (flags(nq), flags(nd)) if validity else (None, None)
        if allowed:
            kw["allowed"] = torch.from_numpy(rng.random((nq, nd)) > 0.4).to(dev)
        if row_seg:
            kw["row_seg"] = torch.from_numpy(
                rng.integers(0, nd // kw["seg"], nq).astype(np.int32)).to(dev)
        return q, vq, d, vd, kw

    matcher_fills = dict(fill_invalid=192, fill_disallowed=384)
    forms = [
        ("stereo 704x704", *make(704, 704, allowed=True, **matcher_fills)),
        ("map matching 704x1024", *make(704, 1024, allowed=True, **matcher_fills)),
        ("motion stereo, mutual 704x704",
         *make(704, 704, allowed=True, want_cols=True, **matcher_fills)),
        ("mutual, 385 fills 300x700", *make(300, 700, fill_invalid=385, want_cols=True)),
        ("loop matching, 3 segments 704x2112",
         *make(704, 2112, seg=704, fill_invalid=10 ** 9, want_cols=True)),
        ("vocabulary branches 704x64", *make(704, 64, validity=False)),
        ("vocabulary leaves, row_seg 704x4096",
         *make(704, 4096, validity=False, seg=64, row_seg=True)),
        ("all leaves 704x4096", *make(704, 4096, validity=False)),
        ("one cell 1x1", *make(1, 1, allowed=True, want_cols=True, **matcher_fills)),
        ("ragged 37x53", *make(37, 53, allowed=True, want_cols=True, **matcher_fills)),
        ("ragged, unaligned mask 257x513",
         *make(257, 513, allowed=True, seg=171, want_cols=True, fill_invalid=600,
               fill_disallowed=600)),
        ("ragged, row_seg 257x513", *make(257, 513, seg=27, row_seg=True, fill_invalid=385)),
        ("large 768x16384", *make(768, 16384, fill_invalid=385, want_cols=True)),
    ]
    forms[4][4][704:1408] = False  # the second loop candidate is an empty slot
    return forms


def matrix_bytes_popc(nq, nd):
    return 48 * (nq + nd) + 4 * nq * nd, 12 * nq * nd


def match_bytes_popc(q, vq, d, vd, kw):
    """Bytes the fused call must move (inputs once, outputs once) and the
    popcounts it needs on these inputs."""
    nq, nd = q.shape[0], d.shape[0]
    seg = kw.get("seg") or nd
    n_bytes = 48 * nq + (0 if vq is None else nq) + (0 if vd is None else nd)
    if "row_seg" in kw:  # a row reads only its segment
        rows = int(kw["row_seg"].unique().numel()) * seg
        return n_bytes + 48 * rows + 4 * nq + 12 * nq, 12 * nq * seg
    n_bytes += 48 * nd + (nq * nd if "allowed" in kw else 0)
    n_bytes += 12 * nq * (nd // seg) + (8 * nd if kw.get("want_cols") else 0)
    return n_bytes, 12 * nq * nd


def check_kernels(dev, card):
    """Both kernels against their plain versions, exactly; then their times
    at the TIMED shapes.  Returns {kernel name: entry of the `kernels` line}."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    rng = np.random.default_rng(0)
    rate, sms, mhz = popc_per_s()
    print(f"popcount rate {rate:.3e}/s ({POPC_PER_CLOCK_PER_SM} a clock x {sms} SMs x "
          f"{mhz:.0f} MHz), memory {MEMORY_BYTES_PER_S:.3e} B/s")

    # ---- the matrix kernel
    matrix_err = 0
    for nq, nd in SHAPES:
        q = torch.from_numpy(random_words(rng, nq)).to(dev)
        d = torch.from_numpy(random_words(rng, nd)).to(dev)
        k = hamming.hamming_matrix_packed(q, d)
        p = hamming.hamming_matrix_plain(q, d)
        torch.cuda.synchronize()
        err = int((k.to(torch.int64) - p.to(torch.int64)).abs().max())
        if not torch.equal(k, p):
            raise RuntimeError(f"hamming kernel != plain at {nq}x{nd}: max err {err}")
        matrix_err = max(matrix_err, err)
        if (nq, nd) == (37, 53):
            qn, dn = q.cpu().numpy().view(np.uint32), d.cpu().numpy().view(np.uint32)
            ref = np.unpackbits((qn[:, None] ^ dn[None]).view(np.uint8), axis=-1)
            if not np.array_equal(k.cpu().numpy(), ref.reshape(nq, nd, -1).sum(-1)):
                raise RuntimeError("hamming kernel != numpy popcount at 37x53")
        print(f"hamming matrix {nq}x{nd}: kernel == plain, exact")
    if hamming.KERNEL.build_log:
        print("nvcc:", " | ".join(l.strip() for l in hamming.KERNEL.build_log.splitlines()
                                  if "registers" in l or "spill" in l))

    # ---- the fused match kernel, in each site's form
    match_err = 0
    forms = match_forms(rng, dev)
    for name, q, vq, d, vd, kw in forms:
        got = hamming.hamming_match(q, vq, d, vd, **kw)
        ref = hamming.hamming_match_plain(q, vq, d, vd, **kw)
        torch.cuda.synchronize()
        for what, g, r in zip(("row_min", "row_arg", "col_arg"), got, ref):
            if g is None and r is None:
                continue
            err = int((g.to(torch.int64) - r.to(torch.int64)).abs().max())
            match_err = max(match_err, err)
            if g.dtype != r.dtype or not torch.equal(g, r):
                raise RuntimeError(f"hamming match != plain ({name}): {what} max err {err}")
        print(f"hamming match, {name}: kernel == plain, exact"
              + (" (minima of 1e9 present)" if int(got[0].max()) == 10 ** 9 else ""))

    # ---- times.  The library yardstick is the JAX matcher's formulation:
    # one bf16 matmul of the +-1 rows, then (384 - dot) / 2 (and one min over
    # the rows for the match); the unpacking is done before the clock starts.
    entries = {}
    by_name = {f[0]: f[1:] for f in forms}
    timed_forms = {
        (704, 64): "vocabulary branches 704x64", (704, 704): "motion stereo, mutual 704x704",
        (704, 1024): "map matching 704x1024", (704, 2112): "loop matching, 3 segments 704x2112",
        (704, 4096): "all leaves 704x4096", (768, 16384): "large 768x16384",
    }
    rows = [("matrix", shape, None) for shape in TIMED]
    rows += [("match", shape, timed_forms[shape]) for shape in TIMED]
    rows.append(("match", (704, 4096), "vocabulary leaves, row_seg 704x4096"))
    print(f"times in ms on {card}; device = one of {GRAPH_LAUNCHES} launches in a CUDA graph, "
          "call = a Python call, share = bound / device")
    for kind, (nq, nd), form in rows:
        if kind == "matrix":
            q = torch.from_numpy(random_words(rng, nq)).to(dev)
            d = torch.from_numpy(random_words(rng, nd)).to(dev)
            run = lambda: hamming.hamming_matrix_packed(q, d)  # noqa: E731
            plain = lambda: hamming.hamming_matrix_plain(q, d)  # noqa: E731
            n_bytes, n_popc = matrix_bytes_popc(nq, nd)
            label = f"hamming matrix {nq}x{nd}"
        else:
            q, vq, d, vd, kw = by_name[form]
            run = lambda: hamming.hamming_match(q, vq, d, vd, **kw)  # noqa: E731
            plain = lambda: hamming.hamming_match_plain(q, vq, d, vd, **kw)  # noqa: E731
            n_bytes, n_popc = match_bytes_popc(q, vq, d, vd, kw)
            label = f"hamming match, {form}"
        a, b = unpack_pm1(q), unpack_pm1(d).T.contiguous()
        if kind == "matrix":
            lib = lambda: (384 - torch.matmul(a, b)) / 2  # noqa: E731
        else:
            lib = lambda: torch.min((384 - torch.matmul(a, b)) / 2, dim=1)  # noqa: E731
        t_dev = device_ms(run)
        t_call = time_ms(run, 200)
        t_plain = time_ms(plain, 10)
        t_lib = device_ms(lib)
        t_dev = min(t_dev, device_ms(run))
        t_call = min(t_call, time_ms(run, 200))
        t_bound, by = bound(n_bytes, n_popc, rate)
        print(f"{label}: device {t_dev:.5f}, call {t_call:.5f}, plain {t_plain:.4f}, library "
              f"{t_lib:.5f}, bound {t_bound:.5f} ({by}), share {100 * t_bound / t_dev:.1f}%")
        if (nq, nd) == (704, 1024):  # the shape of the `kernels` line
            entries[kind] = dict(ms=t_call, device_ms=t_dev, plain_ms=t_plain, bound_ms=t_bound,
                                 bound_by=by, library_ms=t_lib)
    entries["matrix"]["max_abs_err"] = matrix_err
    entries["match"]["max_abs_err"] = match_err
    return entries


def match_masked_on_matrix(packed_a, valid_a, packed_b, valid_b, allowed):
    """`matcher.match_masked` as it was composed on the matrix kernel: kept
    here for the comparison of the site's time only."""
    import torch
    from okvis2x_tpu_torch.frontend import matcher

    D = matcher.hamming_matrix(packed_a, valid_a, packed_b, valid_b)
    D = torch.where(allowed, D, torch.full_like(D, float(matcher.DESC_BITS)))
    idx = torch.argmin(D, dim=1)
    d1 = torch.gather(D, 1, idx[:, None])[:, 0]
    return idx, d1, d1 <= 60.0


def assign_packed_on_matrix(packed, valid, vocab):
    """`bow.assign_packed` as it was composed on the matrix kernel: kept here
    for the comparison of the site's time only."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    d1 = hamming.hamming_matrix_packed(packed, vocab.branches)
    b = torch.argmin(d1, dim=1)
    d2 = hamming.hamming_matrix_packed(packed, vocab.leaves)
    leaf_branch = torch.arange(d2.shape[1], device=d2.device) // vocab.L
    d2 = torch.where(leaf_branch[None, :] == b[:, None], d2,
                     torch.full_like(d2, hamming.DESC_BITS + 1))
    w = torch.argmin(d2, dim=1)
    return torch.where(valid, w, torch.zeros_like(w))


def time_sites(dev, card):
    """The two sites as a whole, composed on the matrix kernel (before) and
    on the fused kernel (after): same results, device and Python-call time."""
    import torch
    from okvis2x_tpu_torch.frontend import bow, matcher

    rng = np.random.default_rng(1)
    q, d = (torch.from_numpy(x).to(dev) for x in tied_words(rng, 704, 1024))
    vq = torch.from_numpy(rng.random(704) > 0.15).to(dev)
    vd = torch.from_numpy(rng.random(1024) > 0.15).to(dev)
    allowed = torch.from_numpy(rng.random((704, 1024)) > 0.4).to(dev)
    vocab = bow.HierVocabulary.load(device=dev)
    sites = {
        "matcher.match_masked 704x1024": (
            lambda: match_masked_on_matrix(q, vq, d, vd, allowed),
            lambda: tuple(matcher.match_masked(q, vq, d, vd, allowed, max_dist=60.0))),
        "bow.assign_packed 704": (
            lambda: (assign_packed_on_matrix(q, vq, vocab),),
            lambda: (bow.assign_packed(q, vq, vocab),)),
    }
    for name, (before, after) in sites.items():
        for x, y in zip(before(), after()):
            if x.dtype != y.dtype or not torch.equal(x, y):
                raise RuntimeError(f"{name}: the fused composition differs from the old one")
        t = [device_ms(before), device_ms(after), device_ms(after), device_ms(before)]
        c = [time_ms(before, 100), time_ms(after, 100), time_ms(after, 100),
             time_ms(before, 100)]
        print(f"site {name}: on the matrix kernel device {min(t[0], t[3]):.5f} ms, call "
              f"{min(c[0], c[3]):.5f} ms; on the fused kernel device {min(t[1], t[2]):.5f} ms, "
              f"call {min(c[1], c[2]):.5f} ms; same results ({card})")


def render(n_frames, **traj_kwargs):
    """`n_frames` frames of the circuit at the EuRoC operating point."""
    from okvis2x_tpu_torch.io import synthetic

    seq = synthetic.render_sequence(
        duration=0.3 + n_frames / 20.0, frame_rate=20.0, imu_rate=200.0, width=752,
        height=480, fx=460.0, density=22.0, seed=3, trajectory="circuit", scene_version=2,
        traj_kwargs=traj_kwargs,
    )
    if len(seq.frame_t) < n_frames:
        raise RuntimeError(f"rendered {len(seq.frame_t)} frames, need {n_frames}")
    return seq


def run_pipeline(seq, device, n_frames, record_times=False, loop_closure=False):
    """Feed `n_frames` frames of `seq` to a fresh VioPipeline on `device`
    (with synchronous loop closure when `loop_closure`)."""
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
    pipe_cfg = PipelineConfig(max_keypoints=704, do_loop_closures=loop_closure,
                              async_place_recognition=False, async_loop_closure=False)
    vio = VioPipeline([cam, cam], seq.T_SC, est_cfg, pipe_cfg, device=device)
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


def check_positions(vio, n_frames, what):
    ts = np.array([s[0] for s in vio.states_log])
    Ts = np.stack([s[1] for s in vio.states_log])
    if len(ts) != n_frames or not np.isfinite(Ts).all():
        raise RuntimeError(f"non-finite or missing poses on the {what} path")
    return ts, Ts


def ate_checked(seq, ts, Ts, what):
    from okvis2x_tpu_torch.io import trajectory_io

    ate = trajectory_io.ate_rmse(ts, Ts[:, :3], seq.gt[:, 0], seq.gt[:, 1:4])
    if ate is None or not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"{what} ATE {ate} m exceeds {ATE_LIMIT_M} m")
    return ate


def vio_phase(dev, card):
    """40 frames of VIO on the GPU, the first frames again on the CPU, then
    ratio-test matching of the last two frames.  Returns the launches of the
    (fused, matrix) kernels on these paths."""
    import torch
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    t0 = time.perf_counter()
    seq = render(N_FRAMES)
    print(f"rendered {N_FRAMES} frames at 752x480: {time.perf_counter() - t0:.1f} s")
    timing.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    vio, infos, wall = run_pipeline(seq, dev, N_FRAMES, record_times=True)
    t_run = time.perf_counter() - t0
    launches = hamming.hamming_match.launches
    on_matrix = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ts, Ts = check_positions(vio, N_FRAMES, "VIO")
    if launches != 4 * N_FRAMES or on_matrix != 0:
        raise RuntimeError(f"the VIO path launched the fused kernel {launches} times and the "
                           f"matrix kernel {on_matrix} times over {N_FRAMES} frames; expected "
                           f"{4 * N_FRAMES} and 0")
    ate = ate_checked(seq, ts, Ts, "VIO online")
    ms = np.asarray(wall) * 1e3
    counts = np.array([[i["n_map"], i["n_stereo"], i["n_motion"]] for i in infos])
    p50 = np.median(counts, axis=0)
    print(f"VIO path: {N_FRAMES} frames in {t_run:.1f} s, dtype "
          f"{vio.est.cfg.dtype}, online ATE {ate:.4f} m, ms/frame p50 "
          f"{np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} "
          f"(first frame {ms[0]:.1f}), peak allocated {peak / 2**20:.1f} MiB, "
          f"fused match launches {launches} = 4 a frame, matrix launches {on_matrix} ({card})")
    print(f"VIO path counts p50: map {p50[0]:.0f} stereo {p50[1]:.0f} motion "
          f"{p50[2]:.0f}; keyframes {sum(i['is_keyframe'] for i in infos)} ({card})")
    print(timing.report())

    # the same first frames on the CPU (plain Hamming version)
    t0 = time.perf_counter()
    vio_c, _, _ = run_pipeline(seq, torch.device("cpu"), CPU_FRAMES)
    p_cpu = np.stack([s[1][:3] for s in vio_c.states_log])
    gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
    print(f"cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m "
          f"({time.perf_counter() - t0:.1f} s)")
    if not gap <= CPU_GPU_TOL_M:
        raise RuntimeError(f"GPU and CPU runs disagree by {gap} m")
    return launches, ratio_match_phase(vio, dev)


def ratio_match_phase(vio, dev):
    """Frame-to-frame matching with Lowe's ratio test and the mutual check
    (`matcher.match`, the caller that wants the distance matrix) on the cam-0
    descriptors of the last two frames; returns the matrix kernel's launches."""
    import torch
    from okvis2x_tpu_torch.frontend import matcher
    from okvis2x_tpu_torch.ops import hamming

    fa, fb = (vio.frames[f][0] for f in sorted(vio.frames)[-2:])
    args = [torch.as_tensor(np.ascontiguousarray(x)) for x in
            (fa.packed.astype(np.int32), fa.valid, fb.packed.astype(np.int32), fb.valid)]
    kw = dict(max_dist=vio.cfg.matching_threshold, ratio=0.8, mutual=True)
    hamming.reset_launch_counts()
    got = matcher.match(*(x.to(dev) for x in args), **kw)
    torch.cuda.synchronize()
    launches = hamming.hamming_matrix_packed.launches
    ref = matcher.match(*args, **kw)
    for x, y in zip(got, ref):
        if not torch.equal(x.cpu(), y):
            raise RuntimeError("ratio-test matches differ between the card and the CPU")
    n = int(ref.valid.sum())
    print(f"ratio-test matching of the last two frames: {n} mutual matches, card == CPU, "
          f"matrix kernel launches {launches}")
    if launches <= 0 or n <= 0:
        raise RuntimeError("the ratio-test matching found nothing or never launched the "
                           "matrix kernel")
    return launches


def loop_closure_phase(dev, card):
    """Synchronous loop closure over one lap of the small circuit, then
    finish() and the final BA.  Returns the fused kernel's launches."""
    import torch
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    t0 = time.perf_counter()
    seq = render(LC_FRAMES, radius=LC_RADIUS_M)
    print(f"rendered {LC_FRAMES} frames at 752x480, circuit radius {LC_RADIUS_M} m: "
          f"{time.perf_counter() - t0:.1f} s")
    timing.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    vio, infos, wall = run_pipeline(seq, dev, LC_FRAMES, record_times=True, loop_closure=True)
    vio.finish()
    t_run = time.perf_counter() - t0
    ts, Ts = check_positions(vio, LC_FRAMES, "loop-closure")
    t0 = time.perf_counter()
    cost = vio.est.final_ba()
    torch.cuda.synchronize()
    t_ba = time.perf_counter() - t0
    launches = hamming.hamming_match.launches
    sites = dict(hamming.hamming_match.site_launches)
    on_matrix = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ft, fT = vio.est.full_trajectory()
    if not np.isfinite(fT).all() or not np.isfinite(cost):
        raise RuntimeError("non-finite poses or cost after the final BA")
    closures = [(i["fid"], e["i"]) for i in infos if i["loop_closure"]
                for e in vio.est.archive_edges if e.get("loop") and e["j"] == i["fid"]]
    print(f"loop closures {vio.n_loop_closures} (frame, candidate) {closures}, landmarks "
          f"merged {vio.n_landmarks_merged}, keyframe records {len(vio.kf_records)}")
    n_kf = sum(i["is_keyframe"] for i in infos)
    print(f"fused match launches by site {sites} over {LC_FRAMES} frames and {n_kf} "
          f"keyframes; matrix kernel launches {on_matrix}")
    if vio.n_loop_closures < 1:
        raise RuntimeError("no loop closure was accepted")
    for site in ("bow", "lc_match"):
        if sites.get(site, 0) <= 0:
            raise RuntimeError(f"the fused kernel was never launched from site {site!r}")
    if sites.get("assoc", 0) != 4 * LC_FRAMES or on_matrix != 0:
        raise RuntimeError("the association did not launch the fused kernel 4 times a frame, "
                           "or the loop-closure path launched the matrix kernel")
    ate_on = ate_checked(seq, ts, Ts, "loop-closure online")
    ate_fin = ate_checked(seq, ft, fT, "final")
    ms = np.asarray(wall) * 1e3
    print(f"loop-closure path: {LC_FRAMES} frames in {t_run:.1f} s, online ATE "
          f"{ate_on:.4f} m, final ATE {ate_fin:.4f} m over {len(ft)} keyframes, ms/frame "
          f"p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f}, 2.8 LoopClosure "
          f"mean {timing.mean_ms('2.8 LoopClosure'):.1f} ms, final BA {t_ba:.1f} s, peak "
          f"allocated {peak / 2**20:.1f} MiB, fused match launches {launches} ({card})")
    print(timing.report())

    # the vocabulary descent of one keyframe on the card and on the CPU
    rec = vio.kf_records[min(vio.kf_records)]
    w_gpu = bow.assign_packed(rec["packed_d"], rec["valid_d"], vio.vocab).cpu()
    w_cpu = bow.assign_packed(rec["packed_d"].cpu(), rec["valid_d"].cpu(), vio.vocab.to("cpu"))
    if not torch.equal(w_gpu, w_cpu):
        raise RuntimeError("vocabulary words differ between the card and the CPU")
    print("vocabulary words of the first keyframe: card == CPU, exact")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- phases 2 and 3: the kernels against their plain versions, their times
    t0 = time.perf_counter()
    entries = check_kernels(dev, card)
    time_sites(dev, card)
    device_ms.stream = None
    torch.cuda.empty_cache()
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s; it leaves "
          f"{torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB allocated (the library "
          "yardstick's cuBLAS workspace), which the phases' peaks below include")

    # ---- phases 4 to 6: the main paths
    t0 = time.perf_counter()
    on_match, on_matrix = vio_phase(dev, card)
    print(f"VIO phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    on_match += loop_closure_phase(dev, card)
    print(f"loop-closure phase: {time.perf_counter() - t0:.1f} s")

    # times at 704x1024, the map matching's shape
    print(json.dumps({"kernels": [
        {"name": "hamming_match", "route": "cuda",
         "source": "okvis2x_tpu_torch/csrc/hamming_match.cu",
         "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
         "launches": on_match, **entries["match"]},
        {"name": "hamming_matrix_packed", "route": "cuda",
         "source": "okvis2x_tpu_torch/csrc/hamming.cu",
         "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
         "launches": on_matrix, **entries["matrix"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
