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
   The fused kernel is also held against its plain version from a second
   host thread on a CUDA stream of its own, as the place-recognition worker
   launches it;
4. VIO: renders 20 frames (1 s) of the synthetic circuit at the EuRoC
   operating point (752x480 stereo at 20 Hz, 200 Hz IMU, 704 keypoints) in
   memory and feeds them to `VioPipeline` on the GPU under the JAX package's
   default `PipelineConfig` (pose refinement, pipelined solve, loop closure
   with the place-recognition worker), then `finish()`: every pose must be
   finite, the association must have launched the fused kernel 4 times a
   frame, and the online position ATE must be at most 0.25 m; the first
   frames are also run on the CPU (plain versions) and must agree with the
   GPU run (the CPU halves of this check and of phase 9 run meanwhile in a
   spawned process);
5. ratio-test matching: the cam-0 descriptors of the last two frames of that
   run through `matcher.match` with Lowe's ratio test and the mutual check,
   the caller that wants the distance matrix: the matrix kernel must have
   been launched and the matches must equal the CPU's;
6. synchronous loop closure: the same operating point on a circuit of
   radius 0.8 m (one lap in about 125 frames; 150 frames rendered once for
   phases 6 to 9, which run 128, 30, 128 and 150 of them) with the synchronous, non-pipelined path (BoW place
   recognition on the shipped vocabulary, loop matching, non-central
   RANSAC, in-line pose-graph solve), then `finish()` and the final BA: at
   least one closure must be accepted, the fused kernel must have been
   launched from the vocabulary descent and the loop matching, every pose
   must be finite, and the online and final ATE must both be at most
   0.25 m;
7. multi-session: phase 6's pipeline is session A and is saved as a map
   component; session B is a new pipeline without a vocabulary file
   (`vocab_path=""`) in phase 6's configuration that loads it (a vocabulary
   of 256 words bootstrapped from A's descriptors: binary k-means on the
   fused kernel) and runs the first 30 frames from a world frame 1.5 m
   lateral and 0.1 rad of yaw off A's (moved so right after the
   estimator's first state, before the first keyframe is recorded): B must
   relocalise, its poses from then on must lie within 0.2 m and 0.05 rad
   of A's estimate of the same frames, the vocabulary must equal the plain
   trainer's on the same descriptors and seed on the card, one
   verification's mutual match must equal the plain version's, and the
   fused kernel must have been launched from the sites "vocab" and
   "reloc";
8. asynchronous loop closure on the same frames: the flagship configuration
   of tools/slam_bench.py without its deferred frontend (place recognition
   on the worker thread, the background optimisation of the history,
   pipelined solve, the realtime budget controller at 35 ms with at least 6
   iterations) with the background complete-factor-graph BA up to 64
   keyframes, then `finish()` and the final BA: the same checks, and a
   background full BA must have been synchronised, the worker must have
   stopped, and the words the worker computed on its stream for a keyframe
   must equal the CPU's;
9. the flagship on the same frames: tools/slam_bench.py's configuration as
   written (the deferred fused frontend at depth 1, asynchronous loop
   closure, the budget controller), then `finish()` and the final BA: the
   checks of phase 8 (a background pose graph synchronised), every
   `frontend_dispatch` free of host syncs under
   `torch.cuda.set_sync_debug_mode`, the fused kernel's results at the
   association's call sites equal to its plain version on the same inputs,
   and the first frames equal to those of the same run on the CPU; it prints
   the wait on the critical block, the descriptor blocks still in flight
   when folded in, the iteration budget and the frame times;
10. the matrix-free PCG pose-graph solver on drifted circles with loop
   edges at 300 and 1000 nodes: the card's poses within 1e-6 of the CPU's,
   and its time per solve.

Every phase fails on an ERROR record logged by any thread (the background
workers log and carry on, as in the JAX package).  The second-to-last line
is a JSON object describing the kernels; the last line is
`{"ok": true, "device": {...}}`.  Any failure raises, and the script exits
non-zero without printing a result.
"""

import json
import logging
import multiprocessing
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ProcessPoolExecutor

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
N_FRAMES = 20  # the VIO phase: 1 s of the sequence
# the loop-closure phases: a lap of the 0.8 m circuit (1 rad/s) is about 125
# frames; the flagship records keyframes more sparsely and a call later, and
# gets the frames of the next keyframes after the lap as well
LC_FRAMES = {"synchronous": 128, "asynchronous": 128, "flagship": 150}
# the body starts at rest, as the estimator's stationary initialisation assumes
SMALL_CIRCUIT = dict(radius=0.8, speed=0.8, speed_mod=-1.0 / (2 * np.pi * 0.07))
ATE_LIMIT_M = 0.25
CPU_FRAMES = 3
CPU_GPU_TOL_M = 1e-3
# the estimator of tools/slam_bench.py; the flagship adds the realtime budget
BASE_EST = dict(cap_landmarks=1024, cap_obs=8192, max_iterations=10, early_exit_rel=5e-4)
FLAGSHIP_EST = dict(realtime_time_limit=0.035, min_iterations=6)
# tools/slam_bench.py's pipeline (the JAX defaults leave
# async_place_recognition and pipelined_solve on) ...
FLAGSHIP_PIPE = dict(do_loop_closures=True, async_loop_closure=True, pose_refine=False,
                     deferred_frontend=True, pipeline_depth=1)
# ... and the loop-closure phases before it
LC_PIPES = {
    "synchronous": dict(do_loop_closures=True, async_place_recognition=False,
                        async_loop_closure=False, pose_refine=False, pipelined_solve=False),
    "asynchronous": FLAGSHIP_PIPE | dict(deferred_frontend=False, full_ba_threshold=64),
    "flagship": FLAGSHIP_PIPE,
}
LC_ESTS = {"synchronous": {}, "asynchronous": FLAGSHIP_EST, "flagship": FLAGSHIP_EST}
# the multi-session phase: session B runs this many frames from a world frame
# 1.5 m lateral and 0.1 rad of yaw off session A's (tests/test_multisession.py)
MS_FRAMES = 30
MS_OFFSET = (1.5, 0.1)
MS_POS_TOL_M, MS_ROT_TOL_RAD = 0.2, 0.05
COMPARE_EVERY = 16  # flagship frames between two holds of the kernel against its plain version
PCG_NODES = (300, 1000)
PCG_ITERATIONS = 15  # PipelineConfig.full_graph_iterations
PCG_TOL = 1e-6


class ErrorRecords(logging.Handler):
    """Keeps every ERROR record logged by any thread: a background worker
    that fails logs and carries on, and the run must not."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def check(self, phase):
        if self.records:
            msgs = "; ".join(f"[{r.threadName}] {r.getMessage()}" for r in self.records)
            raise RuntimeError(f"{phase}: {len(self.records)} error records: {msgs}")


ERRORS = ErrorRecords()


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
        # the multi-session phase: k-means assignment of session A's
        # descriptors to 256 centres; the relocalisation's mutual match is
        # the form "mutual, 385 fills" at 704x704
        ("vocabulary training 20000x256", *make(20000, 256, validity=False)),
        ("reloc mutual, 385 fills 704x704", *make(704, 704, fill_invalid=385, want_cols=True)),
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


def check_on_worker_stream(forms):
    """The fused kernel in the forms of the place-recognition worker's sites
    (vocabulary descent, loop matching), launched from a second host thread
    on a CUDA stream of its own, against its plain version; returns the
    largest difference (0)."""
    import torch
    from okvis2x_tpu_torch.ops import hamming

    sites = ("vocabulary branches 704x64", "vocabulary leaves, row_seg 704x4096",
             "loop matching, 3 segments 704x2112")
    done, errors = [], []

    def work():
        try:
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())  # the inputs' copies
            with torch.cuda.stream(stream):
                for name, q, vq, d, vd, kw in forms:
                    if name not in sites:
                        continue
                    got = hamming.hamming_match(q, vq, d, vd, **kw)
                    ref = hamming.hamming_match_plain(q, vq, d, vd, **kw)
                    stream.synchronize()
                    for g, r in zip(got, ref):
                        if (g is None) != (r is None) or (g is not None and not torch.equal(g, r)):
                            raise RuntimeError(
                                f"hamming match != plain on a worker stream ({name})")
                    done.append(name)
        except Exception as e:  # noqa: BLE001 — raised on the main thread below
            errors.append(e)

    t = threading.Thread(target=work, name="kernel-check")
    t.start()
    t.join()
    if errors:
        raise errors[0]
    if len(done) != len(sites):
        raise RuntimeError(f"the worker-stream check ran {done}, expected {sites}")
    print(f"hamming match from a second thread on its own stream: {len(done)} worker-site "
          "forms == plain, exact")
    return 0


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
    match_err = max(match_err, check_on_worker_stream(forms))

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


def run_pipeline(seq, device, n_frames, record_times=False, est_kw=(), pipe_kw=(), wrap=None):
    """Feed `n_frames` frames of `seq` to a fresh VioPipeline on `device`:
    the estimator of tools/slam_bench.py updated with `est_kw`, the JAX
    package's default PipelineConfig at 704 keypoints updated with
    `pipe_kw`; then `finish()`.  `wrap(vio)` may instrument the pipeline
    before the first frame.  Returns (pipeline, frame infos, wall time a
    frame, iterations of each pipelined window solve when it was built, wall
    time of finish, the wait on the critical block a frame)."""
    import torch
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig
    from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline
    from okvis2x_tpu_torch.utils import timing

    c = seq.camera
    cam = pinhole.make_pinhole(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"],
                               model=c["model"], dist_params=c["dist_params"],
                               dtype=torch.float64, device=device)
    est_cfg = EstimatorConfig(**(BASE_EST | dict(est_kw)))
    pipe_cfg = PipelineConfig(**(dict(max_keypoints=704) | dict(pipe_kw)))
    # on the card through the default device, as a user calls it
    on_cpu = dict(device=device) if device.type == "cpu" else {}
    vio = VioPipeline([cam, cam], seq.T_SC, est_cfg, pipe_cfg, **on_cpu)
    if wrap is not None:
        wrap(vio)
    infos, wall, iters, waits = [], [], [], []
    n = 0
    for kind, data in seq.events():
        if kind == "imu":
            vio.add_imu_measurement(*data)
            continue
        if n >= n_frames:
            break
        t0 = time.perf_counter()
        w0 = timing.total_s("2.0 PrefetchWait")
        infos.append(vio.process_frame(data[0], data[1]))
        if record_times and device.type == "cuda":
            torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        waits.append(timing.total_s("2.0 PrefetchWait") - w0)
        h = (vio._pending["h"] if vio._pending is not None
             else vio._inflight[-1]["solve"] if vio._inflight else None)
        if h is not None:
            iters.append(h["iters"])
        n += 1
    t0 = time.perf_counter()
    vio.finish()
    return vio, infos, wall, iters, time.perf_counter() - t0, waits


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


def vio_cpu_positions():
    """The first CPU_FRAMES positions of the VIO phase's run on the CPU
    (plain kernel versions); with the run's seconds."""
    import torch

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    vio = run_pipeline(render(N_FRAMES), torch.device("cpu"), CPU_FRAMES)[0]
    return np.stack([s[1][:3] for s in vio.states_log]), time.perf_counter() - t0


def flagship_cpu_positions():
    """The first CPU_FRAMES positions of the flagship phase's run on the
    CPU, with the run's seconds.  One frame more is run: with the deferred
    frontend a frame's solve is built in the next call, and the last one
    only in finish(), against a window without that next frame."""
    import torch

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    vio = run_pipeline(render(max(LC_FRAMES.values()), **SMALL_CIRCUIT), torch.device("cpu"),
                       CPU_FRAMES + 1,
                       est_kw=LC_ESTS["flagship"], pipe_kw=LC_PIPES["flagship"])[0]
    return (np.stack([s[1][:3] for s in vio.states_log[:CPU_FRAMES]]),
            time.perf_counter() - t0)


def pcg_cpu_solves():
    """The PCG phase's solves on the CPU: {nodes: (poses, cost, seconds)}."""
    import torch
    from okvis2x_tpu_torch.parallel import dist_posegraph

    torch.set_num_threads(2)
    out = {}
    for K in PCG_NODES:
        *args, _ = drifted_circle(K, np.random.default_rng(K))
        t0 = time.perf_counter()
        T, cost = dist_posegraph.optimize_pose_graph_pcg(*args, iterations=PCG_ITERATIONS,
                                                         device="cpu")
        out[K] = (T, cost, time.perf_counter() - t0)
    return out


def vio_phase(dev, card, cpu_positions):
    """N_FRAMES frames of VIO on the GPU under the JAX default configuration,
    against the CPU's first frames (`cpu_positions`, a future of
    `vio_cpu_positions`), then ratio-test matching of the last two frames.
    Returns the fused kernel's launches by site and the matrix kernel's
    launches on these paths."""
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
    vio, infos, wall, _, _, _ = run_pipeline(seq, dev, N_FRAMES, record_times=True)
    t_run = time.perf_counter() - t0
    launches = hamming.hamming_match.launches
    sites = dict(hamming.hamming_match.site_launches)
    on_matrix = hamming.hamming_matrix_packed.launches
    peak = torch.cuda.max_memory_allocated(dev)
    ts, Ts = check_positions(vio, N_FRAMES, "VIO")
    n_kf = sum(i["is_keyframe"] for i in infos)
    if sites.get("assoc", 0) != 4 * N_FRAMES or on_matrix != 0:
        raise RuntimeError(f"the VIO path launched the fused kernel {sites} and the matrix "
                           f"kernel {on_matrix} times over {N_FRAMES} frames; expected "
                           f"{4 * N_FRAMES} association launches and 0")
    ERRORS.check("VIO phase")
    ate = ate_checked(seq, ts, Ts, "VIO online")
    ms = np.asarray(wall) * 1e3
    counts = np.array([[i["n_map"], i["n_stereo"], i["n_motion"]] for i in infos])
    p50 = np.median(counts, axis=0)
    print(f"VIO path (JAX default PipelineConfig: pose refinement, pipelined solve, place "
          f"recognition worker): {N_FRAMES} frames in {t_run:.1f} s, dtype {vio.est.cfg.dtype}, "
          f"online ATE {ate:.4f} m, ms/frame p50 {np.percentile(ms, 50):.1f} p90 "
          f"{np.percentile(ms, 90):.1f} (first frame {ms[0]:.1f}), peak allocated "
          f"{peak / 2**20:.1f} MiB, fused match launches {launches} by site {sites} = 4 a frame "
          f"+ 2 a keyframe ({n_kf}) on the worker, matrix launches {on_matrix} ({card})")
    print(f"VIO path counts p50: map {p50[0]:.0f} stereo {p50[1]:.0f} motion "
          f"{p50[2]:.0f}; keyframes {n_kf} ({card})")
    print(timing.report())

    # the same first frames on the CPU (plain Hamming version)
    p_cpu, t_cpu = cpu_positions.result()
    gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
    print(f"cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m "
          f"(CPU run {t_cpu:.1f} s, in a process of its own)")
    if not gap <= CPU_GPU_TOL_M:
        raise RuntimeError(f"GPU and CPU runs disagree by {gap} m")
    return sites, ratio_match_phase(vio, dev)


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


class FrontendCheck:
    """Instruments the flagship pipeline's `frontend_dispatch`.

    Host syncs: `torch.cuda.set_sync_debug_mode` is process-wide, while the
    recognition worker and the background optimisation read their results
    back on their own streams, as they must.  So a dispatch runs under
    "error" when neither is running (the worker's item lock is held for the
    dispatch; the background thread starts only from the frame thread),
    else under "warn", and a warning issued on the frame thread during a
    dispatch counts as a sync.  Either way a sync fails the phase.

    The kernel: every COMPARE_EVERY-th dispatch keeps the inputs and results
    of the association's fused-kernel launches, and after the dispatch holds
    each against the plain version on the same inputs."""

    SYNC = "synchronizing CUDA operation"

    def __init__(self):
        self.n_error = self.n_warn = self.n_compared = self._n = 0
        self.syncs = []
        self.calls = None
        self._in_dispatch = False
        self._frame_thread = threading.current_thread()

    def install(self):
        self._show, self._filters = warnings.showwarning, warnings.filters[:]
        warnings.showwarning = self._showwarning
        warnings.filterwarnings("always", message=f".*{self.SYNC}.*")

    def uninstall(self):
        warnings.showwarning, warnings.filters[:] = self._show, self._filters

    def _showwarning(self, message, category, filename, lineno, file=None, line=None):
        if self.SYNC not in str(message):
            return self._show(message, category, filename, lineno, file, line)
        if self._in_dispatch and threading.current_thread() is self._frame_thread:
            self.syncs.append(f"{filename}:{lineno}")

    def wrap(self, vio):
        import torch
        from okvis2x_tpu_torch.frontend import matcher
        from okvis2x_tpu_torch.ops import hamming

        def recorded(*args, **kwargs):
            out = hamming.hamming_match(*args, **kwargs)
            self.calls.append((args, kwargs, out))
            return out

        # ops.hamming as the matcher sees it during a compared dispatch
        recording = types.SimpleNamespace(**vars(hamming))
        recording.hamming_match = recorded
        dispatch = vio.frontend_dispatch

        def checked(*args, **kwargs):
            quiet = vio._lc_active.acquire(blocking=False)
            compare = self._n % COMPARE_EVERY == COMPARE_EVERY // 2
            self._n += 1
            real = matcher.hamming
            try:
                mode = "error" if quiet and not vio.full_graph.is_loop_closing else "warn"
                self.n_error += mode == "error"
                self.n_warn += mode == "warn"
                if compare:
                    self.calls, matcher.hamming = [], recording
                self._in_dispatch = True
                torch.cuda.set_sync_debug_mode(mode)
                try:
                    return dispatch(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                    self._in_dispatch = False
                    matcher.hamming = real
            finally:
                if quiet:
                    vio._lc_active.release()
                if compare:
                    self._compare()

        vio.frontend_dispatch = checked

    def _compare(self):
        import torch
        from okvis2x_tpu_torch.ops import hamming

        for args, kwargs, out in self.calls:
            ref = hamming.hamming_match_plain(*args, **{k: v for k, v in kwargs.items()
                                                        if k != "site"})
            for g, r in zip(out, ref):
                if (g is None) != (r is None) or (g is not None and not torch.equal(g, r)):
                    raise RuntimeError("flagship: the fused kernel differs from its plain "
                                       "version at an association site")
            self.n_compared += 1
        self.calls = None


def loop_closure_phase(dev, card, mode, seq, cpu_positions=None):
    """One lap of the 0.8 m circuit (`seq`) with loop closure, then finish()
    and the final BA, in `mode`: "synchronous" (the synchronous,
    non-pipelined path), "asynchronous" (the flagship without its deferred
    frontend, with the background full BA) or "flagship" (tools/slam_bench.py
    as written; `cpu_positions` is a future of `flagship_cpu_positions`).
    Returns the fused kernel's launches by site and the pipeline."""
    import torch
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.ops import hamming
    from okvis2x_tpu_torch.utils import timing

    what = f"{mode} loop-closure"
    n_frames = LC_FRAMES[mode]
    check = FrontendCheck() if mode == "flagship" else None
    timing.reset()
    torch.cuda.reset_peak_memory_stats(dev)
    hamming.reset_launch_counts()
    t0 = time.perf_counter()
    threads_before = set(threading.enumerate())
    if check is not None:
        check.install()
    try:
        vio, infos, wall, iters, t_finish, waits = run_pipeline(
            seq, dev, n_frames, record_times=True, est_kw=LC_ESTS[mode], pipe_kw=LC_PIPES[mode],
            wrap=None if check is None else check.wrap)
    finally:
        if check is not None:
            check.uninstall()
    t_run = time.perf_counter() - t0
    ts, Ts = check_positions(vio, n_frames, what)
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
    closures = sorted((int(e["j"]), int(e["i"])) for e in vio.est.archive_edges
                      if e.get("loop"))
    print(f"{what}: closures {vio.n_loop_closures} (frame, candidate) {closures}, landmarks "
          f"merged {vio.n_landmarks_merged}, keyframe records {len(vio.kf_records)} ({card})")
    n_kf = sum(i["is_keyframe"] for i in infos)
    print(f"{what}: fused match launches by site {sites} over {n_frames} frames and {n_kf} "
          f"keyframes; matrix kernel launches {on_matrix}")
    ERRORS.check(what)
    if vio.n_loop_closures < 1:
        raise RuntimeError(f"{what}: no loop closure was accepted")
    for site in ("bow", "lc_match"):
        if sites.get(site, 0) <= 0:
            raise RuntimeError(f"{what}: the fused kernel was never launched from site {site!r}")
    if sites.get("assoc", 0) != 4 * n_frames or on_matrix != 0:
        raise RuntimeError(f"{what}: the association did not launch the fused kernel 4 times a "
                           "frame, or the path launched the matrix kernel")
    ate_on = ate_checked(seq, ts, Ts, f"{what} online")
    ate_fin = ate_checked(seq, ft, fT, f"{what} final")
    ms = np.asarray(wall) * 1e3
    n_common = min(LC_FRAMES.values())
    print(f"{what}: {n_frames} frames in {t_run:.1f} s (finish() {t_finish:.1f} s), online "
          f"ATE {ate_on:.4f} m, final ATE {ate_fin:.4f} m over {len(ft)} keyframes, ms/frame "
          f"p50 {np.percentile(ms, 50):.1f} p90 {np.percentile(ms, 90):.1f} max {ms.max():.1f} "
          f"(first {n_common} frames: p50 {np.percentile(ms[:n_common], 50):.1f} p90 "
          f"{np.percentile(ms[:n_common], 90):.1f}), "
          f"2.8 LoopClosure mean {timing.mean_ms('2.8 LoopClosure'):.1f} ms, final BA "
          f"{t_ba:.1f} s, peak allocated {peak / 2**20:.1f} MiB, fused match launches "
          f"{launches} ({card})")
    if mode != "synchronous":
        fg = vio.full_graph
        hist = {int(k): int(n) for k, n in zip(*np.unique(iters, return_counts=True))}
        left = [t.name for t in set(threading.enumerate()) - threads_before if t.is_alive()]
        print(f"{what}: background optimisation dispatched {fg.n_dispatched}, synchronised "
              f"{fg.n_synchronised} (full BA {fg.n_full_ba}), stale discarded "
              f"{fg.n_stale_discarded}, solve wall time mean "
              f"{timing.mean_ms('4.1 FullGraphSolve'):.1f} ms; keyframes demoted to index-only "
              f"{vio._lc_skipped}; window solve iterations {hist} (histogram of _rt_iters when "
              f"built), budget overruns {vio.est.n_budget_overruns} of {len(iters)} solves; "
              f"threads left after finish(): {left} ({card})")
        if fg.n_synchronised < 1:
            raise RuntimeError(f"{what}: the background optimisation was never synchronised")
        if mode == "asynchronous" and fg.n_full_ba < 1:
            raise RuntimeError(f"{what}: no background full BA was synchronised")
        if left or vio._lc_thread is not None or fg.is_loop_closing:
            raise RuntimeError(f"{what}: threads still running after finish(): {left}")
        # the words the worker computed on its stream, against the CPU
        rec = next(r for r in vio.kf_records.values() if "words" in r)
        w_cpu = bow.assign_packed(rec["packed_d"].cpu(), rec["valid_d"].cpu(),
                                  vio.vocab.to("cpu")).numpy()
        if not np.array_equal(rec["words"], w_cpu):
            raise RuntimeError("the worker's vocabulary words differ from the CPU's")
        print(f"{what}: vocabulary words computed by the worker on its stream == CPU, exact "
              f"({card})")
    else:
        # the vocabulary descent of one keyframe on the card and on the CPU
        rec = vio.kf_records[min(vio.kf_records)]
        w_gpu = bow.assign_packed(rec["packed_d"], rec["valid_d"], vio.vocab).cpu()
        w_cpu = bow.assign_packed(rec["packed_d"].cpu(), rec["valid_d"].cpu(),
                                  vio.vocab.to("cpu"))
        if not torch.equal(w_gpu, w_cpu):
            raise RuntimeError("vocabulary words differ between the card and the CPU")
        print(f"{what}: vocabulary words of the first keyframe: card == CPU, exact")
    if check is not None:
        wait_ms = np.asarray(waits) * 1e3
        print(f"{what}: frontend_dispatch under set_sync_debug_mode: {check.n_error} dispatches "
              f"under 'error', {check.n_warn} under 'warn' (a worker running), host syncs on the "
              f"frame thread {len(check.syncs)}; fused kernel == plain at {check.n_compared} "
              f"association launches of {n_frames // COMPARE_EVERY} frames, exact; "
              f"2.0 PrefetchWait ms p50 {np.percentile(wait_ms, 50):.3f} p90 "
              f"{np.percentile(wait_ms, 90):.3f} max {wait_ms.max():.3f}; descriptor blocks still "
              f"in flight when folded in: {vio.n_desc_late} ({card})")
        if check.syncs or check.n_error + check.n_warn != n_frames:
            raise RuntimeError(f"{what}: host syncs in frontend_dispatch at {check.syncs}")
        if check.n_compared != 4 * (n_frames // COMPARE_EVERY):
            raise RuntimeError(f"{what}: held {check.n_compared} kernel launches against plain")
        p_cpu, t_cpu = cpu_positions.result()
        gap = float(np.abs(p_cpu - Ts[:CPU_FRAMES, :3]).max())
        print(f"{what}: cpu vs gpu over {CPU_FRAMES} frames: max position gap {gap:.3e} m (CPU run "
              f"{t_cpu:.1f} s, in a process of its own)")
        if not gap <= CPU_GPU_TOL_M:
            raise RuntimeError(f"{what}: GPU and CPU runs disagree by {gap} m")
    print(timing.report())
    return sites, vio


class MatchRecorder:
    """Keeps the inputs and outputs of the calls of
    `hamming.match_packed_mutual` from one site while installed."""

    def __init__(self, site):
        self.site, self.calls = site, []

    def __enter__(self):
        from okvis2x_tpu_torch.ops import hamming

        self.orig = hamming.match_packed_mutual

        def call(*args, **kw):
            out = self.orig(*args, **kw)
            if kw.get("site") == self.site:
                self.calls.append((args, dict(kw), out))
            return out

        hamming.match_packed_mutual = call
        return self

    def __exit__(self, *exc):
        from okvis2x_tpu_torch.ops import hamming

        hamming.match_packed_mutual = self.orig


def plain_match():
    """A context in which `hamming.hamming_match` is its plain version (on
    the card too): for holding a whole site against it."""
    import contextlib

    from okvis2x_tpu_torch.ops import hamming

    @contextlib.contextmanager
    def ctx():
        orig = hamming.hamming_match
        hamming.hamming_match = lambda *a, site=None, **kw: hamming.hamming_match_plain(*a, **kw)
        try:
            yield
        finally:
            hamming.hamming_match = orig

    return ctx()


def rot_err(qa, qb):
    """Angles (rad) between the rotations of unit quaternions (..., 4)."""
    return 2 * np.arccos(np.clip(np.abs(np.sum(qa * qb, axis=-1)), 0, 1))


def multisession_phase(dev, card, vio_a, seq):
    """Session A (the synchronous phase's pipeline) saved as a component;
    session B, a new pipeline on the card without a vocabulary file
    (`vocab_path=""`) in the synchronous configuration, loads it (its
    vocabulary bootstrapped from A's descriptors on the kernel, site
    "vocab") and runs MS_FRAMES frames of the same rendering from a world
    frame that is MS_OFFSET off A's (put on after the estimator's first
    state, before the first keyframe is recorded).  B's keyframes are
    verified against A's (site "reloc").  Returns the fused kernel's
    launches by site."""
    import os
    import tempfile

    import torch
    from okvis2x_tpu_torch.core import se3np
    from okvis2x_tpu_torch.frontend import bow
    from okvis2x_tpu_torch.graph import component
    from okvis2x_tpu_torch.ops import hamming

    what = "multi-session"
    t0 = time.perf_counter()
    offset = se3np.se3_multiply(
        np.array([0.0, MS_OFFSET[0], 0.0, 0, 0, 0, 1.0]),
        np.concatenate([[0.0, 0.0, 0.0], se3np.delta_q(np.array([0.0, 0.0, MS_OFFSET[1]]))]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session_a.npz")
        vio_a.save_component(path)
        comp = component.load_component(path)
        print(f"{what}: session A saved, {len(comp['frame_fids'])} pose-graph nodes, "
              f"{len(comp['records'])} keyframe records, {os.path.getsize(path) / 2**20:.2f} MiB")

        def prepare(vio):
            """Load A, then put B's world frame off A's at its first state."""
            if not vio.load_component(path):
                raise RuntimeError(f"{what}: load_component refused session A")
            add_state = vio.est.add_state

            def first_state(t):
                fid = add_state(t)
                vio.est.rigid_transform(offset, session_only=True)
                vio.est.add_state = add_state
                return fid

            vio.est.add_state = first_state

        hamming.reset_launch_counts()
        with MatchRecorder("reloc") as rec:
            vio, infos, wall, _, _, _ = run_pipeline(
                seq, dev, MS_FRAMES, record_times=True, est_kw=LC_ESTS["synchronous"],
                pipe_kw=LC_PIPES["synchronous"] | dict(vocab_path=""), wrap=prepare)
        sites = dict(hamming.hamming_match.site_launches)
    t_run = time.perf_counter() - t0
    ERRORS.check(what)
    ts, Ts = check_positions(vio, MS_FRAMES, what)
    print(f"{what}: session B, {MS_FRAMES} frames in {t_run:.1f} s (ms/frame p50 "
          f"{np.percentile(np.asarray(wall) * 1e3, 50):.1f}), relocalisations "
          f"{vio.n_relocalisations}, loop closures {vio.n_loop_closures}; fused match launches "
          f"by site {sites} ({card})")
    if vio.n_relocalisations < 1 or not vio.relocalised:
        raise RuntimeError(f"{what}: session B was never relocalised")
    for site in ("vocab", "reloc"):
        if sites.get(site, 0) <= 0:
            raise RuntimeError(f"{what}: the fused kernel was never launched from site {site!r}")

    # the bootstrapped vocabulary against the plain trainer on the card
    recs = vio.components[0]["records"].values()
    packs = torch.cat([r["packed_d"][r["valid_d"]] for r in recs])
    init = bow.init_indices(len(packs), vio.cfg.vocab_k)
    with plain_match():
        plain = bow.train_vocabulary_core(packs, init, iters=6)
    if not torch.equal(vio.vocab, plain):
        raise RuntimeError(f"{what}: the vocabulary trained on the kernel differs from the plain "
                           "trainer's")
    print(f"{what}: vocabulary of {vio.vocab.shape[0]} words bootstrapped from {len(packs)} "
          "descriptors of session A on the kernel == plain trainer on the card, exact")

    # one verification's match on the kernel against the plain version
    args, kw, out = rec.calls[0]
    with plain_match():
        ref = hamming.match_packed_mutual(*args, **kw)
    for name, g, r in zip(("idx", "dist", "ok"), out, ref):
        if g.dtype != r.dtype or not torch.equal(g, r):
            raise RuntimeError(f"{what}: the reloc match differs from the plain version ({name})")
    print(f"{what}: reloc match of {args[0].shape[0]} x {args[2].shape[0]} descriptors == plain, "
          f"exact ({len(rec.calls)} reloc matches in the run)")

    # B's poses from its first relocalisation on, against A's estimate
    first = next(i for i, inf in enumerate(infos) if inf["loop_closure"])
    ta = np.array([s[0] for s in vio_a.states_log])
    Ta = np.stack([s[1] for s in vio_a.states_log])
    if not np.array_equal(ta[first:MS_FRAMES], ts[first:]):
        raise RuntimeError(f"{what}: sessions A and B logged different frame times")
    d_pos = np.linalg.norm(Ts[first:, :3] - Ta[first:MS_FRAMES, :3], axis=1)
    d_rot = rot_err(Ts[first:, 3:7], Ta[first:MS_FRAMES, 3:7])
    print(f"{what}: first relocalised at frame {first}; B against A over frames {first}-"
          f"{MS_FRAMES - 1}: position gap max {d_pos.max():.4f} m, rotation gap max "
          f"{d_rot.max():.4f} rad (limits {MS_POS_TOL_M} m, {MS_ROT_TOL_RAD} rad); before: "
          f"{np.linalg.norm(offset[:3]):.2f} m, {MS_OFFSET[1]} rad")
    if not (d_pos.max() <= MS_POS_TOL_M and d_rot.max() <= MS_ROT_TOL_RAD):
        raise RuntimeError(f"{what}: relocalised poses off session A's estimate")
    return sites


def drifted_circle(K, rng, radius=5.0):
    """K keyframes on a circle with drifting estimates, noisy odometry edges
    to the next two keyframes and loop edges from the last quarter to the
    first four: the pose graph of a loop closure."""
    from okvis2x_tpu_torch.core import se3np

    gt, est = [], []
    for k in range(K):
        th = 2 * np.pi * k / K
        T = np.concatenate([[radius * np.cos(th), radius * np.sin(th), 0.0],
                            se3np.delta_q(np.array([0.0, 0.0, th + np.pi / 2]))])
        gt.append(T)
        est.append(se3np.retract(T, np.concatenate([[1.0, 0.5, 0.1], [0, 0, 1.0]]) * 0.8 * k / K))
    ei, ej, eT, eS = [], [], [], []
    for a, b, w, noise in ([(k, k + 1, 100.0, 1e-3) for k in range(K - 1)]
                           + [(k, k + 2, 100.0, 1e-3) for k in range(K - 2)]
                           + [(k % 4, k, 50.0, 2e-3) for k in range(K - K // 4, K)]):
        ei.append(a)
        ej.append(b)
        eT.append(se3np.retract(se3np.se3_multiply(se3np.se3_inverse(gt[a]), gt[b]),
                                rng.normal(0, noise, 6)))
        eS.append(np.eye(6) * w)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return (np.stack(est), fixed, np.array(ei), np.array(ej), np.stack(eT), np.stack(eS),
            np.stack(gt))


def pcg_phase(dev, card, cpu_solves):
    """The matrix-free PCG pose-graph solver at 300 and 1000 nodes on the
    card, against the CPU's solves (`cpu_solves`, a future of
    `pcg_cpu_solves`); the card's time a solve."""
    import torch
    from okvis2x_tpu_torch.parallel import dist_posegraph

    for K in PCG_NODES:
        *args, gt = drifted_circle(K, np.random.default_rng(K))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T_gpu, cost_gpu = dist_posegraph.optimize_pose_graph_pcg(
            *args, iterations=PCG_ITERATIONS, device=dev)
        t_gpu = time.perf_counter() - t0  # the result is on the host: synchronised
        T_cpu, cost_cpu, t_cpu = cpu_solves.result()[K]
        gap = float(np.abs(T_gpu - T_cpu).max())
        err = float(np.linalg.norm(T_gpu[:, :3] - gt[:, :3], axis=1).max())
        err0 = float(np.linalg.norm(args[0][:, :3] - gt[:, :3], axis=1).max())
        Kp = dist_posegraph.bucket(K, 64)
        print(f"PCG pose graph {K} nodes, {len(args[2])} edges (padded {Kp} nodes, "
              f"{dist_posegraph.bucket(len(args[2]), 256)} edges, {max(128, Kp)} CG iterations "
              f"x {PCG_ITERATIONS} LM steps): card {t_gpu * 1e3:.1f} ms a solve, CPU "
              f"{t_cpu * 1e3:.1f} ms; card vs CPU max pose gap "
              f"{gap:.3e}, cost {cost_gpu:.6e} vs {cost_cpu:.6e}; max position error "
              f"{err0:.3f} -> {err:.4f} m ({card})")
        if not gap <= PCG_TOL or not np.isfinite(T_gpu).all():
            raise RuntimeError(f"PCG pose graph at {K} nodes: card and CPU differ by {gap}")
        if not err < err0:
            raise RuntimeError(f"PCG pose graph at {K} nodes did not reduce the drift")
    ERRORS.check("PCG phase")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logging.getLogger().addHandler(ERRORS)

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
    ERRORS.check("kernel phase")
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s; it leaves "
          f"{torch.cuda.memory_allocated(dev) / 2**20:.1f} MiB allocated (the library "
          "yardstick's cuBLAS workspace), which the phases' peaks below include")

    # ---- phases 4 to 10: the main paths, then the PCG pose graph; the CPU
    # halves of their card-vs-CPU checks run meanwhile in a process of
    # their own (one core of the host; the card's phases are host-bound on
    # one other)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_positions = pool.submit(vio_cpu_positions)
        cpu_flagship = pool.submit(flagship_cpu_positions)
        cpu_solves = pool.submit(pcg_cpu_solves)
        t0 = time.perf_counter()
        match_sites = {}

        def add_sites(sites):
            for k, n in sites.items():
                match_sites[k] = match_sites.get(k, 0) + n

        sites, on_matrix = vio_phase(dev, card, cpu_positions)
        add_sites(sites)
        print(f"VIO phase: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        seq = render(max(LC_FRAMES.values()), **SMALL_CIRCUIT)
        print(f"rendered {max(LC_FRAMES.values())} frames at 752x480, circuit radius "
              f"{SMALL_CIRCUIT['radius']} m: {time.perf_counter() - t0:.1f} s")
        for mode in LC_PIPES:
            t0 = time.perf_counter()
            sites, vio = loop_closure_phase(dev, card, mode, seq, cpu_flagship)
            add_sites(sites)
            print(f"{mode} loop-closure phase: {time.perf_counter() - t0:.1f} s")
            if mode == "synchronous":
                t0 = time.perf_counter()
                add_sites(multisession_phase(dev, card, vio, seq))
                print(f"multi-session phase: {time.perf_counter() - t0:.1f} s")
            del vio
        t0 = time.perf_counter()
        pcg_phase(dev, card, cpu_solves)
        print(f"PCG phase: {time.perf_counter() - t0:.1f} s")

    # times at 704x1024, the map matching's shape; launches over phases 4-9
    print(json.dumps({"kernels": [
        {"name": "hamming_match", "route": "cuda",
         "source": "okvis2x_tpu_torch/csrc/hamming_match.cu",
         "replaces": "okvis2x_tpu/ops/hamming_pallas.py:67",
         "launches": sum(match_sites.values()), "site_launches": match_sites,
         **entries["match"]},
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
