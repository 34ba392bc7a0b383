"""Packed binary-descriptor Hamming distances: the two hand-written CUDA
kernels and their plain PyTorch versions.

Counterpart of ``okvis2x_tpu/ops/hamming_pallas.py``.  Descriptors are 384
bits packed LSB-first into 12 words and stored as int32 tensors (the bits of
``np.ndarray.view(np.int32)`` of the uint32 words).

  * ``hamming_matrix_packed`` (``csrc/hamming.cu``): the (NQ, ND) int32
    distance matrix, for callers that want the matrix (the ratio test of
    ``frontend.matcher.match``).
  * ``hamming_match`` (``csrc/hamming_match.cu``): the masked distances
    reduced to row and column argmins inside the kernel, the matrix never
    written; every matching site of the pipeline runs on it.

Dispatch: a CUDA tensor goes to the kernel; if the kernel cannot be built or
launched the error is raised.  A CPU tensor goes to the plain version.  Both
sources are compiled with ``nvcc`` for ``sm_90a`` on first use into one
library under ``build/okvis2x_tpu_torch/`` at the root of the checkout and
loaded with ctypes.  Each wrapper counts its kernel launches in ``.launches``
and by calling site in ``.site_launches`` ("assoc": per-frame association,
"bow": vocabulary descent, "lc_match": loop-closure matching, "vocab":
vocabulary training, "reloc": the verification of a relocalisation).

Both are thread-safe: the place-recognition worker launches the fused kernel
from a thread of its own, so the first build runs under a lock and the
counts are updated under another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

WORDS = 12  # 384-bit descriptors
DESC_BITS = 32 * WORDS

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_SRCS = (_CSRC / "hamming.cu", _CSRC / "hamming_match.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "okvis2x_tpu_torch"
# one lock for every native build of the port (these kernels, the mesh library)
BUILD_LOCK = threading.Lock()
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "--threads", "2",
]


class _Kernel:
    """Lazily built and loaded shared library of the CUDA kernels."""

    def __init__(self):
        self.lib = None
        self.build_log = ""
        self._lock = BUILD_LOCK

    def load(self):
        if self.lib is not None:
            return self.lib
        with self._lock:  # one build, whichever thread launches first
            if self.lib is None:
                self.lib = self._build_and_load()
        return self.lib

    def _build_and_load(self):
        digest = hashlib.sha1(b"".join(p.read_bytes() for p in _SRCS)
                              + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libokvis_hamming_{digest.hexdigest()[:12]}.so"
        if not out.exists():
            from torch.utils.cpp_extension import CUDA_HOME

            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
            if not nvcc or not os.path.exists(nvcc):
                nvcc = shutil.which("nvcc")
            if nvcc is None:
                raise RuntimeError("nvcc not found: cannot build csrc/hamming*.cu")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # unique per process and thread: threads share the pid
            tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _SRCS)],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_CSRC}/hamming*.cu:\n"
                                   f"{res.stdout}{res.stderr}")
            self.build_log = res.stdout + res.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.okvis_hamming_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.okvis_hamming_i32.restype = ctypes.c_int
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.okvis_hamming_match.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr,  # q d vq vd allowed row_seg
            i32, i32, i32, i32,  # nq nd seg walk
            i32, i32, i32, i32,  # the fills: two as carried in the keys, two as reported
            ptr, ctypes.c_longlong,  # scratch and its words
            ptr, ptr, ptr, ptr,  # row_min row_arg col_arg stream
        ]
        lib.okvis_hamming_match.restype = ctypes.c_int
        lib.okvis_cuda_error_string.argtypes = [ctypes.c_int]
        lib.okvis_cuda_error_string.restype = ctypes.c_char_p
        return lib


KERNEL = _Kernel()
_COUNT_LOCK = threading.Lock()


def _count_launch(fn, site: str):
    """One launch of `fn`'s kernel from `site`, counted under a lock."""
    with _COUNT_LOCK:
        fn.launches += 1
        fn.site_launches[site] = fn.site_launches.get(site, 0) + 1


def _check_packed(x: torch.Tensor, name: str):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != WORDS:
        raise ValueError(f"{name}: expected (N, {WORDS}) int32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def hamming_matrix_plain(packed_q: torch.Tensor, packed_d: torch.Tensor) -> torch.Tensor:
    """(NQ, ND) int32 Hamming distances in plain PyTorch: XOR and a SWAR
    popcount in int64 on the words masked to 32 bits (torch lacks shifts and
    subtraction on uint32 on the CPU).  Processed in query chunks to bound
    memory."""
    q = packed_q.to(torch.int64) & 0xFFFFFFFF
    d = packed_d.to(torch.int64) & 0xFFFFFFFF
    nq, nd = q.shape[0], d.shape[0]
    out = torch.empty((nq, nd), dtype=torch.int32, device=q.device)
    step = max(1, (1 << 22) // max(nd * WORDS, 1))
    for s in range(0, nq, step):
        x = q[s:s + step, None, :] ^ d[None, :, :]
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
        out[s:s + step] = x.sum(-1).to(torch.int32)
    return out


def hamming_matrix_packed(packed_q: torch.Tensor, packed_d: torch.Tensor,
                          site: str = "assoc") -> torch.Tensor:
    """(NQ, ND) int32 Hamming distances of packed descriptors; any NQ, ND.
    `site` names the caller in the per-site launch counts."""
    _check_packed(packed_q, "packed_q")
    _check_packed(packed_d, "packed_d")
    if packed_q.device != packed_d.device:
        raise ValueError("packed_q and packed_d must be on the same device")
    if packed_q.device.type == "cpu":
        return hamming_matrix_plain(packed_q, packed_d)
    if packed_q.device.type != "cuda":
        raise ValueError(f"unsupported device {packed_q.device}")
    nq, nd = packed_q.shape[0], packed_d.shape[0]
    out = torch.empty((nq, nd), dtype=torch.int32, device=packed_q.device)
    if nq == 0 or nd == 0:
        return out
    lib = KERNEL.load()
    with torch.cuda.device(packed_q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.okvis_hamming_i32(
            packed_q.data_ptr(), packed_d.data_ptr(), out.data_ptr(), nq, nd, stream
        )
    if err != 0:
        msg = lib.okvis_cuda_error_string(err).decode()
        raise RuntimeError(f"hamming kernel launch failed: {msg} ({err})")
    _count_launch(hamming_matrix_packed, site)
    return out


hamming_matrix_packed.launches = 0
hamming_matrix_packed.site_launches = {}

# hamming_match packs a cell's value and an index into one 32-bit key
_KEY_VALUE_MAX = 511  # 9 bits; a larger fill is carried as 511 and mapped back
MATCH_MAX_ROWS = 1 << 20  # rows and columns (a 23-bit index, 65535 rows of blocks)
_MATCH_BLOCKS = 2048  # blocks above which a block of the match kernel walks several tiles


def _check_tensor(x, name: str, dtype, shape, device):
    """An optional argument of `hamming_match`: None, or as the kernel reads it."""
    if x is None:
        return
    if x.dtype != dtype or x.shape != shape:
        raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name}: must be on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_match_args(q, vq, d, vd, allowed, seg, row_seg, fill_invalid, fill_disallowed,
                      want_cols):
    """Validate the arguments of `hamming_match`; returns the segment length."""
    _check_packed(q, "q")
    _check_packed(d, "d")
    if q.device != d.device:
        raise ValueError("q and d must be on the same device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    nq, nd = q.shape[0], d.shape[0]
    if nd < 1:
        raise ValueError("d: an empty database has no best match")
    if nq > MATCH_MAX_ROWS or nd > MATCH_MAX_ROWS:
        raise ValueError(f"at most {MATCH_MAX_ROWS} rows and columns, got {nq} x {nd}")
    _check_tensor(vq, "vq", torch.bool, (nq,), q.device)
    _check_tensor(vd, "vd", torch.bool, (nd,), q.device)
    _check_tensor(allowed, "allowed", torch.bool, (nq, nd), q.device)
    _check_tensor(row_seg, "row_seg", torch.int32, (nq,), q.device)
    seg = nd if seg is None else int(seg)
    if seg < 1 or nd % seg:
        raise ValueError(f"seg {seg} does not divide ND {nd}")
    for name, f in (("fill_invalid", fill_invalid), ("fill_disallowed", fill_disallowed)):
        if f is not None and not (f == int(f) and 0 <= f < 1 << 31):
            raise ValueError(f"{name}: expected a whole number in [0, 2^31), got {f}")
    if allowed is not None:
        if fill_disallowed is None:
            raise ValueError("allowed needs fill_disallowed")
        # the keys carry any fill above 511 as 511: two such fills must be one
        if (min(fill_invalid, _KEY_VALUE_MAX) == min(fill_disallowed, _KEY_VALUE_MAX)
                and fill_invalid != fill_disallowed):
            raise ValueError("fill_invalid and fill_disallowed above 510 must be equal")
    if row_seg is not None and (allowed is not None or want_cols):
        raise ValueError("row_seg goes with neither allowed nor want_cols")
    return seg


def hamming_match_plain(q, vq, d, vd, allowed=None, seg=None, row_seg=None,
                        fill_invalid=DESC_BITS + 1, fill_disallowed=None, want_cols=False):
    """`hamming_match` in plain PyTorch: the distance matrix, the fills, then
    argmins (first index on ties)."""
    seg = _check_match_args(q, vq, d, vd, allowed, seg, row_seg, fill_invalid,
                            fill_disallowed, want_cols)
    nq, nd = q.shape[0], d.shape[0]
    D = hamming_matrix_plain(q, d)
    if vq is not None:
        D = torch.where(vq[:, None], D, torch.full_like(D, int(fill_invalid)))
    if vd is not None:
        D = torch.where(vd[None, :], D, torch.full_like(D, int(fill_invalid)))
    if allowed is not None:
        D = torch.where(allowed, D, torch.full_like(D, int(fill_disallowed)))
    if row_seg is not None:
        first = row_seg.to(torch.int64).clamp(0, nd // seg - 1) * seg
        cols = first[:, None] + torch.arange(seg, device=D.device)
        Ds = torch.gather(D, 1, cols)
        idx = torch.argmin(Ds, dim=1, keepdim=True)
        return torch.gather(Ds, 1, idx)[:, 0], (first[:, None] + idx)[:, 0], None
    Ds = D.reshape(nq, nd // seg, seg)
    idx = torch.argmin(Ds, dim=2, keepdim=True)
    row_min = torch.gather(Ds, 2, idx)[:, :, 0]
    row_arg = idx[:, :, 0] + torch.arange(0, nd, seg, device=D.device)
    col_arg = None
    if want_cols:  # with no row to point at: zeros
        col_arg = (torch.argmin(D, dim=0) if nq
                   else torch.zeros((nd,), dtype=torch.int64, device=D.device))
    return row_min, row_arg, col_arg


def hamming_match(q, vq, d, vd, allowed=None, seg=None, row_seg=None,
                  fill_invalid=DESC_BITS + 1, fill_disallowed=None, want_cols=False,
                  site: str = "assoc"):
    """Best database row per query without the distance matrix.

    q (NQ, 12), d (ND, 12) int32 packed descriptors; vq (NQ,), vd (ND,) bool
    or None (all valid); allowed (NQ, ND) bool or None.  A cell is the
    Hamming distance where both rows are valid, `fill_invalid` elsewhere, and
    `fill_disallowed` where `allowed` is false.  The database axis is cut
    into S = ND / seg segments (one when `seg` is None).  Returns

      row_min (NQ, S) int32   least cell of the row in each segment,
      row_arg (NQ, S) int64   its first column (an index into d),
      col_arg (ND,) int64     first row of each column's least cell, when
                              `want_cols`, else None.

    With `row_seg` (NQ,) int32, row i looks only at segment row_seg[i]
    (clamped to [0, S)) and row_min, row_arg are (NQ,).  `site` names the
    caller in the launch counts."""
    seg = _check_match_args(q, vq, d, vd, allowed, seg, row_seg, fill_invalid,
                            fill_disallowed, want_cols)
    if q.device.type == "cpu":
        return hamming_match_plain(q, vq, d, vd, allowed, seg, row_seg, fill_invalid,
                                   fill_disallowed, want_cols)
    nq, nd = q.shape[0], d.shape[0]
    n_seg = nd // seg
    dev = q.device
    shape = (nq,) if row_seg is not None else (nq, n_seg)
    row_min = torch.empty(shape, dtype=torch.int32, device=dev)
    row_arg = torch.empty(shape, dtype=torch.int64, device=dev)
    col_arg = None
    if want_cols:  # with no row to point at: zeros
        col_arg = (torch.empty if nq else torch.zeros)((nd,), dtype=torch.int64, device=dev)
    if nq == 0:
        return row_min, row_arg, col_arg
    fill_invalid = int(fill_invalid)
    fill_dis = -1 if fill_disallowed is None else int(fill_disallowed)
    scratch = None
    walk = words = 1
    if row_seg is None:
        # the grid, gx x gy blocks of 32 rows that each walk `walk` tiles of
        # 64 columns inside a segment: one tile, until there are more tiles
        # than _MATCH_BLOCKS.  Every block leaves a partial key for each of
        # its rows and, with want_cols, each of its columns.
        tiles_per_seg, gy = -(-seg // 64), -(-nq // 32)
        walk = max(1, n_seg * tiles_per_seg * gy // _MATCH_BLOCKS)
        gx = n_seg * -(-tiles_per_seg // walk)
        words = nq * gx + (gy * nd if want_cols else 0)
        if words >= 1 << 31:
            raise ValueError(f"{nq} x {nd} in segments of {seg}: too many partial keys")
        scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = KERNEL.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.okvis_hamming_match(
            q.data_ptr(), d.data_ptr(), ptr(vq), ptr(vd), ptr(allowed), ptr(row_seg),
            nq, nd, seg, walk, min(fill_invalid, _KEY_VALUE_MAX),
            min(fill_dis, _KEY_VALUE_MAX), fill_invalid, fill_dis,
            ptr(scratch), words, row_min.data_ptr(), row_arg.data_ptr(), ptr(col_arg), stream,
        )
    if err != 0:
        msg = lib.okvis_cuda_error_string(err).decode()
        raise RuntimeError(f"hamming match kernel launch failed: {msg} ({err})")
    _count_launch(hamming_match, site)
    return row_min, row_arg, col_arg


hamming_match.launches = 0
hamming_match.site_launches = {}


def reset_launch_counts():
    with _COUNT_LOCK:
        for fn in (hamming_matrix_packed, hamming_match):
            fn.launches = 0
            fn.site_launches.clear()


def best_matches_packed(packed_q, packed_d, max_dist=60):
    """Best database match per query + distance, from packed descriptors."""
    d, idx, _ = hamming_match(packed_q, None, packed_d, None)
    d = d[:, 0]
    return idx[:, 0].to(torch.int32), d, d <= max_dist


def match_packed_mutual(packed_q, valid_q, packed_d, valid_d, max_dist: float = 60.0,
                        site: str = "assoc"):
    """Mutual best matching straight from packed descriptors; invalid rows
    and columns are masked to 385 (one above any real distance).  Returns
    (idx_d (NQ,) int32, dist (NQ,) float32, valid (NQ,) bool).  `site`
    names the caller in the launch counts."""
    nq = packed_q.shape[0]
    d, idx, back = hamming_match(packed_q, valid_q, packed_d, valid_d,
                                 fill_invalid=DESC_BITS + 1, want_cols=True, site=site)
    idx, d = idx[:, 0], d[:, 0].to(torch.float32)
    mutual = back[idx] == torch.arange(nq, device=idx.device)
    return idx.to(torch.int32), d, valid_q & mutual & (d <= max_dist)
