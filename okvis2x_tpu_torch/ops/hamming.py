"""Packed binary-descriptor Hamming distances: the hand-written CUDA kernel
(``csrc/hamming.cu``) and its plain PyTorch version.

Counterpart of ``okvis2x_tpu/ops/hamming_pallas.py``.  Descriptors are 384
bits packed LSB-first into 12 words and stored as int32 tensors (the bits of
``np.ndarray.view(np.int32)`` of the uint32 words).

Dispatch: a CUDA tensor goes to the kernel; if the kernel cannot be built or
launched the error is raised.  A CPU tensor goes to the plain version.  The
kernel is compiled with ``nvcc`` for ``sm_90a`` on first use into
``build/okvis2x_tpu_torch/`` at the root of the checkout and loaded with
ctypes.  ``hamming_matrix_packed.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

WORDS = 12  # 384-bit descriptors
DESC_BITS = 32 * WORDS

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "hamming.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "okvis2x_tpu_torch"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]


class _Kernel:
    """Lazily built and loaded shared library of the CUDA kernel."""

    def __init__(self):
        self.lib = None
        self.build_log = ""

    def load(self):
        if self.lib is not None:
            return self.lib
        digest = hashlib.sha1(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"libokvis_hamming_{digest.hexdigest()[:12]}.so"
        if not out.exists():
            from torch.utils.cpp_extension import CUDA_HOME

            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
            if not nvcc or not os.path.exists(nvcc):
                nvcc = shutil.which("nvcc")
            if nvcc is None:
                raise RuntimeError("nvcc not found: cannot build csrc/hamming.cu")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stdout}{res.stderr}")
            self.build_log = res.stdout + res.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.okvis_hamming_i32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.okvis_hamming_i32.restype = ctypes.c_int
        lib.okvis_cuda_error_string.argtypes = [ctypes.c_int]
        lib.okvis_cuda_error_string.restype = ctypes.c_char_p
        self.lib = lib
        return lib


KERNEL = _Kernel()


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


def hamming_matrix_packed(packed_q: torch.Tensor, packed_d: torch.Tensor) -> torch.Tensor:
    """(NQ, ND) int32 Hamming distances of packed descriptors; any NQ, ND."""
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
    hamming_matrix_packed.launches += 1
    return out


hamming_matrix_packed.launches = 0


def best_matches_packed(packed_q, packed_d, max_dist=60):
    """Best database match per query + distance, from packed descriptors."""
    D = hamming_matrix_packed(packed_q, packed_d)
    idx = torch.argmin(D, dim=1)
    d = torch.gather(D, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), d, d <= max_dist


def match_packed_mutual(packed_q, valid_q, packed_d, valid_d, max_dist: float = 60.0):
    """Mutual best matching straight from packed descriptors; invalid rows
    and columns are masked to 385 (one above any real distance).  Returns
    (idx_d (NQ,) int32, dist (NQ,) float32, valid (NQ,) bool)."""
    nq = packed_q.shape[0]
    D = hamming_matrix_packed(packed_q, packed_d).to(torch.float32)
    big = torch.tensor(float(DESC_BITS + 1), dtype=torch.float32, device=D.device)
    D = torch.where(valid_d[None, :], D, big)
    D = torch.where(valid_q[:, None], D, big)
    idx = torch.argmin(D, dim=1)
    d = torch.gather(D, 1, idx[:, None])[:, 0]
    back = torch.argmin(D, dim=0)
    mutual = back[idx] == torch.arange(nq, device=D.device)
    return idx.to(torch.int32), d, valid_q & mutual & (d <= max_dist)
