"""Submap meshes: marching tetrahedra over a dense log-odds grid, and the
ASCII PLY mesh writer (torch counterpart of ``okvis2x_tpu/mapping/mesh.py``,
the reference's per-submap ``map->mesh()`` export).

The extraction is host work in C++: ``native/mesh_mt.cpp`` (the JAX
package's source) is compiled with ``g++ -O2 -shared -fPIC`` on first use
into ``build/okvis2x_tpu_torch/`` at the root of the checkout, under the
port's build lock, and called through ctypes; a failed build raises.  The
JAX package builds its own copy into ``native/``, which the port never
touches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np
import torch

from okvis2x_tpu_torch.ops.hamming import BUILD_DIR, BUILD_LOCK

SRC = BUILD_DIR.parents[1] / "native" / "mesh_mt.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_LIB = None


def _load() -> ctypes.CDLL:
    global _LIB
    with BUILD_LOCK:
        if _LIB is None:
            digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
            so = BUILD_DIR / f"libmesh_mt_{digest.hexdigest()[:12]}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
                res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"g++ failed on {SRC}:\n{res.stdout}{res.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.mesh_marching_tetrahedra.restype = ctypes.c_int64
            lib.mesh_marching_tetrahedra.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
            _LIB = lib
    return _LIB


def extract_mesh(field, iso: float = 0.0) -> np.ndarray:
    """Triangles (T, 3, 3) in voxel coordinates of the iso surface of a dense
    (nx, ny, nz) scalar field (numpy or a tensor; iso 0 is the occupancy
    boundary of a log-odds grid)."""
    lib = _load()
    if torch.is_tensor(field):
        field = field.detach().cpu().numpy()
    f = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = f.shape
    cap = 1 << 20
    for _ in range(4):  # the library returns -(floats needed) when cap is short
        out = np.empty(cap, np.float32)
        n = lib.mesh_marching_tetrahedra(f.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                         nx, ny, nz, ctypes.c_float(iso),
                                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
        if n >= 0:
            return out[:n].reshape(-1, 3, 3)
        cap = int(-n) + 64
    raise RuntimeError("mesh buffer negotiation failed")


def submap_mesh(sm, cfg, iso: float = 0.0) -> np.ndarray:
    """Triangles (T, 3, 3) in submap-frame metres of a dense submap's
    log-odds; a brick-sparse submap has no dense field to mesh and raises
    (the JAX package fails there too, ROADMAP.md C-R16)."""
    if not hasattr(sm, "logodds"):
        raise ValueError("submap_mesh needs a dense grid: a brick-sparse submap has no "
                         "dense log-odds field to mesh (ROADMAP.md, C-R16)")
    tris = extract_mesh(sm.logodds, iso)
    half = cfg.dim * cfg.res / 2.0
    return (tris + 0.5) * cfg.res - half


def write_ply_mesh(path: str, tris: np.ndarray, colours=None):
    """ASCII PLY triangle mesh, three vertices a triangle; `colours` (T * 3,
    3) in [0, 1] adds per-vertex RGB."""
    nv = tris.shape[0] * 3
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {nv}\n"
                "property float x\nproperty float y\nproperty float z\n")
        if colours is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {tris.shape[0]}\n"
                "property list uchar int vertex_indices\nend_header\n")
        if colours is not None:
            cb = np.clip(np.asarray(colours) * 255, 0, 255).astype(np.uint8)
            for t, c in zip(tris.reshape(-1, 3), cb):
                f.write(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for t in tris.reshape(-1, 3):
                f.write(f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f}\n")
        for i in range(tris.shape[0]):
            f.write(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n")
