"""The port's submap meshes and VTK bounding boxes against the JAX package:
marching tetrahedra on a sphere field and on a submap's log-odds (the same
triangles; the port builds native/mesh_mt.cpp into build/okvis2x_tpu_torch/
with the JAX package's g++ flags), the interface's PLY mesh export
with and without colour, the VTK export of rotated submaps, the brick grid
that neither package meshes (C-R16 in ROADMAP.md), and the port's versions
of tests/test_mapping.py's mesh cases and tests/test_submapping.py's VTK
case.

The JAX package's mesh wrappers run here on the library the port builds
from the same source with the same flags: the JAX package builds its own
into native/ on first use without a lock, and its tests may be doing so in
another worker at the same moment.

Tolerances: triangles exactly; the PLY meshes' vertices within 1.5e-4 m
(both write 4 decimals of float32 world coordinates, which XLA composes with
fused multiply-adds) and their colours within 1/255; the VTK corners within
1e-6 m."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.mapping import brick as jbrick
from okvis2x_tpu.mapping import mesh as jmesh
from okvis2x_tpu.mapping import submap as jsm
from okvis2x_tpu.pipeline import submapping as jsub
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.mapping import brick, mesh
from okvis2x_tpu_torch.mapping import submap as sm_mod
from okvis2x_tpu_torch.ops.hamming import BUILD_DIR
from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig, SubmappingInterface

torch.set_num_threads(1)

GRID = dict(dim=48, res=0.1)
I7 = np.array([0, 0, 0, 0, 0, 0, 1.0])


@pytest.fixture(autouse=True)
def jax_mesh_library(monkeypatch):
    monkeypatch.setattr(jmesh, "_LIB", mesh._load())


def sphere(n=24, radius=8.0):
    g = np.mgrid[0:n, 0:n, 0:n].astype(np.float32)
    return radius - np.sqrt(((g - n / 2) ** 2).sum(axis=0))  # positive inside


def cams(w=96, h=72, f=80.0):
    kw = dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h, model="none")
    jcam = jpin.make_pinhole(**kw, dtype=jnp.float64)
    return jcam, convert.camera(jcam)


def wall_depth(rng, h=72, w=96, z=1.6):
    ys, xs = np.mgrid[0:h, 0:w]
    return (z + 0.003 * xs + 0.002 * ys + rng.normal(0, 0.005, (h, w))).astype(np.float32)


def yaw_pose(x, y, yaw):
    return np.array([x, y, 0.1, 0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def interfaces(colour):
    """Both interfaces after four depth images of a slanted wall into one
    submap anchored at a rotated keyframe, cam0 colour splatted when
    `colour`."""
    rng = np.random.default_rng(3)
    jcam, cam = cams()
    cfg = dict(min_frames_integrated=2, depth_stride=2)
    jsi = jsub.SubmappingInterface(jsub.SubmappingConfig(submap=jsm.SubmapConfig(**GRID), **cfg))
    tsi = SubmappingInterface(SubmappingConfig(submap=sm_mod.SubmapConfig(**GRID), **cfg),
                              device="cpu")
    T = yaw_pose(0.2, -0.1, 0.3)
    for _ in range(4):
        d = wall_depth(rng)
        col = rng.uniform(0, 1, d.shape + (3,)).astype(np.float32) if colour else None
        jsi.integrate_depth(0, T, T, jcam, d, colour=col)
        tsi.integrate_depth(0, T, T, cam, d, colour=col)
    return tsi, jsi


def read_ply_mesh(path):
    """(vertices (V, 3), colours (V, 3) or None, faces (F, 3))."""
    with open(path) as f:
        lines = f.read().splitlines()
    end = lines.index("end_header")
    nv = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[2])
    nf = int(next(ln for ln in lines if ln.startswith("element face")).split()[2])
    rgb = "property uchar red" in lines
    v = np.array([ln.split() for ln in lines[end + 1:end + 1 + nv]], np.float64)
    v = v.reshape(nv, 6 if rgb else 3)
    faces = np.array([ln.split()[1:] for ln in lines[end + 1 + nv:end + 1 + nv + nf]],
                     np.int64).reshape(nf, 3)
    return v[:, :3], (v[:, 3:] if rgb else None), faces


def test_native_mesh_extraction_matches_jax():
    """Marching tetrahedra on a sphere field: the JAX package's triangles,
    every vertex near the sphere (tests/test_mapping.py's case); the library
    is built under build/okvis2x_tpu_torch/, never into native/."""
    field = sphere()
    tris = mesh.extract_mesh(field, iso=0.0)
    np.testing.assert_array_equal(tris, jmesh.extract_mesh(field, iso=0.0))
    assert tris.shape[0] > 100 and tris.dtype == np.float32
    d = np.sqrt(((tris.reshape(-1, 3) - 12) ** 2).sum(axis=1))
    assert np.abs(d - 8.0).max() < 1.0
    np.testing.assert_array_equal(mesh.extract_mesh(torch.from_numpy(field), iso=0.5),
                                  jmesh.extract_mesh(field, iso=0.5))
    built = [p for p in os.listdir(BUILD_DIR) if p.startswith("libmesh_mt_")]
    assert built and mesh.SRC.parent.name == "native"
    assert not any(p.startswith("libmesh_mt_") for p in os.listdir(mesh.SRC.parent))


def test_submap_mesh_matches_jax():
    """A submap's mesh in submap-frame metres: on the JAX package's grid the
    JAX package's triangles exactly; on the port's own grid (log-odds within
    1e-6 of JAX's, tests/test_torch_submapping.py) the same count, vertices
    within 1e-5 m; the wall's surface near its depth (tests/test_mapping.py's
    world-scale case)."""
    tsi, jsi = interfaces(colour=False)
    j, jcfg = jsi.maps[0].sm, jsi.cfg.submap
    tris_j = jmesh.submap_mesh(j, jcfg)
    tris = mesh.submap_mesh(convert.submap_grid(j), convert.submap_config(jcfg))
    assert tris.shape[0] > 50
    np.testing.assert_array_equal(tris, tris_j)
    own = mesh.submap_mesh(tsi.maps[0].sm, tsi.cfg.submap)
    assert own.shape == tris_j.shape
    np.testing.assert_allclose(own, tris_j, rtol=0, atol=1e-5)
    z = np.median(tris[..., 2])
    assert 1.2 < z < 2.4  # the slanted wall 1.6-2.0 m ahead of the camera


@pytest.mark.parametrize("colour", [False, True])
def test_export_mesh_ply_matches_jax(tmp_path, colour):
    """The interface's PLY mesh of a rotated submap (world frame), with
    per-vertex colour when splatted: the same triangle count and faces,
    vertices and colours within the stated tolerances."""
    tsi, jsi = interfaces(colour)
    pt, pj = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    n = tsi.export_mesh_ply(pt, tsi.maps[0])
    assert n == jsi.export_mesh_ply(pj, jsi.maps[0]) > 50
    vt, ct, ft = read_ply_mesh(pt)
    vj, cj, fj = read_ply_mesh(pj)
    assert len(ft) == n
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1.5e-4)
    assert (ct is None) == (cj is None) == (not colour)
    if colour:
        assert np.abs(ct - cj).max() <= 1
        assert len(np.unique(ct, axis=0)) > 10  # splatted colours, not the grey default


def test_export_empty_mesh(tmp_path):
    """A submap with nothing above the iso level writes an empty mesh."""
    si = SubmappingInterface(SubmappingConfig(submap=sm_mod.SubmapConfig(**GRID)), device="cpu")
    si.start_submap(0, I7)
    path = str(tmp_path / "empty.ply")
    assert si.export_mesh_ply(path, si.maps[0]) == 0
    v, c, f = read_ply_mesh(path)
    assert len(v) == len(f) == 0 and c is None


def test_export_vtk_bboxes_matches_jax(tmp_path):
    """Bounding boxes of three submaps (one rotated, one re-anchored) as
    legacy VTK: the JAX package's file, corners within 1e-6 m; 24 points,
    three hexahedra (tests/test_submapping.py's case)."""
    cfg = dict(submap=GRID)
    tsi = SubmappingInterface(SubmappingConfig(submap=sm_mod.SubmapConfig(**cfg["submap"])),
                              device="cpu")
    jsi = jsub.SubmappingInterface(jsub.SubmappingConfig(submap=jsm.SubmapConfig(**GRID)))
    poses = [I7, np.array([5.0, 0, 0, 0, 0, 0, 1.0]), yaw_pose(1.0, 2.0, 0.7)]
    for si in (tsi, jsi):
        for k, T in enumerate(poses):
            si.start_submap(k, T)
        si.on_state_update({1: yaw_pose(5.2, 0.1, -0.4)})
    pt, pj = str(tmp_path / "port.vtk"), str(tmp_path / "jax.vtk")
    assert tsi.export_vtk_bboxes(pt) == pt
    jsi.export_vtk_bboxes(pj)
    lt, lj = open(pt).read().splitlines(), open(pj).read().splitlines()
    assert lt[0].startswith("# vtk DataFile") and len(lt) == len(lj)
    i = lt.index("POINTS 24 float")
    assert lj[i] == lt[i]
    pts_t = np.array([ln.split() for ln in lt[i + 1:i + 25]], np.float64)
    pts_j = np.array([ln.split() for ln in lj[i + 1:i + 25]], np.float64)
    np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=1e-6)
    assert lt[i + 25:] == lj[i + 25:]
    assert "CELL_TYPES 3" in lt
    # the boxes' extent: the grid's 4.8 m
    np.testing.assert_allclose(np.ptp(pts_t[:8], axis=0), 4.8, atol=1e-6)


def test_brick_grid_mesh_raises_in_both():
    """A brick-sparse submap has no dense log-odds to mesh: the JAX package
    fails on the missing field and the port raises (C-R16)."""
    cfg_j = jbrick.BrickConfig(table_dim=8, brick=8, res=0.2, pool_bricks=16)
    cfg_t = brick.BrickConfig(**cfg_j._asdict())
    with pytest.raises(AttributeError):
        jmesh.submap_mesh(jsm.new_submap(I7, cfg_j), cfg_j)
    with pytest.raises(ValueError, match="C-R16"):
        mesh.submap_mesh(sm_mod.new_submap(I7, cfg_t), cfg_t)
    si = SubmappingInterface(SubmappingConfig(submap=cfg_t), device="cpu")
    si.start_submap(0, I7)
    with pytest.raises(ValueError, match="dense grid"):
        si.export_mesh_ply("unused.ply", si.maps[0])
