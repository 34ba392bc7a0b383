"""The port's occupancy submaps against the JAX package: ray and depth-image
integration, interpolation, the observed mask, the occupied-voxel list and
colour splatting on a 32^3 grid; the submapping interface's life cycle on
both packages; the port's versions of the depth and colour cases of
tests/test_submapping.py.  The brick-sparse grid is held in
tests/test_torch_brick.py, the mesh and VTK exports in tests/test_torch_mesh.py.
The LiDAR half (integration, alignment edges) is held in
tests/test_torch_lidar.py.

The JAX functions run jitted, as the JAX package's interface runs them (XLA
folds their `jnp.linspace` sample fractions differently outside a program).

Tolerances: log-odds to 1e-6 (float32 sums of the same updates in another
order), integration counts (weights) exactly, occupied voxel sets and
observed masks exactly, interpolated values and gradients to 1e-5, colours
to 1e-6."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.io import config as jconfig
from okvis2x_tpu.mapping import colour as jcol
from okvis2x_tpu.mapping import submap as jsm
from okvis2x_tpu.pipeline import submapping as jsub
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.io import config
from okvis2x_tpu_torch.mapping import colour, submap
from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig, SubmappingInterface

torch.set_num_threads(1)

GRID = dict(dim=32, res=0.2)
I7 = np.array([0, 0, 0, 0, 0, 0, 1.0])


def cams(w=128, h=96, f=100.0):
    kw = dict(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h, model="none")
    jcam = jpin.make_pinhole(**kw, dtype=jnp.float64)
    return jcam, convert.camera(jcam)


def wall(rng, h=96, w=128, z=2.5):
    """A slanted wall with noise and a few invalid pixels (0 and inf)."""
    ys, xs = np.mgrid[0:h, 0:w]
    d = (z + 0.004 * xs + 0.002 * ys + rng.normal(0, 0.01, (h, w))).astype(np.float32)
    d[rng.uniform(size=(h, w)) < 0.05] = 0.0
    d[:3, :5] = np.inf
    return d


def pose(x=0.0, y=0.0, yaw=0.0):
    return np.array([x, y, 0.0, 0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])


def occupied_set(centres, valid):
    return {tuple(np.round(p, 4)) for p in np.asarray(centres)[np.asarray(valid)]}


def compare_maps(t, j, cfg_t, cfg_j):
    np.testing.assert_allclose(t.logodds.cpu().numpy(), np.asarray(j.logodds), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.weight.cpu().numpy(), np.asarray(j.weight))
    ct, vt = submap.occupied_point_list(t, cfg_t, max_points=8192)
    cj, vj = jsm.occupied_point_list(j, cfg_j, max_points=8192)
    assert occupied_set(ct, vt) == occupied_set(cj, vj)
    return int(vt.sum())


@pytest.mark.parametrize("per_ray_sigma", [False, True])
def test_integrate_rays_matches_jax(per_ray_sigma):
    rng = np.random.default_rng(0)
    n = 300
    origin = np.array([0.1, -0.2, 0.05], np.float32)
    end = (origin + rng.normal(0, 1, (n, 3)) * [1.0, 1.0, 0.3] + [0, 0, 2.0]).astype(np.float32)
    valid = rng.uniform(size=n) < 0.9
    sigma = rng.uniform(0.02, 0.5, n).astype(np.float32) if per_ray_sigma else 0.1
    cfg_t, cfg_j = submap.SubmapConfig(**GRID), jsm.SubmapConfig(**GRID)
    t = submap.new_submap(I7, cfg_t)
    j = jsm.new_submap(I7, cfg_j)
    for _ in range(2):
        t = submap.integrate_rays(t, cfg_t, torch.from_numpy(origin), torch.from_numpy(end),
                                  torch.from_numpy(valid), torch.as_tensor(sigma))
        j = jax.jit(lambda *a: jsm.integrate_rays(j, cfg_j, *a))(
            jnp.asarray(origin), jnp.asarray(end), jnp.asarray(valid), jnp.asarray(sigma))
    assert compare_maps(t, j, cfg_t, cfg_j) > 20
    pts = rng.uniform(-3.5, 3.5, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(submap.observed_mask(t, cfg_t, torch.from_numpy(pts)).numpy(),
                                  np.asarray(jsm.observed_mask(j, cfg_j, jnp.asarray(pts))))
    for ft, fj in ((submap.interp_occupancy, jsm.interp_occupancy),
                   (submap.grad_occupancy, jsm.grad_occupancy)):
        vt, okt = ft(t, cfg_t, torch.from_numpy(pts))
        vj, okj = fj(j, cfg_j, jnp.asarray(pts))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-5)
    ct, occ_t = submap.occupied_points(t, cfg_t)
    cj, occ_j = jsm.occupied_points(j, cfg_j)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(occ_t.numpy(), np.asarray(occ_j))


def test_integrate_depth_image_and_colour_match_jax():
    """A depth image at a camera pose in the submap (float32, as the
    interfaces pass it), the colour of its pixels splatted into the end
    points' voxels, and the colours read back."""
    rng = np.random.default_rng(1)
    jcam, cam = cams()
    depth = wall(rng)
    sigma = (0.01 * depth * depth).astype(np.float32)
    T_KC = pose(0.3, -0.1, 0.2).astype(np.float32)
    cfg_t, cfg_j = submap.SubmapConfig(**GRID), jsm.SubmapConfig(**GRID)
    t, j = submap.new_submap(I7, cfg_t), jsm.new_submap(I7, cfg_j)
    for _ in range(2):  # one integration moves a voxel by at most log_odd_occ
        t = submap.integrate_depth_image(t, cfg_t, cam, torch.from_numpy(T_KC),
                                         torch.from_numpy(depth), torch.from_numpy(sigma),
                                         stride=4, max_depth=20.0)
        j = jax.jit(lambda sm, *a: jsm.integrate_depth_image(sm, cfg_j, jcam, *a, stride=4))(
            j, jnp.asarray(T_KC), jnp.asarray(depth), jnp.asarray(sigma))
    assert compare_maps(t, j, cfg_t, cfg_j) > 20
    col = rng.uniform(0, 1, depth.shape + (3,)).astype(np.float32)
    _, p_K, ok = submap.depth_rays(cam, torch.from_numpy(T_KC), torch.from_numpy(depth), 4, 20.0)
    st = colour.splat(colour.new_store(cfg_t), cfg_t, p_K, torch.from_numpy(col[::4, ::4])
                      .reshape(-1, 3), ok)
    sj = jcol.splat(jcol.new_store(cfg_j), j, cfg_j, jnp.asarray(p_K.numpy()),
                    jnp.asarray(col[::4, ::4].reshape(-1, 3)), jnp.asarray(ok.numpy()))
    np.testing.assert_allclose(st.col.numpy(), np.asarray(sj.col), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.w.numpy(), np.asarray(sj.w))
    q = rng.uniform(-3.3, 3.3, (400, 3)).astype(np.float32)
    q[:200] = p_K.numpy()[:200]
    np.testing.assert_allclose(colour.colour_at(st, cfg_t, torch.from_numpy(q)).numpy(),
                               np.asarray(jcol.colour_at(sj, j, cfg_j, jnp.asarray(q))),
                               rtol=0, atol=1e-6)


def test_interface_matches_jax(tmp_path):
    """Both interfaces on a keyframe sequence: a first submap, a keyframe
    seen before, an overlapping one, then one beyond the grid (below the
    overlap threshold: a new submap); colour on the last two; the same
    submaps, anchors, keyframes, grids, colours and exported points."""
    rng = np.random.default_rng(2)
    jcam, cam = cams()
    cfg = dict(min_frames_integrated=2, depth_stride=2)
    jsi = jsub.SubmappingInterface(jsub.SubmappingConfig(submap=jsm.SubmapConfig(**GRID), **cfg))
    tsi = SubmappingInterface(SubmappingConfig(submap=submap.SubmapConfig(**GRID), **cfg),
                              device="cpu")
    seq = [(0, pose()), (0, pose(0.05)), (1, pose(0.1, 0.0, 0.05)), (2, pose(8.0, 2.0, 0.1))]
    for k, (kf, T_WC) in enumerate(seq):
        d = wall(rng)
        col = rng.uniform(0, 1, d.shape).astype(np.float32) if k >= 2 else None
        # anchors without rotation: both packages invert them exactly in
        # float32 (XLA contracts the cross products of a rotated one into
        # fused multiply-adds, which moves T_KC by an ulp)
        T_WK = pose(*T_WC[:2])
        jsi.integrate_depth(kf, T_WK, T_WC, jcam, d, colour=col)
        tsi.integrate_depth(kf, T_WK, T_WC, cam, d, colour=col)
    assert len(tsi.maps) == len(jsi.maps) == 2
    for a, b in zip(tsi.maps, jsi.maps):
        assert (a.anchor_fid, a.n_frames, a.kf_ids) == (b.anchor_fid, b.n_frames, b.kf_ids)
        np.testing.assert_array_equal(a.sm.T_WK.numpy(), np.asarray(b.sm.T_WK))
        compare_maps(a.sm, b.sm, tsi.cfg.submap, jsi.cfg.submap)
        assert (a.col is None) == (b.col is None)
    np.testing.assert_allclose(tsi.maps[1].col.col.numpy(), np.asarray(jsi.maps[1].col.col),
                               rtol=0, atol=1e-5)
    pt, pj = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert tsi.export_occupied_ply(pt) == jsi.export_occupied_ply(pj) > 20
    with open(pt) as f, open(pj) as g:
        assert f.read() == g.read()


def test_decide_new_submap_overlap_threshold():
    """Below `new_submap_overlap` of the points in observed voxels a new
    submap starts; at or above it the active one stays."""
    jcam, cam = cams()
    si = SubmappingInterface(SubmappingConfig(submap=submap.SubmapConfig(**GRID),
                                              min_frames_integrated=1), device="cpu")
    si.integrate_depth(0, I7, I7, cam, np.full((96, 128), 2.0, np.float32))
    a = si.active
    pts = torch.tensor([[0.0, 0.0, 2.0]] * 8 + [[50.0, 0.0, 2.0]] * 92, dtype=torch.float32)
    good = torch.ones(100, dtype=torch.bool)
    assert si._overlap_fraction(a, pts, good) == pytest.approx(0.08)
    assert si.decide_new_submap(1, pts, good)
    pts[8:11, 0] = 0.0  # 11 of 100 in observed voxels
    assert si._overlap_fraction(a, pts, good) == pytest.approx(0.11)
    assert not si.decide_new_submap(1, pts, good)
    assert not si.decide_new_submap(0, pts[8:], good[8:])  # a keyframe the submap has


# -------------------------------------- the port's cases of tests/test_submapping.py

CFG = SubmappingConfig(submap=submap.SubmapConfig(dim=64, res=0.2), min_frames_integrated=2)


def wall_depth(cam, z=3.0):
    return np.full((cam.height, cam.width), z, np.float32)


def test_depth_integration_and_lifecycle():
    _, cam = cams()
    si = SubmappingInterface(CFG, device="cpu")
    si.integrate_depth(0, I7, I7, cam, wall_depth(cam))
    assert len(si.maps) == 1
    si.integrate_depth(0, I7, I7, cam, wall_depth(cam))
    assert si.active.n_frames == 2
    si.integrate_depth(0, I7, I7, cam, wall_depth(cam))  # the same keyframe
    assert len(si.maps) == 1
    T_far = np.array([100.0, 0, 0, 0, 0, 0, 1.0])
    si.integrate_depth(1, T_far, T_far, cam, wall_depth(cam))
    assert len(si.maps) == 2 and si.maps[0].finished


def test_occupied_export(tmp_path):
    _, cam = cams()
    si = SubmappingInterface(CFG, device="cpu")
    for _ in range(3):
        si.integrate_depth(0, I7, I7, cam, wall_depth(cam))
    path = os.path.join(tmp_path, "map.ply")
    assert si.export_occupied_ply(path) > 50
    pts = np.loadtxt(path, skiprows=7)
    assert np.abs(np.median(pts[:, 2]) - 3.0) < 0.3


def test_reanchoring():
    _, cam = cams()
    si = SubmappingInterface(CFG, device="cpu")
    si.integrate_depth(5, I7, I7, cam, wall_depth(cam))
    T_new = np.array([0.5, 0.2, 0.0, 0, 0, 0, 1.0])
    si.on_state_update({5: T_new})
    np.testing.assert_allclose(si.maps[0].sm.T_WK.numpy(), T_new)


def test_overlap_triggers_reuse():
    _, cam = cams()
    si = SubmappingInterface(CFG, device="cpu")
    si.integrate_depth(0, I7, I7, cam, wall_depth(cam))
    si.integrate_depth(0, I7, I7, cam, wall_depth(cam))
    T_near = np.array([0.1, 0.0, 0.0, 0, 0, 0, 1.0])
    si.integrate_depth(1, T_near, T_near, cam, wall_depth(cam))
    assert len(si.maps) == 1 and 1 in si.active.kf_ids


def test_colour_submap_integration(tmp_path):
    """A wall red on its left half and green on its right comes back with
    those colours; the point export carries RGB."""
    _, cam = cams()
    si = SubmappingInterface(CFG, device="cpu")
    H, W = cam.height, cam.width
    col = np.zeros((H, W, 3), np.float32)
    col[:, : W // 2, 0] = 1.0
    col[:, W // 2:, 1] = 1.0
    for _ in range(3):
        si.integrate_depth(0, I7, I7, cam, wall_depth(cam), colour=col)
    e = si.active
    c = colour.colour_at(e.col, CFG.submap, torch.tensor([[-1.0, 0.0, 3.0], [1.0, 0.0, 3.0]]))
    c = c.numpy()
    assert c[0, 0] > 0.8 and c[0, 1] < 0.2, c
    assert c[1, 1] > 0.8 and c[1, 0] < 0.2, c
    path = os.path.join(tmp_path, "col.ply")
    assert si.export_occupied_ply(path) > 50
    assert "property uchar red" in open(path).read(400)


def test_from_se2_dense_matches_jax():
    """An se2.yaml at a dense resolution gives the JAX package's config."""
    for se2_t, se2_j in ((config.SubMapConfig(map_dim=(25.6, 25.6, 25.6), map_res=0.2),
                          jconfig.SubMapConfig(map_dim=(25.6, 25.6, 25.6), map_res=0.2)),):
        a, b = SubmappingConfig.from_se2(se2_t), jsub.SubmappingConfig.from_se2(se2_j)
        assert tuple(a.submap) == tuple(b.submap)
        for k in ("new_submap_overlap", "new_submap_kf_count", "min_frames_integrated",
                  "align_points", "sensor_sigma", "depth_stride", "max_depth"):
            assert getattr(a, k) == getattr(b, k), k
