"""The port's brick-sparse occupancy grid against the JAX package: the nine
cases of tests/test_brick.py, each run through both packages on the same
inputs (the 12.8 m grid at 0.2 m, the reference's 25.6 m at 0.025 m, a pool
of 4 bricks), the colour store on a brick grid, the field under forward-mode
Jacobians (the ICP rows of the window solver), and `SubmappingConfig.from_se2`
above 256^3.

The JAX functions run jitted, as the JAX package's interface runs them (XLA
folds their `jnp.linspace` sample fractions differently outside a program,
C-H10 in ROADMAP.md).

Tolerances: the brick table, the slots' brick coordinates and the allocated
count exactly; integration counts exactly on all but BOUNDARY_FLIPS of the
observed voxels (a ray sample on a voxel boundary moves by an ulp of XLA's
fused multiply-adds, C-H10) and log-odds within 1e-5 on the others (float32
sums of the same updates in another order); interpolated values, gradients,
the observed mask and the occupied list as the dense grid's tests hold them
(tests/test_torch_submapping.py): values and gradients within 1e-5, masks
and voxel sets exactly; the float32 ICP alignment within 2e-5 (as
tests/test_torch_icp.py holds it on the dense grid), the residuals and
Jacobians with float64 poses within 1e-7 of their largest entry (3.5e-8
apart on the 2.5 cm field, whose gradients are 8 times the 0.2 m grid's),
the alignment edge's information within EDGE_H_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from okvis2x_tpu.io import config as jconfig
from okvis2x_tpu.mapping import brick as jbrick
from okvis2x_tpu.mapping import colour as jcol
from okvis2x_tpu.mapping import icp_factor as jicp
from okvis2x_tpu.mapping import submap as jsm
from okvis2x_tpu.pipeline import submapping as jsub
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.io import config
from okvis2x_tpu_torch.mapping import brick, colour, icp_factor
from okvis2x_tpu_torch.mapping import submap as sm_mod
from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig, SubmappingInterface

torch.set_num_threads(1)

F32 = torch.float32
I7 = np.array([0, 0, 0, 0, 0, 0, 1.0])
# tests/test_brick.py's grids: 12.8 m at 0.2 m, and the reference se2.yaml's
# 25.6 m at 0.025 m (1024^3 voxels, a 128^3 table)
COARSE = dict(table_dim=8, brick=8, res=0.2, pool_bricks=256)
FINE = dict(table_dim=128, brick=8, res=0.025, pool_bricks=4096, samples_per_ray=96,
            band_samples=24)
TINY = dict(table_dim=8, brick=8, res=0.2, pool_bricks=4)
DENSE = dict(dim=64, res=0.2)
BOUNDARY_FLIPS = 2e-4  # of the observed voxels (16 of 109,616 on the fine wall)
# the float32 alignment edge on the 2.5 cm field: its information H of the
# first submap's points against the second's field, relative to H's largest
# entry; points near trilinear cell boundaries take either cell's gradient
# by an ulp (C-H13), and H's largest entry is 4e12 here (2.4e-4 apart)
EDGE_H_TOL = 1e-3


def wall_end_points(n=40, z=2.0, extent=3.0):
    xs = np.linspace(-extent, extent, n)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], -1).astype(np.float32)


def make_wall(kw, passes=3, n=40, z=2.0, extent=3.0):
    """tests/test_brick.py's wall (rays from the origin to the plane z, sigma
    0.05) in both packages: (port submap, config; JAX submap, config)."""
    brick_grid = "table_dim" in kw
    tcfg = brick.BrickConfig(**kw) if brick_grid else sm_mod.SubmapConfig(**kw)
    jcfg = jbrick.BrickConfig(**kw) if brick_grid else jsm.SubmapConfig(**kw)
    t, j = sm_mod.new_submap(I7, tcfg), jsm.new_submap(I7, jcfg)
    end = wall_end_points(n, z, extent)
    fn = jax.jit(lambda s, e, v: jsm.integrate_rays(s, jcfg, jnp.zeros(3, jnp.float32), e, v,
                                                     0.05))
    for _ in range(passes):
        t = sm_mod.integrate_rays(t, tcfg, torch.zeros(3), torch.from_numpy(end),
                                  torch.ones(len(end), dtype=torch.bool), 0.05)
        j = fn(j, jnp.asarray(end), jnp.ones(len(end), bool))
    return t, tcfg, j, jcfg


def compare_grids(t, j):
    """The port's brick submap against the JAX one: allocation exactly,
    counts on all but BOUNDARY_FLIPS of the observed voxels, log-odds
    within 1e-5 elsewhere; returns the allocated bricks."""
    np.testing.assert_array_equal(t.table.numpy(), np.asarray(j.table))
    np.testing.assert_array_equal(t.brick_xyz.numpy(), np.asarray(j.brick_xyz))
    assert t.table.dtype == t.brick_xyz.dtype == t.n_alloc.dtype == torch.int32
    assert int(t.n_alloc) == int(j.n_alloc)
    w_t, w_j = t.pool_w.numpy(), np.asarray(j.pool_w)
    same = w_t == w_j
    assert (~same).sum() <= BOUNDARY_FLIPS * (w_j > 0).sum(), ((~same).sum(), (w_j > 0).sum())
    np.testing.assert_allclose(t.pool_lo.numpy()[same], np.asarray(j.pool_lo)[same], rtol=0,
                               atol=1e-5)
    return int(t.n_alloc)


def field_points(rng, n=200):
    return np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2.5, 2.5, n),
                     rng.uniform(0.2, 2.3, n)], -1).astype(np.float32)


def interp_both(t, tcfg, j, jcfg, pts):
    """(value, inside) of both packages at pts (numpy)."""
    vt, okt = sm_mod.interp_occupancy(t, tcfg, torch.from_numpy(pts))
    vj, okj = jsm.interp_occupancy(j, jcfg, jnp.asarray(pts))
    return vt.numpy(), okt.numpy(), np.asarray(vj), np.asarray(okj)


def test_brick_matches_dense_field():
    """At equal resolution and updates the brick field equals the dense one
    wherever observed, and the port's brick grid equals the JAX package's:
    allocation, counts, log-odds, values and gradients."""
    t, tcfg, j, jcfg = make_wall(COARSE)
    assert 0 < compare_grids(t, j) <= COARSE["pool_bricks"]
    td, dcfg, _, _ = make_wall(DENSE)
    pts = field_points(np.random.default_rng(4))
    vt, okt, vj, okj = interp_both(t, tcfg, j, jcfg, pts)
    vd, okd = sm_mod.interp_occupancy(td, dcfg, torch.from_numpy(pts))
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_array_equal(okt, okd.numpy())
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vt, vd.numpy(), rtol=0, atol=1e-5)
    gt, _ = sm_mod.grad_occupancy(t, tcfg, torch.from_numpy(pts))
    gj, _ = jsm.grad_occupancy(j, jcfg, jnp.asarray(pts))
    gd, _ = sm_mod.grad_occupancy(td, dcfg, torch.from_numpy(pts))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gt.numpy(), gd.numpy(), rtol=0, atol=1e-4)


def test_fine_resolution_surface():
    """25.6 m at 2.5 cm (the reference se2.yaml, 1024^3): the grids equal,
    the surface band localises the wall within ~2 voxels and free space
    stays free, in both packages."""
    t, tcfg, j, jcfg = make_wall(FINE, passes=3, n=60, z=2.0, extent=0.7)
    compare_grids(t, j)
    q = np.array([[0.0, 0.0, 2.075], [0.4, -0.4, 2.075], [0.0, 0.0, 1.95], [0.4, -0.4, 1.95],
                  [0.0, 0.0, 1.0], [0.0, 0.0, 2.35]], np.float32)
    vt, okt, vj, okj = interp_both(t, tcfg, j, jcfg, q)
    np.testing.assert_array_equal(okt, okj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    assert okt.all()
    assert vt[:2].min() > 0.3  # 7.5 cm behind the wall
    assert vt[2:4].max() < -0.02  # 5 cm in front
    assert vt[4] < -0.1  # free space
    assert abs(vt[5]) < 0.3  # unobserved behind the wall


def test_allocation_bounded_and_reused():
    """One pass allocates within the pool; the same geometry again allocates
    nothing new, in both packages."""
    t, tcfg, j, jcfg = make_wall(COARSE, passes=1)
    n1 = compare_grids(t, j)
    assert 0 < n1 <= COARSE["pool_bricks"]
    end = wall_end_points()
    t2 = sm_mod.integrate_rays(t, tcfg, torch.zeros(3), torch.from_numpy(end),
                               torch.ones(len(end), dtype=torch.bool), 0.05)
    j2 = jax.jit(lambda s: jsm.integrate_rays(s, jcfg, jnp.zeros(3, jnp.float32),
                                              jnp.asarray(end), jnp.ones(len(end), bool),
                                              0.05))(j)
    assert compare_grids(t2, j2) == n1
    np.testing.assert_array_equal(t2.table.numpy(), t.table.numpy())


def test_pool_overflow_is_safe():
    """A pool of 4 bricks: the count clamps at capacity, the bricks beyond it
    stay unallocated (their samples go to the trash voxel, which stays 0),
    reads stay finite; as in the JAX package."""
    t, tcfg, j, jcfg = make_wall(TINY, passes=1)
    assert compare_grids(t, j) == 4
    assert float(t.pool_lo[-1]) == float(t.pool_w[-1]) == 0.0
    assert int((t.table >= 0).sum()) == 4
    vt, okt, vj, okj = interp_both(t, tcfg, j, jcfg, np.array([[0.0, 0.0, 2.0]], np.float32))
    assert np.isfinite(vt).all()
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)


def test_out_of_map_zero():
    t, tcfg, j, jcfg = make_wall(COARSE, passes=1)
    far = np.array([[100.0, 0.0, 0.0]], np.float32)
    vt, okt, vj, okj = interp_both(t, tcfg, j, jcfg, far)
    gt, _ = sm_mod.grad_occupancy(t, tcfg, torch.from_numpy(far))
    assert not okt[0] and not okj[0] and vt[0] == 0.0 == vj[0]
    assert float(gt.abs().max()) == 0.0


def test_gradient_matches_finite_difference():
    """The analytic gradient against central differences of the field, and
    against the JAX package's gradient."""
    t, tcfg, j, jcfg = make_wall(COARSE)
    p = np.array([[0.33, -0.41, 1.87]], np.float32)
    gt, _ = sm_mod.grad_occupancy(t, tcfg, torch.from_numpy(p))
    gj, _ = jsm.grad_occupancy(j, jcfg, jnp.asarray(p))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    eps = 1e-3
    for ax in range(3):
        d = np.zeros(3, np.float32)
        d[ax] = eps
        vp, _ = sm_mod.interp_occupancy(t, tcfg, torch.from_numpy(p + d))
        vm, _ = sm_mod.interp_occupancy(t, tcfg, torch.from_numpy(p - d))
        num = (float(vp[0]) - float(vm[0])) / (2 * eps)
        np.testing.assert_allclose(float(gt[0, ax]), num, atol=2e-2)


def test_observed_mask_and_occupied_list():
    """The observed mask and the occupied list (pool order, rows past the
    count filled as the JAX package's fixed-size nonzero fills them) equal
    the JAX package's; the occupied voxels sit on the wall."""
    t, tcfg, j, jcfg = make_wall(COARSE)
    rng = np.random.default_rng(6)
    q = np.concatenate([np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 5.9]], np.float32),
                        rng.uniform([-4, -4, -1], [4, 4, 3], (300, 3)).astype(np.float32)])
    seen = sm_mod.observed_mask(t, tcfg, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(seen, np.asarray(jsm.observed_mask(j, jcfg, jnp.asarray(q))))
    assert seen[0] and not seen[1] and 20 < seen.sum() < 300
    for cap in (512, 64):
        ct, vt = sm_mod.occupied_point_list(t, tcfg, 1.0, cap)
        cj, vj = jsm.occupied_point_list(j, jcfg, 1.0, cap)
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
    ct, vt = sm_mod.occupied_point_list(t, tcfg, 1.0, 512)
    pts = ct.numpy()[vt.numpy()]
    assert len(pts) > 50
    assert np.abs(pts[:, 2] - 2.0).max() < 0.35


def test_colour_on_brick_grid():
    """Colours splatted through the brick table (points in unallocated
    bricks go to the trash row) and read back, against the JAX package."""
    t, tcfg, j, jcfg = make_wall(COARSE, passes=1)
    rng = np.random.default_rng(7)
    end = wall_end_points()
    p = np.concatenate([end, rng.uniform(-6, 6, (200, 3)).astype(np.float32)])
    col = rng.uniform(0, 1, (len(p), 3)).astype(np.float32)
    valid = rng.uniform(size=len(p)) < 0.9
    st = colour.splat(colour.new_store(tcfg), tcfg, torch.from_numpy(p), torch.from_numpy(col),
                      torch.from_numpy(valid), sm=t)
    sj = jcol.splat(jcol.new_store(jcfg), j, jcfg, jnp.asarray(p), jnp.asarray(col),
                    jnp.asarray(valid))
    assert st.col.shape[0] == COARSE["pool_bricks"] * 512 + 1
    np.testing.assert_allclose(st.col.numpy(), np.asarray(sj.col), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.w.numpy(), np.asarray(sj.w))
    np.testing.assert_allclose(
        colour.colour_at(st, tcfg, torch.from_numpy(p), sm=t).numpy(),
        np.asarray(jcol.colour_at(sj, j, jcfg, jnp.asarray(p))), rtol=0, atol=1e-6)


def test_icp_align_through_brick_field():
    """Frame-to-map Gauss-Newton alignment against the fine brick field
    recovers a 15 cm z offset, as the JAX package's does; the residuals and
    forward-mode Jacobians through the two chained gathers equal JAX's."""
    t, tcfg, j, jcfg = make_wall(FINE, passes=3, n=60, z=2.0, extent=0.7)
    rng = np.random.default_rng(11)
    dz_true = 0.15
    pts = np.stack([rng.uniform(-0.6, 0.6, 200), rng.uniform(-0.6, 0.6, 200),
                    np.full(200, 2.0 - dz_true)], -1).astype(np.float32)
    args_t = [torch.tensor(I7, dtype=F32), torch.tensor(I7, dtype=F32), torch.from_numpy(pts),
              torch.ones(200, dtype=torch.bool)]
    args_j = [jnp.asarray(I7, jnp.float32), jnp.asarray(I7, jnp.float32), jnp.asarray(pts),
              jnp.ones(200, bool)]
    T_est, cost = icp_factor.icp_align(t, tcfg, *args_t, iterations=10)
    Tj, cost_j = jax.jit(lambda *a: jicp.icp_align(j, jcfg, *a, iterations=10))(*args_j)
    assert abs(float(T_est[2]) - dz_true) < 0.05, T_est
    np.testing.assert_allclose(T_est.numpy(), np.asarray(Tj), rtol=0, atol=2e-5)
    assert abs(float(cost) - float(cost_j)) <= 1e-4 * max(float(cost_j), 1e-6)
    # float64 poses on the float32 field, as the window solver's ICP rows
    T_WB = np.array([0.0, 0.01, -0.1, 0.01, 0, 0, 0.99995])
    got = icp_factor.linearize_icp(t, tcfg, torch.tensor(I7), torch.tensor(T_WB),
                                   *args_t[2:])
    want = jax.jit(lambda *a: jicp.linearize_icp(j, jcfg, *a))(
        jnp.asarray(I7), jnp.asarray(T_WB), *args_j[2:])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[3].sum()) > 100
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        assert g.dtype == torch.float64 and w.dtype == np.float64
        assert np.abs(g.numpy() - w).max() <= 1e-7 * np.abs(w).max()


def test_convert_brick_submap():
    """A JAX BrickSubmap and BrickConfig through `convert`: the same arrays
    and dtypes, and the same field."""
    _, _, j, jcfg = make_wall(COARSE, passes=1)
    t = convert.submap_grid(jax.tree.map(np.asarray, j))
    cfg = convert.submap_config(jcfg)
    assert isinstance(t, brick.BrickSubmap) and cfg == brick.BrickConfig(**COARSE)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.numpy().dtype == np.asarray(b).dtype
    pts = field_points(np.random.default_rng(8))
    vt, okt, vj, okj = interp_both(t, cfg, j, jcfg, pts)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)


def test_from_se2_brick_matches_jax():
    """An se2.yaml finer than 256^3 gives the JAX package's brick config,
    field by field (the reference's 25.6 m at 0.025 m, and 0.05 m); at
    0.2 m both stay dense."""
    for res, pool in ((0.025, 8192), (0.05, 2048), (0.2, 8192)):
        kw = dict(map_dim=(25.6, 25.6, 25.6), map_res=res)
        a = SubmappingConfig.from_se2(config.SubMapConfig(**kw), pool_bricks=pool)
        b = jsub.SubmappingConfig.from_se2(jconfig.SubMapConfig(**kw), pool_bricks=pool)
        assert sm_mod.is_brick(a.submap) == hasattr(b.submap, "table_dim") == (res < 0.1)
        assert a.submap._asdict() == b.submap._asdict()
        assert a.submap.dim == b.submap.dim
        for k in ("new_submap_overlap", "new_submap_kf_count", "min_frames_integrated",
                  "align_points", "sensor_sigma", "depth_stride", "max_depth"):
            assert getattr(a, k) == getattr(b, k), k
    fine = SubmappingConfig.from_se2(config.SubMapConfig())  # the defaults: 0.025 m
    assert (fine.submap.dim, fine.submap.table_dim, fine.submap.samples_per_ray,
            fine.submap.band_samples) == (1024, 128, 96, 18)


def test_submapping_interface_with_brick_grid():
    """tests/test_brick.py's interface case in both packages: a sweep into a
    brick submap at the reference resolution, the same submap and grid, the
    overlap decisions (the same cloud again: no new submap; a distant one:
    a new one), and a second submap whose closing hands over the same
    alignment edge."""
    kw = dict(map_dim=(25.6, 25.6, 25.6), map_res=0.025)
    cfg_t = SubmappingConfig.from_se2(config.SubMapConfig(**kw), pool_bricks=2048)
    cfg_j = jsub.SubmappingConfig.from_se2(jconfig.SubMapConfig(**kw), pool_bricks=2048)
    cfg_t.min_frames_integrated = cfg_j.min_frames_integrated = 1
    edges_t, edges_j = [], []
    tsi = SubmappingInterface(cfg_t, align_callback=edges_t.append, device="cpu")
    jsi = jsub.SubmappingInterface(cfg_j, align_callback=edges_j.append)
    end = wall_end_points(n=40, z=2.0, extent=0.5)
    for si in (tsi, jsi):
        for _ in range(3):
            si.integrate_lidar(0, I7, I7, end, sigma=0.05)
    assert len(tsi.maps) == len(jsi.maps) == 1
    assert int(tsi.maps[0].sm.n_alloc) > 0
    compare_grids(tsi.maps[0].sm, jsi.maps[0].sm)
    good = torch.ones(len(end), dtype=torch.bool)
    assert not tsi.decide_new_submap(1, torch.from_numpy(end), good)
    assert not jsi.decide_new_submap(1, I7, end)
    far = (end + np.array([0.0, 0.0, 10.0])).astype(np.float32)
    assert tsi.decide_new_submap(1, torch.from_numpy(far), good)
    assert jsi.decide_new_submap(1, I7, far)
    # a second submap 2 cm along x: the first one's closing edge
    T1 = np.array([0.02, 0, 0, 0, 0, 0, 1.0])
    for si in (tsi, jsi):
        si.start_submap(1, T1)
        for _ in range(3):
            si.integrate_lidar(1, T1, T1, end, sigma=0.05)
        si.finish_submap()
    assert len(edges_t) == len(edges_j) == 1
    et, ej = edges_t[0], edges_j[0]
    assert (et["i"], et["j"]) == (ej["i"], ej["j"]) == (0, 1)
    np.testing.assert_allclose(et["T_ij"], ej["T_ij"], rtol=0, atol=1e-6)
    Ht, Hj = et["sqrt_info"].T @ et["sqrt_info"], ej["sqrt_info"].T @ ej["sqrt_info"]
    assert np.abs(Ht - Hj).max() <= EDGE_H_TOL * np.abs(Hj).max()
