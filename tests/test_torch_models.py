"""The port's depth models against the JAX package: the learned stereo and
multi-view nets with the shipped weights (converted from the flax trees),
census stereo, the plane sweep, depth conversion and fusion, and the engine
dispatch of `stereo_depth` and `mvs_depth`.

Tolerances: the stereo net's disparity to 1e-4 px and its sigma to 1e-5
relative (float32 convolutions summed in another order); the MVS net's depth
to 1e-6 m and sigma to 1e-6 relative (its cost volume is float64 in both
packages); census bits and popcounts exactly; aggregated census costs to
1e-5 (float32 box filter) with the winning disparity equal wherever the JAX
volume's best cost leads the next by more than 1e-4 (equal aggregated costs
are ties, C-H3); the plane sweep's depth to 1e-4 m and its valid mask
exactly on all but a 3-pixel border (the first row and column project onto
the sources' edges, where the two packages' K^-1, one ulp apart, decide
whether a sample lies inside, and the 5x5 cost box spreads that two
pixels); elementwise conversions to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.core import se3 as jse3
from okvis2x_tpu.models import mvs as jmvs
from okvis2x_tpu.models import mvs_net as jmvs_net
from okvis2x_tpu.models import stereo as jstereo
from okvis2x_tpu.models import stereo_net as jstereo_net
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.models import mvs, mvs_net, stereo, stereo_net

torch.set_num_threads(1)

SIZES = [(64, 96), (61, 93)]


def _box5(img):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(img)[None, None], (jnp.ones((5, 5), jnp.float32) / 25.0)[None, None],
        (1, 1), "SAME"))[0, 0]


def stereo_pair(H, W, disp=6, seed=13):
    """A textured plane at constant disparity (right pixel x - d matches
    left x) with sensor noise."""
    rng = np.random.default_rng(seed)
    tex = _box5(rng.uniform(0, 1, (H, W + 64)).astype(np.float32))
    left = tex[:, 32:32 + W]
    right = tex[:, 32 + disp:32 + disp + W] + rng.normal(0, 0.01, (H, W)).astype(np.float32)
    return left, right.astype(np.float32)


def mvs_inputs(H, W, seed=0):
    rng = np.random.default_rng(seed)
    ref = _box5(rng.uniform(0, 1, (H, W)).astype(np.float32))
    srcs = np.stack([np.roll(ref, 3, axis=1), np.roll(ref, -2, axis=0)]).astype(np.float32)
    K = np.array([80.0, 80.0, W / 2, H / 2], np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    T[0, 0, 3], T[1, 1, 3] = 0.1, -0.1
    return ref, srcs, K, T


@pytest.fixture(scope="module")
def nets():
    """Both packages' trained nets: (flax stereo params, port StereoNet,
    flax MVS params and meta, port MvsNet)."""
    sp, _ = jstereo_net.load_params()
    mp, mmeta = jmvs_net.load_params()
    snet = stereo_net.StereoNet(64)
    snet.load_state_dict(convert.stereo_net_params(sp))
    mnet = mvs_net.MvsNet(int(mmeta["n_depths"]), mmeta["d_min"], mmeta["d_max"])
    mnet.load_state_dict(convert.mvs_net_params(mp))
    return sp, snet.eval(), mp, mmeta, mnet.eval()


@pytest.mark.parametrize("H,W", SIZES)
def test_stereo_net_matches_flax(nets, H, W):
    """The shipped stereo weights through both nets, at an even and an odd
    size (flax's asymmetric SAME padding of the stride-2 convs)."""
    sp, snet = nets[:2]
    left, right = stereo_pair(H, W)
    jd, js = jax.jit(jstereo_net.StereoNet(max_disp=64).apply)(sp, left, right)
    with torch.no_grad():
        td, ts = snet(torch.from_numpy(left), torch.from_numpy(right))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=0)
    assert float(td.max()) > 1.0  # a real disparity map, not a constant


@pytest.mark.parametrize("H,W", SIZES)
def test_mvs_net_matches_flax(nets, H, W):
    """The shipped MVS weights through both nets, with and without sparse
    depth hints."""
    _, _, mp, mmeta, mnet = nets
    ref, srcs, K, T = mvs_inputs(H, W)
    hints = np.zeros((H, W), np.float32)
    hints[20:25, 30:35] = 2.0
    jnet = jmvs_net.MvsNet(n_depths=int(mmeta["n_depths"]))
    for h in (None, hints):
        jd, js = jnet.apply(mp, ref, srcs, K, T, None if h is None else jnp.asarray(h))
        with torch.no_grad():
            td, ts = mnet(*(torch.from_numpy(x) for x in (ref, srcs, K, T)),
                          None if h is None else torch.from_numpy(h))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
        assert mnet.d_min - 1e-3 <= float(td.min()) and float(td.max()) <= mnet.d_max + 1e-3


def test_weight_conversion_layouts(nets):
    """Conv kernels (kh, kw, in, out) -> (out, in, kh, kw), Dense kernels
    (in, out) -> (out, in); the flat npz paths give the same state_dict as
    the nested tree; every parameter of both nets is covered."""
    sp, snet, mp, _, mnet = nets
    flat = dict(np.load(stereo_net.DEFAULT_WEIGHTS))
    sd = convert.stereo_net_params({k: v for k, v in flat.items() if not k.startswith("__")})
    assert set(sd) == set(snet.state_dict())
    k = np.asarray(sp["params"]["FeatureNet_1"]["Conv_2"]["kernel"])
    np.testing.assert_array_equal(sd["FeatureNet_1.Conv_2.weight"].numpy(), k.transpose(3, 2, 0, 1))
    md = convert.mvs_net_params(mp)
    assert set(md) == set(mnet.state_dict())
    d = np.asarray(mp["params"]["MatchingMlp_0"]["Dense_0"]["kernel"])
    np.testing.assert_array_equal(md["MatchingMlp_0.Dense_0.weight"].numpy(), d.T)


def test_census_bits_and_popcounts_exact():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    img[5:9, 5:9] = 0.5  # equal neighbours
    got = stereo.census(torch.from_numpy(img)).numpy()
    ref = np.asarray(jstereo._census(jnp.asarray(img))).astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000001]
    np.testing.assert_array_equal(stereo.popcount32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  np.asarray(jstereo._popcount32(jnp.asarray(x))))


def test_census_stereo_matches_jax():
    """The port's case of tests/test_models.py (constant disparity
    recovered) and the JAX engine's volume, winners and outputs."""
    left, right = stereo_pair(96, 128, disp=12)
    max_disp = 32
    disp, sigma_d, valid = stereo.census_stereo(torch.from_numpy(left), torch.from_numpy(right),
                                                max_disp=max_disp)
    jd, js, jv = jstereo.census_stereo(jnp.asarray(left), jnp.asarray(right), max_disp=max_disp)
    vol, _ = stereo.cost_volumes(torch.from_numpy(left), torch.from_numpy(right), max_disp)
    jl, jr = jnp.asarray(left), jnp.asarray(right)
    cl, cr = jstereo._census(jl), jstereo._census(jr)
    xs = np.arange(128)[None]
    jvol = np.stack([np.asarray(jstereo._box(jnp.where(
        xs >= d, jstereo._popcount32(cl ^ jnp.roll(cr, d, axis=1)).astype(jnp.float32), 1e4), 3))
        for d in range(max_disp)])
    np.testing.assert_allclose(vol.numpy(), jvol, rtol=1e-5, atol=1e-5)
    srt = np.sort(jvol, axis=0)
    clear = (srt[1] - srt[0]) > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(vol.argmin(0).numpy()[clear], jvol.argmin(0)[clear])
    both = clear & np.asarray(jv) & valid.numpy()
    np.testing.assert_allclose(disp.numpy()[both], np.asarray(jd)[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(sigma_d.numpy()[both], np.asarray(js)[both], rtol=1e-4, atol=0)
    assert (valid.numpy()[clear] == np.asarray(jv)[clear]).mean() > 0.999
    v = valid.numpy()
    assert v.mean() > 0.5
    assert np.median(np.abs(disp.numpy()[v] - 12.0)) < 0.5
    assert sigma_d.numpy()[v].mean() < 3.0


def test_disparity_to_depth_and_fusion_match_jax():
    rng = np.random.default_rng(2)
    disp = rng.uniform(-1, 40, (8, 9)).astype(np.float32)
    sd = rng.uniform(0.1, 2, (8, 9)).astype(np.float32)
    valid = rng.uniform(size=(8, 9)) < 0.8
    out = stereo.disparity_to_depth(torch.from_numpy(disp), torch.from_numpy(sd),
                                    torch.from_numpy(valid), 400.0, 0.1)
    ref = jstereo.disparity_to_depth(disp, sd, valid, fx=400.0, baseline=0.1)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    # the port's case of tests/test_models.py
    out = stereo.disparity_to_depth(torch.full((4, 4), 10.0), torch.full((4, 4), 0.5),
                                    torch.ones((4, 4), dtype=bool), fx=400.0, baseline=0.1)
    np.testing.assert_allclose(out.depth.numpy(), 4.0)
    np.testing.assert_allclose(out.sigma.numpy(), 4.0 * 4.0 / 40.0 * 0.5, rtol=1e-6)
    d1, s1 = np.where(valid, 2.0, 0.0).astype(np.float32), np.full((8, 9), 0.1, np.float32)
    d2 = np.where(rng.uniform(size=(8, 9)) < 0.5, 3.0, 0.0)
    s2 = np.full((8, 9), 0.2)
    d, s = stereo.fuse_depths(*(torch.from_numpy(np.asarray(x)) for x in (d1, s1, d2, s2)))
    jd, js = jstereo.fuse_depths(d1, s1, d2, s2)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-12, atol=0)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-12, atol=0)
    both = (d1 > 0) & (d2 > 0)
    np.testing.assert_allclose(d.numpy()[both], (2.0 / 0.01 + 3.0 / 0.04) / (1 / 0.01 + 1 / 0.04))
    assert np.isinf(s.numpy()[(d1 == 0) & (d2 == 0)]).all()


def plane_scene(H=80, W=96, fx=100.0, depth_true=3.0):
    """tests/test_models.py's textured plane at 3 m seen from the reference
    and two sources 15 cm off."""
    rng = np.random.default_rng(13)
    tex = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(rng.uniform(0, 1, (300, 300)).astype(np.float32))[None, None],
        (jnp.ones((7, 7), jnp.float32) / 49.0)[None, None], (1, 1), "SAME"))[0, 0]

    def render(T_WC):
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        rays = np.stack([(xs - W / 2) / fx, (ys - H / 2) / fx, np.ones_like(xs)], -1)
        C = np.asarray(jse3.quat_to_matrix(jnp.asarray(T_WC[3:7])))
        d_w = rays @ C.T
        lam = (depth_true - T_WC[2]) / d_w[..., 2]
        pw = T_WC[:3] + lam[..., None] * d_w
        u = np.clip((pw[..., 0] + 1.5) / 3.0 * 299, 0, 298).astype(int)
        v = np.clip((pw[..., 1] + 1.5) / 3.0 * 299, 0, 298).astype(int)
        return tex[v, u].astype(np.float32)

    T_s = np.array([[0.15, 0, 0, 0, 0, 0, 1.0], [0, 0.15, 0, 0, 0, 0, 1.0]])
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]], np.float32)
    return render(np.array([0, 0, 0, 0, 0, 0, 1.0])), np.stack([render(t) for t in T_s]), K, \
        T_s.astype(np.float32)


def test_plane_sweep_matches_jax():
    """The port's case of tests/test_models.py (the plane's depth
    recovered) and the JAX engine's output on it."""
    ref, srcs, K, T_s = plane_scene()
    kw = dict(min_depth=1.0, max_depth=8.0, num_depths=32)
    out = mvs.plane_sweep(*(torch.from_numpy(x) for x in (ref, srcs, K, T_s)), **kw)
    jo = jmvs.plane_sweep(jnp.asarray(ref), jnp.asarray(srcs), jnp.asarray(K), jnp.asarray(T_s),
                          **kw)
    v, jv = out.valid.numpy(), np.asarray(jo.valid)
    inner = np.zeros_like(v)
    inner[3:-3, 3:-3] = True
    np.testing.assert_array_equal(v[inner], jv[inner])
    np.testing.assert_allclose(out.depth.numpy()[inner], np.asarray(jo.depth)[inner], rtol=0,
                               atol=1e-4)
    assert v.mean() > 0.4
    assert abs(np.median(out.depth.numpy()[v]) - 3.0) < 0.3


def test_stereo_engine_dispatch(nets, tmp_path):
    """`auto` takes the net (its recorded RMSE 1.62 beats census's 5.81) and
    gives the net's depth; `census` never loads it; without the artifact
    `net` raises and `auto` falls back to census."""
    snet = nets[1]
    left, right = (torch.from_numpy(x) for x in stereo_pair(64, 96))
    _, meta = stereo_net.load_params(stereo_net.DEFAULT_WEIGHTS)
    assert meta["rmse_net"] < meta["rmse_census"]
    auto = stereo.stereo_depth(left, right, fx=200.0, baseline=0.1)
    with torch.no_grad():
        disp, sig = snet(left, right)
    ref = stereo.disparity_to_depth(disp, sig, (disp > 0.5) & (disp < 63), 200.0, 0.1)
    np.testing.assert_array_equal(auto.depth.numpy(), ref.depth.numpy())
    net = stereo.stereo_depth(left, right, fx=200.0, baseline=0.1, engine="net")
    np.testing.assert_array_equal(net.depth.numpy(), ref.depth.numpy())
    cen = stereo.stereo_depth(left, right, fx=200.0, baseline=0.1, engine="census")
    ref = stereo.disparity_to_depth(*stereo.census_stereo(left, right), 200.0, 0.1)
    np.testing.assert_array_equal(cen.depth.numpy(), ref.depth.numpy())
    missing = tmp_path / "none.npz"
    with pytest.raises(FileNotFoundError):
        stereo.stereo_depth(left, right, 200.0, 0.1, engine="net", weights=missing)
    fallback = stereo.stereo_depth(left, right, 200.0, 0.1, weights=missing)
    np.testing.assert_array_equal(fallback.depth.numpy(), cen.depth.numpy())


def test_mvs_engine_dispatch(nets, tmp_path):
    """`auto` takes the net for two sources (RMSE 1.06 against the plane
    sweep's 3.37) and the plane sweep for three (the source count of the
    meta); `net` raises for three sources and without the artifact;
    `classical` runs the plane sweep."""
    mnet = nets[4]
    ref, srcs, K, T_s = (torch.from_numpy(x) for x in plane_scene())
    auto = mvs.mvs_depth(ref, srcs, K, T_s)
    T_sr7 = torch.stack([torch.as_tensor(np.asarray(jse3.se3_inverse(jnp.asarray(t.numpy()))))
                         for t in T_s])
    M = torch.eye(4).repeat(2, 1, 1)
    M[:, :3, :3] = torch.as_tensor(np.asarray(jax.vmap(
        lambda t: jse3.quat_to_matrix(t[3:7]))(jnp.asarray(T_sr7.numpy()))))
    M[:, :3, 3] = T_sr7[:, :3]
    with torch.no_grad():
        d, _ = mnet(ref, srcs, torch.stack([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]), M)
    ok = (d > mnet.d_min + 1e-3) & (d < mnet.d_max - 1e-3)
    np.testing.assert_allclose(auto.depth.numpy(), torch.where(ok, d, 0.0).numpy(), atol=1e-6)
    cls = mvs.mvs_depth(ref, srcs, K, T_s, engine="classical")
    ps = mvs.plane_sweep(ref, srcs, K, T_s)
    np.testing.assert_array_equal(cls.depth.numpy(), ps.depth.numpy())
    three, T3 = torch.cat([srcs, srcs[:1]]), torch.cat([T_s, T_s[:1]])
    np.testing.assert_array_equal(mvs.mvs_depth(ref, three, K, T3).depth.numpy(),
                                  mvs.plane_sweep(ref, three, K, T3).depth.numpy())
    with pytest.raises(FileNotFoundError):
        mvs.mvs_depth(ref, three, K, T3, engine="net")
    with pytest.raises(FileNotFoundError):
        mvs.mvs_depth(ref, srcs, K, T_s, engine="net", weights=tmp_path / "none.npz")
