"""Parity of the port's frontend (okvis2x_tpu_torch.frontend) with the JAX
package: detection, description, packed-descriptor matching and
triangulation on the same seeded inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.frontend import descriptor as jdesc
from okvis2x_tpu.frontend import detector as jdet
from okvis2x_tpu.frontend import matcher as jmatch
from okvis2x_tpu.frontend import triangulation as jtri
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.frontend import descriptor, detector, matcher, triangulation
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

# The suite runs in several worker processes; torch's intra-op thread pool
# stalls badly when they oversubscribe the cores, and the port's many small
# ops gain nothing from it.
torch.set_num_threads(1)


def pack_bits_np(bits):
    """(N, 384) bool -> (N, 12) int32 words packed LSB-first."""
    b = bits.reshape(-1, 12, 32).astype(np.uint64)
    return (b << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=None)
def frame(kind):
    """One rendered, width-padded float32 image as the pipeline sees it."""
    if kind == "euroc":
        W, H, fx = 752, 480, 460.0
        pts, br, rad = synthetic.make_circuit_scene(density=22.0, seed=3)
        p, q, _, _, _ = synthetic.circuit_trajectory(np.array([1.3]))
    else:
        W, H, fx = 320, 240, 280.0
        pts, br, rad = synthetic.make_scene(600, 3)
        p, q, _, _, _ = synthetic.analytic_trajectory(np.array([0.7]))
    cam = pinhole_np.NpCamera(np.array([fx, fx, W / 2, H / 2]),
                              np.array([-0.25, 0.06, 1e-4, -1e-4]), W, H, "radtan")
    T_WC = se3np.se3_multiply(np.concatenate([p[0], q[0]]),
                              np.array([-0.055, 0, 0, 0, 0, 0, 1.0]))
    img = synthetic.render_image(cam, T_WC, pts, br, rad, seed=5)
    u8 = VioPipeline._pad_width((img * 255).astype(np.uint8))
    return u8.astype(np.float32) * np.float32(1 / 255)


DET = dict(euroc=dict(max_keypoints=704, octaves=2, threshold=1e-7),
           small=dict(max_keypoints=256, octaves=1, threshold=1e-6))


@functools.lru_cache(maxsize=None)
def detections(kind):
    img = frame(kind)
    kw = DET[kind]
    kj = jax.jit(functools.partial(jdet.detect, cell=32, per_cell=8, **kw))(jnp.asarray(img))
    kt = detector.detect(torch.from_numpy(img), cell=32, per_cell=8, **kw)
    return kj, kt


@pytest.mark.parametrize("kind", ["euroc", "small"])
def test_detect_keypoint_sets(kind):
    kj, kt = detections(kind)
    vj, vt = np.asarray(kj.valid), kt.valid.numpy()
    uj = np.asarray(kj.uv)[vj].astype(np.float64)
    ut = kt.uv.numpy()[vt].astype(np.float64)
    assert vj.sum() > 100
    # sorted sets: every JAX keypoint has a port keypoint within 1e-3 px
    uj = uj[np.lexsort(uj.T[::-1])]
    ut = ut[np.lexsort(ut.T[::-1])]
    d = np.linalg.norm(uj[:, None, :] - ut[None, :, :], axis=-1).min(axis=1)
    assert (d <= 1e-3).mean() >= 0.99
    assert abs(len(uj) - len(ut)) <= 0.01 * len(uj)
    np.testing.assert_array_equal(np.asarray(kj.level)[vj].sum(), kt.level.numpy()[vt].sum())


@pytest.mark.parametrize("kind,angle", [("euroc", 0.7), ("euroc", -2.9), ("small", 1.4)])
def test_extract_bits(kind, angle):
    img = frame(kind)
    kj, _ = detections(kind)
    n = kj.uv.shape[0]
    valid = np.asarray(kj.valid).copy()
    valid[::17] = False  # invalid keypoints get zero bits
    pj, _ = jax.jit(jdesc.extract)(jnp.asarray(img), kj.uv, jnp.full((n,), angle, jnp.float32),
                                   kj.level, jnp.asarray(valid))
    pj = np.asarray(pj).view(np.int32)
    pt = descriptor.extract(torch.from_numpy(img), torch.from_numpy(np.asarray(kj.uv)),
                            torch.full((n,), angle), torch.from_numpy(np.asarray(kj.level)),
                            torch.from_numpy(valid)).numpy()
    assert pt.dtype == np.int32 and pt.shape == (n, 12)
    same = (pj == pt).all(axis=1)
    assert same[valid].all()  # the bf16 sampling is reproduced bit for bit
    assert (pt[~valid] == 0).all()


def test_pad_width_matches():
    img = np.random.default_rng(6).integers(0, 256, (48, 300), dtype=np.uint8)
    np.testing.assert_array_equal(VioPipeline._pad_width(img), JVioPipeline._pad_width(img))
    assert VioPipeline._pad_width(img).shape == (48, 384)


def test_pattern_constants_match():
    np.testing.assert_array_equal(descriptor.PATTERN_PTS, np.asarray(jdesc.PATTERN_PTS))
    np.testing.assert_array_equal(descriptor.PAIR_A, np.asarray(jdesc.PAIR_A))
    np.testing.assert_array_equal(descriptor.PAIR_B, np.asarray(jdesc.PAIR_B))


@pytest.mark.parametrize("n,m,seed", [(96, 160, 0), (200, 64, 1), (33, 33, 2)])
def test_match_masked_on_packed_descriptors(n, m, seed):
    rng = np.random.default_rng(seed)
    bits_b = rng.random((m, 384)) < 0.5
    src = rng.integers(0, m, n)
    flips = rng.random((n, 384)) < rng.uniform(0.0, 0.2, (n, 1))
    bits_a = bits_b[src] ^ flips
    bits_a[: n // 8] = bits_a[n // 8: 2 * (n // 8)]  # duplicated rows: ties
    va = rng.random(n) > 0.15
    vb = rng.random(m) > 0.15
    allowed = rng.random((n, m)) > 0.3
    allowed[rng.integers(0, n, 5)] = False  # fully masked rows
    pa = pack_bits_np(bits_a)
    pb = pack_bits_np(bits_b)
    mj = jmatch.match_masked(
        jdesc.unpack_pm1(jnp.asarray(pa.view(np.uint32)), jnp.asarray(va)),
        jdesc.unpack_pm1(jnp.asarray(pb.view(np.uint32)), jnp.asarray(vb)),
        jnp.asarray(allowed), max_dist=60.0)
    mt = matcher.match_masked(torch.from_numpy(pa), torch.from_numpy(va), torch.from_numpy(pb),
                              torch.from_numpy(vb), torch.from_numpy(allowed), max_dist=60.0)
    np.testing.assert_array_equal(mt.idx_b.numpy(), np.asarray(mj.idx_b))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    # an invalid but allowed row sits at 192 from everything, as with ±1 rows
    assert (mt.dist.numpy() == 192).any()


@pytest.mark.parametrize("ratio,mutual", [(0.0, False), (0.8, False), (0.8, True), (0.0, True)])
def test_match_on_packed_descriptors(ratio, mutual):
    rng = np.random.default_rng(5)
    bits_b = rng.random((150, 384)) < 0.5
    bits_b[100:120] = bits_b[:20]  # duplicated database rows: equal best and second best
    bits_a = bits_b[rng.integers(0, 150, 90)] ^ (rng.random((90, 384)) < 0.08)
    va, vb = rng.random(90) > 0.1, rng.random(150) > 0.1
    pa, pb = pack_bits_np(bits_a), pack_bits_np(bits_b)
    mj = jmatch.match(jdesc.unpack_pm1(jnp.asarray(pa.view(np.uint32)), jnp.asarray(va)),
                      jdesc.unpack_pm1(jnp.asarray(pb.view(np.uint32)), jnp.asarray(vb)),
                      max_dist=60.0, ratio=ratio, mutual=mutual)
    mt = matcher.match(torch.from_numpy(pa), torch.from_numpy(va), torch.from_numpy(pb),
                       torch.from_numpy(vb), max_dist=60.0, ratio=ratio, mutual=mutual)
    np.testing.assert_array_equal(mt.idx_b.numpy(), np.asarray(mj.idx_b))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert mt.valid.numpy().any()


def test_hamming_matrix_pm1_semantics():
    rng = np.random.default_rng(4)
    bits = rng.random((40, 384)) < 0.5
    v = rng.random(40) > 0.3
    p = pack_bits_np(bits)
    pm1 = jdesc.unpack_pm1(jnp.asarray(p.view(np.uint32)), jnp.asarray(v))
    ref = np.asarray(jmatch.hamming_matrix(pm1, pm1))
    out = matcher.hamming_matrix(torch.from_numpy(p), torch.from_numpy(v),
                                 torch.from_numpy(p), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate(seed):
    rng = np.random.default_rng(seed)
    n = 300
    X = rng.uniform([-3, -2, 1], [3, 2, 20], (n, 3))
    p_B = np.tile([0.11, 0.01, 0.0], (n, 1))
    p_B[: n // 10] = 0.0  # zero baseline: parallel rays
    e_A = X / np.linalg.norm(X, axis=1, keepdims=True)
    eb = X - p_B + rng.normal(0, 1e-3, (n, 3))
    e_B = eb / np.linalg.norm(eb, axis=1, keepdims=True)
    e_B[-5:] = -e_B[-5:]  # behind the camera
    rj = jtri.triangulate(jnp.zeros((n, 3)), jnp.asarray(e_A), jnp.asarray(p_B), jnp.asarray(e_B))
    rt = triangulation.triangulate(torch.zeros(n, 3, dtype=torch.float64), torch.from_numpy(e_A),
                                   torch.from_numpy(p_B), torch.from_numpy(e_B))
    np.testing.assert_allclose(rt.hp_A.numpy(), np.asarray(rj.hp_A), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(rt.valid.numpy(), np.asarray(rj.valid))
    np.testing.assert_array_equal(rt.parallel.numpy(), np.asarray(rj.parallel))
    assert rt.parallel.numpy().any() and (~rt.valid.numpy()).any()
