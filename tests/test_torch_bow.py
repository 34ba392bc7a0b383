"""Parity of the port's bag-of-words place recognition
(okvis2x_tpu_torch.frontend.bow) with the JAX package: the shipped
vocabulary, word ids from the Hamming-kernel tree descent (exactly equal),
and the tf-idf database (same frame ids in the same order, scores within
1e-12)."""

import functools

import numpy as np
import pytest
import torch

from okvis2x_tpu.frontend import bow as jbow
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.cameras import pinhole_np
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.frontend import bow, descriptor, detector
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.ops import hamming
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def vocabs():
    return (jbow.HierVocabulary.load(str(bow.DEFAULT_VOCAB)),
            bow.HierVocabulary.load(device="cpu"))


def random_words(rng, n):
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    return w.view(np.int32)


@functools.lru_cache(maxsize=None)
def rendered(seed):
    """704 packed descriptors of one rendered 752x480 circuit view (the
    port's detector and descriptor, which the frontend tests hold to the
    JAX package)."""
    W, H = 752, 480
    pts, br, rad = synthetic.make_circuit_scene(density=22.0, seed=3)
    p, q, _, _, _ = synthetic.circuit_trajectory(np.array([1.0 + 2.0 * seed]))
    cam = pinhole_np.NpCamera(np.array([460.0, 460.0, W / 2, H / 2]),
                              np.array([-0.25, 0.06, 1e-4, -1e-4]), W, H, "radtan")
    T_WC = se3np.se3_multiply(np.concatenate([p[0], q[0]]),
                              np.array([-0.055, 0, 0, 0, 0, 0, 1.0]))
    img = synthetic.render_image(cam, T_WC, pts, br, rad, seed=seed)
    u8 = VioPipeline._pad_width((img * 255).astype(np.uint8))
    img_t = torch.from_numpy(u8.astype(np.float32) * np.float32(1 / 255))
    kp = detector.detect(img_t, max_keypoints=704, octaves=2, cell=32, per_cell=8,
                         threshold=1e-7)
    packed = descriptor.extract(img_t, kp.uv, torch.zeros(704), kp.level, kp.valid)
    return packed.numpy(), kp.valid.numpy()


def test_shipped_vocabulary_loads_packed():
    jv, tv = vocabs()
    assert (tv.B, tv.L, tv.n_words) == (jv.B, jv.L, jv.n_words) == (64, 64, 4096)
    assert tv.branches.dtype == torch.int32 and tv.branches.shape == (64, 12)
    assert tv.leaves.shape == (4096, 12)
    cv = convert.hier_vocabulary(jv)
    assert torch.equal(cv.branches, tv.branches) and torch.equal(cv.leaves, tv.leaves)


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_word_ids_match_jax(kind):
    """Word ids exactly equal for 704 descriptors, a seventh of them invalid
    (their word is 0 in both)."""
    rng = np.random.default_rng(4)
    if kind == "rendered":
        packed, valid = rendered(0)
        assert valid.sum() > 400
    else:
        packed, valid = random_words(rng, 704), np.ones(704, bool)
    valid = valid & (rng.random(704) > 1 / 7)
    jv, tv = vocabs()
    ref = np.asarray(jbow.assign_packed(packed.view(np.uint32), valid, jv))
    n0 = hamming.hamming_matrix_packed.launches
    got = bow.assign_packed(torch.from_numpy(packed), torch.from_numpy(valid), tv).numpy()
    assert hamming.hamming_matrix_packed.launches == n0  # the CPU takes the plain version
    np.testing.assert_array_equal(got, ref)
    assert (got[~valid] == 0).all()
    assert len(np.unique(got[valid])) > 50


def test_database_query_matches_jax():
    """Both databases fed the same words: the same frame ids in the same
    order, scores within 1e-12."""
    jv, tv = vocabs()
    rng = np.random.default_rng(6)
    jdb, tdb = jbow.BowDatabase(k=jv.n_words), bow.BowDatabase(k=tv.n_words)
    words = []
    for fid in range(6):
        packed, valid = rendered(fid % 3) if fid < 3 else (random_words(rng, 704),
                                                           rng.random(704) > 0.2)
        w = bow.assign_packed(torch.from_numpy(packed), torch.from_numpy(valid), tv).numpy()
        words.append((w, valid))
        jdb.add(fid, w, valid)
        tdb.add(fid, w, valid)
    for q in range(6):
        w, valid = words[q]
        ref = jdb.query(w, valid, exclude={q}, top=8)
        got = tdb.query(w, valid, exclude={q}, top=8)
        assert [f for f, _ in got] == [f for f, _ in ref]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in ref], rtol=0, atol=1e-12)
    # a view re-queried against itself scores 1 and ranks first
    got = tdb.query(*words[1], top=3)
    assert got[0][0] == 1 and abs(got[0][1] - 1.0) < 1e-9
