"""The port's vocabularies against the JAX package's: the flat vocabulary's
word assignment, binary k-means training (flat and hierarchical) and the
vocabulary file.

The JAX package seeds its k-means with `jax.random.permutation`, which
torch cannot reproduce; the port draws its own (`bow.init_indices`).  The
parity tests feed the port's `train_vocabulary_core` the JAX permutation
(or patch `bow.init_indices` to draw it), so the centres must then be
exactly the JAX package's once packed.  The online training inside the
pipeline is held against the JAX pipeline in tests/test_torch_slice.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.frontend import bow as jbow
from okvis2x_tpu.frontend import descriptor as jdesc
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.frontend import bow

torch.set_num_threads(1)


def jax_init_indices(n, k, seed=0):
    return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k]))


def corpus(rng, n, n_base=12, p_flip=0.2, n_exact=0):
    """n packed descriptors (uint32) around n_base random words with
    p_flip of their bits flipped; the first n_exact rows are exact copies
    of a few words, so that several initial centres coincide and all but
    the first of them stay empty (argmin takes the first index)."""
    base = rng.integers(0, 2**32, (n_base, 12), dtype=np.uint64).astype(np.uint32)
    bits = np.unpackbits(base[rng.integers(0, n_base, n)].view(np.uint8), axis=1,
                         bitorder="little")
    flip = rng.random(bits.shape) < p_flip
    flip[:n_exact] = False
    bits[:n_exact] = bits[:1]
    return np.packbits(bits ^ flip, axis=1, bitorder="little").view(np.uint32).reshape(n, 12)


def pm1_of(packed):
    return jdesc.unpack_pm1(jnp.asarray(packed), jnp.ones(len(packed), bool))


def majority_vote_numpy(packed, init_idx, iters):
    """The algorithm in plain numpy; also reports whether a vote tied and
    whether a cluster was empty along the way."""
    bits = np.unpackbits(packed.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    c = bits[init_idx].copy()
    tie = empty = False
    for _ in range(iters):
        a = np.argmin((bits[:, None, :] != c[None]).sum(-1), axis=1)
        for j in range(len(c)):
            m = bits[a == j]
            if not len(m):
                empty = True
                continue
            ones = m.sum(0)
            tie |= bool((2 * ones == len(m)).any())
            c[j] = 2 * ones >= len(m)
    packed_c = np.packbits(c.astype(np.uint8), axis=1, bitorder="little")
    return packed_c.view(np.uint32).reshape(len(c), 12), tie, empty


@pytest.mark.parametrize("k", [32, 64])
def test_train_vocabulary_matches_jax(k):
    """Centres exact against the JAX package's, with its permutation; the
    corpus makes votes tie and clusters empty (checked on a numpy
    reference of the same algorithm)."""
    rng = np.random.default_rng(k)
    packed = corpus(rng, 600, n_exact=200)
    ref = np.asarray(jbow.train_vocabulary(pm1_of(packed), k=k, iters=6, seed=7), np.float32)
    idx = jax_init_indices(len(packed), k, seed=7)
    got = bow.train_vocabulary_core(torch.from_numpy(packed.view(np.int32)), idx, iters=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, 12)
    np.testing.assert_array_equal(got.numpy(), convert.pack_pm1(ref))
    np.testing.assert_array_equal(got.numpy(), convert.flat_vocabulary(ref).numpy())
    plain, tie, empty = majority_vote_numpy(packed, idx.numpy(), 6)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), plain)
    assert tie and empty


def test_train_vocabulary_fewer_rows_than_words():
    """n < k: the permutation has n entries, so there are n centres (the
    JAX package's `permutation(n)[:k]`; with k > n its update fails to
    broadcast, so it is held at k = n)."""
    rng = np.random.default_rng(3)
    packed = corpus(rng, 20)
    got = bow.train_vocabulary(torch.from_numpy(packed.view(np.int32)), k=64, iters=3, seed=1)
    assert tuple(got.shape) == (20, 12)
    assert tuple(bow.init_indices(20, 64, 1).shape) == (20,)
    ref = np.asarray(jbow.train_vocabulary(pm1_of(packed), k=20, iters=3, seed=1), np.float32)
    mine = bow.train_vocabulary_core(torch.from_numpy(packed.view(np.int32)),
                                     jax_init_indices(20, 64, 1), iters=3)
    np.testing.assert_array_equal(mine.numpy(), convert.pack_pm1(ref))


def test_init_indices_are_seeded():
    a, b = bow.init_indices(500, 64, 3), bow.init_indices(500, 64, 3)
    assert torch.equal(a, b) and len(set(a.tolist())) == 64
    assert not torch.equal(a, bow.init_indices(500, 64, 4))


def test_flat_assign_matches_jax():
    """Flat word assignment: exact against the JAX package, invalid rows to
    word 0, ties (repeated words) to the first index."""
    rng = np.random.default_rng(11)
    vocab = corpus(rng, 48, p_flip=0.3)
    vocab[40:] = vocab[3]  # repeated words: ties
    packed = corpus(rng, 300, p_flip=0.3)
    packed[:10] = vocab[3]
    valid = rng.random(300) < 0.8
    jv = jnp.asarray(np.unpackbits(vocab.view(np.uint8), axis=1, bitorder="little") * 2.0 - 1.0,
                     jnp.bfloat16)
    ref = np.asarray(jbow.assign_packed(packed, valid, jv))
    tv = torch.from_numpy(vocab.view(np.int32).copy())
    got = bow.assign_packed(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(valid), tv)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[~valid] == 0).all() and (got.numpy()[:10][valid[:10]] == 3).all()
    assert bow.n_words(tv) == jbow.n_words(jv) == 48


def test_train_vocabulary_hier_matches_jax(monkeypatch):
    """The vocabulary tree with the JAX package's permutations: branches
    and leaves exact, including branches too thin for their leaves (rows
    drawn with numpy's default_rng(seed), as in the JAX package)."""
    monkeypatch.setattr(bow, "init_indices", jax_init_indices)
    rng = np.random.default_rng(2)
    packed = corpus(rng, 240, n_base=6)
    ref = jbow.train_vocabulary_hier(pm1_of(packed), branch=8, leaf=8, iters=3, seed=4)
    got = bow.train_vocabulary_hier(torch.from_numpy(packed.view(np.int32)), branch=8, leaf=8,
                                    iters=3, seed=4)
    conv = convert.hier_vocabulary(ref)
    np.testing.assert_array_equal(got.branches.numpy(), conv.branches.numpy())
    np.testing.assert_array_equal(got.leaves.numpy(), conv.leaves.numpy())
    counts = np.bincount(bow.assign_packed(torch.from_numpy(packed.view(np.int32)), None,
                                           got.branches).numpy(), minlength=8)
    assert counts.min() < 8  # a thin branch
    assert (got.B, got.L, got.n_words) == (8, 8, 64)


def test_hier_vocabulary_files_interchangeable(tmp_path):
    """A tree the port saves loads in the JAX package, and the reverse;
    the words assigned agree."""
    rng = np.random.default_rng(9)
    packed = corpus(rng, 200)
    jv = jbow.train_vocabulary_hier(pm1_of(packed), branch=4, leaf=8, iters=2)
    jv.save(str(tmp_path / "jax.npz"))
    tv = bow.HierVocabulary.load(tmp_path / "jax.npz", device="cpu")
    tv.save(str(tmp_path / "port.npz"))
    back = jbow.HierVocabulary.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.branches, np.float32),
                                  np.asarray(jv.branches, np.float32))
    np.testing.assert_array_equal(np.asarray(back.leaves, np.float32),
                                  np.asarray(jv.leaves, np.float32))
    zj, zt = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    for key in ("branches", "leaves", "B", "L", "version"):
        assert zj[key].dtype == zt[key].dtype
        np.testing.assert_array_equal(zj[key], zt[key])
    valid = rng.random(200) < 0.9
    np.testing.assert_array_equal(
        bow.assign_packed(torch.from_numpy(packed.view(np.int32)), torch.from_numpy(valid),
                          tv).numpy(),
        np.asarray(jbow.assign_packed(packed, valid, jv)))


def test_pack_bits_roundtrip():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.integers(-2**31, 2**31, (17, 12), dtype=np.int64).astype(np.int32))
    assert torch.equal(bow.pack_bits(bow.unpack_bits(w)), w)
    np.testing.assert_array_equal(
        bow.unpack_bits(w).numpy(),
        np.unpackbits(w.numpy().view(np.uint8), axis=1, bitorder="little"))


@pytest.mark.parametrize("vocab_path", ["", "missing"])
def test_pipeline_without_vocabulary_file(tmp_path, caplog, vocab_path):
    """`vocab_path=""` and a path that does not exist build a pipeline that
    trains its vocabulary online, as the JAX package's does (a missing file
    logs the same warning); recognition stays on the frame thread."""
    from okvis2x_tpu.cameras import distortion as jdist
    from okvis2x_tpu.cameras import pinhole as jpin
    from okvis2x_tpu.graph import EstimatorConfig
    from okvis2x_tpu.pipeline.vio import PipelineConfig
    from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    path = str(tmp_path / "vocab.npz") if vocab_path else ""
    jcam = jpin.make_pinhole(fx=400.0, fy=400.0, cx=320.0, cy=240.0, width=640, height=480,
                             model=jdist.NONE)
    T_SC = np.array([[0, 0, 0, 0, 0, 0, 1.0]])
    cfg = PipelineConfig(vocab_path=path)
    warned = []
    pipes = []
    for make in (lambda: JVioPipeline([jcam], T_SC, EstimatorConfig(), cfg),
                 lambda: VioPipeline([convert.camera(jax.tree.map(np.asarray, jcam))], T_SC,
                                     convert.estimator_config(EstimatorConfig()),
                                     convert.pipeline_config(cfg), device="cpu")):
        caplog.clear()
        pipes.append(make())
        warned.append([r.getMessage() for r in caplog.records if r.levelname == "WARNING"])
    jp, tp = pipes
    for p in pipes:
        p._lc_queue.put(None)
        p._lc_thread.join(timeout=60.0)
    assert tp.vocab is None and tp.bow_db is None and jp.vocab is None
    assert tp._vocab_pretrained is jp._vocab_pretrained is False
    assert not tp._use_async_pr()
    assert (tp.components, tp.relocalised, tp.n_relocalisations) == ([], False, 0)
    assert warned[1] == warned[0] and len(warned[0]) == (1 if vocab_path else 0)
