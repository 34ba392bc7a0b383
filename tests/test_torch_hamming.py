"""Parity of the port's packed Hamming distances (okvis2x_tpu_torch.ops.hamming)
with the Pallas kernel (interpret mode) and a numpy popcount.  Every
distance and match result must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.ops import hamming_pallas
from okvis2x_tpu_torch.ops import hamming

# The suite runs in several worker processes; torch's intra-op thread pool
# stalls badly when they oversubscribe the cores, and the port's many small
# ops gain nothing from it.
torch.set_num_threads(1)

RNG = np.random.default_rng(7)


def words(n, rng=RNG):
    """(n, 12) uint32 with all-ones and sign-bit words mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.1] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.1] = 0x80000000
    return w


def numpy_hamming(q, d):
    x = (q[:, None, :] ^ d[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).reshape(len(q), len(d), -1).sum(-1)


def t(w):
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


@pytest.mark.parametrize("nq,nd", [(256, 512), (512, 1024)])
def test_plain_matches_pallas_interpret(nq, nd):
    q, d = words(nq), words(nd)
    ref = np.asarray(hamming_pallas.hamming_matrix_packed(
        jnp.asarray(q), jnp.asarray(d), interpret=True))
    out = hamming.hamming_matrix_packed(t(q), t(d))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("nq,nd", [(1, 1), (37, 53), (257, 513), (5, 2000)])
def test_plain_matches_numpy_at_odd_sizes(nq, nd):
    q, d = words(nq), words(nd)
    np.testing.assert_array_equal(
        hamming.hamming_matrix_plain(t(q), t(d)).numpy(), numpy_hamming(q, d))


def test_extreme_words():
    q = np.array([[0xFFFFFFFF] * 12, [0x80000000] * 12, [0] * 12], np.uint32)
    out = hamming.hamming_matrix_packed(t(q), t(q)).numpy()
    np.testing.assert_array_equal(out, [[0, 372, 384], [372, 0, 12], [384, 12, 0]])


def _with_ties(n, n_dup, rng):
    """Database with duplicated rows (ties) and queries near them."""
    d = words(n, rng)
    d[n_dup:2 * n_dup] = d[:n_dup]
    q = d[rng.integers(0, n, 256)].copy()
    flip = rng.integers(0, 12, (256, 3))
    for i in range(256):
        q[i, flip[i]] ^= np.uint32(1) << rng.integers(0, 32, 3).astype(np.uint32)
    return q, d


def test_best_matches_packed_ties_first_index():
    rng = np.random.default_rng(3)
    q, d = _with_ties(512, 64, rng)
    ji, jd, jok = hamming_pallas.best_matches_packed(
        jnp.asarray(q), jnp.asarray(d), interpret=True)
    ti, td, tok = hamming.best_matches_packed(t(q), t(d))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (ti.numpy() < 64).sum() > 0  # ties resolved to the first copy


@pytest.mark.parametrize("nq,nd,seed", [(256, 512, 0), (300, 700, 1), (64, 64, 2)])
def test_match_packed_mutual(nq, nd, seed):
    rng = np.random.default_rng(seed)
    q, d = _with_ties(nd, nd // 8, rng)
    q = q[:nq] if nq <= len(q) else np.concatenate([q, words(nq - len(q), rng)])
    vq = rng.random(nq) > 0.2
    vd = rng.random(nd) > 0.2
    ji, jd, jok = hamming_pallas.match_packed_mutual(
        jnp.asarray(q), jnp.asarray(vq), jnp.asarray(d), jnp.asarray(vd),
        max_dist=60.0, interpret=True)
    ti, td, tok = hamming.match_packed_mutual(
        t(q), torch.from_numpy(vq), t(d), torch.from_numpy(vd), max_dist=60.0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().any() and (td.numpy() == 385).any()


@pytest.mark.parametrize("bad", ["dtype", "width", "contiguity"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = t(words(8))
    if bad == "dtype":
        q = q.to(torch.int64)
    elif bad == "width":
        q = q[:, :11].contiguous()
    else:
        q = torch.cat([q, q], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        hamming.hamming_matrix_packed(q, t(words(4)))


def test_cpu_tensors_never_count_as_kernel_launches():
    n0 = hamming.hamming_matrix_packed.launches
    hamming.hamming_matrix_packed(t(words(3)), t(words(5)))
    assert hamming.hamming_matrix_packed.launches == n0
