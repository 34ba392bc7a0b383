"""The port's CUDA kernels on the card, against their plain PyTorch versions.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports neither JAX nor the JAX package, so it also runs where
only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from okvis2x_tpu_torch.frontend import bow, matcher
from okvis2x_tpu_torch.ops import hamming

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def words(n, rng):
    """(n, 12) int32 words with the all-ones and sign-bit patterns mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.1] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.1] = 0x80000000
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("nq,nd", [(1, 1), (37, 53), (704, 64), (704, 1024), (704, 2112),
                                   (704, 4096), (768, 16384)])
def test_cuda_kernel_matches_plain(cuda, nq, nd):
    rng = np.random.default_rng(nq)
    q, d = words(nq, rng).to(cuda), words(nd, rng).to(cuda)
    n0 = hamming.hamming_matrix_packed.launches
    k = hamming.hamming_matrix_packed(q, d)
    torch.cuda.synchronize()
    assert hamming.hamming_matrix_packed.launches == n0 + 1
    assert torch.equal(k, hamming.hamming_matrix_plain(q, d))


def test_cuda_matcher_matches_cpu(cuda):
    rng = np.random.default_rng(1)
    a, b = words(300, rng), words(500, rng)
    va, vb = torch.from_numpy(rng.random(300) > 0.1), torch.from_numpy(rng.random(500) > 0.1)
    allowed = torch.from_numpy(rng.random((300, 500)) > 0.3)
    ref = matcher.match_masked(a, va, b, vb, allowed, max_dist=200.0)
    got = matcher.match_masked(a.to(cuda), va.to(cuda), b.to(cuda), vb.to(cuda),
                               allowed.to(cuda), max_dist=200.0)
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu(), y)


def test_cuda_wrapper_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError):
        hamming.hamming_matrix_packed(words(4, rng).to(cuda), words(4, rng))


def test_cuda_vocabulary_words_match_cpu(cuda):
    """The tree descent on the card (two kernel launches, counted under the
    "bow" site) gives the CPU's words; invalid rows get word 0."""
    rng = np.random.default_rng(3)
    packed = words(704, rng)
    valid = torch.from_numpy(rng.random(704) > 0.2)
    vocab = bow.HierVocabulary.load()
    ref = bow.assign_packed(packed, valid, vocab)
    n0 = hamming.hamming_matrix_packed.site_launches.get("bow", 0)
    got = bow.assign_packed(packed.to(cuda), valid.to(cuda), vocab.to(cuda))
    assert hamming.hamming_matrix_packed.site_launches["bow"] == n0 + 2
    assert torch.equal(got.cpu(), ref)
    assert (ref[~valid] == 0).all()
