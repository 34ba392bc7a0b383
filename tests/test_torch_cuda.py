"""The port's CUDA kernels on the card, against their plain PyTorch versions.

The kernels have no CPU mode, so these tests skip without a CUDA device
(all but the last, which checks what happens without one).
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


def tied_words(nq, nd, rng):
    """Queries and a database with duplicated rows, so that ties occur on
    both axes."""
    q, d = words(nq, rng), words(nd, rng)
    d[nd // 2:nd // 2 + nd // 8] = d[:nd // 8]
    q[nq // 2:nq // 2 + nq // 8] = q[:nq // 8]
    q[: min(nq, nd) // 4] = d[: min(nq, nd) // 4]
    return q, d


# (nq, nd, validity, allowed, fills, seg, want_cols, row_seg): each site's form
MATCH_FORMS = {
    "map_matching": (704, 1024, True, True, (192, 384), None, False, False),
    "stereo": (704, 704, True, True, (192, 384), None, False, False),
    "motion_stereo": (704, 704, True, True, (192, 384), None, True, False),
    "mutual_385": (300, 700, True, False, (385, None), None, True, False),
    "best_matches": (512, 1024, False, False, (385, None), None, False, False),
    "loop_matching": (704, 2112, True, False, (10 ** 9, None), 704, True, False),
    "vocabulary_branches": (704, 64, False, False, (385, None), None, False, False),
    "vocabulary_leaves": (704, 4096, False, False, (385, None), 64, False, True),
    "one_cell": (1, 1, True, True, (192, 384), None, True, False),
    "ragged": (37, 53, True, True, (192, 384), None, True, False),
    "ragged_unaligned_mask": (257, 513, True, True, (600, 600), 171, True, False),
    "ragged_row_seg": (257, 513, True, False, (385, None), 27, False, True),
    "large": (768, 16384, True, False, (385, None), None, True, False),
}


@pytest.mark.parametrize("form", sorted(MATCH_FORMS))
def test_cuda_match_kernel_matches_plain(cuda, form):
    nq, nd, validity, use_allowed, fills, seg, want_cols, use_row_seg = MATCH_FORMS[form]
    rng = np.random.default_rng(nq + nd)
    q, d = (x.to(cuda) for x in tied_words(nq, nd, rng))
    vq = torch.from_numpy(rng.random(nq) > 0.15).to(cuda) if validity else None
    vd = torch.from_numpy(rng.random(nd) > 0.15).to(cuda) if validity else None
    if form == "loop_matching":
        vd[704:1408] = False  # an empty candidate slot
    kw = dict(seg=seg, fill_invalid=fills[0], fill_disallowed=fills[1], want_cols=want_cols)
    if use_allowed:
        kw["allowed"] = torch.from_numpy(rng.random((nq, nd)) > 0.4).to(cuda)
    if use_row_seg:
        kw["row_seg"] = torch.from_numpy(
            rng.integers(0, nd // seg, nq).astype(np.int32)).to(cuda)
    n0 = hamming.hamming_match.launches
    got = hamming.hamming_match(q, vq, d, vd, **kw)
    torch.cuda.synchronize()
    assert hamming.hamming_match.launches == n0 + 1
    ref = hamming.hamming_match_plain(q, vq, d, vd, **kw)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or (g.dtype == r.dtype and torch.equal(g, r))


def test_cuda_matcher_matches_cpu(cuda):
    """`match_masked` on the card: one launch of the fused kernel a call,
    none of the matrix kernel, and the CPU's matches."""
    rng = np.random.default_rng(1)
    a, b = words(300, rng), words(500, rng)
    va, vb = torch.from_numpy(rng.random(300) > 0.1), torch.from_numpy(rng.random(500) > 0.1)
    allowed = torch.from_numpy(rng.random((300, 500)) > 0.3)
    for mutual in (False, True):
        ref = matcher.match_masked(a, va, b, vb, allowed, max_dist=200.0, mutual=mutual)
        n0, m0 = hamming.hamming_match.launches, hamming.hamming_matrix_packed.launches
        got = matcher.match_masked(a.to(cuda), va.to(cuda), b.to(cuda), vb.to(cuda),
                                   allowed.to(cuda), max_dist=200.0, mutual=mutual)
        assert hamming.hamming_match.launches == n0 + 1
        assert hamming.hamming_matrix_packed.launches == m0
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y)


def test_cuda_ratio_matcher_matches_cpu(cuda):
    """`match` with the ratio test keeps the matrix kernel."""
    rng = np.random.default_rng(5)
    a, b = tied_words(300, 500, rng)
    va, vb = torch.from_numpy(rng.random(300) > 0.1), torch.from_numpy(rng.random(500) > 0.1)
    ref = matcher.match(a, va, b, vb, max_dist=200.0, ratio=0.9, mutual=True)
    m0 = hamming.hamming_matrix_packed.launches
    got = matcher.match(a.to(cuda), va.to(cuda), b.to(cuda), vb.to(cuda), max_dist=200.0,
                        ratio=0.9, mutual=True)
    assert hamming.hamming_matrix_packed.launches == m0 + 1
    for x, y in zip(got, ref):
        assert torch.equal(x.cpu(), y)


def test_cuda_match_wrapper_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(2)
    q, d = words(4, rng).to(cuda), words(4, rng)
    with pytest.raises(ValueError):
        hamming.hamming_match(q, None, d, None)
    with pytest.raises(ValueError):
        hamming.hamming_match(q, torch.ones(4, dtype=torch.bool), d.to(cuda), None)


def test_cuda_wrapper_rejects_mixed_devices(cuda):
    rng = np.random.default_rng(2)
    with pytest.raises(ValueError):
        hamming.hamming_matrix_packed(words(4, rng).to(cuda), words(4, rng))


def test_cuda_vocabulary_words_match_cpu(cuda):
    """The tree descent on the card (two launches of the fused kernel,
    counted under the "bow" site, none of the matrix kernel) gives the CPU's
    words; invalid rows get word 0."""
    rng = np.random.default_rng(3)
    packed = words(704, rng)
    valid = torch.from_numpy(rng.random(704) > 0.2)
    vocab = bow.HierVocabulary.load(device="cpu")
    ref = bow.assign_packed(packed, valid, vocab)
    n0 = hamming.hamming_match.site_launches.get("bow", 0)
    m0 = hamming.hamming_matrix_packed.launches
    got = bow.assign_packed(packed.to(cuda), valid.to(cuda), vocab.to(cuda))
    assert hamming.hamming_match.site_launches["bow"] == n0 + 2
    assert hamming.hamming_matrix_packed.launches == m0
    assert torch.equal(got.cpu(), ref)
    assert (ref[~valid] == 0).all()


def test_cuda_vocabulary_training_matches_cpu(cuda):
    """Binary k-means on the card (one launch a iteration under the
    "vocab" site) gives the CPU's centres; the flat vocabulary's words (one
    "bow" launch) too."""
    rng = np.random.default_rng(4)
    packed = words(3000, rng)
    packed[1000:2000] = packed[:1000]  # duplicated rows: ties and empty clusters
    init = bow.init_indices(3000, 256, 0)
    ref = bow.train_vocabulary_core(packed, init, iters=6)
    n0 = hamming.hamming_match.site_launches.get("vocab", 0)
    got = bow.train_vocabulary_core(packed.to(cuda), init, iters=6)
    assert hamming.hamming_match.site_launches["vocab"] == n0 + 6
    assert torch.equal(got.cpu(), ref)
    b0 = hamming.hamming_match.site_launches.get("bow", 0)
    w = bow.assign_packed(packed.to(cuda), None, got)
    assert hamming.hamming_match.site_launches["bow"] == b0 + 1
    assert torch.equal(w.cpu(), bow.assign_packed(packed, None, ref))


def test_cuda_reloc_match_counts_its_site(cuda):
    """The relocalisation's mutual match launches the fused kernel once,
    counted under "reloc", and equals the CPU's."""
    rng = np.random.default_rng(5)
    q, d = tied_words(704, 704, rng)
    vq, vd = (torch.from_numpy(rng.random(704) > 0.2) for _ in range(2))
    ref = hamming.match_packed_mutual(q, vq, d, vd, max_dist=60.0)
    n0 = hamming.hamming_match.site_launches.get("reloc", 0)
    got = hamming.match_packed_mutual(q.to(cuda), vq.to(cuda), d.to(cuda), vd.to(cuda),
                                      max_dist=60.0, site="reloc")
    assert hamming.hamming_match.site_launches["reloc"] == n0 + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def test_no_device_means_cuda_or_an_error():
    """`VioPipeline` and `SlidingWindowEstimator` built without a device run
    on the first CUDA device; where there is none they raise and do not
    carry on on the CPU."""
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, SlidingWindowEstimator
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    cam = pinhole.make_pinhole(280.0, 280.0, 160.0, 120.0, 320, 240,
                               dist_params=[-0.25, 0.06, 1e-4, -1e-4])
    T_SC = np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]])
    build = (lambda: VioPipeline([cam, cam], T_SC, EstimatorConfig()),
             lambda: SlidingWindowEstimator(EstimatorConfig(), [cam, cam], T_SC))
    for make in build:
        if torch.cuda.is_available():
            assert make().device == torch.device("cuda:0")
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
