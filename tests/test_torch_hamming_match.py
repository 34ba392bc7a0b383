"""Parity of the port's fused matching (okvis2x_tpu_torch.ops.hamming.hamming_match,
on the CPU its plain version) with each JAX site it serves: the Pallas
wrappers (interpret mode), the ±1 matcher, the motion-stereo composition,
the loop matching and the vocabulary descent.  Inputs are numpy-seeded, hold
duplicated rows (ties) and invalid rows; distances, indices and masks must be
exactly equal."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.frontend import bow as jbow
from okvis2x_tpu.frontend import descriptor as jdesc
from okvis2x_tpu.frontend import matcher as jmatch
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.ops import hamming_pallas
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch.frontend import bow, matcher
from okvis2x_tpu_torch.ops import hamming

torch.set_num_threads(1)


def words(n, rng):
    """(n, 12) uint32 with all-ones and sign-bit words mixed in."""
    w = rng.integers(0, 2**32, (n, 12), dtype=np.uint64).astype(np.uint32)
    w[rng.random((n, 12)) < 0.1] = 0xFFFFFFFF
    w[rng.random((n, 12)) < 0.1] = 0x80000000
    return w


def tied(nq, nd, rng):
    """Database with an eighth of its rows duplicated (ties on both axes) and
    queries a few bits away from database rows, themselves partly duplicated."""
    d = words(nd, rng)
    k = max(nd // 8, 1)
    d[k:2 * k] = d[:k]
    q = d[rng.integers(0, nd, nq)].copy()
    flip = rng.integers(0, 12, (nq, 3))
    for i in range(nq):
        q[i, flip[i]] ^= np.uint32(1) << rng.integers(0, 32, 3).astype(np.uint32)
    q[nq // 2:nq // 2 + nq // 8] = q[:nq // 8]
    return q, d


def t(w):
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32))


def b(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def numpy_cells(q, vq, d, vd, allowed, fill_invalid, fill_disallowed):
    x = (q[:, None, :] ^ d[None, :, :]).view(np.uint8)
    D = np.unpackbits(x, axis=-1).reshape(len(q), len(d), -1).sum(-1).astype(np.int64)
    D = np.where(vq[:, None] & vd[None, :], D, fill_invalid)
    if allowed is not None:
        D = np.where(allowed, D, fill_disallowed)
    return D


# ------------------------------------------------------------ the Pallas wrappers
@pytest.mark.parametrize("nq,nd,seed", [(256, 512, 0), (300, 700, 1), (64, 64, 2)])
def test_mutual_form_matches_pallas_match_packed_mutual(nq, nd, seed):
    rng = np.random.default_rng(seed)
    q, d = tied(nq, nd, rng)
    vq, vd = rng.random(nq) > 0.2, rng.random(nd) > 0.2
    ji, jd, jok = hamming_pallas.match_packed_mutual(
        jnp.asarray(q), jnp.asarray(vq), jnp.asarray(d), jnp.asarray(vd),
        max_dist=60.0, interpret=True)
    rm, ra, ca = hamming.hamming_match(t(q), b(vq), t(d), b(vd), fill_invalid=385,
                                       want_cols=True)
    assert rm.dtype == torch.int32 and ra.dtype == torch.int64 and ca.dtype == torch.int64
    assert rm.shape == ra.shape == (nq, 1) and ca.shape == (nd,)
    np.testing.assert_array_equal(ra[:, 0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(rm[:, 0].numpy(), np.asarray(jd))
    ok = b(vq) & (ca[ra[:, 0]] == torch.arange(nq)) & (rm[:, 0] <= 60)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    # and the port's wrapper on top of it, with its types
    ti, td, tok = hamming.match_packed_mutual(t(q), b(vq), t(d), b(vd), max_dist=60.0)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert tok.numpy().any() and (td.numpy() == 385).any()


@pytest.mark.parametrize("nq,nd,seed", [(256, 512, 3), (512, 1024, 4)])
def test_plain_form_matches_pallas_best_matches_packed(nq, nd, seed):
    rng = np.random.default_rng(seed)
    q, d = tied(nq, nd, rng)
    ji, jd, jok = hamming_pallas.best_matches_packed(jnp.asarray(q), jnp.asarray(d),
                                                     interpret=True)
    rm, ra, ca = hamming.hamming_match(t(q), None, t(d), None)
    assert ca is None
    np.testing.assert_array_equal(ra[:, 0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(rm[:, 0].numpy(), np.asarray(jd))
    ti, td, tok = hamming.best_matches_packed(t(q), t(d))
    assert ti.dtype == torch.int32 and td.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (ti.numpy() < nd // 8).sum() > 0  # ties resolved to the first copy


# ------------------------------------------------------------------- the matcher
def pm1(w, v):
    return jdesc.unpack_pm1(jnp.asarray(w), jnp.asarray(v))


@pytest.mark.parametrize("n,m,seed", [(96, 160, 0), (200, 64, 1), (33, 33, 2), (130, 257, 3)])
def test_matcher_fills_match_jax_match_masked(n, m, seed):
    rng = np.random.default_rng(seed)
    q, d = tied(n, m, rng)
    va, vb = rng.random(n) > 0.15, rng.random(m) > 0.15
    allowed = rng.random((n, m)) > 0.3
    allowed[rng.integers(0, n, 5)] = False  # fully masked rows
    mj = jmatch.match_masked(pm1(q, va), pm1(d, vb), jnp.asarray(allowed), max_dist=60.0)
    rm, ra, _ = hamming.hamming_match(t(q), b(va), t(d), b(vb), allowed=b(allowed),
                                      fill_invalid=192, fill_disallowed=384)
    np.testing.assert_array_equal(ra[:, 0].numpy(), np.asarray(mj.idx_b))
    np.testing.assert_array_equal(rm[:, 0].numpy(), np.asarray(mj.dist))
    mt = matcher.match_masked(t(q), b(va), t(d), b(vb), b(allowed), max_dist=60.0)
    assert mt.idx_b.dtype == torch.int64 and mt.dist.dtype == torch.float32
    np.testing.assert_array_equal(mt.idx_b.numpy(), np.asarray(mj.idx_b))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(mj.dist))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mj.valid))
    assert (mt.dist.numpy() == 192).any() and (mt.dist.numpy() == 384).any()


@pytest.mark.parametrize("n,motion_on,seed", [(128, True, 0), (200, True, 1), (64, False, 2)])
def test_mutual_masked_form_matches_jax_motion_stereo(n, motion_on, seed):
    """The motion-stereo composition of okvis2x_tpu/pipeline/vio.py: the ±1
    distances masked to 384 outside `mo_allowed`, row argmin, threshold and
    the mutual check through the column argmin."""
    rng = np.random.default_rng(seed)
    q, d = tied(n, n, rng)
    vq, vk = rng.random(n) > 0.15, rng.random(n) > 0.15
    un_c, kf_un = rng.random(n) > 0.3, rng.random(n) > 0.3
    mo_allowed = (un_c & vq)[:, None] & (kf_un & vk)[None, :] & motion_on
    Dm = jmatch.hamming_matrix(pm1(q, vq), pm1(d, vk))
    Dm = jnp.where(jnp.asarray(mo_allowed), Dm, jnp.float32(jmatch.DESC_BITS))
    mo_idx = jnp.argmin(Dm, axis=1)
    d1 = jnp.take_along_axis(Dm, mo_idx[:, None], axis=1)[:, 0]
    back = jnp.argmin(Dm, axis=0)
    mo_val = (d1 <= 80.0) & (back[mo_idx] == jnp.arange(n))
    mt = matcher.match_masked(t(q), b(vq), t(d), b(vk), b(mo_allowed), max_dist=80.0,
                              mutual=True)
    np.testing.assert_array_equal(mt.idx_b.numpy(), np.asarray(mo_idx))
    np.testing.assert_array_equal(mt.dist.numpy(), np.asarray(d1))
    np.testing.assert_array_equal(mt.valid.numpy(), np.asarray(mo_val))
    assert mt.valid.numpy().any() == motion_on


# ------------------------------------------------------------- the loop matching
@functools.lru_cache(maxsize=None)
def jax_pipeline(n):
    return JVioPipeline(
        [jpin.make_pinhole(280.0, 280.0, 160.0, 120.0, 320, 240)] * 2,
        np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]]),
        EstimatorConfig(),
        PipelineConfig(max_keypoints=n, do_loop_closures=False, async_place_recognition=False,
                       pose_refine=False, pipelined_solve=False))


@pytest.mark.parametrize("n,n_cand,seed", [(128, 2, 0), (128, 3, 1), (192, 1, 2)])
def test_segments_with_columns_match_jax_lc_match_fn(n, n_cand, seed):
    """`seg`/`want_cols` with the 1e9 fill against `_lc_match_fn`: three
    candidate slots, the unused ones empty (all-invalid zero descriptors)."""
    rng = np.random.default_rng(seed)
    Bc = 3
    rec_pk, _ = tied(n, n, rng)
    rec_v = rng.random(n) > 0.15
    cand_pk = np.zeros((Bc, 1, n, 12), np.uint32)
    cand_v = np.zeros((Bc, 1, n), bool)
    for c in range(n_cand):
        pk = words(n, rng)
        src, dst = rng.permutation(n)[: n // 3], rng.permutation(n)[: n // 3]
        flips = (rng.random((n // 3, 12, 32)) < 0.02) << np.arange(32, dtype=np.uint32)
        pk[dst] = rec_pk[src] ^ flips.sum(-1).astype(np.uint32)
        pk[: n // 8] = pk[n // 8: 2 * (n // 8)]  # duplicated candidate rows
        cand_pk[c, 0], cand_v[c, 0] = pk, rng.random(n) > 0.15
    jpipe = jax_pipeline(n)
    thr = float(jpipe.cfg.matching_threshold)
    mi_j, ok_j = jpipe._lc_match_fn()(jnp.asarray(rec_pk[None]), jnp.asarray(rec_v[None]),
                                      jnp.asarray(cand_pk), jnp.asarray(cand_v))
    mi_j, ok_j = np.asarray(mi_j)[:, 0], np.asarray(ok_j)[:, 0]  # (B, N)

    dv = b(cand_v[:, 0])
    rm, ra, ca = hamming.hamming_match(
        t(rec_pk), b(rec_v), t(cand_pk[:, 0].reshape(Bc * n, 12)), dv.reshape(-1), seg=n,
        fill_invalid=10 ** 9, want_cols=True)
    assert rm.shape == ra.shape == (n, Bc) and ca.shape == (Bc * n,)
    mi = ra.T - torch.arange(Bc)[:, None] * n
    assert ((mi >= 0) & (mi < n)).all()  # a column of its own segment, also where all is 1e9
    mutual = torch.gather(ca.reshape(Bc, n), 1, mi) == torch.arange(n)
    ok = mutual & (rm.T <= thr) & b(rec_v)[None] & torch.gather(dv, 1, mi)
    np.testing.assert_array_equal(mi.numpy(), mi_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert (rm.numpy() == 10 ** 9).any()
    assert ok[:n_cand].sum() > n // 8 and not ok[n_cand:].any()
    assert (mi[n_cand:] == 0).all()  # an empty slot answers its first column


# -------------------------------------------------------- the vocabulary descent
@pytest.mark.parametrize("n,seed", [(704, 0), (100, 1)])
def test_row_segments_match_jax_assign_packed(n, seed):
    """Branches with one segment, then leaves with `row_seg`, on the shipped
    vocabulary, against `okvis2x_tpu.frontend.bow.assign_packed`."""
    rng = np.random.default_rng(seed)
    jv, tv = jbow.HierVocabulary.load(str(bow.DEFAULT_VOCAB)), bow.HierVocabulary.load()
    leaves = tv.leaves.numpy().view(np.uint32)
    packed = leaves[rng.integers(0, len(leaves), n)].copy()  # near leaves: ties are likely
    packed[n // 2:] ^= words(n - n // 2, rng) & words(n - n // 2, rng) & words(n - n // 2, rng)
    valid = rng.random(n) > 1 / 7
    ref = np.asarray(jbow.assign_packed(packed, valid, jv))
    _, br, _ = hamming.hamming_match(t(packed), None, tv.branches, None)
    rm, w, ca = hamming.hamming_match(t(packed), None, tv.leaves, None, seg=tv.L,
                                      row_seg=br[:, 0].to(torch.int32))
    assert rm.shape == w.shape == (n,) and ca is None
    assert (w // tv.L == br[:, 0]).all()
    np.testing.assert_array_equal(w.numpy()[valid], ref[valid])
    got = bow.assign_packed(t(packed), b(valid), tv)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (got.numpy()[~valid] == 0).all()


# ------------------------------------------------ the plain version against numpy
@pytest.mark.parametrize("nq,nd,seg,fills,use_allowed", [
    (1, 1, None, (385, None), False),
    (37, 53, None, (192, 384), True),
    (257, 513, 171, (10 ** 9, None), False),
    (50, 96, 32, (600, 600), True),
    (40, 60, 20, (0, 511), True),
])
def test_plain_matches_numpy(nq, nd, seg, fills, use_allowed):
    rng = np.random.default_rng(nq + nd)
    q, d = tied(nq, nd, rng)
    vq, vd = rng.random(nq) > 0.2, rng.random(nd) > 0.2
    allowed = rng.random((nq, nd)) > 0.4 if use_allowed else None
    D = numpy_cells(q, vq, d, vd, allowed, *fills)
    s = seg or nd
    rm, ra, ca = hamming.hamming_match_plain(
        t(q), b(vq), t(d), b(vd), allowed=None if allowed is None else b(allowed), seg=seg,
        fill_invalid=fills[0], fill_disallowed=fills[1], want_cols=True)
    Ds = D.reshape(nq, nd // s, s)
    np.testing.assert_array_equal(rm.numpy(), Ds.min(-1))
    np.testing.assert_array_equal(ra.numpy(), Ds.argmin(-1) + np.arange(0, nd, s))
    np.testing.assert_array_equal(ca.numpy(), D.argmin(0))
    # row_seg: each row in a segment of its own, out-of-range segments clamped
    rs = rng.integers(-1, nd // s + 1, nq).astype(np.int32)
    rm, ra, ca = hamming.hamming_match_plain(t(q), b(vq), t(d), b(vd), seg=s,
                                             row_seg=b(rs), fill_invalid=fills[0])
    Dn = numpy_cells(q, vq, d, vd, None, fills[0], None).reshape(nq, nd // s, s)
    Dn = Dn[np.arange(nq), np.clip(rs, 0, nd // s - 1)]
    np.testing.assert_array_equal(rm.numpy(), Dn.min(-1))
    np.testing.assert_array_equal(ra.numpy(), Dn.argmin(-1) + np.clip(rs, 0, nd // s - 1) * s)
    assert ca is None


def test_no_query_rows():
    rng = np.random.default_rng(0)
    rm, ra, ca = hamming.hamming_match(t(words(0, rng)), None, t(words(8, rng)), None, seg=4,
                                       want_cols=True)
    assert rm.shape == ra.shape == (0, 2) and ca.shape == (8,)


# ------------------------------------------------------------------- the wrapper
@pytest.mark.parametrize("bad", [
    "dtype", "width", "contiguity", "seg", "mixed_devices", "empty_database", "flag_dtype",
    "flag_shape", "allowed_shape", "allowed_contiguity", "allowed_without_fill",
    "fills_collide", "negative_fill", "row_seg_dtype", "row_seg_with_columns",
    "row_seg_with_allowed",
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(0)
    q, d = t(words(8, rng)), t(words(12, rng))
    vq, vd = torch.ones(8, dtype=torch.bool), torch.ones(12, dtype=torch.bool)
    kw = {}
    if bad == "dtype":
        q = q.to(torch.int64)
    elif bad == "width":
        q = q[:, :11].contiguous()
    elif bad == "contiguity":
        q = torch.cat([q, q], dim=1)[:, ::2]
    elif bad == "seg":
        kw = dict(seg=5)
    elif bad == "mixed_devices":
        d = torch.empty((12, 12), dtype=torch.int32, device="meta")
    elif bad == "empty_database":
        d, vd = d[:0], vd[:0]
    elif bad == "flag_dtype":
        vq = vq.to(torch.uint8)
    elif bad == "flag_shape":
        vd = vd[:11]
    elif bad == "allowed_shape":
        kw = dict(allowed=torch.ones((12, 8), dtype=torch.bool), fill_disallowed=384)
    elif bad == "allowed_contiguity":
        kw = dict(allowed=torch.ones((12, 8), dtype=torch.bool).T, fill_disallowed=384)
    elif bad == "allowed_without_fill":
        kw = dict(allowed=torch.ones((8, 12), dtype=torch.bool))
    elif bad == "fills_collide":
        kw = dict(allowed=torch.ones((8, 12), dtype=torch.bool), fill_invalid=10 ** 9,
                  fill_disallowed=600)
    elif bad == "negative_fill":
        kw = dict(fill_invalid=-1)
    elif bad == "row_seg_dtype":
        kw = dict(seg=4, row_seg=torch.zeros(8, dtype=torch.int64))
    elif bad == "row_seg_with_columns":
        kw = dict(seg=4, row_seg=torch.zeros(8, dtype=torch.int32), want_cols=True)
    else:
        kw = dict(seg=4, row_seg=torch.zeros(8, dtype=torch.int32),
                  allowed=torch.ones((8, 12), dtype=torch.bool), fill_disallowed=384)
    with pytest.raises(ValueError):
        hamming.hamming_match(q, vq, d, vd, **kw)


def test_cpu_tensors_never_count_as_kernel_launches():
    rng = np.random.default_rng(1)
    q, d = t(words(16, rng)), t(words(24, rng))
    v = torch.ones(16, dtype=torch.bool)
    n0, s0 = hamming.hamming_match.launches, dict(hamming.hamming_match.site_launches)
    m0 = hamming.hamming_matrix_packed.launches
    hamming.hamming_match(q, v, d, None, seg=8, want_cols=True, site="lc_match")
    hamming.match_packed_mutual(q, v, q, v)
    hamming.best_matches_packed(q, d)
    matcher.match_masked(q, v, q, v, torch.ones((16, 16), dtype=torch.bool), mutual=True)
    bow.assign_packed(q, v, bow.HierVocabulary.load())
    assert hamming.hamming_match.launches == n0
    assert hamming.hamming_match.site_launches == s0
    assert hamming.hamming_matrix_packed.launches == m0
