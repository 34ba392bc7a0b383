"""Parity of the port's RANSAC solvers (okvis2x_tpu_torch.frontend.ransac)
with the JAX package.

The JAX package draws hypotheses from jax.random, which torch cannot
reproduce.  So each port core is fed the JAX package's own sample indices
(`ransac._sample_indices` with the same key) and must give the same best
hypothesis: equal inlier masks and counts, poses within 1e-8.  With the
port's own generator the solvers are held to the statistical bounds of
tests/test_bow_ransac.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from okvis2x_tpu.frontend import ransac as jr
from okvis2x_tpu_torch.core import se3np
from okvis2x_tpu_torch.frontend import ransac

torch.set_num_threads(1)
TOL = 1e-8


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def known_rotation_case(rng):
    n = 120
    pts = rng.uniform([-3, -3, 2], [3, 3, 8], (n, 3))
    q_WC = se3np.delta_q(np.array([0.1, -0.05, 0.3]))
    t_true = np.array([0.5, -0.3, 0.2])
    rays = unit((pts - t_true) @ se3np.quat_to_matrix(q_WC))
    rays[:36] = unit(rng.normal(size=(36, 3)))  # 30% outliers
    return q_WC, rays, pts, np.ones(n, bool), t_true


def p3p_case(rng):
    n = 100
    pts = rng.uniform([-3, -3, 2], [3, 3, 8], (n, 3))
    q_WC = se3np.delta_q(np.array([0.05, 0.1, -0.2]))
    t_true = np.array([0.3, 0.1, -0.2])
    p_C = (pts - t_true) @ se3np.quat_to_matrix(q_WC)
    depth = np.linalg.norm(p_C, axis=-1)
    rays = p_C / depth[:, None]
    rays[:25] = unit(rng.normal(size=(25, 3)))
    return rays, pts, np.ones(n, bool), depth, t_true


def rotation_case(rng):
    n = 80
    rays_a = unit(rng.normal(size=(n, 3)))
    q = se3np.delta_q(np.array([0.02, 0.3, -0.1]))
    rays_b = rays_a @ se3np.quat_to_matrix(q)
    rays_b[:16] = unit(rng.normal(size=(16, 3)))
    return rays_a, rays_b, np.ones(n, bool), q


def noncentral_case(rng, n=150, cap=256, n_out=40, noise=2e-4):
    """Two-camera rig (origins +-0.055 m) seeing world points from body pose
    T_WS; valid rows are a prefix of the padded capacity."""
    T_WS = np.concatenate([[0.4, -0.2, 0.1], se3np.delta_q(np.array([0.05, -0.1, 0.4]))])
    pts = rng.uniform([-3, -3, 2], [3, 3, 8], (n, 3))
    cam = rng.integers(0, 2, n)
    origins = np.stack([np.where(cam == 0, -0.055, 0.055), np.zeros(n), np.zeros(n)], -1)
    p_S = se3np.se3_apply(se3np.se3_inverse(T_WS), pts)
    rays = unit(p_S - origins + rng.normal(0, noise, (n, 3)))
    rays[:n_out] = unit(rng.normal(size=(n_out, 3)))
    depth = np.linalg.norm(p_S - origins, axis=-1) * rng.uniform(0.8, 1.2, n)
    pad = lambda a, fill=0.0: np.concatenate(  # noqa: E731
        [a, np.full((cap - n,) + a.shape[1:], fill)])
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return pad(rays), pad(origins), pad(pts), mask, pad(depth, 1.0), T_WS


def T(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def jax_idx(key, n_hyp, s, n):
    return torch.as_tensor(np.array(jr._sample_indices(key, n_hyp, s, n)), dtype=torch.int64)


def assert_same(got, ref):
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_known_rotation_core_matches_jax(seed):
    q, rays, pts, mask, _ = known_rotation_case(np.random.default_rng(10 + seed))
    key = jax.random.PRNGKey(seed)
    ref = jr.absolute_pose_known_rotation(key, jnp.asarray(q), jnp.asarray(rays),
                                          jnp.asarray(pts), jnp.asarray(mask))
    got = ransac.absolute_pose_known_rotation_core(
        jax_idx(key, 256, 2, len(rays)), T(q), T(rays), T(pts), torch.as_tensor(mask))
    assert_same(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_p3p_core_matches_jax(seed):
    rays, pts, mask, depth, _ = p3p_case(np.random.default_rng(20 + seed))
    key = jax.random.PRNGKey(seed)
    ref = jr.absolute_pose_p3p_refined(key, jnp.asarray(rays), jnp.asarray(pts),
                                       jnp.asarray(mask), jnp.asarray(depth))
    got = ransac.absolute_pose_p3p_refined_core(
        jax_idx(key, 512, 3, len(rays)), T(rays), T(pts), torch.as_tensor(mask), T(depth))
    assert_same(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_core_matches_jax(seed):
    ra, rb, mask, _ = rotation_case(np.random.default_rng(30 + seed))
    key = jax.random.PRNGKey(seed)
    ref = jr.relative_rotation_2pt(key, jnp.asarray(ra), jnp.asarray(rb), jnp.asarray(mask))
    got = ransac.relative_rotation_2pt_core(
        jax_idx(key, 128, 2, len(ra)), T(ra), T(rb), torch.as_tensor(mask))
    assert_same(got, ref)


def test_noncentral_core_matches_jax_batched():
    """The loop-closure verifier: three candidates in one batch (the last an
    empty slot, as when fewer candidates pass), each against the JAX solver
    with its own key, as the JAX pipeline vmaps it."""
    rng = np.random.default_rng(40)
    cases = [noncentral_case(rng), noncentral_case(rng, n=60, n_out=10)]
    empty = tuple(np.zeros_like(a) for a in cases[0][:5])
    empty = empty[:3] + (np.zeros(256, bool), np.ones(256))
    batch = [c[:5] for c in cases] + [empty]
    keys = [jax.random.PRNGKey(7 + b) for b in range(3)]
    refs = [jr.absolute_pose_noncentral(k, *[jnp.asarray(a) for a in c], n_hyp=512)
            for k, c in zip(keys, batch)]
    idx = torch.stack([jax_idx(k, 512, 3, max(int(c[3].sum()), 3)) for k, c in zip(keys, batch)])
    stacked = [torch.as_tensor(np.stack([c[i] for c in batch])) for i in range(5)]
    got = ransac.absolute_pose_noncentral_core(idx, *stacked)
    for b in range(3):
        assert_same(ransac.RansacResult(got.T[b], got.inliers[b], got.num_inliers[b]), refs[b])
    assert int(got.num_inliers[2]) == 0
    for b, c in enumerate(cases):
        assert int(got.num_inliers[b]) > 0.6 * c[3].sum()
        np.testing.assert_allclose(got.T[b, :3].numpy(), c[5][:3], atol=5e-2)


def test_known_rotation_own_generator():
    for seed in range(3):
        q, rays, pts, mask, t_true = known_rotation_case(np.random.default_rng(50 + seed))
        res = ransac.absolute_pose_known_rotation(
            T(q), T(rays), T(pts), torch.as_tensor(mask),
            generator=torch.Generator().manual_seed(seed))
        assert int(res.num_inliers) > 70
        np.testing.assert_allclose(res.T[:3].numpy(), t_true, atol=5e-3)
        assert res.inliers[:36].double().mean() < 0.1


def test_p3p_own_generator():
    for seed in range(3):
        rays, pts, mask, depth, t_true = p3p_case(np.random.default_rng(60 + seed))
        res = ransac.absolute_pose_p3p_refined(
            T(rays), T(pts), torch.as_tensor(mask), T(depth),
            generator=torch.Generator().manual_seed(seed))
        assert int(res.num_inliers) > 60
        np.testing.assert_allclose(res.T[:3].numpy(), t_true, atol=1e-2)


def test_rotation_own_generator():
    for seed in range(3):
        ra, rb, mask, q = rotation_case(np.random.default_rng(70 + seed))
        res = ransac.relative_rotation_2pt(T(ra), T(rb), torch.as_tensor(mask),
                                           generator=torch.Generator().manual_seed(seed))
        assert int(res.num_inliers) > 55
        dq = se3np.quat_multiply(se3np.quat_conjugate(res.T[3:7].numpy()), q)
        assert np.linalg.norm(se3np.quat_log(dq)) < 5e-3


def test_noncentral_own_generator():
    """Batched, with the valid-prefix sampling: every real candidate found
    within 5 cm (the refinement places points on their rays, which biases
    the pose at this noise) and its outliers rejected."""
    rng = np.random.default_rng(80)
    cases = [noncentral_case(rng) for _ in range(3)]
    stacked = [torch.as_tensor(np.stack([c[i] for c in cases])) for i in range(5)]
    res = ransac.absolute_pose_noncentral(*stacked, generator=torch.Generator().manual_seed(3))
    for b, c in enumerate(cases):
        assert int(res.num_inliers[b]) > 100
        assert res.inliers[b, :40].double().mean() < 0.1
        np.testing.assert_allclose(res.T[b, :3].numpy(), c[5][:3], atol=5e-2)
        dq = se3np.quat_multiply(se3np.quat_conjugate(res.T[b, 3:7].numpy()), c[5][3:7])
        assert np.linalg.norm(se3np.quat_log(dq)) < 2e-3
