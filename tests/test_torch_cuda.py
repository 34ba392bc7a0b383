"""The port's CUDA kernels on the card, against their plain PyTorch versions,
and the port's device code that has no kernel of its own (the depth nets,
the occupancy grids, dense and brick-sparse, the submap-ICP rows, the LiDAR
pipeline, the mapping modes of the app, the synchronous node) on the card
against the CPU.

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


def test_cuda_app_runs_on_the_card_by_default(cuda, tmp_path, monkeypatch):
    """Without --device the dataset app's pipeline runs on cuda:0 (where
    there is no card it raises: tests/test_torch_app.py)."""
    import os

    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    devices = []
    init = VioPipeline.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        devices.append(self.device)

    monkeypatch.setattr(VioPipeline, "__init__", spy)
    out = str(tmp_path / "out")
    ate = okvis2x_app.main(["--synthetic-test", "--mode", "vio", "--max-frames", "3",
                            "--output", out])
    assert devices == [torch.device("cuda:0")]
    assert np.isfinite(ate) and os.path.exists(os.path.join(out, "trajectory.tum"))


def test_cuda_node_replays_a_bag_on_the_card_by_default(cuda, tmp_path, monkeypatch):
    """Without --device the synchronous node's pipeline runs on cuda:0 (where
    there is no card it raises: tests/test_torch_node.py); its online poses
    on a small ROS1 bag agree with the node's on the CPU within 1e-3 m, as
    chip_smoke.py holds the VIO phase."""
    import os
    import sys
    import types

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from okvis2x_tpu_torch.apps import okvis2x_node_synchronous as node
    from okvis2x_tpu_torch.io import synthetic
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    pipes = []
    init = VioPipeline.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        pipes.append(self)

    monkeypatch.setattr(VioPipeline, "__init__", spy)
    ds = str(tmp_path / "ds")
    cam, T_SC, _ = synthetic.generate(ds, duration=0.8, frame_rate=10.0, width=160, height=120)
    fx, fy, cx, cy = (float(v) for v in cam.fxfycxcy)
    rig = types.SimpleNamespace(T_SC=T_SC, camera=dict(
        width=160, height=120, fx=fx, fy=fy, cx=cx, cy=cy,
        dist_params=[float(v) for v in cam.dist_params]))
    cfg = str(tmp_path / "okvis2.yaml")
    chip_smoke.app_config(cfg, rig)
    bag, _, _ = chip_smoke.write_bags(ds, str(tmp_path))
    args = ["--bag", bag, "--config", cfg, "--max-frames", "4", "--max-keypoints", "128",
            "--no-loop-closures"]
    assert node.main([*args, "--output", str(tmp_path / "card")]) == 0
    assert node.main([*args, "--output", str(tmp_path / "cpu"), "--device", "cpu"]) == 0
    assert [p.device for p in pipes] == [torch.device("cuda:0"), torch.device("cpu")]
    a, b = (np.stack([T[:3] for _, T in p.states_log]) for p in pipes)
    assert a.shape == b.shape == (4, 3) and np.isfinite(a).all()
    assert float(np.abs(a - b).max()) < 1e-3


def textured(h, w, seed):
    """A smooth random texture in [0, 1] (float32)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((1, 1, h + 4, w + 4), generator=g)
    return torch.nn.functional.avg_pool2d(x, 5, stride=1)[0, 0]


@pytest.mark.parametrize("h,w", [(96, 128), (61, 93)])
def test_cuda_depth_nets_match_cpu(cuda, h, w):
    """The shipped stereo and MVS nets on the card against the CPU: disparity
    within 1e-4 px, MVS depth within 1e-5 m, with TF32 allowed around the
    call (the nets turn it off for themselves)."""
    from okvis2x_tpu_torch.models import mvs_net, stereo_net

    left = textured(h, w, 0)
    right = torch.roll(left, -4, dims=1)
    srcs = torch.stack([torch.roll(left, 3, dims=1), torch.roll(left, -2, dims=0)])
    K = torch.tensor([80.0, 80.0, w / 2, h / 2])
    T = torch.eye(4).repeat(2, 1, 1)
    T[0, 0, 3], T[1, 1, 3] = 0.1, -0.1
    out = {}
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cpu", "cuda:0"):
            snet, _ = stereo_net.trained(str(stereo_net.DEFAULT_WEIGHTS), 64, dev)
            mnet, _ = mvs_net.trained(str(mvs_net.DEFAULT_WEIGHTS), dev)
            with torch.no_grad():
                out[dev] = (snet(left.to(dev), right.to(dev))
                            + mnet(left.to(dev), srcs.to(dev), K.to(dev), T.to(dev)))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    (d0, s0, m0, ms0), (d1, s1, m1, ms1) = out["cpu"], [x.cpu() for x in out["cuda:0"]]
    assert (d1 - d0).abs().max() < 1e-4 and ((s1 - s0).abs() / s0).max() < 1e-4
    assert (m1 - m0).abs().max() < 1e-5 and ((ms1 - ms0).abs() / ms0).max() < 1e-5


def test_cuda_occupancy_grid_matches_cpu(cuda):
    """Depth-image integration, interpolation and colour splatting into a
    64^3 grid on the card against the CPU: counts equal, log-odds within
    1e-6, the occupied set equal."""
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.mapping import colour, submap

    cam = pinhole.make_pinhole(100.0, 100.0, 64.0, 48.0, 128, 96, model="none")
    depth = 2.5 + 0.5 * textured(96, 128, 1)
    sigma = 0.01 * depth * depth
    T_KC = torch.tensor([0.1, -0.05, 0.02, 0.0, 0.0, 0.0499792, 0.9987503])
    cfg = submap.SubmapConfig(dim=64, res=0.2)
    grids = {}
    for dev in ("cpu", "cuda:0"):
        sm = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dev)
        for _ in range(3):
            sm = submap.integrate_depth_image(sm, cfg, cam.to(device=dev), T_KC.to(dev),
                                              depth.to(dev), sigma.to(dev))
        _, p_K, ok = submap.depth_rays(cam.to(device=dev), T_KC.to(dev), depth.to(dev), 4, 20.0)
        st = colour.splat(colour.new_store(cfg, device=dev), cfg, p_K,
                          torch.rand((p_K.shape[0], 3), generator=torch.Generator().manual_seed(2))
                          .to(dev), ok)
        q = p_K[:500]
        grids[dev] = (sm, submap.interp_occupancy(sm, cfg, q)[0].cpu(),
                      colour.colour_at(st, cfg, q).cpu())
    (a, ia, ca), (b, ib, cb) = grids["cpu"], grids["cuda:0"]
    assert torch.equal(a.weight, b.weight.cpu())
    assert (a.logodds - b.logodds.cpu()).abs().max() < 1e-6
    assert torch.equal(a.logodds > 1.0, b.logodds.cpu() > 1.0) and bool((a.logodds > 1.0).any())
    assert (ia - ib).abs().max() < 1e-5 and (ca - cb).abs().max() < 1e-6


def test_cuda_brick_grid_matches_cpu(cuda):
    """One depth image integrated three times into the reference's 1024^3
    brick-sparse grid (a 128^3 table, 8192 bricks) on the card against the
    CPU: the table, the slots' brick coordinates, the allocated count and
    the counts equal, log-odds within 1e-5; interpolation, the observed mask,
    the occupied list and a colour splat through the table agree."""
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.mapping import brick, colour, submap

    cam = pinhole.make_pinhole(100.0, 100.0, 64.0, 48.0, 128, 96, model="none")
    depth = 2.5 + 0.5 * textured(96, 128, 3)
    sigma = 0.01 * depth * depth
    T_KC = torch.tensor([0.1, -0.05, 0.02, 0.0, 0.0, 0.0499792, 0.9987503])
    cfg = brick.BrickConfig(samples_per_ray=96, band_samples=18)
    out = {}
    for dev in ("cpu", "cuda:0"):
        sm = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, device=dev)
        for _ in range(3):
            sm = submap.integrate_depth_image(sm, cfg, cam.to(device=dev), T_KC.to(dev),
                                              depth.to(dev), sigma.to(dev))
        _, p_K, ok = submap.depth_rays(cam.to(device=dev), T_KC.to(dev), depth.to(dev), 4, 20.0)
        st = colour.splat(colour.new_store(cfg, device=dev), cfg, p_K,
                          torch.rand((p_K.shape[0], 3), generator=torch.Generator().manual_seed(2))
                          .to(dev), ok, sm=sm)
        q = p_K[:500]
        occ, valid = submap.occupied_point_list(sm, cfg, 1.0, 4096)
        out[dev] = ([x.cpu() for x in sm], submap.interp_occupancy(sm, cfg, q)[0].cpu(),
                    submap.observed_mask(sm, cfg, q).cpu(), occ.cpu(), valid.cpu(),
                    colour.colour_at(st, cfg, q, sm=sm).cpu())
    (a, ia, oa, pa, va, ca), (b, ib, ob, pb, vb, cb) = out["cpu"], out["cuda:0"]
    a, b = brick.BrickSubmap(*a), brick.BrickSubmap(*b)
    for k in ("table", "brick_xyz", "n_alloc", "pool_w"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert 0 < int(a.n_alloc) < cfg.pool_bricks
    assert (a.pool_lo - b.pool_lo).abs().max() < 1e-5
    assert (ia - ib).abs().max() < 1e-5 and torch.equal(oa, ob) and bool(oa.any())
    assert torch.equal(va, vb) and bool(va.any()) and torch.equal(pa[va], pb[vb])
    assert (ca - cb).abs().max() < 1e-6


def icp_problem(device, Q=64):
    """tests/test_icp_solver.py's problem, the port's alone: frame 0 anchors
    a 5 cm grid with a wall at 2 m (pose prior, fixed), frame 1 owns Q
    points of the wall but starts 6 cm off."""
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.mapping import submap
    from okvis2x_tpu_torch.solver import gauss_newton as gn
    from okvis2x_tpu_torch.solver import problem as prb

    cfg = submap.SubmapConfig(dim=96, res=0.05, band_samples=16)
    f64 = dict(dtype=torch.float64, device=device)
    sm = submap.new_submap(np.r_[0, 0, 0, 0, 0, 0, 1.0], cfg, torch.float64, device)
    xs = np.linspace(-1.8, 1.8, 72)
    gx, gy = np.meshgrid(xs, xs)
    end = torch.as_tensor(np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 2.0)], -1), **f64)
    for _ in range(3):
        sm = submap.integrate_rays(sm, cfg, torch.zeros(3, **f64), end,
                                   torch.ones(len(end), dtype=torch.bool, device=device), 0.05)
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-1.5, 1.5, Q), rng.uniform(-1.5, 1.5, Q), np.full(Q, 2.0)], -1)
    T0, T1 = np.r_[0, 0, 0, 0, 0, 0, 1.0], np.r_[0, 0, -0.06, 0, 0, 0, 1.0]
    b = dict(dtype=torch.bool, device=device)
    p = prb.empty_problem(K=2, L=4, C=1, N=4, M=0, R=1, G=0, Q=Q, **f64)._replace(
        T_WS=torch.as_tensor(np.stack([T0, T1]), **f64), frame_valid=torch.ones(2, **b),
        pose_fixed=torch.tensor([True, False], device=device), sb_fixed=torch.ones(2, **b),
        lm_fixed=torch.ones(4, **b), pose_prior_T=torch.as_tensor(np.stack([T0, T0]), **f64),
        pose_prior_sqrt_info=torch.as_tensor(np.stack([100 * np.eye(6), 0 * np.eye(6)]), **f64),
        pose_prior_valid=torch.tensor([True, False], device=device),
        icp_a=torch.zeros(Q, dtype=torch.int64, device=device),
        icp_b=torch.ones(Q, dtype=torch.int64, device=device),
        icp_p_B=torch.as_tensor(pts, **f64), icp_si=torch.full((Q,), 10.0, **f64),
        icp_valid=torch.ones(Q, **b), icp_map=sm)
    cam = pinhole.make_pinhole(400.0, 400.0, 320.0, 240.0, 640, 480, model="none",
                               dist_params=[], device=device)
    return p, gn.stack_cameras([cam]), gn.SolverConfig(icp_cfg=cfg, estimate_landmarks=False,
                                                       max_iterations=5)


def test_cuda_icp_rows_match_cpu(cuda):
    """The per-point submap-ICP rows on the card: the linearisation (H, b,
    cost), the cost and 5 LM iterations against the CPU's."""
    from okvis2x_tpu_torch.solver import gauss_newton as gn

    out = {}
    for dev in ("cpu", cuda):
        p, cams, cfg = icp_problem(dev)
        lin = gn.linearize(p, cams, cfg)
        p_opt, cost = gn.optimize(p, cams, cfg)
        out[str(dev)] = [x.cpu() for x in (lin.H_ff, lin.b_f, lin.cost, p_opt.T_WS, cost)]
    (H0, b0, c0, T0, f0), (H1, b1, c1, T1, f1) = out["cpu"], out[str(cuda)]
    assert (H0 - H1).abs().max() <= 1e-9 * H0.abs().max()
    assert (b0 - b1).abs().max() <= 1e-9 * b0.abs().max()
    assert abs(float(c0 - c1)) <= 1e-9 * float(c0)
    assert (T0 - T1).abs().max() <= 1e-9 and abs(float(T1[1, 2])) < 0.03
    assert abs(float(f0 - f1)) <= 1e-9 * max(float(f0), 1e-12)


def test_cuda_drift_recovery_matches_cpu(cuda):
    """The drift-recovery scenario of tests/test_lidar_vio.py on the card
    (the whole LiDAR pipeline: deskew, filter, submap, per-point rows in the
    window solve) lands where the CPU's does."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    T = {dev: np.array(chip_smoke.drift_recovery(128, dev).est.frames[-1].T_WS)
         for dev in ("cpu", cuda)}
    assert np.abs(T["cpu"][:3] - T[cuda][:3]).max() <= chip_smoke.DRIFT_CPU_TOL_M
    assert abs(T[cuda][2]) < 0.03


@pytest.mark.parametrize("mode", ["rgbd", "depth", "lidar"])
def test_cuda_depth_modes_run_on_the_card(cuda, mode, tmp_path):
    """`--mode rgbd`, `--mode depth` and `--mode lidar` of the dataset app on
    cuda:0 by default: both trajectories and map.ply, the submaps on the
    card."""
    import os

    from okvis2x_tpu_torch.apps import okvis2x_app
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingInterface

    made = []
    init = SubmappingInterface.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    SubmappingInterface.__init__ = spy
    out = str(tmp_path / "out")
    try:
        okvis2x_app.main(["--synthetic-test", "--mode", mode, "--max-frames", "6",
                          "--output", out])
    finally:
        SubmappingInterface.__init__ = init
    assert made[0].device == torch.device("cuda:0") and made[0].maps
    assert all(e.sm.logodds.is_cuda for e in made[0].maps)
    for name in ("trajectory.tum", "final_trajectory.tum", "map.ply"):
        assert os.path.exists(os.path.join(out, name))


def test_no_device_means_cuda_or_an_error():
    """`VioPipeline`, `SlidingWindowEstimator` and `SubmappingInterface`
    built without a device run on the first CUDA device; where there is none
    they raise and do not carry on on the CPU."""
    from okvis2x_tpu_torch.cameras import pinhole
    from okvis2x_tpu_torch.graph.estimator import EstimatorConfig, SlidingWindowEstimator
    from okvis2x_tpu_torch.pipeline.vio import VioPipeline

    cam = pinhole.make_pinhole(280.0, 280.0, 160.0, 120.0, 320, 240,
                               dist_params=[-0.25, 0.06, 1e-4, -1e-4])
    T_SC = np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]])
    from okvis2x_tpu_torch.pipeline.submapping import SubmappingConfig, SubmappingInterface

    build = (lambda: VioPipeline([cam, cam], T_SC, EstimatorConfig()),
             lambda: SlidingWindowEstimator(EstimatorConfig(), [cam, cam], T_SC),
             lambda: SubmappingInterface(SubmappingConfig()))
    for make in build:
        if torch.cuda.is_available():
            assert make().device == torch.device("cuda:0")
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
