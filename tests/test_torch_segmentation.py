"""The port's semantic keypoint weighting against the JAX package's:
FastSCNN with the shipped weights, the keypoint classes and weights, the
sky heuristic, the textured world and its class maps, the fourth column of
the deferred fused frontend and the observation sigmas it gives, an 8-frame
run of the textured world with the weighting on, and C-R19 (the synchronous
frontend never computes the weights, in either package).

Tolerances: FastSCNN's logits to 5e-5 (float32 convolutions summed in
another order; the largest gap measured is 4e-6 on logits up to 9); the
class of a keypoint equal wherever the JAX logits' top two differ by more
than 1e-4 (a closer pair is a tie at that tolerance); weights, the sky
heuristic and the textured world's images and class maps exactly; the fused
frontend's fourth column exactly; the 8-frame run's positions within 2e-4 m
(test_torch_deferred.py's bound at depth 1), its ATE within 1e-3 m and the
sigmas of the observations both runs share exactly.

`python tests/test_torch_segmentation.py` runs the JAX pipeline on the CPU
on chip_smoke.py's segmentation phase (SEG_DATA: 16 frames at 752x480, the
flagship's configuration, weighting off and "net") and prints the ATEs that
phase holds the card to (`chip_smoke.JAX_SEG`)."""

import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from okvis2x_tpu.cameras import pinhole as jpin  # noqa: E402
from okvis2x_tpu.graph import EstimatorConfig  # noqa: E402
from okvis2x_tpu.io import synthetic as jsyn  # noqa: E402
from okvis2x_tpu.models import segmentation as jseg  # noqa: E402
from okvis2x_tpu.pipeline.vio import PipelineConfig  # noqa: E402
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline  # noqa: E402
from okvis2x_tpu_torch import convert  # noqa: E402
from okvis2x_tpu_torch.cameras import pinhole, pinhole_np  # noqa: E402
from okvis2x_tpu_torch.io import png, synthetic, trajectory_io  # noqa: E402
from okvis2x_tpu_torch.models import segmentation as seg  # noqa: E402
from okvis2x_tpu_torch.pipeline.vio import VioPipeline  # noqa: E402
from test_torch_deferred import EST, PIPE, POS_TOL, cameras, drain_waiting  # noqa: E402
from test_torch_lc_slice import pin_to_cores, run_cache_dir, use_compile_cache  # noqa: E402

torch.set_num_threads(1)

LOGIT_TOL = 5e-5
MARGIN = 1e-4
ATE_TOL_M = 1e-3
SIZES = [(120, 160), (480, 752)]
# tests/test_adversarial.py's textured world at 320x240, 8 frames
TEX = dict(duration=1.1, frame_rate=10.0, width=320, height=240, trajectory="circuit",
           fx=280.0, density=16.0, seed=21, world="textured",
           world_kwargs=dict(n_distractors=10, n_panels=14, n_clouds=8),
           traj_kwargs=dict(radius=6.0, speed=1.5))
N_FRAMES = 8
SEG_PIPE = dict(PIPE, pipeline_depth=1, segmentation="net")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX half of `runs` (`jax_run`), started in a spawned process by
    this file's first test, so that it runs while the tests before `runs`
    do."""
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        yield pool.submit(jax_run, run_cache_dir(tmp_path_factory))


@pytest.fixture(scope="module")
def flax_net():
    jseg.trained_net()  # loaded outside any trace, so that jitted calls may use it (C-R20)
    params, _ = jseg.load_params()
    net = seg.FastSCNN()
    net.load_state_dict(convert.fast_scnn_params(params))
    return params, net.eval()


def textured_image(H, W, seed=0):
    """A frame of the textured world (sky, panels, dots) at H x W."""
    cam = pinhole_np.NpCamera(fxfycxcy=np.array([0.61 * W, 0.61 * W, W / 2, H / 2]),
                              dist_params=np.array([-0.25, 0.06, 1e-4, -1e-4]), width=W,
                              height=H, model="radtan")
    world = synthetic.make_textured_world(radius=6.0, seed=21, density=16.0, n_distractors=10,
                                          n_panels=14, n_clouds=8)
    p, q, _, _, _ = synthetic.circuit_trajectory(np.array([0.5]), radius=6.0, speed=1.5)
    return synthetic.render_textured(cam, np.r_[p[0], q[0]], world, 0.5, seed=seed)


def keypoints(rng, H, W, n=600):
    """Keypoints across the image, some off its edges, some on half pixels."""
    uv = rng.uniform([-3, -3], [W + 3, H + 3], (n, 2))
    uv[: n // 4] = np.round(uv[: n // 4] * 2) / 2
    return uv.astype(np.float32)


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("H,W", SIZES)
def test_fast_scnn_matches_flax(flax_net, H, W):
    """The shipped weights through both nets: logits, then the class and
    weight of every keypoint."""
    params, net = flax_net
    img = textured_image(H, W)
    ref = np.asarray(jax.jit(jseg.FastSCNN().apply)(params, jnp.asarray(img)))
    with torch.no_grad():
        got = net(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape == (H, W, seg.NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LOGIT_TOL)

    uv = keypoints(np.random.default_rng(H), H, W)
    jc = np.asarray(jseg.sample_classes(jnp.asarray(ref), jnp.asarray(uv)))
    tc = seg.sample_classes(torch.from_numpy(got), torch.from_numpy(uv)).numpy()
    x = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    y = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    top2 = np.sort(ref[y, x], axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(tc[clear], jc[clear])
    jw = np.asarray(jseg.keypoint_weights_from_classes(jnp.asarray(jc)))
    tw = seg.keypoint_weights_from_classes(torch.from_numpy(jc)).numpy()
    assert tw.dtype == np.float32
    np.testing.assert_array_equal(tw, jw)
    assert set(np.unique(jc)) >= {0, seg.SKY}, np.unique(jc)  # the net sees sky and structure


def test_keypoint_weights_match_jax(flax_net):
    """`keypoint_weights` with each engine on one image, and the heuristic on
    a flat bright patch: equal to the JAX package's."""
    H, W = 96, 128
    img = textured_image(H, W, seed=3)
    img[10:30, 20:60] = 0.9  # bright and flat in the upper 40%
    uv = keypoints(np.random.default_rng(5), H, W, 800)
    grid = np.stack(np.meshgrid(np.arange(22, 57, 7), np.arange(12, 29, 2)), -1).reshape(-1, 2)
    uv[:len(grid)] = grid  # on the patch
    for engine in ("net", "heuristic", "auto"):
        run = jax.jit(lambda im, kp: jseg.keypoint_weights(im, kp, engine=engine))
        ref = np.asarray(run(jnp.asarray(img), jnp.asarray(uv)))
        got = seg.keypoint_weights(torch.from_numpy(img), torch.from_numpy(uv), engine=engine)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.float32))
        assert set(np.unique(ref)) <= {1.0, 3.0, 5.0}
    heu = np.asarray(jseg.sky_heuristic_weights(jnp.asarray(img), jnp.asarray(uv)))
    assert (heu == 5.0).sum() >= 30 and (heu == 1.0).sum() > 500
    batched = seg.keypoint_weights(torch.from_numpy(np.stack([img, img[::-1].copy()])),
                                   torch.from_numpy(np.stack([uv, uv])), engine="heuristic")
    np.testing.assert_array_equal(batched[0].numpy(), heu)


def test_textured_world_matches_jax(tmp_path):
    """`generate(world="textured", with_classmap=True)`: the PNGs of both
    cameras and the class maps decode to the JAX package's pixels, the CSVs
    are equal, and `render_sequence` yields the same frames in memory."""
    kw = dict(TEX, duration=0.6, width=160, height=120, fx=140.0, with_classmap=True)
    jsyn.generate(str(tmp_path / "j"), **kw)
    synthetic.generate(str(tmp_path / "p"), **kw)
    seq = synthetic.render_sequence(**kw)
    n = 0
    for sub in ("cam0", "cam1", "seg0"):
        j, t = tmp_path / "j" / "mav0" / sub, tmp_path / "p" / "mav0" / sub
        assert (j / "data.csv").read_text() == (t / "data.csv").read_text()
        names = sorted(os.listdir(j / "data"))
        assert names == sorted(os.listdir(t / "data")) and len(names) == 3
        for i, f in enumerate(names):
            ref = np.asarray(Image.open(j / "data" / f))
            got = png.read(str(t / "data" / f))
            assert got.dtype == ref.dtype == np.uint8
            np.testing.assert_array_equal(got, ref)
            mem = seq.classmaps[i] if sub == "seg0" else seq.images[i, int(sub[3])]
            np.testing.assert_array_equal(mem, ref)
            n += 1
    counts = np.bincount(seq.classmaps.ravel(), minlength=3)
    assert counts.min() > 0, counts  # static, sky and distractor pixels all present
    for sub in ("imu0", "state_groundtruth_estimate0"):
        assert ((tmp_path / "j" / "mav0" / sub / "data.csv").read_text()
                == (tmp_path / "p" / "mav0" / sub / "data.csv").read_text())


# ------------------------------------------------- the fused frontend in a run
def observations(est):
    """{(frame, camera, uv bytes): sigma} of every live and archived
    observation of an estimator (either package)."""
    out = {}
    for fid, cam, uv, sig in zip(est.obs_fid, est.obs_cam, np.asarray(est.obs_uv),
                                 est.obs_sigma):
        out[(int(fid), int(cam), np.asarray(uv, np.float64).tobytes())] = float(sig)
    for fid, cam, uv, sig in zip(est.arch_obs_fid, est.arch_obs_cam, est.arch_obs_uv,
                                 est.arch_obs_sigma):
        out[(int(fid), int(cam), np.asarray(uv, np.float64).tobytes())] = float(sig)
    return out


def _run(pipe, seq, record=None):
    """N_FRAMES frames of `seq`, then finish(): the online positions, ATE and
    observation sigmas."""
    n = 0
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
        elif n < N_FRAMES:
            pipe.process_frame(data[0], data[1])
            n += 1
    pipe.finish()
    ts = np.array([s[0] for s in pipe.states_log])
    ps = np.stack([s[1][:3] for s in pipe.states_log])
    ate = trajectory_io.ate_rmse(ts, ps, seq.gt[:, 0], seq.gt[:, 1:4])
    return dict(positions=ps, ate=float(ate), obs=observations(pipe.est), dispatches=record)


def jax_run(cache_dir=None):
    """The JAX pipeline's run with the weighting on, in a process of its own
    on two cores; it keeps the staged images, poses and critical blocks of
    every fused-frontend launch."""
    pin_to_cores(0)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    use_compile_cache(cache_dir)
    seq = synthetic.render_sequence(**TEX)
    jpipe = drain_waiting(JVioPipeline(cameras(seq, jpin), seq.T_SC, EstimatorConfig(**EST),
                                       PipelineConfig(**SEG_PIPE)))
    rec, dispatch = [], jpipe.frontend_dispatch

    def keep(fid, t, staged, T_WS_pred, depth_images=None):
        h = dispatch(fid, t, staged, T_WS_pred, depth_images)
        rec.append(dict(imgs=np.asarray(staged[1]), T_WS=np.asarray(T_WS_pred).copy(),
                        crit=np.asarray(h["crit"])))
        return h

    jpipe.frontend_dispatch = keep
    return _run(jpipe, seq, rec)


@pytest.fixture(scope="module")
def runs(jax_ref):
    """The textured world with the weighting on, run by both packages at
    once: the JAX pipeline in a spawned process (`jax_ref`), the port in
    this one."""
    seq = synthetic.render_sequence(**TEX)
    tpipe = VioPipeline(cameras(seq, pinhole), seq.T_SC,
                        convert.estimator_config(EstimatorConfig(**EST)),
                        convert.pipeline_config(PipelineConfig(**SEG_PIPE)), device="cpu")
    got = _run(tpipe, seq)
    return got, jax_ref.result(timeout=600), tpipe


def test_fused_fourth_column_matches_jax(runs):
    """The port's detection and weighting on the staged inputs of every
    fused-frontend launch of the JAX run: keypoints equal and the fourth
    column (the sigma multipliers) equal keypoint by keypoint, with some
    keypoints downweighted."""
    _, ref, tpipe = runs
    C, N = 2, PIPE["max_keypoints"]
    n_down = 0
    for d in ref["dispatches"]:
        det = d["crit"][:C * N * 4].reshape(C, N, 4)
        juv, jvalid = det[:, :, :2].copy().view(np.float32), det[:, :, 2] > 0
        jw = det[:, :, 3].copy().view(np.float32)
        imgs = torch.from_numpy(d["imgs"])
        uv, valid, _ = tpipe._detect_describe_device(imgs, tpipe._gravity_angles(C, d["T_WS"]))
        w = tpipe._keypoint_weights(imgs, uv).numpy()
        uv, valid = uv.numpy(), valid.numpy()
        assert w.dtype == np.float32
        for c in range(C):
            got = {uv[c][k].tobytes(): w[c][k] for k in np.nonzero(valid[c])[0]}
            want = {juv[c][k].tobytes(): jw[c][k] for k in np.nonzero(jvalid[c])[0]}
            assert got == want, f"camera {c}: keypoints or weights differ"
            n_down += int((jw[c][jvalid[c]] > 1).sum())
        assert set(np.unique(jw)) <= {1.0, 3.0, 5.0}
    assert len(ref["dispatches"]) == N_FRAMES and n_down > 0


def test_weighted_run_matches_jax(runs):
    """Positions within POS_TOL, the ATE within 1e-3 m, and the sigmas of
    the observations both runs share equal, some of them scaled."""
    got, ref, tpipe = runs
    assert abs(got["ate"] - ref["ate"]) <= ATE_TOL_M, (got["ate"], ref["ate"])
    np.testing.assert_allclose(got["positions"], ref["positions"], rtol=0,
                               atol=POS_TOL["depth1"])
    shared = got["obs"].keys() & ref["obs"].keys()
    assert len(shared) >= 0.95 * len(ref["obs"]) > 0, (len(shared), len(ref["obs"]))
    assert all(got["obs"][k] == ref["obs"][k] for k in shared)
    base = tpipe.est.cfg.keypoint_sigma_px
    scaled = [ref["obs"][k] for k in shared if ref["obs"][k] != base]
    assert scaled and set(scaled) <= {3.0 * base, 5.0 * base}, set(scaled)


def test_synchronous_frontend_ignores_segmentation():
    """C-R19: the JAX package's synchronous `detect_and_describe` never sets
    `FrameData.w`, so observation sigmas stay the keypoint sigma there even
    with the weighting on; the port copies it.  The fused path's weights on
    the same frame are not all 1."""
    seq = synthetic.render_sequence(**dict(TEX, duration=0.35))
    imgs = list(seq.images[0].astype(np.float32) / 255.0)
    T_WS = np.r_[seq.gt[0, 1:4], seq.gt[0, 4:8]]
    sync = dict(PIPE, segmentation="net")
    jpipe = JVioPipeline(cameras(seq, jpin), seq.T_SC, EstimatorConfig(**EST),
                         PipelineConfig(**sync))
    tpipe = VioPipeline(cameras(seq, pinhole), seq.T_SC,
                        convert.estimator_config(EstimatorConfig(**EST)),
                        convert.pipeline_config(PipelineConfig(**sync)), device="cpu")
    for pipe in (jpipe, tpipe):
        for fd in pipe.detect_and_describe(imgs, T_WS):
            assert fd.w is None
            assert pipe._obs_sigma(fd, np.nonzero(fd.valid)[0]) is None
    imgs_d = torch.from_numpy(tpipe._pack_images(imgs))
    uv, valid, _ = tpipe._detect_describe_device(imgs_d, tpipe._gravity_angles(2, T_WS))
    assert (tpipe._keypoint_weights(imgs_d, uv)[valid] > 1).any()


# ------------------------------------------- the card's phase: the JAX bound
def jax_seg_bound():
    """The JAX pipeline on chip_smoke.py's segmentation phase on the CPU,
    weighting off and "net": online ATE and positions of each, each frame
    run to its end (the budget controller then sees no wait, as the port's
    deferred mode on the card does, C2)."""
    from okvis2x_tpu.utils import jaxconfig

    jaxconfig.setup()
    seq = chip_smoke.seg_sequence()
    out = {}
    for mode in ("off", "net"):
        est = EstimatorConfig(**(chip_smoke.BASE_EST | chip_smoke.FLAGSHIP_EST))
        cfg = PipelineConfig(**(dict(max_keypoints=704) | chip_smoke.FLAGSHIP_PIPE
                                | dict(segmentation=mode)))
        pipe = drain_waiting(JVioPipeline(cameras(seq, jpin), seq.T_SC, est, cfg))
        n = 0
        for kind, data in seq.events():
            if kind == "imu":
                pipe.add_imu_measurement(*data)
            elif n < chip_smoke.SEG_FRAMES:
                pipe.process_frame(data[0], data[1])
                for item in list(pipe._inflight):
                    item["_ev"].wait()
                n += 1
        pipe.finish()
        ts = np.array([s[0] for s in pipe.states_log])
        ps = np.stack([s[1][:3] for s in pipe.states_log])
        out[mode] = dict(ate_online_m=float(trajectory_io.ate_rmse(ts, ps, seq.gt[:, 0],
                                                                     seq.gt[:, 1:4])),
                         rt_iters=int(pipe.est._rt_iters), positions=ps.tolist())
    return out


if __name__ == "__main__":
    print(json.dumps(jax_seg_bound()))
