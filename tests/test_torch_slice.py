"""The port's VIO slice against the JAX package: the in-memory renderer
against the dataset generator, then both `VioPipeline`s on the same frames
(with loop closure on a vocabulary trained online), and the port's
independence from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.io import euroc
from okvis2x_tpu.io import synthetic as jsyn
from okvis2x_tpu.io.native_loader import decode_image
from okvis2x_tpu.pipeline.vio import PipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch import convert
from okvis2x_tpu_torch.cameras import pinhole
from okvis2x_tpu_torch.frontend import bow
from okvis2x_tpu_torch.io import synthetic
from okvis2x_tpu_torch.pipeline.vio import VioPipeline

# The suite runs in several worker processes; torch's intra-op thread pool
# stalls badly when they oversubscribe the cores, and the port's many small
# ops gain nothing from it.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8
# the online vocabulary is trained once the keyframe records hold this many
# descriptors: at the second keyframe of the run
VOCAB_MIN_DESC = 300


@pytest.fixture(scope="module")
def seq():
    return synthetic.render_sequence(duration=1.15, frame_rate=10.0, width=320, height=240)


@pytest.mark.parametrize("trajectory", ["sinusoid", "circuit"])
def test_renderer_matches_dataset_generator(trajectory, tmp_path):
    kw = dict(duration=1.15, frame_rate=10.0, width=320, height=240, trajectory=trajectory)
    seq = synthetic.render_sequence(**kw)
    out = str(tmp_path / "synth")
    _, T_SC, gt = jsyn.generate(out, **kw)
    root = os.path.join(out, "mav0")
    imu = np.loadtxt(os.path.join(root, "imu0", "data.csv"), delimiter=",", skiprows=1)
    imu_ns = np.loadtxt(os.path.join(root, "imu0", "data.csv"), delimiter=",", skiprows=1,
                        usecols=0, dtype=np.int64)
    np.testing.assert_array_equal(seq.imu_ns, imu_ns)
    np.testing.assert_allclose(seq.gyr, imu[:, 1:4], rtol=0, atol=1e-12)
    np.testing.assert_allclose(seq.acc, imu[:, 4:7], rtol=0, atol=1e-12)
    np.testing.assert_array_equal(seq.T_SC, T_SC)
    np.testing.assert_allclose(seq.gt[:, 1:], gt[:, 1:], rtol=0, atol=1e-12)
    ds = euroc.EurocDataset(out)
    np.testing.assert_allclose(seq.gt[:, 1:], ds.ground_truth[:, 1:], rtol=0, atol=1e-12)
    assert len(ds.frames) == len(seq.frame_t) >= N_FRAMES
    for k, fr in enumerate(ds.frames):
        for c in range(2):
            np.testing.assert_array_equal(seq.images[k, c], decode_image(fr.paths[c]))


def _run(pipe, seq):
    out = []
    for kind, data in seq.events():
        if kind == "imu":
            pipe.add_imu_measurement(*data)
        elif len(out) < N_FRAMES:
            info = pipe.process_frame(data[0], data[1])
            out.append((info["T_WS"][:3].copy(),
                        np.array([info["n_map"], info["n_stereo"], info["n_motion"]]),
                        info["is_keyframe"], info["tracking_quality"].name))
    return out


def jax_init_indices(n, k, seed=0):
    """The JAX package's k-means seed (jax.random), drawn for the port."""
    import jax

    return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k]))


@pytest.fixture(scope="module")
def runs(seq):
    """The small configuration of tests/test_pipeline.py with loop closure on
    a vocabulary trained online (`vocab_path=""`), run by both packages; the
    port draws its k-means seed as the JAX package does.  No keyframe is old
    enough to be a loop candidate, so loop closure only trains, indexes and
    queries.  Returns (JAX pipeline, port pipeline, their frame results)."""
    est_cfg = EstimatorConfig(num_keyframes=4, num_imu_frames=3, cap_frames=10,
                              cap_landmarks=512, cap_obs=4096, cap_imu_links=9,
                              cap_imu_samples=128, max_iterations=5, keypoint_sigma_px=1.0)
    pipe_cfg = PipelineConfig(max_keypoints=256, octaves=1, harris_threshold=1e-6,
                              keyframe_match_fraction=0.5, do_loop_closures=True,
                              vocab_path="", vocab_k=64, vocab_min_desc=VOCAB_MIN_DESC,
                              deferred_frontend=False, pipelined_solve=False, pose_refine=False)
    c = seq.camera
    args = (c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"])
    jcam = jpin.make_pinhole(*args, model=c["model"], dist_params=c["dist_params"])
    tcam = pinhole.make_pinhole(*args, model=c["model"], dist_params=c["dist_params"])
    jp = JVioPipeline([jcam, jcam], seq.T_SC, est_cfg, pipe_cfg)
    tp = VioPipeline([tcam, tcam], seq.T_SC, convert.estimator_config(est_cfg),
                     convert.pipeline_config(pipe_cfg), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bow, "init_indices", jax_init_indices)
        ref, got = _run(jp, seq), _run(tp, seq)
    jp._lc_drain()
    tp._lc_drain()
    return jp, tp, ref, got


def test_pipeline_matches_jax(runs):
    """Positions within 1 cm, the association counts equal in 6 of 8 frames
    and within 10% elsewhere."""
    _, _, ref, got = runs
    assert len(got) == len(ref) == N_FRAMES
    gap = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(got, ref))
    assert gap < 0.01, gap
    same = sum(bool(np.array_equal(a[1], b[1])) for a, b in zip(got, ref))
    assert same >= 6, [(a[1], b[1]) for a, b in zip(got, ref)]
    for a, b in zip(got, ref):
        assert (np.abs(a[1] - b[1]) <= np.ceil(0.1 * b[1])).all(), (a[1], b[1])
    assert [a[2:] for a in got] == [b[2:] for b in ref]  # keyframe flags, tracking quality
    assert sum(int(b[1][1]) for b in ref) > 50  # the run triangulated landmarks


def test_online_vocabulary_matches_jax(runs):
    """The vocabulary trained in the run, every keyframe's words and the BoW
    scores equal the JAX pipeline's; recognition stayed on the frame
    thread."""
    jp, tp, _, _ = runs
    assert tp.vocab is not None and not tp._vocab_pretrained and not tp._use_async_pr()
    np.testing.assert_array_equal(tp.vocab.numpy(), convert.pack_pm1(jp.vocab))
    assert list(tp.kf_records) == list(jp.kf_records) and len(tp.kf_records) >= 3
    first = sum(int(r["valid"].sum()) for r in list(jp.kf_records.values())[:1])
    assert first < VOCAB_MIN_DESC  # trained at a later keyframe, earlier ones re-indexed
    for f, r in jp.kf_records.items():
        np.testing.assert_array_equal(tp.kf_records[f]["packed"].view(np.uint32), r["packed"])
        np.testing.assert_array_equal(tp.kf_records[f]["words"], r["words"])
    tdb, jdb = tp.bow_db, jp.bow_db
    assert tdb.n_frames == jdb.n_frames
    np.testing.assert_array_equal(tdb.word_df, jdb.word_df)
    for f, r in jp.kf_records.items():
        assert tdb.query(r["words"], r["valid"], top=8) == jdb.query(r["words"], r["valid"],
                                                                     top=8)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import okvis2x_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import okvis2x_tpu_torch.pipeline.vio\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'okvis2x_tpu' or m.startswith('okvis2x_tpu.')]\n"
        "assert not bad, bad\n"
        "assert len(names) > 20, names\n"
        "print('ok', len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_cuda_device_needs_cuda():
    """The port takes its device from the caller; asking for a GPU where
    there is none raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cam = pinhole.make_pinhole(280.0, 280.0, 160.0, 120.0, 320, 240,
                               dist_params=[-0.25, 0.06, 1e-4, -1e-4])
    T_SC = np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]])
    with pytest.raises((RuntimeError, AssertionError)):
        VioPipeline([cam, cam], T_SC, convert.estimator_config(EstimatorConfig()),
                    device="cuda")
