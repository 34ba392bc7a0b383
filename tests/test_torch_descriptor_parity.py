"""Packed descriptors of the port against the JAX package's frame program, bit
for bit, where they used to part (C4 in ROADMAP.md), and what is left of
the parting (C-H14).

The frames are the first three of the depth phase's sinusoid dataset at
752x480 (`chip_smoke.DEPTH_DATA["depth"]`); the angles are those the two
apps fed their frontends on that dataset of 24 frames.  At the angles of
frames 1, 6 and 15 the port's descriptors differed on a few keypoints a
camera: XLA's CPU code takes the extraction direction's cosine and sine
from the C library's cosf and sinf (the port took ATen's, an ulp off on
some angles: more than 1% of them below) and rotates the pattern as a
two-term dot whose second product is fused.  Both are reproduced now (`descriptor.sincosf`).

What remains is not the descriptor's: from frame 2 on, the two apps' states
differ in their last digits (float64 solves that sum in another order), so
their gravity-aligned angles differ by about 6e-9 rad, and that moves a
sample by enough to flip a bf16-rounded interpolation weight.  The JAX
package's own program gives other bits for the two angles.  In the rgbd
mode the same difference in the states moves a keyframe's fused depth in
the JAX package's own program (the last test)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # as a script
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.graph import EstimatorConfig
from okvis2x_tpu.pipeline.vio import PipelineConfig as JPipelineConfig
from okvis2x_tpu.pipeline.vio import VioPipeline as JVioPipeline
from okvis2x_tpu_torch.frontend import descriptor
from okvis2x_tpu_torch.io import euroc
from okvis2x_tpu_torch.pipeline.vio import PipelineConfig, VioPipeline

import chip_smoke

torch.set_num_threads(1)

# the angles (rad, as the float64 the apps computed) at which the port's
# descriptors of the same images parted from the JAX app's: frames 1, 6, 15
PARTING_ANGLES = (-0.0002445125534618623, -0.03950376178567831, -0.11214719735623906)
# frame 2: the JAX app's angle and the port's, 6e-9 rad apart
FRAME2_ANGLES = (-0.0007913118889650893, -0.0007913178873068353)


@functools.lru_cache(maxsize=None)
def frames(tmp_root):
    """The first three stereo pairs of the depth phase's dataset, as uint8
    width-padded (2, H, W') stacks, as both pipelines pack them."""
    ds_dir, _ = chip_smoke.depth_dataset(tmp_root, "depth", 2)
    ds = euroc.EurocDataset(ds_dir)
    out = []
    for fr in ds.frames[:3]:
        imgs = [ds.load_image(p) for p in fr.paths]
        if imgs[0].dtype != np.uint8:  # as both pipelines pack a frame
            imgs = [np.clip(im * 255.0, 0, 255).astype(np.uint8) for im in imgs]
        out.append(np.stack([VioPipeline._pad_width(im) for im in imgs]))
    return out


@functools.lru_cache(maxsize=None)
def programs():
    """The JAX package's frame program (`VioPipeline._detect_fn`: detection and
    description of both cameras in one jitted program, the app's defaults)
    and the port's stage-2 function on the CPU."""
    cam = jpin.make_pinhole(460.0, 460.0, 376.0, 240.0, 752, 480, model="radtan",
                            dist_params=[-0.25, 0.06, 1e-4, -1e-4])
    T_SC = np.array([[-0.055, 0, 0, 0, 0, 0, 1.0], [0.055, 0, 0, 0, 0, 0, 1.0]])
    jp = JVioPipeline([cam, cam], T_SC, EstimatorConfig(), JPipelineConfig())
    from okvis2x_tpu_torch import convert

    tp = VioPipeline([convert.camera(cam)] * 2, T_SC, convert.estimator_config(EstimatorConfig()),
                     PipelineConfig(), device="cpu")

    def jax_desc(imgs, angles):
        out = np.asarray(jp._detect_fn(imgs.shape)(jnp.asarray(imgs),
                                                   jnp.asarray(angles, jnp.float32)))
        return out[:, :, :2].view(np.float32), out[:, :, 2] > 0, out[:, :, 3:15].view(np.int32)

    def port_desc(imgs, angles):
        uv, valid, packed = tp._detect_describe_device(torch.from_numpy(imgs), angles)
        return uv.numpy(), valid.numpy(), packed.numpy()

    return jax_desc, port_desc


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return frames(str(tmp_path_factory.mktemp("c4")))


def test_sincosf_is_xlas_cos_and_sin():
    """`descriptor.sincosf` equals the JAX package's jitted float32 cosine
    and sine bit for bit over the angles a gravity direction gives (and
    beyond, to |x| < 120); ATen's differ on some of them, the parting angle
    of frame 1 among them."""
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.uniform(-np.pi, np.pi, 200_000), rng.normal(0, 1e-3, 50_000),
                        rng.uniform(-100, 100, 20_000), np.float32(PARTING_ANGLES),
                        np.float32([0.0, 2.0**-12, -(2.0**-12), np.pi / 4, np.pi])])
    a = a.astype(np.float32)
    s, c = descriptor.sincosf(torch.from_numpy(a))
    js, jc = jax.jit(lambda x: (jnp.sin(x), jnp.cos(x)))(jnp.asarray(a))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    aten = torch.cos(torch.from_numpy(a)).numpy()
    assert (aten != np.asarray(jc)).mean() > 0.01
    assert aten[-8] != np.asarray(jc)[-8]  # frame 1's angle: 1.0 against 0.99999994


@pytest.mark.parametrize("angle", PARTING_ANGLES)
def test_parting_frames_bit_exact(data, angle):
    """Frame 1 at each parting angle through both programs: the same
    keypoints and every packed descriptor equal."""
    jax_desc, port_desc = programs()
    imgs = data[1]
    uj, vj, pj = jax_desc(imgs, [angle, angle])
    ut, vt, pt = port_desc(imgs, [angle, angle])
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ut[vt], uj[vj])
    assert vj.sum() > 500
    np.testing.assert_array_equal(pt, pj)


def test_state_difference_moves_bits_in_jax(data):
    """C-H14: frame 2 at the JAX app's and at the port's angle (6e-9 rad
    apart, from states that differ in their last digits).  The port equals
    the JAX program at each angle, and the JAX program's own descriptors
    differ between the two."""
    jax_desc, port_desc = programs()
    imgs = data[2]
    packed = {}
    for a in FRAME2_ANGLES:
        _, vj, pj = jax_desc(imgs, [a, a])
        _, _, pt = port_desc(imgs, [a, a])
        np.testing.assert_array_equal(pt, pj)
        packed[a] = pj
    moved = (packed[FRAME2_ANGLES[0]] != packed[FRAME2_ANGLES[1]]).any(axis=-1)
    assert 0 < moved.sum() < 0.2 * vj.sum(), moved.sum()


# the rgbd mode's keyframe 6 on the 12-frame dataset of tests/test_torch_app.py:
# the poses of its two multi-view sources (keyframes 4 and 5) in its camera,
# float32 as each app passed them, from the port's states and from the JAX
# app's (8.2e-8 apart)
KF6_T_RS = {
    "port": [[0.011167637072503567, 0.002932511502876878, 0.09145333617925644,
              0.0006437241099774837, -0.0013194822240620852, -0.0007463167421519756,
              0.9999986290931702],
             [0.006755776237696409, 0.0016019458416849375, 0.05249832570552826,
              0.0004138386866543442, -0.0007299992139451206, -0.00046709668822586536,
              0.9999995231628418]],
    "jax": [[0.011167611926794052, 0.002932540141046047, 0.09145325422286987,
             0.0006437252159230411, -0.0013194815255701542, -0.0007463191286660731,
             0.9999986290931702],
            [0.006755772978067398, 0.0016019691247493029, 0.05249829217791557,
             0.0004138404910918325, -0.0007300002034753561, -0.00046709791058674455,
             0.9999995231628418]],
}


def kf6_depths(root):
    """Keyframe 6's fused depth on each app's source poses (KF6_T_RS), from
    the port's app function and the JAX app's program, on the app test's
    12-frame rgbd dataset written under `root`: {poses: (port fused, JAX
    fused, port multi-view, JAX multi-view)}."""
    from okvis2x_tpu.io import synthetic as jsyn
    from okvis2x_tpu.models import mvs as jmvs
    from okvis2x_tpu.models import stereo as jstereo
    from okvis2x_tpu_torch.apps.okvis2x_app import fused_depth
    from okvis2x_tpu_torch.io import xdataset
    from okvis2x_tpu_torch.models import mvs

    _, T_SC, _ = jsyn.generate(str(root), duration=0.3 + 12 / 10.0 - 0.05, frame_rate=10.0,
                               width=320, height=240, with_depth=True)
    ds = xdataset.XDataset(str(root))
    fr = [d for k, d in ds.events() if k == "frames"]
    img = {f: [np.asarray(ds.load_image(p), np.float32) for p in fr[f].paths] for f in (4, 5, 6)}
    left, right = img[6]
    srcs = np.stack([img[4][0], img[5][0]])
    fx, cx, cy = 280.0, 160.0, 120.0  # tests/test_torch_app.py's camera at 320x240
    baseline = float(np.linalg.norm(T_SC[1][:3] - T_SC[0][:3]))
    K = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]], np.float32)

    @jax.jit
    def jax_fused(left, right, srcs, K, T_rs):  # as apps/okvis2x_app.py fuses
        sd = jstereo.stereo_depth(left, right, fx, baseline)
        md = jmvs.mvs_depth(left, srcs, K, T_rs)
        d, _ = jstereo.fuse_depths(jnp.where(sd.valid, sd.depth, 0.0), sd.sigma,
                                   jnp.where(md.valid, md.depth, 0.0), md.sigma)[:2]
        return d, md.depth

    t = {k: torch.as_tensor(x) for k, x in (("l", left), ("r", right), ("s", srcs), ("K", K))}
    out = {}
    for who, T_rs in KF6_T_RS.items():
        T_rs = np.asarray(T_rs, np.float32)
        jd, jmd = (np.asarray(x) for x in jax_fused(left, right, srcs, K, T_rs))
        Tt = torch.as_tensor(T_rs)
        d, _ = fused_depth(t["l"], t["r"], fx, baseline, t["s"], t["K"], Tt)
        md = mvs.mvs_depth(t["l"], t["s"], t["K"], Tt).depth.numpy() if who == "jax" else None
        out[who] = (d.numpy(), jd, md, jmd)
    return out


def test_state_difference_moves_fused_depth_in_jax(tmp_path):
    """C-H14 in the rgbd mode: keyframe 6's fused depth (the learned stereo
    and multi-view depth) on the source poses of each app's states.  On the
    same poses the port's fused depth is the JAX program's within 1e-5 m (on
    the JAX app's, the multi-view depth within 1e-8 m); the JAX program's own
    fused depth moves by more than 1e-3 m between the two apps' poses.  So
    the rgbd app test holds 8 frames: at 12, this keyframe moves 6 voxels'
    log-odds by up to 1.28e-5 against the JAX app's grid."""
    out = kf6_depths(tmp_path)
    for d, jd, _, _ in out.values():
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    _, _, md, jmd = out["jax"]
    np.testing.assert_allclose(md, jmd, rtol=0, atol=1e-8)
    assert float(np.abs(out["port"][1] - out["jax"][1]).max()) > 1e-3


if __name__ == "__main__":
    # the gaps behind the test above:
    #   JAX_PLATFORMS=cpu python tests/test_torch_descriptor_parity.py
    import tempfile

    import conftest  # noqa: F401  (the CPU platform and float64, as under pytest)

    with tempfile.TemporaryDirectory() as root:
        out = kf6_depths(root)
    for who, (d, jd, md, jmd) in out.items():
        print(f"on the {who} app's poses: port vs JAX fused depth max |gap| "
              f"{np.abs(d - jd).max():.3g} m"
              + ("" if md is None else f", multi-view {np.abs(md - jmd).max():.3g} m"))
    print(f"the JAX program's fused depth between the two poses: max |gap| "
          f"{np.abs(out['port'][1] - out['jax'][1]).max():.3g} m")
