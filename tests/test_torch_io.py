"""The port's dataset layer against the JAX package: the PNG/PGM codec and
the YAML reader against Pillow and PyYAML, config loading, the EuRoC,
extended, Leica and RPG readers, the dataset writer and generator, the debug
CSVs, the public API types, IMU propagation, the pseudo-IMU residual and the
camera rig.  Inputs come from seeded numpy; integers, parsed values and
pixels must be equal, floats within the stated tolerance."""

import dataclasses
import filecmp
import io
import math
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from okvis2x_tpu import api as japi
from okvis2x_tpu.cameras import ncamera as jncam
from okvis2x_tpu.cameras import pinhole as jpin
from okvis2x_tpu.factors import imu_factor as jimu_factor
from okvis2x_tpu.imu import preintegration as jpre
from okvis2x_tpu.io import config as jconfig
from okvis2x_tpu.io import debug_csv as jdebug
from okvis2x_tpu.io import euroc as jeuroc
from okvis2x_tpu.io import leica as jleica
from okvis2x_tpu.io import rpg as jrpg
from okvis2x_tpu.io import synthetic as jsyn
from okvis2x_tpu.io import xdataset as jx
from okvis2x_tpu.io.dataset_writer import DatasetWriter as JDatasetWriter
from okvis2x_tpu.io.native_loader import decode_image as jdecode_image
from okvis2x_tpu_torch import api, convert
from okvis2x_tpu_torch.cameras import ncamera, pinhole
from okvis2x_tpu_torch.factors import imu_factor
from okvis2x_tpu_torch.imu import preintegration
from okvis2x_tpu_torch.io import config, debug_csv, euroc, leica, png, rpg, synthetic, xdataset
from okvis2x_tpu_torch.io import yaml_subset
from okvis2x_tpu_torch.io.dataset_writer import DatasetWriter

torch.set_num_threads(1)

TOL = 1e-12


# ---------------------------------------------------------------- PNG / PGM

def _filter_rows(img_bytes: np.ndarray, ftypes, bpp: int) -> bytes:
    """PNG row filtering written out per byte (the specification's
    definitions, independent of the decoder under test)."""
    H, S = img_bytes.shape
    x = img_bytes.astype(np.int64)
    out = bytearray()
    for r in range(H):
        f = ftypes[r]
        out.append(f)
        for i in range(S):
            a = x[r, i - bpp] if i >= bpp else 0
            b = x[r - 1, i] if r > 0 else 0
            c = x[r - 1, i - bpp] if r > 0 and i >= bpp else 0
            if f == 0:
                pred = 0
            elif f == 1:
                pred = a
            elif f == 2:
                pred = b
            elif f == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x[r, i] - pred) & 0xFF)
    return bytes(out)


def _png_bytes(W, H, depth, colour, idat: bytes, interlace=0) -> bytes:
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))
    return (png.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(idat)) + chunk(b"IEND", b""))


def _image(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.integers(0, 65536, shape).astype(np.uint16)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("filters", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_filters_decode_as_pillow(filters, dtype):
    """Every filter type, written by the test, at 8 and 16 bits and odd
    widths: the port's decoder and Pillow give the image back."""
    rng = np.random.default_rng(len(filters) + dtype().itemsize)
    for shape in [(7, 13), (1, 1), (5, 1), (12, 31)]:
        img = _image(rng, shape, dtype)
        H = shape[0]
        f = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
        ftypes = [r % 5 for r in range(H)] if filters == "mixed" else [f[filters]] * H
        raw = img.astype(">u2").view(np.uint8).reshape(H, -1) if dtype == np.uint16 else img
        data = _png_bytes(shape[1], H, 8 * img.itemsize, 0,
                          _filter_rows(raw, ftypes, img.itemsize))
        got = png.decode_png(data)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_and_pgm_round_trip(dtype, tmp_path):
    """The port's encoder read back by itself and by Pillow, exactly; files
    that Pillow writes read by the port; `decode_image` as the JAX package's
    on both formats."""
    rng = np.random.default_rng(7)
    for shape in [(48, 63), (1, 5), (240, 321)]:
        img = _image(rng, shape, dtype)
        data = png.encode_png(img)
        np.testing.assert_array_equal(png.decode_png(data), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="PNG")
        np.testing.assert_array_equal(png.decode_png(buf.getvalue()), img)
        for ext in ("png", "pgm"):
            path = str(tmp_path / f"im.{ext}")
            png.write(path, img)
            np.testing.assert_array_equal(png.read(path), img)
            np.testing.assert_array_equal(png.decode_image(path), jdecode_image(path))
        np.testing.assert_array_equal(np.asarray(Image.open(str(tmp_path / "im.pgm"))), img)


def test_png_rejects_what_it_does_not_handle():
    row = b"\x00" + bytes(4)
    for W, depth, colour, interlace, body in [(4, 8, 2, 0, row * 2), (4, 1, 0, 0, row),
                                              (4, 8, 0, 1, row), (4, 8, 0, 0, b"\x05" + bytes(4))]:
        with pytest.raises(ValueError):
            png.decode_png(_png_bytes(W, 1, depth, colour, body, interlace))
    with pytest.raises(ValueError):
        png.decode_png(b"not a png")
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2, 3), np.uint8))


# ---------------------------------------------------------------- YAML

# the EuRoC okvis2.yaml, with the values tests/test_io.py asserts, plus the
# optional sections
EUROC_YAML = """%YAML:1.0
cameras:
     - {T_SC:
        [ 0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
          0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
         -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
          0.0, 0.0, 0.0, 1.0],
        image_dimension: [752, 480],
        distortion_coefficients: [-0.2834085106798416, 0.07395907389290132,
                                  0.00019359502856909603, 1.7618711454538528e-05],
        distortion_type: radialtangential,
        focal_length: [458.654880721, 457.296696463],
        principal_point: [367.215803962, 248.37534061],
        camera_type: gray, #gray, rgb, gray+depth, rgb+depth
        slam_use: okvis} #none, okvis, okvis-depth, okvis-virtual
     - {T_SC:
        [ 0.0125552670891, -0.999755099723, 0.0182237714554, 0.0198435579556,
          0.999598781151, 0.0130119051815, 0.0251588363115, -0.0645148332891,
         -0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038,
          0.0, 0.0, 0.0, 1.0],
        image_dimension: [752, 480],
        distortion_coefficients: [-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05],
        distortion_type: radialtangential,
        focal_length: [457.587426604, 456.134967266],
        principal_point: [379.999066145, 255.238186756],
        camera_type: gray,
        slam_use: okvis}

# additional camera parameters
camera_parameters:
    timestamp_tolerance: 0.005 # [s] stereo frame out-of-sync tolerance
    sync_cameras: [0, 1]
    image_delay: 0.0 # [s] timestamp_camera_correct = timestamp_camera - image_delay
    online_calibration:
        do_extrinsics: false
        do_extrinsics_final_ba: false
        sigma_r: 0.001 # T_SCi position prior stdev [m]
        sigma_alpha: 0.005 # T_SCi orientation prior stdev [rad]

imu_parameters:
    use: true
    a_max: 160.0 # acceleration saturation [m/s^2]
    g_max: 10.0 # gyro saturation [rad/s]
    sigma_g_c: 20.0e-4 # gyro noise density [rad/s/sqrt(Hz)]
    sigma_bg: 0.03 # gyro bias prior [rad/s]
    sigma_a_c: 8.0e-3 # accelerometer noise density [m/s^2/sqrt(Hz)]
    sigma_ba: 0.1 # accelerometer bias prior [m/s^2]
    sigma_gw_c: 4.0e-6 # gyro drift noise density [rad/s^s/sqrt(Hz)]
    sigma_aw_c: 4.0e-5 # accelerometer drift noise density [m/s^2/sqrt(Hz)]
    g: 9.81007 # Earth's acceleration due to gravity [m/s^2]
    g0: [ 0.0, 0.0, 0.0 ] # initial gyro bias [rad/s]
    a0: [ -0.05, 0.09, 0.01 ] # initial accelerometer bias [m/s^2]
    s_a: [ 1.0, 1.0, 1.0 ]
    # transform Body-Sensor (IMU)
    T_BS:
        [1.0000, 0.0000, 0.0000, 0.0000,
         0.0000, 1.0000, 0.0000, 0.0000,
         0.0000, 0.0000, 1.0000, 0.0000,
         0.0000, 0.0000, 0.0000, 1.0000]

# frontend: detection etc.
frontend_parameters:
    detection_threshold: 42.0
    absolute_threshold: 20.0
    matching_threshold: 60.0
    octaves: 0
    max_num_keypoints: 700
    keyframe_overlap: 0.59
    use_cnn: yes
    parallelise_detection: on
    num_matching_threads: 4

# estimator parameters
estimator_parameters:
    num_keyframes: 5
    num_loop_closure_frames: 5
    num_imu_frames: 3
    do_loop_closures: true
    do_final_ba: true
    enforce_realtime: false
    realtime_min_iterations: 3
    realtime_max_iterations: 10
    realtime_time_limit: 0.035
    realtime_num_threads: 2
    full_graph_iterations: 15
    full_graph_num_threads: 2
    p_dbow: 0.4
    drift_percentage_heuristic: 1.35

output_parameters:
    display_matches: true
    display_overhead: Off
    display_topview: 'true'
    enable_submapping: false

gps_parameters:
    data_type: "geodetic"
    r_SA: [ 0.1, -0.02, 0.3 ]
    yaw_error_threshold: 2.0
    robust_gps_init: true

lidar:
    T_SL:
        [ 0.0, -1.0, 0.0, 0.01,
          1.0, 0.0, 0.0, -0.02,
          0.0, 0.0, 1.0, 0.1,
          0.0, 0.0, 0.0, 1.0 ]
    elevation_resolution_angle: 0.35
    azimuth_resolution_angle: 0.18
"""

# every scalar form of the subset, and nesting
FORMS_YAML = """---
ints: [0, -3, +12, 1_000, 0x1F, 017, 0b101, 190:20:30, -0]
floats: [1.5, -2.0e-3, .5, 1., 6.8523015e+5, 685_230.15, 190:20:30.15, .inf, -.Inf, .NaN]
strings: [1e-3, abc, "quoted # not a comment", 'it''s', "esc\\t\\u00e9", 12abc, ""]
bools: {a: yes, b: No, c: ON, d: off, e: True, f: FALSE}
nulls: {a: ~, b: null, c: , d: Null}
plain: a value, with a comma, -dash and http://x.y/z
apostrophe: it's plain
empty:
seq_under_key:
- one
- {k: v}
- - nested
  - block
- key: value
  other: [1,
          2]
deep:
    level:
        - a: 1
          b:
              c: [x, {y: z}]
"1": quoted key
2: int key
"""

UNSUPPORTED = ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x",
               "a: 1\n---\nb: 2", "a: 1\n...", "? a\n: b", "a: b\n  c", "a: 2001-12-14",
               "a: 'x\n  y'", "a: [1, 2", "a:\n\t- 1", "a: b: c", "[a]: 1", "a: @x",
               "a: [a: 1]", "%TAG ! x\na: 1"]


def _same(a, b):
    """Equal values of equal types (NaN equal to NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("text", [EUROC_YAML, FORMS_YAML, "[1, {a: b}]", "just a string", ""],
                         ids=["euroc", "forms", "flow_root", "scalar_root", "empty"])
def test_yaml_reader_matches_pyyaml(text):
    ref = yaml.safe_load("\n".join(l for l in text.splitlines() if not l.startswith("%YAML")))
    got = yaml_subset.loads(text)
    assert _same(got, ref), (got, ref)


@pytest.mark.parametrize("text", UNSUPPORTED)
def test_yaml_reader_rejects_unsupported(text):
    with pytest.raises(ValueError, match="line"):
        yaml_subset.loads(text)


# ---------------------------------------------------------------- config

def _assert_same_fields(a, b, path="cfg"):
    """Port dataclasses, cameras, arrays and scalars: every field equal."""
    if isinstance(a, pinhole.Camera):
        assert (a.width, a.height, a.model) == (b.width, b.height, b.model), path
        for k in ("fxfycxcy", "dist_params"):
            ta, tb = getattr(a, k), getattr(b, k)
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), f"{path}.{k}"
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same_fields(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)) and not isinstance(a, preintegration.ImuParams):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_fields(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_config_load_matches_jax(tmp_path):
    """Every field of `load` as the JAX package's, floats exact; the values
    tests/test_io.py asserts on the reference's EuRoC file."""
    path = str(tmp_path / "okvis2.yaml")
    with open(path, "w") as f:
        f.write(EUROC_YAML)
    got = config.load(path)
    _assert_same_fields(got, convert.vi_config(jconfig.load(path)))
    cam = got.cameras[0].camera
    assert (cam.width, cam.height, cam.model) == (752, 480, "radtan")
    assert got.imu.sigma_g == 20.0e-4 and got.estimator.num_keyframes == 5
    assert got.frontend.use_cnn is True and got.output.display_topview is True
    assert got.gps.data_type == "geodetic" and got.lidar.T_SL.shape == (7,)
    np.testing.assert_array_equal(got.cameras[0].T_SC[:3],
                                  [-0.0216401454975, -0.064676986768, 0.00981073058949])


def test_submap_config_matches_jax(tmp_path):
    path = str(tmp_path / "se2.yaml")
    with open(path, "w") as f:
        f.write("%YAML:1.0\ngeneral:\n  submap_kf_threshold: 20\n  submap_overlap_ratio: 0.1\n"
                "  submap_min_frames: 40\n  n_factors_per_state: 200\n  sensor_error: 0.4\n"
                "  use_map_to_map_factors: true\n  use_map_to_live_factors: true\n"
                "  near_plane: 0.4\nmap:\n  dim: [25.6, 25.6, 25.6]\n  res: 0.025\n"
                "data:\n  log_odd_max: 5.015\n  uncertainty_model: quadratic\n")
    got, ref = config.load_submap_config(path), jconfig.load_submap_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.map_dim == (25.6, 25.6, 25.6) and got.submap_min_frames == 40


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def jax_dataset(tmp_path_factory):
    """A dataset written by the JAX package's generator, with every stream."""
    out = str(tmp_path_factory.mktemp("jds") / "synth")
    jsyn.generate(out, duration=1.2, frame_rate=20.0, width=96, height=64, with_gps=True,
                  with_lidar=True, with_depth=True)
    return out


def _events(ds):
    out = []
    for kind, ev in ds.events():
        if kind == "frames":
            out.append((kind, ev.t, tuple(ev.paths)))
        elif kind == "lidar":
            out.append((kind, ev.t, ev.t_point.tobytes(), ev.pts.tobytes(),
                        ev.intensity.tobytes()))
        elif kind == "depth":
            out.append((kind, ev[0], ev[1]))
        else:
            out.append((kind, float(ev[0]), *(np.asarray(x).tobytes() for x in ev[1:])))
    return out


def test_euroc_reader_matches_jax(jax_dataset):
    got, ref = euroc.EurocDataset(jax_dataset), jeuroc.EurocDataset(jax_dataset)
    assert got.t0_ns == ref.t0_ns
    for k in ("t", "gyr", "acc"):
        np.testing.assert_array_equal(getattr(got.imu, k), getattr(ref.imu, k))
    assert [(f.t, f.paths) for f in got.frames] == [(f.t, f.paths) for f in ref.frames]
    np.testing.assert_array_equal(got.ground_truth, ref.ground_truth)
    assert _events(got) == _events(ref)
    for fr in ref.frames:
        for p in fr.paths:
            a, b = got.load_image(p), ref.load_image(p)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_imu_stamp_quantisation_is_kept(jax_dataset):
    """C-R9: the IMU column goes through float64 (256 ns steps at 1.4e18 ns),
    frame stamps stay integers: an IMU sample written at a frame's stamp
    comes after that frame in `events()`, in both packages alike."""
    for mod in (euroc, jeuroc):
        ds = mod.EurocDataset(jax_dataset)
        imu_ns = np.loadtxt(os.path.join(ds.root, "imu0", "data.csv"), delimiter=",",
                            skiprows=1, usecols=0, dtype=np.int64)
        frame_ns = {int(os.path.basename(f.paths[0])[:-4]) for f in ds.frames}
        late, seen = [], set()
        for kind, ev in ds.events():
            if kind == "frames":
                seen.add(int(os.path.basename(ev.paths[0])[:-4]))
            else:
                i = int(np.searchsorted(ds.imu.t, ev[0]))
                if imu_ns[i] in frame_ns and imu_ns[i] in seen:
                    late.append(imu_ns[i])
        assert late, mod.__name__
        err = np.abs((imu_ns - ds.t0_ns) * 1e-9 - ds.imu.t).max()
        assert 1e-8 < err < 2e-7, err


def test_generate_writes_what_jax_writes(jax_dataset, tmp_path):
    """The port's generator writes the JAX package's CSVs byte for byte and
    images that decode to the same pixels (depth maps included)."""
    out = str(tmp_path / "synth")
    cam, T_SC, gt = synthetic.generate(out, duration=1.2, frame_rate=20.0, width=96, height=64,
                                       with_gps=True, with_lidar=True, with_depth=True)
    jcam, jT_SC, jgt = jsyn.generate(str(tmp_path / "j"), duration=1.2, frame_rate=20.0,
                                     width=96, height=64)
    np.testing.assert_array_equal(T_SC, jT_SC)
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(cam.fxfycxcy.numpy(), np.asarray(jcam.fxfycxcy))
    np.testing.assert_array_equal(cam.dist_params.numpy(), np.asarray(jcam.dist_params))
    for sub in ("imu0", "cam0", "cam1", "depth0", "state_groundtruth_estimate0", "gps0",
                "lidar0"):
        a, b = os.path.join(out, "mav0", sub, "data.csv"), os.path.join(
            jax_dataset, "mav0", sub, "data.csv")
        assert filecmp.cmp(a, b, shallow=False), sub
    for sub in ("cam0", "cam1", "depth0"):
        names = sorted(os.listdir(os.path.join(jax_dataset, "mav0", sub, "data")))
        assert names == sorted(os.listdir(os.path.join(out, "mav0", sub, "data")))
        for n in names:
            a = png.read(os.path.join(out, "mav0", sub, "data", n))
            b = np.asarray(Image.open(os.path.join(jax_dataset, "mav0", sub, "data", n)))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    seq = synthetic.render_sequence(duration=1.2, frame_rate=20.0, width=96, height=64)
    ds = euroc.EurocDataset(out)
    for k, fr in enumerate(ds.frames):
        for c in range(2):
            np.testing.assert_array_equal(png.read(fr.paths[c]), seq.images[k, c])


@pytest.mark.parametrize("kw", [dict(world="textured"), dict(with_classmap=True)])
def test_generate_refuses_unported_worlds(kw, tmp_path):
    with pytest.raises(NotImplementedError, match="A5"):
        synthetic.generate(str(tmp_path / "x"), duration=0.5, width=32, height=24, **kw)


@pytest.mark.parametrize("gps_type", ["cartesian", "geodetic"])
def test_xdataset_matches_jax(jax_dataset, gps_type, tmp_path):
    root = jax_dataset
    if gps_type == "geodetic":  # rewrite the fixes as WGS84 degrees
        root = str(tmp_path / "geo")
        os.makedirs(os.path.join(root, "mav0", "gps0"))
        for sub in ("imu0", "cam0", "cam1", "depth0", "lidar0", "state_groundtruth_estimate0"):
            os.symlink(os.path.join(jax_dataset, "mav0", sub), os.path.join(root, "mav0", sub))
        rng = np.random.default_rng(3)
        with open(os.path.join(root, "mav0", "gps0", "data_raw.csv"), "w") as f:
            f.write("#t,lat,lon,alt,hErr,vErr\n")
            for i in range(6):
                t = 1_400_000_000_000_000_000 + 18_000_000_000 + i * 200_000_000
                f.write(f"{t},{47.37 + rng.normal(0, 1e-4)},{8.54 + rng.normal(0, 1e-4)},"
                        f"{408 + rng.normal()},0.02,0.04\n")
    got = xdataset.XDataset(root, gps_type=gps_type)
    ref = jx.XDataset(root, gps_type=gps_type)
    assert got.depth_frames == ref.depth_frames
    np.testing.assert_array_equal(got.lidar, ref.lidar)
    np.testing.assert_allclose(got.gps, ref.gps, rtol=0, atol=TOL)
    assert _events(got) == _events(ref)
    for _, p in ref.depth_frames[:3]:
        np.testing.assert_array_equal(got.load_depth(p), ref.load_depth(p))
    enu = [(xdataset.geodetic_to_enu(*a), jx.geodetic_to_enu(*a))
           for a in [(0.8268, 0.1491, 410.0, 0.8267, 0.1490, 400.0)]]
    for a, b in enu:
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _png_file(path, rng, w=16, h=12):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((rng.random((h, w)) * 255).astype(np.uint8)).save(path)


def test_leica_reader_matches_jax(tmp_path):
    """The layout of tests/test_readers.py, with a cartesian and then a
    geodetic GNSS stream."""
    rng = np.random.default_rng(0)
    root = str(tmp_path / "leica")
    os.makedirs(root)
    t0 = 1_500_000_000_000_000_000
    with open(os.path.join(root, "imu_bottom.csv"), "w") as f:
        f.write("#t,wx,wy,wz,ax,ay,az\n")
        for i in range(50):
            f.write(f"{t0 + i * 5_000_000},{rng.normal()},0,0.1,0,0,9.81\n")
    with open(os.path.join(root, "lidar.csv"), "w") as f:
        f.write("#t,x,y,z,intensity\n")
        for i in range(300):
            f.write(f"{t0 + i * 1_000_000},{1 + i * 0.01},0.5,2.0,100\n")
    for i in range(3):
        t = t0 + i * 100_000_000
        _png_file(os.path.join(root, "pinhole", f"bottom_{t}.png"), rng)
        _png_file(os.path.join(root, "pinhole", f"front_{t + 1_000_000}.png"), rng)
    with open(os.path.join(root, "gnss.csv"), "w") as f:
        f.write("#t,lat,lon,alt,hErr,vErr\n")
        for i in range(5):
            f.write(f"{t0 + i * 200_000_000},47.37{i},8.54,408.0,0.02,0.04\n")
    for step in ("geodetic", "cartesian"):
        if step == "cartesian":
            os.makedirs(os.path.join(root, "gps0"))
            with open(os.path.join(root, "gps0", "data.csv"), "w") as f:
                f.write("#t,x,y,z,sx,sy,sz\n")
                for i in range(4):
                    f.write(f"{t0 + i * 250_000_000},{i * 0.3},{rng.normal()},1.0,0.1,0.1,0.2\n")
        kw = dict(cameras=["bottom", "front"], sweep_dt=0.1)
        got, ref = leica.LeicaDataset(root, **kw), jleica.LeicaDataset(root, **kw)
        assert len(got.frames) == 3 and len(got.sweeps) == 3
        assert _events(got) == _events(ref)
        for (ta, pa, ea), (tb, pb, eb) in zip(got.gps, ref.gps):
            assert ta == tb
            np.testing.assert_allclose(pa, pb, rtol=0, atol=TOL)
            np.testing.assert_array_equal(ea, eb)
        p = ref.frames[0].paths[0]
        np.testing.assert_array_equal(got.load_image(p), ref.load_image(p))


def test_rpg_reader_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    root = str(tmp_path / "rpg")
    os.makedirs(os.path.join(root, "imu0"))
    t0 = 1_500_000_000_000_000_000
    with open(os.path.join(root, "imu0", "data.csv"), "w") as f:
        f.write("#t,w,a\n")
        for i in range(40):
            f.write(f"{t0 + i * 5_000_000},{rng.normal()},0,0,0,0,9.81\n")
    for side in ("left", "right"):
        with open(os.path.join(root, f"{side}_images.txt"), "w") as f:
            f.write("# id timestamp image_name\n")
            for i in range(4):
                rel = f"img/{side}_{i}.png"
                _png_file(os.path.join(root, rel), rng)
                f.write(f"{i} {1.5e9 + i * 0.1:.6f} {rel}\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# id t px py pz qx qy qz qw\n")
        for i in range(4):
            f.write(f"{i} {i * 0.1:.6f} {i * 0.5} 0 0 0 0 0 1\n")
    got, ref = rpg.RpgDataset(root), jrpg.RpgDataset(root)
    assert got.num_cams == ref.num_cams == 2
    np.testing.assert_array_equal(got.ground_truth, ref.ground_truth)
    assert _events(got) == _events(ref)
    p = ref.frames[1].paths[1]
    np.testing.assert_array_equal(got.load_image(p), ref.load_image(p))


def test_dataset_writer_matches_jax(tmp_path):
    """The same streams through both writers: CSVs identical, images and
    depth maps decode equal."""
    dirs = []
    for cls, name in ((DatasetWriter, "port"), (JDatasetWriter, "jax")):
        r = np.random.default_rng(4)
        w = cls(str(tmp_path / name))
        for k in range(3):
            t = 0.1 * k
            w.add_imu(t, r.normal(size=3), r.normal(size=3))
            w.add_images(t, [r.random((24, 33)).astype(np.float32), r.random((24, 33))])
            w.add_depth(t, r.random((24, 33)) * 5.0)
            w.add_lidar_points(t + np.arange(4) * 1e-3, r.normal(size=(4, 3)))
            w.add_gps(t, r.normal(size=3), np.full(3, 0.05))
        w.close()
        dirs.append(os.path.join(str(tmp_path / name), "mav0"))
    for sub in ("imu0", "cam0", "cam1", "depth0", "lidar0", "gps0"):
        assert filecmp.cmp(os.path.join(dirs[0], sub, "data.csv"),
                           os.path.join(dirs[1], sub, "data.csv"), shallow=False), sub
    for sub in ("cam0", "cam1", "depth0"):
        for n in os.listdir(os.path.join(dirs[1], sub, "data")):
            a = png.read(os.path.join(dirs[0], sub, "data", n))
            b = np.asarray(Image.open(os.path.join(dirs[1], sub, "data", n)))
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- debug CSVs

def test_debug_csv_files_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    lids = rng.integers(-1, 50, 30)
    uv = rng.random((30, 2)) * 300
    desc = rng.integers(0, 2**32, (30, 12), dtype=np.uint64).astype(np.uint32)
    res, occ, grad = rng.normal(size=40), rng.normal(size=40), np.abs(rng.normal(size=40))
    occ[:5] = 0
    gyr, acc = rng.normal(size=(3, 3)), rng.normal(size=(3, 3)).tolist()
    for mod, name in ((debug_csv, "port"), (jdebug, "jax")):
        d = tmp_path / name
        d.mkdir()
        imu = mod.ImuCsvWriter(str(d / "imu.csv"))
        tracks = mod.TracksCsvWriter(str(d / "tracks.csv"))
        gps = mod.GpsResidualCsvWriter(str(d / "gps.csv"))
        for k in range(3):
            imu.add(0.005 * k, gyr[k], acc[k])
            tracks.add_frame(0.1 * k, lids, uv, np.full(30, 1.0), desc)
            tracks.add_frame(0.1 * k + 0.05, lids, uv, np.float64(0.8))
            gps.add(0.2 * k, k, res[:3], 1.5)
        for w in (imu, tracks, gps):
            w.close()
        infos = [mod.LidarDebugInfo.from_arrays(3, 1, res, occ, grad),
                 mod.LidarDebugInfo.from_arrays(4, 1, res[:0], occ[:0], grad[:0])]
        mod.write_lidar_debug_csv(str(d / "run"), infos)
    for f in ("imu.csv", "tracks.csv", "gps.csv", "run-lidar-info.csv"):
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f, shallow=False), f


# ---------------------------------------------------------------- api types

def _state(mod, rng, sid, t):
    q = rng.normal(size=4)
    return mod.State(id=sid, timestamp=t, T_WS=np.concatenate([rng.normal(size=3),
                                                              q / np.linalg.norm(q)]),
                     v_W=rng.normal(size=3), b_g=rng.normal(0, 0.01, 3),
                     b_a=rng.normal(0, 0.05, 3), omega_S=rng.normal(0, 0.3, 3),
                     is_keyframe=bool(sid % 2))


def test_trajectory_matches_jax():
    """`get_state` and `propagate_batch` through the raw IMU buffer, state
    replacement by id and `clear_imu_before`, against JAX at 1e-12."""
    trajs = []
    for mod, params in ((api, convert.imu_params(jpre.ImuParams())), (japi, jpre.ImuParams())):
        rng = np.random.default_rng(6)
        tr = mod.Trajectory(params)
        for i in range(200):
            tr.add_imu_measurement(0.005 * i, rng.normal(0, 0.2, 3),
                                   rng.normal([0, 0, 9.81], 0.3, 3))
        for sid, t in enumerate([0.1, 0.3, 0.55, 0.8]):
            tr.update(_state(mod, rng, sid, t))
        tr.update(_state(mod, rng, 2, 0.55))  # an updated state replaces by id
        trajs.append(tr)
    got, ref = trajs
    assert got.state_ids() == ref.state_ids()
    times = np.random.default_rng(8).uniform(0.0, 1.1, 40)
    for t in [*times, 0.3, 0.05]:
        a, b = got.get_state(t), ref.get_state(t)
        assert (a.id, a.timestamp, a.is_keyframe) == (b.id, b.timestamp, b.is_keyframe)
        for k in ("T_WS", "v_W", "omega_S"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.propagate_batch(times), ref.propagate_batch(times),
                               rtol=0, atol=TOL)
    got.clear_imu_before(0.5)
    ref.clear_imu_before(0.5)
    assert got._imu_t == ref._imu_t
    np.testing.assert_allclose(got.get_state(0.9).T_WS, ref.get_state(0.9).T_WS, rtol=0,
                               atol=TOL)
    assert api.Trajectory().get_state(0.0) is None


def test_propagators_match_jax():
    rng = np.random.default_rng(9)
    base = _state(api, rng, 0, 1.0)
    jbase = japi.State(**dataclasses.asdict(base))
    for t in (1.0, 1.25, 3.0):
        a = api.ConstantVelocityPropagator(base).propagate(t)
        b = japi.ConstantVelocityPropagator(jbase).propagate(t)
        np.testing.assert_allclose(a.T_WS, b.T_WS, rtol=0, atol=TOL)
        assert a.timestamp == b.timestamp
    qs = [api.QueuedTrajectory(max_samples=6), japi.QueuedTrajectory(max_samples=6)]
    for i in rng.permutation(8):
        T = _state(api, rng, 0, 0.0).T_WS
        for q in qs:
            q.push(0.1 * i, T)
    for t in (-0.1, 0.2, 0.25, 0.33, 0.7, 0.71, 0.9):
        a, b = (q.get(t) for q in qs)
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


# ---------------------------------------------------------------- IMU, rig

def _preintegrated(rng):
    n = 41
    t = np.arange(n) * 0.005
    gyr, acc = rng.normal(0, 0.3, (n, 3)), rng.normal([0, 0, 9.81], 0.5, (n, 3))
    bg, ba = rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)
    batch = jpre.ImuBatch(t=jnp.asarray(t), gyr=jnp.asarray(gyr), acc=jnp.asarray(acc),
                          mask=jnp.ones(n, bool))
    return jpre.preintegrate(jpre.ImuParams(), batch, jnp.asarray(0.01), jnp.asarray(0.19),
                             jnp.asarray(bg), jnp.asarray(ba))


def _numpy_leaves(nt):
    return type(nt)(*[np.asarray(x) for x in nt])


def _pose(rng):
    q = rng.normal(size=4)
    return np.concatenate([rng.normal(size=3), q / np.linalg.norm(q)])


def test_propagate_state_matches_jax():
    rng = np.random.default_rng(10)
    jp = _preintegrated(rng)
    tp = convert.preintegrated(_numpy_leaves(jp))
    for _ in range(3):
        T0, v0 = _pose(rng), rng.normal(size=3)
        bg, ba = np.asarray(jp.lin_bg) + rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)
        ref = jpre.propagate_state(jpre.ImuParams(), jp, jnp.asarray(T0), jnp.asarray(v0),
                                   jnp.asarray(bg), jnp.asarray(ba))
        got = preintegration.propagate_state(
            convert.imu_params(jpre.ImuParams()), tp, *(torch.as_tensor(x) for x in
                                                        (T0, v0, bg, ba)))
        for g, r in zip(got, ref):
            assert g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=TOL)


def test_pseudo_residual_matches_jax():
    rng = np.random.default_rng(11)
    for dt in (0.05, 0.0005):
        T0, T1 = _pose(rng), _pose(rng)
        sb0, sb1 = rng.normal(size=9), rng.normal(size=9)
        ref = jimu_factor.pseudo_residual(0.5, 0.1, dt, *(jnp.asarray(x) for x in
                                                         (T0, sb0, T1, sb1)))
        got = imu_factor.pseudo_residual(0.5, 0.1, dt, *(torch.as_tensor(x) for x in
                                                        (T0, sb0, T1, sb1)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_ncamera_matches_jax():
    """Projection through the rig and the overlap flags, against JAX at
    1e-12: a stereo pair and a camera looking away."""
    rng = np.random.default_rng(12)
    specs = [(280.0, 281.0, 160.0, 120.0, 320, 240, "radtan", [-0.25, 0.06, 1e-4, -1e-4]),
             (300.0, 300.0, 170.0, 118.0, 340, 236, "equidistant", [0.01, -0.002, 1e-3, 0]),
             (250.0, 250.0, 160.0, 120.0, 320, 240, "none", [])]
    T_SC = [np.array([-0.055, 0, 0, 0, 0, 0, 1.0]), np.array([0.055, 0, 0.01, 0, 0, 0, 1.0]),
            np.array([0, 0.1, 0, 1.0, 0, 0, 0])]
    jrig = jncam.make_rig([jpin.make_pinhole(*s[:6], model=s[6], dist_params=s[7])
                           for s in specs], [jnp.asarray(T) for T in T_SC])
    trig = ncamera.make_rig([pinhole.make_pinhole(*s[:6], model=s[6], dist_params=s[7])
                             for s in specs], [torch.as_tensor(T) for T in T_SC])
    assert trig.num_cameras == jrig.num_cameras == 3
    assert ncamera.overlap_masks(trig) == jncam.overlap_masks(jrig)
    T_WS = _pose(rng)
    hp = np.concatenate([rng.normal([0, 0, 0], 2.0, (64, 3)), rng.uniform(0.2, 1.0, (64, 1))], 1)
    for c in range(3):
        uv_j, ok_j = jncam.project_world_point(jrig, c, jnp.asarray(T_WS), jnp.asarray(hp))
        uv_t, ok_t = ncamera.project_world_point(trig, c, torch.as_tensor(T_WS),
                                                 torch.as_tensor(hp))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        ok = np.asarray(ok_j)
        np.testing.assert_allclose(uv_t.numpy()[ok], np.asarray(uv_j)[ok], rtol=0, atol=TOL)
