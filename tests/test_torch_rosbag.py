"""The port's bag modules (`okvis2x_tpu_torch/io/rosbag1.py`, `rosbag2.py`,
`bag_convert.py`) against the JAX package's: bags written by each package
and read by the other, the messages decoded to equal arrays; equal ROS1 file
bytes and equal ROS2 CDR payloads for the same messages; bz2 chunks;
`to_mono8` on every encoding both decode; NavSatFix round trips; and
`convert_bag` with the HILTI and VBR presets (and a GNSS topic) on the bags of
tests/test_rosbag.py, the CSVs equal byte for byte and the PNGs as decoded
pixels (the JAX package writes them through Pillow, the port through
`io/png.py`).  All comparisons are exact."""

import bz2
import os
import sqlite3
import struct

import numpy as np
import pytest

from okvis2x_tpu.io import bag_convert as jconv
from okvis2x_tpu.io import rosbag1 as j1
from okvis2x_tpu.io import rosbag2 as j2
from okvis2x_tpu_torch.io import bag_convert as tconv
from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.io import rosbag1 as t1
from okvis2x_tpu_torch.io import rosbag2 as t2

ROS1 = {"jax": j1, "port": t1}
ROS2 = {"jax": j2, "port": t2}
CONV = {"jax": jconv, "port": tconv}
IMAGES = [("mono8", np.uint8, ()), ("mono16", np.uint16, ()), ("rgb8", np.uint8, (3,)),
          ("bgr8", np.uint8, (3,)), ("rgba8", np.uint8, (4,)), ("bgra8", np.uint8, (4,))]


def image(rng, dtype, extra, h=12, w=17):
    hi = 65535 if dtype == np.uint16 else 255
    return rng.integers(0, hi, (h, w, *extra), endpoint=True).astype(dtype)


def ouster_cloud(t0, mod):
    """tests/test_rosbag.py's Ouster layout: x,y,z f32; intensity f32 @16;
    t u32 ns @20; ring u8 @26; stride 32; point 3 all zero."""
    fields = [mod.PointField("x", 0, 7, 1), mod.PointField("y", 4, 7, 1),
              mod.PointField("z", 8, 7, 1), mod.PointField("intensity", 16, 7, 1),
              mod.PointField("t", 20, 6, 1), mod.PointField("ring", 26, 2, 1)]
    n = 8
    buf = bytearray(32 * n)
    for i in range(n):
        x = 0.0 if i == 3 else 1.0 + i
        struct.pack_into("<fff", buf, 32 * i, x, 0.0 if i == 3 else 2.0, 0.0 if i == 3 else 3.0)
        struct.pack_into("<f", buf, 32 * i + 16, 10.0 * i)
        struct.pack_into("<I", buf, 32 * i + 20, 1000 * i)
        struct.pack_into("<B", buf, 32 * i + 26, i % 4)
    return fields, bytes(buf), n


def hesai_cloud(t0, n, rng, mod):
    """tests/test_rosbag.py's Hilti Hesai layout: x,y,z f32; intensity f32
    @16; absolute f64 seconds @24; ring u16 @32; stride 48."""
    fields = [mod.PointField("x", 0, 7, 1), mod.PointField("y", 4, 7, 1),
              mod.PointField("z", 8, 7, 1), mod.PointField("intensity", 16, 7, 1),
              mod.PointField("timestamp", 24, 8, 1), mod.PointField("ring", 32, 4, 1)]
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    buf = bytearray(48 * n)
    for i in range(n):
        struct.pack_into("<fff", buf, 48 * i, xyz[i, 0], xyz[i, 1], xyz[i, 2])
        struct.pack_into("<f", buf, 48 * i + 16, float(i))
        struct.pack_into("<d", buf, 48 * i + 24, t0 * 1e-9 + i * 1e-6)
        struct.pack_into("<H", buf, 48 * i + 32, i % 32)
    return fields, bytes(buf)


def navsatfix_ros1(t_ns, lat, lon, alt, cov):
    secs, nsecs = divmod(t_ns, 1_000_000_000)
    body = struct.pack("<III", 0, secs, nsecs) + struct.pack("<I", 3) + b"gps"
    body += struct.pack("<bH", 1, 1) + struct.pack("<3d", lat, lon, alt)
    body += struct.pack("<9d", *cov) + struct.pack("<B", 2)
    return body


def navsatfix_ros2(t_ns, lat, lon, alt, cov):
    w = t2._CdrWriter()
    w.header(t_ns, "gps")
    w.i8(1)
    w.u16(1)
    for v in (lat, lon, alt):
        w.f64(v)
    w.f64s(cov)
    w.u8(2)
    return w.bytes()


def messages(mod, ros2):
    """A seeded stream of every message family through `mod`'s encoders:
    (topic, type, t_ns, raw)."""
    rng = np.random.default_rng(7)
    pre = "sensor_msgs/msg/" if ros2 else "sensor_msgs/"
    out = []
    for k in range(3):
        t = 1_000_000_007 + 50_000_000 * k
        for enc, dtype, extra in IMAGES:
            out.append((f"/cam_{enc}", pre + "Image", t,
                        mod.encode_image(t, image(rng, dtype, extra), encoding=enc)))
        for j in range(4):
            ti = t + 5_000_000 * j
            out.append(("/imu0", pre + "Imu", ti,
                        mod.encode_imu(ti, rng.normal(size=3), rng.normal(size=3) + 9.81)))
        fields, blob = hesai_cloud(t, 6, rng, mod)
        out.append(("/points", pre + "PointCloud2", t,
                    mod.encode_pointcloud2(t, fields, 48, blob, 6)))
        fix = (navsatfix_ros2 if ros2 else navsatfix_ros1)(
            t, 48.1 + 1e-5 * k, 11.6, 520.0 + k, rng.uniform(0.1, 2.0, 9))
        out.append(("/gps", pre + "NavSatFix", t, fix))
    return out


def write(path, writer, msgs):
    with writer(path) as bag:
        for m in msgs:
            bag.write(*m)


def decoded(codec, msg):
    """A message's decoded fields as plain values and arrays."""
    kind = msg.msgtype.rsplit("/", 1)[1]
    if kind == "Image":
        m = codec.decode_image(msg.raw)
        return (m.t_ns, m.height, m.width, m.encoding, m.data, codec.to_mono8(m))
    if kind == "Imu":
        m = codec.decode_imu(msg.raw)
        return (m.t_ns, m.gyr, m.acc)
    if kind == "PointCloud2":
        m = codec.decode_pointcloud2(msg.raw)
        return (m.t_ns, m.height, m.width, [(f.name, f.offset, f.datatype, f.count)
                                             for f in m.fields], m.point_step, m.data,
                *m.arrays().values())
    m = codec.decode_navsatfix(msg.raw)
    return (m.t_ns, m.status, m.latitude, m.longitude, m.altitude, m.position_covariance)


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_rosbag1_writers_give_equal_bytes(tmp_path):
    """The same messages give the same encodings and the same bag file, byte
    for byte (header field order, the chunk, the connection records)."""
    ja, ta = messages(j1, False), messages(t1, False)
    assert [m[3] for m in ja] == [m[3] for m in ta]
    paths = {k: str(tmp_path / f"{k}.bag") for k in ROS1}
    for k, mod in ROS1.items():
        write(paths[k], mod.Rosbag1Writer, ta)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_rosbag1_exchanged(tmp_path, writer, reader):
    """A bag written by one package and read by both: the same records, and
    every message decoded by the reader's package equal to its decoding by
    the writer's."""
    msgs = messages(ROS1[writer], False)
    path = str(tmp_path / "x.bag")
    write(path, ROS1[writer].Rosbag1Writer, msgs)
    got = {k: list(mod.Rosbag1Reader(path).messages()) for k, mod in ROS1.items()}
    for k in ROS1:
        assert [(m.topic, m.msgtype, m.t_ns, m.raw) for m in got[k]] == msgs
    for a, b in zip(got[writer], got[reader]):
        assert_same(decoded(ROS1[writer], a), decoded(ROS1[reader], b))
    only = list(ROS1[reader].Rosbag1Reader(path).messages(topics=["/gps"]))
    assert [m.topic for m in only] == ["/gps"] * 3


def test_rosbag1_bz2_chunk(tmp_path):
    """A bag whose chunk is bz2-compressed (as `rosbag record --bz2` writes
    it) reads as the uncompressed one in both packages; an lz4 chunk is
    refused by the port."""
    msgs = messages(t1, False)
    path = str(tmp_path / "plain.bag")
    write(path, t1.Rosbag1Writer, msgs)
    with open(path, "rb") as f:
        buf = f.read()
    off = len(t1.MAGIC)
    chunk_at = None
    while off < len(buf):
        header, data, nxt = t1._read_record(buf, off)
        if header[b"op"][0] == 0x05:
            chunk_at = off
            break
        off = nxt

    def recompressed(comp, data_out):
        hdr = t1._emit_header({b"op": bytes([0x05]), b"compression": comp,
                               b"size": struct.pack("<I", len(data))})
        rec = struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data_out)) + data_out
        return buf[:chunk_at] + rec

    bz = str(tmp_path / "bz2.bag")
    with open(bz, "wb") as f:
        f.write(recompressed(b"bz2", bz2.compress(data)))
    for mod in ROS1.values():
        got = [(m.topic, m.msgtype, m.t_ns, m.raw) for m in mod.Rosbag1Reader(bz).messages()]
        assert got == msgs
    lz = str(tmp_path / "lz4.bag")
    with open(lz, "wb") as f:
        f.write(recompressed(b"lz4", data))
    with pytest.raises(ValueError, match="lz4"):
        list(t1.Rosbag1Reader(lz).messages())


def test_rosbag2_payloads_equal(tmp_path):
    """The same messages give the same CDR payloads and the same rows in the
    bag's topics and messages tables."""
    ja, ta = messages(j2, True), messages(t2, True)
    assert [m[3] for m in ja] == [m[3] for m in ta]
    rows = {}
    for k, mod in ROS2.items():
        d = str(tmp_path / k)
        write(d, mod.Rosbag2Writer, ta)
        con = sqlite3.connect(os.path.join(d, f"{k}_0.db3"))
        rows[k] = [con.execute(f"SELECT * FROM {t} ORDER BY id").fetchall()
                   for t in ("topics", "messages")]
        con.close()
        with open(os.path.join(d, "metadata.yaml")) as f:
            rows[k].append(f.read().replace(f"{k}_0.db3", "*.db3"))
    assert rows["jax"] == rows["port"]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_rosbag2_exchanged(tmp_path, writer, reader):
    """A ROS2 bag written by one package and read by both: the same topics
    and messages, every message decoded equal."""
    msgs = messages(ROS2[writer], True)
    d = str(tmp_path / "bag")
    write(d, ROS2[writer].Rosbag2Writer, msgs)
    want = {m[0]: m[1] for m in msgs}
    got = {}
    for k, mod in ROS2.items():
        r = mod.Rosbag2Reader(d)
        assert r.topics() == want
        got[k] = list(r.messages())
        assert sorted((m.topic, m.msgtype, m.t_ns, m.raw) for m in got[k]) == sorted(msgs)
    for a, b in zip(got[writer], got[reader]):
        assert (a.topic, a.t_ns) == (b.topic, b.t_ns)
        assert_same(decoded(ROS2[writer], a), decoded(ROS2[reader], b))
    db = os.path.join(d, "bag_0.db3")
    assert [m.raw for m in ROS2[reader].Rosbag2Reader(db).messages(topics=["/gps"])] == [
        m[3] for m in msgs if m[0] == "/gps"]


@pytest.mark.parametrize("enc,dtype,extra", IMAGES, ids=[e[0] for e in IMAGES])
def test_to_mono8_matches_jax(enc, dtype, extra):
    """Each encoding decoded and turned grey by both
    packages: equal images, in ROS1 and ROS2 encodings."""
    rng = np.random.default_rng(3)
    img = image(rng, dtype, extra, 9, 13)
    for jmod, tmod in ((j1, t1), (j2, t2)):
        raw = tmod.encode_image(42, img, encoding=enc)
        a, b = jmod.decode_image(raw), tmod.decode_image(raw)
        np.testing.assert_array_equal(b.data, img)
        assert_same((a.data, jmod.to_mono8(a)), (b.data, tmod.to_mono8(b)))
        assert tmod.to_mono8(b).dtype == np.uint8 and tmod.to_mono8(b).shape == (9, 13)


def test_navsatfix_round_trips():
    """tests/test_rosbag.py's ROS1 NavSatFix body, and its CDR counterpart,
    decoded equal by both packages."""
    cov = np.arange(9, dtype=np.float64) + 1
    for jmod, tmod, body in ((j1, t1, navsatfix_ros1(7_000_000_011, 48.1, 11.6, 520.0, cov)),
                             (j2, t2, navsatfix_ros2(7_000_000_011, 48.1, 11.6, 520.0, cov))):
        a, b = jmod.decode_navsatfix(body), tmod.decode_navsatfix(body)
        assert b.t_ns == 7_000_000_011 and b.status == 1
        assert (b.latitude, b.longitude, b.altitude) == (48.1, 11.6, 520.0)
        np.testing.assert_array_equal(b.position_covariance, cov)
        assert_same((a.t_ns, a.status, a.latitude, a.longitude, a.altitude,
                     a.position_covariance),
                    (b.t_ns, b.status, b.latitude, b.longitude, b.altitude,
                     b.position_covariance))


def hilti_bag(path):
    """tests/test_rosbag.py's Hilti bag: five cameras, one IMU sample, one
    Hesai sweep of 16 points."""
    rng = np.random.default_rng(7)
    t0 = 2_000_000_000
    fields, blob = hesai_cloud(t0, 16, rng, t1)
    img = rng.integers(0, 255, (16, 20), dtype=np.uint8)
    with t1.Rosbag1Writer(path) as bag:
        for i in range(5):
            bag.write(f"/alphasense/cam{i}/image_raw", "sensor_msgs/Image", t0 + i,
                      t1.encode_image(t0 + i, img))
        bag.write("/alphasense/imu", "sensor_msgs/Imu", t0,
                  t1.encode_imu(t0, [0, 0, 0.1], [0, 0, 9.81]))
        bag.write("/hesai/pandar", "sensor_msgs/PointCloud2", t0,
                  t1.encode_pointcloud2(t0, fields, 48, blob, 16))


def vbr_bag(path, with_gps=False):
    """tests/test_rosbag.py's VBR bag: a stereo pair, one IMU sample, one
    Ouster sweep with an all-zero return; with `with_gps` also three
    NavSatFix messages on /gps."""
    rng = np.random.default_rng(7)
    t0 = 3_000_000_000
    fields, blob, n = ouster_cloud(t0, t1)
    img = rng.integers(0, 255, (12, 16), dtype=np.uint8)
    with t1.Rosbag1Writer(path) as bag:
        for side in ("left", "right"):
            bag.write(f"/camera_{side}/image_raw", "sensor_msgs/Image", t0,
                      t1.encode_image(t0, img))
        bag.write("/imu/data", "sensor_msgs/Imu", t0, t1.encode_imu(t0, [0, 0, 0], [0, 0, 9.81]))
        bag.write("/ouster/points", "sensor_msgs/PointCloud2", t0,
                  t1.encode_pointcloud2(t0, fields, 32, blob, n))
        if with_gps:
            for k in range(3):
                t = t0 + 200_000_000 * k
                bag.write("/gps", "sensor_msgs/NavSatFix", t, navsatfix_ros1(
                    t, 47.3 + 1e-6 * k, 8.5, 410.0, np.full(9, 0.25 * (k + 1))))


def presets(mod):
    return {"hilti": mod.HILTI, "vbr": mod.VBR,
            "vbr_gps": mod.BagPreset(cameras=dict(mod.VBR.cameras), imu_topic="/imu/data",
                                     lidar_topic="/ouster/points", lidar_time_field="t",
                                     drop_zero_points=True, gps_topic="/gps")}


@pytest.mark.parametrize("preset", ["hilti", "vbr", "vbr_gps"])
def test_convert_bag_matches_jax(tmp_path, preset):
    """Both packages' `convert_bag` on one bag: the same counts and files, the
    CSVs byte for byte, the PNGs as decoded pixels."""
    bag = str(tmp_path / "in.bag")
    if preset == "hilti":
        hilti_bag(bag)
    else:
        vbr_bag(bag, with_gps=preset == "vbr_gps")
    outs, counts = {}, {}
    for k, mod in CONV.items():
        outs[k] = str(tmp_path / k)
        counts[k] = mod.convert_bag(bag, outs[k], presets(mod)[preset])
    assert counts["port"] == counts["jax"]
    assert counts["port"]["images"] > 0 and counts["port"]["lidar_points"] > 0
    assert counts["port"]["gps"] == (3 if preset == "vbr_gps" else 0)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(outs["port"]) == files(outs["jax"])
    for rel in files(outs["port"]):
        a, b = (os.path.join(outs[k], rel) for k in ("jax", "port"))
        if rel.endswith(".png"):
            x, y = png.read(a), png.read(b)
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
