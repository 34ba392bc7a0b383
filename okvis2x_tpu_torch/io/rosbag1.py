"""Pure-Python ROS1 bag (format v2.0) reader and writer.

Counterpart of ``okvis2x_tpu/io/rosbag1.py``, which replaces the
`rosbag`/`cv_bridge` dependency of the reference's conversion tools
(tools/hilti_bag2mrl.py, tools/vbr_bag2mrl.py and
okvis_apps/scripts/bag_creator.py): no ROS installation is needed to read a
public dataset shipped as a ROS1 bag, or to write one from a dataset folder.

Supported record set: bag header (0x03), chunk (0x05, uncompressed or bz2),
connection (0x07), message data (0x02); index records are skipped (messages
are streamed in file order, which rosbag writes in roughly time order per
chunk).

Message decoders cover the sensor types OKVIS2-X consumes: sensor_msgs/Imu,
sensor_msgs/Image, sensor_msgs/PointCloud2, sensor_msgs/NavSatFix.
Serialization is the ROS1 wire format: little-endian, no alignment, strings
as u32 length + bytes.  `Rosbag1Writer` writes the same bytes as the JAX
package's for the same messages.
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_OP_MSGDATA = 0x02
_OP_BAGHEADER = 0x03
_OP_INDEXDATA = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONNECTION = 0x07

MAGIC = b"#ROSBAG V2.0\n"


# ----------------------------------------------------------------- records


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _emit_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        field = name + b"=" + value
        out += struct.pack("<I", len(field)) + field
    return out


def _read_record(buf: bytes, off: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", buf, off)
    header = _parse_header(buf[off + 4:off + 4 + hlen])
    off += 4 + hlen
    (dlen,) = struct.unpack_from("<I", buf, off)
    data = buf[off + 4:off + 4 + dlen]
    return header, data, off + 4 + dlen


@dataclasses.dataclass
class Connection:
    conn_id: int
    topic: str
    msgtype: str


@dataclasses.dataclass
class BagMessage:
    topic: str
    msgtype: str
    t_ns: int  # record (receive) time
    raw: bytes  # serialized ROS1 message body


class Rosbag1Reader:
    """Stream (topic, type, raw, t) tuples out of a ROS1 v2.0 bag file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = f.read()
        if not self._buf.startswith(MAGIC):
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        self.connections: Dict[int, Connection] = {}

    def _decompress(self, header, data) -> bytes:
        comp = header.get(b"compression", b"none")
        if comp == b"none":
            return data
        if comp == b"bz2":
            return bz2.decompress(data)
        raise ValueError(f"unsupported chunk compression {comp!r} (bz2 and none are read)")

    def _handle_connection(self, header, data):
        cid = struct.unpack("<I", header[b"conn"])[0]
        info = _parse_header(data)
        self.connections[cid] = Connection(
            conn_id=cid,
            topic=header.get(b"topic", info.get(b"topic", b"")).decode(),
            msgtype=info.get(b"type", b"").decode(),
        )

    def messages(
        self, topics: Optional[List[str]] = None
    ) -> Iterator[BagMessage]:
        want = set(topics) if topics is not None else None
        off = len(MAGIC)
        buf = self._buf
        while off < len(buf):
            header, data, off = _read_record(buf, off)
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONNECTION:
                self._handle_connection(header, data)
            elif op == _OP_CHUNK:
                inner = self._decompress(header, data)
                ioff = 0
                while ioff < len(inner):
                    ih, idata, ioff = _read_record(inner, ioff)
                    iop = ih.get(b"op", b"\x00")[0]
                    if iop == _OP_CONNECTION:
                        self._handle_connection(ih, idata)
                    elif iop == _OP_MSGDATA:
                        msg = self._msg(ih, idata, want)
                        if msg is not None:
                            yield msg
            elif op == _OP_MSGDATA:  # unchunked (v1.2-style) bags
                msg = self._msg(header, data, want)
                if msg is not None:
                    yield msg
            # bag header / index / chunk info records: skip

    def _msg(self, header, data, want) -> Optional[BagMessage]:
        cid = struct.unpack("<I", header[b"conn"])[0]
        conn = self.connections.get(cid)
        if conn is None or (want is not None and conn.topic not in want):
            return None
        secs, nsecs = struct.unpack("<II", header[b"time"])
        return BagMessage(
            topic=conn.topic,
            msgtype=conn.msgtype,
            t_ns=secs * 1_000_000_000 + nsecs,
            raw=data,
        )


# ------------------------------------------------------------ deserializers


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.buf, self.off)
        self.off += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n):
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return np.asarray(v)

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def raw(self, n) -> bytes:
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b


def _header(c: _Cursor) -> Tuple[int, str]:
    """std_msgs/Header -> (stamp_ns, frame_id)."""
    c.u32()  # seq
    secs, nsecs = c.u32(), c.u32()
    frame_id = c.string()
    return secs * 1_000_000_000 + nsecs, frame_id


@dataclasses.dataclass
class ImuMsg:
    t_ns: int
    gyr: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)


def decode_imu(raw: bytes) -> ImuMsg:
    c = _Cursor(raw)
    t_ns, _ = _header(c)
    c.f64s(4)  # orientation quaternion
    c.f64s(9)  # orientation covariance
    gyr = c.f64s(3)
    c.f64s(9)
    acc = c.f64s(3)
    c.f64s(9)
    return ImuMsg(t_ns=t_ns, gyr=gyr, acc=acc)


@dataclasses.dataclass
class ImageMsg:
    t_ns: int
    height: int
    width: int
    encoding: str
    data: np.ndarray  # (H, W) or (H, W, C) uint8 / uint16


_ENC = {
    "mono8": (np.uint8, 1),
    "8UC1": (np.uint8, 1),
    "mono16": (np.uint16, 1),
    "16UC1": (np.uint16, 1),
    "rgb8": (np.uint8, 3),
    "bgr8": (np.uint8, 3),
    "rgba8": (np.uint8, 4),
    "bgra8": (np.uint8, 4),
    "bayer_rggb8": (np.uint8, 1),
    "bayer_gbrg8": (np.uint8, 1),
    "bayer_grbg8": (np.uint8, 1),
    "bayer_bggr8": (np.uint8, 1),
}


def decode_image(raw: bytes) -> ImageMsg:
    c = _Cursor(raw)
    t_ns, _ = _header(c)
    height, width = c.u32(), c.u32()
    encoding = c.string()
    c.u8()  # is_bigendian
    step = c.u32()
    n = c.u32()
    data = c.raw(n)
    dtype, channels = _ENC.get(encoding, (np.uint8, 1))
    row = np.frombuffer(data, dtype=np.uint8).reshape(height, step)
    itemsize = np.dtype(dtype).itemsize
    img = row[:, : width * channels * itemsize].copy().view(dtype)
    img = img.reshape(height, width, channels) if channels > 1 else img.reshape(
        height, width
    )
    return ImageMsg(
        t_ns=t_ns, height=height, width=width, encoding=encoding, data=img
    )


def to_mono8(img: ImageMsg) -> np.ndarray:
    """Grayscale view of any supported encoding (≙ cv_bridge
    `imgmsg_to_cv2(desired_encoding="mono8")` for the encodings above)."""
    a = img.data
    if a.dtype == np.uint16:
        a = (a / 257.0).astype(np.uint8)
    if a.ndim == 2:
        return a
    if img.encoding.startswith("bgr"):
        b, g, r = a[..., 0], a[..., 1], a[..., 2]
    else:
        r, g, b = a[..., 0], a[..., 1], a[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b).astype(np.uint8)


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


_PF_DTYPE = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


@dataclasses.dataclass
class PointCloud2Msg:
    t_ns: int
    height: int
    width: int
    fields: List[PointField]
    point_step: int
    data: bytes

    def arrays(self) -> Dict[str, np.ndarray]:
        """Per-field numpy arrays (structured view over the blob)."""
        names = [f.name for f in self.fields]
        formats = [
            (_PF_DTYPE[f.datatype], f.count) if f.count > 1
            else _PF_DTYPE[f.datatype]
            for f in self.fields
        ]
        offsets = [f.offset for f in self.fields]
        dt = np.dtype(
            {"names": names, "formats": formats, "offsets": offsets,
             "itemsize": self.point_step}
        )
        n = self.height * self.width
        rec = np.frombuffer(self.data, dtype=dt, count=n)
        return {name: rec[name] for name in names}


def decode_pointcloud2(raw: bytes) -> PointCloud2Msg:
    c = _Cursor(raw)
    t_ns, _ = _header(c)
    height, width = c.u32(), c.u32()
    nf = c.u32()
    fields = []
    for _ in range(nf):
        name = c.string()
        offset, datatype, count = c.u32(), c.u8(), c.u32()
        fields.append(PointField(name, offset, datatype, count))
    c.u8()  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    n = c.u32()
    data = c.raw(n)
    return PointCloud2Msg(
        t_ns=t_ns, height=height, width=width, fields=fields,
        point_step=point_step, data=data,
    )


@dataclasses.dataclass
class NavSatFixMsg:
    t_ns: int
    status: int
    latitude: float
    longitude: float
    altitude: float
    position_covariance: np.ndarray  # (9,)


def decode_navsatfix(raw: bytes) -> NavSatFixMsg:
    c = _Cursor(raw)
    t_ns, _ = _header(c)
    status = c.i8()
    c.u16()  # service
    lat, lon, alt = c.f64(), c.f64(), c.f64()
    cov = c.f64s(9)
    c.u8()  # covariance type
    return NavSatFixMsg(
        t_ns=t_ns, status=status, latitude=lat, longitude=lon, altitude=alt,
        position_covariance=cov,
    )


DECODERS = {
    "sensor_msgs/Imu": decode_imu,
    "sensor_msgs/Image": decode_image,
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "sensor_msgs/NavSatFix": decode_navsatfix,
}


# --------------------------------------------------------------- serializers
# (bag creation — parity with okvis_apps/scripts/bag_creator.py)


def _ser_header(t_ns: int, frame_id: str = "") -> bytes:
    secs, nsecs = divmod(int(t_ns), 1_000_000_000)
    fid = frame_id.encode()
    return struct.pack("<III", 0, secs, nsecs) + struct.pack(
        "<I", len(fid)
    ) + fid


def encode_imu(t_ns: int, gyr, acc, frame_id: str = "imu") -> bytes:
    out = _ser_header(t_ns, frame_id)
    out += struct.pack("<4d", 0, 0, 0, 1)  # orientation
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(gyr, np.float64))
    out += struct.pack("<9d", *([0.0] * 9))
    out += struct.pack("<3d", *np.asarray(acc, np.float64))
    out += struct.pack("<9d", *([0.0] * 9))
    return out


def encode_image(
    t_ns: int, img: np.ndarray, encoding: str = "mono8", frame_id: str = "cam"
) -> bytes:
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    step = img.strides[0]
    body = img.tobytes()
    enc = encoding.encode()
    out = _ser_header(t_ns, frame_id)
    out += struct.pack("<II", h, w)
    out += struct.pack("<I", len(enc)) + enc
    out += struct.pack("<BI", 0, step)
    out += struct.pack("<I", len(body)) + body
    return out


def encode_pointcloud2(
    t_ns: int,
    fields: List[PointField],
    point_step: int,
    data: bytes,
    n_points: int,
    frame_id: str = "lidar",
) -> bytes:
    out = _ser_header(t_ns, frame_id)
    out += struct.pack("<II", 1, n_points)
    out += struct.pack("<I", len(fields))
    for f in fields:
        name = f.name.encode()
        out += struct.pack("<I", len(name)) + name
        out += struct.pack("<IBI", f.offset, f.datatype, f.count)
    out += struct.pack("<BII", 0, point_step, point_step * n_points)
    out += struct.pack("<I", len(data)) + data
    out += struct.pack("<B", 1)  # is_dense
    return out


class Rosbag1Writer:
    """Write a structurally valid v2.0 bag: one uncompressed chunk holding
    all connection + message records (enough for Rosbag1Reader and for
    `rosbag reindex`-capable consumers)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        # bag header record, padded to 4096 bytes like rosbag does
        hdr = _emit_header(
            {
                b"op": bytes([_OP_BAGHEADER]),
                b"index_pos": struct.pack("<Q", 0),
                b"conn_count": struct.pack("<I", 0),
                b"chunk_count": struct.pack("<I", 1),
            }
        )
        pad = 4096 - 8 - len(hdr)
        self._f.write(struct.pack("<I", len(hdr)) + hdr)
        self._f.write(struct.pack("<I", pad) + b" " * pad)
        self._chunk = bytearray()
        self._topics: Dict[str, int] = {}

    def _record(self, fields: Dict[bytes, bytes], data: bytes) -> bytes:
        hdr = _emit_header(fields)
        return (
            struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data
        )

    def _conn(self, topic: str, msgtype: str) -> int:
        if topic in self._topics:
            return self._topics[topic]
        cid = len(self._topics)
        self._topics[topic] = cid
        info = _emit_header(
            {
                b"topic": topic.encode(),
                b"type": msgtype.encode(),
                b"md5sum": b"*",
                b"message_definition": b"",
            }
        )
        self._chunk += self._record(
            {
                b"op": bytes([_OP_CONNECTION]),
                b"conn": struct.pack("<I", cid),
                b"topic": topic.encode(),
            },
            info,
        )
        return cid

    def write(self, topic: str, msgtype: str, t_ns: int, raw: bytes):
        cid = self._conn(topic, msgtype)
        secs, nsecs = divmod(int(t_ns), 1_000_000_000)
        self._chunk += self._record(
            {
                b"op": bytes([_OP_MSGDATA]),
                b"conn": struct.pack("<I", cid),
                b"time": struct.pack("<II", secs, nsecs),
            },
            raw,
        )

    def close(self):
        chunk = bytes(self._chunk)
        self._f.write(
            self._record(
                {
                    b"op": bytes([_OP_CHUNK]),
                    b"compression": b"none",
                    b"size": struct.pack("<I", len(chunk)),
                },
                chunk,
            )
        )
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
