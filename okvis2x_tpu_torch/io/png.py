"""PNG and PGM codec (numpy and the standard library's zlib).

Counterpart of the image decoding of ``okvis2x_tpu/io/native_loader.py``
(`decode_image`) and of the PNG writes of ``okvis2x_tpu/io/dataset_writer.py``
and ``synthetic.generate``, which go through libpng or Pillow: the port
carries its own codec so that it needs neither.

Decoded: PNG of colour type 0 (grey), 2 (RGB), 4 (grey and alpha) or 6
(RGBA) at bit depth 8 or 16, not interlaced, with any of the five row
filters; binary PGM (P5) with a maxval up to 65535.  Encoded: grey PNG and
PGM.  Anything else raises ``ValueError``.  Two conversions to grey:
`to_grey` computes what libpng gives the native loader (BT.709 weights in
fixed point), `pil_grey` what Pillow's ``convert("L")`` gives (BT.601).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of `raw` (H, 1 + S) uint8, the filter byte
    first in each row; `bpp` bytes per pixel.  Returns (H, S) uint8.

    Byte (r, i) depends on (r, i - bpp), (r - 1, i) and (r - 1, i - bpp), so
    the bytes of one anti-diagonal r + i // bpp are independent: one numpy
    step per anti-diagonal, whatever the mix of filters."""
    H, S = raw.shape[0], raw.shape[1] - 1
    ftype = raw[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    if not ftype.any():
        return raw[:, 1:].copy()
    W = S // bpp
    x = raw[:, 1:].astype(np.int64).reshape(H, W, bpp)
    out = np.zeros((H + 1, W + 1, bpp), np.int64)  # a zero row above, a zero column left
    rows = np.arange(H)
    for d in range(H + W - 1):
        r = rows[max(0, d - W + 1):min(H, d + 1)]
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, ul)], 0)
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(H, S).astype(np.uint8)


CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # by PNG colour type


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) for grey, else (H, W, C) with C the colour type's
    channels; uint8, or uint16 (big-endian samples decoded) at bit depth 16."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, colour, comp, filt, interlace = header
    if colour not in CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not handled (palettes are not)")
    if depth not in (8, 16):
        raise ValueError(f"PNG bit depth {depth} is not handled (8 or 16)")
    if interlace != 0:
        raise ValueError("interlaced PNG is not handled")
    if comp != 0 or filt != 0:
        raise ValueError("unknown PNG compression or filter method")
    C = CHANNELS[colour]
    bpp = C * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError("PNG image data of the wrong size")
    img = unfilter(raw.reshape(H, 1 + W * bpp), bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape((H, W) if C == 1 else (H, W, C))


def _rgb(img: np.ndarray) -> np.ndarray:
    return img[..., :3].astype(np.int64)


def to_grey(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 of a decoded PNG as libpng gives it to the native loader
    (``png_set_strip_16``, ``png_set_strip_alpha``,
    ``png_set_rgb_to_gray_fixed`` with its default coefficients 6968, 23434
    and 2366 of 32768): 16-bit samples keep their high byte, alpha goes, and
    colour is weighted at the samples' own depth, truncated at 8 bits and
    rounded at 16."""
    wide = img.dtype == np.uint16
    if img.ndim == 3:
        if img.shape[2] >= 3:
            r, g, b = np.moveaxis(_rgb(img), -1, 0)
            s = 6968 * r + 23434 * g + 2366 * b
            img = (s + 16384) >> 15 if wide else s >> 15
        else:
            img = img[..., 0]
    return (img >> 8 if wide else img).astype(np.uint8)


def pil_grey(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 of a decoded PNG as Pillow's ``Image.open(path).convert("L")``
    gives it: 16-bit grey clipped at 255 (Pillow opens it as "I;16"), other
    16-bit samples their high byte, alpha dropped, colour weighted
    (19595 R + 38470 G + 7471 B + 32768) >> 16."""
    if img.ndim == 2:
        return np.minimum(img, 255).astype(np.uint8)
    if img.dtype == np.uint16:
        img = img >> 8
    if img.shape[2] < 3:
        return img[..., 0].astype(np.uint8)
    r, g, b = np.moveaxis(_rgb(img), -1, 0)
    return ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8 or uint16 array -> PNG bytes (rows unfiltered)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes a 2-D uint8 or uint16 array, not "
                         f"{img.dtype} {img.shape}")
    H, W = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows.reshape(H, -1)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _pgm_tokens(data: bytes, n: int):
    """The first `n` header tokens of a PGM and the offset after them."""
    toks, pos = [], 2
    while len(toks) < n:
        while data[pos:pos + 1].isspace() or data[pos:pos + 1] == b"#":
            if data[pos:pos + 1] == b"#":
                pos = data.index(b"\n", pos)
            pos += 1
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        toks.append(int(data[pos:end]))
        pos = end
    return toks, pos + 1  # one whitespace byte ends the header


def _decode_pgm(data: bytes):
    if not data.startswith(b"P5"):
        raise ValueError("not a binary PGM (P5) file")
    (W, H, maxval), pos = _pgm_tokens(data, 3)
    if not 0 < maxval < 65536:
        raise ValueError(f"PGM maxval {maxval}")
    dt = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
    img = np.frombuffer(data, dt, H * W, pos).reshape(H, W)
    return img.astype(np.uint8 if maxval < 256 else np.uint16), maxval


def decode_pgm(data: bytes) -> np.ndarray:
    """Binary PGM bytes -> (H, W) uint8 (maxval < 256) or uint16 array."""
    return _decode_pgm(data)[0]


def encode_pgm(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("encode_pgm takes a 2-D uint8 or uint16 array")
    H, W = img.shape
    maxval = 255 if img.dtype == np.uint8 else 65535
    return f"P5\n{W} {H}\n{maxval}\n".encode() + img.astype(
        np.uint8 if maxval == 255 else ">u2").tobytes()


def read(path: str) -> np.ndarray:
    """Decode a PNG or PGM file to its uint8 or uint16 array (`decode_png`)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data)
    if data.startswith(b"P5"):
        return decode_pgm(data)
    raise ValueError(f"{path}: neither PNG nor binary PGM")


def write(path: str, img: np.ndarray, level: int = 6):
    """Write `img` as PNG, or as PGM when `path` ends in .pgm."""
    data = encode_pgm(img) if path.lower().endswith(".pgm") else encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)


def decode_image(path: str) -> np.ndarray:
    """One image file -> (H, W) uint8, as ``native_loader.decode_image``
    does through libpng: a PNG through `to_grey`, a 16-bit PGM scaled by
    255 / maxval."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(b"P5"):
        img, maxval = _decode_pgm(data)
        if img.dtype == np.uint16:
            img = (img.astype(np.uint32) * 255 // maxval).astype(np.uint8)
        return img
    return to_grey(decode_png(data))
