"""The port's native dataset loader (`okvis2x_tpu_torch/io/native_loader.py`,
the port's own build of native/dataloader.cpp) against the JAX package's
`okvis2x_tpu/io/native_loader.py`: the eight cases of
tests/test_native_loader.py (PNG decode of grey, RGB and 16-bit images,
binary PGM, in-order prefetch, an early close, the native queue's round trip,
drop and timeout, a blocking producer and consumer), every decode held
against the JAX package's `decode_image` on the same file; every PNG kind the
port's codec reads decoded as libpng decodes it; and the fallback to
``io/png.py`` where the library cannot be built, counted frame by frame.

Every test that starts a thread runs under `within` (tests/test_torch_queues.py):
a hang fails that test after LIMIT_S instead of stopping the suite."""

import os
import struct
import threading
import time
import zlib

import numpy as np
import pytest
from PIL import Image

from okvis2x_tpu.io import native_loader as jnl
from okvis2x_tpu_torch.io import native_loader as nl
from okvis2x_tpu_torch.io import png
from okvis2x_tpu_torch.ops.hamming import BUILD_DIR
from test_torch_queues import within


def _write_png(path, arr, mode="L"):
    Image.fromarray(arr, mode=mode).save(path)


def decoded(path):
    """The port's decode of `path`, held equal to the JAX package's."""
    out = nl.decode_image(path)
    np.testing.assert_array_equal(out, jnl.decode_image(path))
    assert out.dtype == np.uint8
    return out


def test_library_is_the_ports_own_build():
    """The port builds its library from the source into build/, never the
    JAX package's native/libdataloader.so."""
    assert nl.available(), nl.LIBRARY.error
    lib = os.path.realpath(nl.LIBRARY.lib._name)
    assert os.path.dirname(lib) == os.path.realpath(BUILD_DIR)
    assert os.path.basename(lib).startswith("libdataloader_")


def test_decode_png_gray(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    p = str(tmp_path / "g.png")
    _write_png(p, arr)
    np.testing.assert_array_equal(decoded(p), arr)


def test_decode_png_rgb(tmp_path):
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (32, 40, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    _write_png(p, arr, mode="RGB")
    out = decoded(p)
    assert out.shape == (32, 40)
    # libpng defaults to BT.709 luminance coefficients
    lum = arr @ np.array([0.2126, 0.7152, 0.0722])
    assert np.abs(out.astype(float) - lum).mean() < 3.0


def test_decode_png_16bit(tmp_path):
    arr16 = (np.arange(16 * 20, dtype=np.uint16).reshape(16, 20) * 97) % 65535
    p = str(tmp_path / "d.png")
    Image.fromarray(arr16, mode="I;16").save(p)
    out = decoded(p)
    assert out.shape == (16, 20)
    # 16->8 bit strip keeps the high byte
    np.testing.assert_array_equal(out, (arr16 >> 8).astype(np.uint8))


def test_decode_pgm(tmp_path):
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, (24, 30), dtype=np.uint8)
    p = str(tmp_path / "e.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# comment\n30 24\n255\n")
        f.write(arr.tobytes())
    np.testing.assert_array_equal(decoded(p), arr)


def png_bytes(arr, colour):
    """A PNG of `arr` (uint8 or uint16, the colour type's channels last),
    rows unfiltered."""
    H, W = arr.shape[:2]
    depth = 8 * arr.dtype.itemsize
    rows = (arr.astype(">u2") if depth == 16 else arr).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    return (png.PNG_SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, colour, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("colour", sorted(png.CHANNELS))
def test_codec_decodes_as_libpng(tmp_path, colour, depth):
    """Every PNG kind the port's codec reads (grey, RGB, grey and alpha,
    RGBA at 8 and 16 bits) comes out of `io/png.py` as libpng gives it to
    the loader, bit for bit, with equal channels where colour is grey."""
    rng = np.random.default_rng(10 * colour + depth)
    C = png.CHANNELS[colour]
    arr = rng.integers(0, 2**depth, (37, 41) if C == 1 else (37, 41, C),
                       dtype=np.uint8 if depth == 8 else np.uint16)
    if C >= 3:
        arr[0, :7, 1:3] = arr[0, :7, :1]
    p = str(tmp_path / f"{colour}_{depth}.png")
    with open(p, "wb") as f:
        f.write(png_bytes(arr, colour))
    np.testing.assert_array_equal(png.read(p), arr)
    np.testing.assert_array_equal(png.decode_image(p), decoded(p))


def frames(tmp_path, n, rng, shape=(16, 16)):
    paths, imgs = [], []
    for i in range(n):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        p = str(tmp_path / f"{i:03d}.png")
        _write_png(p, arr)
        paths.append(p)
        imgs.append(arr)
    return paths, imgs


def test_prefetcher_order(tmp_path):
    paths, imgs = frames(tmp_path, 25, np.random.default_rng(3))
    got = within(lambda: list(nl.ImagePrefetcher(paths, n_threads=4, window=4)))
    ref = within(lambda: list(jnl.ImagePrefetcher(paths, n_threads=4, window=4)))
    assert len(got) == len(ref) == 25
    for a, b, c in zip(got, ref, imgs):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_prefetcher_early_close(tmp_path):
    paths, _ = frames(tmp_path, 10, np.random.default_rng(4), shape=(8, 8))

    def early_close():
        pf = nl.ImagePrefetcher(paths, n_threads=2, window=2)
        first = next(pf)
        pf.close()  # must not deadlock or crash
        return first

    np.testing.assert_array_equal(within(early_close), decoded(paths[0]))


def test_queue_roundtrip_and_drop():
    q = nl.NativeQueue(capacity=2)
    a = np.arange(10, dtype=np.float64)
    assert q.push(a) == 0
    assert q.push(a * 2) == 0
    # dropping push on a full queue drops the oldest
    assert q.push(a * 3, block=False) == 1
    out = q.pop().view(np.float64)
    np.testing.assert_array_equal(out, a * 2)
    out = q.pop().view(np.float64)
    np.testing.assert_array_equal(out, a * 3)
    assert q.size() == 0
    # timeout pop on empty
    t0 = time.time()
    assert q.pop(timeout_ms=50) is None
    assert time.time() - t0 < 2.0
    # a payload larger than the pop's first buffer, and pushes after shutdown
    big = np.arange(1 << 20, dtype=np.float64)
    assert q.push(big) == 0
    np.testing.assert_array_equal(q.pop(max_bytes=1024).view(np.float64), big)
    q.shutdown()
    assert q.push(a) == -1 and q.pop(timeout_ms=50) is None


def test_queue_blocking_producer_consumer():
    q = nl.NativeQueue(capacity=4)
    n = 200
    seen = []

    def consumer():
        while True:
            item = q.pop(timeout_ms=2000)
            if item is None:
                return
            seen.append(int(item.view(np.int64)[0]))
            if len(seen) == n:
                return

    th = threading.Thread(target=consumer, daemon=True)
    th.start()

    def produce():
        for i in range(n):
            q.push(np.array([i], np.int64))

    within(produce)
    th.join(timeout=10)
    assert not th.is_alive()
    assert seen == list(range(n))
    q.shutdown()


class _Missing:
    """A library that failed to build."""

    lib, error = None, "g++ failed"

    def load(self):
        return None


def test_fallback_without_the_library(tmp_path, monkeypatch):
    """Without the library every frame is decoded by io/png.py, equal to
    libpng's decode, and counted; the queue refuses to start, as the JAX
    package's does."""
    paths, imgs = frames(tmp_path, 5, np.random.default_rng(5))
    rgb = str(tmp_path / "c.png")
    _write_png(rgb, np.random.default_rng(6).integers(0, 256, (9, 11, 3), dtype=np.uint8),
               mode="RGB")
    monkeypatch.setattr(nl, "LIBRARY", _Missing())
    nl.FALLBACKS.reset()
    assert not nl.available()
    got = within(lambda: list(nl.ImagePrefetcher(paths)))
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nl.decode_image(rgb), jnl.decode_image(rgb))
    assert nl.FALLBACKS.frames == len(paths) + 1
    with pytest.raises(RuntimeError, match="unavailable"):
        nl.NativeQueue()
