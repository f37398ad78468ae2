"""The port's JPEG decoder (data/jpeg.py) and its palette, low-bit-depth and
interlaced PNGs (data/imageio.py) against OpenCV, which this image has and
the card's machine does not.

- JPEGs that cv2.imwrite writes at quality 50 and 95, at 4:4:4, 4:2:2 and
  4:2:0 chroma, grey, with a restart interval, at ETH3D's raw 739x458 and
  at odd sizes: within 1 of cv2.imread per channel (the decoder repeats
  libjpeg-turbo's integer IDCT, fancy upsampling and colour tables, and is
  exact on all of them here);
- the committed fixtures of tests/data/jpeg/ (chip_smoke.py's ETH3D frames):
  within 1 of cv2.imread;
- lossless, hierarchical, 12-bit and 4-component JPEGs, and a progressive
  one whose scans leave coefficient bits unknown, raise NotImplementedError
  naming the mode;
- palette PNGs at 1, 2, 4 and 8 bits, grey at 1, 2 and 4 bits, and Adam7
  interlaced PNGs of every colour type: equal to cv2.imread;
- eth3d_stream over color/*.jpg: the JAX package's frames and intrinsics,
  exactly.
"""
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest

from droid_slam_reserch_tpu.data import eth3d as jeth3d
from droid_slam_reserch_tpu_torch.data import eth3d as teth3d
from droid_slam_reserch_tpu_torch.data import imageio, jpeg

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "jpeg")
SIZES = [(458, 739), (37, 53), (9, 17)]
KINDS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "grey": None, "restart": None}


def _texture(h, w, c=3, seed=0):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, c), dtype=np.uint8), (5, 5), 1.2)
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)


def _within_one(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max()) <= 1


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("quality", [50, 95])
def test_jpeg_matches_cv2(tmp_path, quality, kind):
    for k, (h, w) in enumerate(SIZES):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if KINDS[kind] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, KINDS[kind]]
        if kind == "restart":
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
        path = str(tmp_path / f"x{k}.jpg")
        cv2.imwrite(path, _texture(h, w, 1 if kind == "grey" else 3, seed=k), params)
        _within_one(imageio.imread(path), cv2.imread(path))
        if kind == "grey":
            _within_one(imageio.read_bgr(path)[..., 0], cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_committed_fixtures_match_cv2():
    files = sorted(os.listdir(FIXTURES))
    assert len(files) == 6 and sum(os.path.getsize(os.path.join(FIXTURES, f))
                                   for f in files) <= 300 * 1024
    for f in files:
        path = os.path.join(FIXTURES, f)
        got = imageio.imread(path)
        assert got.shape == (458, 739, 3)
        _within_one(got, cv2.imread(path))


def _sos_offsets(blob):
    """Offsets of the SOS markers of a JPEG (header segments walked, each
    scan's entropy-coded data skipped up to the next marker)."""
    pos, out = 2, []
    while pos < len(blob):
        marker = blob[pos + 1]
        if marker == 0xD9:
            break
        length = (blob[pos + 2] << 8) | blob[pos + 3]
        if marker == 0xDA:
            out.append(pos)
            pos += 2 + length
            while not (blob[pos] == 0xFF and blob[pos + 1] not in (0x00, *range(0xD0, 0xD8))):
                pos += 1
        else:
            pos += 2 + length
    return out


def _with_sof(blob, marker=None, precision=None, extra_component=False):
    """A baseline JPEG's frame header relabelled: another SOF marker, another
    sample precision, or a fourth component."""
    blob = bytearray(blob)
    sof = blob.find(b"\xff\xc0")
    if marker is not None:
        blob[sof + 1] = marker
    if precision is not None:
        blob[sof + 4] = precision
    if extra_component:
        n = (blob[sof + 2] << 8) | blob[sof + 3]
        blob[sof + 2: sof + 4] = (n + 3).to_bytes(2, "big")
        blob[sof + 9] = 4
        blob[sof + 2 + n: sof + 2 + n] = bytes([4, 0x11, 0])
    return bytes(blob)


def _incomplete_progressive():
    """cv2's progressive JPEG without its last four scans (the DC refine and
    the final AC refinements): bits of every AC coefficient stay unknown."""
    ok, buf = cv2.imencode(".jpg", _texture(16, 24), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    blob = buf.tobytes()
    sos = _sos_offsets(blob)
    assert len(sos) == 10
    return blob[: sos[6]] + b"\xff\xd9"


def _baseline():
    return cv2.imencode(".jpg", _texture(16, 24))[1].tobytes()


UNSUPPORTED = {
    "lossless": (lambda: _with_sof(_baseline(), marker=0xC3), "lossless"),
    "hierarchical": (lambda: _with_sof(_baseline(), marker=0xC5), "hierarchical"),
    "arith-lossless": (lambda: _with_sof(_baseline(), marker=0xCB), "lossless"),
    "12-bit": (lambda: _with_sof(_baseline(), precision=12), "12-bit"),
    "4-component": (lambda: _with_sof(_baseline(), extra_component=True), "4-component"),
    "incomplete-progressive": (_incomplete_progressive, "unknown"),
}


@pytest.mark.parametrize("mode", sorted(UNSUPPORTED))
def test_unsupported_jpeg_modes_raise(mode):
    """The modes the decoder still refuses raise NotImplementedError naming
    the mode (progressive and arithmetic-coded JPEGs decode:
    tests/test_torch_jpeg_progressive.py and tests/test_torch_jpeg_arith.py)."""
    make, match = UNSUPPORTED[mode]
    with pytest.raises(NotImplementedError, match=match):
        jpeg.decode(make())


def _pack(samples, depth):
    """Rows of samples [h, w, c] packed at `depth` bits, [h, bytes]."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.reshape(h, -1).astype(np.uint8)
    bits = ((samples.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(rows, bpp, seed):
    """Each row with a row filter (0-4, seeded), as a PNG's IDAT holds it."""
    kinds = np.random.RandomState(seed).randint(0, 5, len(rows))
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for f, x in zip(kinds, rows.astype(np.int32)):
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        pred = [0, a, prev, (a + prev) >> 1, paeth][f]
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def write_png(path, samples, depth, ctype, palette=None, interlace=False):
    """Encode samples [h, w, c] (palette indices for ctype 3) at `depth`
    bits, with seeded row filters, Adam7-interlaced if asked."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        body = b"".join(_filtered(_pack(samples[y0::dy, x0::dx], depth), bpp, k)
                        for k, (x0, y0, dx, dy) in enumerate(ADAM7)
                        if samples[y0::dy, x0::dx].size)
    else:
        body = _filtered(_pack(samples, depth), bpp, 0)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                             0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    with open(path, "wb") as f:
        f.write(out + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_palette_png_matches_cv2(tmp_path, depth, interlace):
    rng = np.random.RandomState(depth)
    n = 2 ** depth
    palette = rng.randint(0, 256, (n, 3))
    for h, w in ((13, 21), (1, 1), (8, 3)):
        path = str(tmp_path / f"p{h}.png")
        write_png(path, rng.randint(0, n, (h, w, 1)), depth, 3, palette, interlace)
        got = imageio.imread(path)
        assert got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, cv2.imread(path))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_depth_grey_png_matches_cv2(tmp_path, depth):
    path = str(tmp_path / "g.png")
    write_png(path, np.random.RandomState(depth).randint(0, 2 ** depth, (11, 19, 1)), depth, 0)
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(imageio.imread(path, anydepth=True),
                                  cv2.imread(path, cv2.IMREAD_ANYDEPTH))


TYPES = [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16), (2, 16), (6, 16)]


@pytest.mark.parametrize("ctype,depth", TYPES, ids=[f"type{t}-{d}bit" for t, d in TYPES])
def test_interlaced_png_matches_cv2(tmp_path, ctype, depth):
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype + depth)
    hi = 65536 if depth == 16 else 256
    for h, w in ((23, 37), (3, 2), (1, 9)):
        path = str(tmp_path / f"i{h}.png")
        samples = rng.randint(0, hi, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
        write_png(path, samples, depth, ctype, interlace=True)
        np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
        if ctype == 0:
            np.testing.assert_array_equal(imageio.imread(path, anydepth=True),
                                          cv2.imread(path, cv2.IMREAD_ANYDEPTH))


def test_eth3d_stream_on_jpegs_matches_jax(tmp_path):
    """ETH3D's color/*.jpg layout (no rgb/): the port's frames and
    intrinsics equal the JAX package's (cv2.imread + resize_to_area)."""
    os.makedirs(tmp_path / "color")
    for k, f in enumerate(sorted(os.listdir(FIXTURES))[:3]):
        shutil.copy(os.path.join(FIXTURES, f), tmp_path / "color" / f"{1000.0 + 0.5 * k:.6f}.jpg")
    np.savetxt(tmp_path / "calibration.txt", np.array([[726.28, 726.28, 354.65, 186.47]]))
    got = list(teth3d.eth3d_stream(str(tmp_path)))
    ref = list(jeth3d.eth3d_stream(str(tmp_path)))
    assert len(got) == len(ref) == 3
    for (tg, ig, kg), (tr, ir, kr) in zip(got, ref):
        assert tg == tr
        np.testing.assert_array_equal(ig, ir)
        np.testing.assert_array_equal(kg, kr)
    assert teth3d.eth3d_timestamps(str(tmp_path)) == jeth3d.eth3d_timestamps(str(tmp_path))
