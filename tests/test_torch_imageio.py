"""The port's data/imageio.py against OpenCV, which this image has and the
card's machine does not.

- imread: exactly cv2.imread (IMREAD_COLOR, and IMREAD_ANYDEPTH of grey
  PNGs), for colour types 0, 2, 4 and 6 at 8 bits and 0 and 2 at 16 bits,
  written by a small encoder here with each row filter 0-4 and a mix of
  them (OpenCV picks its own filters), and as cv2.imwrite writes them;
- resize: INTER_LINEAR on uint8 replicates OpenCV's fixed-point rule, so it
  is held exactly at the readers' shapes (a looser bar would be within 1 and
  99.9 % equal); INTER_NEAREST exactly; the float path within 1e-5 of
  cv2.resize's float result;
- init_undistort_rectify_map: within 1e-3 px of cv2's maps (EuRoC left and
  right);
- remap and undistort: within 1 and equal on at least 99.99 % of the
  values (EuRoC left and right rectification, TUM fr1, a generic
  5-coefficient calibration).
"""
import struct
import zlib

import cv2
import numpy as np
import pytest

from droid_slam_reserch_tpu.data import euroc as jeuroc
from droid_slam_reserch_tpu_torch.data import euroc as teuroc
from droid_slam_reserch_tpu_torch.data import imageio


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, samples, filters, ctype=None, interlace=0):
    """Encode samples [H, W, C] (uint8 or uint16, PNG channel order) with the
    row filters `filters` (one per row, cycled)."""
    h, w, c = samples.shape
    depth = 16 if samples.dtype == np.uint16 else 8
    ctype = {1: 0, 3: 2, 2: 4, 4: 6}[c] if ctype is None else ctype
    raw = samples.astype(">u2").view(np.uint8) if depth == 16 else samples
    raw = raw.reshape(h, -1).astype(np.int32)
    bpp = c * depth // 8
    out, prev = [], np.zeros(raw.shape[1], np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        x = raw[y]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, cc)][f]
        out.append(bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes())
        prev = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def _samples(h, w, c, depth, seed=0):
    rng = np.random.RandomState(seed)
    if depth == 8:
        return rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    return rng.randint(0, 65536, (h, w, c)).astype(np.uint16)


def _smooth(h, w, c=3, seed=0):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, c), dtype=np.uint8), (5, 5), 1.2)
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)


FILTERS = {"none": [0], "sub": [1], "up": [2], "average": [3], "paeth": [4],
           "mixed": [0, 1, 2, 3, 4, 4, 3, 2, 1]}
TYPES = [(0, 8), (2, 8), (4, 8), (6, 8), (0, 16), (2, 16)]


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("ctype,depth", TYPES, ids=[f"type{t}-{d}bit" for t, d in TYPES])
def test_imread_matches_cv2(tmp_path, ctype, depth, filt):
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    path = str(tmp_path / "x.png")
    write_png(path, _samples(23, 37, c, depth), FILTERS[filt])
    ref = cv2.imread(path)
    got = imageio.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, ref)
    if ctype in (0, 4):
        any_ref = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        any_got = imageio.imread(path, anydepth=True)
        assert any_got.dtype == any_ref.dtype == (np.uint16 if depth == 16 else np.uint8)
        np.testing.assert_array_equal(any_got, any_ref)


@pytest.mark.parametrize("kind", ["grey", "bgr", "bgra", "grey16", "bgr16"])
def test_imread_of_cv2_written_pngs(tmp_path, kind):
    """PNGs as cv2.imwrite writes them (the synthetic datasets' encoder),
    at EuRoC's raw 752x480."""
    img = _smooth(480, 752, 1 if kind.startswith("grey") else 4 if kind == "bgra" else 3)
    if kind.endswith("16"):
        img = img.astype(np.uint16) * 257 + 3
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
    np.testing.assert_array_equal(imageio.read_bgr(path)[..., 0], cv2.imread(path)[..., 0])
    if kind.startswith("grey"):
        np.testing.assert_array_equal(imageio.imread(path, anydepth=True),
                                      cv2.imread(path, cv2.IMREAD_ANYDEPTH))


def test_imread_refusals(tmp_path):
    """Formats the readers do not decode raise NotImplementedError naming
    the file or the mode (palette and interlaced PNGs and baseline,
    progressive and arithmetic-coded JPEGs are decoded:
    tests/test_torch_jpeg*.py; a lossless JPEG is not)."""
    with pytest.raises(NotImplementedError, match="frame.bmp"):
        imageio.imread(str(tmp_path / "frame.bmp"))
    path = str(tmp_path / "p.jpg")
    blob = bytearray(cv2.imencode(".jpg", _smooth(16, 24))[1].tobytes())
    blob[blob.find(b"\xff\xc0") + 1] = 0xC3           # the frame declared lossless
    with open(path, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(NotImplementedError, match="p.jpg: lossless"):
        imageio.imread(path)
    path = str(tmp_path / "i.png")
    write_png(path, _samples(8, 8, 3, 8), [0])
    with pytest.raises(NotImplementedError, match="colour"):
        imageio.imread(path, anydepth=True)


def _eth3d_area_size():
    """ETH3D's raw 739x458 resized to the area of 480x640 (resize_to_area)."""
    s = np.sqrt(480 * 640 / (458 * 739))
    return int(739 * s), int(458 * s)


# (source h, w) -> (w, h), the readers' resizes and an upscale
RESIZES = {
    "euroc": ((480, 752), (512, 320)),
    "tum": ((480, 640), (352, 256)),
    "eth3d_area": ((458, 739), _eth3d_area_size()),
    "tartanair": ((480, 640), (512, 384)),
    "upscale": ((120, 160), (331, 247)),
    "odd": ((37, 53), (29, 41)),
}


@pytest.mark.parametrize("name", sorted(RESIZES))
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_matches_cv2(name, channels):
    (h0, w0), size = RESIZES[name]
    img = _smooth(h0, w0, channels, seed=len(name))
    ref = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    got = imageio.resize(img, size)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)      # OpenCV's fixed point, replicated


@pytest.mark.parametrize("name", sorted(RESIZES))
def test_resize_nearest_matches_cv2(name):
    (h0, w0), size = RESIZES[name]
    rng = np.random.RandomState(1)
    for img in (rng.randint(0, 65536, (h0, w0)).astype(np.uint16),
                rng.randint(0, 65536, (h0, w0)) / 5000.0,
                _smooth(h0, w0, 3)):
        np.testing.assert_array_equal(imageio.resize(img, size, interp="nearest"),
                                      cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_resize_linear_float(dtype):
    img = np.random.RandomState(2).rand(48, 64).astype(dtype) * 4.0
    for size in ((40, 30), (100, 77)):
        np.testing.assert_allclose(imageio.resize(img, size),
                                   cv2.resize(img, size, interpolation=cv2.INTER_LINEAR),
                                   rtol=1e-5, atol=1e-5)


def _within_one(got, ref, share):
    d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert got.shape == ref.shape and d.max() <= 1
    assert np.mean(d == 0) >= share, f"{np.mean(d == 0):.6f} equal"


def test_euroc_constants_are_the_jax_packages():
    for k in ("K_L", "D_L", "R_L", "P_L", "K_R", "D_R", "R_R", "P_R"):
        np.testing.assert_array_equal(getattr(teuroc, k), getattr(jeuroc, k))
    assert teuroc.EUROC_INTRINSICS == jeuroc.EUROC_INTRINSICS


@pytest.mark.parametrize("side", [0, 1])
def test_rectify_map_and_remap_match_cv2(side):
    K, D, R, P = [(teuroc.K_L, teuroc.D_L, teuroc.R_L, teuroc.P_L),
                  (teuroc.K_R, teuroc.D_R, teuroc.R_R, teuroc.P_R)][side]
    mx, my = imageio.init_undistort_rectify_map(K, D, R, P[:3, :3], (752, 480))
    rx, ry = cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (752, 480), cv2.CV_32F)
    assert mx.dtype == np.float32 and mx.shape == (480, 752)
    assert np.abs(mx - rx).max() < 1e-3 and np.abs(my - ry).max() < 1e-3
    img = _smooth(480, 752, 3, seed=side)
    ref = cv2.remap(img, rx, ry, interpolation=cv2.INTER_LINEAR)
    _within_one(imageio.remap(img, mx, my), ref, 0.9999)
    remap = teuroc.rect_remaps()[side]
    _within_one(remap(img), ref, 0.9999)
    # one grey channel gives each channel of the replicated image
    grey = np.repeat(img[..., :1], 3, axis=2)
    np.testing.assert_array_equal(remap(img[..., :1])[..., 0], remap(grey)[..., 1])


def test_remap_border_and_far_off_taps():
    """Taps off the image read 0, however far off the map points."""
    img = _smooth(30, 40, 3)
    ys, xs = np.mgrid[0:25, 0:35].astype(np.float32)
    mx = (xs * 1.3 - 3.7).astype(np.float32)
    my = (ys * 1.4 - 4.2).astype(np.float32)
    mx[0, :5] = [-1e4, 1e4, -0.5, 39.5, np.float32(39.99)]
    ref = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    _within_one(imageio.remap(img, mx, my), ref, 0.9999)


CALIBS = {
    "tum_fr1": (np.array([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1.0]]),
                np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633]), (480, 640)),
    "generic5": (np.array([[300.0, 0, 161.3], [0, 305.0, 118.9], [0, 0, 1.0]]),
                 np.array([-0.21, 0.05, 0.001, -0.002, -0.004]), (240, 320)),
}


@pytest.mark.parametrize("name", sorted(CALIBS))
def test_undistort_matches_cv2(name):
    K, D, (h, w) = CALIBS[name]
    img = _smooth(h, w, 3, seed=3)
    ref = cv2.undistort(img, K, D)
    _within_one(imageio.undistort(img, K, D), ref, 0.9999)
    table = imageio.undistort_remap(K, D, (w, h))
    _within_one(table(img), ref, 0.9999)
