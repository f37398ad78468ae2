"""The port's progressive Huffman JPEG decoding (SOF2, data/jpeg.py) against
OpenCV's libjpeg-turbo.

- progressive JPEGs that cv2.imwrite writes (libjpeg's simple progression:
  DC first and refine scans, spectral selection, successive approximation
  with AC refine scans and end-of-band runs) at quality 50 and 95, at 4:4:4,
  4:2:2 and 4:2:0 chroma, grey, with a restart interval, at small and odd
  sizes: exactly cv2.imread;
- the committed fixtures of tests/data/jpeg_progressive/ (cv2's progressive
  versions of the ETH3D frames of tests/data/jpeg/): exactly cv2.imread,
  and the digests of tests/data/jpeg_progressive.json;
- eth3d_stream over progressive color/*.jpg: the JAX package's frames and
  intrinsics, exactly.
"""
import hashlib
import json
import os
import shutil

import cv2
import numpy as np
import pytest

from droid_slam_reserch_tpu.data import eth3d as jeth3d
from droid_slam_reserch_tpu_torch.data import eth3d as teth3d
from droid_slam_reserch_tpu_torch.data import imageio, jpeg

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "jpeg_progressive")
SIZES = [(64, 80), (37, 53), (9, 17)]
KINDS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
         "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "grey": None, "restart": None}


def _texture(h, w, c=3, seed=0):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, c), dtype=np.uint8), (5, 5), 1.2)
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)


def _is_progressive(path):
    with open(path, "rb") as f:
        return b"\xff\xc2" in f.read()


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("quality", [50, 95])
def test_progressive_matches_cv2(tmp_path, quality, kind):
    for k, (h, w) in enumerate(SIZES):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if KINDS[kind] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, KINDS[kind]]
        if kind == "restart":
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
        path = str(tmp_path / f"p{k}.jpg")
        cv2.imwrite(path, _texture(h, w, 1 if kind == "grey" else 3, seed=k), params)
        assert _is_progressive(path)
        np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))
        if kind == "grey":
            np.testing.assert_array_equal(imageio.read_bgr(path)[..., 0],
                                          cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_committed_progressive_fixtures_match_cv2():
    with open(FIXTURES + ".json") as f:
        digests = json.load(f)
    files = sorted(os.listdir(FIXTURES))
    assert files == sorted(digests) and len(files) == 6
    for name in files:
        path = os.path.join(FIXTURES, name)
        assert _is_progressive(path)
        got = imageio.imread(path)
        np.testing.assert_array_equal(got, cv2.imread(path))
        assert {"sha256": hashlib.sha256(got.tobytes()).hexdigest(), "shape": list(got.shape),
                "dtype": str(got.dtype)} == digests[name]


def test_eth3d_stream_on_progressive_jpegs_matches_jax(tmp_path):
    """ETH3D's color/*.jpg layout, progressive frames: the port's frames and
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


def test_progressive_coefficients_equal_baseline():
    """cv2 re-encodes a decoded frame; its progressive and baseline writes
    at the same quality hold the same quantised coefficients."""
    img = _texture(48, 72, seed=3)
    ok, base = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                          cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    a, b = jpeg.read_coefficients(base.tobytes()), jpeg.read_coefficients(prog.tobytes())
    for ca, cb in zip(a.comps, b.comps):
        np.testing.assert_array_equal(ca.blocks, cb.blocks)
        np.testing.assert_array_equal(ca.q, cb.q)
