"""The port's arithmetic-coded JPEG decoding (SOF9 sequential, SOF10
progressive; data/jpeg.py) against OpenCV's libjpeg-turbo and against the
port's own baseline decoding.

The files are written by tests/torch_jpeg_encoder.py (jcarith.c's QM
encoder) from the quantised coefficients of a baseline JPEG, so each must
decode to exactly the baseline file's samples: a check that needs no cv2.

- the committed fixtures of tests/data/jpeg_arith/ (the ETH3D frames of
  tests/data/jpeg/ as SOF9 and as SOF10 with libjpeg's simple progression):
  exactly cv2.imread of each, the port's decode of the baseline frame, and
  the digests of tests/data/jpeg_arith.json;
- small frames at 4:4:4, 4:2:2, 4:2:0 and grey, sequential and progressive,
  with DAC markers that set non-default L, U and Kx for each conditioning
  table, and with restart intervals (1 and 3 MCUs): exactly cv2.imread and
  the baseline decode;
- a progressive script whose last scans never refine AC 10-63 (libjpeg
  smooths no block for it): exactly cv2.imread.
"""
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from droid_slam_reserch_tpu_torch.data import imageio, jpeg
from torch_jpeg_encoder import encode_arith

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FIXTURES = os.path.join(DATA, "jpeg_arith")
BASELINE = os.path.join(DATA, "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, "grey": None}
DACS = {"default": None,
        "dac": {"dc0": (2, 5), "dc1": (1, 3), "ac0": 10, "ac1": 2},
        "dac-extreme": {"dc0": (0, 0), "dc1": (5, 15), "ac0": 1, "ac1": 63}}


def _texture(h, w, c=3, seed=0):
    rng = np.random.RandomState(seed)
    img = cv2.GaussianBlur(rng.randint(0, 256, (h, w, c), dtype=np.uint8), (5, 5), 1.2)
    return img.reshape(h, w, c) if c > 1 else img.reshape(h, w)


def _cv2_decode(blob):
    img = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED)
    assert img is not None
    return img[..., None] if img.ndim == 2 else img


def test_committed_arith_fixtures_match_cv2_and_baseline():
    with open(FIXTURES + ".json") as f:
        digests = json.load(f)
    files = sorted(os.listdir(FIXTURES))
    assert files == sorted(digests) and len(files) == 12
    for name in files:
        path = os.path.join(FIXTURES, name)
        with open(path, "rb") as f:
            sof = b"\xff\xca" if name.endswith("_prog.jpg") else b"\xff\xc9"
            assert sof in f.read()
        got = imageio.imread(path)
        np.testing.assert_array_equal(got, cv2.imread(path))
        base = imageio.imread(os.path.join(BASELINE, name.rsplit("_", 1)[0] + ".jpg"))
        np.testing.assert_array_equal(got, base)
        assert {"sha256": hashlib.sha256(got.tobytes()).hexdigest(), "shape": list(got.shape),
                "dtype": str(got.dtype)} == digests[name]


@pytest.mark.parametrize("dac", sorted(DACS))
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
def test_arith_matches_cv2_and_baseline(progressive, sampling, dac):
    for k, ((h, w), quality, restart) in enumerate((((37, 53), 50, 0), ((9, 17), 95, 1),
                                                    ((24, 40), 80, 3))):
        params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        if SAMPLING[sampling] is not None:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        ok, buf = cv2.imencode(".jpg", _texture(h, w, 1 if sampling == "grey" else 3, seed=k),
                               params)
        coefs = jpeg.read_coefficients(buf.tobytes())
        blob = encode_arith(coefs, progressive=progressive, restart=restart, dac=DACS[dac])
        got = jpeg.decode(blob)
        np.testing.assert_array_equal(got, _cv2_decode(blob))
        np.testing.assert_array_equal(got, jpeg.decode(buf.tobytes()))


def test_arith_progressive_without_high_refinement_matches_cv2():
    """Coefficients 10-63 keep their last bit unknown: libjpeg's smoothing
    looks at coefficients 0-9 only, so the image decodes unsmoothed."""
    ok, buf = cv2.imencode(".jpg", _texture(40, 56, seed=5), [cv2.IMWRITE_JPEG_QUALITY, 95])
    script = [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 9, 0, 0), ([0], 10, 63, 0, 1),
              ([1], 1, 63, 0, 0), ([2], 1, 63, 0, 0)]
    blob = encode_arith(jpeg.read_coefficients(buf.tobytes()), progressive=True, script=script)
    np.testing.assert_array_equal(jpeg.decode(blob), _cv2_decode(blob))
