"""The port's dataset streams against the JAX package's, frame by frame, on
tests/synth_scenes.py's fabricated datasets (and a depth track, a stereo
pair and a distorted generic sequence written here with cv2).

Each pair of streams yields the same number of frames with the same stamps;
intrinsics agree within rtol 1e-6, depth maps exactly, and images to
imageio's tolerances: resized frames exactly (OpenCV's fixed point is
replicated), remapped and undistorted ones within 1 on at least 99.99 % of
the values.
"""
import os

import cv2
import numpy as np
import pytest

from droid_slam_reserch_tpu import data as jdata
from droid_slam_reserch_tpu.data import euroc as jeuroc
from droid_slam_reserch_tpu.data import tum as jtum
from droid_slam_reserch_tpu_torch import data as tdata
from synth_scenes import (make_eth3d_sequence, make_euroc_sequence, make_tartanair_scene,
                          make_tum_sequence, textured_image)


def _assert_streams_match(jstream, tstream, remapped):
    jframes, tframes = list(jstream), list(tstream)
    assert len(tframes) == len(jframes) > 0
    for j, t in zip(jframes, tframes):
        assert len(t) == len(j)
        assert t[0] == j[0]
        np.testing.assert_allclose(t[-1], j[-1], rtol=1e-6)
        assert t[-1].dtype == j[-1].dtype
        img_t, img_j = t[1], j[1]
        assert img_t.shape == img_j.shape and img_t.dtype == img_j.dtype == np.uint8
        if remapped:
            d = np.abs(img_t.astype(np.int32) - img_j)
            assert d.max() <= 1 and np.mean(d == 0) >= 0.9999
        else:
            np.testing.assert_array_equal(img_t, img_j)
        if len(j) == 4:
            assert t[2].dtype == j[2].dtype
            np.testing.assert_array_equal(t[2], j[2])
    return tframes


@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_stream(tmp_path, stereo):
    mav0, _ = make_euroc_sequence(tmp_path / "MH", n_frames=3, stereo=stereo)
    for kw in ({}, {"image_size": (64, 96), "stride": 2}):
        frames = _assert_streams_match(jdata.euroc_stream(mav0, stereo=stereo, **kw),
                                       tdata.euroc_stream(mav0, stereo=stereo, **kw), True)
        h, w = kw.get("image_size", (320, 512))
        assert frames[0][1].shape == ((2, h, w, 3) if stereo else (h, w, 3))
    assert tdata.euroc_timestamps(mav0) == jeuroc.euroc_timestamps(mav0)
    assert tdata.euroc_timestamps(mav0, stride=2) == jeuroc.euroc_timestamps(mav0, stride=2)


def test_tum_stream_with_depth(tmp_path):
    root, _ = make_tum_sequence(tmp_path / "fr1", n_frames=6)
    os.makedirs(root / "depth")
    rng = np.random.RandomState(4)
    for f in sorted(os.listdir(root / "rgb")):
        cv2.imwrite(str(root / "depth" / f), (5000 + 3000 * rng.rand(480, 640)).astype(np.uint16))
    for kw in ({"use_depth": True}, {"use_depth": False, "image_size": (64, 96), "stride": 1}):
        frames = _assert_streams_match(jdata.tum_stream(str(root), **kw),
                                       tdata.tum_stream(str(root), **kw), True)
        assert len(frames[0]) == (4 if kw["use_depth"] else 3)
    np.testing.assert_array_equal(tdata.tum_timestamps(str(root)),
                                  jtum.tum_timestamps(str(root)))


def test_eth3d_stream_with_depth(tmp_path):
    root = make_eth3d_sequence(tmp_path / "eth3d", n_frames=4, with_depth=True)
    for kw in ({"use_depth": True}, {"use_depth": True, "target_area": 64 * 96, "stride": 2},
               {"use_depth": False}):
        frames = _assert_streams_match(jdata.eth3d_stream(str(root), **kw),
                                       tdata.eth3d_stream(str(root), **kw), False)
        if kw["use_depth"]:
            assert frames[0][2].dtype == np.float32 and frames[0][2].shape == frames[0][1].shape[:2]
    assert tdata.eth3d_timestamps(str(root)) == jdata.eth3d_timestamps(str(root))
    assert tdata.eth3d_timestamps(str(root), stride=3) == jdata.eth3d_timestamps(str(root), stride=3)


def test_eth3d_jpeg_is_refused_by_name(tmp_path):
    """A JPEG the port does not decode (lossless) is refused naming the
    file; baseline, progressive and arithmetic-coded JPEGs are decoded
    (tests/test_torch_jpeg*.py)."""
    os.makedirs(tmp_path / "color")
    np.savetxt(tmp_path / "calibration.txt", np.array([[100.0, 100.0, 80.0, 60.0]]))
    blob = bytearray(cv2.imencode(".jpg", textured_image(120, 160, 0,
                                                         np.random.RandomState(0)))[1].tobytes())
    blob[blob.find(b"\xff\xc0") + 1] = 0xC3           # the frame declared lossless
    with open(tmp_path / "color" / "100.0.jpg", "wb") as f:
        f.write(bytes(blob))
    assert tdata.eth3d_timestamps(str(tmp_path)) == jdata.eth3d_timestamps(str(tmp_path))
    with pytest.raises(NotImplementedError, match="100.0.jpg: lossless"):
        next(tdata.eth3d_stream(str(tmp_path)))


@pytest.mark.parametrize("stereo", [False, True])
def test_tartan_stream(tmp_path, stereo):
    scene = make_tartanair_scene(str(tmp_path / "P000"), n_frames=3, stereo=stereo)
    for kw in ({}, {"image_size": (64, 96), "stride": 2}):
        frames = _assert_streams_match(jdata.tartan_stream(scene, stereo=stereo, **kw),
                                       tdata.tartan_stream(scene, stereo=stereo, **kw), False)
        assert frames[0][1].ndim == (4 if stereo else 3)
    from droid_slam_reserch_tpu.data.tartan import TARTAN_TEST_SPLIT

    assert tdata.TARTAN_TEST_SPLIT == TARTAN_TEST_SPLIT


@pytest.mark.parametrize("coeffs", [0, 4, 5])
def test_generic_image_stream(tmp_path, coeffs):
    """demo's stream: a calibration with no, 4 or 5 distortion coefficients."""
    os.makedirs(tmp_path / "imgs")
    rng = np.random.RandomState(5)
    for t in range(3):
        cv2.imwrite(str(tmp_path / "imgs" / f"{t:04d}.png"), textured_image(120, 160, t, rng))
    calib = [120.0, 118.0, 81.0, 59.0, -0.2, 0.04, 0.001, -0.002, 0.01][: 4 + coeffs]
    np.savetxt(tmp_path / "calib.txt", np.asarray(calib)[None], delimiter=" ")
    for kw in ({}, {"target_area": 64 * 96, "stride": 2}):
        _assert_streams_match(
            jdata.generic_image_stream(str(tmp_path / "imgs"), str(tmp_path / "calib.txt"), **kw),
            tdata.generic_image_stream(str(tmp_path / "imgs"), str(tmp_path / "calib.txt"), **kw),
            coeffs > 0)
