"""TUM-RGBD fr1 stream (mirror of data/tum.py; reference
evaluation_scripts/test_tum.py:23-53).

Uses the published TUM freiburg1 intrinsics + distortion.
"""
import glob
import os

import numpy as np

from .imageio import imread, resize, undistort_remap

TUM_FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)
TUM_FR1_DIST = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def tum_timestamps(datapath, stride=2):
    """Epoch timestamps of the streamed frames, parsed from the TUM rgb
    filenames (<stamp>.png) — used to associate against groundtruth.txt by
    time rather than by index."""
    images_list = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    out = []
    for f in images_list:
        stem = os.path.splitext(os.path.basename(f))[0]
        try:
            out.append(float(stem))
        except ValueError:
            out.append(float(len(out)))
    return np.asarray(out, np.float64)


def tum_stream(datapath, stride=2, use_depth=False, image_size=(240, 320)):
    """Undistorted, resized fr1 stream; crops the distortion boundary.

    At the default image_size the protocol is the reference's exactly
    (resize 640x480 -> 352x256, crop 16/8 -> 320x240, test_tum.py:36-51);
    other sizes scale the resize + crop proportionally.  One undistortion
    table, built for the first frame's size, serves every frame."""
    fx, fy, cx, cy = TUM_FR1_INTRINSICS
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])

    ht1, wd1 = image_size
    cy_px = max(1, round(8 * ht1 / 240))    # 8 at the reference size
    cx_px = max(1, round(16 * wd1 / 320))   # 16 at the reference size
    H1, W1 = ht1 + 2 * cy_px, wd1 + 2 * cx_px

    images_list = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))[::stride]
    depth_list = sorted(glob.glob(os.path.join(datapath, "depth", "*.png")))[::stride]

    undistort = None
    for t, imfile in enumerate(images_list):
        image = imread(imfile)
        if undistort is None:
            undistort = undistort_remap(K, TUM_FR1_DIST, (image.shape[1], image.shape[0]))
        image = resize(undistort(image), (W1, H1))

        intr = np.array([fx, fy, cx, cy], np.float32)
        intr[0::2] *= W1 / 640.0
        intr[1::2] *= H1 / 480.0
        # crop distortion boundary (reference :48-51)
        intr[2] -= cx_px
        intr[3] -= cy_px
        image = image[cy_px:-cy_px, cx_px:-cx_px]

        if use_depth and t < len(depth_list):
            depth = imread(depth_list[t], anydepth=True) / 5000.0
            depth = resize(depth, (W1, H1), interp="nearest")
            depth = depth[cy_px:-cy_px, cx_px:-cx_px]
            yield t, image, depth, intr
        else:
            yield t, image, intr
