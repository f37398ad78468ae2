"""ETH3D RGB-D stream (mirror of data/eth3d.py; reference test_eth3d.py:25-56)."""
import glob
import os

import numpy as np

from .imageio import imread, resize
from .streams import resize_to_area


def _image_list(datapath):
    """rgb/*.png, else color/*.jpg (which ``imread`` refuses: no JPEG decoder)."""
    image_list = sorted(glob.glob(os.path.join(datapath, "rgb", "*.png")))
    return image_list or sorted(glob.glob(os.path.join(datapath, "color", "*.jpg")))


def eth3d_stream(datapath, use_depth=False, stride=1, target_area=384 * 512):
    fx, fy, cx, cy = np.loadtxt(os.path.join(datapath, "calibration.txt")).tolist()
    image_list = _image_list(datapath)[::stride]
    depth_list = sorted(glob.glob(os.path.join(datapath, "depth", "*.png")))[::stride]

    for t, image_file in enumerate(image_list):
        image, (sx, sy) = resize_to_area(imread(image_file), target_area=target_area)
        intr = np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)

        if use_depth and t < len(depth_list):
            depth = imread(depth_list[t], anydepth=True) / 1000.0
            h1, w1 = image.shape[:2]
            depth = resize(depth, (w1, h1), interp="nearest")
            yield t, image, depth.astype(np.float32), intr
        else:
            yield t, image, intr


def eth3d_timestamps(datapath, stride=1):
    """Frame timestamps parsed from the rgb filenames (<stamp>.png)."""
    out = []
    for f in _image_list(datapath)[::stride]:
        stem = os.path.splitext(os.path.basename(f))[0]
        try:
            out.append(float(stem))
        except ValueError:
            out.append(float(len(out)))
    return out
