"""Generic image streams (mirror of data/streams.py; reference demo.py:47-78)."""
import os

import numpy as np

from .imageio import imread, resize, undistort_remap


def resize_to_area(image, target_area=384 * 512):
    """Resize keeping the aspect so h * w ~= target_area, then crop to
    multiples of 8 (reference demo.py:66-71).  Returns the image and the
    scale factors (sx, sy)."""
    h0, w0 = image.shape[:2]
    s = np.sqrt(target_area / (h0 * w0))
    h1, w1 = int(h0 * s), int(w0 * s)
    image = resize(image, (w1, h1))
    image = image[: h1 - h1 % 8, : w1 - w1 % 8]
    return image, (w1 / w0, h1 / h0)


def generic_image_stream(imagedir, calib, stride=1, target_area=384 * 512):
    """Calibrated image-directory stream (reference demo.py:47-78): yields
    (t, image [H, W, 3] uint8 BGR, intrinsics [4]).

    calib: path to a text file "fx fy cx cy [k1 k2 p1 p2 [k3]]".  With
    distortion coefficients every frame is undistorted by one table, built
    for the first frame's size.
    """
    calib = np.loadtxt(calib, delimiter=" ").reshape(-1)
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0], K[0, 2], K[1, 1], K[1, 2] = fx, cx, fy, cy

    undistort = None
    image_list = sorted(os.listdir(imagedir))[::stride]
    for t, imfile in enumerate(image_list):
        image = imread(os.path.join(imagedir, imfile))
        if len(calib) > 4:
            if undistort is None:
                undistort = undistort_remap(K, calib[4:], (image.shape[1], image.shape[0]))
            image = undistort(image)
        image, (sx, sy) = resize_to_area(image, target_area)
        intrinsics = np.array([fx * sx, fy * sy, cx * sx, cy * sy], np.float32)
        yield t, image, intrinsics
