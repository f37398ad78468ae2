"""Write the JPEG fixtures of tests/data/jpeg/ with OpenCV.

    python tests/data/make_jpeg_fixtures.py

eth3d_000.jpg ... eth3d_005.jpg: ETH3D's raw 739x458 colour frames of a
smoothed random texture (a grey pattern under a slowly varying tint)
panning 4 px a frame (seed 0), as cv2.imwrite writes them at quality 80
(4:2:0): about 38 KB each.  chip_smoke.py tracks them with the port's
eth3d command, on a machine without OpenCV; tests/test_torch_jpeg.py holds
the port's decoder against cv2.imread on them.
"""
import os

import cv2
import numpy as np
from scipy.ndimage import gaussian_filter

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg")
H, W, N, STEP = 458, 739, 6, 4


def frames(n=N, seed=0):
    rng = np.random.RandomState(seed)
    shape = (H + 8, W + STEP * n + 8)
    lum = gaussian_filter(rng.rand(*shape), 4.0)
    tint = gaussian_filter(rng.rand(*shape, 3), (24.0, 24.0, 0.0))
    lum, tint = ((x - x.min()) / (x.max() - x.min()) for x in (lum, tint))
    base = 255.0 * (0.75 * lum[..., None] + 0.25 * tint)
    return [base[4:4 + H, 4 + STEP * t: 4 + STEP * t + W].astype(np.uint8) for t in range(n)]


def main():
    os.makedirs(OUT, exist_ok=True)
    for t, img in enumerate(frames()):
        cv2.imwrite(os.path.join(OUT, f"eth3d_{t:03d}.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 80])


if __name__ == "__main__":
    main()
