"""EuRoC MAV streams with stereo rectification (mirror of data/euroc.py).

The camera calibration constants are the EuRoC dataset's published sensor
parameters (also hardcoded in reference evaluation_scripts/test_euroc.py:
26-76 and droid_slam/loop_detect.py:27-159).
"""
import glob
import os

import numpy as np

from .imageio import Remap, init_undistort_rectify_map, read_bgr, resize

# EuRoC cam0/cam1 factory calibration (public dataset constants)
K_L = np.array([458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]).reshape(3, 3)
D_L = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
R_L = np.array([
    0.999966347530033, -0.001422739138722922, 0.008079580483432283,
    0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
    -0.008089410156878961, -0.007044357138835809, 0.9999424675829176,
]).reshape(3, 3)
P_L = np.array([435.2046959714599, 0, 367.4517211914062, 0,
                0, 435.2046959714599, 252.2008514404297, 0,
                0, 0, 1, 0]).reshape(3, 4)

K_R = np.array([457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]).reshape(3, 3)
D_R = np.array([-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0])
R_R = np.array([
    0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
    0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
    -0.007729688520722713, 0.007064130529506649, 0.999945173484644,
]).reshape(3, 3)
P_R = np.array([435.2046959714599, 0, 367.4517211914062, -47.90639384423901,
                0, 435.2046959714599, 252.2008514404297, 0,
                0, 0, 1, 0]).reshape(3, 4)

EUROC_INTRINSICS = [435.2046959714599, 435.2046959714599, 367.4517211914062, 252.2008514404297]
RAW_SIZE = (480, 752)  # (ht0, wd0)


def rect_remaps():
    """The left and right rectification of the raw 752x480 frames, each a
    ``Remap`` built once (the maps are fixed for a sequence)."""
    return tuple(Remap(*init_undistort_rectify_map(K, D, R, P[:3, :3], (752, 480)), (752, 480))
                 for K, D, R, P in ((K_L, D_L, R_L, P_L), (K_R, D_R, R_R, P_R)))


def euroc_stream(datapath, image_size=(320, 512), stereo=False, stride=1):
    """Rectified (stereo) stream (reference test_euroc.py:25-76): yields
    (stride * t, image, intrinsics), image [H, W, 3] uint8 BGR or
    [2, H, W, 3] (left, right).

    datapath: .../<sequence>/mav0 directory containing cam0/data, cam1/data.
    A grey frame is rectified and resized on its one channel, then
    replicated: the same bytes as doing it on three.
    """
    remap_l, remap_r = rect_remaps()
    ht0, wd0 = RAW_SIZE
    ht1, wd1 = image_size

    images_left = sorted(glob.glob(os.path.join(datapath, "cam0/data/*.png")))[::stride]
    images_right = [x.replace("cam0", "cam1") for x in images_left]

    sx, sy = wd1 / wd0, ht1 / ht0
    intrinsics = np.array(
        [EUROC_INTRINSICS[0] * sx, EUROC_INTRINSICS[1] * sy,
         EUROC_INTRINSICS[2] * sx, EUROC_INTRINSICS[3] * sy], np.float32
    )

    for t, (imgL, imgR) in enumerate(zip(images_left, images_right)):
        if stereo and not os.path.isfile(imgR):
            continue
        frames = [remap_l(read_bgr(imgL))]
        if stereo:
            frames.append(remap_r(read_bgr(imgR)))
        frames = [np.repeat(f, 3 // f.shape[2], axis=2)
                  for f in (resize(f, (wd1, ht1)) for f in frames)]
        image = np.stack(frames) if stereo else frames[0]
        yield stride * t, image, intrinsics


def euroc_timestamps(datapath, stride=1):
    """Timestamps (ns filenames) of cam0 frames."""
    files = sorted(glob.glob(os.path.join(datapath, "cam0/data/*.png")))[::stride]
    return [float(os.path.basename(f)[:-4]) for f in files]
