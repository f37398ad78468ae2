"""TartanAir: the training dataset and the evaluation stream (mirror of
the JAX package's data/tartan.py; reference data_readers/tartan.py and
evaluation_scripts/validate_tartanair.py:18-37)."""
import glob
import os.path as osp

import numpy as np

from .base import RGBDDataset
from .imageio import imread, resize

# TartanAir test-split environments (reference data_readers/tartan_test.txt)
TARTAN_TEST_SPLIT = [
    "abandonedfactory/abandonedfactory/Easy/P011",
    "abandonedfactory/abandonedfactory/Hard/P011",
    "abandonedfactory_night/abandonedfactory_night/Easy/P013",
    "abandonedfactory_night/abandonedfactory_night/Hard/P014",
    "amusement/amusement/Easy/P008",
    "amusement/amusement/Hard/P007",
    "carwelding/carwelding/Easy/P007",
    "endofworld/endofworld/Easy/P009",
    "gascola/gascola/Easy/P008",
    "gascola/gascola/Hard/P009",
    "hospital/hospital/Easy/P036",
    "hospital/hospital/Hard/P049",
    "japanesealley/japanesealley/Easy/P007",
    "japanesealley/japanesealley/Hard/P005",
    "neighborhood/neighborhood/Easy/P021",
    "neighborhood/neighborhood/Hard/P017",
    "ocean/ocean/Easy/P013",
    "ocean/ocean/Hard/P009",
    "office2/office2/Easy/P011",
    "office2/office2/Hard/P010",
    "office/office/Hard/P007",
    "oldtown/oldtown/Easy/P007",
    "oldtown/oldtown/Hard/P008",
    "seasidetown/seasidetown/Easy/P009",
    "seasonsforest/seasonsforest/Easy/P011",
    "seasonsforest/seasonsforest/Hard/P006",
    "seasonsforest_winter/seasonsforest_winter/Easy/P009",
    "seasonsforest_winter/seasonsforest_winter/Hard/P018",
    "soulcity/soulcity/Easy/P012",
    "soulcity/soulcity/Hard/P009",
    "westerndesert/westerndesert/Easy/P013",
    "westerndesert/westerndesert/Hard/P007",
]

# the fixed TartanAir camera at 640x480 (reference data_readers/tartan.py calib_read)
TARTAN_INTRINSICS = np.array([320.0, 320.0, 320.0, 240.0])


class TartanAir(RGBDDataset):
    """Scenes under ``datapath/*/*/*/*`` with image_left/*.png,
    depth_left/*.npy and pose_left.txt (NED [x y z qx qy qz qw])."""
    DEPTH_SCALE = 5.0  # balances rotation against translation

    def __init__(self, mode="training", **kwargs):
        self.mode = mode
        super().__init__(name="TartanAir", **kwargs)

    @staticmethod
    def is_test_scene(scene):
        return any(x in scene for x in TARTAN_TEST_SPLIT)

    def _build_dataset(self):
        scene_info = {}
        for scene in sorted(glob.glob(osp.join(self.root, "*/*/*/*"))):
            images = sorted(glob.glob(osp.join(scene, "image_left/*.png")))
            depths = sorted(glob.glob(osp.join(scene, "depth_left/*.npy")))
            if not images or len(images) != len(depths):
                continue
            poses = np.loadtxt(osp.join(scene, "pose_left.txt"), delimiter=" ")
            # NED -> the camera's xyz order
            poses = poses[:, [1, 2, 0, 4, 5, 3, 6]]
            poses[:, :3] /= TartanAir.DEPTH_SCALE
            intrinsics = [TartanAir.calib_read()] * len(images)
            graph = self.build_frame_graph(poses, depths, intrinsics)
            scene_info[scene] = {"images": images, "depths": depths, "poses": poses,
                                 "intrinsics": intrinsics, "graph": graph}
        return scene_info

    @staticmethod
    def calib_read():
        return TARTAN_INTRINSICS.copy()

    @staticmethod
    def depth_read(depth_file):
        depth = np.load(depth_file) / TartanAir.DEPTH_SCALE
        depth[np.isnan(depth)] = 1.0
        depth[np.isinf(depth)] = 1.0
        return depth


def tartan_stream(scene_path, stereo=False, stride=1, image_size=(384, 512)):
    """Evaluation stream over a TartanAir trajectory: frames are resized
    from the raw 480x640 to image_size and the fixed calibration is scaled
    accordingly (the reference's 0.8 factor for 384x512)."""
    images_left = sorted(glob.glob(osp.join(scene_path, "image_left/*.png")))[::stride]
    images_right = [x.replace("_left", "_right") for x in images_left]
    ht1, wd1 = image_size
    sx, sy = wd1 / 640.0, ht1 / 480.0
    intr = (TARTAN_INTRINSICS * np.array([sx, sy, sx, sy])).astype(np.float32)

    for t, (imgL, imgR) in enumerate(zip(images_left, images_right)):
        frames = [resize(imread(imgL), (wd1, ht1))]
        if stereo:
            frames.append(resize(imread(imgR), (wd1, ht1)))
        image = np.stack(frames) if stereo else frames[0]
        yield t, image, intr
