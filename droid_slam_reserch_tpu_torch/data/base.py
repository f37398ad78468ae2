"""Training dataset base (mirror of the JAX package's data/base.py):
a pickle-cached scene index, each scene's flow-distance covisibility graph,
and the sampling walk that prefers forward frames with flow in [fmin, fmax].
"""
import os
import os.path as osp
import pickle

import numpy as np

from .augmentation import RGBDAugmentor
from .imageio import imread
from .rgbd_utils import compute_distance_matrix_flow


class RGBDDataset:
    """device: where the scene graphs' distance matrices are computed."""

    def __init__(self, name, datapath, n_frames=4, crop_size=(384, 512), fmin=8.0, fmax=75.0,
                 do_aug=True, cache_dir=None, rng=None, device="cpu"):
        self.root = datapath
        self.name = name
        self.n_frames = n_frames
        self.fmin = fmin
        self.fmax = fmax
        self.device = device
        self.rng = rng or np.random.default_rng()
        self.aug = RGBDAugmentor(crop_size=crop_size, rng=self.rng) if do_aug else None

        cache_dir = cache_dir or osp.join(osp.dirname(osp.abspath(__file__)), "cache")
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = osp.join(cache_dir, f"{self.name}.pickle")
        if osp.isfile(cache_path):
            with open(cache_path, "rb") as f:
                scene_info = pickle.load(f)[0]
        else:
            scene_info = self._build_dataset()
            with open(cache_path, "wb") as f:
                pickle.dump((scene_info,), f)
        self.scene_info = scene_info
        self._build_dataset_index()

    # subclasses override ---------------------------------------------------
    def _build_dataset(self):
        raise NotImplementedError

    @staticmethod
    def is_test_scene(scene):
        return False

    @staticmethod
    def image_read(image_file):
        return imread(image_file)

    @staticmethod
    def depth_read(depth_file):
        return np.load(depth_file)

    # -----------------------------------------------------------------------
    def _build_dataset_index(self):
        self.dataset_index = []
        for scene in self.scene_info:
            if not self.__class__.is_test_scene(scene):
                graph = self.scene_info[scene]["graph"]
                for i in graph:
                    if len(graph[i][0]) > self.n_frames:
                        self.dataset_index.append((scene, i))

    def build_frame_graph(self, poses, depths, intrinsics, f=16, max_flow=256):
        """Frame i's neighbours: the frames j with flow distance under max_flow."""
        def read_disp(fn):
            depth = self.__class__.depth_read(fn)[f // 2:: f, f // 2:: f]
            depth[depth < 0.01] = np.mean(depth)
            return 1.0 / depth

        poses = np.array(poses)
        intrinsics = np.array(intrinsics) / f
        disps = np.stack(list(map(read_disp, depths)), 0)
        d = f * compute_distance_matrix_flow(poses, disps, intrinsics, device=self.device)

        graph = {}
        for i in range(d.shape[0]):
            (j,) = np.where(d[i] < max_flow)
            graph[i] = (j, d[i, j])
        return graph

    def __getitem__(self, index):
        """An n_frames covisibility walk: (images, poses, disps, intrinsics),
        numpy float32, scale-normalised."""
        index = index % len(self.dataset_index)
        scene_id, ix = self.dataset_index[index]
        info = self.scene_info[scene_id]
        frame_graph = info["graph"]

        inds = [ix]
        while len(inds) < self.n_frames:
            j, d = frame_graph[ix]
            k = (d > self.fmin) & (d < self.fmax)
            frames = j[k]
            if np.count_nonzero(frames[frames > ix]):
                ix = self.rng.choice(frames[frames > ix])
            elif np.count_nonzero(frames):
                ix = self.rng.choice(frames)
            inds.append(ix)

        images = np.stack([self.__class__.image_read(info["images"][i])
                           for i in inds]).astype(np.float32)
        depths = np.stack([self.__class__.depth_read(info["depths"][i])
                           for i in inds]).astype(np.float32)
        poses = np.stack([info["poses"][i] for i in inds]).astype(np.float32)
        intrinsics = np.stack([info["intrinsics"][i] for i in inds]).astype(np.float32)

        disps = 1.0 / depths
        if self.aug is not None:
            images, poses, disps, intrinsics = self.aug(images, poses, disps, intrinsics)

        # scale normalisation
        if np.count_nonzero(disps > 0.01) > 0:
            s = disps[disps > 0.01].mean()
            disps = disps / s
            poses[..., :3] *= s

        return images, poses, disps, intrinsics

    def __len__(self):
        return len(self.dataset_index)
