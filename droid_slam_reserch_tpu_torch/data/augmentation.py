"""Training augmentation (mirror of the JAX package's data/augmentation.py):
colour jitter, random scale and centre crop with the intrinsics adjusted.

The rng is drawn in the JAX package's order, so a seeded augmentor gives
its arrays; the resizes are ``imageio.resize`` (OpenCV's INTER_LINEAR on
float images, INTER_NEAREST on disparities).
"""
import numpy as np

from .imageio import resize


class RGBDAugmentor:
    def __init__(self, crop_size=(384, 512), max_scale=0.25, rng=None):
        self.crop_size = crop_size
        self.max_scale = max_scale
        self.rng = rng or np.random.default_rng()

    def color_transform(self, images):
        """Brightness, contrast, saturation jitter and a random grayscale,
        shared by every frame.  images [N, H, W, 3] BGR float 0-255."""
        rng = self.rng
        x = images.astype(np.float32)
        b = rng.uniform(0.75, 1.25)
        c = rng.uniform(0.75, 1.25)
        s = rng.uniform(0.75, 1.25)
        x = x * b
        mean = x.mean(axis=(1, 2, 3), keepdims=True)
        x = (x - mean) * c + mean
        gray = x.mean(axis=-1, keepdims=True)
        x = (x - gray) * s + gray
        if rng.random() < 0.1:
            x = np.repeat(x.mean(axis=-1, keepdims=True), 3, axis=-1)
        return np.clip(x, 0, 255)

    def spatial_transform(self, images, poses, disps, intrinsics):
        """A random scale, then the centre crop."""
        N, ht, wd = images.shape[:3]
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / ht, (cw + 1) / wd))
        scale = 2 ** self.rng.uniform(min_scale, self.max_scale)

        h1, w1 = int(round(ht * scale)), int(round(wd * scale))
        images = np.stack([resize(im, (w1, h1), "linear") for im in images])
        disps = np.stack([resize(d, (w1, h1), "nearest") for d in disps])
        intrinsics = intrinsics * np.array([w1 / wd, h1 / ht, w1 / wd, h1 / ht])

        y0 = (h1 - ch) // 2
        x0 = (w1 - cw) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0])
        images = images[:, y0: y0 + ch, x0: x0 + cw]
        disps = disps[:, y0: y0 + ch, x0: x0 + cw]
        return images, poses, disps, intrinsics

    def __call__(self, images, poses, disps, intrinsics):
        images = self.color_transform(images)
        return self.spatial_transform(images, poses, disps, intrinsics)
