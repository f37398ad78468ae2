"""Inputs made from the seed: the frames of a traffic mix and the weights.

Frames: a smoothed random texture panning ``pan_px`` pixels a frame
(uint8 BGR, three equal channels); a stereo frame is the pair [2, H, W, 3]
whose right view is cut ``stereo_disparity_px`` further along the pan; an
RGB-D frame carries a smooth depth of ``depth_m`` metres panning with the
texture.  Every seed gives the same sizes, pan and depth range; only the
texture differs.

Weights: DROID-SLAM's parameters in ``state_dict`` order, each uniform in
+-1/sqrt(fan_in) (PyTorch's Conv2d default, as the port's ``init_params``
draws them), drawn in one call on the device from a ``torch.Generator``
seeded with the run's seed.
"""
import math

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


class Frames:
    """Up to ``count`` frames of one seeded sequence, cut on demand."""

    def __init__(self, seed, count, image_size, mix, stereo, rgbd):
        H, W = image_size
        self.count, self.H, self.W = count, H, W
        self.step = int(mix["pan_px"])
        self.shift = int(mix["stereo_disparity_px"]) if stereo else None
        rng = np.random.default_rng([seed, 0])
        width = W + self.step * count + 8 + (self.shift or 0)
        base = gaussian_filter(rng.random((H + 8, width)), float(mix["texture_blur_px"]))
        self.base = ((base - base.min()) / (base.max() - base.min()) * 255.0).astype(np.float32)
        self.depth = None
        if rgbd:
            lo, hi = mix["depth_m"]
            rng = np.random.default_rng([seed, 1])
            d = gaussian_filter(rng.random((H + 8, W + self.step * count + 8)),
                                float(mix["depth_blur_px"]))
            self.depth = (lo + (hi - lo) * (d - d.min()) / (d.max() - d.min())).astype(np.float32)

    def _view(self, t, dx):
        x0 = 4 + self.step * t + dx
        return np.repeat(self.base[4:4 + self.H, x0:x0 + self.W, None], 3, -1).astype(np.uint8)

    def image(self, t):
        """Frame t: [H, W, 3] uint8, or the stereo pair [2, H, W, 3]."""
        if t >= self.count:
            raise IndexError(f"frame {t} is past the {self.count} frames made")
        if self.shift is None:
            return self._view(t, 0)
        return np.stack([self._view(t, 0), self._view(t, self.shift)])

    def depth_map(self, t):
        """Frame t's depth [H, W] float32 in metres, or None without a sensor."""
        if self.depth is None:
            return None
        x0 = 4 + self.step * t
        return self.depth[4:4 + self.H, x0:x0 + self.W].copy()


def weights(seed, device, template):
    """A state_dict like ``template`` (names and shapes), uniform in
    +-1/sqrt(fan_in) of each conv, fp32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(v.numel() for v in template.values())
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, o = {}, 0
    for k, v in template.items():
        conv = k.rsplit(".", 1)[0]
        bound = 1.0 / math.sqrt(math.prod(template[conv + ".weight"].shape[1:]))
        out[k] = (u[o:o + v.numel()] * bound).reshape(v.shape)
        o += v.numel()
    return out
