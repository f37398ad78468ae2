"""DroidNet container: fnet + cnet + update operator, and a seeded initializer.

The container exists for its ``state_dict`` names, which are the upstream
checkpoint's (``fnet.layer1.0.conv1.weight``, ``update.gru.convq.bias``,
...); the training forward waits for a later slice.
"""
import math

import torch
from torch import nn

from .extractor import BasicEncoder
from .update import UpdateModule

# ImageNet normalisation (reference droid_net.py:160-163)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()


def init_params(seed=0):
    """Seeded random weights as a state_dict (CPU tensors).

    Every conv weight and bias is uniform in +-1/sqrt(fan_in), PyTorch's
    default Conv2d bound, drawn from one ``torch.Generator`` in
    ``state_dict`` order, so a seed gives the same weights on every host.
    """
    gen = torch.Generator().manual_seed(seed)
    sd = DroidNet().state_dict()
    out = {}
    for k, v in sd.items():
        conv = k.rsplit(".", 1)[0]
        fan_in = math.prod(sd[conv + ".weight"].shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        out[k] = (torch.rand(v.shape, generator=gen) * 2.0 - 1.0) * bound
    return out
