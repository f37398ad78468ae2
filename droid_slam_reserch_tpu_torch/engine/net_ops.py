"""Network entry points used by the engine (mirror of engine/net_ops.py)."""
import torch
import torch.nn.functional as F

from ..models.droidnet import IMAGE_MEAN, IMAGE_STD


def normalize_image(images):
    """[..., H, W, 3] BGR 0-255 -> normalized RGB (reference motion_filter.py:66-69)."""
    x = images.flip(-1) / 255.0
    mean = torch.tensor(IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def fnet_apply(net, images):
    """images [B, H, W, 3] BGR 0-255 -> fmaps [B, H/8, W/8, 128]."""
    return net.fnet(normalize_image(images))


def cnet_apply(net, images):
    """images [B, H, W, 3] -> (net tanh, inp relu), each [B, H/8, W/8, 128]."""
    ctx = net.cnet(normalize_image(images))
    return torch.tanh(ctx[..., :128]), F.relu(ctx[..., 128:])


def update_apply(update, net, inp, corr, motn, kk=None, num_segments=None, emask=None):
    """The factor graph's update seam: ``update`` is the UpdateModule (the
    oracle tests pass their own function with this signature)."""
    return update(net, inp, corr, motn, kk, num_segments, emask)
