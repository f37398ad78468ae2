"""Network entry points used by the engine (mirror of engine/net_ops.py).

The networks compute in the dtype of their weights (the compute dtype):
images are normalised in fp32 and then cast, and the update operator's
correlation and motion inputs are cast to the dtype of its hidden state.
"""
import torch
import torch.nn.functional as F

from ..models.droidnet import normalize_images
from ..utils.timing import section

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name):
    """The torch dtype of a ``DroidConfig.compute_dtype`` value; raises
    ValueError for any other value, as the JAX package's lookup fails."""
    try:
        return COMPUTE_DTYPES[name]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, "
                         f"got {name!r}") from None


def _weights_dtype(encoder):
    return encoder.conv1.weight.dtype


def fnet_apply(net, images):
    """images [B, H, W, 3] BGR 0-255 -> fmaps [B, H/8, W/8, 128]."""
    with section("encode"):
        return net.fnet(normalize_images(images).to(_weights_dtype(net.fnet)))


def cnet_apply(net, images):
    """images [B, H, W, 3] -> (net tanh, inp relu), each [B, H/8, W/8, 128]."""
    with section("encode"):
        ctx = net.cnet(normalize_images(images).to(_weights_dtype(net.cnet)))
        return torch.tanh(ctx[..., :128]), F.relu(ctx[..., 128:])


def update_apply(update, net, inp, corr, motn, kk=None, num_segments=None, emask=None):
    """The factor graph's update seam: ``update`` is the UpdateModule (the
    oracle tests pass their own function with this signature).  corr and
    motn are cast to the dtype of the hidden state ``net``."""
    return update(net, inp, corr.to(net.dtype), motn.to(net.dtype), kk, num_segments, emask)
