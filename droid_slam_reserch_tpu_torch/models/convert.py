"""Weights from elsewhere -> the port's state_dict.

- ``params_from_jax``: the JAX package names its Flax parameters
  ``fnet/layer1_0/conv1/kernel`` (HWIO); the port uses the upstream torch
  names ``fnet.layer1.0.conv1.weight`` (OIHW).  This is the inverse of the
  JAX package's torch-checkpoint converter, so the same weights run in both
  packages.
- ``state_dict_from_torch``: an upstream ``droid.pth`` state_dict (the JAX
  package's models/convert.py:58-126 ingests the same file): the
  DataParallel ``module.`` prefix stripped, the update operator's weight and
  delta heads cut from 3 output channels to the 2 that inference uses, and
  the GRU's convz/convr stacked into the port's single convzr.
- ``load_weights``: ``DroidConfig.weights`` as the JAX package reads it
  (its engine/droid.py:26-35): a ``.pth``/``.pt`` is such a state_dict, any
  other file an ``.npz`` of JAX params under "params".
"""
import os
import warnings

import numpy as np
import torch

from .droidnet import DroidNet

_UPDATE_NAMES = {
    "corr_enc1": "corr_encoder.0",
    "corr_enc2": "corr_encoder.2",
    "flow_enc1": "flow_encoder.0",
    "flow_enc2": "flow_encoder.2",
    "weight1": "weight.0",
    "weight2": "weight.2",
    "delta1": "delta.0",
    "delta2": "delta.2",
    "gru/convzr": "gru.convzr",
    "gru/convq": "gru.convq",
    "gru/w": "gru.w",
    "gru/convzr_glo": "gru.convzr_glo",
    "gru/convq_glo": "gru.convq_glo",
    "agg/conv1": "agg.conv1",
    "agg/conv2": "agg.conv2",
    "agg/eta0": "agg.eta.0",
    "agg/upmask0": "agg.upmask.0",
}


def _encoder_name(path):
    """'layer2_0/downsample' -> 'layer2.0.downsample.0'; 'conv1' -> 'conv1'."""
    parts = path.split("/")
    if len(parts) == 1:
        return parts[0]
    layer, blk = parts[0].rsplit("_", 1)
    conv = "downsample.0" if parts[1] == "downsample" else parts[1]
    return f"{layer}.{blk}.{conv}"


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, v


def params_from_jax(params):
    """Flax params ({"fnet", "cnet", "update"}, optionally under "params")
    with numpy leaves -> the port's state_dict of float32 CPU tensors."""
    params = params.get("params", params)
    sd = {}
    for path, val in _leaves(params):
        module, rest = path.split("/", 1)
        conv_path, kind = rest.rsplit("/", 1)
        if module == "update":
            name = _UPDATE_NAMES[conv_path]
        else:
            name = _encoder_name(conv_path)
        val = np.asarray(val, np.float32)
        if kind == "kernel":
            sd[f"{module}.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(val.transpose(3, 2, 0, 1)))
        else:
            sd[f"{module}.{name}.bias"] = torch.from_numpy(val.copy())
    return sd


# heads trained with an extra channel; inference uses the first two
_SLICED_HEADS = ("update.weight.2", "update.delta.2")
_STACKED = (("update.gru.convz", "update.gru.convr", "update.gru.convzr"),
            ("update.gru.convz_glo", "update.gru.convr_glo", "update.gru.convzr_glo"))


def state_dict_from_torch(state_dict):
    """An upstream droid.pth state_dict -> the port's state_dict of float32
    CPU tensors.  Keys the port has no parameter for are dropped with a
    warning, as the JAX converter drops them."""
    sd = {k.replace("module.", ""): torch.as_tensor(v).detach().cpu().float()
          for k, v in state_dict.items()}
    for head in _SLICED_HEADS:
        if f"{head}.weight" in sd and sd[f"{head}.weight"].shape[0] == 3:
            sd[f"{head}.weight"] = sd[f"{head}.weight"][:2]
            sd[f"{head}.bias"] = sd[f"{head}.bias"][:2]
    for a, b, out in _STACKED:
        for kind in ("weight", "bias"):
            if f"{a}.{kind}" in sd and f"{b}.{kind}" in sd:
                sd[f"{out}.{kind}"] = torch.cat([sd.pop(f"{a}.{kind}"), sd.pop(f"{b}.{kind}")])
    names = DroidNet().state_dict().keys()
    unused = sorted(set(sd) - set(names))
    if unused:
        warnings.warn(f"unconverted checkpoint keys: {unused[:10]}...")
    return {k: sd[k].contiguous() for k in names if k in sd}


def load_weights(path):
    """The port's state_dict from ``DroidConfig.weights``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights checkpoint not found: {path} "
                                "(refusing to silently run with random weights)")
    if path.endswith((".pth", ".pt")):
        return state_dict_from_torch(torch.load(path, map_location="cpu", weights_only=True))
    with np.load(path, allow_pickle=True) as data:
        return params_from_jax(data["params"].item())
