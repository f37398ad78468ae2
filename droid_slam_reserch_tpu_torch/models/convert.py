"""JAX parameter pytree -> the port's state_dict.

The JAX package names its Flax parameters ``fnet/layer1_0/conv1/kernel``
(HWIO); the port uses the upstream torch names ``fnet.layer1.0.conv1.weight``
(OIHW).  This is the inverse of the JAX package's torch-checkpoint
converter, so the same weights run in both packages.
"""
import numpy as np
import torch

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
