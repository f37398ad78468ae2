"""Networks of the port as nn.Modules, with upstream parameter names."""
from .convert import load_weights, params_from_jax, state_dict_from_torch
from .droidnet import IMAGE_MEAN, IMAGE_STD, DroidNet, init_params
from .extractor import BasicEncoder
from .gru import ConvGRU
from .update import GraphAgg, UpdateModule

__all__ = [k for k in dir() if not k.startswith("_")]
