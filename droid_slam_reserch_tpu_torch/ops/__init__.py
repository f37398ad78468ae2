"""Correlation and BA-block functions.  Each kernel wrapper launches its
hand-written CUDA kernel for CUDA tensors and runs its plain PyTorch version
for CPU tensors:

- K1 ``cuda_ba.ba_system_blocks``  (plain: ``cuda_ba.build_system_blocks``)
- K2 ``cuda_corr.corr_build``      (plain: ``cuda_corr.corr_build_plain``)
- K3 ``cuda_corr.corr_lookup``     (plain: ``cuda_corr.corr_lookup_plain``)
- K4 ``cuda_corr.corr_build_windows``  (plain: ``cuda_corr.corr_build_windows_plain``)
- K5 ``cuda_corr.corr_lookup_windows`` (plain: ``cuda_corr.corr_lookup_windows_plain``)
- K6 ``cuda_corr.corr_lookup_pmajor``  (plain: ``cuda_corr.corr_lookup_pmajor_plain``)
- K7 ``cuda_corr.corr_extract_windows`` (plain: ``cuda_corr.corr_extract_windows_plain``)
- K8 ``cuda_corr.corr_build_windows_levels``
  (plain: ``cuda_corr.corr_build_windows_levels_plain``)
- ``cuda_conv.conv3x3``, the update operator's 3x3 convolutions (plain:
  ``cuda_conv.conv3x3_plain``, ``F.conv2d``); replaces no TPU kernel

K2-K8 also have bf16 instantiations (``cuda_corr.INSTANCES``): K2
``corr_build_bf16`` (bf16 levels) and ``corr_build_bf16_f32`` (fp32 levels),
``corr_lookup_bf16``, ``corr_build_windows_bf16``,
``corr_lookup_windows_bf16``, ``corr_lookup_pmajor_bf16``,
``corr_extract_windows_bf16`` and ``corr_build_windows_levels_bf16``, each
counted under its own name.

``pack_pyramid`` / ``packed_lookup`` (plain PyTorch, ops/corr.py) are the
JAX package's exports of the same names; no kernel and no engine path use
them.
"""
from .corr import pack_pyramid, packed_lookup
from .cuda_ba import ba_system_blocks, build_system_blocks
from .cuda_conv import conv3x3, conv3x3_plain
from .cuda_corr import (
    INSTANCES,
    corr_build,
    corr_build_plain,
    corr_build_windows,
    corr_build_windows_levels,
    corr_build_windows_levels_plain,
    corr_build_windows_plain,
    corr_extract_windows,
    corr_extract_windows_plain,
    corr_lookup,
    corr_lookup_plain,
    corr_lookup_pmajor,
    corr_lookup_pmajor_plain,
    corr_lookup_windows,
    corr_lookup_windows_plain,
)

_WRAPPERS = {
    "corr_build": (corr_build, corr_build_plain),
    "corr_lookup": (corr_lookup, corr_lookup_plain),
    "corr_build_windows": (corr_build_windows, corr_build_windows_plain),
    "corr_lookup_windows": (corr_lookup_windows, corr_lookup_windows_plain),
    "corr_lookup_pmajor": (corr_lookup_pmajor, corr_lookup_pmajor_plain),
    "corr_extract_windows": (corr_extract_windows, corr_extract_windows_plain),
    "corr_build_windows_levels": (corr_build_windows_levels, corr_build_windows_levels_plain),
}
# every kernel instantiation by name -> (its wrapper, its plain version)
KERNELS = {"ba_blocks": (ba_system_blocks, build_system_blocks)}
KERNELS.update({name: pair for kernel, pair in _WRAPPERS.items() for name in INSTANCES[kernel]})
KERNELS["conv3x3"] = (conv3x3, conv3x3_plain)


def reset_counts():
    """Set every instantiation's launch count and its plain version's call count to 0."""
    for name, (wrapper, plain) in KERNELS.items():
        wrapper.launches[name] = 0
        plain.calls[name] = 0


def counts():
    """{instantiation: (kernel launches, plain calls)}."""
    return {name: (w.launches[name], p.calls[name]) for name, (w, p) in KERNELS.items()}


__all__ = [k for k in dir() if not k.startswith("_")]
