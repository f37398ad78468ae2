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
"""
from .cuda_ba import ba_system_blocks, build_system_blocks
from .cuda_corr import (
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

KERNELS = {
    "ba_blocks": (ba_system_blocks, build_system_blocks),
    "corr_build": (corr_build, corr_build_plain),
    "corr_lookup": (corr_lookup, corr_lookup_plain),
    "corr_build_windows": (corr_build_windows, corr_build_windows_plain),
    "corr_lookup_windows": (corr_lookup_windows, corr_lookup_windows_plain),
    "corr_lookup_pmajor": (corr_lookup_pmajor, corr_lookup_pmajor_plain),
    "corr_extract_windows": (corr_extract_windows, corr_extract_windows_plain),
    "corr_build_windows_levels": (corr_build_windows_levels, corr_build_windows_levels_plain),
}


def reset_counts():
    """Set every kernel's launch count and every plain version's call count to 0."""
    for wrapper, plain in KERNELS.values():
        wrapper.launches = 0
        plain.calls = 0


def counts():
    """{name: (kernel launches, plain calls)}."""
    return {name: (w.launches, p.calls) for name, (w, p) in KERNELS.items()}


__all__ = [k for k in dir() if not k.startswith("_")]
