"""K2 (correlation build) and K3 (pyramid lookup): CUDA kernels and their
plain PyTorch versions.

The counterpart of the JAX package's ops/pallas_corr.py on the path the port
runs (corr_build_pmajor_pallas + corr_lookup_blocked_pallas).  For a CUDA
tensor each wrapper launches its hand-written kernel (csrc/corr_build.cu,
csrc/corr_lookup.cu) or raises; for a CPU tensor it runs the plain version.
``launches`` / ``calls`` count each, so a run can show which one it took.
"""
import torch

from . import build
from .corr import build_pyramid_flat, corr_lookup_pyramid_flat, corr_volume_flat

NUM_LEVELS = 4
RADIUS = 3


def corr_build_plain(f1, f2):
    """Plain K2: f1 [E, H1, W1, C], f2 [E, H2, W2, C] -> 4 levels
    [E, H1*W1, H2 >> l, W2 >> l] (fp32)."""
    corr_build_plain.calls += 1
    return build_pyramid_flat(corr_volume_flat(f1, f2), NUM_LEVELS)


corr_build_plain.calls = 0


def corr_lookup_plain(levels, coords):
    """Plain K3: levels from corr_build, coords [E, P, 2] -> [E, P, 196]."""
    corr_lookup_plain.calls += 1
    return corr_lookup_pyramid_flat(levels, coords, RADIUS)


corr_lookup_plain.calls = 0


def _check_f32(name, x, ndim):
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 {ndim}-D tensor, "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def corr_build(f1, f2):
    """All-pairs correlation pyramid (K2).  f1 [E, H1, W1, C], f2
    [E, H2, W2, C] float32 -> list of 4 levels [E, H1*W1, H2 >> l, W2 >> l]."""
    if f1.device.type == "cpu" and f2.device.type == "cpu":
        return corr_build_plain(f1, f2)
    if not (f1.is_cuda and f2.is_cuda and f1.device == f2.device):
        raise ValueError(f"corr_build: f1 on {f1.device}, f2 on {f2.device}")
    _check_f32("f1", f1, 4)
    _check_f32("f2", f2, 4)
    E, H1, W1, C = f1.shape
    _, H2, W2, C2 = f2.shape
    if f2.shape[0] != E or C2 != C:
        raise ValueError(f"corr_build: f1 {tuple(f1.shape)} vs f2 {tuple(f2.shape)}")
    P = H1 * W1
    levels = [torch.empty(E, P, H2 >> l, W2 >> l, device=f1.device)
              for l in range(NUM_LEVELS)]
    lib = build.library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_build_launch(f1.data_ptr(), f2.data_ptr(), E, P, H2, W2, C,
                                    *[v.data_ptr() for v in levels], stream)
    build.check(err, "corr_build")
    corr_build.launches += 1
    return levels


corr_build.launches = 0


def corr_lookup(levels, coords):
    """Radius-3 pyramid lookup (K3).  levels from corr_build, coords
    [E, P, 2] level-0 pixels -> [E, P, 196] (channel 49 l + 7 a + b)."""
    coords = coords.detach()
    if coords.device.type == "cpu":
        return corr_lookup_plain(levels, coords)
    if not coords.is_cuda or any(v.device != coords.device for v in levels):
        raise ValueError("corr_lookup: levels and coords must share one CUDA device")
    if len(levels) != NUM_LEVELS:
        raise ValueError(f"corr_lookup: expected {NUM_LEVELS} levels, got {len(levels)}")
    _check_f32("coords", coords, 3)
    E, P, two = coords.shape
    if two != 2:
        raise ValueError(f"corr_lookup: coords {tuple(coords.shape)}")
    _, _, H2, W2 = levels[0].shape
    for l, v in enumerate(levels):
        _check_f32(f"level{l}", v, 4)
        if tuple(v.shape) != (E, P, H2 >> l, W2 >> l):
            raise ValueError(f"corr_lookup: level{l} {tuple(v.shape)} does not fit "
                             f"E={E} P={P} H2={H2} W2={W2}")
    out = torch.empty(E, P, NUM_LEVELS * (2 * RADIUS + 1) ** 2, device=coords.device)
    lib = build.library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_lookup_launch(*[v.data_ptr() for v in levels], coords.data_ptr(),
                                     E, P, H2, W2, out.data_ptr(), stream)
    build.check(err, "corr_lookup")
    corr_lookup.launches += 1
    return out


corr_lookup.launches = 0
