"""Correlation kernels and their plain PyTorch versions:

- K2 ``corr_build``          all-pairs volume and its 4-level pyramid, tile
                             by tile (the product as 3xTF32 wgmma on the
                             tensor cores), every level written once
                             (csrc/corr_build.cu; JAX corr_build_pmajor_pallas)
- K3 ``corr_lookup``         radius-3 lookup in that pyramid
                             (csrc/corr_lookup.cu; JAX corr_lookup_blocked_pallas)
- K4 ``corr_build_windows``  the same volume and pyramid, built band by band
                             in shared memory (the product as 3xTF32 on the
                             tensor cores); writes only each pixel's
                             per-level window and its base
                             (csrc/corr_windows_build.cu; JAX
                             corr_build_windows_light_pallas)
- K5 ``corr_lookup_windows`` the radius-3 lookup inside those windows
                             (csrc/corr_windows_lookup.cu; JAX
                             corr_lookup_windows_pallas)
- K6 ``corr_lookup_pmajor``  the radius-3 lookup in the zero-bordered
                             P-major pyramid of ops.corr.build_pyramid_pmajor
                             (csrc/corr_pmajor_lookup.cu; JAX
                             corr_lookup_pmajor_pallas)
- K7 ``corr_extract_windows`` K4's windows and bases cut out of K2's levels
                             (csrc/corr_extract_windows.cu; JAX
                             corr_extract_windows_pallas)
- K8 ``corr_build_windows_levels`` K4 that also writes K2's levels
                             (csrc/corr_windows_build.cu; JAX
                             corr_build_windows_pallas)

For a CUDA tensor each wrapper launches its hand-written kernel or raises;
for a CPU tensor it runs the plain version.  ``launches`` / ``calls`` count
each, so a run can show which one it took.
"""
import torch

from . import build
from .corr import (
    build_pyramid_flat,
    corr_lookup_pyramid_flat,
    corr_volume_flat,
    extract_windows,
    level_sizes,
    lookup_pmajor,
    lookup_windows,
    pack_offsets,
    window_bases,
)

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


def _check_levels(name, levels, E, P, H2, W2, border=0):
    """Each level l is a contiguous float32 [E, P, H2 >> l, W2 >> l] (K2's
    layout), or with border 8 the padded P-major [E, Hp_l, Wp_l, P]."""
    if len(levels) != NUM_LEVELS:
        raise ValueError(f"{name}: expected {NUM_LEVELS} levels, got {len(levels)}")
    for l, v in enumerate(levels):
        _check_f32(f"level{l}", v, 4)
        h, w = (H2 >> l) + 2 * border, (W2 >> l) + 2 * border
        want = (E, h, w, P) if border else (E, P, h, w)
        if tuple(v.shape) != want:
            raise ValueError(f"{name}: level{l} {tuple(v.shape)}, expected {want}")


def _check_windows_build(name, f1, f2, coords0):
    """K4's and K8's inputs: f1 [E, H1, W1, C], f2 [E, H2, W2, C], coords0
    [E, H1*W1, 2], contiguous float32; the kernel copies 4 channels at a time,
    so C is a multiple of 4 and f1, f2 start 16-byte aligned.  Returns
    (E, P, H2, W2, C)."""
    _check_f32("f1", f1, 4)
    _check_f32("f2", f2, 4)
    _check_f32("coords0", coords0, 3)
    E, H1, W1, C = f1.shape
    _, H2, W2, C2 = f2.shape
    P = H1 * W1
    if f2.shape[0] != E or C2 != C or tuple(coords0.shape) != (E, P, 2):
        raise ValueError(f"{name}: f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, "
                         f"coords0 {tuple(coords0.shape)}")
    if C % 4 or f1.data_ptr() % 16 or f2.data_ptr() % 16:
        raise ValueError(f"{name}: needs C % 4 == 0 and 16-byte aligned features, got C={C}")
    return E, P, H2, W2, C


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
    if C % 4 or f1.data_ptr() % 16 or f2.data_ptr() % 16:
        raise ValueError(f"corr_build: the kernel's tensor maps need C % 4 == 0 and 16-byte "
                         f"aligned features, got C={C}")
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
    _check_f32("coords", coords, 3)
    E, P, two = coords.shape
    if two != 2 or levels[0].dim() != 4:
        raise ValueError(f"corr_lookup: coords {tuple(coords.shape)}")
    H2, W2 = levels[0].shape[-2:]
    _check_levels("corr_lookup", levels, E, P, H2, W2)
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


def _cut_windows(levels, coords):
    """Each pixel's per-level window around coords [E, P, 2], cut out of
    the zero-bordered levels -> (windows, bases)."""
    sizes = [tuple(v.shape[-2:]) for v in levels]
    bases = window_bases(coords.detach().float(), sizes, RADIUS)
    return extract_windows(levels, bases), bases


def corr_build_windows_plain(f1, f2, coords0):
    """Plain K4: the plain pyramid, zero-bordered, cut into each pixel's
    per-level window around coords0 [E, P, 2].  Returns (windows
    [E, P, sum(WH), max(WW)], bases [E, 2L, P] int32)."""
    corr_build_windows_plain.calls += 1
    return _cut_windows(build_pyramid_flat(corr_volume_flat(f1, f2), NUM_LEVELS), coords0)


corr_build_windows_plain.calls = 0


def corr_lookup_windows_plain(wins, bases, coords, target_hw):
    """Plain K5: the K3 formula inside the windows -> [E, P, 196]."""
    corr_lookup_windows_plain.calls += 1
    return lookup_windows(wins, bases, coords, level_sizes(*target_hw, NUM_LEVELS), RADIUS)


corr_lookup_windows_plain.calls = 0


def corr_build_windows(f1, f2, coords0):
    """Per-pixel window cache of the correlation pyramid (K4).  f1 [E, H1,
    W1, C], f2 [E, H2, W2, C] float32, coords0 [E, H1*W1, 2] level-0 pixels
    -> (windows [E, P, sum(WH), max(WW)] float32, bases [E, 2L, P] int32).
    The pyramid itself never reaches device memory."""
    if f1.device.type == "cpu" and f2.device.type == "cpu" and coords0.device.type == "cpu":
        return corr_build_windows_plain(f1, f2, coords0)
    if not (f1.is_cuda and f1.device == f2.device == coords0.device):
        raise ValueError(f"corr_build_windows: f1 on {f1.device}, f2 on {f2.device}, "
                         f"coords0 on {coords0.device}")
    coords0 = coords0.detach()
    E, P, H2, W2, C = _check_windows_build("corr_build_windows", f1, f2, coords0)
    _, sum_wh, ww_max = pack_offsets(level_sizes(H2, W2, NUM_LEVELS))
    wins = torch.empty(E, P, sum_wh, ww_max, device=f1.device)
    bases = torch.empty(E, 2 * NUM_LEVELS, P, dtype=torch.int32, device=f1.device)
    lib = build.library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_windows_build_launch(f1.data_ptr(), f2.data_ptr(), coords0.data_ptr(),
                                            E, P, H2, W2, C, wins.data_ptr(), bases.data_ptr(),
                                            stream)
    build.check(err, "corr_build_windows")
    corr_build_windows.launches += 1
    return wins, bases


corr_build_windows.launches = 0


def corr_lookup_windows(wins, bases, coords, target_hw):
    """Radius-3 lookup inside the cached windows (K5).  wins/bases from
    corr_build_windows, coords [E, P, 2] level-0 pixels, target_hw the
    (H2, W2) of the target feature map -> [E, P, 196].  Equals corr_lookup
    on the full pyramid wherever ops.corr.window_drift_ok holds."""
    coords = coords.detach()
    if coords.device.type == "cpu":
        return corr_lookup_windows_plain(wins, bases, coords, target_hw)
    if not (coords.is_cuda and wins.device == bases.device == coords.device):
        raise ValueError("corr_lookup_windows: wins, bases and coords must share one CUDA device")
    _check_f32("coords", coords, 3)
    _check_f32("wins", wins, 4)
    E, P, two = coords.shape
    H2, W2 = target_hw
    _, sum_wh, ww_max = pack_offsets(level_sizes(H2, W2, NUM_LEVELS))
    if (two != 2 or tuple(wins.shape) != (E, P, sum_wh, ww_max)
            or tuple(bases.shape) != (E, 2 * NUM_LEVELS, P) or bases.dtype != torch.int32
            or not bases.is_contiguous()):
        raise ValueError(f"corr_lookup_windows: wins {tuple(wins.shape)}, bases "
                         f"{tuple(bases.shape)} {bases.dtype}, coords {tuple(coords.shape)} "
                         f"do not fit H2={H2} W2={W2}")
    out = torch.empty(E, P, NUM_LEVELS * (2 * RADIUS + 1) ** 2, device=coords.device)
    lib = build.library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_windows_lookup_launch(wins.data_ptr(), bases.data_ptr(), coords.data_ptr(),
                                             E, P, H2, W2, out.data_ptr(), stream)
    build.check(err, "corr_lookup_windows")
    corr_lookup_windows.launches += 1
    return out


corr_lookup_windows.launches = 0


def corr_lookup_pmajor_plain(padded, coords):
    """Plain K6: padded levels from ops.corr.build_pyramid_pmajor, coords
    [E, P, 2] -> [E, P, 196]."""
    corr_lookup_pmajor_plain.calls += 1
    return lookup_pmajor(padded, coords, RADIUS)


corr_lookup_pmajor_plain.calls = 0


def corr_lookup_pmajor(padded, coords):
    """Radius-3 lookup in the zero-bordered P-major pyramid (K6).  padded
    [E, (H2 >> l) + 16, (W2 >> l) + 16, P] per level (ops.corr.
    build_pyramid_pmajor), coords [E, P, 2] level-0 pixels -> [E, P, 196].
    Equals corr_lookup on K2's levels of the same features."""
    coords = coords.detach()
    if coords.device.type == "cpu":
        return corr_lookup_pmajor_plain(padded, coords)
    if not coords.is_cuda or any(v.device != coords.device for v in padded):
        raise ValueError("corr_lookup_pmajor: levels and coords must share one CUDA device")
    _check_f32("coords", coords, 3)
    E, P, two = coords.shape
    if two != 2 or padded[0].dim() != 4:
        raise ValueError(f"corr_lookup_pmajor: coords {tuple(coords.shape)}")
    H2, W2 = padded[0].shape[1] - 16, padded[0].shape[2] - 16
    _check_levels("corr_lookup_pmajor", padded, E, P, H2, W2, border=8)
    out = torch.empty(E, P, NUM_LEVELS * (2 * RADIUS + 1) ** 2, device=coords.device)
    lib = build.library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_pmajor_lookup_launch(*[v.data_ptr() for v in padded], coords.data_ptr(),
                                            E, P, H2, W2, out.data_ptr(), stream)
    build.check(err, "corr_lookup_pmajor")
    corr_lookup_pmajor.launches += 1
    return out


corr_lookup_pmajor.launches = 0


def corr_extract_windows_plain(levels, coords):
    """Plain K7: the windows and bases of K4 around coords [E, P, 2], cut
    out of K2's levels."""
    corr_extract_windows_plain.calls += 1
    return _cut_windows(levels, coords)


corr_extract_windows_plain.calls = 0


def corr_extract_windows(levels, coords):
    """The per-pixel window cache cut out of an existing pyramid (K7).
    levels from corr_build, coords [E, P, 2] level-0 pixels -> (windows
    [E, P, sum(WH), max(WW)] float32, bases [E, 2L, P] int32), as
    corr_build_windows gives them for the same features."""
    coords = coords.detach()
    if coords.device.type == "cpu":
        return corr_extract_windows_plain(levels, coords)
    if not coords.is_cuda or any(v.device != coords.device for v in levels):
        raise ValueError("corr_extract_windows: levels and coords must share one CUDA device")
    _check_f32("coords", coords, 3)
    E, P, two = coords.shape
    if two != 2 or levels[0].dim() != 4:
        raise ValueError(f"corr_extract_windows: coords {tuple(coords.shape)}")
    H2, W2 = levels[0].shape[-2:]
    _check_levels("corr_extract_windows", levels, E, P, H2, W2)
    _, sum_wh, ww_max = pack_offsets(level_sizes(H2, W2, NUM_LEVELS))
    wins = torch.empty(E, P, sum_wh, ww_max, device=coords.device)
    bases = torch.empty(E, 2 * NUM_LEVELS, P, dtype=torch.int32, device=coords.device)
    lib = build.library()
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_extract_windows_launch(*[v.data_ptr() for v in levels], coords.data_ptr(),
                                              E, P, H2, W2, wins.data_ptr(), bases.data_ptr(),
                                              stream)
    build.check(err, "corr_extract_windows")
    corr_extract_windows.launches += 1
    return wins, bases


corr_extract_windows.launches = 0


def corr_build_windows_levels_plain(f1, f2, coords0):
    """Plain K8: the plain pyramid and K4's windows and bases cut from it
    -> (levels, windows, bases)."""
    corr_build_windows_levels_plain.calls += 1
    pyramid = build_pyramid_flat(corr_volume_flat(f1, f2), NUM_LEVELS)
    return (pyramid, *_cut_windows(pyramid, coords0))


corr_build_windows_levels_plain.calls = 0


def corr_build_windows_levels(f1, f2, coords0):
    """Pyramid and per-pixel window cache in one pass (K8).  Arguments as
    corr_build_windows -> (levels as corr_build gives them, windows, bases
    as corr_build_windows gives them)."""
    if f1.device.type == "cpu" and f2.device.type == "cpu" and coords0.device.type == "cpu":
        return corr_build_windows_levels_plain(f1, f2, coords0)
    if not (f1.is_cuda and f1.device == f2.device == coords0.device):
        raise ValueError(f"corr_build_windows_levels: f1 on {f1.device}, f2 on {f2.device}, "
                         f"coords0 on {coords0.device}")
    coords0 = coords0.detach()
    E, P, H2, W2, C = _check_windows_build("corr_build_windows_levels", f1, f2, coords0)
    _, sum_wh, ww_max = pack_offsets(level_sizes(H2, W2, NUM_LEVELS))
    levels = [torch.empty(E, P, H2 >> l, W2 >> l, device=f1.device) for l in range(NUM_LEVELS)]
    wins = torch.empty(E, P, sum_wh, ww_max, device=f1.device)
    bases = torch.empty(E, 2 * NUM_LEVELS, P, dtype=torch.int32, device=f1.device)
    lib = build.library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corr_windows_build_levels_launch(
            f1.data_ptr(), f2.data_ptr(), coords0.data_ptr(), E, P, H2, W2, C, wins.data_ptr(),
            bases.data_ptr(), *[v.data_ptr() for v in levels], stream)
    build.check(err, "corr_build_windows_levels")
    corr_build_windows_levels.launches += 1
    return levels, wins, bases


corr_build_windows_levels.launches = 0
