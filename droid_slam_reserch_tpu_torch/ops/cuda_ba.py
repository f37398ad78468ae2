"""K1 (per-edge BA blocks): the CUDA kernel and its plain PyTorch version.

The counterpart of the JAX package's ops/pallas_ba.py and, for the plain
version, of ba/system.py::build_system_blocks.  For CUDA tensors
``ba_system_blocks`` launches csrc/ba_blocks.cu or raises; for CPU tensors
it runs ``build_system_blocks``.  ``launches`` / ``calls`` count each
(dicts keyed by the kernel's name, as ops.cuda_corr's);
``system_blocks`` is the uncounted function itself.

Conventions: weights are scaled by ba.system.W_SCALE (0.001), pixels
behind min_depth get zero weight, and stereo self-edges (ii == jj)
contribute only depth terms.
"""
import torch

from . import build
from ..geom.projective import relative_poses
from ..lie import quat_to_matrix


def system_blocks(target, weight, poses, disps, intrinsics, ii, jj, min_depth=0.25):
    """K1's function in plain PyTorch: ba/system.py's blocks on one batch
    item.  target/weight [N, H, W, 2]; poses [MW, 7]; disps [MW, H, W];
    intrinsics [4]; ii/jj [N] local frame indices.

    Returns Hii/Hij/Hji/Hjj [N, 6, 6], vi/vj [N, 6], Ei/Ej [N, 6, HW] and
    Ck/wk [N, HW].
    """
    from ..ba import system     # ba imports this module (ba/solver.py)

    intr = intrinsics.expand(poses.shape[0], 4)
    blk = system.build_system_blocks(target[None], weight[None], poses[None], disps[None],
                                     intr[None], ii, jj, min_depth=min_depth)
    return {k: v[0] for k, v in blk.items() if k not in ("coords", "valid")}


def build_system_blocks(*args, **kw):
    """Plain K1: system_blocks, counted."""
    build_system_blocks.calls["ba_blocks"] += 1
    return system_blocks(*args, **kw)


build_system_blocks.calls = {"ba_blocks": 0}


def edge_inputs(poses, ii, jj):
    """What the kernel forms itself from the poses and ii/jj, in plain
    PyTorch: gij [N, 12] (row-major R of Gij = poses[jj] * poses[ii]^-1, then
    its t), with the stereo self-edge override.  The CPU tests hold the
    kernel's arithmetic against it."""
    N = ii.shape[0]
    Gij = relative_poses(poses[None], ii, jj)[0]
    return torch.cat([quat_to_matrix(Gij[:, 3:7]).reshape(N, 9), Gij[:, :3]], 1)


def outputs(N, H, W, device):
    """K1's outputs, carved from one allocation: H [N, 12, 12], v [N, 12],
    E [N, 12, HW], C [N, HW], w [N, HW]."""
    HW = H * W
    sizes = (144, 12, 12 * HW, HW, HW)
    buf = torch.empty(N * sum(sizes), device=device)
    parts = buf.split([N * n for n in sizes])
    return (parts[0].view(N, 12, 12), parts[1].view(N, 12), parts[2].view(N, 12, HW),
            parts[3].view(N, HW), parts[4].view(N, HW))


def launch(out, target, weight, poses, disps, intrinsics, ii, jj, min_depth=0.25):
    """One launch of csrc/ba_blocks.cu into ``out`` (from ``outputs``), on
    inputs the wrapper has checked."""
    from ..ba.system import W_SCALE

    N, H, W, _ = target.shape
    lib = build.library()
    with torch.cuda.device(target.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ba_blocks_launch(
            target.data_ptr(), weight.data_ptr(), poses.data_ptr(), disps.data_ptr(),
            ii.data_ptr(), jj.data_ptr(), intrinsics.data_ptr(), float(min_depth),
            W_SCALE, N, H, W, *[o.data_ptr() for o in out], stream)
    build.check(err, "ba_system_blocks")
    return out


def ba_system_blocks(target, weight, poses, disps, intrinsics, ii, jj, min_depth=0.25):
    """Per-edge GN blocks (K1); arguments and result as build_system_blocks.
    On the card: float32 tensors, ii/jj int64, all contiguous on one device."""
    if target.device.type == "cpu":
        return build_system_blocks(target, weight, poses, disps, intrinsics, ii, jj,
                                   min_depth=min_depth)
    dev = target.device
    for name, x, dtype in (("target", target, torch.float32), ("weight", weight, torch.float32),
                           ("poses", poses, torch.float32), ("disps", disps, torch.float32),
                           ("intrinsics", intrinsics, torch.float32), ("ii", ii, torch.int64),
                           ("jj", jj, torch.int64)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"ba_system_blocks: {name} must be contiguous {dtype} on {dev}, "
                             f"got {x.dtype} on {x.device}")
    N, H, W, two = target.shape
    if (two != 2 or tuple(weight.shape) != (N, H, W, 2) or tuple(disps.shape[1:]) != (H, W)
            or tuple(poses.shape) != (disps.shape[0], 7) or intrinsics.numel() != 4):
        raise ValueError(f"ba_system_blocks: target {tuple(target.shape)}, weight "
                         f"{tuple(weight.shape)}, poses {tuple(poses.shape)}, disps "
                         f"{tuple(disps.shape)}, intrinsics {tuple(intrinsics.shape)}")
    if target.data_ptr() % 8 or weight.data_ptr() % 8:
        raise ValueError("ba_system_blocks: target/weight must be 8-byte aligned")
    if ii.shape != (N,) or jj.shape != (N,):
        raise ValueError(f"ba_system_blocks: ii {tuple(ii.shape)}, jj {tuple(jj.shape)}")

    Hb, vb, Eb, Cb, wb = launch(outputs(N, H, W, dev), target, weight, poses, disps,
                                intrinsics, ii, jj, min_depth)
    ba_system_blocks.launches["ba_blocks"] += 1
    return {
        "Hii": Hb[:, :6, :6], "Hij": Hb[:, :6, 6:], "Hji": Hb[:, 6:, :6], "Hjj": Hb[:, 6:, 6:],
        "vi": vb[:, :6], "vj": vb[:, 6:], "Ei": Eb[:, :6], "Ej": Eb[:, 6:],
        "Ck": Cb, "wk": wb,
    }


ba_system_blocks.launches = {"ba_blocks": 0}
