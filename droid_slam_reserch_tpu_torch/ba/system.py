"""Per-edge Gauss-Newton blocks, batched and differentiable (mirror of the
JAX package's ba/system.py).

The one plain implementation of the blocks: training's BA builds them here
under autograd, and ops/cuda_ba.py's plain K1 (the reference of its CUDA
kernel, which has no backward) is this function on one batch item.
Conventions are the engine's: weights scaled by W_SCALE, pixels behind the
camera weigh 0, and stereo self-edges (ii == jj) add only depth terms.
"""
import torch

from ..geom.projective import projective_transform

W_SCALE = 0.001


def build_system_blocks(target, weight, poses, disps, intrinsics, ii, jj, group="se3",
                        min_depth=0.2):
    """target, weight [B, N, H, W, 2]; poses [B, P, 7|8]; disps [B, P, H, W];
    intrinsics [B, P, 4]; ii, jj [N].  Returns a dict of per-edge blocks
    (D the manifold dim): Hii, Hij, Hji, Hjj [B, N, D, D]; vi, vj [B, N, D];
    Ei, Ej [B, N, D, HW] (pose-depth coupling, depth of frame ii);
    Ck, wk [B, N, HW] (depth diagonal and rhs); coords and valid."""
    B, N, H, W, _ = target.shape
    coords, valid, (Ji, Jj, Jz) = projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True, group=group, min_depth=min_depth)
    D = Ji.shape[-1]

    r = target - coords                                  # [B, N, H, W, 2]
    w = W_SCALE * valid * weight
    wp = w * (ii != jj).to(w.dtype)[None, :, None, None, None]
    Jz0 = Jz[..., 0]                                     # [B, N, H, W, 2]
    # the contractions run over B * N edges at once
    fJi, fJj, fwp, fr, fJz0 = (x.reshape((B * N,) + x.shape[2:]) for x in (Ji, Jj, wp, r, Jz0))

    def per_edge(eq, *xs):
        out = torch.einsum(eq, *xs)
        return out.reshape((B, N) + out.shape[1:])

    def hblock(Ja, Jb):
        return per_edge("nhwcx,nhwc,nhwcy->nxy", Ja, fwp, Jb)

    def eblock(J):
        return per_edge("nhwcx,nhwc,nhwc->nxhw", J, fwp, fJz0).reshape(B, N, D, H * W)

    Hij = hblock(fJi, fJj)
    return {"Hii": hblock(fJi, fJi), "Hij": Hij, "Hji": Hij.transpose(-1, -2),
            "Hjj": hblock(fJj, fJj),
            "vi": per_edge("nhwcx,nhwc,nhwc->nx", fJi, fwp, fr),
            "vj": per_edge("nhwcx,nhwc,nhwc->nx", fJj, fwp, fr),
            "Ei": eblock(fJi), "Ej": eblock(fJj),
            # depth terms keep their weight on stereo self-edges
            "Ck": (w * Jz0 * Jz0).sum(-1).reshape(B, N, H * W),
            "wk": (w * r * Jz0).sum(-1).reshape(B, N, H * W),
            "coords": coords, "valid": valid}
