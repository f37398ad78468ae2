"""Correlation volumes and the radius-3 bilinear pyramid lookup, plain PyTorch.

The spec that the CUDA kernels of ops/cuda_corr.py match:
- features dot products are scaled by 1/16 and accumulated in fp32;
- the pyramid is built by 2x average pooling with floor semantics;
- level l is sampled at coords / 2**l with the same radius;
- lookup channels are ``a * (2r+1) + b`` with a the x tap and b the y tap;
- bilinear corners outside the level read 0;
- levels are concatenated level-major.
"""
import torch


def corr_volume_flat(f1, f2):
    """f1 [E, H1, W1, C], f2 [E, H2, W2, C] -> [E, H1*W1, H2, W2], scaled 1/16."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    v = torch.bmm(f1.reshape(E, H1 * W1, C).float(),
                  f2.reshape(E, H2 * W2, C).float().transpose(1, 2))
    return (v / 16.0).reshape(E, H1 * W1, H2, W2)


def pool2x_volume_flat(volp):
    """2x average pool over the trailing dims of [E, P, H2, W2] (floor)."""
    E, P, H2, W2 = volp.shape
    h, w = H2 // 2, W2 // 2
    v = volp[..., : 2 * h, : 2 * w].reshape(E, P, h, 2, w, 2)
    return (v[..., 0, :, 0] + v[..., 0, :, 1] + v[..., 1, :, 0] + v[..., 1, :, 1]) * 0.25


def build_pyramid_flat(volp, num_levels=4):
    pyr = [volp]
    for _ in range(num_levels - 1):
        volp = pool2x_volume_flat(volp)
        pyr.append(volp)
    return pyr


def _lookup_level(vol, coords, radius):
    """vol [E, P, h, w], coords [E, P, 2] in level pixels -> [E, P, rd*rd]."""
    E, P, h, w = vol.shape
    rd = 2 * radius + 1
    x, y = coords[..., 0], coords[..., 1]
    xf, yf = torch.floor(x), torch.floor(y)
    dx, dy = (x - xf)[..., None, None], (y - yf)[..., None, None]
    offs = torch.arange(-radius, radius + 2, device=vol.device)
    ys = yf.clamp(-1e6, 1e6).long()[..., None] + offs              # [E, P, rd+1]
    xs = xf.clamp(-1e6, 1e6).long()[..., None] + offs
    ok = (((ys >= 0) & (ys < h))[..., :, None] & ((xs >= 0) & (xs < w))[..., None, :])
    idx = ys.clamp(0, max(h - 1, 0))[..., :, None] * w + xs.clamp(0, max(w - 1, 0))[..., None, :]
    if h * w == 0:
        g = vol.new_zeros(E, P, rd + 1, rd + 1)
    else:
        g = vol.reshape(E, P, h * w).gather(2, idx.reshape(E, P, -1)).reshape(E, P, rd + 1, rd + 1)
        g = torch.where(ok, g, torch.zeros_like(g))
    yb = (1.0 - dy) * g[:, :, :rd, :] + dy * g[:, :, 1:, :]         # [E, P, b, rd+1]
    xb = (1.0 - dx) * yb[..., :rd] + dx * yb[..., 1:]                # [E, P, b, a]
    return xb.transpose(-1, -2).reshape(E, P, rd * rd)


def corr_lookup_pyramid_flat(pyramid, coords, radius=3):
    """pyramid of [E, P, h_l, w_l], coords [E, P, 2] level-0 pixels
    -> [E, P, L*(2r+1)**2], level-major."""
    coords = coords.detach().float()
    return torch.cat(
        [_lookup_level(vol, coords / (2.0 ** lvl), radius) for lvl, vol in enumerate(pyramid)],
        dim=-1,
    )
