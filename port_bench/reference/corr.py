"""The all-pairs correlation volume, its 4-level pyramid and the radius-3
bilinear lookup, plain PyTorch in fp32 (DROID-SLAM's CorrBlock).

Feature dot products are scaled by 1/16; level l + 1 is the 2x average
pool (floor) of level l; level l is sampled at coords / 2**l; corners
outside a level read 0; output channels are level-major, then
``a * 7 + b`` with a the x tap and b the y tap.  A frozen copy of the
port's plain ``ops/corr.py`` functions.
"""
import torch

LEVELS = 4
RADIUS = 3


def pyramid(f1, f2):
    """f1 [E, H1, W1, C], f2 [E, H2, W2, C] -> levels [E, H1*W1, H2 >> l, W2 >> l]."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    vol = torch.bmm(f1.reshape(E, H1 * W1, C).float(),
                    f2.reshape(E, H2 * W2, C).float().transpose(1, 2))
    vol = (vol / 16.0).reshape(E, H1 * W1, H2, W2)
    levels = [vol]
    for _ in range(LEVELS - 1):
        h, w = vol.shape[-2] // 2, vol.shape[-1] // 2
        v = vol[..., :2 * h, :2 * w].reshape(E, H1 * W1, h, 2, w, 2)
        vol = (v[..., 0, :, 0] + v[..., 0, :, 1] + v[..., 1, :, 0] + v[..., 1, :, 1]) * 0.25
        levels.append(vol)
    return levels


def _lookup_level(vol, coords):
    E, P, h, w = vol.shape
    rd = 2 * RADIUS + 1
    x, y = coords[..., 0], coords[..., 1]
    xf, yf = torch.floor(x), torch.floor(y)
    dx, dy = (x - xf)[..., None, None], (y - yf)[..., None, None]
    offs = torch.arange(-RADIUS, RADIUS + 2, device=vol.device)
    ys = yf.clamp(-1e6, 1e6).long()[..., None] + offs
    xs = xf.clamp(-1e6, 1e6).long()[..., None] + offs
    ok = ((ys >= 0) & (ys < h))[..., :, None] & ((xs >= 0) & (xs < w))[..., None, :]
    idx = ys.clamp(0, max(h - 1, 0))[..., :, None] * w + xs.clamp(0, max(w - 1, 0))[..., None, :]
    if h * w == 0:
        g = vol.new_zeros(E, P, rd + 1, rd + 1)
    else:
        g = vol.reshape(E, P, h * w).gather(2, idx.reshape(E, P, -1)).reshape(E, P, rd + 1, rd + 1)
        g = torch.where(ok, g, torch.zeros_like(g))
    yb = (1.0 - dy) * g[:, :, :rd, :] + dy * g[:, :, 1:, :]
    xb = (1.0 - dx) * yb[..., :rd] + dx * yb[..., 1:]
    return xb.transpose(-1, -2).reshape(E, P, rd * rd)


def lookup(levels, coords):
    """coords [E, P, 2] level-0 pixels -> [E, P, 196]."""
    coords = coords.float()
    return torch.cat([_lookup_level(v, coords / (2.0 ** l)) for l, v in enumerate(levels)], -1)


def correlate(f1, f2, coords, chunk=16):
    """lookup(pyramid(f1, f2), coords) computed ``chunk`` edges at a time,
    so that the volumes of a large graph fit."""
    out = [lookup(pyramid(f1[e:e + chunk], f2[e:e + chunk]), coords[e:e + chunk])
           for e in range(0, f1.shape[0], chunk)]
    return torch.cat(out, 0)
