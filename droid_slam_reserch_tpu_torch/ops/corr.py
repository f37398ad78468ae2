"""Correlation volumes and the radius-3 bilinear pyramid lookup, plain PyTorch:
the full pyramid (K2, K3), the per-pixel window cache and its drift rule
(K4, K5, K7, K8), the zero-bordered P-major pyramid (K6), the backend's
altcorr over a pooled feature pyramid, the training forward's
differentiable pyramid, and the JAX package's packed single-product lookup
(``pack_pyramid`` / ``packed_lookup``, used by no engine path).

The spec that the CUDA kernels of ops/cuda_corr.py match:
- features dot products are scaled by 1/16 and accumulated in fp32;
- the pyramid is built by 2x average pooling with floor semantics;
- level l is sampled at coords / 2**l with the same radius;
- lookup channels are ``a * (2r+1) + b`` with a the x tap and b the y tap;
- bilinear corners outside the level read 0;
- levels are concatenated level-major;
- in bf16 (the JAX package's bfloat16 compute dtype) every value is computed
  in fp32 and rounded once where the TPU kernels store it: each level (a
  pooled level pools the rounded one below it), each window, each lookup
  output.  The lookups' bilinear weights are rounded to the volume's dtype
  first, as the TPU kernels cast them.
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
    """2x average pool over the trailing dims of [E, P, H2, W2] (floor),
    summed in fp32 and returned in volp's dtype."""
    E, P, H2, W2 = volp.shape
    h, w = H2 // 2, W2 // 2
    v = volp[..., : 2 * h, : 2 * w].float().reshape(E, P, h, 2, w, 2)
    out = (v[..., 0, :, 0] + v[..., 0, :, 1] + v[..., 1, :, 0] + v[..., 1, :, 1]) * 0.25
    return out.to(volp.dtype)


def build_pyramid_flat(volp, num_levels=4):
    pyr = [volp]
    for _ in range(num_levels - 1):
        volp = pool2x_volume_flat(volp)
        pyr.append(volp)
    return pyr


def _weights(x, xf, dtype):
    """The bilinear weight x - xf [..., 1, 1], rounded to ``dtype`` (as the
    TPU kernels cast it to the volume's dtype) and computed with in fp32."""
    return (x - xf).to(dtype).float()[..., None, None]


def _lookup_level(vol, coords, radius):
    """vol [E, P, h, w], coords [E, P, 2] in level pixels -> [E, P, rd*rd]
    in vol's dtype."""
    E, P, h, w = vol.shape
    rd = 2 * radius + 1
    x, y = coords[..., 0], coords[..., 1]
    xf, yf = torch.floor(x), torch.floor(y)
    dx, dy = _weights(x, xf, vol.dtype), _weights(y, yf, vol.dtype)
    offs = torch.arange(-radius, radius + 2, device=vol.device)
    ys = yf.clamp(-1e6, 1e6).long()[..., None] + offs              # [E, P, rd+1]
    xs = xf.clamp(-1e6, 1e6).long()[..., None] + offs
    ok = (((ys >= 0) & (ys < h))[..., :, None] & ((xs >= 0) & (xs < w))[..., None, :])
    idx = ys.clamp(0, max(h - 1, 0))[..., :, None] * w + xs.clamp(0, max(w - 1, 0))[..., None, :]
    if h * w == 0:
        g = vol.new_zeros(E, P, rd + 1, rd + 1, dtype=torch.float32)
    else:
        g = vol.reshape(E, P, h * w).gather(2, idx.reshape(E, P, -1)).reshape(E, P, rd + 1, rd + 1)
        g = torch.where(ok, g, torch.zeros_like(g)).float()
    yb = (1.0 - dy) * g[:, :, :rd, :] + dy * g[:, :, 1:, :]         # [E, P, b, rd+1]
    xb = (1.0 - dx) * yb[..., :rd] + dx * yb[..., 1:]                # [E, P, b, a]
    return xb.transpose(-1, -2).reshape(E, P, rd * rd).to(vol.dtype)


def corr_lookup_pyramid_flat(pyramid, coords, radius=3):
    """pyramid of [E, P, h_l, w_l], coords [E, P, 2] level-0 pixels
    -> [E, P, L*(2r+1)**2], level-major."""
    coords = coords.detach().float()
    return torch.cat(
        [_lookup_level(vol, coords / (2.0 ** lvl), radius) for lvl, vol in enumerate(pyramid)],
        dim=-1,
    )


# ---------------------------------------------------------------- windows
#
# The per-pixel window cache of the frontend (K4 builds it, K5 reads it).
# Each level is thought of with an 8-pixel zero border (padded level
# Hp x Wp); a pixel's window at level l is the WH x WW block of the padded
# level whose top-left corner is its base (by, bx), centred on the 8-tap
# span of the FIRST round's coords.  Windows of all levels are packed along
# the rows: [E, P, sum(WH), max(WW)], level l at rows off_l .. off_l + WH_l.

PPAD = 8    # zero border of a padded level
WIN = 24    # window extent: +-(WIN - 8) / 2 = 8 px of drift tolerance


def level_sizes(H2, W2, num_levels=4):
    """[(h_l, w_l)] of the pyramid (floor halving)."""
    return [(H2 >> l, W2 >> l) for l in range(num_levels)]


def win_shape(h, w):
    """Window extent (WH, WW) of a level; the whole padded level when small."""
    return min(h + 2 * PPAD, WIN), min(w + 2 * PPAD, WIN)


def pack_offsets(sizes):
    """Row offset of each level's window in the packed tile, and the total
    rows; plus the packed column count (the widest window)."""
    offs, off = [], 0
    for h, w in sizes:
        offs.append(off)
        off += win_shape(h, w)[0]
    return offs, off, max(win_shape(h, w)[1] for h, w in sizes)


def _floor_int(x):
    """floor(x) as int64, clamped to +-1e6 first (the CUDA kernels' rule)."""
    return torch.floor(x).clamp(-1e6, 1e6).long()


def window_bases(coords, sizes, radius=3):
    """Window starts [E, 2L, P] int32 (by_l, bx_l per level) in padded-level
    rows/cols: the 8-tap span of coords [E, P, 2] sits centred in the window."""
    out = []
    for l, (h, w) in enumerate(sizes):
        WH, WW = win_shape(h, w)
        c = coords / (2.0 ** l)
        by = (_floor_int(c[..., 1]) + PPAD - radius - (WH - 8) // 2).clamp(0, h + 2 * PPAD - WH)
        bx = (_floor_int(c[..., 0]) + PPAD - radius - (WW - 8) // 2).clamp(0, w + 2 * PPAD - WW)
        out += [by, bx]
    return torch.stack(out, 1).to(torch.int32)


def extract_windows(pyramid, bases):
    """Cut each pixel's per-level window out of the zero-bordered levels.

    pyramid: levels [E, P, h_l, w_l]; bases [E, 2L, P].  Returns the packed
    windows [E, P, sum(WH), max(WW)]; columns past a level's WW are 0.
    """
    sizes = [tuple(v.shape[-2:]) for v in pyramid]
    offs, sum_wh, ww_max = pack_offsets(sizes)
    E, P = pyramid[0].shape[:2]
    out = pyramid[0].new_zeros(E, P, sum_wh, ww_max)
    for l, (v, off, (h, w)) in enumerate(zip(pyramid, offs, sizes)):
        WH, WW = win_shape(h, w)
        vp = torch.nn.functional.pad(v, (PPAD, PPAD, PPAD, PPAD))      # [E, P, Hp, Wp]
        rows = bases[:, 2 * l].long()[..., None] + torch.arange(WH, device=v.device)
        cols = bases[:, 2 * l + 1].long()[..., None] + torch.arange(WW, device=v.device)
        g = vp.gather(2, rows[..., None].expand(E, P, WH, vp.shape[-1]))
        out[:, :, off:off + WH, :WW] = g.gather(3, cols[:, :, None, :].expand(E, P, WH, WW))
    return out


def _sample_span(win, sy, sx, c, radius):
    """The K3 formula read from a zero-bordered tile: win [E, P, R, S], the
    8-tap span starting at (sy, sx) [E, P], c [E, P, 2] level pixels
    -> [E, P, (2r+1)**2] in win's dtype (channel a * (2r+1) + b)."""
    E, P, _, S = win.shape
    rd = 2 * radius + 1
    taps = torch.arange(rd + 1, device=c.device)
    x, y = c[..., 0], c[..., 1]
    dx, dy = _weights(x, torch.floor(x), win.dtype), _weights(y, torch.floor(y), win.dtype)
    g = win.gather(2, (sy[..., None] + taps)[..., None].expand(E, P, rd + 1, S))
    g = g.gather(3, (sx[..., None] + taps)[:, :, None, :].expand(E, P, rd + 1, rd + 1)).float()
    yb = (1.0 - dy) * g[:, :, :rd, :] + dy * g[:, :, 1:, :]           # [E, P, b, rd+1]
    xb = (1.0 - dx) * yb[..., :rd] + dx * yb[..., 1:]                  # [E, P, b, a]
    return xb.transpose(-1, -2).reshape(E, P, rd * rd).to(win.dtype)


def lookup_windows(wins, bases, coords, sizes, radius=3):
    """Radius-r bilinear lookup inside the packed windows -> [E, P, L*(2r+1)**2].

    The 8-tap span start is clipped into the window; it equals the full
    lookup (corr_lookup_pyramid_flat) wherever ``window_drift_ok`` holds.
    """
    coords = coords.detach().float()
    offs, _, _ = pack_offsets(sizes)
    out = []
    for l, (off, (h, w)) in enumerate(zip(offs, sizes)):
        WH, WW = win_shape(h, w)
        c = coords / (2.0 ** l)
        sy = (_floor_int(c[..., 1]) + PPAD - radius - bases[:, 2 * l].long()).clamp(0, WH - 8)
        sx = (_floor_int(c[..., 0]) + PPAD - radius - bases[:, 2 * l + 1].long()).clamp(0, WW - 8)
        out.append(_sample_span(wins[:, :, off:off + WH, :WW], sy, sx, c, radius))
    return torch.cat(out, -1)


def window_drift_ok(bases, coords, sizes, radius=3):
    """True (a bool tensor on the coords' device) iff the windowed lookup
    equals the full lookup for every pixel at every level.

    Both clip the 8-tap span: the full lookup reads zeros outside the level,
    the window clips its start into [0, WH - 8].  A span outside that range
    is safe only when both land on the same zero rows: the pixel wholly
    above the level with the base at the top edge, or wholly below with the
    base at the bottom edge (and likewise for columns).
    """
    coords = coords.detach()
    ok = torch.ones((), dtype=torch.bool, device=coords.device)
    for l, (h, w) in enumerate(sizes):
        Hp, Wp = h + 2 * PPAD, w + 2 * PPAD
        WH, WW = win_shape(h, w)
        c = coords / (2.0 ** l)
        yl = _floor_int(c[..., 1]) + PPAD - radius
        xl = _floor_int(c[..., 0]) + PPAD - radius
        by, bx = bases[:, 2 * l].long(), bases[:, 2 * l + 1].long()
        sy, sx = yl - by, xl - bx
        bad_y = (((sy < 0) & ((yl > 0) | (by > 0)))
                 | ((sy > WH - 8) & ((yl < Hp - 8) | (by < Hp - WH))))
        bad_x = (((sx < 0) & ((xl > 0) | (bx > 0)))
                 | ((sx > WW - 8) & ((xl < Wp - 8) | (bx < Wp - WW))))
        ok = ok & ~(bad_y | bad_x).any()
    return ok


# ---------------------------------------------------------------- P-major
#
# The JAX package's pixels-last layout (K6 reads it): each level is
# [E, H2_l, W2_l, P] with the 8-pixel zero border written out, so a lookup
# needs no bounds checks; the span start is clipped into [0, Hp - 8], where
# a span off the level lands wholly in the border.

def corr_volume_pmajor(f1, f2):
    """f1 [E, H1, W1, C], f2 [E, H2, W2, C] -> [E, H2, W2, H1*W1], scaled 1/16."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    v = torch.bmm(f2.reshape(E, H2 * W2, C).float(),
                  f1.reshape(E, H1 * W1, C).float().transpose(1, 2))
    return (v / 16.0).reshape(E, H2, W2, H1 * W1)


def pool2x_pmajor(v):
    """2x average pool over the spatial dims of [E, H, W, P] (floor),
    summed in fp32 and returned in v's dtype."""
    E, H, W, P = v.shape
    h, w = H // 2, W // 2
    x = v[:, : 2 * h, : 2 * w].float().reshape(E, h, 2, w, 2, P)
    out = (x[:, :, 0, :, 0] + x[:, :, 0, :, 1] + x[:, :, 1, :, 0] + x[:, :, 1, :, 1]) * 0.25
    return out.to(v.dtype)


def build_pyramid_pmajor(f1, f2, num_levels=4, dtype=None):
    """Zero-bordered P-major pyramid: ([E, H2_l + 16, W2_l + 16, P] per
    level, [(H2_l, W2_l)]).  The levels are fp32, or ``dtype``: the fp32
    volume rounded once, each pooled level the fp32 mean of the rounded
    level below it, rounded once."""
    vol = corr_volume_pmajor(f1, f2)
    if dtype is not None:
        vol = vol.to(dtype)
    pyr = [vol]
    for _ in range(num_levels - 1):
        vol = pool2x_pmajor(vol)
        pyr.append(vol)
    padded = [torch.nn.functional.pad(v, (0, 0, PPAD, PPAD, PPAD, PPAD)) for v in pyr]
    return padded, [tuple(v.shape[1:3]) for v in pyr]


def lookup_pmajor(padded, coords, radius=3):
    """Radius-r lookup in the padded P-major levels, coords [E, P, 2]
    level-0 pixels -> [E, P, L*(2r+1)**2]; equals corr_lookup_pyramid_flat."""
    coords = coords.detach().float()
    out = []
    for l, v in enumerate(padded):
        Hp, Wp = v.shape[1:3]
        c = coords / (2.0 ** l)
        sy = (_floor_int(c[..., 1]) + PPAD - radius).clamp(0, Hp - 8)
        sx = (_floor_int(c[..., 0]) + PPAD - radius).clamp(0, Wp - 8)
        out.append(_sample_span(v.permute(0, 3, 1, 2), sy, sx, c, radius))
    return torch.cat(out, -1)


# ---------------------------------------------------------------- training
#
# The training forward's all-pairs pyramid in the 5-D layout
# [E, H1, W1, H2_l, W2_l], on the plain functions above.  Autograd runs
# through the volume (the lookup's gather) and the features; the lookup's
# coords are detached, as the upstream CUDA sampler differentiates the
# volume only.  No counted kernel wrapper runs here.

def corr_volume(f1, f2):
    """f1 [E, H1, W1, C], f2 [E, H2, W2, C] -> [E, H1, W1, H2, W2] in fp32, scaled 1/16."""
    E, H1, W1, _ = f1.shape
    H2, W2 = f2.shape[1:3]
    return corr_volume_flat(f1, f2).reshape(E, H1, W1, H2, W2)


def pool2x_volume(vol):
    """2x average pool over the last two dims of [E, H1, W1, H2, W2] (floor)."""
    E, H1, W1, H2, W2 = vol.shape
    out = pool2x_volume_flat(vol.reshape(E, H1 * W1, H2, W2))
    return out.reshape(E, H1, W1, *out.shape[2:])


def build_pyramid(vol, num_levels=4):
    pyr = [vol]
    for _ in range(num_levels - 1):
        vol = pool2x_volume(vol)
        pyr.append(vol)
    return pyr


def corr_lookup(vol, coords, radius=3):
    """vol [E, H1, W1, H2, W2], coords [E, H1, W1, 2] in the volume's pixels
    -> [E, H1, W1, (2r+1)**2], channel a * (2r+1) + b (a the x tap)."""
    E, H1, W1, H2, W2 = vol.shape
    out = _lookup_level(vol.reshape(E, H1 * W1, H2, W2),
                        coords.detach().float().reshape(E, H1 * W1, 2), radius)
    return out.reshape(E, H1, W1, -1)


def corr_lookup_pyramid(pyramid, coords, radius=3):
    """Every level's lookup at coords / 2**l, level-major:
    coords [E, H1, W1, 2] -> [E, H1, W1, L*(2r+1)**2]."""
    E, H1, W1 = pyramid[0].shape[:3]
    flat = [v.reshape(E, H1 * W1, *v.shape[3:]) for v in pyramid]
    out = corr_lookup_pyramid_flat(flat, coords.reshape(E, H1 * W1, 2), radius)
    return out.reshape(E, H1, W1, -1)


def pack_pyramid(pyramid):
    """All levels of [E, H1, W1, H2_l, W2_l] volumes in one [E, H1, W1, H2_0,
    sum(W2_l)] array, each level in its own column range from row 0 (the
    JAX package's layout for a single-product lookup on the TPU).

    Returns (packed, meta), meta a tuple of (H2_l, W2_l, column offset)."""
    E, H1, W1, H2 = pyramid[0].shape[:4]
    meta, off = [], 0
    for v in pyramid:
        meta.append((v.shape[3], v.shape[4], off))
        off += v.shape[4]
    packed = pyramid[0].new_zeros(E, H1, W1, H2, off)
    for v, (h2, w2, o) in zip(pyramid, meta):
        packed[..., :h2, o: o + w2] = v
    return packed, tuple(meta)


def packed_lookup(packed, meta, coords, radius=3):
    """corr_lookup_pyramid on a pack_pyramid volume, as the JAX package
    computes it: per level a y-tap and an x-tap selector with the bilinear
    weights (zero for corners off the level), two products over the packed
    volume, and the diagonal level blocks kept.

    packed [E, H1, W1, K, Wp], coords [E, H1, W1, 2] in level-0 pixels ->
    [E, H1, W1, L*(2r+1)**2], level-major, channel a*(2r+1) + b."""
    E, H1, W1, K, Wp = packed.shape
    L, rd, P = len(meta), 2 * radius + 1, H1 * W1
    dev = packed.device
    coords = coords.detach().float().reshape(E, P, 2)
    taps = torch.arange(rd, device=dev) - radius
    iok = torch.arange(K, device=dev)
    iow = torch.arange(Wp, device=dev)
    wy, wx = [], []
    for lvl, (h2, w2, off) in enumerate(meta):
        c = coords / (2.0 ** lvl)
        xf, yf = torch.floor(c[..., 0]), torch.floor(c[..., 1])
        dx = (c[..., 0] - xf)[..., None, None]
        dy = (c[..., 1] - yf)[..., None, None]
        yc = yf.long()[..., None, None] + taps[:, None]
        xc = xf.long()[..., None, None] + taps[:, None]
        wy0 = torch.where((yc >= 0) & (yc < h2), 1.0 - dy, 0.0)
        wy1 = torch.where((yc + 1 >= 0) & (yc + 1 < h2), dy, 0.0)
        wy.append(wy0 * (iok == yc) + wy1 * (iok == yc + 1))
        wx0 = torch.where((xc >= 0) & (xc < w2), 1.0 - dx, 0.0)
        wx1 = torch.where((xc + 1 >= 0) & (xc + 1 < w2), dx, 0.0)
        wx.append(wx0 * (iow == xc + off) + wx1 * (iow == xc + 1 + off))
    wy = torch.cat(wy, 2).to(packed.dtype)                        # [E, P, L*rd, K]
    wx = torch.cat(wx, 2).to(packed.dtype)                        # [E, P, L*rd, Wp]
    tmp = torch.einsum("epbk,epkw->epbw", wy, packed.reshape(E, P, K, Wp))
    full = torch.einsum("epbw,epaw->epba", tmp, wx).reshape(E, P, L, rd, L, rd)
    out = torch.stack([full[:, :, l, :, l, :] for l in range(L)], 2)   # [E, P, L, b, a]
    return out.transpose(3, 4).reshape(E, H1, W1, L * rd * rd)


# ---------------------------------------------------------------- altcorr

def pool2x_fmap(f):
    """2x average pool over the spatial dims of [E, H, W, C] (floor semantics)."""
    E, H, W, C = f.shape
    h, w = H // 2, W // 2
    return f[:, : 2 * h, : 2 * w].reshape(E, h, 2, w, 2, C).mean(dim=(2, 4))


def altcorr(f1, f2, coords, radius=3):
    """Correlation lookup against one target feature level: f1 [E, H1, W1, C],
    f2 [E, H2, W2, C], coords [E, H1, W1, 2] in that level's pixels
    -> [E, H1, W1, (2r+1)**2], scaled 1/16."""
    E, H1, W1, _ = f1.shape
    vol = corr_volume_flat(f1, f2)
    out = _lookup_level(vol, coords.detach().float().reshape(E, H1 * W1, 2), radius)
    return out.reshape(E, H1, W1, -1)


def altcorr_pyramid(f1, f2_pyramid, coords, radius=3):
    """The backend's correlation: altcorr over a pooled feature pyramid,
    coords [E, H, W, 2] level-0 pixels -> [E, H, W, L*(2r+1)**2].

    Pooling the features commutes with the dot product, so this equals the
    volume pyramid's lookup (K2 then K3) up to float rounding."""
    return torch.cat([altcorr(f1, f2, coords / (2.0 ** l), radius)
                      for l, f2 in enumerate(f2_pyramid)], dim=-1)
