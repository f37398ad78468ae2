"""The operations and bytes that K1-K5 need, from their shapes.

Each function counts what the algorithm needs for one call, whatever a
kernel does: every input byte read once and every output byte written
once, and only the cells a lookup or window really needs.  It returns
(products, other fp32 operations, bytes); ``stats.bound_s`` turns them into
the least time.  Products are multiply-adds of a correlation (2 operations
each), run at the fp32-accurate tensor-core rate; the rest at the fp32
rate.
"""
import torch

LEVELS, RADIUS, PPAD, WIN = 4, 3, 8, 24
TAPS = (2 * RADIUS + 1) ** 2 * LEVELS       # 196 lookup outputs per pixel
SPAN = 2 * RADIUS + 2                        # 8 cells a bilinear span reads per axis
# K1: per edge pixel and image axis, w*Ji and w*Jj (12 products), the
# symmetric Hii and Hjj (21 multiply-adds each), Hij (36), vi and vj (12),
# Ei and Ej (12) and the depth terms (3): 222 operations.
K1_OPS_PER_PIXEL = 2 * (12 + 2 * (21 + 21 + 36 + 12 + 12 + 3))


def level_sizes(h, w):
    return [(h >> l, w >> l) for l in range(LEVELS)]


def ba_blocks(N, HW, MW):
    """K1 over N edges of HW pixels in a window of MW frames: reads target,
    weight, the window's disparities and poses, ii/jj; writes Hii, Hij,
    Hjj, vi, vj, Ei, Ej, Ck, wk (Hji is Hij transposed)."""
    reads = 4 * (4 * N * HW + MW * HW + 7 * MW + 4) + 16 * N
    writes = 4 * (3 * 36 * N + 12 * N + 12 * N * HW + 2 * N * HW)
    return 0.0, float(K1_OPS_PER_PIXEL * N * HW), float(reads + writes)


def corr_build(E, h1, w1, h2, w2, C, in_bytes, out_bytes):
    """K2: the all-pairs volume of E edges and its 4-level pyramid."""
    P, Q = h1 * w1, h2 * w2
    pooled = sum(h * w for h, w in level_sizes(h2, w2)[1:])
    products = 2.0 * E * P * Q * C
    other = 4.0 * E * P * pooled
    nbytes = (E * (P + Q) * C * in_bytes
              + E * P * sum(h * w for h, w in level_sizes(h2, w2)) * out_bytes)
    return products, other, float(nbytes)


def span_cells(coords, h2, w2):
    """Level cells the radius-3 bilinear lookups at coords [E, P, 2] read,
    summed over the pixels and levels: each 8x8 span clipped to its level."""
    total = 0
    c = coords.detach().float()
    for l, (h, w) in enumerate(level_sizes(h2, w2)):
        x0 = torch.floor(c[..., 0] / 2 ** l).clamp(-1e6, 1e6) - RADIUS
        y0 = torch.floor(c[..., 1] / 2 ** l).clamp(-1e6, 1e6) - RADIUS
        nx = ((x0 + SPAN).clamp(0, w) - x0.clamp(0, w)).clamp_min(0)
        ny = ((y0 + SPAN).clamp(0, h) - y0.clamp(0, h)).clamp_min(0)
        total += int((nx * ny).sum())
    return total


def corr_lookup(E, P, cells, level_bytes, out_bytes):
    """K3: ``cells`` level cells read (``span_cells``), coords, outputs."""
    nbytes = cells * level_bytes + E * P * 2 * 4 + E * P * TAPS * out_bytes
    return 0.0, 6.0 * E * P * TAPS, float(nbytes)


def window_cells(bases, h2, w2):
    """Cells of the windows at ``bases`` [E, 2L, P] that lie inside their
    levels (the rest is the zero border): the correlations a window cache
    needs to compute."""
    total = 0
    b = bases.long()
    for l, (h, w) in enumerate(level_sizes(h2, w2)):
        WH, WW = min(h + 2 * PPAD, WIN), min(w + 2 * PPAD, WIN)
        y0, x0 = b[:, 2 * l] - PPAD, b[:, 2 * l + 1] - PPAD
        ny = ((y0 + WH).clamp(0, h) - y0.clamp(0, h)).clamp_min(0)
        nx = ((x0 + WW).clamp(0, w) - x0.clamp(0, w)).clamp_min(0)
        total += int((nx * ny).sum())
    return total


def window_shape(h2, w2):
    sizes = [(min(h + 2 * PPAD, WIN), min(w + 2 * PPAD, WIN)) for h, w in level_sizes(h2, w2)]
    return sum(s[0] for s in sizes), max(s[1] for s in sizes)


def corr_build_windows(E, h1, w1, h2, w2, C, cells, elt):
    """K4: each in-level window cell is one C-long product of a pixel's
    feature with the pooled target features; the pooling of the target
    features; reads both feature maps and the coords, writes the packed
    windows and their bases."""
    P, Q = h1 * w1, h2 * w2
    rows, cols = window_shape(h2, w2)
    products = 2.0 * C * cells
    other = 4.0 * E * C * sum(h * w for h, w in level_sizes(h2, w2)[1:])
    nbytes = E * (P + Q) * C * elt + E * P * 2 * 4 + E * P * rows * cols * elt + E * 2 * LEVELS * P * 4
    return products, other, float(nbytes)


def corr_lookup_windows(E, P, elt):
    """K5: each pixel's 8x8 span in each level's window (the span is
    clipped into the window), its bases and coords; writes the lookups."""
    nbytes = (E * P * LEVELS * SPAN * SPAN * elt + E * 2 * LEVELS * P * 4 + E * P * 2 * 4
              + E * P * TAPS * elt)
    return 0.0, 6.0 * E * P * TAPS, float(nbytes)


def conv_flops(module, inp, out):
    """Multiply-adds x 2 of one nn.Conv2d forward, from its shapes."""
    kh, kw = module.kernel_size
    cin = inp.shape[1] // module.groups
    return 2.0 * out.numel() * cin * kh * kw
