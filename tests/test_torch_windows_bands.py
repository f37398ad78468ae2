"""The decomposition and the numerics that K4 and K8 (csrc/corr_windows_build.cu)
rely on, emulated in plain torch on the CPU; no kernel runs here.

- Bands: the cell dimension is cut into bands of 8 level-0 rows.  Each band
  is pooled alone to its rows of levels 1-3 and writes the window rows it
  owns: the level rows in the band, the zero rows above a level (band 0) and
  below it (the last band).  Put together, the bands give the plain versions'
  windows and levels bit for bit, and every window cell is written exactly
  once, at full, ragged and small sizes, with coords off the image.
- bf16: the same with a tile of bf16 cells, as the bf16 kernels keep it:
  level 0 rounded once after the 1/16 scale, each pooled band row the fp32
  mean of the rounded rows below it, rounded once.  Every cell the kernel
  writes is then a bf16 value, and the bands give the plain bf16 versions'
  windows and levels bit for bit.
- 3xTF32: the product taken as three TF32 products per 8 channels (small*big
  + big*small + big*big, fp32 sums) stays within K4's tolerance,
  1e-5 * max(1, |w|), of the plain windows at the main path's feature scale;
  one TF32 product does not.
- The bf16 tile's layout (make_meta): K4 pads each level's rows to 3 or 5
  mod 8 words, so the window stores' reads of up to 8 rows and 3 runs of 8
  cells find distinct banks; pixels are 4 (2 j + 1) words apart, so the tile
  stores of a warp's 32 threads do too; every 4-byte access of the tile falls
  on a word, odd widths included; K8's rows are W_l cells rounded up to even,
  and its level copies put each cell once where it belongs, in 16-byte runs
  aligned at both ends where W_l and the run's offset are multiples of 8; the
  tile fits a block up to 181 cells wide.
"""
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.ops.corr import (
    PPAD,
    build_pyramid_flat,
    corr_volume_flat,
    extract_windows,
    level_sizes,
    pack_offsets,
    pool2x_volume_flat,
    win_shape,
    window_bases,
)
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    corr_build_windows_levels_plain,
    corr_build_windows_plain,
)

torch.set_num_threads(1)
BAND = 8            # level-0 rows of a band, the kernel's kBand
RADIUS = 3
K4_TOL = 1e-5       # chip_smoke's K4 tolerance, times max(1, |w|)


def _case(E, H, W, C, seed):
    """Features and first-round coords near the grid, some far off the image."""
    rng = np.random.RandomState(seed)
    f1 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, C)).astype(np.float32)
    P = H * W
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, P, 2)
    c0 = np.broadcast_to(grid, (E, P, 2)) + 0.5 * rng.standard_normal((E, P, 2))
    c0[:, :6] += 40.0
    c0[:, 6:12] -= 40.0
    return torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(c0.astype(np.float32))


def band_build(f1, f2, c0, dtype=torch.float32):
    """K4/K8's algorithm band by band, with a tile of `dtype` cells ->
    (levels, windows, bases, writes): writes counts how often each window
    cell was written."""
    E, H1, W1, _ = f1.shape
    H, W = f2.shape[1:3]
    P = H1 * W1
    sizes = level_sizes(H, W)
    offs, sum_wh, ww_max = pack_offsets(sizes)
    bases = window_bases(c0, sizes, RADIUS)
    vol = corr_volume_flat(f1, f2)
    nbands = -(-H // BAND)
    wins = torch.full((E, P, sum_wh, ww_max), float("nan"), dtype=dtype)
    writes = torch.zeros((E, P, sum_wh, ww_max), dtype=torch.int32)
    levels = [torch.full((E, P, h, w), float("nan"), dtype=dtype) for h, w in sizes]
    cols = torch.arange(ww_max)
    for k in range(nbands):
        slab = vol[:, :, BAND * k:BAND * (k + 1)].to(dtype)   # the band's level-0 rows
        for l, (off, (h, w)) in enumerate(zip(offs, sizes)):
            if l:
                slab = pool2x_volume_flat(slab)            # this band's rows of level l
            ylo = (BAND * k) >> l
            levels[l][:, :, ylo:ylo + slab.shape[2]] = slab
            WH, WW = win_shape(h, w)
            y = bases[:, 2 * l].long()[..., None] - PPAD + torch.arange(WH)      # [E, P, WH]
            x = bases[:, 2 * l + 1].long()[..., None] - PPAD + cols             # [E, P, ww]
            ymin = -(1 << 30) if k == 0 else ylo
            ymax = (1 << 30) if k == nbands - 1 else (BAND * (k + 1)) >> l
            own = ((y >= ymin) & (y < ymax))[..., None].expand(E, P, WH, ww_max)
            inside = (((y >= 0) & (y < h))[..., None]
                      & ((x >= 0) & (x < w) & (cols < WW))[:, :, None, :])
            rows = slab.shape[2]
            if rows and w:
                r = (y - ylo).clamp(0, rows - 1)
                g = slab.gather(2, r[..., None].expand(E, P, WH, w))
                g = g.gather(3, x.clamp(0, w - 1)[:, :, None, :].expand(E, P, WH, ww_max))
            else:                                         # no rows of the level in this band
                g = torch.zeros(E, P, WH, ww_max, dtype=dtype)
            vals = torch.where(inside, g, torch.zeros((), dtype=dtype))
            region = wins[:, :, off:off + WH]
            region[own] = vals[own]
            writes[:, :, off:off + WH] += own.int()
    return levels, wins, bases, writes


BAND_SHAPES = [(1, 40, 64, 8), (2, 30, 44, 8), (2, 13, 20, 8), (2, 8, 12, 8)]
BAND_IDS = ["40x64", "30x44-ragged", "13x20-ragged", "8x12-small"]


@pytest.mark.parametrize("E,H,W,C", BAND_SHAPES, ids=BAND_IDS)
def test_bands_equal_the_plain_versions_bit_for_bit(E, H, W, C):
    f1, f2, c0 = _case(E, H, W, C, 0)
    levels, wins, bases, writes = band_build(f1, f2, c0)
    assert bool((writes == 1).all()), "a window cell is written other than once"
    pwins, pbases = corr_build_windows_plain(f1, f2, c0)
    assert torch.equal(bases, pbases)
    assert torch.equal(wins, pwins)
    plevels, lwins, lbases = corr_build_windows_levels_plain(f1, f2, c0)
    assert torch.equal(wins, lwins) and torch.equal(bases, lbases)
    for mine, ref in zip(levels, plevels):
        assert torch.equal(mine, ref)


@pytest.mark.parametrize("E,H,W,C", BAND_SHAPES, ids=BAND_IDS)
def test_bf16_bands_equal_the_plain_versions_bit_for_bit(E, H, W, C):
    f1, f2, c0 = _case(E, H, W, C, 0)
    f1, f2 = f1.to(torch.bfloat16), f2.to(torch.bfloat16)
    levels, wins, bases, writes = band_build(f1, f2, c0, torch.bfloat16)
    assert bool((writes == 1).all()), "a window cell is written other than once"
    pwins, pbases = corr_build_windows_plain(f1, f2, c0)
    assert pwins.dtype == wins.dtype == torch.bfloat16
    assert torch.equal(bases, pbases)
    assert torch.equal(wins, pwins)
    plevels, lwins, lbases = corr_build_windows_levels_plain(f1, f2, c0)
    assert torch.equal(wins, lwins) and torch.equal(bases, lbases)
    for mine, ref in zip(levels, plevels):
        assert mine.dtype == ref.dtype == torch.bfloat16
        assert torch.equal(mine, ref)


def bf16_row_cells(w, pad_rows=True):
    """make_meta's bf16 row stride for a level w cells wide: whole words,
    padded to 3 or 5 mod 8 words for K4 (pad_rows), not for K8."""
    words = (w + 1) // 2
    while pad_rows and words % 8 not in (3, 5):
        words += 1
    return 2 * words


def bf16_layout(W2, pad_rows=True):
    """make_meta's bf16 layout at width W2: each level's row stride, the
    offsets of each level's band rows in a pixel's tile, and the pixel
    stride S, all in cells."""
    rs = [bf16_row_cells(W2 >> l, pad_rows) for l in range(4)]
    lo = [sum((BAND >> k) * rs[k] for k in range(l)) for l in range(5)]
    return rs, lo[:4], ((lo[4] + 1) // 2 + 7) // 8 * 16 + 8


def bf16_tile(W2, pad_rows=True):
    """(pixel stride S in cells, pixels a block, dynamic shared bytes) of a
    bf16 block at width W2, as make_meta computes them (K4 pads its rows,
    K8 does not)."""
    S = bf16_layout(W2, pad_rows)[2]
    if W2 <= 64:     # the tile shares memory with 4 stages of (64 + 512) x 64 bytes
        return S, 64, max(64 * S * 2, 4 * 576 * 64) + 4 * 8 * 64
    return S, 32, 32 * S * 2 + 3 * 544 * 64 + 4 * 8 * 32


WIDTHS = [64, 44, 80, 20, 12, 120, 181]


@pytest.mark.parametrize("W2", WIDTHS)
def test_bf16_tile_reads_and_stores_find_distinct_banks(W2):
    S, _, _ = bf16_tile(W2)
    for l in range(4):
        w = W2 >> l
        if not w:
            continue
        rs = bf16_row_cells(w)
        assert rs >= w and rs % 2 == 0
        # a window store: lanes (row lr, run q) read cell x0 + 8 q + j of up
        # to 8 >> l rows of the band; lanes reading one word share it
        for x0 in range(-8, 8):
            for j in range(8):
                banks = {}
                for lr in range(BAND >> l):
                    for q in range(3):
                        word = (lr * rs + x0 + 8 * q + j) // 2
                        banks.setdefault(word % 32, set()).add(word)
                assert max(len(v) for v in banks.values()) == 1, (l, x0, j)
    # a tile store: thread (g, t) writes cells x, x + 1 (x = 2 t + const) of
    # pixel g, all in one row
    words = [(S // 2) * g + t for g in range(8) for t in range(4)]
    assert len({v % 32 for v in words}) == 32


@pytest.mark.parametrize("W2", WIDTHS)
def test_bf16_tile_fits_a_block(W2):
    _, px, nbytes = bf16_tile(W2)
    assert bf16_tile(W2, pad_rows=False)[2] <= nbytes <= 232448
    assert px == (64 if W2 <= 64 else 32)
    assert bf16_tile(W2 + 1)[2] > 232448 or W2 < 181


def k8_level_copy(lo, rs, Wl, rows, dst):
    """K8 bf16's copy of one pixel's band rows of a level, indexed as the
    kernel indexes it -> {cell of the level tensor: cell of the tile}.  Where
    W_l and the run's offset lo are multiples of 8, the band's rows are one
    run in the tile (rs = W_l) copied 16 bytes at a time, aligned at both
    ends; else a cell at a time, row by row."""
    out = {}
    if Wl % 8 == 0 and lo % 8 == 0:
        assert rs == Wl
        for i in range(rows * Wl // 8):
            assert (lo + 8 * i) % 8 == 0 and (dst + 8 * i) % 8 == 0
            out.update({dst + 8 * i + c: lo + 8 * i + c for c in range(8)})
    else:
        for i in range(rows * Wl):
            r = i // Wl
            out[dst + i] = lo + r * rs + i - r * Wl
    return out


@pytest.mark.parametrize("W2", WIDTHS + [45, 34, 66, 35, 13])
def test_bf16_tile_words_and_k8_level_copies(W2):
    # the 4-byte accesses (a tile store's cell pair x, x + 1, x even, in
    # level-0 rows 2k and 2k + 1 of any pixel) start on even cells, for K4's
    # rows and K8's, odd widths included; a pixel's tile is 16-byte aligned
    for pad in (True, False):
        rs, lo, S = bf16_layout(W2, pad)
        assert S % 8 == 0 and all(r % 2 == 0 for r in rs) and all(v % 2 == 0 for v in lo)
    rs, lo, S = bf16_layout(W2, pad_rows=False)
    H2, P = 20, 3
    for l in range(4):
        Hl, Wl = H2 >> l, W2 >> l
        if not Wl:
            continue
        for e_p in range(P):
            for band in range(-(-H2 // BAND)):
                ylo = (band * BAND) >> l
                rows = min(BAND >> l, Hl - ylo)
                if rows <= 0:
                    continue
                got = k8_level_copy(e_p * S + lo[l], rs[l], Wl, rows, (e_p * Hl + ylo) * Wl)
                want = {(e_p * Hl + ylo + r) * Wl + x: e_p * S + lo[l] + r * rs[l] + x
                        for r in range(rows) for x in range(Wl)}
                assert got == want, (l, e_p, band)


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def volume_tf32(f1, f2, passes):
    """The 1/16-scaled volume [E, P, H2, W2] from TF32 products, 8 channels a
    step as mma.sync m16n8k8 takes them: passes=3 is 3xTF32 (small*big,
    big*small, big*big into one fp32 sum), passes=1 one TF32 product."""
    E, H1, W1, C = f1.shape
    H2, W2 = f2.shape[1:3]
    a, b = f1.reshape(E, H1 * W1, C), f2.reshape(E, H2 * W2, C)
    acc = torch.zeros(E, H1 * W1, H2 * W2)
    for k0 in range(0, C, 8):
        ak, bk = a[..., k0:k0 + 8], b[..., k0:k0 + 8]
        ab, bb = tf32(ak), tf32(bk)
        if passes == 3:
            acc += torch.bmm(tf32(ak - ab), bb.transpose(1, 2))
            acc += torch.bmm(ab, tf32(bk - bb).transpose(1, 2))
        acc += torch.bmm(ab, bb.transpose(1, 2))
    return (acc / 16.0).reshape(E, H1 * W1, H2, W2)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12, -(1.0 + 2.0 ** -11), 3.0e-8])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)])
    assert torch.equal(tf32(x)[:4], want)                  # ties go away from zero
    big = tf32(x)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((x - big).abs() <= x.abs() * 2.0 ** -11).all())


def test_3xtf32_holds_k4_tolerance():
    E, H, W, C = 2, 40, 64, 128
    f1, f2, c0 = _case(E, H, W, C, 1)
    pwins, bases = corr_build_windows_plain(f1, f2, c0)
    tol = K4_TOL * max(1.0, float(pwins.abs().max()))
    errs = {}
    for passes in (3, 1):
        wins = extract_windows(build_pyramid_flat(volume_tf32(f1, f2, passes)), bases)
        errs[passes] = float((wins - pwins).abs().max())
    assert errs[3] <= tol, f"3xTF32 {errs[3]:.3e} > tol {tol:.3e}"
    assert errs[1] > tol, f"one TF32 product {errs[1]:.3e} already within tol {tol:.3e}"
