"""The bf16 window extraction and P-major lookup's kernels of their own, K7
bf16 (csrc/corr_extract_windows.cu, extract_windows_bf16_kernel) and K6
bf16 (csrc/corr_pmajor_lookup.cu, pmajor_lookup_bf16_kernel), emulated in
numpy on the CPU with the kernels' own index arithmetic and word operations;
no kernel runs here.

K7 bf16: a block takes 32 consecutive pixels of one edge and a thread per
(pixel, window row r, 16-byte output chunk k), 768 threads a block.  Chunk k
of row r holds cells x0 .. x0 + 7, x0 = bx - 8 + 8 k, of level row
y = by - 8 + r.  On a level whose rows are whole 16-byte chunks it reads
chunk x0 >> 3 (floor division) and, where x0 & 7, the next, each wholly in
the row or zero (rows off the level zero), and aligns them with
lookup_bf16::span8; other levels read 2-byte cells with bounds tests.  Each
chunk is one 16-byte store into the tile's contiguous run (cell by cell
where the window rows are not whole chunks).

K6 bf16: a block takes 32 consecutive pixels of one edge (a cell's 64
contiguous bytes); per level the box of rows [min sy, max sy + 8) x columns
[min sx, max sx + 8) that the group's spans cover, the four boxes laid end to
end in a buffer of 768 cells; a whole group whose boxes fit is copied in
16-byte chunks (2-byte cells where P is not a multiple of 8 or a level is not
aligned) and blended from the buffer, any other gathers from the level.

Each equals the plain bf16 version (ops/corr.py) bit for bit at 40x64 (the
main path's), 27x45 (odd P), 24x66 and 8x12, and on the 2-byte bodies.
"""
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.ops import cuda_corr
from droid_slam_reserch_tpu_torch.ops.corr import (PPAD, build_pyramid_pmajor, level_sizes,
                                                   pack_offsets, win_shape)
from droid_slam_reserch_tpu_torch.tools import lookup_sources
from test_torch_lookup_vectors import bits, blend, level_xy, span8, widen, words

torch.set_num_threads(1)
LEVELS, R, D, OUT, WIN = 4, 3, 7, 196, 24
K7_TILE, K7_THREADS = 32, 768     # K7 bf16: pixels a block (kTileB), threads (kThreadsB)
K6_TILE, K6_BOX = 32, 768         # K6 bf16: pixels a group (kTileB), buffer cells (kBoxCells)
SHAPES = [(40, 64), (27, 45), (24, 66), (8, 12)]
SHAPE_IDS = ["40x64", "27x45-oddP", "24x66", "8x12"]


def _features(E, H, W, seed):
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy((0.3 * rng.standard_normal((E, H, W, 8))).astype(np.float32))
    f2 = torch.from_numpy((0.3 * rng.standard_normal((E, H, W, 8))).astype(np.float32))
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, H * W, 2)
    return f1.to(torch.bfloat16), f2.to(torch.bfloat16), grid.astype(np.float32), rng


def noisy_coords(grid, E, rng):
    """2 px of noise, some pixels 50 px off the image either side, so that
    window starts reach both clamps and chunks fall off the rows."""
    c = grid + 2.0 * rng.standard_normal((E, grid.shape[1], 2))
    c[:, :6] += 50.0
    c[:, 6:12] -= 50.0
    return c.astype(np.float32)


# ---------------------------------------------------------------- K7 bf16

def window_base(c, l, n, win):
    """K7's window_base: clip(floor(c / 2^l) + 8 - 3 - (win - 8) / 2, 0, n + 16 - win)."""
    f = np.clip(np.floor(c * np.float32(1.0 / (1 << l))), -1e6, 1e6).astype(np.int64)
    return np.clip(f + PPAD - R - (win - 8) // 2, 0, n + 2 * PPAD - win)


def k7_bf16(levels, coords, vec_levels, vec_stores):
    """K7 bf16 over every (edge, pixel, level, window row, chunk) -> (windows
    [E, P, sum WH, ww] uint16 cells, bases [E, 8, P], the flat level ranges
    read with the start of their row, the flat cells each store writes)."""
    E, P = coords.shape[:2]
    sizes = [tuple(v.shape[-2:]) for v in levels]
    offs, sum_wh, ww = pack_offsets(sizes)
    runs = -(-ww // 8)
    out = np.full((E, P, sum_wh, ww), 0xDEAD, np.uint16)   # every cell must be written
    bases = np.empty((E, 2 * LEVELS, P), np.int64)
    reads, stores = [], []
    ep = np.arange(E * P).reshape(E, P)
    for l, (v, off, (h, w)) in enumerate(zip(levels, offs, sizes)):
        WH, WW = win_shape(h, w)
        by = window_base(coords[..., 1], l, h, WH)
        bx = window_base(coords[..., 0], l, w, WW)
        bases[:, 2 * l], bases[:, 2 * l + 1] = by, bx
        cells = np.append(bits(v), np.uint16(0))      # a cell to index where none is read
        r = np.arange(WH)[:, None]
        k = np.arange(runs)[None]
        y = by[..., None, None] + r - PPAD                           # [E, P, WH, 1]
        x0 = bx[..., None, None] - PPAD + 8 * k                      # [E, P, 1, runs]
        in_y = (y >= 0) & (y < h)
        row = (ep[..., None, None] * h + np.where(in_y, y, 0)) * w   # flat start of level row y
        if vec_levels[l]:
            assert w > 0 and w % 8 == 0 and WW == ww == WIN
            ch, s, wc = x0 >> 3, x0 & 7, w // 8

            def chunk(c, ok):
                ok = np.broadcast_to(ok, np.broadcast_shapes(row.shape, c.shape))
                at = np.broadcast_to(row + 8 * c, ok.shape)
                got = np.where(ok[..., None], cells[np.where(ok, at, 0)[..., None] + np.arange(8)], 0)
                reads.append((at[ok], np.broadcast_to(row, ok.shape)[ok], w))
                return words(got.astype(np.uint16))

            lo = chunk(ch, in_y & (ch >= 0) & (ch < wc))
            hi = chunk(ch + 1, in_y & (s != 0) & (ch + 1 >= 0) & (ch + 1 < wc))
            vw = span8(lo, hi, np.broadcast_to(s, lo.shape[:-1]))
            v16 = np.stack([vw & 0xFFFF, vw >> 16], -1).reshape(*vw.shape[:-1], 8).astype(np.uint16)
        else:
            j = np.arange(8)
            x = x0[..., None] + j
            ok = in_y[..., None] & (8 * k[..., None] + j < WW) & (x >= 0) & (x < w)
            at = row[..., None] + x
            v16 = np.where(ok, cells[np.where(ok, at, 0)], 0).astype(np.uint16)
            reads.append((at[ok], np.broadcast_to(row[..., None], ok.shape)[ok], w))
        cols = 8 * k[..., None] + np.arange(8)                       # [1, runs, 8]
        keep = np.broadcast_to(cols < ww, v16.shape) if not vec_stores else \
            np.ones(v16.shape, bool)
        dst = ((ep[..., None, None, None] * sum_wh + off + r[..., None]) * ww + cols)
        dst = np.broadcast_to(dst, v16.shape)
        flat = out.reshape(-1)
        flat[dst[keep]] = v16[keep]
        stores.append(dst[..., 0].reshape(-1) if vec_stores else dst[keep])
    return out, bases, reads, stores


def k7_case(E, H, W, seed):
    f1, f2, grid, rng = _features(E, H, W, seed)
    levels = cuda_corr.corr_build_plain(f1, f2)
    return levels, noisy_coords(grid, E, rng)


def check_k7(levels, coords, vec_levels):
    ref_w, ref_b = cuda_corr.corr_extract_windows_plain(levels, torch.from_numpy(coords))
    ww = ref_w.shape[-1]
    out, bases, reads, stores = k7_bf16(levels, coords, vec_levels, ww % 8 == 0)
    assert np.array_equal(out.reshape(-1), bits(ref_w))
    assert np.array_equal(bases, ref_b.numpy())
    for at, row, w in reads:                                  # inside the row of the level
        assert np.all(at >= row) and np.all(at < row + w)
    if ww % 8 == 0:                                           # whole, aligned 16-byte stores
        starts = np.concatenate(stores)
        assert np.all(starts % 8 == 0)
        assert np.array_equal(np.sort(starts), np.arange(0, ref_w.numel(), 8))
    return out


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k7_bf16_chunks_equal_the_plain_version(H, W, E):
    """16-byte chunks on the levels whose width is a positive multiple of 8
    (chunk x0 >> 3, the next only where x0 & 7, each inside its row or
    zero), 2-byte cells on the others; every cell of the output written by
    16-byte stores that tile it once; bit for bit the plain bf16 windows and
    bases."""
    levels, coords = k7_case(E, H, W, 0)
    vec = [v.shape[-1] > 0 and v.shape[-1] % 8 == 0 for v in levels]
    check_k7(levels, coords, vec)
    assert vec == {(40, 64): [True] * 4, (27, 45): [False] * 4,
                   (24, 66): [False, False, True, True], (8, 12): [False] * 4}[H, W]


def test_k7_bf16_two_byte_cells_and_stores():
    """Levels 2 bytes off alignment take 2-byte cells at every level (bit for
    bit all the same), and a 16x6 target map (windows 22 cells wide) stores
    cell by cell."""
    levels, coords = k7_case(2, 40, 64, 1)
    check_k7(levels, coords, [False] * LEVELS)
    levels, coords = k7_case(2, 16, 6, 2)
    assert pack_offsets(level_sizes(16, 6))[2] == 22
    check_k7(levels, coords, [False] * LEVELS)


def test_k7_bf16_chunk_starts_reach_both_sides():
    """At 40x64 the chunk starts x0 cover -8 (the left border, a zero chunk)
    through 64 (the right border, past the row), with and without a 16-bit
    shift."""
    levels, coords = k7_case(1, 40, 64, 3)
    P = 40 * 64
    x0 = window_base(coords[..., 0], 0, 64, WIN)[..., None] - PPAD + 8 * np.arange(3)
    assert x0.min() == -8 and x0.max() == 64
    assert np.any(x0 % 8 != 0) and np.any(x0 % 8 == 0)
    assert P % K7_TILE == 0


def test_k7_bf16_block_shape():
    """768 threads are 32 pixels x 24 rows x 3 chunks in 3 whole passes; the
    bases of a tile fit in static shared memory."""
    assert K7_THREADS * 3 == K7_TILE * WIN * 3
    assert (K7_TILE * WIN * 3) % K7_THREADS == 0
    assert LEVELS * K7_TILE * 8 <= 48 * 1024


# ---------------------------------------------------------------- K6 bf16

def span_starts(coords, l, Hp, Wp):
    """K6's span starts (sy, sx) and rounded fractional parts at level l."""
    x, y, fx, fy = level_xy(coords, l)
    return (np.clip(y + PPAD - R, 0, Hp - 8), np.clip(x + PPAD - R, 0, Wp - 8), fx, fy)


def k6_bf16(padded, coords, vec):
    """K6 bf16 over every group -> (out [E, P, L, 7 (a), 7 (b)] float32,
    staged [E, groups], box cells [E, groups])."""
    E, P = coords.shape[:2]
    G = -(-P // K6_TILE)
    cells = [bits(v).reshape(v.shape) for v in padded]
    out = np.empty((E, P, LEVELS, D, D), np.float32)
    staged = np.zeros((E, G), bool)
    ncells = np.zeros((E, G), np.int64)
    for e in range(E):
        for g in range(G):
            p0 = g * K6_TILE
            n = min(K6_TILE, P - p0)
            lane = p0 + np.minimum(np.arange(K6_TILE), n - 1)   # lanes past P: the last pixel
            spans, boxes, at = [], [], 0
            for l, v in enumerate(padded):
                Hp, Wp = v.shape[1:3]
                sy, sx, fx, fy = span_starts(coords[e, lane], l, Hp, Wp)
                ry, cx = sy.min(), sx.min()
                nr, nc = sy.max() - ry + 8, sx.max() - cx + 8
                spans.append((sy, sx, fx, fy))
                boxes.append((ry, cx, nr, nc, at))
                at += nr * nc
            ncells[e, g] = at
            staged[e, g] = n == K6_TILE and at <= K6_BOX
            if staged[e, g]:
                buf = np.full((K6_BOX, K6_TILE), 0xDEAD, np.uint16)
                for l, (ry, cx, nr, nc, a0) in enumerate(boxes):
                    box = cells[l][e, ry:ry + nr, cx:cx + nc, p0:p0 + K6_TILE]
                    assert box.shape == (nr, nc, K6_TILE)
                    if vec:          # 16-byte chunks: 8 pixels each, 16-byte aligned
                        starts = (((e * padded[l].shape[1] + ry + np.arange(nr))[:, None]
                                   * padded[l].shape[2] + cx + np.arange(nc)) * P + p0)
                        assert np.all((starts[..., None] + 8 * np.arange(K6_TILE // 8)) % 8 == 0)
                    buf[a0:a0 + nr * nc] = box.reshape(nr * nc, K6_TILE)
            for l, ((sy, sx, fx, fy), (ry, cx, nr, nc, a0)) in enumerate(zip(spans, boxes)):
                q = np.arange(n)
                ii, jj = np.arange(8)[:, None], np.arange(8)[None]
                if staged[e, g]:     # the span's cells inside the box, read from the buffer
                    r, c = sy[q, None, None] - ry + ii, sx[q, None, None] - cx + jj
                    assert r.min() >= 0 and r.max() < nr and c.min() >= 0 and c.max() < nc
                    rows = buf[a0 + r * nc + c, q[:, None, None]]
                else:
                    rows = cells[l][e, sy[q, None, None] + ii, sx[q, None, None] + jj,
                                    (p0 + q)[:, None, None]]
                out[e, p0:p0 + n, l] = blend(widen(words(rows.astype(np.uint16))),
                                             fx[q], fy[q])
    return out, staged, ncells


def k6_case(E, H, W, kind, seed):
    f1, f2, grid, rng = _features(E, H, W, seed)
    padded, _ = build_pyramid_pmajor(f1, f2, dtype=torch.bfloat16)
    if kind == "pan":
        coords = np.broadcast_to(grid + 4.0, (E, H * W, 2)).astype(np.float32).copy()
    else:                # edge 0 under the pan, the others noisy: both branches
        coords = noisy_coords(grid, E, rng)
        coords[0] = grid[0] + 4.0
    return padded, coords


def check_k6(padded, coords, vec):
    E, P = coords.shape[:2]
    out, staged, ncells = k6_bf16(padded, coords, vec)
    ref = cuda_corr.corr_lookup_pmajor_plain(padded, torch.from_numpy(coords))
    assert torch.equal(torch.from_numpy(out.reshape(E, P, OUT)).to(torch.bfloat16), ref)
    cells, fits = lookup_sources.pmajor_groups(torch, torch.from_numpy(coords),
                                               (padded[0].shape[1] - 16, padded[0].shape[2] - 16))
    assert np.array_equal(cells.numpy(), ncells) and np.array_equal(fits.numpy(), staged)
    return staged


@pytest.mark.parametrize("kind", ["noise", "pan"])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k6_bf16_boxes_equal_the_plain_version(H, W, kind):
    """The groups' boxes hold every span cell; whole groups whose boxes fit
    768 cells blend from them, the others gather; bit for bit the plain bf16
    version, and the tool's count of staged groups is the kernel's."""
    padded, coords = k6_case(2, H, W, kind, 4)
    staged = check_k6(padded, coords, vec=(H * W) % 8 == 0)
    if (H, W) == (40, 64) and kind == "pan":
        assert staged.all()              # 8 x 39 cells at level 0: every box fits
    if (H, W) == (40, 64) and kind == "noise":
        assert staged.any() and not staged.all()


def test_k6_bf16_two_byte_copies_at_40x64():
    """Levels 2 bytes off alignment copy their boxes 2 bytes a cell: the
    same values, so bit for bit all the same."""
    padded, coords = k6_case(1, 40, 64, "pan", 5)
    assert check_k6(padded, coords, vec=False).all()


def test_k6_bf16_groups_fit_the_card():
    """The tool counts with the kernel's constants; a group's boxes and its
    staged outputs fit the 48 KB of static shared memory."""
    assert (lookup_sources.GROUP, lookup_sources.BOX_CELLS) == (K6_TILE, K6_BOX)
    assert K6_BOX * K6_TILE * 2 <= 48 * 1024
    assert K6_TILE * OUT * 2 <= K6_BOX * K6_TILE * 2
