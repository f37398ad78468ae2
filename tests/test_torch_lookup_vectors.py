"""The bf16 lookups' kernels of their own, K3 bf16 (csrc/corr_lookup.cu,
corr_lookup_bf16_kernel) and K5 bf16 (csrc/corr_windows_lookup.cu,
windows_lookup_bf16_kernel), emulated in numpy on the CPU with the kernels'
own index arithmetic and word operations (csrc/lookup_bf16.cuh); no kernel
runs here.

- A block takes 16 consecutive pixels of one edge, thread l * 16 + q the
  (pixel p0 + q, level l).  It reads its span's 8 rows as aligned 16-byte
  chunks: chunk floor(x / 8) of the row and, only where x % 8 != 0, the next
  one (K5: x = sx, inside the 24-cell window row, from the copy of the 8 rows
  that one bulk copy a thread brings into shared memory, 25 chunks a thread;
  K3: x = x0 = floor(x) - 3, which may be negative, each chunk wholly inside
  the level or skipped).
- The chunks are aligned by word selects and a 16-bit funnel shift, widened
  to fp32, blended row pair by row pair (along y, then x, each op rounded to
  fp32), and outputs 49 l + 7 a + b staged in bf16; the tile's run is
  written with 16-byte stores where it starts at an even pixel e * P + p0,
  else 8-byte ones.
- Levels whose width is not a multiple of 8 (K3), and windows whose rows are
  not (K5, target maps narrower than 8 cells), are read 2 bytes a cell by the
  same body.
Each equals the plain bf16 version (ops/corr.py) bit for bit at E = 1 and 3
over 40x64 (the main path's), 30x45, 27x45 (odd P) and 8x12.
"""
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.ops import cuda_corr
from droid_slam_reserch_tpu_torch.ops.corr import PPAD, level_sizes, pack_offsets, win_shape

torch.set_num_threads(1)
LEVELS, R, D, OUT = 4, 3, 7, 196
TILE = 16                 # pixels a block (kTileB)
SPAN_CHUNKS = 25          # K5: 16-byte chunks of a thread's copy of its span (kSpanChunks)
THREADS = TILE * LEVELS   # a thread per (pixel, level)
SMS = 132                 # SMs of an H100 SXM
SHAPES = [(40, 64), (30, 45), (27, 45), (8, 12)]
SHAPE_IDS = ["40x64", "30x45", "27x45-oddP", "8x12"]


def bits(t):
    """A bf16 tensor's cells as uint16, flat."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16).reshape(-1)


def words(cells):
    """[..., 8] uint16 cells -> [..., 4] uint32 words, the lower address in
    the lower half."""
    c = cells.astype(np.uint32)
    return c[..., 0::2] | (c[..., 1::2] << 16)


def span8(lo, hi, s):
    """lookup_bf16::span8: cells s .. s + 7 of the chunks lo, hi ([..., 4]
    words): a shift by 2 words where s & 4, by 1 word where s & 2, then a
    16-bit funnel shift where s & 1."""
    w = np.concatenate([lo, hi], -1).astype(np.uint64)
    v = np.where((s & 4)[..., None] != 0, w[..., 2:8], w[..., 0:6])
    u = np.where((s & 2)[..., None] != 0, v[..., 1:6], v[..., 0:5])
    sh = ((s & 1) * 16).astype(np.uint64)[..., None]
    return ((((u[..., 1:5] << np.uint64(32)) | u[..., 0:4]) >> sh) & np.uint64(0xFFFFFFFF)
            ).astype(np.uint32)


def widen(w):
    """lookup_bf16::widen8: [..., 4] words -> [..., 8] float32 cells."""
    lo = (w << np.uint32(16)).view(np.float32)
    hi = (w & np.uint32(0xFFFF0000)).view(np.float32)
    return np.stack([lo, hi], -1).reshape(*w.shape[:-1], 8)


def bf16_round(x):
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return x.to(torch.bfloat16).float().numpy()


def level_xy(coords, l):
    """The kernels' level coords: x = c.x * 2^-l; floor clamped to +-1e6;
    the fractional parts rounded to bf16."""
    c = coords * np.float32(1.0 / (1 << l))
    x, y = c[..., 0], c[..., 1]
    fl = lambda v: np.clip(np.floor(v), -1e6, 1e6).astype(np.int64)   # noqa: E731
    return fl(x), fl(y), bf16_round(x - np.floor(x)), bf16_round(y - np.floor(y))


def blend(rows, fx, fy):
    """lookup_bf16::blend_span: rows [..., 8, 8] float32 -> [..., 7 (a), 7 (b)]
    float32, each product and sum rounded to fp32."""
    one = np.float32(1)
    wy, wx = (one - fy)[..., None], (one - fx)[..., None]
    fy, fx = fy[..., None], fx[..., None]
    out = np.empty(rows.shape[:-2] + (D, D), np.float32)
    for b in range(D):
        y = wy * rows[..., b, :] + fy * rows[..., b + 1, :]
        out[..., :, b] = wx * y[..., :D] + fx * y[..., 1:]
    return out


def chunk_rows(cells, row0, x, vec, ok_row, width, ok_chunk):
    """The span's 8 rows as [..., 8, 4] words: row i starts at flat cell
    row0[..., i]; cells x .. x + 7 of it.  vec: chunks x >> 3 and, where
    x & 7, the next (ok_chunk(c) says whether chunk c is read, else 0);
    else 2-byte cells, 0 outside [0, width).  Returns the words and the
    loads, as flat [start, end) and the start of the row each is for."""
    reads = []
    if vec:
        c, s = x >> 3, x & 7
        ok0 = ok_row & ok_chunk(c)[..., None]
        ok1 = ok_row & ((s != 0) & ok_chunk(c + 1))[..., None]
        lo_at = row0 + 8 * c[..., None]
        def get(at, ok):
            return np.where(ok[..., None], cells[np.where(ok, at, 0)[..., None] + np.arange(8)], 0)

        lo, hi = get(lo_at, ok0), get(lo_at + 8, ok1)
        reads += [(lo_at[ok0], lo_at[ok0] + 8, row0[ok0]),
                  (lo_at[ok1] + 8, lo_at[ok1] + 16, row0[ok1])]
        return span8(words(lo), words(hi), s[..., None]), reads
    xs = x[..., None, None] + np.arange(8)
    ok = ok_row[..., None] & (xs >= 0) & (xs < width)
    at = row0[..., None] + xs
    reads.append((at[ok], at[ok] + 1, np.broadcast_to(row0[..., None], at.shape)[ok]))
    return words(np.where(ok, cells[np.where(ok, at, 0)], 0)), reads


def k5_bf16(wins, bases, coords, hw, vec):
    """K5 bf16 over every (edge, pixel, level) -> (out [E, P, L, 7, 7]
    float32, per level the span rows' starts and the flat ranges read, the
    span starts sx [E, P, L])."""
    E, P, sum_wh, ww = wins.shape
    cells = bits(wins)
    sizes = level_sizes(*hw)
    ep = np.arange(E * P).reshape(E, P)
    out = np.empty((E, P, LEVELS, D, D), np.float32)
    reads, sxs = [], []
    for l, (off, (h, w)) in enumerate(zip(pack_offsets(sizes)[0], sizes)):
        WH, WW = win_shape(h, w)
        x, y, fx, fy = level_xy(coords, l)
        sy = np.clip(y + PPAD - R - bases[:, 2 * l], 0, WH - 8)
        sx = np.clip(x + PPAD - R - bases[:, 2 * l + 1], 0, WW - 8)
        row0 = ((ep * sum_wh + off + sy)[..., None] + np.arange(8)) * ww     # [E, P, 8]
        if vec:         # one bulk copy: 8 whole rows of the level's window, 16-byte aligned
            assert np.all(sy >= 0) and np.all(sy + 8 <= WH) and ww % 8 == 0
            assert np.all(row0[..., 0] % 8 == 0) and row0[..., -1].max() + ww <= wins.numel()
            last = 7 * (ww // 8) + (sx >> 3) + (sx % 8 != 0)   # the last chunk read of the copy
            assert last.max() < SPAN_CHUNKS and 8 * ww <= 8 * (SPAN_CHUNKS - 1)
        rows, r = chunk_rows(cells, row0, sx, vec, np.ones(row0.shape, bool), ww,
                             lambda c: np.ones(c.shape, bool))
        out[:, :, l] = blend(widen(rows), fx, fy)
        reads.append((row0, r))
        sxs.append(sx)
    return out, reads, np.stack(sxs, -1)


def k3_bf16(levels, coords, vec_levels):
    """K3 bf16 over every (edge, pixel, level) -> (out [E, P, L, 7, 7]
    float32, per level the flat ranges read and the chunk starts x0)."""
    E, P = coords.shape[:2]
    ep = np.arange(E * P).reshape(E, P)
    out = np.empty((E, P, LEVELS, D, D), np.float32)
    reads = []
    for l, v in enumerate(levels):
        h, w = v.shape[-2:]
        x, y, fx, fy = level_xy(coords, l)
        x0, y0 = x - R, y - R
        yy = y0[..., None] + np.arange(8)
        ok_row = (yy >= 0) & (yy < h)
        row0 = (ep[..., None] * h + np.where(ok_row, yy, 0)) * w
        rows, r = chunk_rows(bits(v), row0, x0, vec_levels[l], ok_row, w,
                             lambda c: (c >= 0) & (c < w // 8))
        out[:, :, l] = blend(widen(rows), fx, fy)
        reads.append((row0, ok_row, x0, r))
    return out, reads


def stage_tiles(vals, P):
    """The threads' staging map: thread (l, q) of tile t writes output
    7 a + b of (pixel p0 + q, level l) to stage[q * 196 + 49 l + 7 a + b];
    the tiles' runs laid end to end -> (out [E, P, 196], how often each
    staged output of each tile was written)."""
    E = vals.shape[0]
    T = -(-P // TILE)
    tid = np.arange(THREADS)
    l, q = tid // TILE, tid % TILE
    p = np.arange(T)[:, None] * TILE + q                                     # [T, threads]
    valid = p < P
    ab = np.arange(D * D)
    at = (q * OUT + l * D * D)[:, None] + (D * (ab // D) + ab % D)           # [threads, 49]
    stage = np.full((E, T, TILE * OUT), np.nan, np.float32)
    written = np.zeros((T, TILE * OUT), np.int64)
    src = vals[:, np.minimum(p, P - 1), l]                                  # [E, T, thr, 7, 7]
    for t in range(T):
        sel = valid[t]
        stage[:, t, at[sel].ravel()] = src[:, t, sel].reshape(E, -1)
        np.add.at(written[t], at[sel].ravel(), 1)
    return stage.reshape(E, T * TILE * OUT)[:, :P * OUT].reshape(E, P, OUT), written


def run_is_written_once(written, P):
    n = np.minimum(TILE, P - np.arange(written.shape[0]) * TILE)
    return np.array_equal(written, (np.arange(TILE * OUT)[None] < (n * OUT)[:, None]).astype(int))


def run_stores(E, P):
    """lookup_bf16::store_run for every (edge, tile) of an output that starts
    16-byte aligned -> [(byte address, bytes)], in order."""
    stores = []
    for e in range(E):
        for p0 in range(0, P, TILE):
            n = min(TILE, P - p0) * OUT
            start = (e * P + p0) * OUT * 2
            if start % 16 == 0:
                stores += [(start + 16 * i, 16) for i in range(n // 8)]
                if n % 8:
                    stores.append((start + 8 * (n // 4 - 1), 8))
            else:
                stores += [(start + 8 * i, 8) for i in range(n // 4)]
    return stores


def as_bf16(out):
    """[E, P, 196] float32 outputs rounded once to bf16."""
    return torch.from_numpy(np.ascontiguousarray(out)).to(torch.bfloat16)


def _features(E, H, W, seed):
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy(rng.standard_normal((E, H, W, 8)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((E, H, W, 8)).astype(np.float32))
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, H * W, 2)
    return f1.to(torch.bfloat16), f2.to(torch.bfloat16), grid.astype(np.float32), rng


def k5_case(E, H, W, seed):
    """bf16 windows and bases around first-round coords c0 (2 px of noise,
    some pixels 50 px off the image), and lookup coords c1 that drift up to
    2 px, some 12 px, so that the span starts reach 0 and WW - 8."""
    f1, f2, grid, rng = _features(E, H, W, seed)
    P = H * W
    c0 = grid + 2.0 * rng.standard_normal((E, P, 2))
    c0[:, :6] += 50.0
    c0[:, 6:12] -= 50.0
    c1 = c0 + rng.uniform(-2, 2, (E, P, 2))
    c1[:, 12:40:2] += 12.0
    c1[:, 13:40:2] -= 12.0
    c0, c1 = torch.from_numpy(c0.astype(np.float32)), torch.from_numpy(c1.astype(np.float32))
    wins, bases = cuda_corr.corr_build_windows_plain(f1, f2, c0)
    return wins, bases, c1


def k3_case(E, H, W, seed):
    """bf16 levels and coords with 2 px of noise, some 50 px off the image."""
    f1, f2, grid, rng = _features(E, H, W, seed)
    coords = grid + 2.0 * rng.standard_normal((E, H * W, 2))
    coords[:, :6] += 50.0
    coords[:, 6:12] -= 50.0
    return cuda_corr.corr_build_plain(f1, f2), torch.from_numpy(coords.astype(np.float32))


def check_k5(wins, bases, c1, hw, vec):
    E, P = c1.shape[:2]
    ref = cuda_corr.corr_lookup_windows_plain(wins, bases, c1, hw)
    vals, reads, sx = k5_bf16(wins, bases.numpy().astype(np.int64), c1.numpy(), hw, vec)
    out, written = stage_tiles(vals, P)
    assert torch.equal(as_bf16(out), ref)
    assert run_is_written_once(written, P)
    ww = wins.shape[-1]
    for _, loads in reads:                    # every read inside its span row
        for start, end, row in loads:
            assert np.all(start >= row) and np.all(end <= row + ww)
            assert np.all(end <= wins.numel())
            if vec:
                assert np.all(start % 8 == 0)
    return sx


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k5_bf16_spans_equal_the_plain_version(H, W, E):
    """16-byte chunks (ww_max = 24 at every shape here), the second one only
    where sx % 8 != 0; every read inside its 48-byte window row, whose start
    is 16-byte aligned; each staged output written once; bit for bit the
    plain bf16 version."""
    wins, bases, c1 = k5_case(E, H, W, 0)
    assert wins.shape[-1] % 8 == 0
    sx = check_k5(wins, bases, c1, (H, W), vec=True)
    assert {0, 8, 16} <= set(np.unique(sx[..., 0]).tolist())
    assert np.any(sx % 8 != 0)


def test_k5_bf16_two_byte_cells():
    """A 16x6 target map gives windows 22 cells wide (not a whole number of
    16-byte chunks): the 2-byte body, bit for bit; and the same body over the
    main path's windows (as for windows that do not start 16-byte aligned)."""
    wins, bases, c1 = k5_case(2, 16, 6, 1)
    assert wins.shape[-1] == 22
    check_k5(wins, bases, c1, (16, 6), vec=False)
    wins, bases, c1 = k5_case(1, 40, 64, 2)
    check_k5(wins, bases, c1, (40, 64), vec=False)


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k3_bf16_chunks_equal_the_plain_version(H, W, E):
    """16-byte chunks on levels whose width is a multiple of 8, chunk index
    x0 >> 3 (floor division: x0 may be negative), each chunk wholly inside
    the level's row or skipped, rows off the level skipped; 2-byte cells on
    the other levels; each staged output written once; bit for bit the plain
    bf16 version."""
    levels, coords = k3_case(E, H, W, 3)
    vec = [v.shape[-1] % 8 == 0 for v in levels]
    P = H * W
    vals, reads = k3_bf16(levels, coords.numpy(), vec)
    out, written = stage_tiles(vals, P)
    assert torch.equal(as_bf16(out), cuda_corr.corr_lookup_plain(levels, coords))
    assert run_is_written_once(written, P)
    for v, is_vec, (row0, ok_row, x0, ranges) in zip(levels, vec, reads):
        w = v.shape[-1]
        for start, end, row in ranges:        # inside the span row of the level
            assert np.all(start >= row) and np.all(end <= row + w)
            assert np.all(start >= 0) and np.all(end <= v.numel())
        if is_vec:                            # negative x0 reach the floor division
            assert np.any((x0 < 0) & (x0 % 8 != 0) & (x0 > -8))
    if (H, W) == (40, 64):
        assert all(vec)
    else:
        assert not all(vec)


def test_k3_bf16_two_byte_cells_at_40x64():
    """Levels that do not start 16-byte aligned take the 2-byte body at
    every level: bit for bit all the same."""
    levels, coords = k3_case(2, 40, 64, 4)
    vals, _ = k3_bf16(levels, coords.numpy(), [False] * LEVELS)
    out, _ = stage_tiles(vals, 40 * 64)
    assert torch.equal(as_bf16(out), cuda_corr.corr_lookup_plain(levels, coords))


def test_span8_selects_each_shift():
    """span8 gives cells s .. s + 7 of two chunks for every s."""
    cells = np.arange(16, dtype=np.uint16) + 100
    lo, hi = words(cells[:8]), words(cells[8:])
    for s in range(8):
        got = span8(lo[None], hi[None], np.array([s]))[0]
        assert np.array_equal(got, words(cells[s:s + 8]))


@pytest.mark.parametrize("E,H,W", [(3, 40, 64), (2, 27, 45), (3, 8, 12)])
def test_run_stores(E, H, W):
    """The tiles' runs cover the output once, in stores aligned to their
    size: 16 bytes where the run starts at an even pixel e * P + p0 (and one
    8-byte store for an odd last half chunk), else 8 bytes."""
    P = H * W
    stores = run_stores(E, P)
    addr = np.array([a for a, _ in stores])
    size = np.array([n for _, n in stores])
    assert np.all(addr % size == 0)
    assert addr[0] == 0 and np.array_equal(addr[1:], addr[:-1] + size[:-1])
    assert addr[-1] + size[-1] == E * P * OUT * 2
    for e in range(E):
        for p0 in range(0, P, TILE):
            start = (e * P + p0) * OUT * 2
            first = size[np.searchsorted(addr, start)]
            assert first == (16 if (e * P + p0) % 2 == 0 else 8)
    assert (P % 2 == 1) == bool(np.any(size == 8))


def test_tiles_fit_the_card():
    """The motion filter's single 40x64 edge gives more blocks than the
    card has SMs; a tile's staged bf16 outputs fit in static shared memory."""
    assert -(-40 * 64 // TILE) > SMS
    assert TILE * OUT * 2 <= 48 * 1024
