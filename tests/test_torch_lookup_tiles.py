"""The tiling that K3 (csrc/corr_lookup.cu) and K6 (csrc/corr_pmajor_lookup.cu)
rely on, emulated in numpy on the CPU with the kernels' own index
arithmetic; no kernel runs here.

- K3: a block takes 16 consecutive pixels, a thread per (pixel, x tap a).
  The thread reads its span's columns a and a + 1 at every level with bounds
  checks (0 off the level) and stages its 28 outputs in the tile's contiguous
  16 x 196 run, written out with 16-byte stores.
- K6: a block takes 32 consecutive pixels, a thread per (pixel, x tap a).
  The thread reads its span's columns a and a + 1 at every level, unchecked
  (the clipped span start keeps them inside the padded level), and stages its
  28 outputs in the tile's contiguous 32 x 196 run; under a smooth pan the
  tile's loads touch only the sectors of its 8-pixel groups' union boxes.
- Both equal the plain versions (corr_lookup_pyramid_flat, lookup_pmajor) bit
  for bit: the kernels round each product and sum on its own as the plain
  versions do.  Shapes 40x64 (the main path's), ragged 30x44 and 13x20, and
  8x12; E = 1 and 3; P not a multiple of the tile; coords off the image, and
  coords scattered over the whole level.
"""
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu_torch.ops.corr import (
    build_pyramid_flat,
    build_pyramid_pmajor,
    corr_lookup_pyramid_flat,
    corr_volume_flat,
    lookup_pmajor,
)

torch.set_num_threads(1)
LEVELS, R, D, OUT = 4, 3, 7, 196
PAD = 8
SMS = 132                 # SMs of an H100 SXM
K3_TILE = 16              # K3's pixels a block
K6_TILE = 32              # K6's pixels a block
K6_GROUP = 8              # pixels of one 32-byte sector of a P-major cell


def floor_clamped(v):
    return np.clip(np.floor(v), -1e6, 1e6).astype(np.int64)


def blend(g00, g01, g10, g11, fx, fy):
    """The kernels' blend, each op rounded to float32: along y, then x."""
    wy, wx = np.float32(1) - fy, np.float32(1) - fx
    y0 = wy * g00 + fy * g10
    y1 = wy * g01 + fy * g11
    return wx * y0 + fx * y1


def decode(o):
    """Output o of a tile's run -> (pixel q, level l, x tap a, y tap b)."""
    q, c = o // OUT, o % OUT
    l, ab = c // (D * D), c % (D * D)
    return q, l, ab // D, ab % D


def level_coords(coords, l):
    c = coords * np.float32(1.0 / (1 << l))
    x, y = c[..., 0], c[..., 1]
    return x, y, x - np.floor(x), y - np.floor(y)


# ---------------------------------------------------------------- K3

def x_tap_threads(tile):
    """A block of K3 or K6: thread t is (pixel q, x tap a), t = 7 q + a."""
    t = np.arange(tile * D)
    return t // D, t % D


def k3_tiles(levels, coords):
    """K3 over every (edge, tile) at once: thread (q, a) reads its span's
    columns a and a + 1 at each level, 0 off the level, and stages its 28
    outputs in the tile's run -> ([E, P, 196], how often each staged output
    was written)."""
    E, P = coords.shape[:2]
    T = -(-P // K3_TILE)
    q, a = x_tap_threads(K3_TILE)
    p = np.arange(T)[:, None] * K3_TILE + q                    # [T, 112]
    valid = p < P
    pc = np.minimum(p, P - 1)
    stage = np.full((E, T, K3_TILE * OUT), np.nan, np.float32)
    written = np.zeros((E, T, K3_TILE * OUT), np.int64)
    ei = np.arange(E)[:, None, None, None]
    for l, v in enumerate(levels):
        h, w = v.shape[-2:]
        x, y, fx, fy = (t[:, pc] for t in level_coords(coords, l))   # [E, T, 112]
        rows = (floor_clamped(y) - R)[..., None] + np.arange(D + 1)  # [E, T, 112, 8]

        def column(k):
            cols = (floor_clamped(x) - R + a + k)[..., None]
            inside = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
            cell = v[ei, pc[..., None], np.clip(rows, 0, h - 1), np.clip(cols, 0, w - 1)]
            return np.where(inside, cell, np.float32(0))

        g0, g1 = column(0), column(1)
        for b in range(D):
            o = q * OUT + l * D * D + a * D + b
            val = blend(g0[..., b], g1[..., b], g0[..., b + 1], g1[..., b + 1], fx, fy)
            stage[:, :, o] = np.where(valid, val, stage[:, :, o])
            written[:, :, o] += valid
    return stage.reshape(E, T * K3_TILE, OUT)[:, :P], written


def run_is_written_once(written, P, tile):
    """Each tile's first np x 196 staged outputs written exactly once, the
    rest of the stage not at all."""
    n = np.minimum(tile, P - np.arange(written.shape[1]) * tile)        # pixels a tile
    run = np.arange(tile * OUT)[None, :] < (n * OUT)[:, None]
    return np.array_equal(written, np.broadcast_to(run, written.shape).astype(np.int64))


# ---------------------------------------------------------------- K6

def k6_tiles(padded, coords):
    """K6 over every (edge, tile) at once -> ([E, P, 196], the cells each
    thread read as (row, column) pairs per level, how often each staged
    output was written)."""
    E, P = coords.shape[:2]
    T = -(-P // K6_TILE)
    q, a = x_tap_threads(K6_TILE)
    p = np.arange(T)[:, None] * K6_TILE + q                    # [T, 224]
    valid = p < P
    pc = np.minimum(p, P - 1)
    stage = np.full((E, T, K6_TILE * OUT), np.nan, np.float32)
    written = np.zeros((E, T, K6_TILE * OUT), np.int64)
    reads = []
    ei = np.arange(E)[:, None, None]
    for l, v in enumerate(padded):
        Hp, Wp = v.shape[1:3]
        x, y, fx, fy = (t[:, pc] for t in level_coords(coords, l))   # [E, T, 224]
        sy = np.clip(floor_clamped(y) + PAD - R, 0, Hp - 8)
        sx = np.clip(floor_clamped(x) + PAD - R, 0, Wp - 8)
        rows = sy[..., None] + np.arange(D + 1)                   # [E, T, 224, 8]
        g0 = v[ei[..., None], rows, (sx + a)[..., None], pc[..., None]]
        g1 = v[ei[..., None], rows, (sx + a + 1)[..., None], pc[..., None]]
        reads.append((rows, (sx + a)[..., None] + np.arange(2)))
        for b in range(D):
            o = q * OUT + l * D * D + a * D + b
            val = blend(g0[..., b], g1[..., b], g0[..., b + 1], g1[..., b + 1], fx, fy)
            stage[:, :, o] = np.where(valid, val, stage[:, :, o])
            written[:, :, o] += valid
    return stage.reshape(E, T * K6_TILE, OUT)[:, :P], reads, written


# ---------------------------------------------------------------- cases

SHAPES = [(40, 64), (30, 44), (13, 20), (8, 12)]
SHAPE_IDS = ["40x64", "30x44-ragged", "13x20-ragged", "8x12-small"]


def _case(E, H, W, seed, scatter=0.0):
    """Features (C = 8) and coords near the grid, some wholly off the image;
    with scatter, coords spread that many pixels (std) around the grid."""
    rng = np.random.RandomState(seed)
    f1 = rng.standard_normal((E, H, W, 8)).astype(np.float32)
    f2 = rng.standard_normal((E, H, W, 8)).astype(np.float32)
    P = H * W
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, P, 2)
    coords = grid + (scatter or 2.0) * rng.standard_normal((E, P, 2))
    coords[:, :6] += 50.0
    coords[:, 6:12] -= 50.0
    return torch.from_numpy(f1), torch.from_numpy(f2), coords.astype(np.float32)


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k3_x_tap_threads_equal_the_plain_version(H, W, E):
    """Bounds-checked columns (0 off the level, coords far off the image
    included), each staged output written once; the run equals the plain
    version bit for bit."""
    f1, f2, coords = _case(E, H, W, 0)
    levels = build_pyramid_flat(corr_volume_flat(f1, f2))
    ref = corr_lookup_pyramid_flat(levels, torch.from_numpy(coords)).numpy()
    out, written = k3_tiles([v.numpy() for v in levels], coords)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    assert run_is_written_once(written, H * W, K3_TILE)


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k6_x_tap_threads_equal_the_plain_version(H, W, E):
    """Each staged output written once, by its (pixel, x tap) thread; the
    run equals the plain version bit for bit."""
    f1, f2, coords = _case(E, H, W, 1)
    padded, _ = build_pyramid_pmajor(f1, f2)
    ref = lookup_pmajor(padded, torch.from_numpy(coords)).numpy()
    out, _, written = k6_tiles([v.numpy() for v in padded], coords)
    np.testing.assert_array_equal(out, ref)
    assert run_is_written_once(written, H * W, K6_TILE)


@pytest.mark.parametrize("H,W", SHAPES, ids=SHAPE_IDS)
def test_k6_scattered_coords_read_inside_the_padded_level(H, W):
    """Coords scattered over and far off the image: the clipped span start
    keeps every unchecked read inside the padded level, and stays exact."""
    f1, f2, coords = _case(2, H, W, 2, scatter=0.5 * W)
    padded, _ = build_pyramid_pmajor(f1, f2)
    out, reads, _ = k6_tiles([v.numpy() for v in padded], coords)
    np.testing.assert_array_equal(out, lookup_pmajor(padded, torch.from_numpy(coords)).numpy())
    for v, (rows, cols) in zip(padded, reads):
        Hp, Wp = v.shape[1:3]
        assert rows.min() >= 0 and rows.max() < Hp and cols.min() >= 0 and cols.max() < Wp


def test_k6_pan_shares_sectors():
    """Under the main path's motion (a 4-px pan) a tile's 224 threads make
    3584 level-0 loads but touch only the sectors of its four 8-pixel groups'
    union boxes, 8 rows by 15 columns each: the reuse L1 serves."""
    H, W = 40, 64
    f1, f2, _ = _case(1, H, W, 3)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    coords = (grid.reshape(1, H * W, 2) + 4.0).astype(np.float32)
    padded, _ = build_pyramid_pmajor(f1, f2)
    out, reads, _ = k6_tiles([v.numpy() for v in padded], coords)
    np.testing.assert_array_equal(out, lookup_pmajor(padded, torch.from_numpy(coords)).numpy())
    rows, cols = reads[0]                          # level 0, [1, T, 224, 8] and [.., 2]
    q, _ = x_tap_threads(K6_TILE)
    group = np.broadcast_to((q // K6_GROUP)[:, None, None], (len(q), D + 1, 2))
    for t in range(rows.shape[1]):
        r = np.broadcast_to(rows[0, t][:, :, None], group.shape)
        c = np.broadcast_to(cols[0, t][:, None, :], group.shape)
        sectors = {(g, y, x) for g, y, x in zip(group.ravel(), r.ravel(), c.ravel())}
        assert len(sectors) <= K6_TILE // K6_GROUP * 8 * 15
    assert rows.shape[2] * (D + 1) * 2 == 3584


def test_tiles_fit_the_card():
    """The motion filter's single edge of 40x64 pixels gives K3 more blocks
    than the card has SMs; the staged outputs fit a block's 48 KB of static
    shared memory, and a run of them is a whole number of 16-byte stores."""
    assert -(-40 * 64 // K3_TILE) > SMS
    assert max(K3_TILE, K6_TILE) * OUT * 4 <= 48 * 1024
    assert OUT * 4 % 16 == 0


def test_output_index_map():
    """Output o of a tile's run decodes to (pixel, level, a, b) with channel
    49 l + 7 a + b, every channel once, and a the x tap, b the y tap, as the
    plain version lays them out."""
    q, l, a, b = decode(np.arange(2 * OUT))
    assert np.array_equal(q, np.repeat([0, 1], OUT))
    assert np.array_equal(49 * l + 7 * a + b, np.tile(np.arange(OUT), 2))
    h = w = 64                                     # every level holds 100 * row + column
    vol = torch.from_numpy((100.0 * np.arange(h)[:, None] + np.arange(w)).astype(np.float32))
    levels = [vol.reshape(1, 1, h, w)] * LEVELS
    coords = torch.tensor([[[40.0, 32.0]]])        # an integer cell at every level, spans inside
    ref = corr_lookup_pyramid_flat(levels, coords)[0, 0].numpy()
    q, l, a, b = decode(np.arange(OUT))
    x0 = 40 // 2 ** l - R
    y0 = 32 // 2 ** l - R
    np.testing.assert_array_equal(ref, 100.0 * (y0 + b) + (x0 + a))
