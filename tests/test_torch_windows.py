"""Plain versions of K4 (window-cache build) and K5 (windowed lookup), and
the port's drift rule, against the JAX Pallas kernels in interpret mode
(corr_build_windows_light_pallas, corr_lookup_windows_pallas,
window_drift_ok_pallas; block_p=128).

Tolerances: window bases exactly equal; window values and lookups 1e-5 in
float32 (the same sums, in another order).  The drift cases are those of
tests/test_corr.py: small drift, large drift, coords that leave the image
with an interior base, and a six-seed sweep in which "ok implies windowed
== full lookup (port K3)".
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops.pallas_corr import (
    _pack_offsets,
    _win_shape,
    corr_build_windows_light_pallas,
    corr_lookup_windows_pallas,
    window_drift_ok_pallas,
)
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.corr import level_sizes, pack_offsets, window_drift_ok
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    corr_build,
    corr_build_windows,
    corr_lookup,
    corr_lookup_windows,
)

torch.set_num_threads(1)
TOL = 1e-5
# the second: every level smaller than a window; the third: K4's last 8-row
# band not full, and levels narrower than their windows
SHAPES = [(2, 16, 24, 16), (1, 8, 12, 32), (1, 13, 20, 16)]
IDS = ["E2-16x24", "E1-8x12-small", "E1-13x20-ragged"]


def _case(E, H, W, C, seed):
    """Features and first-round coords near the grid, some far off the image."""
    rng = np.random.RandomState(seed)
    f1 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    f2 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    P = H * W
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, P, 2)
    c0 = np.broadcast_to(grid, (E, P, 2)) + 0.5 * rng.standard_normal((E, P, 2))
    c0[:, :6] += 40.0
    c0[:, 6:12] -= 40.0
    return f1, f2, c0.astype(np.float32), grid.astype(np.float32), rng


def _pallas_build(f1, f2, c0):
    wins, bases, meta, _ = corr_build_windows_light_pallas(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(c0), dtype=jnp.float32,
        block_p=128, interpret=True)
    return wins, bases, meta


def _port_build(f1, f2, c0):
    return corr_build_windows(torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(c0))


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_build_windows_matches_pallas(E, H, W, C):
    f1, f2, c0, _, _ = _case(E, H, W, C, 0)
    pwins, pbases, meta = _pallas_build(f1, f2, c0)
    wins, bases = _port_build(f1, f2, c0)
    P = H * W
    assert [tuple(m) for m in meta] == level_sizes(H, W)
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])

    # Pallas windows are [E, nPB, sum WH, max WW, PB]; the port's [E, P, sum WH, max WW]
    pw = np.asarray(pwins)
    pw = pw.transpose(0, 1, 4, 2, 3).reshape(E, -1, pw.shape[2], pw.shape[3])[:, :P]
    offs, sum_wh, ww_max = pack_offsets(level_sizes(H, W))
    assert tuple(wins.shape) == (E, P, sum_wh, ww_max) == pw.shape
    assert offs == list(_pack_offsets(meta)[0])
    for off, (h, w) in zip(offs, meta):
        WH, WW = _win_shape(h, w)      # compare the written region only
        np.testing.assert_allclose(wins.numpy()[:, :, off:off + WH, :WW],
                                   pw[:, :, off:off + WH, :WW], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_lookup_windows_matches_pallas(E, H, W, C):
    f1, f2, c0, _, rng = _case(E, H, W, C, 1)
    pwins, pbases, meta = _pallas_build(f1, f2, c0)
    wins, bases = _port_build(f1, f2, c0)
    c1 = (c0 + rng.uniform(-4.0, 4.0, c0.shape)).astype(np.float32)
    ref = corr_lookup_windows_pallas(pwins, pbases, meta, jnp.asarray(c1), interpret=True)
    out = corr_lookup_windows(wins, bases, torch.from_numpy(c1), (H, W))
    assert tuple(out.shape) == (E, H * W, 196)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)


def _drift_ok_both(pbases, meta, bases, coords, H, W):
    ok_j = bool(window_drift_ok_pallas(pbases, meta, jnp.asarray(coords)))
    ok_t = window_drift_ok(bases, torch.from_numpy(coords), level_sizes(H, W))
    assert ok_t.dtype == torch.bool and ok_t.dim() == 0
    assert bool(ok_t) == ok_j
    return ok_j


def _full_and_windowed(f1, f2, wins, bases, coords, H, W):
    full = corr_lookup(corr_build(torch.from_numpy(f1), torch.from_numpy(f2)),
                       torch.from_numpy(coords))
    return full.numpy(), corr_lookup_windows(wins, bases, torch.from_numpy(coords), (H, W)).numpy()


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_drift_small_ok_and_exact_large_flagged(E, H, W, C):
    f1, f2, c0, _, rng = _case(E, H, W, C, 2)
    pwins, pbases, meta = _pallas_build(f1, f2, c0)
    wins, bases = _port_build(f1, f2, c0)
    c1 = (c0 + rng.uniform(-4.0, 4.0, c0.shape)).astype(np.float32)
    assert _drift_ok_both(pbases, meta, bases, c1, H, W)
    full, winned = _full_and_windowed(f1, f2, wins, bases, c1, H, W)
    np.testing.assert_allclose(winned, full, atol=TOL, rtol=TOL)
    c2 = c0 + np.float32(12.0)
    assert not _drift_ok_both(pbases, meta, bases, c2, H, W)


def test_drift_out_of_image_interior_base():
    """Coords that leave the image above it, with bases cut around interior
    coords: the window would read real rows where the full lookup reads the
    zero border, so the rule must flag it."""
    E, H, W, C = 1, 16, 24, 16
    f1, f2, _, _, _ = _case(E, H, W, C, 3)
    P = H * W
    c0 = np.stack([np.full((E, P), 12.0), np.full((E, P), 7.0)], -1).astype(np.float32)
    pwins, pbases, meta = _pallas_build(f1, f2, c0)
    wins, bases = _port_build(f1, f2, c0)
    c_out = c0.copy()
    c_out[..., 1] = -6.0
    assert not _drift_ok_both(pbases, meta, bases, c_out, H, W)
    full, winned = _full_and_windowed(f1, f2, wins, bases, c_out, H, W)
    assert np.abs(winned - full).max() > 1e-4       # the fallback is needed here


def test_drift_sweep_ok_implies_exact():
    E, H, W, C = 1, 16, 24, 16
    f1, f2, _, grid, _ = _case(E, H, W, C, 4)
    pwins, pbases, meta = _pallas_build(f1, f2, grid)
    wins, bases = _port_build(f1, f2, grid)
    n_ok = 0
    for seed in range(6):
        drift = np.random.RandomState(10 + seed).uniform(-10.0, 10.0, grid.shape)
        c = (grid + drift).astype(np.float32)
        if _drift_ok_both(pbases, meta, bases, c, H, W):
            n_ok += 1
            full, winned = _full_and_windowed(f1, f2, wins, bases, c, H, W)
            np.testing.assert_allclose(winned, full, atol=TOL, rtol=TOL)
    # a drift of a few pixels everywhere stays inside the windows
    c = (grid + np.random.RandomState(20).uniform(-3.0, 3.0, grid.shape)).astype(np.float32)
    assert _drift_ok_both(pbases, meta, bases, c, H, W)


def test_cpu_tensors_take_the_plain_versions():
    E, H, W, C = 1, 8, 12, 8
    f1, f2, c0, _, _ = _case(E, H, W, C, 5)
    ops.reset_counts()
    wins, bases = _port_build(f1, f2, c0)
    corr_lookup_windows(wins, bases, torch.from_numpy(c0), (H, W))
    assert ops.counts()["corr_build_windows"] == (0, 1)
    assert ops.counts()["corr_lookup_windows"] == (0, 1)
    assert ops.counts()["corr_build"] == (0, 0)


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version."""
    f = torch.empty(1, 8, 12, 8, device="meta")
    c = torch.empty(1, 96, 2, device="meta")
    with pytest.raises(ValueError):
        corr_build_windows(f, f, c)
    wins = torch.empty(1, 96, 79, 24, device="meta")
    bases = torch.empty(1, 8, 96, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        corr_lookup_windows(wins, bases, c, (8, 12))
