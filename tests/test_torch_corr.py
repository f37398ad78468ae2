"""Plain versions of K2 (correlation build) and K3 (pyramid lookup) against
both JAX references: the XLA spec (build_pyramid_flat +
corr_lookup_pyramid_flat) and the Pallas kernels in interpret mode
(corr_build_pmajor_pallas + corr_lookup_blocked_pallas, block_p=128).
Tolerance 1e-5 in float32: the same sums, in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops import corr as jcorr
from droid_slam_reserch_tpu.ops.pallas_corr import (
    corr_build_pmajor_pallas,
    corr_lookup_blocked_pallas,
)
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.cuda_corr import corr_build, corr_lookup

torch.set_num_threads(1)
TOL = 1e-5
PAD = 8  # zero border of the Pallas levels


def _features(E, H, W, C, seed):
    rng = np.random.RandomState(seed)
    f1 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    f2 = (0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1)
    grid = np.broadcast_to(grid.reshape(1, H * W, 2), (E, H * W, 2)).astype(np.float32)
    return f1, f2, grid, rng


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,H,W,C", [(2, 16, 24, 16), (1, 8, 12, 32)], ids=["E2", "E1"])
def test_build_matches_xla_spec(E, H, W, C):
    f1, f2, _, _ = _features(E, H, W, C, 0)
    levels = corr_build(torch.from_numpy(f1), torch.from_numpy(f2))
    ref = jcorr.build_pyramid_flat(jcorr.corr_volume_flat(jnp.asarray(f1), jnp.asarray(f2)))
    assert len(levels) == len(ref) == 4
    for a, b in zip(levels, ref):
        assert tuple(a.shape) == b.shape
        _close(a, b)


def test_build_matches_pallas():
    """Levels as functions of (edge, source pixel, target cell): the Pallas
    levels are [E, nPB, Hp, Wp, PB] with an 8-px zero border."""
    E, H, W, C = 2, 16, 24, 16
    f1, f2, _, _ = _features(E, H, W, C, 1)
    levels = corr_build(torch.from_numpy(f1), torch.from_numpy(f2))
    plv, meta, PB = corr_build_pmajor_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                             dtype=jnp.float32, block_p=128, interpret=True)
    for a, v, (h2, w2) in zip(levels, plv, meta):
        v = np.asarray(v)                                     # [E, nPB, Hp, Wp, PB]
        v = v[:, :, PAD:PAD + h2, PAD:PAD + w2, :].transpose(0, 1, 4, 2, 3)
        v = v.reshape(E, -1, h2, w2)[:, : H * W]
        _close(a, v)


def _lookup_cases(seed, E=2, H=16, W=24, C=16, E1=False):
    f1, f2, grid, rng = _features(E, H, W, C, seed)
    if E1:   # the motion filter's call: one edge at the grid coords
        coords = grid
    else:    # include coords far off the image on every side
        coords = grid + 4.0 * rng.standard_normal(grid.shape).astype(np.float32)
        coords[:, :8] += np.float32(40.0)
        coords[:, 8:16] -= np.float32(40.0)
    return f1, f2, coords.astype(np.float32)


@pytest.mark.parametrize("E1", [False, True], ids=["offimage", "E1-grid"])
def test_lookup_matches_xla_spec(E1):
    f1, f2, coords = _lookup_cases(2, E=1 if E1 else 2, E1=E1)
    levels = corr_build(torch.from_numpy(f1), torch.from_numpy(f2))
    out = corr_lookup(levels, torch.from_numpy(coords))
    pyr = jcorr.build_pyramid_flat(jcorr.corr_volume_flat(jnp.asarray(f1), jnp.asarray(f2)))
    ref = jcorr.corr_lookup_pyramid_flat(pyr, jnp.asarray(coords))
    assert tuple(out.shape) == ref.shape == (coords.shape[0], coords.shape[1], 196)
    _close(out, ref)


@pytest.mark.parametrize("E1", [False, True], ids=["offimage", "E1-grid"])
def test_lookup_matches_pallas(E1):
    f1, f2, coords = _lookup_cases(3, E=1 if E1 else 2, E1=E1)
    levels = corr_build(torch.from_numpy(f1), torch.from_numpy(f2))
    out = corr_lookup(levels, torch.from_numpy(coords))
    plv, meta, _ = corr_build_pmajor_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                            dtype=jnp.float32, block_p=128, interpret=True)
    ref = corr_lookup_blocked_pallas(plv, meta, jnp.asarray(coords), interpret=True)
    _close(out, ref)


def test_cpu_tensors_take_the_plain_versions():
    f1, f2, coords = _lookup_cases(4, E=1, H=8, W=12, C=8)
    ops.reset_counts()
    levels = corr_build(torch.from_numpy(f1), torch.from_numpy(f2))
    corr_lookup(levels, torch.from_numpy(coords))
    assert ops.counts()["corr_build"] == (0, 1)
    assert ops.counts()["corr_lookup"] == (0, 1)


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version."""
    f = torch.empty(1, 8, 12, 8, device="meta")
    with pytest.raises(ValueError):
        corr_build(f, f)
    lv = [torch.empty(1, 96, 8 >> l, 12 >> l, device="meta") for l in range(4)]
    with pytest.raises(ValueError):
        corr_lookup(lv, torch.empty(1, 96, 2, device="meta"))
