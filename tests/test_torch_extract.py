"""Plain versions of K7 (window extraction from an existing pyramid) and K8
(pyramid and windows in one pass) against the JAX Pallas kernels in
interpret mode: corr_extract_windows_pallas over corr_build_pmajor_pallas,
and corr_build_windows_pallas (float32, block_p=128).

The JAX outputs are pixel-blocked ([E, nPB, ..., PB], P padded to 128) and
bordered; they are unblocked and, for the levels, stripped of the 8-pixel
border before the comparison.  Tolerances: bases exactly equal; levels and
windows 1e-5 (the same sums in another order).  Windows are compared per
level on the region the JAX kernels write ([off:off+WH, :WW]): at these
sizes some levels have WW < 24, and the JAX kernels leave the columns past
WW unwritten.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops.pallas_corr import (
    _PPAD,
    _pack_offsets,
    _win_shape,
    corr_build_pmajor_pallas,
    corr_build_windows_pallas,
    corr_extract_windows_pallas,
)
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    corr_build,
    corr_build_windows,
    corr_build_windows_levels,
    corr_extract_windows,
    corr_lookup_windows,
)
from test_torch_windows import IDS, SHAPES, _case

torch.set_num_threads(1)
TOL = 1e-5


def _unblock(x, P):
    """[E, nPB, ..., PB] -> [E, P, ...]."""
    x = np.asarray(x)
    x = np.moveaxis(x, -1, 2)
    return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :P]


def _assert_windows(wins, pwins_blocked, meta, P):
    pw = _unblock(pwins_blocked, P)
    assert tuple(wins.shape) == pw.shape
    for off, (h, w) in zip(_pack_offsets(meta)[0], meta):
        WH, WW = _win_shape(h, w)
        np.testing.assert_allclose(wins.numpy()[:, :, off:off + WH, :WW],
                                   pw[:, :, off:off + WH, :WW], atol=TOL, rtol=TOL)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_extract_windows_matches_pallas(E, H, W, C):
    f1, f2, c0, _, _ = _case(E, H, W, C, 0)
    plevels, meta, _ = corr_build_pmajor_pallas(jnp.asarray(f1), jnp.asarray(f2),
                                                dtype=jnp.float32, block_p=128, interpret=True)
    pwins, pbases = corr_extract_windows_pallas(plevels, meta, jnp.asarray(c0), interpret=True)
    t1, t2, tc = _torch(f1, f2, c0)
    wins, bases = corr_extract_windows(corr_build(t1, t2), tc)
    P = H * W
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])
    _assert_windows(wins, pwins, meta, P)


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_build_windows_levels_matches_pallas(E, H, W, C):
    f1, f2, c0, _, _ = _case(E, H, W, C, 1)
    plevels, pwins, pbases, meta, _ = corr_build_windows_pallas(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(c0), dtype=jnp.float32, block_p=128,
        interpret=True)
    levels, wins, bases = corr_build_windows_levels(*_torch(f1, f2, c0))
    P = H * W
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])
    _assert_windows(wins, pwins, meta, P)
    assert len(levels) == len(meta)
    for v, pv, (h, w) in zip(levels, plevels, meta):
        ref = _unblock(pv, P)[:, :, _PPAD:_PPAD + h, _PPAD:_PPAD + w]
        assert tuple(v.shape) == ref.shape == (E, P, h, w)
        np.testing.assert_allclose(v.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_k7_k8_windows_feed_k5_as_k4s_do(E, H, W, C):
    """K5 reads K7's and K8's windows unchanged: the same lookups as over
    K4's, and K7's and K8's windows and bases equal K4's."""
    f1, f2, c0, _, rng = _case(E, H, W, C, 2)
    t1, t2, tc = _torch(f1, f2, c0)
    c1 = torch.from_numpy((c0 + rng.uniform(-4.0, 4.0, c0.shape)).astype(np.float32))
    w4, b4 = corr_build_windows(t1, t2, tc)
    w7, b7 = corr_extract_windows(corr_build(t1, t2), tc)
    _, w8, b8 = corr_build_windows_levels(t1, t2, tc)
    ref = corr_lookup_windows(w4, b4, c1, (H, W))
    for w, b in ((w7, b7), (w8, b8)):
        assert torch.equal(b, b4)
        np.testing.assert_allclose(w.numpy(), w4.numpy(), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(corr_lookup_windows(w, b, c1, (H, W)).numpy(), ref.numpy(),
                                   atol=TOL, rtol=TOL)


def test_cpu_tensors_take_the_plain_versions():
    E, H, W, C = 1, 8, 12, 8
    f1, f2, c0, _, _ = _case(E, H, W, C, 3)
    t1, t2, tc = _torch(f1, f2, c0)
    levels = corr_build(t1, t2)
    ops.reset_counts()
    corr_extract_windows(levels, tc)
    corr_build_windows_levels(t1, t2, tc)
    counts = ops.counts()
    assert counts["corr_extract_windows"] == (0, 1)
    assert counts["corr_build_windows_levels"] == (0, 1)
    assert counts["corr_build"] == counts["corr_build_windows"] == (0, 0)


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    sent to the plain version."""
    c = torch.empty(1, 96, 2, device="meta")
    levels = [torch.empty(1, 96, 8 >> l, 12 >> l, device="meta") for l in range(4)]
    with pytest.raises(ValueError):
        corr_extract_windows(levels, c)
    f = torch.empty(1, 8, 12, 8, device="meta")
    with pytest.raises(ValueError):
        corr_build_windows_levels(f, f, c)
