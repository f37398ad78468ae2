"""The plain bf16 versions of K2, K3, K4 and K5 (the port's bfloat16 compute
path) against the JAX Pallas kernels with dtype=jnp.bfloat16 in interpret
mode (corr_build_pmajor_pallas, corr_lookup_blocked_pallas,
corr_build_windows_light_pallas, corr_lookup_windows_pallas; block_p=128),
K2 on bf16 features with fp32 levels against the JAX corr_volume_flat and
build_pyramid_flat, and the backend's K2 + K3 against altcorr_pyramid.

The port computes in fp32 and rounds once where the TPU kernel stores (each
level, each window, each lookup output); the JAX interpret run rounds after
every bf16 operation (the pooling adds, the bilinear products and sums).  So
the two differ by a few bf16 rounding steps.  Tolerances, each relative to
the largest magnitude M of the reference:
- levels and windows: 2**-7 M (measured 2.7e-3 M: one rounding step of a
  pooled value, whose four inputs carry the JAX run's per-add roundings);
- lookups: 2**-6 M (measured 9.7e-3 M: the JAX blend rounds four times);
- window bases: equal;
- K2 bf16 -> fp32 levels: 1e-6 absolute (both sum exact bf16 products in
  fp32; only the order differs);
- the backend's correlation: 2**-7 M (JAX pools the bf16 features in bf16,
  the port pools the fp32 volume; measured in the test).
The port's rounding rule itself is held exactly: every bf16 level is the
fp32 mean of the rounded level below, rounded once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops import corr as jcorr
from droid_slam_reserch_tpu.ops.pallas_corr import (
    _PPAD,
    _win_shape,
    corr_build_pmajor_pallas,
    corr_build_windows_light_pallas,
    corr_lookup_blocked_pallas,
    corr_lookup_windows_pallas,
)
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.corr import (
    level_sizes,
    pack_offsets,
    pool2x_volume_flat,
    window_drift_ok,
)
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    corr_build,
    corr_build_plain,
    corr_build_windows,
    corr_lookup,
    corr_lookup_windows,
)

torch.set_num_threads(1)
BF16 = torch.bfloat16
TOL_LEVELS = 2.0 ** -7
TOL_LOOKUP = 2.0 ** -6
SHAPES = [(2, 16, 24, 32), (1, 8, 12, 32), (1, 13, 20, 16)]
IDS = ["E2-16x24", "E1-8x12-small", "E1-13x20-ragged"]


def _case(E, H, W, C, seed):
    """bf16 features (as numpy fp32 holding bf16 values) and coords near the
    grid, some far off the image."""
    rng = np.random.RandomState(seed)
    f1, f2 = (torch.from_numpy((0.3 * rng.standard_normal((E, H, W, C))).astype(np.float32))
              .to(BF16) for _ in range(2))
    P = H * W
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, P, 2)
    c = np.broadcast_to(grid, (E, P, 2)) + 2.0 * rng.standard_normal((E, P, 2))
    c[:, :6] += 40.0
    c[:, 6:12] -= 40.0
    return f1, f2, c.astype(np.float32), rng


def _j(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _unblock(v, E, P):
    """Pallas [E, nPB, R, S, PB] -> [E, P, R, S]."""
    v = _np(v)
    return v.transpose(0, 1, 4, 2, 3).reshape(E, -1, v.shape[2], v.shape[3])[:, :P]


def _close(out, ref, tol, scale):
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_build_and_lookup_match_pallas(E, H, W, C):
    f1, f2, coords, _ = _case(E, H, W, C, 0)
    P = H * W
    plevels, meta, _ = corr_build_pmajor_pallas(_j(f1), _j(f2), dtype=jnp.bfloat16,
                                                block_p=128, interpret=True)
    ops.reset_counts()
    levels = corr_build(f1, f2)
    assert ops.counts()["corr_build_bf16"] == (0, 1)
    assert [tuple(m) for m in meta] == level_sizes(H, W)
    ref = [_unblock(v, E, P)[:, :, _PPAD:_PPAD + h, _PPAD:_PPAD + w]
           for v, (h, w) in zip(plevels, meta)]
    scale = float(np.abs(ref[0]).max())
    for a, b in zip(levels, ref):
        assert a.dtype == BF16
        _close(a.float().numpy(), b, TOL_LEVELS, scale)

    pref = _np(corr_lookup_blocked_pallas(plevels, meta, jnp.asarray(coords), interpret=True))
    out = corr_lookup(levels, torch.from_numpy(coords))
    assert out.dtype == BF16 and tuple(out.shape) == (E, P, 196)
    assert ops.counts()["corr_lookup_bf16"] == (0, 1)
    _close(out.float().numpy(), pref, TOL_LOOKUP, float(np.abs(pref).max()))


@pytest.mark.parametrize("E,H,W,C", SHAPES, ids=IDS)
def test_windows_build_and_lookup_match_pallas(E, H, W, C):
    f1, f2, c0, rng = _case(E, H, W, C, 1)
    P = H * W
    pwins, pbases, meta, _ = corr_build_windows_light_pallas(
        _j(f1), _j(f2), jnp.asarray(c0), dtype=jnp.bfloat16, block_p=128, interpret=True)
    ops.reset_counts()
    wins, bases = corr_build_windows(f1, f2, torch.from_numpy(c0))
    assert wins.dtype == BF16 and ops.counts()["corr_build_windows_bf16"] == (0, 1)
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])
    pw = _unblock(pwins, E, P)
    offs, _, _ = pack_offsets(level_sizes(H, W))
    regions = [(slice(off, off + _win_shape(h, w)[0]), slice(0, _win_shape(h, w)[1]))
               for off, (h, w) in zip(offs, meta)]        # the written cells only
    scale = max(float(np.abs(pw[:, :, r, c]).max()) for r, c in regions)
    for r, c in regions:
        _close(wins.float().numpy()[:, :, r, c], pw[:, :, r, c], TOL_LEVELS, scale)

    c1 = (c0 + rng.uniform(-4.0, 4.0, c0.shape)).astype(np.float32)
    ref = _np(corr_lookup_windows_pallas(pwins, pbases, meta, jnp.asarray(c1), interpret=True))
    out = corr_lookup_windows(wins, bases, torch.from_numpy(c1), (H, W))
    assert out.dtype == BF16 and ops.counts()["corr_lookup_windows_bf16"] == (0, 1)
    _close(out.float().numpy(), ref, TOL_LOOKUP, float(np.abs(ref).max()))


def test_rounding_rule_is_exact():
    """Each bf16 level is the fp32 mean of the rounded level below it,
    rounded once; level 0 is the fp32 volume rounded once; the windowed
    lookup inside K4's windows equals the pyramid lookup in K2's levels."""
    f1, f2, coords, _ = _case(1, 16, 24, 32, 2)
    levels = corr_build(f1, f2)
    fp32 = corr_build(f1, f2, torch.float32)
    assert all(v.dtype == torch.float32 for v in fp32)
    assert torch.equal(levels[0], fp32[0].to(BF16))
    for lo, hi in zip(levels, levels[1:]):
        assert torch.equal(hi, pool2x_volume_flat(lo))
        v = lo.float()[..., : 2 * hi.shape[-2], : 2 * hi.shape[-1]]
        s = ((v[..., 0::2, 0::2] + v[..., 0::2, 1::2]) + v[..., 1::2, 0::2]) + v[..., 1::2, 1::2]
        assert torch.equal(hi, (s * 0.25).to(BF16))
    c0 = torch.from_numpy(coords)
    wins, bases = corr_build_windows(f1, f2, c0)
    near = (c0 + 0.5).contiguous()
    assert bool(window_drift_ok(bases, near, level_sizes(16, 24)))
    assert torch.equal(corr_lookup_windows(wins, bases, near, (16, 24)), corr_lookup(levels, near))


@pytest.mark.parametrize("E,H,W,C", SHAPES[:1], ids=IDS[:1])
def test_build_to_fp32_levels_matches_corr_volume(E, H, W, C):
    """The motion filter's and the backend's K2: bf16 features, fp32 levels,
    as the JAX package's corr_volume (dtype=None) and its fp32 pyramid."""
    f1, f2, _, _ = _case(E, H, W, C, 3)
    ops.reset_counts()
    levels = corr_build(f1, f2, torch.float32)
    assert ops.counts()["corr_build_bf16_f32"] == (0, 1)
    ref = jcorr.build_pyramid_flat(jcorr.corr_volume_flat(_j(f1), _j(f2)))
    for a, b in zip(levels, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)


def test_backend_correlation_matches_altcorr_pyramid():
    """The port's backend chunk (K2 bf16 -> fp32, then fp32 K3) against the
    JAX backend's altcorr_pyramid over the same bf16 features, whose target
    pyramid pools the features in bf16."""
    E, H, W, C = 2, 16, 24, 32
    f1, f2, coords, _ = _case(E, H, W, C, 4)
    jpyr = [_j(f2)]
    for _ in range(3):
        jpyr.append(jcorr.pool2x_fmap(jpyr[-1]))
    assert jpyr[-1].dtype == jnp.bfloat16
    c4 = coords.reshape(E, H, W, 2)
    ref = _np(jcorr.altcorr_pyramid(_j(f1), jpyr, jnp.asarray(c4))).reshape(E, H * W, -1)
    out = corr_lookup(corr_build(f1, f2, torch.float32), torch.from_numpy(coords))
    assert out.dtype == torch.float32
    _close(out.numpy(), ref, TOL_LEVELS, float(np.abs(ref).max()))


def test_no_instantiation_no_cast():
    """fp32 features have no bf16-level instantiation: the wrapper raises
    rather than casting, on the CPU path as on the card's."""
    f1, f2, _, _ = _case(1, 8, 12, 16, 5)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_build(f1.float(), f2.float(), BF16)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_build_plain(f1.half(), f2.half())


def test_lookup_weights_follow_the_tpu_cast(monkeypatch):
    """The TPU lookups cast the bilinear weights to the volume's dtype
    (pallas_corr.py:252-253); the plain bf16 K3 rounds them to bf16 too.  On
    the interpret run's own levels, that gives fewer outputs that differ from
    the interpret run's than weights kept in fp32 do."""
    from droid_slam_reserch_tpu_torch.ops import corr as tcorr

    E, H, W, C = SHAPES[0]
    f1, f2, coords, _ = _case(E, H, W, C, 6)
    plevels, meta, _ = corr_build_pmajor_pallas(_j(f1), _j(f2), dtype=jnp.bfloat16,
                                                block_p=128, interpret=True)
    ref = _np(corr_lookup_blocked_pallas(plevels, meta, jnp.asarray(coords), interpret=True))
    levels = [torch.from_numpy(_unblock(v, E, H * W)[:, :, _PPAD:_PPAD + h, _PPAD:_PPAD + w])
              .to(BF16) for v, (h, w) in zip(plevels, meta)]
    c = torch.from_numpy(coords)
    rounded = int((corr_lookup(levels, c).float().numpy() != ref).sum())
    monkeypatch.setattr(tcorr, "_weights", lambda x, xf, dtype: (x - xf)[..., None, None])
    kept = int((corr_lookup(levels, c).float().numpy() != ref).sum())
    assert rounded < kept, (rounded, kept)
