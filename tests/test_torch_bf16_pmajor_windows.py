"""The bf16 P-major pyramid and the plain bf16 versions of K6, K7 and K8 (the
port's bfloat16 instantiations corr_lookup_pmajor_bf16,
corr_extract_windows_bf16 and corr_build_windows_levels_bf16) against the
JAX package with dtype=jnp.bfloat16: C.build_pyramid_pmajor, and the Pallas
kernels in interpret mode (corr_lookup_pmajor_pallas,
corr_extract_windows_pallas over corr_build_pmajor_pallas, and
corr_build_windows_pallas; block_p=128).  The cases are
tests/test_torch_pmajor.py's: E=2 at 16x24 with coords off the image, and
E=1 at 12x20 (P = 240, not a multiple of 128).

The port computes in fp32 and rounds once where the TPU kernel stores; the
JAX run rounds after every bf16 operation.  Tolerances, each relative to the
largest magnitude M of the reference (tests/test_torch_bf16_kernels.py's):
- levels, and windows built from features: 2**-7 M (one rounding step of a
  pooled value whose four inputs carry the JAX run's per-add roundings);
- lookups on the same levels: 2**-6 M (the JAX blend rounds four times);
- windows cut from the same levels, and every window base: equal.  Windows
  are compared on the cells the TPU kernels write ([off:off+WH, :WW] of each
  level); past a small level's WW they leave garbage.
Within the port: K8's windows equal K7's cut from K8's levels, and K8's
levels K2's, bit for bit; K6 over the bf16 P-major pyramid is within one
rounding step, 2**-7 M, of K3 over K2's bf16 levels (the two volumes sum
the same products in other orders before they are rounded).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops import corr as C
from droid_slam_reserch_tpu.ops.pallas_corr import (
    _PPAD,
    _pack_offsets,
    _win_shape,
    corr_build_pmajor_pallas,
    corr_build_windows_pallas,
    corr_extract_windows_pallas,
    corr_lookup_pmajor_pallas,
)
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.corr import (
    build_pyramid_pmajor,
    corr_volume_pmajor,
    level_sizes,
    pool2x_pmajor,
)
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    _instance,
    corr_build,
    corr_build_windows_levels,
    corr_extract_windows,
    corr_lookup,
    corr_lookup_pmajor,
)
from test_torch_pmajor import CASES, IDS
from test_torch_pmajor import _case as _case32

torch.set_num_threads(1)
BF16 = torch.bfloat16
TOL_LEVELS = 2.0 ** -7
TOL_LOOKUP = 2.0 ** -6
NEW = ("corr_lookup_pmajor_bf16", "corr_extract_windows_bf16", "corr_build_windows_levels_bf16")


def _case(E, H, W, C_, spread, seed=0):
    """tests/test_torch_pmajor.py's features rounded to bf16, and its coords."""
    f1, f2, coords = _case32(E, H, W, C_, spread, seed)
    t1, t2 = torch.from_numpy(f1).to(BF16), torch.from_numpy(f2).to(BF16)
    return t1, t2, torch.from_numpy(coords), _j(t1), _j(t2), jnp.asarray(coords)


def _j(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _unblock(x, P):
    """Pallas [E, nPB, ..., PB] -> [E, P, ...] float32."""
    x = np.moveaxis(_np(x), -1, 2)
    return x.reshape((x.shape[0], -1) + x.shape[3:])[:, :P]


def _strip(levels, meta, P):
    """Pallas bordered levels -> the port's [E, P, h, w] bf16 levels."""
    return [torch.from_numpy(np.ascontiguousarray(
        _unblock(v, P)[:, :, _PPAD:_PPAD + h, _PPAD:_PPAD + w])).to(BF16)
        for v, (h, w) in zip(levels, meta)]


def _written(meta):
    """(rows, columns) of each level's window that the TPU kernels write."""
    return [(slice(off, off + _win_shape(h, w)[0]), slice(0, _win_shape(h, w)[1]))
            for off, (h, w) in zip(_pack_offsets(meta)[0], meta)]


def _close(out, ref, tol):
    err, scale = float(np.abs(out - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (err, tol * scale)


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_pyramid_pmajor_bf16_matches_jax(E, H, W, C_, spread):
    """build_pyramid_pmajor(dtype=bf16) against the JAX one, and the port's
    rounding rule exactly: the fp32 volume rounded once, each pooled level
    the fp32 mean of the rounded level below it, rounded once."""
    t1, t2, _, j1, j2, _ = _case(E, H, W, C_, spread)
    jpad, jmeta = C.build_pyramid_pmajor(j1, j2, dtype=jnp.bfloat16)
    tpad, tmeta = build_pyramid_pmajor(t1, t2, dtype=BF16)
    assert [tuple(m) for m in jmeta] == tmeta == level_sizes(H, W)
    scale_ref = _np(jpad[0])
    for a, b in zip(tpad, jpad):
        assert a.dtype == BF16 and tuple(a.shape) == b.shape
        err = float(np.abs(a.float().numpy() - _np(b)).max())
        assert err <= TOL_LEVELS * float(np.abs(scale_ref).max()), err
    inner = [v[:, _PPAD:-_PPAD, _PPAD:-_PPAD] for v in tpad]
    assert torch.equal(inner[0], corr_volume_pmajor(t1, t2).to(BF16))
    for lo, hi in zip(inner, inner[1:]):
        assert torch.equal(hi, pool2x_pmajor(lo))
        v = lo.float()[:, : 2 * hi.shape[1], : 2 * hi.shape[2]]
        s = ((v[:, 0::2, 0::2] + v[:, 0::2, 1::2]) + v[:, 1::2, 0::2]) + v[:, 1::2, 1::2]
        assert torch.equal(hi, (s * 0.25).to(BF16))
    assert all(float(v.float().abs().sum()) == float(i.float().abs().sum())
               for v, i in zip(tpad, inner))              # the border is zeros


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_lookup_pmajor_bf16_matches_pallas(E, H, W, C_, spread):
    """K6's plain bf16 version on the JAX bf16 levels."""
    _, _, tc, j1, j2, jc = _case(E, H, W, C_, spread)
    jpad, jmeta = C.build_pyramid_pmajor(j1, j2, dtype=jnp.bfloat16)
    ref = _np(corr_lookup_pmajor_pallas(jpad, jmeta, jc, block_p=128, interpret=True))
    padded = [torch.from_numpy(_np(v)).to(BF16) for v in jpad]
    ops.reset_counts()
    out = corr_lookup_pmajor(padded, tc)
    assert out.dtype == BF16 and tuple(out.shape) == ref.shape == (E, H * W, 196)
    assert ops.counts()["corr_lookup_pmajor_bf16"] == (0, 1)
    _close(out.float().numpy(), ref, TOL_LOOKUP)


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_extract_windows_bf16_matches_pallas(E, H, W, C_, spread):
    """K7's plain bf16 version on the levels of the JAX K2 in bf16: the same
    bases, and the same cells wherever the TPU kernel writes."""
    _, _, tc, j1, j2, jc = _case(E, H, W, C_, spread)
    P = H * W
    plevels, meta, _ = corr_build_pmajor_pallas(j1, j2, dtype=jnp.bfloat16, block_p=128,
                                                interpret=True)
    pwins, pbases = corr_extract_windows_pallas(plevels, meta, jc, interpret=True)
    ops.reset_counts()
    wins, bases = corr_extract_windows(_strip(plevels, meta, P), tc)
    assert wins.dtype == BF16 and ops.counts()["corr_extract_windows_bf16"] == (0, 1)
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])
    pw = _unblock(pwins, P)
    assert tuple(wins.shape) == pw.shape
    for r, c in _written(meta):
        np.testing.assert_array_equal(wins.float().numpy()[:, :, r, c], pw[:, :, r, c])


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_build_windows_levels_bf16_matches_pallas(E, H, W, C_, spread):
    """K8's plain version on bf16 features writes bf16 levels and windows,
    as the JAX K8 does at its default dtype."""
    t1, t2, tc, j1, j2, jc = _case(E, H, W, C_, spread)
    P = H * W
    plevels, pwins, pbases, meta, _ = corr_build_windows_pallas(
        j1, j2, jc, dtype=jnp.bfloat16, block_p=128, interpret=True)
    ops.reset_counts()
    levels, wins, bases = corr_build_windows_levels(t1, t2, tc)
    assert ops.counts()["corr_build_windows_levels_bf16"] == (0, 1)
    assert wins.dtype == BF16 and all(v.dtype == BF16 for v in levels)
    np.testing.assert_array_equal(bases.numpy(), np.asarray(pbases)[:, :, :P])
    ref = _strip(plevels, meta, P)
    scale = float(ref[0].float().abs().max())
    for v, pv in zip(levels, ref):
        assert tuple(v.shape) == tuple(pv.shape)
        err = float((v.float() - pv.float()).abs().max()) if v.numel() else 0.0
        assert err <= TOL_LEVELS * scale, err
    pw = _unblock(pwins, P)
    for r, c in _written(meta):
        err = float(np.abs(wins.float().numpy()[:, :, r, c] - pw[:, :, r, c]).max())
        assert err <= TOL_LEVELS * scale, err


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_k8_k7_k6_agree_in_bf16(E, H, W, C_, spread):
    """K8's windows are K7's cut from K8's levels and its levels K2's, bit for
    bit; K6 over the bf16 P-major pyramid is within one rounding step of K3
    over K2's bf16 levels."""
    t1, t2, tc, _, _, _ = _case(E, H, W, C_, spread, seed=1)
    levels, wins, bases = corr_build_windows_levels(t1, t2, tc)
    w7, b7 = corr_extract_windows(levels, tc)
    assert torch.equal(wins, w7) and torch.equal(bases, b7)
    k2 = corr_build(t1, t2)
    assert all(torch.equal(a, b) for a, b in zip(levels, k2))
    k3 = corr_lookup(k2, tc).float().numpy()
    k6 = corr_lookup_pmajor(build_pyramid_pmajor(t1, t2, dtype=BF16)[0], tc)
    assert k6.dtype == BF16
    _close(k6.float().numpy(), k3, TOL_LEVELS)


def test_bf16_instantiations_counted_by_name():
    """Each new instantiation counts its own calls; the fp32 ones stay at 0.
    fp32 features with bf16 outputs (the JAX default of K2, K4 and K8) have
    no instantiation, and a dtype with none raises rather than being cast,
    on the CPU path as on the card's."""
    t1, t2, tc, _, _, _ = _case(*CASES[1])
    padded = build_pyramid_pmajor(t1, t2, dtype=BF16)[0]
    levels = corr_build(t1, t2)
    ops.reset_counts()
    corr_lookup_pmajor(padded, tc)
    corr_extract_windows(levels, tc)
    corr_build_windows_levels(t1, t2, tc)
    counts = ops.counts()
    assert all(counts[k] == (0, 1) for k in NEW), counts
    assert all(counts[k[:-len("_bf16")]] == (0, 0) for k in NEW), counts
    for kernel in ("corr_build", "corr_build_windows", "corr_build_windows_levels"):
        with pytest.raises(ValueError, match="no instantiation"):
            _instance(kernel, torch.float32, BF16)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_build(t1.float(), t2.float(), BF16)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_build_windows_levels(t1.half(), t2.half(), tc)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_lookup_pmajor([v.half() for v in padded], tc)
    with pytest.raises(ValueError, match="no instantiation"):
        corr_extract_windows([v.half() for v in levels], tc)
    assert all(ops.counts()[k] == (0, 1) for k in NEW)
