"""The P-major spec (ops/corr.py build_pyramid_pmajor) and K6's plain version
(corr_lookup_pmajor) against the JAX package: C.build_pyramid_pmajor, and
corr_lookup_pmajor_pallas in interpret mode (block_p=128).

Tolerances: the pyramid atol 1e-6, rtol 1e-5 (the same sums in another
order); the lookup rtol 1e-5, atol 1e-6 (the JAX package's own test of the
kernel, tests/test_corr.py), also against the port's K3 plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ops import corr as C
from droid_slam_reserch_tpu.ops.pallas_corr import corr_lookup_pmajor_pallas
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ops.corr import build_pyramid_pmajor, level_sizes
from droid_slam_reserch_tpu_torch.ops.cuda_corr import (
    corr_build,
    corr_lookup,
    corr_lookup_pmajor,
)

torch.set_num_threads(1)
CASES = [(2, 16, 24, 16, 4.0), (1, 12, 20, 8, 0.0)]   # the second: P = 240, not a multiple of 128
IDS = ["E2-16x24-off-image", "E1-12x20-P240"]


def _case(E, H, W, C_, spread, seed=0):
    rng = np.random.RandomState(seed)
    f1 = (0.3 * rng.standard_normal((E, H, W, C_))).astype(np.float32)
    f2 = (0.3 * rng.standard_normal((E, H, W, C_))).astype(np.float32)
    P = H * W
    grid = np.stack(np.meshgrid(np.arange(W), np.arange(H), indexing="xy"), -1).reshape(1, P, 2)
    coords = np.broadcast_to(grid, (E, P, 2)) + spread * rng.standard_normal((E, P, 2))
    if spread:
        coords[:, :5] += 30.0                      # wholly off the image
        coords[:, 5:10] -= 30.0
    return f1, f2, coords.astype(np.float32)


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_build_pyramid_pmajor_matches_jax(E, H, W, C_, spread):
    f1, f2, _ = _case(E, H, W, C_, spread)
    jpad, jmeta = C.build_pyramid_pmajor(jnp.asarray(f1), jnp.asarray(f2))
    tpad, tmeta = build_pyramid_pmajor(torch.from_numpy(f1), torch.from_numpy(f2))
    assert [tuple(m) for m in jmeta] == tmeta == level_sizes(H, W)
    for a, b in zip(tpad, jpad):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_lookup_pmajor_matches_pallas(E, H, W, C_, spread):
    f1, f2, coords = _case(E, H, W, C_, spread)
    jpad, jmeta = C.build_pyramid_pmajor(jnp.asarray(f1), jnp.asarray(f2))
    ref = corr_lookup_pmajor_pallas(jpad, jmeta, jnp.asarray(coords), block_p=128,
                                    interpret=True)
    padded, _ = build_pyramid_pmajor(torch.from_numpy(f1), torch.from_numpy(f2))
    out = corr_lookup_pmajor(padded, torch.from_numpy(coords))
    assert tuple(out.shape) == ref.shape == (E, H * W, 196)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("E,H,W,C_,spread", CASES, ids=IDS)
def test_lookup_pmajor_equals_k3(E, H, W, C_, spread):
    """K6's function is K3's: the zero border and the clipped span start
    give the zeros that K3's bounds checks give."""
    f1, f2, coords = _case(E, H, W, C_, spread, seed=1)
    t1, t2, tc = torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(coords)
    ops.reset_counts()
    out = corr_lookup_pmajor(build_pyramid_pmajor(t1, t2)[0], tc)
    k3 = corr_lookup(corr_build(t1, t2), tc)
    np.testing.assert_allclose(out.numpy(), k3.numpy(), rtol=1e-5, atol=1e-6)
    assert ops.counts()["corr_lookup_pmajor"] == (0, 1)   # CPU tensors: the plain version


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused."""
    padded = [torch.empty(1, (12 >> l) + 16, (20 >> l) + 16, 240, device="meta")
              for l in range(4)]
    with pytest.raises(ValueError):
        corr_lookup_pmajor(padded, torch.empty(1, 240, 2, device="meta"))
