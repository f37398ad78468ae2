"""The port's lie functions against the JAX package's, on the same seeded
inputs (CPU, float32).  Tolerance 1e-5: both sides evaluate the same
closed forms in float32, so only rounding order differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import lie as jlie
from droid_slam_reserch_tpu_torch import lie as tlie

torch.set_num_threads(1)
TOL = 1e-5


def _poses(rng, n, small=False):
    scale = 1e-5 if small else 1.0
    xi = np.concatenate([rng.standard_normal((n, 3)), 0.5 * scale * rng.standard_normal((n, 3))], 1)
    return np.array(jlie.se3_exp(jnp.asarray(xi, jnp.float32)))


def _check(out_t, out_j):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("small", [False, True], ids=["angle", "tiny-angle"])
def test_se3_exp_log(small):
    rng = np.random.RandomState(0)
    xi = np.concatenate([rng.standard_normal((64, 3)),
                         (1e-5 if small else 0.7) * rng.standard_normal((64, 3))], 1).astype(np.float32)
    _check(tlie.se3_exp(torch.from_numpy(xi)), jlie.se3_exp(jnp.asarray(xi)))
    X = _poses(rng, 64, small)
    _check(tlie.se3_log(torch.from_numpy(X)), jlie.se3_log(jnp.asarray(X)))


@pytest.mark.parametrize("fn", ["se3_inv", "quat_to_matrix"])
def test_unary(fn):
    X = _poses(np.random.RandomState(1), 32)
    arg = X if fn == "se3_inv" else X[:, 3:]
    _check(getattr(tlie, fn)(torch.from_numpy(arg)), getattr(jlie, fn)(jnp.asarray(arg)))


@pytest.mark.parametrize("fn", ["se3_mul", "se3_retr", "se3_act", "se3_adjT"])
def test_binary(fn):
    rng = np.random.RandomState(2)
    X = _poses(rng, 32)
    if fn == "se3_mul":
        Y = _poses(rng, 32)
    elif fn == "se3_act":
        Y = rng.standard_normal((32, 4)).astype(np.float32)
    else:
        Y = (0.3 * rng.standard_normal((32, 6))).astype(np.float32)
    _check(getattr(tlie, fn)(torch.from_numpy(X), torch.from_numpy(Y)),
           getattr(jlie, fn)(jnp.asarray(X), jnp.asarray(Y)))


def test_identity_and_broadcast():
    _check(tlie.se3_identity((3, 2)), jlie.se3_identity((3, 2)))
    rng = np.random.RandomState(3)
    X = _poses(rng, 1)
    P = rng.standard_normal((1, 5, 6, 4)).astype(np.float32)
    _check(tlie.se3_act(torch.from_numpy(X)[:, None, None], torch.from_numpy(P)),
           jlie.se3_act(jnp.asarray(X)[:, None, None], jnp.asarray(P)))
