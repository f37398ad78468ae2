"""The port's training step with the network in bfloat16
(make_train_step_dynamic(dtype=bfloat16): parameters cast to bf16 for the
network, corr and motion cast in, eta, upmask, delta and weight back to
fp32 before BA) against the JAX package's make_train_step_dynamic with
dtype=jnp.bfloat16 (CPU, 64x64, P = 4, 2 unrolled iterations, the batches
of test_torch_train_step.py, JAX weights mapped by params_from_jax).

bf16 rounding, amplified through 2 iterations of BA and the backward pass,
sets how close two bf16 runs can be.  Readings at these inputs (CPU):
- the port against JAX: loss 5.8e-4 and 6.3e-4 relative, metrics within
  6.3e-4, carry within 7.0e-4, all gradients together 0.072 and 0.082
  relative L2;
- each package against itself with the weights moved by 3e-7 relative:
  loss up to 7.0e-4, metrics up to 2.5e-3, gradients 0.061-0.109;
- JAX bf16 against JAX fp32: loss 1.5e-3 and 2.0e-3, gradients 0.10 and
  0.14.
So the limits: loss within 1e-3 relative (the port in fp32 would miss it),
metrics within 5e-3 relative, carry within 2e-3, and every gradient
except the fnet's zero-in-exact-arithmetic biases (see
test_torch_train_step.py), concatenated, within 0.15 relative L2.
JAX's bf16 step is compiled once (module fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.train import init_train_state as j_init
from droid_slam_reserch_tpu.train.step import make_train_step_dynamic as j_dynamic
from droid_slam_reserch_tpu_torch.models import params_from_jax
from droid_slam_reserch_tpu_torch.train.step import make_train_step_dynamic as t_dynamic

from test_torch_train_step import CFG, ZERO_GRAD, _rel, make_batch, restart_batch, to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bf16_pair():
    jp, _ = j_init(CFG, image_size=(64, 64))
    j_step, _ = j_dynamic(CFG, dtype=jnp.bfloat16)
    t_step = t_dynamic(CFG, dtype=torch.bfloat16)[0]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    base = make_batch()
    out = {}
    for name, b in (("gt-init", base), ("restart-init", restart_batch(base))):
        gj, mj, cj = j_step(jp, {k: jnp.asarray(v) for k, v in b.items()})
        gt, mt, ct = t_step(params, to_torch(b))
        out[name] = ((params_from_jax(jax.tree_util.tree_map(np.asarray, gj)),
                      {k: float(v) for k, v in mj.items()},
                      [np.asarray(x, np.float32) for x in cj]),
                     ({k: v.numpy() for k, v in gt.items()}, {k: float(v) for k, v in mt.items()},
                      [x.float().numpy() for x in ct]))
    return out


@pytest.mark.parametrize("init", ["gt-init", "restart-init"])
def test_bf16_dynamic_step_matches_jax(bf16_pair, init):
    (gj, mj, cj), (gt, mt, ct) = bf16_pair[init]
    assert mt.keys() == mj.keys()
    np.testing.assert_allclose(mt["loss"], mj["loss"], rtol=1e-3)
    for k in mj:
        np.testing.assert_allclose(mt[k], mj[k], rtol=5e-3, atol=1e-6, err_msg=k)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a, b, atol=2e-3)
    names = [k for k in gj if k not in ZERO_GRAD]
    assert all(gt[k].dtype == np.float32 for k in gt)
    rel = _rel(np.concatenate([gt[k].ravel() for k in names]),
               np.concatenate([gj[k].ravel() for k in names]))
    assert rel < 0.15, rel
