"""The port's optimizer, schedule and checkpoints against the JAX
package's (CPU, float32).

- three AdamW steps on fixed gradients (with the global-norm clip both
  triggered and not) against optax's chain: parameters within 1e-6;
- a gradient with a NaN entry: the entry is zeroed, as optax's chain
  zeroes it, and every parameter stays finite;
- the OneCycle schedule against the JAX onecycle_schedule's values
  (1e-4 relative: JAX evaluates the cosine in float32, the port in
  float64);
- resume equivalence, exactly: 4 training steps straight against 2, a
  checkpoint saved and loaded, and 2 more;
- a checkpoint of the port read by the JAX package's load_ckpt, and by the
  port's load_weights; a JAX checkpoint read by the port as a warm start."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.train import TrainConfig
from droid_slam_reserch_tpu.train import load_ckpt as j_load_ckpt
from droid_slam_reserch_tpu.train import save_ckpt as j_save_ckpt
from droid_slam_reserch_tpu.train.step import make_optimizer as j_make_optimizer
from droid_slam_reserch_tpu.train.step import make_schedule as j_make_schedule
from droid_slam_reserch_tpu_torch.models import init_params, load_weights, params_from_jax
from droid_slam_reserch_tpu_torch.models.convert import params_to_jax
from droid_slam_reserch_tpu_torch.train import load_ckpt, save_ckpt
from droid_slam_reserch_tpu_torch.train.step import (init_opt_state, make_optimizer,
                                                     make_schedule, make_train_step_dynamic)

from test_torch_train_step import CFG as STEP_CFG
from test_torch_train_step import make_batch, to_torch

torch.set_num_threads(2)
CFG = TrainConfig(steps=1000, lr=2.5e-4)


def _grads(seed, scale):
    sd = init_params(0)
    g = torch.Generator().manual_seed(seed)
    return {k: scale * torch.randn(v.shape, generator=g) for k, v in sd.items()}


def _jax_tree(sd):
    return jax.tree_util.tree_map(jnp.asarray, params_to_jax(sd))


@pytest.mark.parametrize("scale", [1e-4, 1.0], ids=["under-clip", "clipped"])
def test_adamw_matches_optax(scale):
    params = init_params(0)
    opt, jopt = make_optimizer(CFG), j_make_optimizer(CFG)
    state, jparams = init_opt_state(params), _jax_tree(params)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    for t in range(3):
        grads = _grads(t, scale)
        if t == 1:
            grads["update.gru.convq.weight"][0, 0, 0, 0] = float("nan")
        params, state = opt(params, state, grads)
        u, jstate = jupdate(_jax_tree(grads), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, d: p + d, jparams, u)
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert state["count"] == 3
    for k in params:
        assert torch.isfinite(params[k]).all()
        torch.testing.assert_close(params[k], mine[k], rtol=0, atol=1e-6)


def test_schedule_matches_jax():
    for cfg in (CFG, dataclasses.replace(CFG, steps=10), dataclasses.replace(CFG, steps=250000)):
        mine, ref = make_schedule(cfg), j_make_schedule(cfg)
        counts = list(range(0, 40)) + list(range(40, cfg.steps + 5, max(cfg.steps // 97, 1)))
        np.testing.assert_allclose([mine(c) for c in counts], [float(ref(c)) for c in counts],
                                   rtol=1e-4, atol=1e-10)


def _run(params, state, t0, t1, grad_step, apply_step):
    for t in range(t0, t1):
        grads, _, _ = grad_step(params, to_torch(make_batch(100 + t)))
        params, state = apply_step(params, state, grads)
    return params, state


def test_resume_is_exact(tmp_path):
    cfg = dataclasses.replace(STEP_CFG, iters=1)
    grad_step, apply_step = make_train_step_dynamic(cfg)
    p0 = init_params(0)
    s0 = init_opt_state(p0)
    p_straight, s_straight = _run(p0, s0, 0, 4, grad_step, apply_step)

    p_half, s_half = _run(p0, s0, 0, 2, grad_step, apply_step)
    path = str(tmp_path / "ck.npz")
    save_ckpt(path, p_half, s_half, 2)
    p_re, s_re, step = load_ckpt(path)
    assert step == 2 and s_re["count"] == 2
    p_resumed, s_resumed = _run(p_re, s_re, step, 4, grad_step, apply_step)
    for k in p_straight:
        assert torch.equal(p_resumed[k], p_straight[k]), k
        assert torch.equal(s_resumed["mu"][k], s_straight["mu"][k]), k
        assert torch.equal(s_resumed["nu"][k], s_straight["nu"][k]), k


def test_checkpoints_cross_packages(tmp_path, capsys):
    params = {k: v + 0.5 for k, v in init_params(3).items()}
    state = init_opt_state(params)
    path = str(tmp_path / "port.npz")
    save_ckpt(path, params, state, 7)
    jparams, jstate, jstep = j_load_ckpt(path)
    assert jstate is None and jstep == 7
    back = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    weights = load_weights(path)
    for k in params:
        assert torch.equal(back[k], params[k]) and torch.equal(weights[k], params[k]), k

    jp = _jax_tree(init_params(4))
    js = j_make_optimizer(CFG).init(jp)
    jpath = str(tmp_path / "jax.npz")
    j_save_ckpt(jpath, jp, js, 5)
    p, opt_state, step = load_ckpt(jpath)
    assert opt_state is None and step == 0
    assert "warm start" in capsys.readouterr().out
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for k in ref:
        assert torch.equal(p[k], ref[k]), k
