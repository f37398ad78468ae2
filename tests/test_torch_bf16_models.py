"""The port's networks in bf16 against the JAX package's Flax modules with
dtype=jnp.bfloat16, with the same weights carried over by params_from_jax
(the port casts them to bf16 once, as Flax casts them at each layer), on the
same bf16 inputs (CPU).

The two frameworks round at other places: XLA rounds each convolution's
output before adding the bias and rounds after every elementwise operation,
the port's convolutions add the bias before their one rounding.  So outputs
differ by a few bf16 rounding steps, compounded through the layers.
Tolerances, relative to the largest magnitude M of the JAX bf16 output:
- largest difference 2**-5 M (measured up to 1.4e-2 M, the instance-normed
  encoder);
- mean difference 2**-8 M (measured up to 2.1e-3 M);
- the port reproduces the bf16 computation and does not run fp32: its mean
  difference from the JAX bf16 output is below that of the JAX fp32 output
  on the same inputs (measured: about half of it for every output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.net_ops import make_applies
from droid_slam_reserch_tpu.models.extractor import BasicEncoder as JEncoder
from droid_slam_reserch_tpu.models.gru import ConvGRU as JConvGRU
from droid_slam_reserch_tpu.models.update import UpdateModule as JUpdate
from droid_slam_reserch_tpu.utils import DroidConfig
from droid_slam_reserch_tpu_torch.engine.net_ops import cnet_apply, fnet_apply, update_apply
from droid_slam_reserch_tpu_torch.models import DroidNet, params_from_jax

torch.set_num_threads(1)
BF = jnp.bfloat16
h8, w8 = 4, 6


@pytest.fixture(scope="module")
def nets():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(DroidConfig(), seed=0))
    net = DroidNet()
    net.load_state_dict(params_from_jax(params))
    return params, net.eval().to(torch.bfloat16)


def _bf(x):
    """numpy -> the same bf16 values in JAX and in torch."""
    j = jnp.asarray(x, BF)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _check(out, ref_bf16, ref_fp32):
    assert out.dtype == torch.bfloat16 and ref_bf16.dtype == BF
    out = out.float().numpy()
    jb = np.asarray(ref_bf16.astype(jnp.float32))
    jf = np.asarray(ref_fp32, np.float32)
    assert out.shape == jb.shape == jf.shape
    m = float(np.abs(jb).max())
    d_port, d_fp32 = np.abs(out - jb), np.abs(jf - jb)
    assert d_port.max() <= 2.0 ** -5 * m, (d_port.max(), m)
    assert d_port.mean() <= 2.0 ** -8 * m, (d_port.mean(), m)
    assert d_port.mean() < d_fp32.mean(), (d_port.mean(), d_fp32.mean())


@pytest.mark.parametrize("which,dim,norm", [("fnet", 128, "instance"), ("cnet", 256, "none")])
def test_basic_encoder_bf16(nets, which, dim, norm):
    params, net = nets
    xj, xt = _bf(np.random.RandomState(0).standard_normal((2, 8 * h8, 8 * w8, 3)))
    p = {"params": params[which]}
    ref = JEncoder(output_dim=dim, norm_fn=norm, dtype=BF).apply(p, xj)
    ref32 = JEncoder(output_dim=dim, norm_fn=norm).apply(p, xj.astype(jnp.float32))
    with torch.no_grad():
        _check(getattr(net, which)(xt), ref, ref32)


def test_conv_gru_bf16(nets):
    params, net = nets
    rng = np.random.RandomState(1)
    hj, ht = _bf(np.tanh(rng.standard_normal((3, h8, w8, 128))))
    ins = [_bf(rng.standard_normal((3, h8, w8, c))) for c in (128, 128, 64)]
    p = {"params": params["update"]["gru"]}
    ref = JConvGRU(128, dtype=BF).apply(p, hj, *[j for j, _ in ins])
    ref32 = JConvGRU(128).apply(p, hj.astype(jnp.float32), *[j.astype(jnp.float32) for j, _ in ins])
    with torch.no_grad():
        out = net.update.gru(ht.permute(0, 3, 1, 2), *[t.permute(0, 3, 1, 2) for _, t in ins])
    _check(out.permute(0, 2, 3, 1), ref, ref32)


def test_update_module_with_graph_agg_bf16(nets):
    """The engine's call: kk segments with a padded (masked) edge; GraphAgg
    sums the edges in fp32 and casts the mean to bf16."""
    params, net = nets
    rng = np.random.RandomState(2)
    N = 5
    xs = [_bf(x) for x in (np.tanh(rng.standard_normal((1, N, h8, w8, 128))),
                           np.maximum(rng.standard_normal((1, N, h8, w8, 128)), 0),
                           rng.standard_normal((1, N, h8, w8, 196)),
                           4 * rng.standard_normal((1, N, h8, w8, 4)))]
    kk = np.array([0, 0, 1, 2, 0], np.int64)
    emask = np.array([1, 1, 1, 1, 0], np.float32)
    p = {"params": params["update"]}
    ref = JUpdate(dtype=BF).apply(p, *[j for j, _ in xs], jnp.asarray(kk), 4, jnp.asarray(emask))
    ref32 = JUpdate().apply(p, *[j.astype(jnp.float32) for j, _ in xs], jnp.asarray(kk), 4,
                            jnp.asarray(emask))
    with torch.no_grad():
        out = net.update(*[t for _, t in xs], torch.from_numpy(kk), 4, torch.from_numpy(emask))
    assert len(out) == len(ref) == 5
    for a, b, c in zip(out, ref, ref32):
        _check(a, b, c)


def test_image_entry_points_and_update_seam_bf16(nets):
    """fnet/cnet from BGR uint8 images: normalised in fp32, then cast; the
    update seam casts fp32 correlation and motion to the hidden state's dtype."""
    params, net = nets
    img = np.random.RandomState(4).randint(0, 255, (1, 8 * h8, 8 * w8, 3)).astype(np.float32)
    jb, jf = make_applies("bfloat16"), make_applies("float32")
    with torch.no_grad():
        _check(fnet_apply(net, torch.from_numpy(img)), jb["fnet"](params, jnp.asarray(img)),
               jf["fnet"](params, jnp.asarray(img)))
        for a, b, c in zip(cnet_apply(net, torch.from_numpy(img)),
                           jb["cnet"](params, jnp.asarray(img)),
                           jf["cnet"](params, jnp.asarray(img))):
            _check(a, b, c)
        rng = np.random.RandomState(5)
        hid = torch.from_numpy(np.tanh(rng.standard_normal((1, 2, h8, w8, 128)))).to(torch.bfloat16)
        corr = torch.from_numpy(rng.standard_normal((1, 2, h8, w8, 196)).astype(np.float32))
        motn = torch.from_numpy(rng.standard_normal((1, 2, h8, w8, 4)).astype(np.float32))
        out = update_apply(net.update, hid, hid, corr, motn)
        ref = net.update(hid, hid, corr.to(torch.bfloat16), motn.to(torch.bfloat16))
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(out, ref))
