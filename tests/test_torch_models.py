"""The port's networks against the JAX package's Flax modules, with the same
weights carried over by params_from_jax (CPU, float32).  Tolerance 1e-4
(absolute and relative), as the JAX package's torch parity tests use: the
two frameworks sum the convolutions in different orders."""
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
from droid_slam_reserch_tpu_torch.engine.net_ops import cnet_apply, fnet_apply
from droid_slam_reserch_tpu_torch.models import DroidNet, init_params, params_from_jax

torch.set_num_threads(1)
TOL = 1e-4
h8, w8 = 4, 6


@pytest.fixture(scope="module")
def nets():
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(DroidConfig(), seed=0))
    net = DroidNet()
    net.load_state_dict(params_from_jax(params))
    return params, net.eval()


def _close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=TOL, rtol=TOL)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_state_dict_names_and_shapes(nets):
    params, net = nets
    sd = params_from_jax(params)
    ref = DroidNet().state_dict()
    assert set(sd) == set(ref)
    assert all(sd[k].shape == ref[k].shape for k in ref)
    for k in ("fnet.layer1.0.conv1.weight", "cnet.layer3.0.downsample.0.bias",
              "update.gru.convq.weight", "update.agg.eta.0.weight", "update.weight.2.bias"):
        assert k in sd
    a, b = init_params(seed=3), init_params(seed=3)
    assert set(a) == set(ref) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("which,dim,norm", [("fnet", 128, "instance"), ("cnet", 256, "none")])
def test_basic_encoder(nets, which, dim, norm):
    params, net = nets
    x = np.random.RandomState(0).standard_normal((2, 8 * h8, 8 * w8, 3)).astype(np.float32)
    ref = JEncoder(output_dim=dim, norm_fn=norm).apply({"params": params[which]}, jnp.asarray(x))
    with torch.no_grad():
        out = getattr(net, which)(_t(x))
    assert out.shape == (2, h8, w8, dim)
    _close(out, ref)


def test_conv_gru(nets):
    params, net = nets
    rng = np.random.RandomState(1)
    hid = np.tanh(rng.standard_normal((3, h8, w8, 128))).astype(np.float32)
    ins = [rng.standard_normal((3, h8, w8, c)).astype(np.float32) for c in (128, 128, 64)]
    ref = JConvGRU(128).apply({"params": params["update"]["gru"]}, jnp.asarray(hid),
                              *map(jnp.asarray, ins))
    with torch.no_grad():
        out = net.update.gru(_t(hid).permute(0, 3, 1, 2),
                             *[_t(i).permute(0, 3, 1, 2) for i in ins]).permute(0, 2, 3, 1)
    _close(out, ref)


def _update_inputs(N, seed):
    rng = np.random.RandomState(seed)
    return (np.tanh(rng.standard_normal((1, N, h8, w8, 128))).astype(np.float32),
            np.maximum(rng.standard_normal((1, N, h8, w8, 128)), 0).astype(np.float32),
            rng.standard_normal((1, N, h8, w8, 196)).astype(np.float32),
            (4 * rng.standard_normal((1, N, h8, w8, 4))).astype(np.float32))


def test_update_module_with_graph_agg(nets):
    """The engine's call: kk segments with a padded (masked) edge."""
    params, net = nets
    net_in, inp, corr, flow = _update_inputs(5, 2)
    kk = np.array([0, 0, 1, 2, 0], np.int64)
    emask = np.array([1, 1, 1, 1, 0], np.float32)
    ref = JUpdate().apply({"params": params["update"]}, *map(jnp.asarray, (net_in, inp, corr, flow)),
                          jnp.asarray(kk), 4, jnp.asarray(emask))
    with torch.no_grad():
        out = net.update(_t(net_in), _t(inp), _t(corr), _t(flow), _t(kk), 4, _t(emask))
    assert len(out) == len(ref) == 5
    for a, b in zip(out, ref):
        _close(a, b)


def test_update_module_motion_filter_call(nets):
    """The motion filter's call: one edge, no flow, no aggregation."""
    params, net = nets
    net_in, inp, corr, _ = _update_inputs(1, 3)
    ref = JUpdate().apply({"params": params["update"]}, *map(jnp.asarray, (net_in, inp, corr)), None)
    with torch.no_grad():
        out = net.update(_t(net_in), _t(inp), _t(corr))
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        _close(a, b)


def test_image_entry_points(nets):
    """fnet/cnet from BGR uint8 images, normalisation included."""
    params, net = nets
    img = np.random.RandomState(4).randint(0, 255, (1, 8 * h8, 8 * w8, 3)).astype(np.float32)
    applies = make_applies("float32")
    with torch.no_grad():
        _close(fnet_apply(net, _t(img)), applies["fnet"](params, jnp.asarray(img)))
        for a, b in zip(cnet_apply(net, _t(img)), applies["cnet"](params, jnp.asarray(img))):
            _close(a, b)
