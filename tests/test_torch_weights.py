"""``DroidConfig.weights`` in the port against the JAX package (CPU).

A state_dict in the upstream ``droid.pth`` layout is built from the port's
seeded ``init_params``: the DataParallel ``module.`` prefix on every key,
the update operator's weight and delta heads padded to the 3 output
channels they were trained with, and the GRU's convzr split into convz and
convr.  The port's ``Droid`` and the JAX ``init_params`` both load it; after
``params_from_jax`` the JAX weights are the port's tensors, bit for bit, and
both are the seeded weights the file was made from.  An ``.npz`` of JAX
params loads into the same tensors, and a missing file raises.
"""
import jax
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.utils import DroidConfig as JConfig
from droid_slam_reserch_tpu_torch.engine import Droid
from droid_slam_reserch_tpu_torch.models import init_params, params_from_jax
from droid_slam_reserch_tpu_torch.utils import DroidConfig

SMALL = dict(image_size=(64, 96), buffer=8)


def droid_pth_layout(sd, prefix="module."):
    """The port's state_dict as upstream DROID-SLAM saves it."""
    out = {}
    gen = torch.Generator().manual_seed(1)
    for k, v in sd.items():
        if k.startswith(("update.weight.2.", "update.delta.2.")):
            v = torch.cat([v, torch.rand((1,) + v.shape[1:], generator=gen)])   # trained 3rd channel
        if ".gru.convzr" in k:
            z, r = v.chunk(2)
            out[prefix + k.replace("convzr", "convz")] = z.clone()
            out[prefix + k.replace("convzr", "convr")] = r.clone()
            continue
        out[prefix + k] = v.clone()
    return out


def port_weights(path):
    d = Droid(DroidConfig(weights=str(path), **SMALL), device="cpu")
    return d.net.state_dict()


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("prefix", ["module.", ""], ids=["dataparallel", "bare"])
def test_droid_pth_loads_the_same_tensors_in_both_packages(tmp_path, prefix):
    seeded = init_params(seed=0)
    layout = droid_pth_layout(seeded, prefix)
    assert any(k.endswith("gru.convz.weight") for k in layout)
    assert layout[f"{prefix}update.delta.2.weight"].shape[0] == 3
    path = tmp_path / "droid.pth"
    torch.save(layout, path)

    mine = port_weights(path)
    jax_params = jax.tree_util.tree_map(np.asarray, jax_init_params(JConfig(weights=str(path))))
    assert_same(mine, params_from_jax(jax_params))
    assert_same(mine, seeded)


def test_port_state_dict_still_loads(tmp_path):
    seeded = init_params(seed=3)
    path = tmp_path / "port.pt"
    torch.save(seeded, path)
    assert_same(port_weights(path), seeded)


def test_npz_of_jax_params_loads_the_same_tensors(tmp_path):
    pth = tmp_path / "droid.pth"
    torch.save(droid_pth_layout(init_params(seed=2)), pth)
    jax_params = jax.tree_util.tree_map(np.asarray, jax_init_params(JConfig(weights=str(pth))))
    npz = tmp_path / "params.npz"
    np.savez(npz, params=np.array(jax_params, dtype=object))
    # the JAX package reads the same file into the same params
    again = jax.tree_util.tree_map(np.asarray, jax_init_params(JConfig(weights=str(npz))))
    assert_same(params_from_jax(again), params_from_jax(jax_params))
    assert_same(port_weights(npz), params_from_jax(jax_params))
    assert_same(port_weights(npz), init_params(seed=2))


@pytest.mark.parametrize("name", ["missing.pth", "missing.npz"])
def test_missing_weights_raise(tmp_path, name):
    with pytest.raises(FileNotFoundError):
        Droid(DroidConfig(weights=str(tmp_path / name), **SMALL), device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_init_params(JConfig(weights=str(tmp_path / name)))
