"""The JAX package's public names that the port mirrors last, against the
JAX package on the CPU (fp32, atol 1e-5):

- ``models.BottleneckBlock`` (weights through params_from_jax's mapping),
  with instance norm and none, at stride 1 and 2;
- ``ops.pack_pyramid`` / ``ops.packed_lookup``: the packed volume and its
  lookup equal the JAX package's, and the lookup equals the port's
  corr_lookup_pyramid;
- ``parallel.is_distributed``: false without a group and in a group of one
  rank, true on both ranks of a two-rank gloo group;
- ``utils.Timer``: the JAX package's wall-clock timer.
"""
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu import ops as jops
from droid_slam_reserch_tpu import utils as jutils
from droid_slam_reserch_tpu.models import BottleneckBlock as JBottleneck
from droid_slam_reserch_tpu_torch import ops as tops
from droid_slam_reserch_tpu_torch import parallel, utils
from droid_slam_reserch_tpu_torch.models import BottleneckBlock, params_from_jax
from droid_slam_reserch_tpu_torch.ops import corr as tcorr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("norm", ["instance", "none"])
def test_bottleneck_block_matches_jax(norm, stride):
    cin = planes = 32
    x = np.random.RandomState(stride).randn(2, 12, 16, cin).astype(np.float32)
    block = JBottleneck(planes, norm, stride)
    params = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"])
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    sd = params_from_jax({"fnet": {"layer1_0": params}})
    prefix = "fnet.layer1.0."
    port = BottleneckBlock(cin, planes, norm, stride)
    port.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_packed_lookup_matches_jax_and_pyramid_lookup():
    rng = np.random.RandomState(0)
    E, H1, W1, H2, W2 = 2, 4, 5, 12, 20
    vol = rng.randn(E, H1, W1, H2, W2).astype(np.float32)
    coords = np.stack([rng.uniform(-4, W2 + 4, (E, H1, W1)),
                       rng.uniform(-4, H2 + 4, (E, H1, W1))], -1).astype(np.float32)
    tpyr = tcorr.build_pyramid(torch.from_numpy(vol))
    jpyr = [jnp.asarray(v.numpy()) for v in tpyr]
    tpacked, tmeta = tops.pack_pyramid(tpyr)
    jpacked, jmeta = jops.pack_pyramid(jpyr)
    assert tmeta == jmeta
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    got = tops.packed_lookup(tpacked, tmeta, torch.from_numpy(coords))
    ref = np.asarray(jops.packed_lookup(jpacked, jmeta, jnp.asarray(coords)))
    assert got.shape == ref.shape == (E, H1, W1, 4 * 49)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), tcorr.corr_lookup_pyramid(tpyr, torch.from_numpy(coords)).numpy(), atol=1e-5)


RANK_SCRIPT = """
import sys
import torch.distributed as dist
from droid_slam_reserch_tpu_torch import parallel
port, rank, world = sys.argv[1:4]
before = parallel.is_distributed()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=int(world),
                        rank=int(rank))
print(before, parallel.is_distributed())
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_is_distributed(world):
    assert not parallel.is_distributed()
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(port), str(r), str(world)],
                              cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split() == ["False", str(world > 1)]


def test_timer_matches_jax():
    a, b = utils.Timer(), jutils.Timer()
    time.sleep(0.02)
    ta, tb = a.elapsed(), b.elapsed()
    assert 0.02 <= ta < 5 and 0.02 <= tb < 5
    assert abs(ta - tb) < 0.01
