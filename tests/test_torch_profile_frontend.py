"""The port's fused_rounds against the JAX package's _fused_rounds, and the
port's frontend profiler on the CPU, at bench.py's small shape (h8, w8, N,
MW) = (8, 16, 16, 8): 6 rounds of 2 BA iterations.

The same numpy inputs and the JAX ``init_params(seed=0)`` weights (carried
over by params_from_jax) go through both.  The JAX function runs its CPU
``flat`` correlation; the port's runs its windowed path (K4 once, then K5),
the same function wherever the drift rule holds.  Tolerances: poses, nets,
weight, damping and the last upsampling mask 1e-4 absolute; disparities
and targets 2e-4 times the output's largest magnitude (1.4 and 20 pixels
here): random weights make the update operator sensitive to float32
summation order, and six rounds of BA compound it (measured: disparities
1.3e-4, targets 3.9e-4).  The culling distance 1e-4 relative; the
profiler's max errors 1e-5, and in bf16 one rounding step, 2**-7 of the
largest lookup (K6 reads the P-major pyramid, whose volume sums the same
products in another order before it is rounded).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_reserch_tpu.ba.solver import schur_pairs as jax_schur_pairs
from droid_slam_reserch_tpu.engine.droid import init_params as jax_init_params
from droid_slam_reserch_tpu.engine.factor_graph import _fused_rounds
from droid_slam_reserch_tpu.engine.net_ops import make_applies
from droid_slam_reserch_tpu.lie import se3_exp as jax_se3_exp
from droid_slam_reserch_tpu.utils import DroidConfig
from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.ba.solver import schur_pairs
from droid_slam_reserch_tpu_torch.engine import factor_graph as tfg
from droid_slam_reserch_tpu_torch.engine.net_ops import update_apply
from droid_slam_reserch_tpu_torch.models import DroidNet, params_from_jax
from droid_slam_reserch_tpu_torch.tools.profile_frontend import SMALL, edge_graph, profile

torch.set_num_threads(1)
ROUNDS = 6
H8, W8, N, MW = SMALL["h8"], SMALL["w8"], SMALL["N"], SMALL["MW"]


def _inputs():
    """bench.py's state at the small shape, from a numpy seed, with nonzero
    nets and inps so that the update operator's state matters."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    ii, jj = edge_graph(N, MW)
    fmaps = (0.1 * rng.standard_normal((MW, H8, W8, 128))).astype(f32)
    has_edge = np.zeros(MW, bool)
    has_edge[ii] = True
    return dict(
        xi=(0.03 * rng.standard_normal((MW, 6))).astype(f32),
        disps=np.ones((MW, H8, W8), f32),
        dsens=np.zeros((MW, H8, W8), f32),
        damping=np.full((MW, H8, W8), 1e-6, f32),
        intr=np.array([W8 * 4.0, W8 * 4.0, W8 / 2.0, H8 / 2.0], f32),
        f1=fmaps[ii], f2=fmaps[jj],
        nets=np.tanh(rng.standard_normal((N, H8, W8, 128))).astype(f32),
        inps=np.maximum(rng.standard_normal((N, H8, W8, 128)), 0).astype(f32),
        target=np.zeros((N, H8, W8, 2), f32),
        ii=ii, jj=jj, has_edge=has_edge, free=np.arange(MW) >= 1,
        cull=np.array([MW - 3, MW - 2]))


@pytest.fixture(scope="module")
def both():
    x = _inputs()
    cfg = DroidConfig(image_size=(H8 * 8, W8 * 8), buffer=MW, compute_dtype="float32")
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(cfg.replace(image_size=(64, 64)), seed=0))
    poses = np.array(jax_se3_exp(jnp.asarray(x["xi"])))
    be, bm = schur_pairs(x["ii"], MW)
    jbe, jbm = jax_schur_pairs(x["ii"], MW)
    np.testing.assert_array_equal(be, jbe)
    np.testing.assert_array_equal(bm, jbm)
    empty = np.zeros((0, H8, W8, 2), np.float32)
    J = jnp.asarray
    ref = _fused_rounds(
        make_applies("float32")["update"], params, J(poses), J(x["disps"]), J(x["dsens"]),
        J(x["damping"]), J(x["intr"]), J(x["f1"]), J(x["f2"]), J(x["nets"]), J(x["inps"]),
        J(x["target"]), J(x["ii"]), J(x["jj"]), J(x["ii"]), jnp.ones(N, bool),
        J(x["has_edge"]), J(x["ii"]), J(x["jj"]), J(empty), J(empty), J(x["free"]), J(jbe),
        J(jbm), J(x["cull"].astype(np.int32)), rounds=ROUNDS, ba_iters=2, lm=1e-4, ep=0.1,
        damping_eps=1e-7, min_depth=0.25, beta=0.3, dtype=jnp.float32, with_cull=True)

    net = DroidNet()
    net.load_state_dict(params_from_jax(params))
    net.eval().requires_grad_(False)
    T = torch.from_numpy
    ops.reset_counts()
    tfg.reset_corr_rounds()
    with torch.no_grad():
        out = tfg.fused_rounds(
            update_apply, net.update, T(poses), T(x["disps"]), T(x["dsens"]), T(x["damping"]),
            T(x["intr"]), T(x["f1"]), T(x["f2"]), T(x["nets"]), T(x["inps"]), T(x["target"]),
            T(x["ii"]), T(x["jj"]), T(x["ii"]), torch.ones(N, dtype=torch.bool),
            T(x["has_edge"]), T(x["ii"]), T(x["jj"]), T(empty), T(empty), T(x["free"]),
            T(be).long(), T(bm), T(x["cull"]), rounds=ROUNDS, ba_iters=2, lm=1e-4, ep=0.1,
            damping_eps=1e-7, min_depth=0.25, beta=0.3)
    return ref, out, ops.counts(), tfg.corr_rounds()


NAMES = ["poses", "disps", "damping", "nets", "target", "weight"]
SCALED = {"disps", "target"}


@pytest.mark.parametrize("k", range(len(NAMES)), ids=NAMES)
def test_fused_rounds_matches_jax(both, k):
    ref, out, _, _ = both
    want = np.asarray(ref[k])
    assert tuple(out[k].shape) == want.shape
    tol = 2e-4 * max(1.0, float(np.abs(want).max())) if NAMES[k] in SCALED else 1e-4
    np.testing.assert_allclose(out[k].numpy(), want, atol=tol)


def test_fused_rounds_cull_distance_and_upmask(both):
    ref, out, _, _ = both
    np.testing.assert_allclose(float(out[7]), float(ref[7]), rtol=1e-4)
    assert tuple(out[6].shape) == ref[6].shape == (MW, H8, W8, 576)
    np.testing.assert_allclose(out[6].numpy(), np.asarray(ref[6]), atol=1e-4)


def test_fused_rounds_reads_the_window_cache(both):
    """K4 once, then K5 every round, on the plain versions (CPU tensors)."""
    _, _, counts, rounds = both
    assert rounds == {"windowed": ROUNDS, "fallback": 0}
    assert counts["corr_build_windows"] == (0, 1)
    assert counts["corr_lookup_windows"] == (0, ROUNDS)
    assert counts["ba_blocks"] == (0, 2 * ROUNDS)


KEYS = ["reproject_ms", "build_plain_ms", "build_k2_ms", "build_k8_ms", "lookup_plain_ms",
        "lookup_k3_ms", "lookup_k6_ms", "extract_k7_ms", "lookup_k5_ms", "k3_max_err",
        "k6_max_err", "k5_max_err", "update_module_ms", "ba_2iter_plain_ms", "ba_2iter_k1_ms",
        "fused_6rounds_ms", "fused_per_round_ms", "sum_parts_per_round_ms",
        "build_amortized_per_round_ms"]


def test_profile_on_the_cpu():
    ops.reset_counts()
    res = profile(**SMALL, device="cpu", iters=1)
    counts = ops.counts()
    assert res["device"] == "cpu" and set(KEYS) <= set(res)
    assert all(np.isfinite(res[k]) and res[k] >= 0 for k in KEYS)
    assert max(res["k3_max_err"], res["k6_max_err"], res["k5_max_err"]) <= 1e-5
    # CPU tensors: every fp32 instantiation ran its plain version, no kernel
    # launched, and no bf16 instantiation ran at all
    fp32 = {k: v for k, v in counts.items() if "bf16" not in k}
    assert all(launches == 0 and plain > 0 for launches, plain in fp32.values()), counts
    assert all(counts[k] == (0, 0) for k in counts if k not in fp32), counts


def test_profile_bf16_on_the_cpu():
    """The bf16 pass gives every key the fp32 pass gives, K6, K7 and K8 too;
    holds K3, K6 and K5 over K7's windows against the plain lookup; and
    amortises K2 + K7 over the rounds.  (tests/test_torch_bf16_engine.py
    holds which instantiations it runs.)"""
    res = profile(**SMALL, device="cpu", iters=1, dtype="bfloat16")
    assert res["dtype"] == "bfloat16" and set(KEYS) <= set(res)
    assert all(res[k] is not None and np.isfinite(res[k]) and res[k] >= 0 for k in KEYS), res
    tol = 2.0 ** -7 * res["lookup_ref_max"]
    assert max(res["k3_max_err"], res["k6_max_err"], res["k5_max_err"]) <= tol
    assert res["build_amortized_per_round_ms"] == pytest.approx(
        (res["build_k2_ms"] + res["extract_k7_ms"]) / ROUNDS, rel=1e-12)


def test_profile_needs_cuda_unless_asked_for_the_cpu():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profile(**SMALL)
