"""The update operator's 3x3 convolution kernel (ops/cuda_conv.py,
csrc/conv3x3.cu) and its routing (models/layers.py::UpdateConv).

CPU tests: the routing rule for each of the update operator's eleven 3x3
convolutions, the state_dict and the weight converter, the plain path
against nn.Conv2d, the forward hooks' operation counts, the launch and
cuDNN counters, the weight packing, and the kernel's tile, tap and split
arithmetic mirrored in PyTorch.  The tests marked ``card`` need a CUDA card
and skip here; on the card they hold the kernel against an fp64 convolution
at the benchmark cells' shapes:

    python -m pytest --noconftest -o addopts="" -m card tests/test_torch_conv3x3.py
"""
import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from droid_slam_reserch_tpu_torch import ops
from droid_slam_reserch_tpu_torch.models import DroidNet, convert, gru, layers, update
from droid_slam_reserch_tpu_torch.models.update import UpdateModule
from droid_slam_reserch_tpu_torch.ops import cuda_conv
from droid_slam_reserch_tpu_torch.utils import timing

# every 3x3 convolution of the update operator -> whether the rule sends it
# to the kernel (fp32, no autograd)
CONVS_3X3 = {
    "corr_encoder.2": True, "flow_encoder.2": True, "weight.0": True, "weight.2": False,
    "delta.0": True, "delta.2": False, "gru.convzr": True, "gru.convq": True,
    "agg.conv1": True, "agg.conv2": True, "agg.eta.0": False,
}
# the batch each one sees in the EuRoC frontend cell: 48 edges, but GraphAgg's
# conv2, which takes one map a keyframe of the window
MAPS = {"agg.conv2": 10}


def tconv_update_module(monkeypatch):
    """UpdateModule as it was built before UpdateConv: plain nn.Conv2d."""
    monkeypatch.setattr(update, "uconv", layers.tconv)
    monkeypatch.setattr(gru, "uconv", layers.tconv)
    return UpdateModule()


def update_inputs(B=1, N=3, H=5, W=7, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, N, H, W, 128, generator=g), torch.randn(B, N, H, W, 128, generator=g),
            torch.randn(B, N, H, W, 196, generator=g), torch.randn(B, N, H, W, 4, generator=g))


def test_the_update_operator_has_eleven_3x3_convs():
    m = UpdateModule()
    found = {n for n, c in m.named_modules() if isinstance(c, nn.Conv2d) and c.kernel_size == (3, 3)}
    assert found == set(CONVS_3X3)
    assert all(isinstance(c, layers.UpdateConv) for c in m.modules() if isinstance(c, nn.Conv2d))


@pytest.mark.parametrize("mode", ["no_grad", "grad", "grad_frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CONVS_3X3))
@pytest.mark.parametrize("shape", ["cpu_test", "frontend_cell"])
def test_routing_rule(name, dtype, mode, shape):
    """The rule for each 3x3 conv, on meta inputs of a CPU test's shape and
    of the EuRoC frontend cell's (48 edges at 40x64): the kernel takes fp32
    calls that build no autograd graph, with C_in % 32 == 0 and C_out % 64 == 0."""
    conv = dict(UpdateModule().named_modules())[name].to(device="meta", dtype=dtype)
    if mode == "grad_frozen":
        conv.requires_grad_(False)
    B, H, W = (3, 5, 7) if shape == "cpu_test" else (MAPS.get(name, 48), 40, 64)
    x = torch.empty(B, conv.in_channels, H, W, device="meta", dtype=dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.set_grad_enabled(mode != "no_grad"):
        takes = conv.routes_to_kernel(x)
    expect = CONVS_3X3[name] and dtype == torch.float32 and mode != "grad"
    assert takes == expect


def test_routing_rule_input_that_requires_grad():
    conv = dict(UpdateModule().named_modules())["gru.convq"].requires_grad_(False)
    x = torch.zeros(1, 448, 4, 4, requires_grad=True)
    assert not conv.routes_to_kernel(x)
    with torch.no_grad():
        assert conv.routes_to_kernel(x)


@pytest.mark.parametrize("kw", [dict(stride=2), dict(padding=2, dilation=2), dict(groups=2),
                                dict(padding_mode="reflect"), dict(padding=0)])
def test_routing_rule_other_3x3(kw):
    args = dict(stride=1, padding=1)
    args.update(kw)
    conv = layers.UpdateConv(128, 128, 3, **args).requires_grad_(False)
    assert not conv.routes_to_kernel(torch.zeros(1, 128, 8, 8))
    with torch.no_grad():
        assert not conv.routes_to_kernel(torch.zeros(1, 128, 8, 8))
        assert layers.UpdateConv(128, 128, 3, padding=1).routes_to_kernel(torch.zeros(1, 128, 8, 8))


def test_state_dict_keys_and_shapes_unchanged(monkeypatch):
    new = UpdateModule().state_dict()
    old = tconv_update_module(monkeypatch).state_dict()
    assert list(new) == list(old)
    assert all(new[k].shape == old[k].shape for k in new)


def test_converter_round_trip_loads_strictly():
    net = DroidNet()
    sd = net.state_dict()
    back = convert.params_from_jax(convert.params_to_jax(sd))
    fresh = DroidNet()
    fresh.load_state_dict(back, strict=True)
    assert all(torch.equal(fresh.state_dict()[k], sd[k]) for k in sd)


def test_upstream_checkpoint_keys_load(monkeypatch):
    """state_dict_from_torch of an upstream-style checkpoint (convz/convr
    apart, 3-channel heads) loads into the new module as into the old one."""
    old = tconv_update_module(monkeypatch)
    sd = {"update." + k: v for k, v in old.state_dict().items()}
    for kind in ("weight", "bias"):
        zr = sd.pop(f"update.gru.convzr.{kind}")
        sd[f"update.gru.convz.{kind}"], sd[f"update.gru.convr.{kind}"] = zr[:128], zr[128:]
    loaded = convert.state_dict_from_torch(sd)
    monkeypatch.undo()
    new = UpdateModule()
    new.load_state_dict({k[len("update."):]: v for k, v in loaded.items()}, strict=True)
    assert all(torch.equal(new.state_dict()[k], old.state_dict()[k]) for k in old.state_dict())


@pytest.mark.parametrize("name", ["gru.convzr", "flow_encoder.2", "delta.2", "agg.conv2",
                                  "corr_encoder.0", "flow_encoder.0"])
def test_plain_path_bit_equal_to_nn_conv2d(name):
    conv = dict(UpdateModule().named_modules())[name]
    ref = nn.Conv2d(conv.in_channels, conv.out_channels, conv.kernel_size, padding=conv.padding)
    ref.load_state_dict(conv.state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 5, 7, conv.in_channels, generator=g).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(conv(x), ref(x))
    assert torch.equal(conv(x), ref(x))           # under autograd too


def test_forward_hooks_count_the_same_conv_flops(monkeypatch):
    """port_bench's hooks (every nn.Conv2d, 2 x out x C_in x kh x kw) see
    the same operations for one update forward with GraphAgg."""
    def flops(module):
        total = []

        def hook(m, inp, out):
            kh, kw = m.kernel_size
            total.append(2.0 * out.numel() * inp[0].shape[1] // m.groups * kh * kw)
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                m.register_forward_hook(hook)
        with torch.no_grad():
            module(*update_inputs(), kk=torch.tensor([0, 0, 1]), num_segments=2)
        return total

    new = flops(UpdateModule())
    old = flops(tconv_update_module(monkeypatch))
    assert len(new) == len(old) == 17 and new == old


def run_counts(fn):
    ops.reset_counts()
    timing.clear_counters("conv3x3")
    fn()
    return ops.counts()["conv3x3"], timing.counters().get("conv3x3.cudnn", 0)


@pytest.mark.parametrize("agg", [True, False])
def test_counts_of_an_update_forward(agg):
    """8 kernel calls and 3 cuDNN calls a forward with GraphAgg, 6 and 2
    without (the motion filter's: no eta head); on the CPU the kernel's
    calls run the plain version."""
    m = UpdateModule().eval()
    kw = dict(kk=torch.tensor([0, 0, 1]), num_segments=2) if agg else {}
    with torch.no_grad():
        (launches, plain), cudnn = run_counts(lambda: m(*update_inputs(), **kw))
    assert "conv3x3" in ops.counts()
    assert (launches, plain, cudnn) == ((0, 8, 3) if agg else (0, 6, 2))


def test_counts_under_training_and_bf16():
    """Training (autograd) and bf16 send every 3x3 call to cuDNN."""
    m = UpdateModule()
    kw = dict(kk=torch.tensor([0, 0, 1]), num_segments=2)
    (launches, plain), cudnn = run_counts(lambda: m(*update_inputs(), **kw))
    assert (launches, plain, cudnn) == (0, 0, 11)
    m16 = UpdateModule().to(torch.bfloat16)
    with torch.no_grad():
        (launches, plain), cudnn = run_counts(
            lambda: m16(*[t.to(torch.bfloat16) for t in update_inputs()], **kw))
    assert (launches, plain, cudnn) == (0, 0, 11)


def test_pack_weight_splits_exactly():
    g = torch.Generator().manual_seed(2)
    w = torch.randn(64, 32, 3, 3, generator=g) * torch.logspace(-20, 20, 64).view(64, 1, 1, 1)
    big, small = cuda_conv.pack_weight(w)
    k = w.permute(0, 2, 3, 1).reshape(64, -1)
    assert big.shape == small.shape == (64, 9 * 32)
    assert torch.equal(big + small, k)
    assert int((big.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert bool((small.abs() <= k.abs() * 2.0 ** -11).all())


def test_packed_weight_cached_per_version():
    conv = layers.UpdateConv(128, 64, 3, padding=1)
    p1 = conv.packed_weight()
    assert conv.packed_weight() is p1
    with torch.no_grad():
        conv.weight.mul_(2.0)
    p2 = conv.packed_weight()
    assert p2 is not p1 and torch.equal(p2[0] + p2[1], 2 * (p1[0] + p1[1]))
    conv.load_state_dict(layers.UpdateConv(128, 64, 3, padding=1).state_dict())
    assert conv.packed_weight() is not p2


@pytest.mark.parametrize("npix,cout,sms,bn", [
    (48 * 2560, 256, 132, 128), (48 * 3010, 128, 132, 128), (2560, 256, 132, 64),
    (2 * 2560, 256, 132, 64), (4 * 2560, 256, 132, 128), (2560, 128, 132, 64),
    (3010, 64, 132, 64), (1, 64, 132, 64)])
def test_block_n(npix, cout, sms, bn):
    assert cuda_conv.block_n(npix, cout, sms) == bn


def test_pixel_stride():
    x = torch.zeros(2, 5, 7, 512).permute(0, 3, 1, 2)
    assert cuda_conv._pixel_stride(x) == 512
    assert cuda_conv._pixel_stride(x[:, 32:480]) == 512
    assert cuda_conv._pixel_stride(torch.cat([x[:, :128], x[:, :320]], dim=1)) == 448
    assert cuda_conv._pixel_stride(torch.zeros(2, 128, 5, 7)) is None
    assert cuda_conv._pixel_stride(x[:, :, 1:]) is None
    assert cuda_conv._pixel_stride(torch.zeros(1, 64, 1, 1)) is not None


def tf32_round(x):
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_trunc(x):
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def kernel_mirror(x, weight, bias):
    """csrc/conv3x3.cu's arithmetic in PyTorch: 128-pixel tiles of the
    flattened map; tap t's box is the tile's rows shifted by (dy-1) W +
    (dx-1), zero before the first and after the last pixel (TMA's fill),
    and zero where the tap mask says the neighbour leaves the map; the
    input split as the kernel splits it, the weights as pack_weight does,
    each operand read as TF32 (truncated) and the three products
    small*big + big*small + big*big summed in fp64."""
    B, C, H, W = x.shape
    cout = weight.shape[0]
    xf = x.permute(0, 2, 3, 1).reshape(-1, C)
    npix = xf.shape[0]
    xb = tf32_round(xf)
    xs = tf32_trunc(xf - xb)
    wb, ws = cuda_conv.pack_weight(weight)
    ws = tf32_trunc(ws)
    rows = -(-npix // cuda_conv.BLOCK_M) * cuda_conv.BLOCK_M
    p = torch.arange(rows)
    q = p % (H * W)
    y, xx = q // W, q % W
    out = torch.zeros(rows, cout, dtype=torch.float64)
    for t in range(9):
        dy, dx = t // 3 - 1, t % 3 - 1
        src = p + dy * W + dx
        live = (src >= 0) & (src < npix)
        live &= (y + dy >= 0) & (y + dy < H) & (xx + dx >= 0) & (xx + dx < W)
        idx = src.clamp(0, npix - 1)
        a_b = torch.where(live[:, None], xb[idx], 0).double()
        a_s = torch.where(live[:, None], xs[idx], 0).double()
        k = slice(t * C, (t + 1) * C)
        out += a_s @ wb[:, k].double().T + a_b @ ws[:, k].double().T + a_b @ wb[:, k].double().T
    out = out[:npix] + bias.double()
    return out.reshape(B, H, W, cout).permute(0, 3, 1, 2)


@pytest.mark.parametrize("B,H,W,cin,cout", [(3, 5, 7, 64, 64), (2, 6, 9, 32, 128),
                                            (1, 43, 70, 32, 64), (2, 1, 130, 32, 64)])
def test_kernel_mirror_against_fp64(B, H, W, cin, cout):
    """The mirror's taps, borders and ragged tiles give the convolution, and
    its split keeps the products within 2e-6 of fp64 (the card test's limit
    leaves the rest to the kernel's fp32 sums)."""
    g = torch.Generator().manual_seed(B * H + W)
    x = torch.randn(B, H, W, cin, generator=g).clamp_min(0).permute(0, 3, 1, 2)
    w = (torch.rand(cout, cin, 3, 3, generator=g) * 2 - 1) / math.sqrt(9 * cin)
    b = torch.rand(cout, generator=g) - 0.5
    ref = F.conv2d(x.double(), w.double(), b.double(), padding=1)
    got = kernel_mirror(x, w, b)
    err = float((got - ref).norm() / ref.norm())
    assert err <= 2e-6
    if H >= 3:                                     # the interior needs no halo
        inner = F.conv2d(x.double(), w.double(), b.double(), padding=0)
        assert float((got[..., 1:-1, 1:-1] - inner).norm()) <= 2e-6 * float(inner.norm())


# ---- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the H100 as the module docstring says")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def card_inputs(dev, E, H, W, cin, cout, seed=0):
    """Inputs as the update operator's convolutions see them (non-negative,
    after a ReLU), weights and bias as init_params draws them."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(E, H, W, cin, generator=g).clamp_min(0)
    bound = 1 / math.sqrt(9 * cin)
    w = (torch.rand(cout, cin, 3, 3, generator=g) * 2 - 1) * bound
    b = (torch.rand(cout, generator=g) * 2 - 1) * bound
    return x.to(dev).permute(0, 3, 1, 2), w.to(dev), b.to(dev)


def rel_err(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


CARD_SHAPES = [(E, H, W, cin, cout) for E in (1, 2, 48, 64) for H, W in ((40, 64), (43, 70))
               for cin, cout in ((128, 128), (128, 64), (448, 256), (448, 128))]


@pytest.mark.card
@pytest.mark.parametrize("E,H,W,cin,cout", CARD_SHAPES)
def test_card_kernel_against_fp64(card, E, H, W, cin, cout):
    x, w, b = card_inputs(card, E, H, W, cin, cout)
    ref = F.conv2d(x.double(), w.double(), b.double(), padding=1)
    ops.reset_counts()
    out = cuda_conv.conv3x3(x, w, b)
    assert ops.counts()["conv3x3"] == (1, 0)
    assert out.shape == ref.shape and out.is_contiguous(memory_format=torch.channels_last)
    err = rel_err(out, ref)
    err_cudnn = rel_err(F.conv2d(x, w, b, padding=1), ref)
    assert err <= 2e-6 and err <= 4 * err_cudnn, (err, err_cudnn)


@pytest.mark.card
def test_card_channel_slices_and_cat(card):
    """Non-contiguous channels-last inputs: a channel slice of a wider
    tensor (read in place) and torch.cat's output, and an NCHW input."""
    x, w, b = card_inputs(card, 3, 43, 70, 512, 128)
    for xs in (x[:, 32:480], torch.cat([x[:, :128], x[:, 192:512]], dim=1),
               x[:, :448].contiguous()):
        ref = F.conv2d(xs.double(), w[:, :448].double(), b.double(), padding=1)
        assert rel_err(cuda_conv.conv3x3(xs, w[:, :448].contiguous(), b), ref) <= 2e-6


@pytest.mark.card
def test_card_bias_halo_and_ragged_tile(card):
    """All-ones input and weights: each output is the bias plus 128 times the
    number of taps inside the map, exactly, at all four borders, across the
    images a tile spans and in the ragged last tile (2 x 43 x 70 pixels)."""
    x = torch.ones(2, 128, 43, 70, device=card).contiguous(memory_format=torch.channels_last)
    w = torch.ones(64, 128, 3, 3, device=card)
    b = torch.arange(64, device=card, dtype=torch.float32)
    taps = F.conv2d(torch.ones(1, 1, 43, 70, device=card), torch.ones(1, 1, 3, 3, device=card),
                    padding=1)
    expect = b.view(1, 64, 1, 1) + 128 * taps
    out = cuda_conv.conv3x3(x, w, b)
    assert torch.equal(out, expect.expand_as(out))
    assert torch.equal(cuda_conv.conv3x3(x, w, None), (128 * taps).expand_as(out))


@pytest.mark.card
def test_card_update_forward_routes(card):
    """One UpdateModule forward on the card: 8 launches and 3 cuDNN calls
    with GraphAgg, 6 and 2 without, none under autograd or in bf16, and the
    outputs within fp32 reach of the cuDNN-only module."""
    torch.manual_seed(0)
    m = UpdateModule().to(card).eval()
    args = [t.to(card) for t in update_inputs(1, 12, 40, 64)]
    kk = torch.arange(12, device=card) // 3
    with torch.no_grad():
        (launches, plain), cudnn = run_counts(lambda: m(*args, kk=kk, num_segments=4))
        assert (launches, plain, cudnn) == (8, 0, 3)
        (launches, plain), cudnn = run_counts(lambda: m(*args))
        assert (launches, plain, cudnn) == (6, 0, 2)
        got = m(*args, kk=kk, num_segments=4)
    m.requires_grad_(True)
    (launches, plain), cudnn = run_counts(lambda: m(*args, kk=kk, num_segments=4))
    assert (launches, plain, cudnn) == (0, 0, 11)
    with torch.no_grad():
        ref = m.double()(*[a.double() for a in args], kk=kk, num_segments=4)
        for a, r in zip(got, ref):
            assert rel_err(a, r) <= 1e-5
        m16 = m.to(torch.bfloat16)
        (launches, plain), cudnn = run_counts(
            lambda: m16(*[a.to(torch.bfloat16) for a in args], kk=kk, num_segments=4))
        assert (launches, plain, cudnn) == (0, 0, 11)
