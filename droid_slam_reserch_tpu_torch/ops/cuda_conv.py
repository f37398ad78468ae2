"""The update operator's 3x3 convolution kernel and its plain version:

- ``conv3x3``  a 3x3, stride-1, zero-padded fp32 convolution of a
               channels-last map as an implicit GEMM on the tensor cores
               (3xTF32 ``wgmma``, fp32 sums; csrc/conv3x3.cu).  It
               replaces no TPU kernel: the JAX package leaves these
               convolutions to XLA, and the port gave them to cuDNN, which
               runs fp32 with TF32 off as FFTs.

For a CUDA tensor the wrapper launches the kernel or raises; for a CPU
tensor it runs the plain version, ``F.conv2d``.  The weights go to the
kernel K-major and split into their TF32 big part and the remainder
(``pack_weight``); ``models.layers.UpdateConv`` packs them once per weight
version.  ``conv3x3.launches`` / ``conv3x3_plain.calls`` count each.
"""
import ctypes

import torch
import torch.nn.functional as F

from . import build

NAME = "conv3x3"
BLOCK_N = (128, 64)         # the kernel's instantiations: output channels a block
BLOCK_M = 128               # output pixels a block
CIN_STEP = 32               # input channels a stage

_sms = {}


def conv3x3_plain(x, weight, bias=None):
    """Plain version: x [B, C_in, H, W], weight [C_out, C_in, 3, 3], bias
    [C_out] or None -> [B, C_out, H, W] (stride 1, padding 1)."""
    conv3x3_plain.calls[NAME] += 1
    return F.conv2d(x, weight, bias, 1, 1)


conv3x3_plain.calls = {NAME: 0}


def pack_weight(weight):
    """weight [C_out, C_in, 3, 3] -> (big, small), each [C_out, 9 * C_in]
    fp32 and K-major (k = (3 dy + dx) C_in + c): big is the weight rounded to
    the nearest TF32 value (the low 13 bits cleared), small = weight - big,
    exact."""
    w = weight.detach().float().permute(0, 2, 3, 1).reshape(weight.shape[0], -1).contiguous()
    big = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return big, w - big


def block_n(npix, cout, sms):
    """The widest block of output channels that divides C_out and still gives
    each of the card's ``sms`` SMs a block, else the narrowest that divides."""
    fits = [bn for bn in BLOCK_N if cout % bn == 0]
    if not fits:
        raise ValueError(f"conv3x3: C_out={cout} is no multiple of {BLOCK_N[-1]}")
    tiles = -(-npix // BLOCK_M)
    for bn in fits:
        if tiles * (cout // bn) >= sms:
            return bn
    return fits[-1]


def _pixel_stride(x):
    """The stride between x's pixels where x [B, C, H, W] is a channels-last
    map whose B*H*W pixels lie one stride apart (a channel slice of a wider
    channels-last tensor is one), else None."""
    B, C, H, W = x.shape
    sb, sc, sh, sw = x.stride()
    s = sw if W > 1 else sh if H > 1 else sb
    flat = ((C == 1 or sc == 1) and s >= C and (H == 1 or sh == W * s)
            and (B == 1 or sb == H * W * s))
    return s if flat else None


def conv3x3(x, weight, bias=None, packed=None):
    """3x3, stride-1, padding-1 convolution.  x [B, C_in, H, W] fp32 (any
    layout; channels-last is read in place), weight [C_out, C_in, 3, 3],
    bias [C_out] or None, packed = pack_weight(weight) or None (packed
    here) -> [B, C_out, H, W] fp32, a channels-last tensor, as nn.Conv2d
    returns it.  C_in must be a multiple of 32 and C_out of 64."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if not x.is_cuda or weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"conv3x3: x on {x.device}, weight on {weight.device}")
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"conv3x3: expected a 4-D fp32 input and fp32 weights, got "
                         f"{x.dtype} {tuple(x.shape)} and {weight.dtype}")
    B, C, H, W = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, C, 3, 3) or C % CIN_STEP or cout % BLOCK_N[-1]:
        raise ValueError(f"conv3x3: weight {tuple(weight.shape)} for {C} input channels; needs "
                         f"C_in % {CIN_STEP} == 0 and C_out % {BLOCK_N[-1]} == 0")
    sw = _pixel_stride(x)
    if sw is None or sw % 4 or x.data_ptr() % 16:
        x = x.contiguous(memory_format=torch.channels_last)
        sw = C
    big, small = pack_weight(weight) if packed is None else packed
    if bias is not None:
        bias = bias.detach().contiguous()
        if bias.dtype != torch.float32 or bias.shape != (cout,):
            raise ValueError(f"conv3x3: bias {bias.dtype} {tuple(bias.shape)}")
    out = torch.empty((B, H, W, cout), dtype=torch.float32, device=x.device)
    npix = B * H * W
    with torch.cuda.device(x.device):
        dev = torch.cuda.current_device()
        if dev not in _sms:
            _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        bn = block_n(npix, cout, _sms[dev])
        err = build.library().conv3x3_launch(
            x.data_ptr(), npix, H, W, C, sw, big.data_ptr(), small.data_ptr(),
            None if bias is None else bias.data_ptr(), cout, bn,
            out.data_ptr(), stream)
    build.check(err, NAME)
    conv3x3.launches[NAME] += 1
    return out.permute(0, 3, 1, 2)


conv3x3.launches = {NAME: 0}


def conv3x3_info(bn):
    """(dynamic shared memory bytes, stages, resident blocks per SM) of the
    instantiation with ``bn`` output channels a block, on the current card."""
    out = (ctypes.c_int * 3)()
    build.check(build.library().conv3x3_info(bn, ctypes.addressof(out)), "conv3x3_info")
    return tuple(out)
