"""Recurrent update operator, graph aggregation and convex upsampling
(mirror of models/update.py).

Tensors are NHWC at the module boundary: net/inp [B, N, H, W, 128],
corr [B, N, H, W, 196], flow [B, N, H, W, 4].  Edges are flattened into the
batch dim for the convolutions.  Parameter names are the upstream
checkpoint's (``corr_encoder.0``, ``gru.convq``, ``agg.eta.0``, ...).
"""
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.timing import section
from .gru import ConvGRU
from .layers import GradientClip, to_nchw, to_nhwc, uconv


def cvx_upsample(data, mask):
    """Mask-weighted 8x convex upsampling (reference droid_net.py:21-35).

    data: [B, H, W, C]; mask: [B, H, W, 576] (channel order k * 64 + sy * 8
    + sx, k the 3x3 tap).  Each output pixel is the softmax-weighted mix of
    its 3x3 neighbourhood in data, zero-padded.  Returns [B, 8H, 8W, C].
    """
    B, H, W, C = data.shape
    mask = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    padded = F.pad(data, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([padded[:, 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)], dim=3)  # [B,H,W,9,C]
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", mask, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, C)


def upsample_disp(disp, mask):
    """disp: [B, N, H, W]; mask: [B, N, H, W, 576] -> [B, N, 8H, 8W]."""
    B, N, H, W = disp.shape
    up = cvx_upsample(disp.reshape(B * N, H, W, 1), mask.reshape(B * N, H, W, -1))
    return up.reshape(B, N, 8 * H, 8 * W)


class GraphAgg(nn.Module):
    """Per-keyframe aggregation of edge hidden states.

    The masked per-frame mean is an ``index_add_`` segment mean over the
    real edges: ``emask`` (0 on padded edges) keeps padding out of both
    the sums and the counts.  Returns eta [B, M, H, W] and the upsampling
    mask [B, M, H, W, 576].
    """

    def __init__(self):
        super().__init__()
        self.conv1 = uconv(128, 128, 3)
        self.conv2 = uconv(128, 128, 3)
        self.eta = nn.Sequential(uconv(128, 1, 3), GradientClip(), nn.Softplus())
        self.upmask = nn.Sequential(uconv(128, 8 * 8 * 9, 1, padding=0))

    def forward(self, net, kk, num_segments, emask=None):
        """net: [B*N, 128, H, W] NCHW edge states; kk: [N] long segment ids."""
        BN, C, H, W = net.shape
        N = kk.shape[0]
        B = BN // N
        M = num_segments
        x = F.relu(self.conv1(net)).reshape(B, N, 128, H, W)
        if emask is None:
            emask = torch.ones(N, dtype=x.dtype, device=x.device)
        emask = emask.to(x.dtype)
        # the sums in fp32, cast to the compute dtype (the JAX contraction's
        # preferred_element_type); the counts are small integers, exact in both
        xm = (x * emask[None, :, None, None, None]).float()
        sums = xm.new_zeros(B, M, 128, H, W).index_add_(1, kk, xm).to(x.dtype)
        counts = xm.new_zeros(M).index_add_(0, kk, emask.float()).to(x.dtype)
        mean = sums / counts.clamp_min(1.0)[None, :, None, None, None]

        y = F.relu(self.conv2(mean.reshape(B * M, 128, H, W)))
        eta = 0.01 * self.eta(y).reshape(B, M, H, W)
        upmask = to_nhwc(self.upmask(y)).reshape(B, M, H, W, 8 * 8 * 9)
        return eta, upmask


class UpdateModule(nn.Module):
    """The recurrent update operator.

    Returns updated net, flow correction delta [B,N,H,W,2], confidence
    weight [B,N,H,W,2] and, when kk/num_segments are given, (eta, upmask).
    """

    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(
            uconv(4 * 49, 128, 1, padding=0), nn.ReLU(), uconv(128, 128, 3), nn.ReLU()
        )
        self.flow_encoder = nn.Sequential(
            uconv(4, 128, 7, padding=3), nn.ReLU(), uconv(128, 64, 3), nn.ReLU()
        )
        self.weight = nn.Sequential(
            uconv(128, 128, 3), nn.ReLU(), uconv(128, 2, 3), GradientClip(), nn.Sigmoid()
        )
        self.delta = nn.Sequential(
            uconv(128, 128, 3), nn.ReLU(), uconv(128, 2, 3), GradientClip()
        )
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, kk=None, num_segments=None, emask=None):
        with section("update_op"):
            B, N, H, W, _ = net.shape
            if flow is None:
                flow = net.new_zeros(B, N, H, W, 4)

            def flat(x):
                return to_nchw(x.reshape(B * N, H, W, x.shape[-1]))

            net_f = self.gru(
                flat(net), flat(inp), self.corr_encoder(flat(corr)), self.flow_encoder(flat(flow))
            )
            delta = to_nhwc(self.delta(net_f)).reshape(B, N, H, W, 2)
            weight = to_nhwc(self.weight(net_f)).reshape(B, N, H, W, 2)
            net_out = to_nhwc(net_f).reshape(B, N, H, W, 128)
            if kk is not None:
                eta, upmask = self.agg(net_f, kk, num_segments, emask)
                return net_out, delta, weight, eta, upmask
            return net_out, delta, weight
