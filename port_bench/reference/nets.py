"""DROID-SLAM's networks in plain PyTorch, fp32, forward only: the feature
and context encoders and the recurrent update operator with its graph
aggregation.

A frozen copy of the port's ``models/`` forward paths with the upstream
checkpoint's parameter names (``fnet.layer1.0.conv1``,
``update.gru.convzr``, ``update.agg.eta.0``, ...), so that one state_dict
loads into both.  Tensors are NHWC at the module boundaries.
"""
import torch
import torch.nn.functional as F
from torch import nn

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def conv(cin, cout, kernel=3, stride=1, padding=None):
    return nn.Conv2d(cin, cout, kernel, stride=stride,
                     padding=kernel // 2 if padding is None else padding)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def normalize_images(images):
    """[..., H, W, 3] BGR 0-255 -> ImageNet-normalised RGB."""
    x = images.flip(-1) / 255.0
    mean = torch.tensor(IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)


class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, norm, stride=1):
        super().__init__()
        self.norm = instance_norm if norm else (lambda x: x)
        self.conv1 = conv(cin, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3, 1)
        self.downsample = nn.Sequential(conv(cin, planes, 1, stride, 0)) if stride != 1 else None

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        if self.downsample is not None:
            x = self.norm(self.downsample(x))
        return F.relu(x + y)


class Encoder(nn.Module):
    """Stride-8 residual encoder: [B, H, W, 3] -> [B, H/8, W/8, output_dim]."""

    def __init__(self, output_dim, norm):
        super().__init__()
        self.norm = instance_norm if norm else (lambda x: x)
        self.conv1 = conv(3, 32, 7, 2, 3)
        cin = 32
        for li, (dim, stride) in enumerate([(32, 1), (64, 2), (128, 2)], start=1):
            setattr(self, f"layer{li}", nn.Sequential(ResidualBlock(cin, dim, norm, stride),
                                                      ResidualBlock(dim, dim, norm, 1)))
            cin = dim
        self.conv2 = conv(cin, output_dim, 1, 1, 0)

    def forward(self, x):
        x = F.relu(self.norm(self.conv1(nchw(x))))
        return nhwc(self.conv2(self.layer3(self.layer2(self.layer1(x)))))


class ConvGRU(nn.Module):
    def __init__(self, h=128, i=128 + 128 + 64):
        super().__init__()
        self.h = h
        self.convzr = conv(h + i, 2 * h, 3)
        self.convq = conv(h + i, h, 3)
        self.w = conv(h, h, 1, 1, 0)
        self.convzr_glo = conv(h, 2 * h, 1, 1, 0)
        self.convq_glo = conv(h, h, 1, 1, 0)

    def forward(self, net, *inputs):
        inp = torch.cat(inputs, dim=1)
        glo = (torch.sigmoid(self.w(net)) * net).mean(dim=(2, 3), keepdim=True)
        zr = self.convzr(torch.cat([net, inp], dim=1)) + self.convzr_glo(glo)
        z, r = torch.sigmoid(zr[:, :self.h]), torch.sigmoid(zr[:, self.h:])
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1)) + self.convq_glo(glo))
        return (1 - z) * net + z * q


class Identity(nn.Module):
    """The training gradient clip's place in the heads (no forward effect)."""

    def forward(self, x):
        return x


class GraphAgg(nn.Module):
    """Mean of the edge states per source keyframe (real edges only), then
    eta [B, M, H, W] and the upsampling mask [B, M, H, W, 576]."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(128, 128, 3)
        self.conv2 = conv(128, 128, 3)
        self.eta = nn.Sequential(conv(128, 1, 3), Identity(), nn.Softplus())
        self.upmask = nn.Sequential(conv(128, 8 * 8 * 9, 1, 1, 0))

    def forward(self, net, kk, num_segments, emask):
        BN, C, H, W = net.shape
        N = kk.shape[0]
        B = BN // N
        x = F.relu(self.conv1(net)).reshape(B, N, 128, H, W) * emask[None, :, None, None, None]
        sums = x.new_zeros(B, num_segments, 128, H, W).index_add_(1, kk, x)
        counts = x.new_zeros(num_segments).index_add_(0, kk, emask)
        mean = sums / counts.clamp_min(1.0)[None, :, None, None, None]
        y = F.relu(self.conv2(mean.reshape(B * num_segments, 128, H, W)))
        eta = 0.01 * self.eta(y).reshape(B, num_segments, H, W)
        upmask = nhwc(self.upmask(y)).reshape(B, num_segments, H, W, 576)
        return eta, upmask


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_encoder = nn.Sequential(conv(196, 128, 1, 1, 0), nn.ReLU(),
                                          conv(128, 128, 3), nn.ReLU())
        self.flow_encoder = nn.Sequential(conv(4, 128, 7, 1, 3), nn.ReLU(),
                                          conv(128, 64, 3), nn.ReLU())
        self.weight = nn.Sequential(conv(128, 128, 3), nn.ReLU(), conv(128, 2, 3), Identity(),
                                    nn.Sigmoid())
        self.delta = nn.Sequential(conv(128, 128, 3), nn.ReLU(), conv(128, 2, 3), Identity())
        self.gru = ConvGRU()
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, kk=None, num_segments=None, emask=None):
        """net/inp [B, N, H, W, 128], corr [B, N, H, W, 196], flow [.., 4]
        (zeros when None); returns (net, delta, weight) and, with the
        segments ``kk``, also (eta, upmask)."""
        B, N, H, W, _ = net.shape
        if flow is None:
            flow = net.new_zeros(B, N, H, W, 4)

        def flat(x):
            return nchw(x.reshape(B * N, H, W, x.shape[-1]))

        net_f = self.gru(flat(net), flat(inp), self.corr_encoder(flat(corr)),
                         self.flow_encoder(flat(flow)))
        delta = nhwc(self.delta(net_f)).reshape(B, N, H, W, 2)
        weight = nhwc(self.weight(net_f)).reshape(B, N, H, W, 2)
        net_out = nhwc(net_f).reshape(B, N, H, W, 128)
        if kk is None:
            return net_out, delta, weight
        return (net_out, delta, weight) + self.agg(net_f, kk, num_segments, emask)


class Networks(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = Encoder(128, norm=True)
        self.cnet = Encoder(256, norm=False)
        self.update = UpdateModule()

    def features(self, images):
        """images [B, H, W, 3] float BGR -> fmaps [B, H/8, W/8, 128]."""
        return self.fnet(normalize_images(images))

    def context(self, images):
        """images [B, H, W, 3] -> (net tanh, inp relu), each [B, H/8, W/8, 128]."""
        ctx = self.cnet(normalize_images(images))
        return torch.tanh(ctx[..., :128]), F.relu(ctx[..., 128:])


def load_networks(state_dict, device):
    """The reference networks on ``device`` in fp32 with ``state_dict``'s
    weights (copied: the caller's tensors are left alone)."""
    net = Networks()
    net.load_state_dict({k: v.detach().float() for k, v in state_dict.items()})
    return net.to(device).eval().requires_grad_(False)
