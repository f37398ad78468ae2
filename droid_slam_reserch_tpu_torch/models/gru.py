"""ConvGRU with the global-context branch (mirror of models/gru.py).

z and r read the same input, so they are one conv with stacked output
channels (``convzr``), as in the JAX package; NCHW tensors.
"""
import torch
from torch import nn

from .layers import uconv


class ConvGRU(nn.Module):
    def __init__(self, h_planes=128, i_planes=128 + 128 + 64):
        super().__init__()
        self.h_planes = h_planes
        c = h_planes + i_planes
        self.convzr = uconv(c, 2 * h_planes, 3)
        self.convq = uconv(c, h_planes, 3)
        self.w = uconv(h_planes, h_planes, 1, padding=0)
        self.convzr_glo = uconv(h_planes, 2 * h_planes, 1, padding=0)
        self.convq_glo = uconv(h_planes, h_planes, 1, padding=0)

    def forward(self, net, *inputs):
        inp = torch.cat(inputs, dim=1)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(2, 3), keepdim=True)
        zr = self.convzr(torch.cat([net, inp], dim=1)) + self.convzr_glo(glo)
        z = torch.sigmoid(zr[:, : self.h_planes])
        r = torch.sigmoid(zr[:, self.h_planes:])
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1)) + self.convq_glo(glo))
        return (1 - z) * net + z * q
