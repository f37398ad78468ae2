"""DroidNet: fnet + cnet + update operator, its unrolled training forward,
and a seeded initializer.

The ``state_dict`` names are the upstream checkpoint's
(``fnet.layer1.0.conv1.weight``, ``update.gru.convq.bias``, ...).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ba.dense import BA
from ..geom.projective import coords_grid, projective_transform
from ..ops.corr import build_pyramid, corr_lookup_pyramid, corr_volume
from .extractor import BasicEncoder
from .update import UpdateModule, upsample_disp

# ImageNet normalisation (reference droid_net.py:160-163)
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def normalize_images(images):
    """[..., H, W, 3] BGR 0-255 -> normalized RGB."""
    x = images.flip(-1) / 255.0
    mean = torch.tensor(IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class DroidNet(nn.Module):
    """The networks compute in the dtype of their weights: training in bf16
    calls this module with bf16 copies of fp32 parameters
    (``torch.func.functional_call``), as a Flax module with ``dtype=bf16``
    casts its fp32 parameters.  BA, the losses and the carried poses and
    disparities stay fp32.

    remat: checkpoint each unrolled iteration (correlation lookup, update,
    2 BA steps) with ``torch.utils.checkpoint``, so the backward pass keeps
    only each iteration's inputs and recomputes the rest, one extra forward
    per iteration.  The JAX module's ``scan`` has no eager counterpart: it
    rolls the iterations into one ``lax.scan`` to cut XLA's compile time
    and leaves the numbers as they are.
    """

    def __init__(self, remat=False):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()
        self.remat = remat

    def extract_features(self, images):
        """images [B, N, H, W, 3] (BGR, 0-255) -> fmaps, net, inp at 1/8 res."""
        B, N, H, W, C = images.shape
        x = normalize_images(images).reshape(B * N, H, W, C).to(self.fnet.conv1.weight.dtype)
        fmaps = self.fnet(x).reshape(B, N, H // 8, W // 8, -1)
        ctx = self.cnet(x).reshape(B, N, H // 8, W // 8, -1)
        net, inp = ctx.chunk(2, dim=-1)
        return fmaps, torch.tanh(net), F.relu(inp)

    def forward(self, Gs, images, disps, intrinsics, ii, jj, num_steps=12, fixedp=2,
                edge_mask=None):
        """The unrolled training forward.

        Gs [B, P, 7]; images [B, P, H, W, 3]; disps [B, P, H/8, W/8];
        intrinsics [B, P, 4] at 1/8 resolution; ii, jj [E] long.
        edge_mask: optional [E] float validity of a padded sampled graph:
        masked edges get zero BA weight and zero residual, and GraphAgg
        sends them to an extra segment that is dropped.
        Returns (Gs_list, disp_up_list, residual_list), one per iteration.
        """
        P = images.shape[1]
        fmaps, net, inp = self.extract_features(images)
        net, inp = net[:, ii], inp[:, ii]

        if edge_mask is not None:
            kk, num_seg = torch.where(edge_mask.bool(), ii, torch.full_like(ii, P)), P + 1
            w_mask = edge_mask.float()[None, :, None, None, None]
        else:
            kk, num_seg, w_mask = ii, P, None

        f1 = fmaps[:, ii].reshape((-1,) + fmaps.shape[2:])
        f2 = fmaps[:, jj].reshape((-1,) + fmaps.shape[2:])
        pyramid = build_pyramid(corr_volume(f1, f2), num_levels=4)

        ht, wd = disps.shape[-2:]
        coords0 = coords_grid(ht, wd, device=disps.device)
        coords1, _ = projective_transform(Gs, disps, intrinsics, ii, jj)
        target = coords1

        # the update's parameters are passed in, not read from the module when
        # the checkpoint recomputes: by then a caller's functional_call has
        # put the module's own parameters back
        update_params = dict(self.update.named_parameters())

        def iteration(update_params, pyramid, net, inp, Gs, disps, coords1, target):
            Gs, disps = Gs.detach(), disps.detach()
            coords1, target = coords1.detach(), target.detach()

            corr = corr_lookup_pyramid(pyramid, coords1.reshape((-1,) + coords1.shape[2:]))
            corr = corr.reshape(coords1.shape[:-1] + (-1,))
            motion = torch.cat([coords1 - coords0, target - coords1], dim=-1).clamp(-64.0, 64.0)

            net, delta, weight, eta, upmask = functional_call(
                self.update, update_params, (net, inp, corr.to(net.dtype), motion.to(net.dtype)),
                {"kk": kk, "num_segments": num_seg})
            eta, upmask = eta[:, :P].float(), upmask[:, :P].float()

            target = coords1 + delta.float()
            weight = weight.float()
            if w_mask is not None:
                weight = weight * w_mask
            for _ in range(2):
                Gs, disps = BA(target, weight, eta, Gs, disps, intrinsics, ii, jj, fixedp=fixedp)

            coords1, valid = projective_transform(Gs, disps, intrinsics, ii, jj)
            residual = target - coords1
            if w_mask is not None:
                residual = residual * w_mask
            disp_up = upsample_disp(disps, upmask)
            return net, Gs, disps, coords1, target, disp_up, valid * residual

        Gs_list, disp_list, residual_list = [], [], []
        for _ in range(num_steps):
            args = (update_params, pyramid, net, inp, Gs, disps, coords1, target)
            out = (checkpoint(iteration, *args, use_reentrant=False) if self.remat
                   else iteration(*args))
            net, Gs, disps, coords1, target, disp_up, residual = out
            Gs_list.append(Gs)
            disp_list.append(disp_up)
            residual_list.append(residual)
        return Gs_list, disp_list, residual_list


def init_params(seed=0):
    """Seeded random weights as a state_dict (CPU tensors).

    Every conv weight and bias is uniform in +-1/sqrt(fan_in), PyTorch's
    default Conv2d bound, drawn from one ``torch.Generator`` in
    ``state_dict`` order, so a seed gives the same weights on every host.
    """
    gen = torch.Generator().manual_seed(seed)
    sd = DroidNet().state_dict()
    out = {}
    for k, v in sd.items():
        conv = k.rsplit(".", 1)[0]
        fan_in = math.prod(sd[conv + ".weight"].shape[1:])
        bound = 1.0 / math.sqrt(fan_in)
        out[k] = (torch.rand(v.shape, generator=gen) * 2.0 - 1.0) * bound
    return out
