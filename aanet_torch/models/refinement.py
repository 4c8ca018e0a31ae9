"""Disparity refinement (aanet_tpu/models/refinement.py).

Every head upsamples the incoming low-resolution disparity to the image
resolution (values rescaled by the width ratio), predicts a residual and
clamps the result at zero. StereoNet's (``:67-95``) sees the disparity and
the left image; StereoDRNet's (``:98-147``) warps the right image by the
disparity and sees the photometric error, the left image and the
disparity; AANet+'s hourglass (``:150-213``) sees the same through the
deformable UNet of GANet's extractor. The convs run dense; the JAX
package's space-to-depth execution of the first two is the same math with
the same parameters. With ``remat`` each block is checkpointed on its own
in training (refinement.py:39-54): StereoNet's and StereoDRNet's
BasicBlocks, the hourglass's BasicConvs and Conv2x (not its bare
deformable convs, as the JAX module).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aanet_torch.models.layers import (
    BasicBlock,
    Conv,
    DeformConv2dLayer,
    DtypeConv2d,
    Norm,
    add_numbered,
    leaky_relu,
    remat,
    unet_forward,
    unet_layers,
)
from aanet_torch.ops import warp as warp_ops
from aanet_torch.ops.resize import resize_bilinear

_DILATIONS = (1, 2, 4, 8, 1, 1)


def _upsample_to_img(low_disp: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """[B, h, w] -> [B, 1, H, W] scaled by W / w (``refinement.py:57-64``)."""
    h, w = img.shape[2:]
    scale = w / low_disp.shape[2]
    disp = low_disp.unsqueeze(1)
    if scale != 1.0:
        disp = resize_bilinear(disp, (h, w)) * scale
    return disp


def _blocks(module, x):
    for k in range(len(_DILATIONS)):
        block = getattr(module, f"BasicBlock_{k}")
        x = remat(block, x) if module.remat and module.training else block(x)
    return x


class StereoNetRefinement(nn.Module):
    """Edge-aware residual refinement on [disparity, left image] (reference
    nets/refinement.py:18-57)."""

    def __init__(self, remat=False):
        super().__init__()
        self.remat = remat
        self.Conv_0 = Conv(4, 32, 3, 1, 1)
        self.Norm_0 = Norm(32)
        for k, d in enumerate(_DILATIONS):
            self.add_module(f"BasicBlock_{k}", BasicBlock(32, 32, dilation=d, leaky=True))
        self.Conv_1 = Conv(32, 1, 3, 1, 1, bias=True)
        nn.init.normal_(self.Conv_1.Conv_0.weight, std=(1.0 / (32 * 9)) ** 0.5)  # lecun normal

    def forward(self, low_disp, left_img, right_img=None):
        disp = _upsample_to_img(low_disp, left_img)
        x = leaky_relu(self.Norm_0(self.Conv_0(torch.cat([disp, left_img], 1))))
        return F.relu(disp + self.Conv_1(_blocks(self, x)))[:, 0]


class StereoDRNetRefinement(nn.Module):
    """Warp-error-driven refinement (reference nets/refinement.py:60-106)."""

    def __init__(self, remat=False):
        super().__init__()
        self.remat = remat
        self.Conv_0 = Conv(6, 16, 3, 1, 1)
        self.Norm_0 = Norm(16)
        self.Conv_1 = Conv(1, 16, 3, 1, 1)
        self.Norm_1 = Norm(16)
        for k, d in enumerate(_DILATIONS):
            self.add_module(f"BasicBlock_{k}", BasicBlock(32, 32, dilation=d, leaky=True))
        self.Conv_2 = Conv(32, 1, 3, 1, 1, bias=True)
        nn.init.normal_(self.Conv_2.Conv_0.weight, std=(1.0 / (32 * 9)) ** 0.5)  # lecun normal

    def forward(self, low_disp, left_img, right_img):
        disp = _upsample_to_img(low_disp, left_img)
        warped_right = warp_ops.disp_warp(right_img, disp[:, 0])[0]
        error = warped_right - left_img
        conv1 = leaky_relu(self.Norm_0(self.Conv_0(torch.cat([error, left_img], 1))))
        conv2 = leaky_relu(self.Norm_1(self.Conv_1(disp)))
        x = _blocks(self, torch.cat([conv1, conv2], 1))
        return F.relu(disp + self.Conv_2(x))[:, 0]


class HourglassRefinement(nn.Module):
    """AANet+'s refinement: StereoDRNet's warp error and two 16-channel
    heads, a deformable conv, the deformable UNet of GANet's extractor
    (``layers.unet_layers``) and a 3x3 conv to the residual (reference
    nets/refinement.py:109-202). H and W must be multiples of 16."""

    def __init__(self, remat=False):
        super().__init__()
        self.remat = remat
        self.Conv_0 = Conv(6, 16, 3, 1, 1)
        self.Norm_0 = Norm(16)
        self.Conv_1 = Conv(1, 16, 3, 1, 1)
        self.Norm_1 = Norm(16)
        names = add_numbered(self, [DeformConv2dLayer(32, 32)] + unet_layers(mdconv=True))
        self.first_name, self.unet_names = names[0], names[1:]
        # flax's own nn.Conv beside the Conv wrappers: the third "Conv"
        self.Conv_2 = DtypeConv2d(32, 1, 3, padding=1, bias=True)
        nn.init.normal_(self.Conv_2.weight, std=(1.0 / (32 * 9)) ** 0.5)  # lecun normal
        nn.init.zeros_(self.Conv_2.bias)

    def _call(self, layer, *inputs):
        if self.remat and self.training and not isinstance(layer, DeformConv2dLayer):
            return remat(layer, *inputs)
        return layer(*inputs)

    def forward(self, low_disp, left_img, right_img):
        disp = _upsample_to_img(low_disp, left_img)
        warped_right = warp_ops.disp_warp(right_img, disp[:, 0])[0]
        error = warped_right - left_img
        conv1 = leaky_relu(self.Norm_0(self.Conv_0(torch.cat([error, left_img], 1))))
        conv2 = leaky_relu(self.Norm_1(self.Conv_1(disp)))
        x = getattr(self, self.first_name)(torch.cat([conv1, conv2], 1))
        x = unet_forward(x, [getattr(self, name) for name in self.unet_names], self._call)
        return F.relu(disp + self.Conv_2(x))[:, 0]
