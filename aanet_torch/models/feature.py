"""Feature extractors (aanet_tpu/models/feature.py): the ResNet-40
backbone with a deformable layer3 and the top-down FPN (``aanet``), and
the single-scale StereoNet (H/2^k), PSMNet (SPP, H/4), GANet (a UNet,
H/3) and GC-Net (H/2) extractors, and the strided pyramid that turns one
scale into three (``FeaturePyramid``)."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from aanet_torch.models.layers import (
    BasicBlock,
    BasicConv,
    Bottleneck,
    Conv,
    DeformBottleneck,
    DeformConv2dLayer,
    DtypeConv2d,
    Norm,
    add_numbered,
    leaky_relu,
    unet_forward,
    unet_layers,
)
from aanet_torch.ops.resize import resize_bilinear, resize_nearest


class AANetFeature(nn.Module):
    """ResNet-40: 7x7/s3 stem, Bottleneck stacks [3, 4, 6] at H/3, H/6 and
    H/12 (128/256/512 channels); layer3 deformable by default
    (``feature.py:36-60``, reference nets/resnet.py:102-194)."""

    def __init__(self, in_channels=32, feature_mdconv=True):
        super().__init__()
        c = in_channels
        self.Conv_0 = Conv(3, c, 7, 3, 3)
        self.Norm_0 = Norm(c)
        # layer1 (3 blocks), layer2 (4), layer3 (6) in execution order, named
        # <class>_<n> as flax auto-names them
        blocks = [Bottleneck(c, c, downsample=True), Bottleneck(4 * c, c), Bottleneck(4 * c, c)]
        blocks += [Bottleneck(4 * c, 2 * c, stride=2)] + [Bottleneck(8 * c, 2 * c) for _ in range(3)]
        if feature_mdconv:
            blocks += [DeformBottleneck(8 * c, 4 * c, stride=2)]
            blocks += [DeformBottleneck(16 * c, 4 * c) for _ in range(5)]
        else:
            blocks += [Bottleneck(8 * c, 4 * c, stride=2)] + [Bottleneck(16 * c, 4 * c) for _ in range(5)]
        self.block_names = add_numbered(self, blocks)

    def forward(self, x):
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        levels = []
        for i, name in enumerate(self.block_names):
            x = getattr(self, name)(x)
            if i in (2, 6, 12):
                levels.append(x)
        return levels  # [H/3 128ch, H/6 256ch, H/12 512ch]


class FeaturePyramidNetwork(nn.Module):
    """Top-down FPN with lateral 1x1s and 128 output channels
    (``feature.py:242-280``)."""

    def __init__(self, in_channels=(128, 256, 512), out_channels=128):
        super().__init__()
        self.num_levels = len(in_channels)
        for i, cin in enumerate(in_channels):
            lateral = DtypeConv2d(cin, out_channels, 1, bias=True)
            fpn = DtypeConv2d(out_channels, out_channels, 3, padding=1, bias=True)
            for conv in (lateral, fpn):
                nn.init.xavier_uniform_(conv.weight)
                nn.init.zeros_(conv.bias)
            self.add_module(f"lateral_{i}", lateral)
            self.add_module(f"fpn_{i}", fpn)
            self.add_module(f"Norm_{i}", Norm(out_channels))

    def forward(self, inputs):
        laterals = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(inputs)]
        for i in range(self.num_levels - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[2:]
            )
        return [
            F.relu(getattr(self, f"Norm_{i}")(getattr(self, f"fpn_{i}")(lat)))
            for i, lat in enumerate(laterals)
        ]


class FeaturePyramid(nn.Module):
    """One scale to three: [x, down(x), down(down(x))], each ``down`` a 3x3
    stride-2 conv, BN, leaky ReLU, 1x1 conv, BN, leaky ReLU at twice the
    channels of the last (``feature.py:219-240``). Flax names the two
    blocks' layers ``Conv_0..3`` and ``Norm_0..3`` in creation order."""

    def __init__(self, in_channels=32):
        super().__init__()
        c = in_channels
        for i, (cin, cout) in enumerate(((c, 2 * c), (2 * c, 4 * c))):
            self.add_module(f"Conv_{2 * i}", Conv(cin, cout, 3, 2, 1))
            self.add_module(f"Norm_{2 * i}", Norm(cout))
            self.add_module(f"Conv_{2 * i + 1}", Conv(cout, cout, 1))
            self.add_module(f"Norm_{2 * i + 1}", Norm(cout))

    def forward(self, x):
        levels = [x]
        for k in range(4):
            x = leaky_relu(getattr(self, f"Norm_{k}")(getattr(self, f"Conv_{k}")(x)))
            if k % 2:
                levels.append(x)
        return levels  # [H_s 32ch, H_s/2 64ch, H_s/4 128ch]


class StereoNetFeature(nn.Module):
    """``num_downsample`` stride-2 5x5 convs, six leaky residual blocks and
    a final 3x3 conv: 32 channels at H/2^k (``feature.py:63-77``)."""

    def __init__(self, num_downsample=3):
        super().__init__()
        self.num_downsample = num_downsample
        for i in range(num_downsample):
            self.add_module(f"Conv_{i}", Conv(3 if i == 0 else 32, 32, 5, 2, 2))
            self.add_module(f"Norm_{i}", Norm(32))
        self.block_names = add_numbered(self, [BasicBlock(32, 32, leaky=True) for _ in range(6)])
        self.add_module(f"Conv_{num_downsample}", Conv(32, 32, 3, 1, 1))

    def forward(self, x):
        for i in range(self.num_downsample):
            x = F.relu(getattr(self, f"Norm_{i}")(getattr(self, f"Conv_{i}")(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return getattr(self, f"Conv_{self.num_downsample}")(x)


class PSMNetBasicBlock(nn.Module):
    """PSMNet's residual block: no ReLU after the add (``feature.py:80-100``,
    reference nets/feature.py:123-147)."""

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        pad = dilation if dilation > 1 else 1
        self.Conv_0 = Conv(cin, planes, 3, stride, pad, dilation)
        self.Norm_0 = Norm(planes)
        self.Conv_1 = Conv(planes, planes, 3, 1, pad, dilation)
        self.Norm_1 = Norm(planes)
        self.has_identity = downsample or stride != 1 or cin != planes
        if self.has_identity:
            self.Conv_2 = Conv(cin, planes, 1, stride)
            self.Norm_2 = Norm(planes)

    def forward(self, x):
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = self.Norm_1(self.Conv_1(out))
        identity = self.Norm_2(self.Conv_2(x)) if self.has_identity else x
        return out + identity


SPP_POOLS = (64, 32, 16, 8)  # the SPP branches' average-pool windows at H/4


class PSMNetFeature(nn.Module):
    """PSMNet's extractor with spatial pyramid pooling: 32 channels at H/4
    (``feature.py:103-149``)."""

    def __init__(self):
        super().__init__()
        # Conv_0..2/Norm_0..2 the stem, Conv_3..6/Norm_3..6 the SPP branches,
        # Conv_7/Norm_7 and Conv_8 the fusion, in flax's creation order
        for i, (cin, stride) in enumerate(((3, 2), (32, 1), (32, 1))):
            self.add_module(f"Conv_{i}", Conv(cin, 32, 3, stride, 1))
            self.add_module(f"Norm_{i}", Norm(32))
        blocks = [PSMNetBasicBlock(32, 32) for _ in range(3)]
        blocks += [PSMNetBasicBlock(32 if i == 0 else 64, 64, stride=2 if i == 0 else 1)
                   for i in range(16)]
        blocks += [PSMNetBasicBlock(64 if i == 0 else 128, 128, downsample=i == 0) for i in range(3)]
        blocks += [PSMNetBasicBlock(128, 128, dilation=2) for _ in range(3)]
        self.block_names = add_numbered(self, blocks)
        for i in range(len(SPP_POOLS)):
            self.add_module(f"Conv_{3 + i}", Conv(128, 32, 1))
            self.add_module(f"Norm_{3 + i}", Norm(32))
        self.Conv_7 = Conv(64 + 128 + 32 * len(SPP_POOLS), 128, 3, 1, 1)
        self.Norm_7 = Norm(128)
        self.Conv_8 = Conv(128, 32, 1)

    def forward(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"Norm_{i}")(getattr(self, f"Conv_{i}")(x)))
        for k, name in enumerate(self.block_names):
            x = getattr(self, name)(x)
            if k == 18:
                output_raw = x  # H/4, 64 channels
        output_skip = x  # H/4, 128 channels
        h, w = output_skip.shape[2:]
        if h < 64 or w < 64:
            raise ValueError(
                f"PSMNetFeature: H/4 feature map is {h}x{w} but the SPP branches pool "
                "fixed 64px windows (reference nets/feature.py:250-265): the input image "
                f"must be at least 256x256 (got {h * 4}x{w * 4})."
            )
        branches = []
        for i, pool in enumerate(SPP_POOLS):
            b = F.avg_pool2d(output_skip, pool, pool)
            b = F.relu(getattr(self, f"Norm_{3 + i}")(getattr(self, f"Conv_{3 + i}")(b)))
            branches.append(resize_bilinear(b, (h, w)))
        # [raw, skip, b8, b16, b32, b64]
        cat = torch.cat([output_raw, output_skip] + branches[::-1], 1)
        return self.Conv_8(F.relu(self.Norm_7(self.Conv_7(cat))))


class GANetFeature(nn.Module):
    """GANet's extractor: a 3x3 and a 5x5 stride-3 BasicConv, a 3x3
    BasicConv or, with ``feature_mdconv``, a deformable conv, then the
    UNet of ``layers.unet_layers`` (deformable where ``feature_mdconv``):
    32 channels at H/3 (``feature.py:152-202``). H/3 and W/3 must be
    multiples of 16."""

    def __init__(self, feature_mdconv=False):
        super().__init__()
        stem = [BasicConv(3, 32, 3, 1, 1), BasicConv(32, 32, 5, 3, 2)]
        stem.append(DeformConv2dLayer(32, 32) if feature_mdconv else BasicConv(32, 32, 3, 1, 1))
        names = add_numbered(self, stem + unet_layers(feature_mdconv))
        self.stem_names, self.unet_names = names[:3], names[3:]

    def forward(self, x):
        for name in self.stem_names:
            x = getattr(self, name)(x)
        return unet_forward(x, [getattr(self, name) for name in self.unet_names])


class GCNetFeature(nn.Module):
    """A 5x5 stride-2 conv, eight PSMNet residual blocks and a 3x3 conv: 32
    channels at H/2 (``feature.py:205-216``)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 32, 5, 2, 2)
        self.Norm_0 = Norm(32)
        self.block_names = add_numbered(self, [PSMNetBasicBlock(32, 32) for _ in range(8)])
        self.Conv_1 = Conv(32, 32, 3, 1, 1)

    def forward(self, x):
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Conv_1(x)
