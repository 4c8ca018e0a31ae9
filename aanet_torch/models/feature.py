"""Feature extraction for the ``aanet`` preset (aanet_tpu/models/feature.py):
the ResNet-40 backbone with a deformable layer3, and the top-down FPN."""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from aanet_torch.models.layers import Bottleneck, Conv, DeformBottleneck, Norm
from aanet_torch.ops.resize import resize_nearest


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
        counts: dict = {}
        self.block_names = []
        for block in blocks:
            kind = type(block).__name__
            name = f"{kind}_{counts.get(kind, 0)}"
            counts[kind] = counts.get(kind, 0) + 1
            self.add_module(name, block)
            self.block_names.append(name)

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
            lateral = nn.Conv2d(cin, out_channels, 1, bias=True)
            fpn = nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=True)
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
