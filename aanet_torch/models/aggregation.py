"""Cost aggregation (aanet_tpu/models/aggregation.py).

Adaptive aggregation (``:32-153``): correlation volumes are
[B, D_s, H_s, W_s], the disparity axis is the channel axis, so the
intra-scale (ISA) bottlenecks and the cross-scale (CSA) fusions are plain
2-D convs.

The 3-D aggregations of the StereoNet, PSMNet and GC-Net baselines
(``:156-311``) take a 4-D volume [B, C, D, H, W] and return volumes
[B, D', H', W'] for soft-argmin (the JAX package's [B, H, W, D] with D
moved to dim 1).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from aanet_torch.models.layers import (
    Conv,
    ConvTranspose,
    DtypeConv2d,
    DeformSimpleBottleneck,
    Norm,
    SimpleBottleneck,
    leaky_relu,
    remat,
)
from aanet_torch.ops.resize import resize_bilinear, resize_trilinear

K3 = (3, 3, 3)


class AdaptiveAggregationModule(nn.Module):
    """One AAModule: per-scale ISA bottlenecks and the full cross-scale
    fusion (reference nets/aggregation.py:313-402)."""

    def __init__(self, num_scales, num_output_branches, max_disp, num_blocks=1,
                 simple_bottleneck=False, deformable_groups=2, mdconv_dilation=2):
        super().__init__()
        self.num_scales = num_scales
        self.num_output_branches = num_output_branches
        self.num_blocks = num_blocks
        disp = [max_disp // 2**i for i in range(num_scales)]
        for i, d_i in enumerate(disp):
            for j in range(num_blocks):
                if simple_bottleneck:
                    block = SimpleBottleneck(d_i, d_i)
                else:
                    block = DeformSimpleBottleneck(
                        d_i, d_i, mdconv_dilation=mdconv_dilation,
                        deformable_groups=deformable_groups,
                    )
                self.add_module(f"isa_{i}_{j}", block)
        if num_scales == 1:
            return
        for i in range(num_output_branches):
            for j in range(num_scales):
                if i < j:  # coarse -> fine: 1x1 conv + BN, then bilinear upsample
                    self.add_module(f"fuse_{i}_{j}_conv", Conv(disp[j], disp[i], 1))
                    self.add_module(f"fuse_{i}_{j}_bn", Norm(disp[i]))
                elif i > j:  # fine -> coarse: chain of stride-2 3x3 convs
                    for k in range(i - j - 1):
                        self.add_module(f"fuse_{i}_{j}_down{k}", Conv(disp[j], disp[j], 3, 2, 1))
                        self.add_module(f"fuse_{i}_{j}_down{k}_bn", Norm(disp[j]))
                    self.add_module(f"fuse_{i}_{j}_downF", Conv(disp[j], disp[i], 3, 2, 1))
                    self.add_module(f"fuse_{i}_{j}_downF_bn", Norm(disp[i]))

    def forward(self, x):
        x = list(x)
        for i in range(self.num_scales):
            for j in range(self.num_blocks):
                x[i] = getattr(self, f"isa_{i}_{j}")(x[i])
        if self.num_scales == 1:
            return x
        fused = []
        for i in range(self.num_output_branches):
            acc = None
            for j in range(self.num_scales):
                if i == j:
                    exch = x[j]
                elif i < j:
                    exch = getattr(self, f"fuse_{i}_{j}_bn")(getattr(self, f"fuse_{i}_{j}_conv")(x[j]))
                    exch = resize_bilinear(exch, x[i].shape[2:])
                else:
                    exch = x[j]
                    for k in range(i - j - 1):
                        exch = getattr(self, f"fuse_{i}_{j}_down{k}")(exch)
                        exch = leaky_relu(getattr(self, f"fuse_{i}_{j}_down{k}_bn")(exch))
                    exch = getattr(self, f"fuse_{i}_{j}_downF_bn")(getattr(self, f"fuse_{i}_{j}_downF")(exch))
                acc = exch if acc is None else acc + exch
            fused.append(leaky_relu(acc))
        return fused


class AdaptiveAggregation(nn.Module):
    """``num_fusions`` AAModules, the last ``num_deform_blocks`` of them with
    deformable ISA, then per-scale final 1x1 convs (reference
    nets/aggregation.py:406-464). Returns the similarity volumes, finest
    first ([H/3, H/6, H/12] for the ``aanet`` preset), each [B, D_s, H_s,
    W_s]. Without ``intermediate_supervision`` the last AAModule fuses into
    the finest scale only and only ``final_conv_0`` runs: one volume
    (aggregation.py:119-122,151-152). With ``remat`` each AAModule is
    checkpointed on its own in training (aggregation.py:134-137)."""

    def __init__(self, max_disp, num_scales=3, num_fusions=6, num_stage_blocks=1,
                 num_deform_blocks=3, deformable_groups=2, mdconv_dilation=2, remat=False,
                 intermediate_supervision=True):
        super().__init__()
        self.num_fusions, self.remat = num_fusions, remat
        self.num_outputs = num_scales if intermediate_supervision else 1
        for i in range(num_fusions):
            last = i == num_fusions - 1
            self.add_module(f"fusion_{i}", AdaptiveAggregationModule(
                num_scales=num_scales,
                num_output_branches=self.num_outputs if last else num_scales,
                max_disp=max_disp,
                num_blocks=num_stage_blocks,
                simple_bottleneck=i < num_fusions - num_deform_blocks,
                deformable_groups=deformable_groups,
                mdconv_dilation=mdconv_dilation,
            ))
        for i in range(self.num_outputs):
            d_i = max_disp // 2**i
            self.add_module(f"final_conv_{i}", DtypeConv2d(d_i, d_i, 1, bias=True))

    def forward(self, cost_volumes):
        x = list(cost_volumes)
        for i in range(self.num_fusions):
            module = getattr(self, f"fusion_{i}")
            x = remat(module, x) if self.remat and self.training else module(x)
        return [getattr(self, f"final_conv_{i}")(x[i]) for i in range(self.num_outputs)]


class StereoNetAggregation(nn.Module):
    """Four 3x3x3 conv + BatchNorm + leaky ReLU layers and a final 1-channel
    3x3x3 conv (``aggregation.py:162-175``): [B, C, D, H, W] -> [B, D, H, W]."""

    def __init__(self, channels=32):
        super().__init__()
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(channels, channels, K3, 1, 1))
            self.add_module(f"Norm_{i}", Norm(channels, dims=3))
        self.Conv_4 = Conv(channels, 1, K3, 1, 1, bias=True)

    def forward(self, cost_volume):
        x = cost_volume
        for i in range(4):
            x = leaky_relu(getattr(self, f"Norm_{i}")(getattr(self, f"Conv_{i}")(x)))
        return self.Conv_4(x)[:, 0]


def _add_convbn(module, name, cin, cout, stride=1):
    module.add_module(f"{name}_conv", Conv(cin, cout, K3, stride, 1))
    module.add_module(f"{name}_bn", Norm(cout, dims=3))


def _convbn(module, name, x):
    return getattr(module, f"{name}_bn")(getattr(module, f"{name}_conv")(x))


class PSMNetBasicAggregation(nn.Module):
    """PSMNet's basic aggregation (``aggregation.py:178-201``): two 3-D
    convs, four residual pairs ``dres1..4``, a classification head, and the
    x4 trilinear upsample to full resolution and max_disp candidates. It
    returns a one-map list in eval and training alike."""

    def __init__(self, in_channels=64):
        super().__init__()
        _add_convbn(self, "dres0a", in_channels, 32)
        _add_convbn(self, "dres0b", 32, 32)
        for i in range(1, 5):
            _add_convbn(self, f"dres{i}a", 32, 32)
            _add_convbn(self, f"dres{i}b", 32, 32)
        _add_convbn(self, "classify_a", 32, 32)
        self.classify_final = Conv(32, 1, K3, 1, 1)

    def forward(self, cost_volume):
        x = F.relu(_convbn(self, "dres0a", cost_volume))
        cost0 = F.relu(_convbn(self, "dres0b", x))
        for i in range(1, 5):
            y = F.relu(_convbn(self, f"dres{i}a", cost0))
            cost0 = _convbn(self, f"dres{i}b", y) + cost0
        x = self.classify_final(F.relu(_convbn(self, "classify_a", cost0)))
        d, h, w = x.shape[2:]
        return [resize_trilinear(x, (4 * d, 4 * h, 4 * w))[:, 0]]


class PSMNetHourglass(nn.Module):
    """One PSMNet 3-D hourglass (``aggregation.py:204-231``): down twice by
    stride-2 convs, up twice by transposed convs, with the previous
    hourglass's skips."""

    def __init__(self, inplanes):
        super().__init__()
        p = inplanes
        _add_convbn(self, "conv1", p, 2 * p, 2)  # 1/8
        _add_convbn(self, "conv2", 2 * p, 2 * p)
        _add_convbn(self, "conv3", 2 * p, 2 * p, 2)  # 1/16
        _add_convbn(self, "conv4", 2 * p, 2 * p)
        self.conv5 = ConvTranspose(2 * p, 2 * p, K3, 2, 1, 1)
        self.conv5_bn = Norm(2 * p, dims=3)
        self.conv6 = ConvTranspose(2 * p, p, K3, 2, 1, 1)
        self.conv6_bn = Norm(p, dims=3)

    def forward(self, x, presqu, postsqu):
        out = F.relu(_convbn(self, "conv1", x))
        pre = _convbn(self, "conv2", out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = F.relu(_convbn(self, "conv3", pre))
        out = F.relu(_convbn(self, "conv4", out))
        up5 = self.conv5_bn(self.conv5(out))
        post = F.relu(up5 + (presqu if presqu is not None else pre))
        return self.conv6_bn(self.conv6(post)), pre, post


class PSMNetHGAggregation(nn.Module):
    """PSMNet's stacked-hourglass aggregation (``aggregation.py:232-271``):
    four 3-D convs, three hourglasses and three classification heads, each
    upsampled x4 (trilinear) to full resolution and max_disp candidates.
    Eval returns [cost3]; training [cost1, cost2, cost3]."""

    def __init__(self, in_channels=64):
        super().__init__()
        _add_convbn(self, "dres0a", in_channels, 32)
        _add_convbn(self, "dres0b", 32, 32)
        _add_convbn(self, "dres1a", 32, 32)
        _add_convbn(self, "dres1b", 32, 32)
        for k in (1, 2, 3):
            self.add_module(f"hg{k}", PSMNetHourglass(32))
        for k in (1, 2, 3):
            _add_convbn(self, f"classif{k}_a", 32, 32)
            self.add_module(f"classif{k}_final", Conv(32, 1, K3, 1, 1))

    def _classify(self, y, k):
        y = F.relu(_convbn(self, f"classif{k}_a", y))
        return getattr(self, f"classif{k}_final")(y)

    def forward(self, cost_volume):
        x = F.relu(_convbn(self, "dres0a", cost_volume))
        x = F.relu(_convbn(self, "dres0b", x))
        cost0 = _convbn(self, "dres1b", F.relu(_convbn(self, "dres1a", x))) + x

        out1, pre1, post1 = self.hg1(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.hg2(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.hg3(out2, pre1, post2)
        out3 = out3 + cost0

        cost1 = self._classify(out1, 1)
        cost2 = self._classify(out2, 2) + cost1
        cost3 = self._classify(out3, 3) + cost2

        d, h, w = cost3.shape[2:]

        def up(c):
            return resize_trilinear(c, (4 * d, 4 * h, 4 * w))[:, 0]

        if self.training:
            return [up(cost1), up(cost2), up(cost3)]
        return [up(cost3)]


GCNET_LEVELS = 4  # stride-2 convs of the encoder below the input volume


class GCNetAggregation(nn.Module):
    """GC-Net's 3-D encoder-decoder (``aggregation.py:274-311``): 3-D
    conv + BatchNorm + ReLU pairs down four stride-2 levels, transposed
    convs back up with the encoder's skips. ``trans5`` has no output
    padding and no BatchNorm or ReLU, so the result of a [B, C, D, H, W]
    volume is [B, 2D - 1, 2H - 1, 2W - 1]: the reference's ConvTranspose3d
    arithmetic, matched and not fixed. D, H and W must be multiples of 16,
    or the skips do not fit the upsampled maps (the JAX model fails on the
    shapes there)."""

    def __init__(self, in_channels=64):
        super().__init__()
        _add_convbn(self, "conv1a", in_channels, 32)
        _add_convbn(self, "conv1b", 32, 32)
        for level, (cin, cout) in enumerate(((in_channels, 64), (64, 64), (64, 64), (64, 128)), 2):
            _add_convbn(self, f"conv{level}a", cin, cout, 2)
            _add_convbn(self, f"conv{level}b1", cout, cout)
            _add_convbn(self, f"conv{level}b2", cout, cout)
        for k, (cin, cout) in enumerate(((128, 64), (64, 64), (64, 64), (64, 32)), 1):
            self.add_module(f"trans{k}_conv", ConvTranspose(cin, cout, K3, 2, 1, 1))
            self.add_module(f"trans{k}_bn", Norm(cout, dims=3))
        self.trans5_conv = ConvTranspose(32, 1, K3, 2, 1, 0)

    def forward(self, cost_volume):
        multiple = 2**GCNET_LEVELS
        if any(s % multiple for s in cost_volume.shape[2:]):
            raise ValueError(
                f"GCNetAggregation: the volume's D, H, W {tuple(cost_volume.shape[2:])} must be "
                f"multiples of {multiple}, or its {GCNET_LEVELS} stride-2 levels do not come "
                "back to the skips' sizes"
            )

        def c3(x, name):
            return F.relu(_convbn(self, name, x))

        skips = [c3(c3(cost_volume, "conv1a"), "conv1b")]
        down = cost_volume
        for level in range(2, 6):
            down = c3(down, f"conv{level}a")
            skips.append(c3(c3(down, f"conv{level}b1"), f"conv{level}b2"))
        x = skips.pop()  # conv5b
        for k in range(1, 5):
            x = F.relu(getattr(self, f"trans{k}_bn")(getattr(self, f"trans{k}_conv")(x)))
            x = x + skips.pop()
        return self.trans5_conv(x)[:, 0]
