"""Adaptive cost aggregation (aanet_tpu/models/aggregation.py:32-153).

Correlation volumes are [B, D_s, H_s, W_s]: the disparity axis is the
channel axis, so the intra-scale (ISA) bottlenecks and the cross-scale
(CSA) fusions are plain 2-D convs.
"""
from __future__ import annotations

import torch.nn as nn

from aanet_torch.models.layers import (
    Conv,
    DeformSimpleBottleneck,
    Norm,
    SimpleBottleneck,
    leaky_relu,
    remat,
)
from aanet_torch.ops.resize import resize_bilinear


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
    nets/aggregation.py:406-464). Returns the similarity volumes
    [H/3, H/6, H/12], each [B, D_s, H_s, W_s]. With ``remat`` each AAModule
    is checkpointed on its own in training (aggregation.py:134-137)."""

    def __init__(self, max_disp, num_scales=3, num_fusions=6, num_stage_blocks=1,
                 num_deform_blocks=3, deformable_groups=2, mdconv_dilation=2, remat=False):
        super().__init__()
        self.num_fusions, self.num_scales, self.remat = num_fusions, num_scales, remat
        for i in range(num_fusions):
            self.add_module(f"fusion_{i}", AdaptiveAggregationModule(
                num_scales=num_scales,
                num_output_branches=num_scales,
                max_disp=max_disp,
                num_blocks=num_stage_blocks,
                simple_bottleneck=i < num_fusions - num_deform_blocks,
                deformable_groups=deformable_groups,
                mdconv_dilation=mdconv_dilation,
            ))
        for i in range(num_scales):
            d_i = max_disp // 2**i
            self.add_module(f"final_conv_{i}", nn.Conv2d(d_i, d_i, 1, bias=True))

    def forward(self, cost_volumes):
        x = list(cost_volumes)
        for i in range(self.num_fusions):
            module = getattr(self, f"fusion_{i}")
            x = remat(module, x) if self.remat and self.training else module(x)
        return [getattr(self, f"final_conv_{i}")(x[i]) for i in range(self.num_scales)]
