"""AANet composer for the ``aanet`` preset (aanet_tpu/models/aanet.py).

feature extraction (ResNet-40 + FPN) -> correlation cost-volume pyramid ->
adaptive aggregation -> soft-argmin at three scales -> two StereoDRNet
refinements at H/2 and H. The output is the disparity pyramid, coarse to
fine: [H/12, H/6, H/3, H/2, H], each a float32 [B, h, w] map, the same
list the JAX model returns.

In eval mode one feature pass runs over both views stacked on the batch
axis (exact: shared weights, running BatchNorm statistics). In training
mode the views take two separate feature passes, left then right, so each
BatchNorm updates its statistics once per view, as the reference and the
JAX model do (aanet_tpu/models/aanet.py:242-244). With ``remat`` the
training forward is checkpointed as the JAX model rematerialises it
(aanet.py:206-213): each view's feature pass and each refinement stage as
a whole, each AAModule and each refinement BasicBlock on its own.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from aanet_torch.models.aggregation import AdaptiveAggregation
from aanet_torch.models.feature import AANetFeature, FeaturePyramidNetwork
from aanet_torch.models.layers import remat
from aanet_torch.models.refinement import StereoDRNetRefinement
from aanet_torch.ops import cost_volume as cost_ops
from aanet_torch.ops import softargmin as softargmin_ops
from aanet_torch.ops.resize import resize_bilinear

NUM_DOWNSAMPLE = 2  # refinements at H/2 and H


class AANet(nn.Module):
    """The five-stage adaptive-aggregation stereo network.

    Build it through ``aanet_torch.config.ModelConfig.build``. Parameter
    names follow the flax model's paths (``aanet_torch/convert.py``).
    """

    def __init__(self, max_disp=192, num_fusions=6, num_stage_blocks=1,
                 num_deform_blocks=3, mdconv_dilation=2, deformable_groups=2,
                 feature_mdconv=True, remat=True):
        super().__init__()
        self.remat = remat
        # the ResNet-40 features start at H/3 (nets/aanet.py:43-61)
        self.max_disp = max_disp // 3
        self.feature_extractor = AANetFeature(feature_mdconv=feature_mdconv)
        self.fpn = FeaturePyramidNetwork(out_channels=128)
        self.aggregation = AdaptiveAggregation(
            self.max_disp, num_scales=3, num_fusions=num_fusions,
            num_stage_blocks=num_stage_blocks, num_deform_blocks=num_deform_blocks,
            deformable_groups=deformable_groups, mdconv_dilation=mdconv_dilation,
            remat=remat,
        )
        self.refinement_0 = StereoDRNetRefinement(remat=remat)
        self.refinement_1 = StereoDRNetRefinement(remat=remat)

    def _features(self, img):
        return self.fpn(self.feature_extractor(img))

    def _refine(self, left_img, right_img, disparity):
        """The two refinements at H/2 and H: [disp at H/2, disp at H]."""
        out = []
        h, w = left_img.shape[2:]
        for i in range(NUM_DOWNSAMPLE):
            scale = 1.0 / 2 ** (NUM_DOWNSAMPLE - i - 1)
            if scale == 1.0:
                curr_left, curr_right = left_img, right_img
            else:
                hw = (int(h * scale), int(w * scale))
                curr_left = resize_bilinear(left_img, hw)
                curr_right = resize_bilinear(right_img, hw)
            disparity = getattr(self, f"refinement_{i}")(disparity, curr_left, curr_right)
            out.append(disparity)
        return out

    def forward(self, left_img: torch.Tensor, right_img: torch.Tensor):
        """left_img, right_img: [B, 3, H, W] normalised images -> the
        disparity pyramid [H/12, H/6, H/3, H/2, H]."""
        n = left_img.shape[0]
        checkpointed = self.training and self.remat
        if self.training:
            features = (lambda img: remat(self._features, img)) if checkpointed else self._features
            left_feats, right_feats = features(left_img), features(right_img)
        else:
            feats = self._features(torch.cat([left_img, right_img], 0))
            left_feats, right_feats = [f[:n] for f in feats], [f[n:] for f in feats]
        vols = [
            cost_ops.correlation_cost_volume(lf, rf, self.max_disp // 2**s)
            for s, (lf, rf) in enumerate(zip(left_feats, right_feats))
        ]
        aggregation = self.aggregation(vols)
        # coarse to fine: [H/3, H/6, H/12] -> [H/12, H/6, H/3]
        pyramid = [softargmin_ops.soft_argmin(v) for v in aggregation[::-1]]
        if checkpointed:
            pyramid += remat(self._refine, left_img, right_img, pyramid[-1])
        else:
            pyramid += self._refine(left_img, right_img, pyramid[-1])
        return [d.float() for d in pyramid]
