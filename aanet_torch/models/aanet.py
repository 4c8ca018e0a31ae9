"""The stereo composer (aanet_tpu/models/aanet.py): feature extraction ->
cost volume -> aggregation -> soft-argmin -> hierarchical refinement,
assembled from the model flags.

The configurations it runs (``aanet_torch.config.ModelConfig.build``
refuses the rest):
* ``aanet``: ResNet-40 + FPN, the correlation pyramid at H/3, H/6, H/12,
  adaptive aggregation, soft-argmin at three scales, two StereoDRNet
  refinements: the pyramid [H/12, H/6, H/3, H/2, H];
* ``stereonet-aa``: StereoNet features at H/4, one correlation volume,
  adaptive aggregation at one scale, two StereoNet refinements:
  [H/4, H/2, H];
* the StereoNet baseline: StereoNet features, the difference volume, four
  3-D convs, a negated soft-argmin (a matching cost), two StereoNet
  refinements: [H/4, H/2, H];
* the PSMNet baseline: SPP features at H/4, the concat volume, three 3-D
  hourglasses upsampled x4, soft-argmin, no refinement: [H] in eval and,
  in training, the three heads in the JAX package's order
  [cost3, cost2, cost1] (its composer reverses the aggregation's list);
  with the basic aggregation (``psmnet_basic``) one head, [H], in both;
* GC-Net: features at H/2, the concat volume over max_disp / 2
  candidates, the 3-D encoder-decoder, a negated soft-argmin (a concat
  volume without PSMNet's aggregation is a matching cost), no refinement:
  [(H - 1, W - 1)], one pixel short on each axis as in the reference;
* ``psmnet-aa``: SPP features at H/4 made three scales by the strided
  ``FeaturePyramid`` (32/64/128 channels at H/4, H/8, H/16), the
  correlation pyramid over 48/24/12 candidates at max_disp 192, the
  adaptive aggregation with one output (no intermediate supervision),
  soft-argmin at H/4, two StereoDRNet refinements: [H/4, H/2, H];
* ``gcnet-aa``: GC-Net features at H/2 through the same pyramid (H/2,
  H/4, H/8; 96/48/24 candidates), one output, one StereoDRNet
  refinement: [H/2, H];
* ``aanet+``: GANet's UNet features at H/3 (deformable) through the same
  pyramid (32/64/128 channels at H/3, H/6, H/12; 64/32/16 candidates at
  max_disp 192), the adaptive aggregation with intermediate supervision,
  soft-argmin at three scales, two hourglass refinements: the pyramid
  [H/12, H/6, H/3, H/2, H]; H and W multiples of 96;
* ``ganet-aa``: the same features and pyramid, one output, two
  StereoDRNet refinements: [H/3, H/2, H]; H and W multiples of 48.

Every map is a float32 [B, h, w] disparity. Under ``dtype="bfloat16"``
the forward installs bf16 as the compute dtype (``ops.precision``) and
casts both images to it (aanet.py:217-221): the convs, BatchNorms,
deformable convs, correlation volumes and warps then run in bf16, while
the parameters and statistics, the offset heads, soft-argmin's
disparities, the refinements' ``disp + residual`` (a float32 disparity
meets a bf16 residual) and the disparity upsampling stay float32. It
serves and trains in bf16; under ``remat`` backward recomputes a block
under the same compute dtype (``layers.remat``).

In eval mode one feature pass runs over both views stacked on the batch
axis (exact: shared weights, running BatchNorm statistics). In training
mode the views take two separate feature passes, left then right, so each
BatchNorm updates its statistics once per view, as the reference and the
JAX model do (aanet_tpu/models/aanet.py:242-244). With ``remat`` the
training forward is checkpointed as the JAX model rematerialises it
(aanet.py:206-213): each view's feature pass and each refinement stage as
a whole, the 3-D aggregations as a whole, each AAModule and each
refinement BasicBlock on its own.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from aanet_torch.models.aggregation import (
    AdaptiveAggregation,
    GCNetAggregation,
    PSMNetBasicAggregation,
    PSMNetHGAggregation,
    StereoNetAggregation,
)
from aanet_torch.models.feature import (
    AANetFeature,
    FeaturePyramid,
    FeaturePyramidNetwork,
    GANetFeature,
    GCNetFeature,
    PSMNetFeature,
    StereoNetFeature,
)
from aanet_torch.models.layers import remat
from aanet_torch.models.refinement import (
    HourglassRefinement,
    StereoDRNetRefinement,
    StereoNetRefinement,
)
from aanet_torch.ops import cost_volume as cost_ops
from aanet_torch.ops import softargmin as softargmin_ops
from aanet_torch.ops.precision import canonical_dtype, precision
from aanet_torch.ops.resize import resize_bilinear

FEATURE_CHANNELS = 32  # the StereoNet, PSMNet and GC-Net extractors' output
REFINEMENTS = {"stereonet": StereoNetRefinement, "stereodrnet": StereoDRNetRefinement,
               "hourglass": HourglassRefinement}
AGGREGATIONS_3D = {"stereonet": StereoNetAggregation, "psmnet_basic": PSMNetBasicAggregation,
                   "psmnet_hourglass": PSMNetHGAggregation, "gcnet": GCNetAggregation}
# the feature scale of each extractor (nets/aanet.py:43-61); StereoNet's
# and PSMNet's is 2^num_downsample
FEATURE_SCALE = {"aanet": 3, "ganet": 3, "gcnet": 2}


class AANet(nn.Module):
    """The five-stage stereo network of the model flags.

    Build it through ``aanet_torch.config.ModelConfig.build``, which checks
    the flags. Parameter names follow the flax model's paths
    (``aanet_torch/convert.py``).
    """

    def __init__(self, max_disp=192, num_downsample=2, feature_type="aanet",
                 feature_pyramid_network=True, feature_pyramid=False,
                 feature_similarity="correlation", aggregation_type="adaptive", num_scales=3,
                 num_fusions=6, num_stage_blocks=1, num_deform_blocks=3,
                 intermediate_supervision=True, refinement_type="stereodrnet",
                 mdconv_dilation=2, deformable_groups=2, feature_mdconv=True, remat=True,
                 dtype=None):
        super().__init__()
        self.remat = remat
        self.dtype = canonical_dtype(dtype)  # None for float32: no policy
        self.num_downsample = num_downsample
        self.feature_similarity = feature_similarity
        self.aggregation_type = aggregation_type
        self.num_scales = num_scales
        self.max_disp = max_disp // FEATURE_SCALE.get(feature_type, 2**num_downsample)
        if feature_type == "aanet":
            self.feature_extractor = AANetFeature(feature_mdconv=feature_mdconv)
        elif feature_type == "stereonet":
            self.feature_extractor = StereoNetFeature(num_downsample)
        elif feature_type == "psmnet":
            self.feature_extractor = PSMNetFeature()
        elif feature_type == "ganet":
            self.feature_extractor = GANetFeature(feature_mdconv=feature_mdconv)
        elif feature_type == "gcnet":
            self.feature_extractor = GCNetFeature()
        else:
            raise NotImplementedError(feature_type)
        # the FPN where both are asked for, as the JAX composer (aanet.py:94-99)
        if feature_pyramid_network:
            self.fpn = FeaturePyramidNetwork(out_channels=128)
        elif feature_pyramid:
            self.fpn = FeaturePyramid()
        else:
            self.fpn = None

        if aggregation_type == "adaptive":
            self.aggregation = AdaptiveAggregation(
                self.max_disp, num_scales=num_scales, num_fusions=num_fusions,
                num_stage_blocks=num_stage_blocks, num_deform_blocks=num_deform_blocks,
                deformable_groups=deformable_groups, mdconv_dilation=mdconv_dilation,
                remat=remat, intermediate_supervision=intermediate_supervision,
            )
        elif aggregation_type in AGGREGATIONS_3D:
            channels = FEATURE_CHANNELS * (2 if feature_similarity == "concat" else 1)
            self.aggregation = AGGREGATIONS_3D[aggregation_type](channels)
        else:
            raise NotImplementedError(aggregation_type)

        self.refinement_type = None if refinement_type in (None, "None") else refinement_type
        if self.refinement_type is not None:
            for i in range(num_downsample):
                self.add_module(f"refinement_{i}", REFINEMENTS[self.refinement_type](remat=remat))

    def _features(self, img):
        feats = self.feature_extractor(img)
        return self.fpn(feats) if self.fpn is not None else feats

    def _cost_volumes(self, left, right):
        """The correlation pyramid of multi-scale features, else one volume
        (in a list for the adaptive aggregation) (aanet.py:147-164)."""
        if isinstance(left, list):
            vols = [cost_ops.cost_volume(lf, rf, self.max_disp // 2**s, self.feature_similarity)
                    for s, (lf, rf) in enumerate(zip(left, right))]
            return vols[:1] if self.num_scales == 1 else vols
        vol = cost_ops.cost_volume(left, right, self.max_disp, self.feature_similarity)
        return [vol] if self.aggregation_type == "adaptive" else vol

    def _disparities(self, aggregation):
        """Soft-argmin of each aggregated volume, coarse to fine
        (aanet.py:166-175); a difference volume is a matching cost."""
        match_similarity = self.feature_similarity not in ("difference", "concat")
        if "psmnet" in self.aggregation_type:
            match_similarity = True  # PSMNet learns a similarity from the concat volume
        if isinstance(aggregation, list):
            return [softargmin_ops.soft_argmin(v, match_similarity) for v in aggregation[::-1]]
        return [softargmin_ops.soft_argmin(aggregation, match_similarity)]

    def _refine(self, left_img, right_img, disparity):
        """The refinements at H/2^(k-1), ..., H/2, H."""
        out = []
        h, w = left_img.shape[2:]
        for i in range(self.num_downsample):
            scale = 1.0 / 2 ** (self.num_downsample - i - 1)
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
        disparity pyramid, coarse to fine, in float32 (float64 for a
        float64 model), under the model's compute dtype."""
        with precision(self.dtype):
            if self.dtype is not None:
                left_img, right_img = left_img.to(self.dtype), right_img.to(self.dtype)
            return self._forward(left_img, right_img)

    def _forward(self, left_img, right_img):
        n = left_img.shape[0]
        checkpointed = self.training and self.remat
        if self.training:
            features = (lambda img: remat(self._features, img)) if checkpointed else self._features
            left_feats, right_feats = features(left_img), features(right_img)
        else:
            feats = self._features(torch.cat([left_img, right_img], 0))
            if isinstance(feats, list):
                left_feats, right_feats = [f[:n] for f in feats], [f[n:] for f in feats]
            else:
                left_feats, right_feats = feats[:n], feats[n:]
        vols = self._cost_volumes(left_feats, right_feats)
        if checkpointed and self.aggregation_type != "adaptive":
            aggregation = remat(self.aggregation, vols)
        else:
            aggregation = self.aggregation(vols)
        pyramid = self._disparities(aggregation)
        if self.refinement_type is not None:
            if checkpointed:
                pyramid += remat(self._refine, left_img, right_img, pyramid[-1])
            else:
                pyramid += self._refine(left_img, right_img, pyramid[-1])
        return [d.to(torch.promote_types(d.dtype, torch.float32)) for d in pyramid]
