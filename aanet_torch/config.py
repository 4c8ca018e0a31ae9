"""Model configuration: the ``ModelConfig`` dataclass and its named presets.

An own copy of ``aanet_tpu/config.py:15-153`` (the port imports nothing of
the JAX package). ``ModelConfig.build`` constructs the port's network and
raises ``NotImplementedError`` for every preset or flag the port does not
run yet: it runs the ``aanet`` preset's inference forward in float32.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class ModelConfig:
    """Flags consumed by the AANet composer (reference nets/aanet.py:14-31)."""

    max_disp: int = 192
    num_downsample: int = 2
    feature_type: str = "aanet"
    no_feature_mdconv: bool = False
    feature_pyramid: bool = False
    feature_pyramid_network: bool = False
    feature_similarity: str = "correlation"
    aggregation_type: str = "adaptive"
    num_scales: int = 3
    num_fusions: int = 6
    num_stage_blocks: int = 1
    num_deform_blocks: int = 3
    no_intermediate_supervision: bool = False
    refinement_type: Optional[str] = "stereodrnet"
    mdconv_dilation: int = 2
    deformable_groups: int = 2
    # compute dtype ('float32' | 'bfloat16'); None is float32
    dtype: Optional[str] = None
    # training-time activation rematerialisation; inference ignores it
    remat: bool = True

    def build(self):
        """The port's ``AANet`` for this configuration (in training mode,
        as ``nn.Module``s start; call ``.eval()`` for inference)."""
        unsupported = {
            "feature_type": (self.feature_type, "aanet"),
            "feature_pyramid_network": (self.feature_pyramid_network, True),
            "feature_pyramid": (self.feature_pyramid, False),
            "feature_similarity": (self.feature_similarity, "correlation"),
            "aggregation_type": (self.aggregation_type, "adaptive"),
            "refinement_type": (self.refinement_type, "stereodrnet"),
            "num_scales": (self.num_scales, 3),
            "num_downsample": (self.num_downsample, 2),
            "no_intermediate_supervision": (self.no_intermediate_supervision, False),
        }
        for flag, (value, supported) in unsupported.items():
            if value != supported:
                raise NotImplementedError(
                    f"{flag}={value!r}: the PyTorch port runs only {flag}={supported!r} "
                    "(the 'aanet' preset) so far"
                )
        if self.dtype not in (None, "float32"):
            raise NotImplementedError(
                f"dtype={self.dtype!r}: the PyTorch port runs float32 only so far"
            )
        from aanet_torch.models.aanet import AANet

        return AANet(
            max_disp=self.max_disp,
            num_fusions=self.num_fusions,
            num_stage_blocks=self.num_stage_blocks,
            num_deform_blocks=self.num_deform_blocks,
            mdconv_dilation=self.mdconv_dilation,
            deformable_groups=self.deformable_groups,
            feature_mdconv=not self.no_feature_mdconv,
        )


MODEL_PRESETS = {
    # scripts/aanet_inference.sh:4-13
    "aanet": ModelConfig(feature_type="aanet", feature_pyramid_network=True),
    # scripts/aanet+_train.sh:14-16
    "aanet+": ModelConfig(
        feature_type="ganet", feature_pyramid=True, refinement_type="hourglass"
    ),
    # scripts/stereonet-aa_inference.sh
    "stereonet-aa": ModelConfig(
        feature_type="stereonet",
        num_scales=1,
        num_fusions=4,
        num_deform_blocks=4,
        refinement_type="stereonet",
    ),
    # scripts/psmnet-aa_inference.sh
    "psmnet-aa": ModelConfig(
        feature_type="psmnet", feature_pyramid=True, no_intermediate_supervision=True
    ),
    # scripts/ganet-aa_inference.sh
    "ganet-aa": ModelConfig(
        feature_type="ganet", feature_pyramid=True, no_intermediate_supervision=True
    ),
    # scripts/gcnet-aa_inference.sh
    "gcnet-aa": ModelConfig(
        feature_type="gcnet",
        feature_pyramid=True,
        num_downsample=1,
        no_intermediate_supervision=True,
    ),
}


def preset(name: str) -> ModelConfig:
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(MODEL_PRESETS)}")
    return dataclasses.replace(MODEL_PRESETS[name])
