"""One train step of GC-Net, the StereoNet baseline and the
``stereonet-aa`` preset in the PyTorch port against the JAX package's
``make_train_step``, on the CPU, at batch 2: GC-Net at 64x128 with
max_disp 32 (H/2, W/2 and max_disp/2 multiples of 16, as its four
stride-2 levels need), the other two at 48x96 with max_disp 48.

GC-Net's map is one pixel short on each axis; the loss upsamples it to
the ground truth with the width rescale, as the JAX loss does.
Tolerances as test_torch_train3d.py.
"""
import dataclasses

import pytest

from aanet_tpu.config import ModelConfig as JaxModelConfig
from aanet_tpu.config import preset as jax_preset
from aanet_torch.config import ModelConfig, preset
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

from _torch_port import compare_train_step

GCNET = dict(feature_type="gcnet", feature_similarity="concat", aggregation_type="gcnet",
             num_downsample=1, refinement_type="None", max_disp=32)
STEREONET = dict(feature_type="stereonet", feature_similarity="difference",
                 aggregation_type="stereonet", refinement_type="stereonet", max_disp=48)
CONFIGS = {
    "gcnet": (JaxModelConfig(**GCNET), ModelConfig(**GCNET), (64, 128)),
    "stereonet": (JaxModelConfig(**STEREONET), ModelConfig(**STEREONET), (48, 96)),
    "stereonet-aa": (dataclasses.replace(jax_preset("stereonet-aa"), max_disp=48),
                     dataclasses.replace(preset("stereonet-aa"), max_disp=48), (48, 96)),
}


@pytest.fixture(autouse=True)
def no_launches_on_cpu():
    yield
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax(name):
    jax_cfg, cfg, hw = CONFIGS[name]
    metrics = compare_train_step(jax_cfg, cfg, hw, 2)
    assert float(metrics["total_loss"]) > 0
