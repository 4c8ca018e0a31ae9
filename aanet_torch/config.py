"""Run configuration: ``ModelConfig`` and its named presets, ``DataConfig``,
``TrainConfig``, ``Config`` and the training recipes.

An own copy of ``aanet_tpu/config.py`` (the port imports nothing of the
JAX package). ``ModelConfig.build`` constructs the port's network and
raises ``NotImplementedError`` for what it does not run: a dtype other
than float32 and bfloat16, bfloat16 with a difference or concat volume,
and flags whose stages do not fit each other. It runs, in float32, for
inference and training, every preset (``aanet``, ``aanet+``,
``stereonet-aa``, ``psmnet-aa``, ``ganet-aa``, ``gcnet-aa``) and the
3-D-aggregation baselines reached through the model flags:

* PSMNet: ``feature_type="psmnet", feature_similarity="concat",
  aggregation_type="psmnet_hourglass", refinement_type="None"``, or
  ``aggregation_type="psmnet_basic"``;
* StereoNet: ``feature_type="stereonet", feature_similarity="difference",
  aggregation_type="stereonet", refinement_type="stereonet"``;
* GC-Net: ``feature_type="gcnet", feature_similarity="concat",
  aggregation_type="gcnet", num_downsample=1, refinement_type="None"``.

In bfloat16 (``dtype="bfloat16"``) it runs the six presets for inference
and training (float32 parameters, BatchNorm statistics and losses, as the
JAX package trains in bf16).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Sequence


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
    # compute dtype ('float32' | 'bfloat16'); None is float32. bfloat16
    # serves and trains, only with correlation volumes
    dtype: Optional[str] = None
    # training-time activation checkpointing (torch.utils.checkpoint per
    # feature pass, per AAModule and per refinement); inference ignores it
    remat: bool = True

    def build(self):
        """The port's ``AANet`` for this configuration (in training mode,
        as ``nn.Module``s start; call ``.eval()`` for inference).

        Raises ``NotImplementedError`` for what the port does not run: a
        dtype other than float32 and bfloat16, unknown stage types, and the
        combinations of flags whose cost volume and aggregation do not fit
        each other (the JAX composer fails on them too). A bfloat16 model
        serves and trains, with any cost volume."""
        refused = [
            (self.feature_type not in ("aanet", "stereonet", "psmnet", "ganet", "gcnet"),
             f"feature_type={self.feature_type!r}: unknown extractor"),
            (self.aggregation_type not in ("adaptive", "stereonet", "psmnet_hourglass",
                                           "psmnet_basic", "gcnet"),
             f"aggregation_type={self.aggregation_type!r}: unknown aggregation"),
            (self.refinement_type not in (None, "None", "stereonet", "stereodrnet", "hourglass"),
             f"refinement_type={self.refinement_type!r}: unknown refinement"),
            (self.dtype not in (None, "float32", "bfloat16"),
             f"dtype={self.dtype!r}: the PyTorch port runs float32 and bfloat16"),
        ]
        # the JAX composer's multi-scale rule (aanet.py:149-153): the AANet
        # extractor's three levels, or one scale made three by the FPN or
        # the pyramid (the FPN where both flags are set, aanet.py:94-99)
        multi_scale = (self.feature_type == "aanet" or self.feature_pyramid
                       or self.feature_pyramid_network)
        volume_4d = self.feature_similarity in ("difference", "concat")
        refused += [
            (self.feature_similarity not in ("correlation", "difference", "concat"),
             f"feature_similarity={self.feature_similarity!r}: unknown cost volume"),
            ((self.feature_type == "aanet") != bool(self.feature_pyramid_network),
             "the FPN runs on the AANet extractor's three levels, and only there "
             f"(feature_type={self.feature_type!r}, "
             f"feature_pyramid_network={self.feature_pyramid_network})"),
            ((self.aggregation_type == "adaptive") == volume_4d,
             f"feature_similarity={self.feature_similarity!r} with "
             f"aggregation_type={self.aggregation_type!r}: the adaptive aggregation takes "
             "correlation volumes, the 3-D aggregations difference or concat volumes"),
            (multi_scale and self.aggregation_type != "adaptive",
             "the 3-D aggregations take one volume of single-scale features"),
            (self.aggregation_type == "adaptive"
             and self.num_scales != (3 if multi_scale else 1),
             f"num_scales={self.num_scales} with feature_type={self.feature_type!r}: the "
             "port runs the adaptive aggregation at three scales when the features are "
             "multi-scale, else at one"),
        ]
        for refuse, message in refused:
            if refuse:
                raise NotImplementedError(message)
        from aanet_torch.models.aanet import AANet

        return AANet(
            max_disp=self.max_disp,
            num_downsample=self.num_downsample,
            feature_type=self.feature_type,
            feature_pyramid_network=self.feature_pyramid_network,
            feature_pyramid=self.feature_pyramid,
            feature_similarity=self.feature_similarity,
            aggregation_type=self.aggregation_type,
            num_scales=self.num_scales,
            num_fusions=self.num_fusions,
            num_stage_blocks=self.num_stage_blocks,
            num_deform_blocks=self.num_deform_blocks,
            intermediate_supervision=not self.no_intermediate_supervision,
            refinement_type=self.refinement_type,
            mdconv_dilation=self.mdconv_dilation,
            deformable_groups=self.deformable_groups,
            feature_mdconv=not self.no_feature_mdconv,
            remat=self.remat,
            dtype=self.dtype,
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


@dataclass
class DataConfig:
    data_dir: str = "data/SceneFlow"
    dataset_name: str = "SceneFlow"  # SceneFlow | KITTI2012 | KITTI2015 | KITTI_mix
    mode: str = "val"  # train | train_all | val | test
    split_preset: str = "full"  # debug | overfit | subset_{N} | full
    filename_root: Optional[str] = None  # dir holding the filename lists
    batch_size: int = 64
    val_batch_size: int = 64
    img_height: int = 288
    img_width: int = 576
    val_img_height: int = 576
    val_img_width: int = 960
    num_workers: int = 8
    load_pseudo_gt: bool = False


@dataclass
class TrainConfig:
    checkpoint_dir: str = "checkpoints/run"
    seed: int = 326
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    offset_lr_mult: float = 0.1  # offset_conv params x0.1 (train.py:209)
    lr_decay_gamma: float = 0.5
    milestones: Sequence[int] = (20, 30, 40, 50, 60)  # epochs
    max_epoch: int = 64
    accumulation_steps: int = 1
    freeze_bn: bool = False
    highest_loss_only: bool = False
    val_metric: str = "epe"  # epe | d1
    # models/aanet_epoch_NNN.pt, without the optimizer, every this many epochs
    save_ckpt_freq: int = 5
    print_freq: int = 50
    # image panels and the signed-error histogram every this many steps
    summary_freq: int = 100
    # continue from aanet_latest.pt under checkpoint_dir, where there is one
    resume: bool = False
    # validation only, as the evaluate entry point runs it: no aanet_best
    # is written (aanet_tpu/config.py:85)
    evaluate_only: bool = False
    no_validate: bool = False
    # non-strict pretrained loading by default, like the reference
    strict_load: bool = False
    pretrained: Optional[str] = None


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _recipe(model_name: str, stage: str) -> Config:
    """The reference's staged training pipelines for AANet and AANet+
    (scripts/aanet_train.sh, scripts/aanet+_train.sh:5-60;
    aanet_tpu/config.py:164-240). Stage N's ``pretrained`` is stage N-1's
    checkpoint, a torch file of the port."""
    model = preset(model_name)
    plus = "+" in model_name
    if stage == "sceneflow":
        # batch 64 over 4 V100s (README.md:110); AANet+ at 16
        data = DataConfig(
            dataset_name="SceneFlow", mode="val", batch_size=16 if plus else 64,
            val_batch_size=64, img_height=288, img_width=576, val_img_height=576,
            val_img_width=960,
        )
        train = TrainConfig(
            checkpoint_dir=f"checkpoints/{model_name}_sceneflow",
            learning_rate=1e-3, milestones=(20, 30, 40, 50, 60), max_epoch=64,
        )
    elif stage == "kittimix":
        # pseudo-GT supervised KITTI mix (aanet+_train.sh:21-40)
        data = DataConfig(
            data_dir="data/KITTI", dataset_name="KITTI_mix", mode="train",
            batch_size=8 if plus else 6, val_batch_size=8, img_height=288 if plus else 336,
            img_width=1152 if plus else 960, val_img_height=384, val_img_width=1248,
            load_pseudo_gt=True,
        )
        train = TrainConfig(
            checkpoint_dir=f"checkpoints/{model_name}_kittimix",
            pretrained=f"checkpoints/{model_name}_sceneflow/aanet_best.pt",
            learning_rate=1e-3, milestones=(400, 600, 800, 900),
            max_epoch=1000, save_ckpt_freq=100, no_validate=True,
        )
    elif stage in ("kitti15", "kitti12"):
        # the full-resolution fine-tune on the last map; AANet+ with frozen
        # BatchNorm (aanet+_train.sh:42-60)
        k15 = stage == "kitti15"
        data = DataConfig(
            data_dir=(
                "data/KITTI/kitti_2015/data_scene_flow"
                if k15 else "data/KITTI/kitti_2012/data_stereo_flow"
            ),
            dataset_name="KITTI2015" if k15 else "KITTI2012",
            mode="train_all", batch_size=8 if plus else 6, val_batch_size=8,
            img_height=384, img_width=1248, val_img_height=384, val_img_width=1248,
            load_pseudo_gt=True,
        )
        train = TrainConfig(
            checkpoint_dir=f"checkpoints/{model_name}_{stage}",
            pretrained=f"checkpoints/{model_name}_kittimix/aanet_latest.pt",
            learning_rate=1e-4, milestones=(400, 600, 800, 900),
            max_epoch=1000, save_ckpt_freq=100, no_validate=True, highest_loss_only=True,
            freeze_bn=plus,
        )
    else:
        raise KeyError(stage)
    return Config(model=model, data=data, train=train)


RUN_RECIPES = {
    f"{m}_{s}": (m, s)
    for m in ("aanet", "aanet+")
    for s in ("sceneflow", "kittimix", "kitti15", "kitti12")
}


def recipe(name: str) -> Config:
    """Full Config for a named training recipe (e.g. 'aanet+_sceneflow')."""
    if name not in RUN_RECIPES:
        raise KeyError(f"unknown recipe {name!r}; have {sorted(RUN_RECIPES)}")
    return _recipe(*RUN_RECIPES[name])
