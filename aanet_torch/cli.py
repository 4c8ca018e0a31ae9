"""Command-line entry points of the PyTorch port:

  python -m aanet_torch.cli train --preset aanet --data_dir data/SceneFlow \\
      --checkpoint_dir runs/aanet [--recipe aanet_sceneflow] [--resume] \\
      [--save_ckpt_freq 5] [--device cuda|cpu]
  python -m aanet_torch.cli evaluate --preset aanet --data_dir data/SceneFlow \\
      [--pretrained ckpt.msgpack.gz | --checkpoint_dir runs/aanet] [--device cuda|cpu]
  python -m aanet_torch.cli inference --preset aanet --data_dir data/KITTI \\
      --dataset_name KITTI2015 --img_height 384 --img_width 1248 \\
      --pretrained weights.pt [--count_time] [--device cuda|cpu]
  python -m aanet_torch.cli predict --preset aanet --data_dir pairs/ \\
      [--pretrained weights.pt] [--device cuda|cpu]
  python -m aanet_torch.cli train --feature_type psmnet \\
      --feature_similarity concat --aggregation_type psmnet_hourglass \\
      --refinement_type None --data_dir data/SceneFlow --checkpoint_dir runs/psmnet
  python -m aanet_torch.cli predict --feature_type gcnet \\
      --feature_similarity concat --aggregation_type gcnet --num_downsample 1 \\
      --refinement_type None --data_dir pairs/

All take the JAX CLI's model flags (aanet_tpu/cli.py:94-122) on top of
``--preset``: the PSMNet (hourglass or basic aggregation), StereoNet and
GC-Net baselines are reached through them, as in the JAX package, which
has no preset or recipe for them. ``train`` also takes the data flags and the
training flags, and the recipes of both AANet and AANet+ (``--recipe
aanet+_sceneflow``). It writes ``aanet_latest.pt`` after every epoch,
``models/aanet_epoch_NNN.pt`` every ``--save_ckpt_freq`` epochs and
``aanet_best.pt`` on the best validation, each with the JAX package's
flax pair beside it (``.msgpack`` and ``.json``, for the JAX package's
``--pretrained``: they hold no optimizer state), the summaries under
``tb/`` (scalars every ``--print_freq`` steps, panels every
``--summary_freq``), ``lossRecord.mat``, ``valLossRecord.mat`` and the
validation's ``matlab_analysis/``; ``--resume`` continues from
``aanet_latest.pt``. ``train`` and ``evaluate`` run data-parallel under a
launcher, one process a card:

  torchrun --nproc_per_node N -m aanet_torch.cli train --preset aanet ...

where ``--device cuda`` is the card ``cuda:LOCAL_RANK``, ``--batch_size``
the global batch (each process takes its share) and only rank 0 writes
files. ``evaluate``
takes the same flags, validates on the ``--mode`` split (``val`` by
default) and prints the metrics as one JSON line; its weights are
``--pretrained``, else ``aanet_best.pt`` and then
``aanet_latest.pt`` under ``--checkpoint_dir`` (``FileNotFoundError``
without one). ``inference`` predicts the test split of a filename-list
dataset, padded to ``--img_height`` x ``--img_width`` and cropped back, and
with ``--count_time`` prints ``{"mean_inference_seconds": ...}`` instead.
``predict`` reads ``left/*.png`` and ``right/`` with the
same names under ``--data_dir`` (GC-Net's map, one pixel short of the
padded pair, crops to one row fewer than the image, as the JAX
``predict`` gives it). Weights are a torch state_dict file, a training
checkpoint, or a flax checkpoint of the JAX package (``.msgpack`` or
``.msgpack.gz``). All default to ``--device cuda`` and raise without a
GPU. Float32 convolutions and matmuls run in full float32 (TF32 off), as
the JAX package's float32 mode does. ``--dtype bfloat16`` serves and
trains in the JAX package's bf16 policy (``train``, ``evaluate``,
``inference``, ``predict``; parameters, also a flax checkpoint's, stay
float32, and so do the checkpoints ``train`` writes, which any entry point
reads in either dtype).
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch

from aanet_torch.config import Config, DataConfig, ModelConfig, TrainConfig, preset, recipe
from aanet_torch.parallel import mesh

_MODEL_FLAGS = {
    "max_disp": int, "feature_type": str, "feature_similarity": str, "num_downsample": int,
    "aggregation_type": str, "num_scales": int, "num_fusions": int, "num_stage_blocks": int,
    "num_deform_blocks": int, "refinement_type": str, "mdconv_dilation": int,
    "deformable_groups": int, "dtype": str,
}
DTYPES = ("float32", "bfloat16")  # --dtype: the compute dtype (aanet_tpu/cli.py:117-119)
# tri-state: None keeps the preset's value, --flag / --no-flag set it
_MODEL_SWITCHES = ("no_feature_mdconv", "feature_pyramid", "feature_pyramid_network",
                   "no_intermediate_supervision")
_DATA_FLAGS = {
    "data_dir": str, "dataset_name": str, "mode": str, "split_preset": str, "filename_root": str,
    "batch_size": int, "val_batch_size": int, "img_height": int, "img_width": int,
    "val_img_height": int, "val_img_width": int, "num_workers": int,
}
_TRAIN_FLAGS = {
    "checkpoint_dir": str, "seed": int, "learning_rate": float, "weight_decay": float,
    "lr_decay_gamma": float, "milestones": str, "max_epoch": int, "accumulation_steps": int,
    "val_metric": str, "save_ckpt_freq": int, "print_freq": int, "summary_freq": int,
    "pretrained": str,
}
_TRAIN_SWITCHES = ("freeze_bn", "highest_loss_only", "no_validate", "load_pseudo_gt", "strict",
                   "resume")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")


def _add_model_args(p):
    p.add_argument("--preset", default=None,
                   help="model preset: 'aanet' (the default), 'aanet+', 'stereonet-aa', "
                        "'psmnet-aa', 'ganet-aa' or 'gcnet-aa'; the PSMNet, StereoNet and GC-Net "
                        "baselines take the model flags instead")
    for name, kind in _MODEL_FLAGS.items():
        if name == "dtype":
            p.add_argument("--dtype", choices=DTYPES, default=None,
                           help="compute dtype (default float32); bfloat16 trains and serves "
                                "(parameters and checkpoints stay float32)")
        else:
            p.add_argument(f"--{name}", type=kind, default=None)
    for name in _MODEL_SWITCHES:
        p.add_argument(f"--{name}", action=argparse.BooleanOptionalAction, default=None)


def _apply_model_flags(model, args):
    for name in (*_MODEL_FLAGS, *_MODEL_SWITCHES):
        if getattr(args, name) is not None:
            setattr(model, name, getattr(args, name))
    return model


def model_config(args) -> ModelConfig:
    """``--preset``'s model with the model flags given on top. Without
    ``--preset`` the base is the JAX CLI's, ``ModelConfig()``, with the FPN
    on exactly when the extractor is AANet's (the FPN runs only on its
    three levels): no flags give the ``aanet`` preset, and the baselines'
    flags a network without FPN."""
    if args.preset:
        return _apply_model_flags(preset(args.preset), args)
    model = _apply_model_flags(ModelConfig(), args)
    if args.feature_pyramid_network is None:
        model.feature_pyramid_network = model.feature_type == "aanet"
    return model


def build_config(args) -> Config:
    """Recipe or preset defaults, then every flag given on the command line
    (aanet_tpu/cli.py:170-203)."""
    if getattr(args, "recipe", None):
        cfg = recipe(args.recipe)
        cfg.model = _apply_model_flags(preset(args.preset) if args.preset else cfg.model, args)
    else:
        cfg = Config(model=model_config(args), data=DataConfig(), train=TrainConfig())
    for section, flags in ((cfg.data, _DATA_FLAGS), (cfg.train, _TRAIN_FLAGS)):
        for name in flags:
            if getattr(args, name, None) is not None:
                setattr(section, name, getattr(args, name))
    if getattr(args, "no_remat", False):
        cfg.model.remat = False
    for name in _TRAIN_SWITCHES:
        value = getattr(args, name, None)
        if value is None:
            continue
        if name == "load_pseudo_gt":
            cfg.data.load_pseudo_gt = value
        else:
            setattr(cfg.train, "strict_load" if name == "strict" else name, value)
    if isinstance(cfg.train.milestones, str):
        cfg.train.milestones = tuple(int(m) for m in cfg.train.milestones.split(","))
    return cfg


def _logger(log_file=None):
    """The training logger, writing also to ``log_file``; on every rank
    but 0, which alone writes, it logs warnings only."""
    from aanet_torch.train.trainer import get_logger

    if mesh.rank() == 0:
        return get_logger(log_file)
    logger = get_logger()
    logger.setLevel(logging.WARNING)
    return logger


def cmd_train(args):
    from aanet_torch.data.datasets import StereoDataset
    from aanet_torch.data.pipeline import make_train_loader, make_val_loader
    from aanet_torch.data.transforms import train_transform, val_transform
    from aanet_torch.train.trainer import Trainer

    cfg = build_config(args)
    mesh.maybe_init_distributed(args.device)
    logger = _logger(os.path.join(cfg.train.checkpoint_dir, "trainLog.txt"))
    if mesh.rank() == 0:
        os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
        with open(os.path.join(cfg.train.checkpoint_dir, "args.json"), "w") as f:
            f.write(cfg.to_json())
        with open(os.path.join(cfg.train.checkpoint_dir, "command_train.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")
    logger.info("config:\n" + cfg.to_json())

    d, t = cfg.data, cfg.train
    train_ds = StereoDataset(
        d.data_dir, d.dataset_name, mode="train_all" if d.mode == "train_all" else "train",
        split_preset=d.split_preset, filename_root=d.filename_root,
        load_pseudo_gt=d.load_pseudo_gt, save_filename=False,
        transform=train_transform(d.img_height, d.img_width, center_crop=d.split_preset == "overfit"),
    )
    val_ds = None
    if not t.no_validate:
        val_ds = StereoDataset(
            d.data_dir, d.dataset_name, mode="val", split_preset=d.split_preset,
            filename_root=d.filename_root, save_filename=False,
            transform=val_transform(d.val_img_height, d.val_img_width),
        )
    logger.info(f"{len(train_ds)} train / {len(val_ds) if val_ds else 0} val samples, "
                f"{mesh.world_size()} process(es)")

    global_batch = d.batch_size * max(1, t.accumulation_steps)
    mesh.local_batch_size(global_batch)  # the world size must divide the global batch
    trainer = Trainer(cfg, len(train_ds) // global_batch, logger=logger,
                      device=mesh.local_device(args.device))
    for epoch in range(trainer.epoch, t.max_epoch):
        means = trainer.train_epoch(
            make_train_loader(train_ds, global_batch, epoch, seed=t.seed, num_workers=d.num_workers)
        )
        logger.info(f"epoch {trainer.epoch} train means: {means}")
        if val_ds is not None:
            trainer.validate(make_val_loader(val_ds, d.val_batch_size, d.num_workers))
    logger.info("training done")
    mesh.stop_distributed()


def cmd_evaluate(args):
    """Validate the weights of ``--pretrained``, else of the run under
    ``--checkpoint_dir``, and print the metrics as one JSON line
    (aanet_tpu/cli.py:265-307)."""
    from aanet_torch.data.datasets import StereoDataset
    from aanet_torch.data.pipeline import make_val_loader
    from aanet_torch.data.transforms import val_transform
    from aanet_torch.infer import load_weights_into
    from aanet_torch.train.trainer import Trainer

    cfg = build_config(args)
    cfg.train.evaluate_only = True
    d, t = cfg.data, cfg.train
    weights = None
    if not t.pretrained:
        # aanet_best -> aanet_latest (reference model.py:267-277)
        found = [p for p in (os.path.join(t.checkpoint_dir, f"{name}.pt")
                             for name in ("aanet_best", "aanet_latest")) if os.path.exists(p)]
        if not found:
            raise FileNotFoundError(
                f"no aanet_best/aanet_latest checkpoint under {t.checkpoint_dir!r} "
                "and no --pretrained given"
            )
        weights = found[0]
    mesh.maybe_init_distributed(args.device)
    logger = _logger()
    val_ds = StereoDataset(
        d.data_dir, d.dataset_name, mode=d.mode, split_preset=d.split_preset,
        filename_root=d.filename_root, save_filename=False,
        transform=val_transform(d.val_img_height, d.val_img_width),
    )
    trainer = Trainer(cfg, steps_per_epoch=1, logger=logger, device=mesh.local_device(args.device))
    if weights:
        load_weights_into(trainer.model, weights, strict=True)
        logger.info(f"loaded {weights}")
    means = trainer.validate(make_val_loader(val_ds, d.val_batch_size, d.num_workers))
    if mesh.rank() == 0:
        print(json.dumps(means), flush=True)
    mesh.stop_distributed()


def cmd_inference(args):
    """Predict the test split and save the maps, or with ``--count_time``
    print the mean forward seconds per pair (aanet_tpu/cli.py:310-325)."""
    from aanet_torch.infer import run_inference

    cfg = build_config(args)
    out = args.output_dir or os.path.join(
        os.path.dirname(args.pretrained or "."), "inference_output"
    )
    mean_s = run_inference(
        cfg, out, save_type=args.save_type, visualize=args.visualize,
        count_time=args.count_time, num_images=args.num_images, device=args.device,
    )
    if mean_s is not None:
        print(json.dumps({"mean_inference_seconds": mean_s}), flush=True)


def cmd_predict(args):
    from aanet_torch.infer import predict_pairs

    cfg = model_config(args)
    predict_pairs(
        cfg, args.data_dir, output_dir=args.output_dir, save_type=args.save_type,
        visualize=args.visualize, pretrained=args.pretrained, device=args.device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="aanet_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    bool_flag = dict(action=argparse.BooleanOptionalAction, default=None)
    for name, fn, helptext in (
        ("train", cmd_train, "train the network on a filename-list dataset"),
        ("evaluate", cmd_evaluate, "validate a checkpoint on a filename-list dataset"),
    ):
        t = sub.add_parser(name, help=helptext)
        _add_model_args(t)
        t.add_argument("--recipe", default=None,
                       help="a training stage of config.RUN_RECIPES, e.g. aanet+_sceneflow")
        for flag, kind in {**_DATA_FLAGS, **_TRAIN_FLAGS}.items():
            t.add_argument(f"--{flag}", type=kind, default=None)
        for flag in _TRAIN_SWITCHES:
            t.add_argument(f"--{flag}", **bool_flag)
        t.add_argument("--no_remat", action="store_true",
                       help="keep every training activation (more memory, no recomputation)")
        _add_device(t)
        t.set_defaults(fn=fn)

    i = sub.add_parser("inference", help="predict the test split of a filename-list dataset")
    _add_model_args(i)
    for flag, kind in _DATA_FLAGS.items():
        i.add_argument(f"--{flag}", type=kind, default=None)
    i.add_argument("--pretrained", default=None,
                   help="torch state_dict, training checkpoint or flax .msgpack(.gz)")
    i.add_argument("--strict", **bool_flag)
    i.add_argument("--output_dir", default=None)
    i.add_argument("--save_type", default="png", choices=["png", "pfm", "npy"])
    i.add_argument("--visualize", action="store_true")
    i.add_argument("--count_time", action="store_true",
                   help="time the forward on the first batch and print the mean per pair")
    i.add_argument("--num_images", type=int, default=100)
    _add_device(i)
    i.set_defaults(fn=cmd_inference)

    p = sub.add_parser("predict", help="predict disparities of rectified pairs")
    _add_model_args(p)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--pretrained", default=None,
                   help="torch state_dict, training checkpoint or flax .msgpack(.gz)")
    p.add_argument("--save_type", default="png", choices=["png", "pfm", "npy"])
    p.add_argument("--visualize", action="store_true")
    _add_device(p)
    p.set_defaults(fn=cmd_predict)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args.fn(args)


if __name__ == "__main__":
    main()
