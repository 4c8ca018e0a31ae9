"""Inference on a dataset's test split and prediction on rectified stereo
pairs (aanet_tpu/infer.py:163-339).

``run_inference`` runs the model over the test list of a filename-list
dataset: each batch is zero-padded at the top and right to the configured
``img_height`` x ``img_width``, a smaller prediction is upsampled, and the
result is cropped back and saved; with ``count_time`` it times the
forward instead. ``predict_pairs`` runs the model on
``{data_dir}/left/*.png`` with the same names under ``right/``: each pair
is normalised, zero-padded at the top and right to a multiple of
``pad_multiple(cfg)`` (96 under hourglass refinement, else 48), and the
prediction is cropped back to the original size.

Weights come from a torch file (a state_dict or a training checkpoint) or
from a flax msgpack checkpoint of the JAX package (``.msgpack`` or
``.msgpack.gz``, read by ``aanet_torch.utils.checkpoint``).

Every entry point takes a ``device``, ``"cuda"`` by default. Without a GPU
it raises unless the caller asks for ``"cpu"``, which runs the plain
PyTorch versions of the kernels.
"""
from __future__ import annotations

import glob
import logging
import os
import time
from typing import Optional

import numpy as np
import torch
from PIL import Image

from aanet_torch.config import Config, ModelConfig
from aanet_torch.data.datasets import StereoDataset
from aanet_torch.data.file_io import read_img, write_pfm
from aanet_torch.data.pipeline import make_val_loader
from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, test_transform
from aanet_torch.ops.resize import upsample_disparity
from aanet_torch.utils import checkpoint

logger = logging.getLogger("aanet_torch")


def pad_multiple(cfg: ModelConfig) -> int:
    """The multiple a pair is padded to: 96 under hourglass refinement, else
    48 (the reference's predict.py:148-151)."""
    return 96 if cfg.refinement_type == "hourglass" else 48


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def _pad_top_right(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad [B, H, W, C] (or [B, H, W]) to (h, w): TOP and RIGHT pads
    (reference inference.py:155-162)."""
    top = h - arr.shape[1]
    right = w - arr.shape[2]
    if top < 0 or right < 0:
        raise ValueError(f"cannot pad {arr.shape} down to {(h, w)}")
    pads = [(0, 0), (top, 0), (0, right)] + [(0, 0)] * (arr.ndim - 3)
    return np.pad(arr, pads)


def load_weights(path: str) -> dict:
    """The model state_dict of a torch file: a state_dict itself, or a
    training checkpoint (``aanet_torch.train.trainer``) holding it under
    ``model``."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state.get("model"), dict):
        state = state["model"]
    return state


def load_weights_into(model: torch.nn.Module, path: str, strict: bool = True) -> list[str]:
    """Load ``path`` into ``model``: a flax checkpoint (``.msgpack`` or
    ``.msgpack.gz``) through ``checkpoint.load_pretrained``, else a torch
    file (``load_weights``). Under ``strict`` every entry of the model must
    be in the file; otherwise what matches is loaded. Returns the entries
    of the model that were not loaded."""
    if path.endswith(checkpoint.FLAX_SUFFIXES):
        return checkpoint.load_pretrained(model, path, strict=strict)
    return model.load_state_dict(load_weights(path), strict=strict).missing_keys


def load_model(cfg: ModelConfig, pretrained: Optional[str] = None, device="cuda",
               strict: bool = True):
    """Build ``cfg``'s model in eval mode on ``device``; load a state_dict
    file (as written by ``torch.save`` of ``convert.state_dict_from_flax``
    or of ``model.state_dict()``), a training checkpoint (its ``model``
    entry) or a flax checkpoint when ``pretrained`` is given."""
    dev = resolve_device(device)
    model = cfg.build()
    if pretrained:
        load_weights_into(model, pretrained, strict=strict)
    return model.to(dev).eval()


def build_forward(model: torch.nn.Module, device="cuda"):
    """A function of NHWC float32 numpy batches (left, right) returning the
    final [B, H, W] disparity as numpy, run by ``model`` on ``device``."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    def forward(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            lt = torch.from_numpy(left).permute(0, 3, 1, 2).contiguous().to(dev)
            rt = torch.from_numpy(right).permute(0, 3, 1, 2).contiguous().to(dev)
            return model(lt, rt)[-1].cpu().numpy()

    return forward


def _save_disp(disp: np.ndarray, save_name: str, save_type: str, visualize: bool) -> str:
    """Save ``disp`` as ``save_type`` beside ``save_name``; return the path
    of the disparity file written."""
    os.makedirs(os.path.dirname(save_name) or ".", exist_ok=True)
    if save_type == "pfm":
        if visualize:
            Image.fromarray((disp * 256.0).astype(np.uint16)).save(save_name)
        path = save_name[:-3] + "pfm"
        write_pfm(path, disp.astype(np.float32))
    elif save_type == "npy":
        path = save_name[:-3] + "npy"
        np.save(path, disp)
    else:  # KITTI submission png: uint16 x256
        path = save_name
        Image.fromarray((disp * 256.0).astype(np.uint16)).save(path)
    return path


def predict_pairs(
    cfg: ModelConfig,
    data_dir: str,
    output_dir: Optional[str] = None,
    save_type: str = "png",
    visualize: bool = False,
    pretrained: Optional[str] = None,
    device="cuda",
) -> list[str]:
    """Predict every pair under ``data_dir`` and save one disparity map per
    pair into ``output_dir`` (default ``{data_dir}/pred``); returns the
    saved names."""
    forward = build_forward(load_model(cfg, pretrained, device), device)
    lefts = sorted(
        glob.glob(os.path.join(data_dir, "left", "*.png"))
        + glob.glob(os.path.join(data_dir, "left", "*.jpg"))
    )
    if not lefts:
        raise FileNotFoundError(f"no images under {data_dir}/left")
    output_dir = output_dir or os.path.join(data_dir, "pred")
    os.makedirs(output_dir, exist_ok=True)

    mean = np.asarray(IMAGENET_MEAN, np.float32)
    std = np.asarray(IMAGENET_STD, np.float32)
    factor = pad_multiple(cfg)
    saved = []
    for lp in lefts:
        rp = os.path.join(data_dir, "right", os.path.basename(lp))
        left = (read_img(lp) / 255.0 - mean) / std
        right = (read_img(rp) / 255.0 - mean) / std
        ori_h, ori_w = left.shape[:2]
        ph = -(-ori_h // factor) * factor
        pw = -(-ori_w // factor) * factor
        pred = forward(
            _pad_top_right(left[None].astype(np.float32), ph, pw),
            _pad_top_right(right[None].astype(np.float32), ph, pw),
        )[0]
        pred = pred[ph - ori_h:, :ori_w]
        name = _save_disp(
            pred, os.path.join(output_dir, os.path.basename(lp)), save_type, visualize
        )
        logger.info("saved %s", name)
        saved.append(name)
    return saved


def _time_forward(model: torch.nn.Module, left: torch.Tensor, right: torch.Tensor,
                 iters: int, warmup: int = 2) -> float:
    """Mean seconds of one forward of ``model`` on the batch (left, right)
    over ``iters`` forwards after ``warmup``: CUDA events around the
    forwards on the card, ``time.perf_counter`` on the CPU."""
    with torch.inference_mode():
        for _ in range(warmup):
            model(left, right)
        if left.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                model(left, right)
            return (time.perf_counter() - t0) / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            model(left, right)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def run_inference(cfg: Config, output_dir: str, save_type: str = "png", visualize: bool = False,
                  count_time: bool = False, num_images: int = 100, device="cuda",
                  logger=None) -> Optional[float]:
    """Run ``cfg``'s model (weights from ``cfg.train.pretrained``, loaded
    under ``cfg.train.strict_load``) over the test split of ``cfg.data``
    in batches of ``data.batch_size`` (a ragged last batch at its own size)
    and save each prediction under ``output_dir`` by its left image's list
    name (aanet_tpu/infer.py:175-267). A batch smaller than
    ``img_height`` x ``img_width`` is zero-padded at the top and right, and
    its prediction, upsampled where the model's is smaller, is cropped
    back. With ``count_time`` nothing is saved: the first batch's forward
    is timed over ``max(2, min(num_images, 8))`` runs after two warm-ups
    (``_time_forward``) and the mean seconds per pair is returned."""
    logger = logger or logging.getLogger("aanet_torch")
    d = cfg.data
    dev = resolve_device(device)
    model = load_model(cfg.model, cfg.train.pretrained, device, strict=cfg.train.strict_load)
    ds = StereoDataset(d.data_dir, d.dataset_name, mode="test", split_preset=d.split_preset,
                       filename_root=d.filename_root, transform=test_transform())
    logger.info(f"{len(ds)} samples found in the test set")

    num_imgs = 0
    for batch in make_val_loader(ds, d.batch_size, num_workers=d.num_workers, process_index=0,
                                 process_count=1):
        left, right = batch["left"], batch["right"]
        ori_h, ori_w = left.shape[1:3]
        top, pad_right = max(0, d.img_height - ori_h), max(0, d.img_width - ori_w)
        left = _pad_top_right(left, ori_h + top, ori_w + pad_right)
        right = _pad_top_right(right, ori_h + top, ori_w + pad_right)
        lt = torch.from_numpy(left).permute(0, 3, 1, 2).contiguous().to(dev)
        rt = torch.from_numpy(right).permute(0, 3, 1, 2).contiguous().to(dev)
        if count_time:
            iters = int(max(2, min(num_images, 8)))
            mean_s = _time_forward(model, lt, rt, iters) / lt.shape[0]
            logger.info(f"mean inference time per pair at {lt.shape[2]}x{lt.shape[3]} batch "
                        f"{lt.shape[0]}: {mean_s:.4f}s ({iters} forwards)")
            return mean_s
        with torch.inference_mode():
            pred = model(lt, rt)[-1]
            if pred.shape[2] < lt.shape[3]:
                pred = upsample_disparity(pred, tuple(lt.shape[2:]))
        pred = pred.cpu().numpy()[:, top:, : pred.shape[2] - pad_right]
        for b in range(pred.shape[0]):
            name = _save_disp(pred[b], os.path.join(output_dir, batch["left_name"][b]),
                              save_type, visualize)
            logger.info("saved %s", name)
        num_imgs += pred.shape[0]
    logger.info(f"saved predictions for {num_imgs} images")
    return None
