"""Prediction on rectified stereo pairs (aanet_tpu/infer.py:270-339).

``predict_pairs`` runs the model on ``{data_dir}/left/*.png`` with the
same names under ``right/``: each pair is normalised, zero-padded at the
top and right to a multiple of ``pad_multiple(cfg)`` (96 under hourglass
refinement, else 48), and the prediction is cropped back to the original
size.

Every entry point takes a ``device``, ``"cuda"`` by default. Without a GPU
it raises unless the caller asks for ``"cpu"``, which runs the plain
PyTorch versions of the kernels.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Optional

import numpy as np
import torch
from PIL import Image

from aanet_torch.config import ModelConfig
from aanet_torch.data.file_io import read_img, write_pfm
from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

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


def load_model(cfg: ModelConfig, pretrained: Optional[str] = None, device="cuda"):
    """Build ``cfg``'s model in eval mode on ``device``; load a state_dict
    file (as written by ``torch.save`` of ``convert.state_dict_from_flax``
    or of ``model.state_dict()``), or a training checkpoint (its ``model``
    entry), when ``pretrained`` is given."""
    dev = resolve_device(device)
    model = cfg.build()
    if pretrained:
        model.load_state_dict(load_weights(pretrained), strict=True)
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
