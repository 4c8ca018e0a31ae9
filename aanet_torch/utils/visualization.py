"""Error maps, disparity colours, image panels and signed-error
histograms for the training summaries (own copy of
aanet_tpu/utils/visualization.py; reference utils/visualization.py):

* the 10-bin blue-to-red KITTI error colormap and ``disp_error_img``,
  whose dilation is a 3x3 (``2r + 1``) max filter in numpy: what
  ``cv2.dilate`` with a kernel of ones computes, without OpenCV;
* ``disp_to_color``, the KITTI devkit's disparity rainbow;
* ``make_summary_writer``: TensorBoard's ``SummaryWriter`` where the
  ``tensorboard`` package is installed, else ``FileSummaryWriter``, PNG
  panels and a JSONL of scalars and histograms;
* ``save_images`` and ``save_hist``, the trainer's panels and histograms.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

# 10 log-spaced error bins, blue (small) to red (large), as (lo, hi, R, G,
# B) with thresholds relative to 3 px / 5 % (reference visualization.py:9-27)
_ERROR_BINS = np.array(
    [
        [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
        [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
        [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
        [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
        [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
        [3 / 3.0, 6 / 3.0, 254, 224, 144],
        [6 / 3.0, 12 / 3.0, 253, 174, 97],
        [12 / 3.0, 24 / 3.0, 244, 109, 67],
        [24 / 3.0, 48 / 3.0, 215, 48, 39],
        [48 / 3.0, np.inf, 165, 0, 38],
    ],
    dtype=np.float64,
)


def gen_error_colormap() -> np.ndarray:
    """[10, 5] rows of (lo, hi, R, G, B)."""
    return _ERROR_BINS.copy()


def dilate(img: np.ndarray, radius: int = 1) -> np.ndarray:
    """Each value of an [H, W, C] image the largest of its (2r + 1)^2
    window, the window cut at the border: ``cv2.dilate`` with a square
    kernel of ones (its default border adds nothing to a maximum)."""
    h, w = img.shape[:2]
    padded = np.pad(img, [(radius, radius), (radius, radius)] + [(0, 0)] * (img.ndim - 2),
                    constant_values=-np.inf)
    out = np.full_like(img, -np.inf)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            np.maximum(out, padded[dy: dy + h, dx: dx + w], out=out)
    return out


def disp_error_img(d_est: np.ndarray, d_gt: np.ndarray, abs_thres: float = 3.0,
                   rel_thres: float = 0.05, dilate_radius: int = 1) -> np.ndarray:
    """KITTI error visualisation (reference visualization.py:30-65): [H, W]
    or [B, H, W] disparities to float32 RGB in [0, 1], [..., H, W, 3],
    coloured by min(error / ``abs_thres``, relative error / ``rel_thres``);
    invalid ground truth (<= 0) black; dilated by ``dilate_radius``."""
    d_est = np.asarray(d_est, np.float32)
    d_gt = np.asarray(d_gt, np.float32)
    mask = d_gt > 0
    error = np.abs(d_est - d_gt)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(mask, error / np.maximum(d_gt, 1e-8) / rel_thres, 0.0)
    err_norm = np.minimum(error / abs_thres, rel)

    img = np.zeros(d_gt.shape + (3,), np.float32)
    for lo, hi, r, g, b in _ERROR_BINS:
        sel = mask & (err_norm >= lo) & (err_norm < hi)
        img[sel] = (r / 255.0, g / 255.0, b / 255.0)
    if dilate_radius > 0:
        if img.ndim == 3:
            img = dilate(img, dilate_radius)
        else:
            img = np.stack([dilate(im, dilate_radius) for im in img])
    return img


# the KITTI devkit's cyclic disparity colormap: 8 anchor colours and the
# widths of the bands between them
_DISP_MAP = np.array(
    [
        [0, 0, 0, 114],
        [0, 0, 1, 185],
        [1, 0, 0, 114],
        [1, 0, 1, 174],
        [0, 1, 0, 114],
        [0, 1, 1, 185],
        [1, 1, 0, 114],
        [1, 1, 1, 0],
    ],
    dtype=np.float64,
)


def disp_to_color(disp: np.ndarray, max_disp: Optional[float] = None) -> np.ndarray:
    """Disparity to the KITTI devkit rainbow: [H, W] to float32 [H, W, 3]
    in [0, 1], scaled by ``max_disp`` (the map's largest value without)."""
    disp = np.asarray(disp, np.float64)
    if max_disp is None:
        max_disp = max(float(disp.max()), 1e-6)
    x = np.clip(disp / max_disp, 0.0, 1.0)
    cum = np.concatenate([[0.0], np.cumsum(_DISP_MAP[:-1, 3])])
    cum /= cum[-1]
    out = np.zeros(x.shape + (3,), np.float64)
    last = len(_DISP_MAP) - 2
    for i in range(last + 1):
        lo, hi = cum[i], cum[i + 1]
        sel = (x >= lo) & (x <= hi if i == last else x < hi)
        t = np.zeros_like(x)
        t[sel] = (x[sel] - lo) / max(hi - lo, 1e-12)
        c0, c1 = _DISP_MAP[i, :3], _DISP_MAP[i + 1, :3]
        for ch in range(3):
            out[..., ch][sel] = (1 - t[sel]) * c0[ch] + t[sel] * c1[ch]
    return out.astype(np.float32)


class FileSummaryWriter:
    """The summaries without TensorBoard: PNG panels and a JSONL of
    scalars and histograms under ``log_dir``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._scalars = os.path.join(log_dir, "scalars.jsonl")

    def _append(self, record: dict):
        with open(self._scalars, "a") as f:
            f.write(json.dumps(record) + "\n")

    def add_scalar(self, tag: str, value, global_step: int = 0):
        self._append({"tag": tag, "value": float(value), "step": int(global_step)})

    def add_image(self, tag: str, img: np.ndarray, global_step: int = 0):
        """``img``: [3, H, W] or [H, W, 3] floats in [0, 1]."""
        from PIL import Image

        img = np.asarray(img)
        if img.ndim == 3 and img.shape[0] in (1, 3):
            img = np.transpose(img, (1, 2, 0))
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_step{global_step:08d}.png")
        Image.fromarray(arr).save(path)

    def add_histogram(self, tag: str, values, global_step: int = 0, bins=None):
        hist, edges = np.histogram(np.asarray(values).ravel(),
                                   bins=bins if bins is not None else 64)
        self._append({"tag": tag + "/hist", "step": int(global_step), "counts": hist.tolist(),
                      "edges": np.round(edges, 5).tolist()})

    def flush(self):
        pass

    def close(self):
        pass


def make_summary_writer(log_dir: str):
    """TensorBoard's writer where ``tensorboard`` is installed, else
    ``FileSummaryWriter``."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return FileSummaryWriter(log_dir)
    return SummaryWriter(log_dir)


def _to_chw(img: np.ndarray) -> np.ndarray:
    """[H, W] (scaled by its largest value) or [H, W, C] (0..255 values
    scaled to 0..1) to [3, H, W] in [0, 1]."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        mx = max(float(img.max()), 1e-6)
        img = np.stack([img / mx] * 3, axis=0)
    elif img.ndim == 3 and img.shape[-1] in (1, 3):
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.max() > 1.5:
            img = img / 255.0
        img = np.transpose(img, (2, 0, 1))
    return np.clip(img, 0.0, 1.0)


def save_images(writer, mode_tag: str, images_dict: Dict[str, np.ndarray], epoch: int,
                max_items: int = 1):
    """Each image or disparity of ``images_dict`` as a panel
    ``<mode_tag>/<name>`` (the first ``max_items`` of a batch;
    reference visualization.py:68-83)."""
    for tag, value in images_dict.items():
        value = np.asarray(value)
        batched = value.ndim == 4 or (value.ndim == 3 and value.shape[-1] not in (1, 3))
        items = value[:max_items] if batched else [value]
        for i, item in enumerate(items):
            full_tag = f"{mode_tag}/{tag}" + (f"/{i}" if len(items) > 1 else "")
            writer.add_image(full_tag, _to_chw(item), epoch)


def disp_error_hist(d_est: np.ndarray, d_gt: np.ndarray,
                    mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The signed errors (estimate - ground truth) at the valid pixels
    (ground truth > 0 unless ``mask``; reference visualization.py:98-126)."""
    d_est = np.asarray(d_est, np.float32)
    d_gt = np.asarray(d_gt, np.float32)
    if mask is None:
        mask = d_gt > 0
    return (d_est - d_gt)[mask]


def save_hist(writer, mode_tag: str, d_est, d_gt, epoch: int, mask=None):
    """The signed errors' histogram as ``<mode_tag>/signed_error``."""
    errors = disp_error_hist(d_est, d_gt, mask)
    if errors.size:
        writer.add_histogram(f"{mode_tag}/signed_error", errors, epoch)
