"""Sample-dict transforms (numpy / PIL; host-side), an own copy of
aanet_tpu/data/transforms.py (the port imports nothing of the JAX package).

The reference's exact augmentation set (`dataloader/transforms.py`):
  * RandomCrop — train: random x, random y; val: center crop. When the
    crop is larger than the image, zero-pad TOP and RIGHT (the KITTI
    padding convention, transforms.py:66-115).
  * RandomColor — with p=.5 a single random color op, else all five in
    random order (contrast, gamma, brightness, hue, saturation; applied
    identically to both views, transforms.py:245-269).
  * RandomVerticalFlip p=.5 (transforms.py:149).
  * ToArray — /255, float32 HWC (ToTensor analogue; we stay channels-last).
  * Normalize — ImageNet mean/std.

Randomness is explicit: every stochastic transform takes an
`np.random.Generator` so the pipeline is seedable per (epoch, sample).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image, ImageEnhance

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_IMG_KEYS = ("left", "right")
_DENSE_KEYS = ("left", "right", "disp", "pseudo_disp")


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class RandomCrop:
    def __init__(self, img_height: int, img_width: int, validate: bool = False):
        self.h = img_height
        self.w = img_width
        self.validate = validate

    def __call__(self, sample, rng):
        ori_h, ori_w = sample["left"].shape[:2]
        if self.h > ori_h or self.w > ori_w:
            top_pad = max(0, self.h - ori_h)
            right_pad = max(0, self.w - ori_w)
            for k in _DENSE_KEYS:
                if k not in sample:
                    continue
                arr = sample[k]
                pads = [(top_pad, 0), (0, right_pad)] + [(0, 0)] * (arr.ndim - 2)
                sample[k] = np.pad(arr, pads, mode="constant")
            return sample
        if self.validate:
            ox = (ori_w - self.w) // 2
            oy = (ori_h - self.h) // 2
        else:
            ox = int(rng.integers(0, ori_w - self.w + 1))
            oy = int(rng.integers(0, ori_h - self.h + 1))
        for k in _DENSE_KEYS:
            if k in sample:
                sample[k] = sample[k][oy : oy + self.h, ox : ox + self.w]
        return sample


class RandomVerticalFlip:
    def __call__(self, sample, rng):
        if rng.random() < 0.5:
            for k in _DENSE_KEYS:
                if k in sample:
                    sample[k] = np.ascontiguousarray(np.flipud(sample[k]))
        return sample


# -- color ops (uint8 PIL domain, like the reference's ToPILImage round-trip) --


def _adjust_gamma(img: Image.Image, gamma: float) -> Image.Image:
    lut = [min(255, int((i / 255.0) ** gamma * 255 + 0.5)) for i in range(256)]
    return img.point(lut * len(img.getbands()))


def _adjust_hue(img: Image.Image, hue: float) -> Image.Image:
    h, s, v = img.convert("HSV").split()
    h_arr = np.array(h, dtype=np.uint8)
    h_arr = (h_arr.astype(np.int16) + int(hue * 255)) % 256
    h = Image.fromarray(h_arr.astype(np.uint8), "L")
    return Image.merge("HSV", (h, s, v)).convert("RGB")


class RandomColor:
    """Photometric jitter applied identically to both views."""

    def __call__(self, sample, rng):
        ops = [
            ("contrast", lambda im, f: ImageEnhance.Contrast(im).enhance(f),
             lambda: rng.uniform(0.8, 1.2)),
            ("gamma", _adjust_gamma, lambda: rng.uniform(0.7, 1.5)),
            ("brightness", lambda im, f: ImageEnhance.Brightness(im).enhance(f),
             lambda: rng.uniform(0.5, 2.0)),
            ("hue", _adjust_hue, lambda: rng.uniform(-0.1, 0.1)),
            ("saturation", lambda im, f: ImageEnhance.Color(im).enhance(f),
             lambda: rng.uniform(0.8, 1.2)),
        ]
        imgs = {
            k: Image.fromarray(sample[k].astype(np.uint8)) for k in _IMG_KEYS
        }
        if rng.random() < 0.5:
            chosen = [ops[int(rng.integers(len(ops)))]]
        else:
            order = rng.permutation(len(ops))
            chosen = [ops[i] for i in order]
        for _name, fn, draw in chosen:
            if rng.random() < 0.5:
                factor = draw()
                imgs = {k: fn(im, factor) for k, im in imgs.items()}
        for k in _IMG_KEYS:
            sample[k] = np.array(imgs[k], dtype=np.float32)
        return sample


class ToArray:
    """images /255 -> float32 (channels-last already)."""

    def __call__(self, sample, rng):
        for k in _IMG_KEYS:
            sample[k] = np.asarray(sample[k], np.float32) / 255.0
        for k in ("disp", "pseudo_disp"):
            if k in sample:
                sample[k] = np.asarray(sample[k], np.float32)
        return sample


class Normalize:
    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample, rng):
        for k in _IMG_KEYS:
            sample[k] = (sample[k] - self.mean) / self.std
        return sample


def train_transform(img_height: int, img_width: int, center_crop: bool = False):
    """The reference's train pipeline (dataloader/dataloader.py:151-155);
    center_crop=True is the overfit-debug variant (py:157-159)."""
    if center_crop:
        return Compose([
            RandomCrop(img_height, img_width, validate=True),
            ToArray(),
            Normalize(),
        ])
    return Compose([
        RandomCrop(img_height, img_width),
        RandomColor(),
        RandomVerticalFlip(),
        ToArray(),
        Normalize(),
    ])


def val_transform(img_height: int, img_width: int):
    return Compose([
        RandomCrop(img_height, img_width, validate=True),
        ToArray(),
        Normalize(),
    ])


def test_transform():
    """Inference: ToArray and Normalize only, no crop (reference
    inference.py:97-100; aanet_tpu/data/transforms.py:177-179)."""
    return Compose([ToArray(), Normalize()])
