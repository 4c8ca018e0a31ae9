"""Backward warp of the right image by disparity (aanet_tpu/ops/warp.py).

A horizontal bilinear warp at ``x - disp`` with border padding, and the
validity mask of the reference (the zero-padded coverage of the sample,
>= 0.9999). The CUDA kernel is ``csrc/warp.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from aanet_torch import _build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def disp_warp_plain(img: torch.Tensor, disp: torch.Tensor):
    """Plain PyTorch warp: img [B, C, H, W], disp [B, H, W] ->
    (warped [B, C, H, W], valid [B, 1, H, W])."""
    b, c, h, w = img.shape
    x = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w) - disp
    xc = x.clamp(0.0, w - 1.0)
    x0 = xc.floor().clamp(0.0, w - 2.0)
    t = (xc - x0).unsqueeze(1)
    idx = x0.long().unsqueeze(1).expand(b, c, h, w)
    warped = img.gather(3, idx) * (1.0 - t) + img.gather(3, idx + 1) * t

    xf = x.floor()
    tf = x - xf
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cover = torch.where((xf >= 0) & (xf <= w - 1), 1.0 - tf, zero) + torch.where(
        (xf + 1 >= 0) & (xf + 1 <= w - 1), tf, zero
    )
    valid = (cover >= 0.9999).to(img.dtype).unsqueeze(1)
    return warped, valid


def disp_warp(img: torch.Tensor, disp: torch.Tensor):
    """Warp ``img`` (the right view) to the left view by ``disp``.

    Args:
      img: [B, C, H, W].
      disp: [B, H, W] disparity in pixels.
    Returns:
      (warped [B, C, H, W], valid [B, 1, H, W] in {0, 1}).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    b, c, h, w = img.shape
    if disp.shape != (b, h, w):
        raise ValueError(f"disp_warp: disp {tuple(disp.shape)} does not match img {tuple(img.shape)}")
    if w < 2:
        raise ValueError("disp_warp: the image needs at least two columns")
    if img.device.type == "cpu":
        return disp_warp_plain(img, disp)
    _build.check_cuda_f32("disp_warp", img=img, disp=disp)
    warped = torch.empty_like(img)
    valid = torch.empty((b, 1, h, w), dtype=torch.float32, device=img.device)
    _build.launch(
        "warp", "aanet_warp_f32", _ARGTYPES,
        _build.ptr(img), _build.ptr(disp), _build.ptr(warped), _build.ptr(valid),
        b, c, h, w, img.device.index, _build.stream(img),
    )
    disp_warp.launches += 1
    return warped, valid


disp_warp.launches = 0
