"""Backward warp of the right image by disparity (aanet_tpu/ops/warp.py).

A horizontal bilinear warp at ``x - disp`` with border padding, and the
validity mask of the reference (the zero-padded coverage of the sample,
>= 0.9999). The op is a ``torch.autograd.Function`` differentiable in the
disparity only, matching ``jax.grad`` of the JAX op (including jnp.clip's
half gradient where ``x - disp`` hits the border exactly); the mask
carries no gradient. The image is the network's input wherever the model
warps, so its gradient is not computed: an image that requires one is
refused. The CUDA kernels (forward and backward) are ``csrc/warp.cu``.

The forward also has a bfloat16 form (the JAX op under a bf16 compute
dtype, ``warp.py:30,60,66``): a bf16 image, a float32 disparity and
sample positions, the blend in float32, the warped image and the mask
in bf16 (``aanet_warp_bf16``); so has the backward: the bf16 warped
image's gradient and the bf16 image widened, the sum over channels in
float32, a float32 gradient for the disparity
(``aanet_warp_backward_bf16``).
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


def _sample(img, disp):
    """Position x = w - disp, its border-clamped left tap x0 and fraction t."""
    w = img.shape[3]
    x = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w) - disp
    xc = x.clamp(0.0, w - 1.0)
    x0 = xc.floor().clamp(0.0, w - 2.0)
    return x, xc - x0, x0.long().unsqueeze(1).expand(img.shape)


def disp_warp_plain(img: torch.Tensor, disp: torch.Tensor):
    """Plain PyTorch warp: img [B, C, H, W], disp [B, H, W] ->
    (warped [B, C, H, W], valid [B, 1, H, W]). For a bf16 image, the bf16
    form: the blend in float32 from a float32 disparity, the warped image
    and the mask rounded to bf16."""
    if img.dtype == torch.bfloat16:
        warped, valid = disp_warp_plain(img.float(), disp.float())
        return warped.to(img.dtype), valid.to(img.dtype)
    w = img.shape[3]
    x, t, idx = _sample(img, disp)
    t = t.unsqueeze(1)
    warped = img.gather(3, idx) * (1.0 - t) + img.gather(3, idx + 1) * t

    xf = x.floor()
    tf = x - xf
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cover = torch.where((xf >= 0) & (xf <= w - 1), 1.0 - tf, zero) + torch.where(
        (xf + 1 >= 0) & (xf + 1 <= w - 1), tf, zero
    )
    valid = (cover >= 0.9999).to(img.dtype).unsqueeze(1)
    return warped, valid


def disp_warp_backward_plain(grad, img, disp):
    """Plain PyTorch gradient for the disparity: -clip'(x) * sum_c g_c *
    (img[x0+1] - img[x0]), where clip' is 1 inside (0, W-1), 1/2 at either
    end and 0 outside. For a bf16 image, the bf16 form: the image and the
    gradient widened, the float32 disparity's gradient in float32."""
    if img.dtype == torch.bfloat16:
        return disp_warp_backward_plain(grad.float(), img.float(), disp)
    w = img.shape[3]
    x, _, idx = _sample(img, disp)
    slope = img.gather(3, idx + 1) - img.gather(3, idx)
    inside = ((x > 0) & (x < w - 1)).to(x.dtype)
    tie = ((x == 0) | (x == w - 1)).to(x.dtype)
    return -(inside + 0.5 * tie) * (grad * slope).sum(1)


def _check(img, disp):
    b, c, h, w = img.shape
    if disp.shape != (b, h, w):
        raise ValueError(f"disp_warp: disp {tuple(disp.shape)} does not match img {tuple(img.shape)}")
    if w < 2:
        raise ValueError("disp_warp: the image needs at least two columns")


def _forward(img, disp):
    if img.device.type == "cpu":
        return disp_warp_plain(img, disp)
    form = _build.form("disp_warp", img.dtype)
    _build.check_cuda("disp_warp", img=(img, img.dtype), disp=(disp, torch.float32))
    b, c, h, w = img.shape
    warped = torch.empty_like(img)
    valid = torch.empty((b, 1, h, w), dtype=img.dtype, device=img.device)
    _build.launch(
        "warp", f"aanet_warp_{form}", _ARGTYPES,
        _build.ptr(img), _build.ptr(disp), _build.ptr(warped), _build.ptr(valid),
        b, c, h, w, img.device.index, _build.stream(img),
    )
    _build.count_launch(disp_warp, form)
    return warped, valid


def disp_warp_backward(grad: torch.Tensor, img: torch.Tensor, disp: torch.Tensor):
    """Gradient for the float32 ``disp`` [B, H, W] given the warped image's
    gradient ``grad`` [B, C, H, W] (the image's dtype). A CPU tensor takes
    the plain version; a CUDA tensor launches ``aanet_warp_backward_f32``
    or, for a bf16 image, ``aanet_warp_backward_bf16``."""
    _check(img, disp)
    if img.device.type == "cpu":
        return disp_warp_backward_plain(grad, img, disp)
    form = _build.form("disp_warp backward", img.dtype)
    _build.check_cuda("disp_warp backward", grad=(grad, img.dtype), img=(img, img.dtype),
                      disp=(disp, torch.float32))
    if grad.shape != img.shape:
        raise ValueError(f"disp_warp backward: grad {tuple(grad.shape)}, expected {tuple(img.shape)}")
    b, c, h, w = img.shape
    grad_disp = torch.empty_like(disp)
    _build.launch(
        "warp", f"aanet_warp_backward_{form}", _ARGTYPES,
        _build.ptr(grad), _build.ptr(img), _build.ptr(disp), _build.ptr(grad_disp),
        b, c, h, w, img.device.index, _build.stream(img),
    )
    _build.count_launch(disp_warp_backward, form)
    return grad_disp


class _DispWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, disp):
        warped, valid = _forward(img, disp)
        ctx.mark_non_differentiable(valid)
        ctx.save_for_backward(img, disp)
        return warped, valid

    @staticmethod
    def backward(ctx, grad_warped, grad_valid):
        img, disp = ctx.saved_tensors
        return None, disp_warp_backward(grad_warped.contiguous(), img, disp)


def disp_warp(img: torch.Tensor, disp: torch.Tensor):
    """Warp ``img`` (the right view) to the left view by ``disp``.

    Args:
      img: [B, C, H, W], float32 or bfloat16; must not require a gradient.
      disp: [B, H, W] disparity in pixels, float32.
    Returns:
      (warped [B, C, H, W], valid [B, 1, H, W] in {0, 1}), both in the
      image's dtype; ``warped`` is differentiable in ``disp``.

    A CPU tensor takes the plain versions; a CUDA tensor launches the kernels.
    """
    _check(img, disp)
    if img.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "disp_warp: the gradient for the image is not computed; "
            "pass an image that does not require grad (detach it)"
        )
    return _DispWarp.apply(img, disp)


disp_warp.launches = 0
disp_warp.launches_bf16 = 0
disp_warp_backward.launches = 0
disp_warp_backward.launches_bf16 = 0
