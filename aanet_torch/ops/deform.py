"""(Modulated) deformable 2-D convolution (aanet_tpu/ops/deform.py).

DCNv2 with zero-padded bilinear sampling: for each output pixel, tap k and
deformable group g, the input is sampled at ``p*stride - pad + p_k*dil +
delta_p_k``, corners outside the image count as zero, the sample is scaled
by the mask ``m_k``, and the samples are contracted with the weight over
taps x input channels. At zero offsets and unit mask this is exactly a
dilated convolution.

Layouts follow the JAX package's channel orders in NCHW: x [B, Cin, H, W];
offset [B, G*K*2, Ho, Wo] in the (g, k, (dy, dx)) order; mask
[B, G*K, Ho, Wo] in the (g, k) order; weight [Cout, Cin, kh, kw] (OIHW).
The CUDA kernel is ``csrc/deform_conv.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aanet_torch import _build

MAX_GROUPS = 8  # deformable groups the kernel stages (csrc/deform_conv.cu)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
] + [ctypes.c_int] * 14 + [ctypes.c_void_p]


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def modulated_deform_conv2d_plain(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    deformable_groups: int = 1,
) -> torch.Tensor:
    """Plain PyTorch DCNv2: gathers the modulated im2col columns
    [B, Cin*K, Ho*Wo] and multiplies them by the weight."""
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    g = deformable_groups
    k2 = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    f32 = dict(dtype=torch.float32, device=x.device)

    off = offset.reshape(b, g, k2, 2, ho, wo).float()
    ky = (torch.arange(kh, **f32) * dilation).repeat_interleave(kw).view(1, 1, k2, 1, 1)
    kx = (torch.arange(kw, **f32) * dilation).repeat(kh).view(1, 1, k2, 1, 1)
    py = (torch.arange(ho, **f32) * stride - padding).view(1, 1, 1, ho, 1) + ky + off[:, :, :, 0]
    px = (torch.arange(wo, **f32) * stride - padding).view(1, 1, 1, 1, wo) + kx + off[:, :, :, 1]
    y0, x0 = py.floor(), px.floor()
    ly, lx = py - y0, px - x0
    m = None if mask is None else mask.reshape(b, g, k2, ho, wo).float()

    xg = x.reshape(b, g, cin // g, h * w)
    zero = torch.zeros((), **f32)
    cols = 0.0
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            wt = wy * wx if m is None else wy * wx * m
            wt = torch.where(inside, wt, zero).view(b, g, 1, -1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            idx = idx.view(b, g, 1, -1).expand(b, g, cin // g, -1)
            cols = cols + xg.gather(3, idx) * wt
    cols = cols.view(b, cin * k2, ho * wo)
    out = torch.matmul(weight.reshape(cout, cin * k2), cols).view(b, cout, ho, wo)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def modulated_deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    deformable_groups: int = 1,
) -> torch.Tensor:
    """Modulated deformable conv (DCNv2 semantics, zero-pad sampling).

    Args:
      x: [B, Cin, H, W].
      offset: [B, G*K*2, Ho, Wo], channel order (g, k, (dy, dx)).
      mask: [B, G*K, Ho, Wo] modulation, or None for a unit mask.
      weight: [Cout, Cin, kh, kw].
      bias: [Cout] or None.
    Returns:
      [B, Cout, Ho, Wo].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    ``offset`` and ``mask`` may be channel slices of a larger tensor: only
    each batch entry must be contiguous.
    """
    b, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    g = deformable_groups
    k2 = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    if wcin != cin or cin % g:
        raise ValueError(f"deform conv: weight {tuple(weight.shape)} and groups {g} do not fit x {tuple(x.shape)}")
    if offset.shape != (b, g * k2 * 2, ho, wo):
        raise ValueError(f"deform conv: offset {tuple(offset.shape)}, expected {(b, g * k2 * 2, ho, wo)}")
    if mask is not None and mask.shape != (b, g * k2, ho, wo):
        raise ValueError(f"deform conv: mask {tuple(mask.shape)}, expected {(b, g * k2, ho, wo)}")
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain(
            x, offset, mask, weight, bias, stride=stride, padding=padding,
            dilation=dilation, deformable_groups=g,
        )
    if g > MAX_GROUPS:
        raise ValueError(f"deform conv: the kernel takes at most {MAX_GROUPS} groups, got {g}")
    tensors = dict(x=x, weight=weight)
    if bias is not None:
        tensors["bias"] = bias
    _build.check_cuda_f32("deform conv", **tensors)
    # offset / mask: each batch entry contiguous (channel slices allowed)
    sliced = dict(offset=offset) if mask is None else dict(offset=offset, mask=mask)
    _build.check_cuda_f32("deform conv", **{k: v[0] for k, v in sliced.items()})
    out = torch.empty((b, cout, ho, wo), dtype=torch.float32, device=x.device)
    _build.launch(
        "deform_conv", "aanet_deform_conv_f32", _ARGTYPES,
        _build.ptr(x), _build.ptr(offset), offset.stride(0),
        _build.ptr(mask), 0 if mask is None else mask.stride(0),
        _build.ptr(weight), _build.ptr(bias), _build.ptr(out),
        b, cin, h, w, cout, ho, wo, kh, kw, stride, padding, dilation, g,
        x.device.index, _build.stream(x),
    )
    modulated_deform_conv2d.launches += 1
    return out


modulated_deform_conv2d.launches = 0

