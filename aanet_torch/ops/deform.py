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

The op is a ``torch.autograd.Function`` whose gradients for x, offset,
mask, weight and bias match ``jax.grad`` of the JAX op. That includes one
quirk of the JAX formulation: the fractional part of a sample position is
``jnp.clip``-ed to [0, 1], and ``jax.grad`` of a clip at an exact tie is
one half, so at an integer sample position (every position, at zero
offsets) the offset gradient is half the one-sided derivative. The CUDA
kernels are ``csrc/deform_conv.cu``: the forward, the input/offset/mask
gradient and the weight gradient. The forward's tiling is chosen here per
conv, batch, output size and SM count (``forward_plan``), with its weight
laid out [tap, cin, cout] (``weight_taps_cin_major``, zero channels up to
whole channel tiles); the input/offset/
mask gradient's per shape (``backward_data_plan``), with its weight laid
out tap-major (``weight_taps_major``); the weight gradient's per conv,
batch, output size and SM count (``backward_weight_plan``), with a
workspace of one slab per split that the kernel sums in a fixed order.
Every kernel returns the same bits from launch to launch: the forward's
split plans and the weight gradient sum float32 slabs in a fixed order,
and the input gradient's scatter adds 64-bit fixed-point integers
(``aanet_deform_conv_backward_data_f32``: a scale chosen on the device
from the largest term any element can receive, then one conversion; its
scratch is ``backward_data_scratch``).

Each kernel also has a bfloat16 form (the JAX op under a bf16 compute
dtype, ``deform.py:146-162,203,220-225``, and the gradients ``jax.vjp``
derives for it): x, the mask and the weight in bf16, the offsets and
the bias float32; the samples, their blend and the scatter in float32 (the
scatter's sum in fixed point), each output rounded once to its primal's
dtype (the output, the x, mask and weight gradients to bf16, the offsets'
gradient kept float32). The bf16 forms are kernels of their own whose
products run on the tensor cores (``mma.sync`` bf16 x bf16, float32 sums),
with their own plans: the forward (``aanet_deform_conv_bf16``,
``forward_plan_bf16``) and the input/offset/mask gradient
(``aanet_deform_conv_backward_data_bf16``, ``backward_data_plan_bf16``) with
the weight laid out in the MMA fragments' order (``weight_fwd_fragments``,
``weight_bwd_fragments``), and the weight gradient
(``aanet_deform_conv_backward_weight_bf16``, ``backward_weight_plan_bf16``)
with gout as the A operand. The forward and the weight gradient multiply by
the sampled column split exactly into three bf16 planes
(``split_planes``). Only the order of float32 sums differs from the twins'.
The JAX op also rounds each blended, modulated sample to bf16 before the
contraction; neither the kernels nor the twins do.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from aanet_torch import _build
from aanet_torch._build import SM_SMEM_BYTES, SMEM_BYTES

MAX_BLOCKS = 3  # blocks per SM the backward-data kernel's registers are budgeted for (2 or 3)
HALO = 3  # pixels of a staged window beyond the zero-offset footprint (both kernels)
TILE_W = 16  # output columns of a tile (both kernels)
TILINGS = ((8, 4), (8, 8), (16, 4))  # the backward-data kernel's builds: (channels, rows)
FWD_CHUNK = 4  # input channels of a forward chunk (FWD_CHUNK in the kernel)
FWD_TILE_H = (16, 8, 4, 2)  # forward tile heights the plan considers
# The forward kernel's __launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS): its
# largest block, and the blocks of that size an SM must hold, which cap a
# thread's registers
FWD_MAX_THREADS = 256
FWD_MIN_BLOCKS = 2
FWD_REGISTERS = 65536 // (FWD_MIN_BLOCKS * FWD_MAX_THREADS)  # of an SM's 64K
SM_THREADS = 2048  # resident threads of one SM
# The weight-gradient kernel's largest block, its builds: for 1 and for 2
# such blocks an SM (__launch_bounds__(WG_MAX_THREADS, blocks)), whose
# registers a thread may take 65536 / (blocks * WG_MAX_THREADS) of, and its
# register tile: WG_TM output channels by all taps (at most WG_MAX_TAPS) of
# one input channel
WG_MAX_THREADS = 256
WG_BUILDS = (1, 2)
WG_TM = 8
WG_MAX_TAPS = 9
WG_PAD = 4  # words after each row of its gout and column tiles
WG_TILE_H = (16, 8, 4, 2)  # weight-gradient tile (window) heights the plan considers
WG_STEP_H = (8, 4, 2)  # and step heights (the kernel's builds)
WG_CHUNKS = tuple(range(4, 65, 4))  # input channels of a block it considers
WG_WARPS = 8  # resident warps an SM needs, beyond which the plan looks at other things
WG_WAVES = 1  # waves of resident blocks the plan's splits fill
# The bf16 kernels on the tensor cores (MMA_* in the kernel): the forward's
# tile rows, block and chunk of input channels, its builds (output-channel
# tile -> blocks an SM its registers are budgeted for); the input/offset/
# mask gradient's chunk and its builds (tile rows -> blocks an SM)
MMA_FWD_TH = 4
MMA_FWD_THREADS = 256
MMA_FWD_CHUNK = 16
MMA_FWD_BUILDS = {16: 2, 32: 2, 64: 2, 128: 1}
MMA_BD_CHUNK = 8
MMA_BD_BUILDS = {8: (2, 3), 4: (4, 6)}
MMA_BD_WARPS = 24  # resident warps an SM needs, beyond which the plan looks at other things
# The bf16 weight gradient on the tensor cores (MMA_WG_* in the kernel): a
# warp a tap, a chunk of input channels (one n-tile of a tap), a step's
# output rows, the bf16 values of a row of its gout tile and the floats of
# a row of its column tiles; its builds (output-channel tile -> blocks an
# SM its registers are budgeted for) and the tile heights its plan considers
MMA_WG_WARPS = 9
MMA_WG_CHUNK = 8
MMA_WG_STEP_H = 4
MMA_WG_RS = 72
MMA_WG_CS = 72
MMA_WG_BUILDS = {16: 2, 32: 2, 64: 2, 128: 1}
MMA_WG_TILE_H = (16, 8, 4)

# x, offset, its batch stride, mask, its batch stride, wt, bias, out, the
# split plans' slabs; batch .. groups (13), the plan's five and wt_stride,
# device; stream
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
] + [ctypes.c_int] * 20 + [ctypes.c_void_p]
# gout, x, offset, its batch stride, mask, its batch stride, wt; the fixed
# point's bound, scratch and flags; grad_x, the offset slabs, grad_offset,
# the mask slabs, grad_mask; batch .. groups (13), chunk, tile_h, blocks,
# smem, device; stream
_BWD_DATA_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
# the bf16 forward: x .. the slabs as _ARGTYPES; batch .. groups (13),
# co_tile, splits, smem, device; stream
_FWD_BF16_ARGTYPES = _ARGTYPES[:9] + [ctypes.c_int] * 17 + [ctypes.c_void_p]
_BWD_WEIGHT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
] + [ctypes.c_int] * 22 + [ctypes.c_void_p]  # batch .. groups, the plan's eight, device, stream
# the bf16 weight gradient: gout .. grad_w as _BWD_WEIGHT_ARGTYPES; batch ..
# groups (13), tile_h, co_tile, splits, blocks, smem, device; stream
_BWD_WEIGHT_BF16_ARGTYPES = _BWD_WEIGHT_ARGTYPES[:8] + [ctypes.c_int] * 19 + [ctypes.c_void_p]


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def _sampling(x, offset, mask, kh, kw, stride, padding, dilation, g):
    """Bilinear sampling of every (batch, group, tap, output pixel): the
    four corners' flat indices, in-image flags and weights, and the
    derivatives of the weights by the sample position, with jnp.clip's
    half gradient at an integer position."""
    b, cin, h, w = x.shape
    k2 = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    f = dict(dtype=torch.promote_types(x.dtype, torch.float32), device=x.device)
    off = offset.reshape(b, g, k2, 2, ho, wo).to(f["dtype"])
    ky = (torch.arange(kh, **f) * dilation).repeat_interleave(kw).view(1, 1, k2, 1, 1)
    kx = (torch.arange(kw, **f) * dilation).repeat(kh).view(1, 1, k2, 1, 1)
    py = (torch.arange(ho, **f) * stride - padding).view(1, 1, 1, ho, 1) + ky + off[:, :, :, 0]
    px = (torch.arange(wo, **f) * stride - padding).view(1, 1, 1, 1, wo) + kx + off[:, :, :, 1]
    y0, x0 = py.floor(), px.floor()
    ly, lx = py - y0, px - x0
    sy = torch.where(ly == 0, 0.5, 1.0).to(f["dtype"])
    sx = torch.where(lx == 0, 0.5, 1.0).to(f["dtype"])
    m = None if mask is None else mask.reshape(b, g, k2, ho, wo).to(f["dtype"])
    corners = []
    for cy, wy, dwy in ((0, 1.0 - ly, -sy), (1, ly, sy)):
        for cx, wx, dwx in ((0, 1.0 - lx, -sx), (1, lx, sx)):
            yy, xx = y0 + cy, x0 + cx
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            # weight, d weight / d py, d weight / d px
            corners.append((idx, inside, wy * wx, dwy * wx, wy * dwx))
    return corners, m, (ho, wo)


def _gather(xg, idx, inside):
    """x at the corner indices [b, g, cg, k2*ho*wo], zero outside."""
    b, g, cg, _ = xg.shape
    flat = idx.reshape(b, g, 1, -1)
    vals = xg.gather(3, flat.expand(b, g, cg, flat.shape[-1]))
    return vals * inside.reshape(b, g, 1, -1).to(vals.dtype)


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
    [B, Cin*K, Ho*Wo] and multiplies them by the weight. For a bf16 x, the
    bf16 form: the mask and the weight rounded to bf16, everything taken
    to float32 and computed as here, the output rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        mask, weight = _bf16_operands(x, mask, weight)
        out = modulated_deform_conv2d_plain(
            x.float(), offset.float(), None if mask is None else mask.float(), weight.float(),
            None if bias is None else bias.float(), stride=stride, padding=padding,
            dilation=dilation, deformable_groups=deformable_groups,
        )
        return out.to(x.dtype)
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    g = deformable_groups
    corners, m, (ho, wo) = _sampling(x, offset, mask, kh, kw, stride, padding, dilation, g)
    xg = x.reshape(b, g, cin // g, h * w)
    cols = 0.0
    for idx, inside, wt, _, _ in corners:
        if m is not None:
            wt = wt * m
        cols = cols + _gather(xg, idx, inside) * wt.reshape(b, g, 1, -1)
    cols = cols.view(b, cin * kh * kw, ho * wo)
    out = torch.matmul(weight.reshape(cout, cin * kh * kw), cols).view(b, cout, ho, wo)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def _bf16_operands(x, mask, weight):
    """The mask and the weight in bf16 x's dtype, as the JAX op casts them
    to its values' dtype (``deform.py:153,197``)."""
    return None if mask is None else mask.to(x.dtype), weight.to(x.dtype)


def _widened(*tensors):
    """The tensors taken to float32 (None stays None)."""
    return tuple(None if t is None else t.float() for t in tensors)


def _column_grad(gout, weight, g):
    """W^T . gout: the gradient of the modulated columns,
    [b, g, cg, k2*ho*wo]."""
    b, cout, ho, wo = gout.shape
    _, cin, kh, kw = weight.shape
    gcol = torch.matmul(weight.reshape(cout, cin * kh * kw).t(), gout.reshape(b, cout, ho * wo))
    return gcol.view(b, g, cin // g, kh * kw * ho * wo)


def modulated_deform_conv2d_backward_data_plain(
    gout, x, offset, mask, weight, *, stride=1, padding=0, dilation=1, deformable_groups=1
):
    """Plain PyTorch gradients of the deformable conv for x, offset and mask
    (None for a unit mask), by the explicit formula: the column gradient
    W^T.gout scattered to the four corners for x; for the offset, the
    column gradient times the mask times the derivative of the bilinear
    sample by its position, summed over the group's channels; for the
    mask, the column gradient times the sample. For a bf16 x, the bf16
    form: every value taken to float32 and computed as here, the x and mask
    gradients rounded to bf16 once (the offsets' stays float32)."""
    if x.dtype == torch.bfloat16:
        grad_x, grad_off, grad_mask = modulated_deform_conv2d_backward_data_plain(
            *_widened(gout, x, offset, mask, weight), stride=stride, padding=padding,
            dilation=dilation, deformable_groups=deformable_groups,
        )
        return grad_x.to(x.dtype), grad_off, None if mask is None else grad_mask.to(mask.dtype)
    b, cin, h, w = x.shape
    _, _, kh, kw = weight.shape
    g = deformable_groups
    k2 = kh * kw
    corners, m, (ho, wo) = _sampling(x, offset, mask, kh, kw, stride, padding, dilation, g)
    gcol = _column_grad(gout, weight, g)
    xg = x.reshape(b, g, cin // g, h * w)
    mm = 1.0 if m is None else m.reshape(b, g, 1, -1)
    gmod = gcol * mm
    grad_x = torch.zeros_like(xg)
    sample = dpy = dpx = 0.0
    for idx, inside, wt, dwy, dwx in corners:
        vals = _gather(xg, idx, inside)
        flat = idx.reshape(b, g, 1, -1).expand_as(gcol)
        grad_x.scatter_add_(3, flat, gmod * (wt * inside).reshape(b, g, 1, -1).to(gcol.dtype))
        sample = sample + vals * wt.reshape(b, g, 1, -1)
        dpy = dpy + vals * dwy.reshape(b, g, 1, -1)
        dpx = dpx + vals * dwx.reshape(b, g, 1, -1)
    grad_off = torch.stack([(gmod * dpy).sum(2), (gmod * dpx).sum(2)], 2)  # [b, g, 2, k2*P]
    grad_off = grad_off.view(b, g, 2, k2, ho, wo).transpose(2, 3).reshape(b, g * k2 * 2, ho, wo)
    grad_mask = None
    if mask is not None:
        grad_mask = (gcol * sample).sum(2).view(b, g * k2, ho, wo)
    return grad_x.view(b, cin, h, w), grad_off.to(offset.dtype), grad_mask


def modulated_deform_conv2d_backward_weight_plain(
    gout, x, offset, mask, weight, *, stride=1, padding=0, dilation=1, deformable_groups=1
):
    """Plain PyTorch weight gradient: gout . cols^T summed over the batch,
    with the modulated columns gathered as in the forward. For a bf16 x,
    the bf16 form: computed in float32, rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return modulated_deform_conv2d_backward_weight_plain(
            *_widened(gout, x, offset, mask, weight), stride=stride, padding=padding,
            dilation=dilation, deformable_groups=deformable_groups,
        ).to(weight.dtype)
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    g = deformable_groups
    corners, m, (ho, wo) = _sampling(x, offset, mask, kh, kw, stride, padding, dilation, g)
    xg = x.reshape(b, g, cin // g, h * w)
    cols = 0.0
    for idx, inside, wt, _, _ in corners:
        if m is not None:
            wt = wt * m
        cols = cols + _gather(xg, idx, inside) * wt.reshape(b, g, 1, -1)
    cols = cols.view(b, cin * kh * kw, ho * wo)
    gw = torch.matmul(gout.reshape(b, cout, ho * wo), cols.transpose(1, 2)).sum(0)
    return gw.view(cout, cin, kh, kw)


class BackwardDataPlan(NamedTuple):
    """How ``aanet_deform_conv_backward_data_f32`` cuts one conv: blocks of
    ``chunk`` input channels of one group (``chunks`` per group) by a tile
    of ``tile_h`` x ``TILE_W`` output pixels, each staging an input window of
    ``win_h`` x ``win_w`` (the zero-offset footprint of the tile's taps plus
    ``HALO`` pixels and the bilinear corner) in ``smem_bytes`` of shared
    memory, built for ``blocks`` blocks per SM (its registers: 128 or 80 a
    thread for 2 or 3)."""

    chunk: int
    chunks: int
    tile_h: int
    blocks: int
    win_h: int
    win_w: int
    smem_bytes: int


def _ceil_div(a, b):
    return -(-a // b)


def _bwd_data_smem(cout, chunk, tile_h, win_h, win_w):
    """Bytes of the kernel's shared memory: the gout tile, two taps'
    weights, the x window and the grad_x window's two 32-bit fixed-point
    words an element (each channel's window padded to an odd number of
    words) and the offset and mask sums of two taps and two halves of the
    block. The kernel refuses a plan whose ``smem_bytes`` differ."""
    pixels = tile_h * TILE_W
    win_stride = win_h * win_w | 1
    return 4 * (cout * pixels + 2 * cout * chunk + 3 * chunk * win_stride + 12 * pixels)


@functools.lru_cache(maxsize=None)
def backward_data_plan(cin: int, cout: int, kh: int, kw: int, stride: int, dilation: int,
                       groups: int) -> BackwardDataPlan:
    """The backward-data kernel's tiling for a conv of these channels and
    geometry (it does not depend on the batch or the image size).

    Among the kernel's ``TILINGS`` that fit ``SMEM_BYTES``: the fewest idle
    channels (16, 32, 48, 64 and 128 channels in 2 groups leave none),
    then the most blocks per SM that the shared memory lets in, up to
    ``MAX_BLOCKS`` (more warps hide more of the scatter's latency), then
    the larger chunk (the gout tile serves more channels), then the taller
    tile (less halo per pixel). The kernel's registers are budgeted for
    that many blocks (``blocks``), and for two where only one fits. On an
    H100 this picked the fastest tiling at every train-step shape. Raises
    if nothing fits."""
    if cin % groups:
        raise ValueError(f"deform conv backward: {groups} groups do not divide {cin} channels")
    cg = cin // groups
    best = None
    for chunk, tile_h in TILINGS:
        chunks = _ceil_div(cg, chunk)
        win_h = (tile_h - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
        win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
        smem = _bwd_data_smem(cout, chunk, tile_h, win_h, win_w)
        if smem > SMEM_BYTES:
            continue
        resident = min(MAX_BLOCKS, SM_SMEM_BYTES // (smem + 1024))
        key = (chunk * chunks - cg, -resident, -chunk, -tile_h)
        plan = BackwardDataPlan(chunk, chunks, tile_h, max(2, resident), win_h, win_w, smem)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(
            f"deform conv backward: no tiling of {cin} -> {cout} channels (stride {stride}, "
            f"dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared memory")
    return best[1]


def _raw_geometry(win_h, win_w, padding, unit):
    """The raw bf16 x window of the tensor-core kernels (``raw_row`` and
    ``raw_channel`` in the kernel): the offset of the window's first
    column past the multiple of 8 its row starts at, the row's values (whole
    16-byte pieces) and a channel's values (an odd multiple of ``unit``)."""
    xoff = (-padding - HALO) % 8
    win_wa = _ceil_div(xoff + win_w, 8) * 8
    n = _ceil_div(win_h * win_wa, unit)
    return xoff, win_wa, (n + 1 - n % 2) * unit


def _fixed_channel(win_h, win_w):
    """The fixed-point window's words a channel (``fixed_channel``): at
    least win_h x win_w, 4 modulo 16."""
    n = win_h * win_w
    return n + (4 - n) % 16


def _bwd_data_mma_smem(cout, tile_h, win_h, win_w, padding):
    """Bytes of the tensor-core input/offset/mask gradient's shared memory
    (``bwd_data_mma_smem_bytes``): the raw bf16 gout tile [cout rounded up
    to 16][tile pixels], the raw bf16 x window of the chunk and its
    fixed-point grad_x window (two 32-bit words an element). The kernel
    refuses a plan whose ``smem_bytes`` differ."""
    _, _, xcs = _raw_geometry(win_h, win_w, padding, 8)
    ws = _fixed_channel(win_h, win_w)
    return (2 * _ceil_div(cout, 16) * 16 * tile_h * TILE_W + 2 * MMA_BD_CHUNK * xcs
            + 8 * MMA_BD_CHUNK * ws)


@functools.lru_cache(maxsize=None)
def backward_data_plan_bf16(cin: int, cout: int, kh: int, kw: int, stride: int, padding: int,
                            dilation: int, groups: int) -> BackwardDataPlan:
    """The tiling of ``aanet_deform_conv_backward_data_bf16`` (the
    tensor-core kernel) for a conv of these channels and geometry: chunks
    of ``MMA_BD_CHUNK`` input channels (a group's last may be short), a
    tile of 8 or 4 rows (a warp a row), built for ``blocks`` blocks an SM
    (``MMA_BD_BUILDS``: the largest build whose blocks fit the SM's shared
    memory, else the smallest). The plan takes the most resident warps up
    to ``MMA_BD_WARPS``, then the taller tile. Raises if nothing fits."""
    if cin % groups:
        raise ValueError(f"deform conv backward: {groups} groups do not divide {cin} channels")
    chunks = _ceil_div(cin // groups, MMA_BD_CHUNK)
    best = None
    for tile_h, builds in MMA_BD_BUILDS.items():
        win_h = (tile_h - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
        win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
        smem = _bwd_data_mma_smem(cout, tile_h, win_h, win_w, padding)
        if smem > SMEM_BYTES:
            continue
        fit = SM_SMEM_BYTES // (smem + 1024)
        build = max([b for b in builds if b <= fit] or [min(builds)])
        warps = min(build, fit) * tile_h
        key = (-min(warps, MMA_BD_WARPS), -tile_h)
        plan = BackwardDataPlan(MMA_BD_CHUNK, chunks, tile_h, build, win_h, win_w, smem)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError(
            f"deform conv backward: no bf16 tiling of {cin} -> {cout} channels (stride {stride}, "
            f"dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared memory")
    return best[1]


def weight_bwd_fragments(weight: torch.Tensor, groups: int) -> torch.Tensor:
    """The weight [cout, cin, kh, kw] as ``aanet_deform_conv_backward_data_bf16``
    reads it: the B operand of ``mma.sync.m16n8k16`` (16 output channels by
    8 input channels) of each tap, group, chunk of ``MMA_BD_CHUNK`` of the
    group's channels and step of 16 output channels, in register order:
    [taps, groups, chunks, ceil(cout / 16), 8 (g), 4 (t), 4] bf16, lane 4 g
    + t holding ``weight[co, c]`` for c = the chunk's channel g and co = 16
    step + 2 t + (0, 1, 8, 9). Zeros beyond cout and beyond each group's
    channels."""
    cout, cin, kh, kw = weight.shape
    cg = cin // groups
    chunks = _ceil_div(cg, MMA_BD_CHUNK)
    steps = _ceil_div(cout, 16)
    w = weight.to(torch.bfloat16).reshape(cout, groups, cg, kh * kw)
    w = torch.nn.functional.pad(w, (0, 0, 0, chunks * MMA_BD_CHUNK - cg, 0, 0, 0, steps * 16 - cout))
    # co = 16 step + 8 vh + 2 t + vl; c = 8 chunk + g
    w = w.reshape(steps, 2, 4, 2, groups, chunks, 8, kh * kw)
    return w.permute(7, 4, 5, 0, 6, 2, 1, 3).contiguous()


def split_planes(col: torch.Tensor):
    """The forward kernel's exact split of a float32 value into three bf16
    planes (``split_planes`` in the kernel): hi, the value truncated to
    bf16; mid, the rest times 2^8 truncated to bf16; lo, what remains
    times 2^16, which fits bf16 exactly. col = hi + 2^-8 mid + 2^-16 lo
    exactly for every finite value (the scaling keeps mid and lo above
    bf16's least subnormal); a non-finite value is hi, mid and lo zero.
    Each plane times a bf16 weight is exact in float32, so the kernel's
    three products of each plane, added in float32, change only the order
    of the sum. Returns the three planes as bf16 tensors."""
    col = col.float()
    top = torch.tensor(-65536, dtype=torch.int32)  # 0xffff0000: the bf16 bits of a float32
    h = (col.view(torch.int32) & top).view(torch.float32)
    r1 = (col - h) * 256.0
    m = (r1.view(torch.int32) & top).view(torch.float32)
    r2 = (r1 - m) * 256.0
    finite = torch.isfinite(col)
    zero = torch.zeros_like(col)
    hi = torch.where(finite, h, col).to(torch.bfloat16)
    return (hi, torch.where(finite, m, zero).to(torch.bfloat16),
            torch.where(finite, r2, zero).to(torch.bfloat16))


def _fwd_mma_smem(kh, kw, win_h, win_w, padding):
    """Bytes of the tensor-core forward's shared memory
    (``fwd_mma_smem_bytes``): the warps' (tap, pixel) quad tables, a float4
    each; two raw bf16 x windows of a chunk; each warp's three plane tiles
    [8 pixels][16 channels]. The kernel refuses a plan whose
    ``smem_bytes`` differ."""
    _, _, xcs = _raw_geometry(win_h, win_w, padding, 16)
    pixels = MMA_FWD_TH * TILE_W
    return (16 * kh * kw * pixels + 2 * 2 * MMA_FWD_CHUNK * xcs
            + 2 * (MMA_FWD_THREADS // 32) * 3 * 8 * MMA_FWD_CHUNK)


class ForwardPlanBf16(NamedTuple):
    """How ``aanet_deform_conv_bf16`` (the tensor-core forward) cuts one
    conv: blocks of ``MMA_FWD_TH`` x ``TILE_W`` output pixels by
    ``co_tile`` output channels, each walking chunks of ``MMA_FWD_CHUNK``
    input channels (``splits`` blocks share a tile's chunks, each storing
    a float32 slab that a second kernel adds in a fixed order), built for
    ``build`` blocks an SM (its registers: the kernel's build for
    ``co_tile``, ``MMA_FWD_BUILDS``), staging a window of ``win_h``
    x ``win_w`` a channel in ``smem_bytes`` of shared memory; ``resident``
    blocks fit one SM and the grid holds ``blocks``."""

    co_tile: int
    splits: int
    build: int
    win_h: int
    win_w: int
    smem_bytes: int
    resident: int
    blocks: int


@functools.lru_cache(maxsize=None)
def forward_plan_bf16(batch: int, cin: int, cout: int, out_h: int, out_w: int, kh: int, kw: int,
                      stride: int, padding: int, dilation: int, groups: int,
                      sms: int) -> ForwardPlanBf16:
    """The tensor-core forward's tiling for a conv of these shapes on a card
    of ``sms`` SMs.

    - The channel tile: the least of ``MMA_FWD_BUILDS``' tiles that holds
      ``cout``, up to 128 (every sampled column serves all of them; the
      weight's fragments are zero beyond cout), else tiles of 128.
    - ``resident``: the blocks one SM holds by shared memory and the tile's
      build (its registers: 128 output channels take one block of 255
      registers a thread).
    - ``splits``: as ``forward_plan``'s, 1 or a multiple of ``groups`` that
      divides the chunks, the fewest that give two waves of resident
      blocks, each block keeping at least min(8, chunks / 2) chunks.
    Raises if nothing fits."""
    if cin % groups:
        raise ValueError(f"deform conv: {groups} groups do not divide {cin} channels")
    if cout < 1:
        raise ValueError(f"deform conv: {cout} output channels")
    co_tile = next((c for c in sorted(MMA_FWD_BUILDS) if c >= cout), max(MMA_FWD_BUILDS))
    win_h = (MMA_FWD_TH - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
    win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
    smem = _fwd_mma_smem(kh, kw, win_h, win_w, padding)
    if smem > SMEM_BYTES:
        raise ValueError(
            f"deform conv: no bf16 forward tiling of {cin} -> {cout} channels (stride {stride}, "
            f"dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared memory")
    build = MMA_FWD_BUILDS[co_tile]
    resident = max(1, min(build, SM_SMEM_BYTES // (smem + 1024)))
    nchunks = groups * _ceil_div(cin // groups, MMA_FWD_CHUNK)
    tiles = (_ceil_div(out_h, MMA_FWD_TH) * _ceil_div(out_w, TILE_W) * _ceil_div(cout, co_tile)
             * batch)
    most = max(1, nchunks // min(8, max(1, nchunks // 2)))
    options = [s for s in range(1, most + 1) if s == 1 or (s % groups == 0 and nchunks % s == 0)]
    splits = next((s for s in options if tiles * s >= 2 * sms * resident), options[-1])
    return ForwardPlanBf16(co_tile, splits, build, win_h, win_w, smem, resident, tiles * splits)


def _wgrad_mma_smem(co_tile, win_h, win_w, padding):
    """Bytes of the tensor-core weight gradient's shared memory
    (``wgrad_mma_smem_bytes``): each warp's two float32 column tiles
    [``MMA_WG_CHUNK``][``MMA_WG_CS``], two raw bf16 gout tiles
    [co_tile][``MMA_WG_RS``], two raw bf16 x windows of the chunk and two
    channel-minor ones (win_h x win_wa positions of 16 bytes), and two
    steps' offsets (float32 dy, dx) and raw bf16 masks, a row of the step's
    pixels a tap. The kernel refuses a plan whose ``smem_bytes`` differ."""
    _, win_wa, xcs = _raw_geometry(win_h, win_w, padding, 8)
    return (4 * MMA_WG_WARPS * 2 * MMA_WG_CHUNK * MMA_WG_CS + 2 * 2 * co_tile * MMA_WG_RS
            + 2 * 2 * MMA_WG_CHUNK * xcs + 2 * 16 * win_h * win_wa
            + 2 * MMA_WG_WARPS * MMA_WG_STEP_H * TILE_W * (2 * 4 + 2))


class BackwardWeightPlanBf16(NamedTuple):
    """How ``aanet_deform_conv_backward_weight_bf16`` (the tensor-core
    weight gradient) cuts one conv: blocks of ``co_tile`` output channels by
    a chunk of ``MMA_WG_CHUNK`` input channels of one group (with all taps,
    a warp each), each summing over a run of the batch's tiles of ``tile_h``
    x ``TILE_W`` output pixels (``splits`` runs, contiguous in (batch, tile)
    order) in steps of ``MMA_WG_STEP_H`` rows, staging a tile's window of
    ``win_h`` x ``win_w`` a channel; ``smem_bytes`` of shared memory; the
    kernel's ``build`` for ``co_tile`` (blocks an SM its registers allow);
    ``resident`` blocks fit one SM and the grid holds ``blocks``. Each split
    writes its slab of the workspace (``workspace`` floats: ``splits``
    slabs of cout x cin x taps), which the kernel's second launch sums in a
    fixed order and rounds to bf16 once."""

    tile_h: int
    co_tile: int
    splits: int
    build: int
    win_h: int
    win_w: int
    smem_bytes: int
    resident: int
    blocks: int
    workspace: int


@functools.lru_cache(maxsize=None)
def backward_weight_plan_bf16(batch: int, cin: int, cout: int, out_h: int, out_w: int, kh: int,
                              kw: int, stride: int, padding: int, dilation: int, groups: int,
                              sms: int) -> BackwardWeightPlanBf16:
    """The tensor-core weight gradient's tiling for a conv of these shapes
    on a card of ``sms`` SMs.

    - The channel tile: the least of ``MMA_WG_BUILDS``' tiles that holds
      ``cout``, up to 128 (each sampled column serves all of them; gout's
      rows past cout are staged as zeros), else tiles of 128; its build.
    - The tile height, of ``MMA_WG_TILE_H``: the most resident blocks up to
      the build's, then the tallest tile (the least halo a step).
    - ``splits``: the most that keep the grid within one wave of resident
      blocks, at most one a tile of the batch.
    Raises if the conv has more than ``MMA_WG_WARPS`` taps or nothing fits."""
    if cin % groups:
        raise ValueError(f"deform conv weight gradient: {groups} groups do not divide {cin} channels")
    if cout < 1:
        raise ValueError(f"deform conv weight gradient: {cout} output channels")
    taps = kh * kw
    if taps > MMA_WG_WARPS:
        raise ValueError(f"deform conv weight gradient: {taps} taps, the bf16 kernel takes at most "
                         f"{MMA_WG_WARPS}")
    co_tile = next((c for c in sorted(MMA_WG_BUILDS) if c >= cout), max(MMA_WG_BUILDS))
    build = MMA_WG_BUILDS[co_tile]
    best = None
    for tile_h in MMA_WG_TILE_H:
        win_h = (tile_h - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
        win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
        smem = _wgrad_mma_smem(co_tile, win_h, win_w, padding)
        if smem > SMEM_BYTES:
            continue
        resident = min(build, SM_SMEM_BYTES // (smem + 1024))
        if best is None or resident > best[3]:
            best = (tile_h, win_h, win_w, resident, smem)
    if best is None:
        raise ValueError(
            f"deform conv weight gradient: no bf16 tiling of {cin} -> {cout} channels (stride "
            f"{stride}, dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared "
            "memory")
    tile_h, win_h, win_w, resident, smem = best
    units = batch * _ceil_div(out_h, tile_h) * _ceil_div(out_w, TILE_W)
    base = groups * _ceil_div(cin // groups, MMA_WG_CHUNK) * _ceil_div(cout, co_tile)
    splits = max(1, min(units, sms * resident // base, 65535))
    return BackwardWeightPlanBf16(tile_h, co_tile, splits, build, win_h, win_w, smem, resident,
                                  base * splits, splits * cout * cin * taps)


def weight_fwd_fragments(weight: torch.Tensor, groups: int, cout_pad: int) -> torch.Tensor:
    """The weight [cout, cin, kh, kw] as ``aanet_deform_conv_bf16`` reads
    it: the A operand of ``mma.sync.m16n8k16`` (16 output channels by a
    tap's 16 input channels of a chunk) of each chunk of ``MMA_FWD_CHUNK``
    of a group's channels, tap and tile of 16 of ``cout_pad`` output
    channels, in register order: [groups x chunks, taps, cout_pad / 16, 8
    (g), 4 (t), 8] bf16, lane 4 g + t holding ``weight[co, c]`` at co = 16
    tile + g + 8 (0, 1, 0, 1) and chunk positions r = 2 t + (0, 1) + 8 (0,
    0, 1, 1) (values in the order (r half, co half, r parity)); position r
    holds the chunk's channel (r // 4) + 4 (r % 4), the order in which the
    kernel's lanes store their samples. Zeros beyond cout and beyond each
    group's channels."""
    cout, cin, kh, kw = weight.shape
    cg = cin // groups
    chunks = _ceil_div(cg, MMA_FWD_CHUNK)
    w = weight.to(torch.bfloat16).reshape(cout, groups, cg, kh * kw)
    w = torch.nn.functional.pad(w, (0, 0, 0, chunks * MMA_FWD_CHUNK - cg, 0, 0, 0, cout_pad - cout))
    # the chunk's channel c = cq + 4 i at position r = 4 cq + i
    w = w.reshape(cout_pad, groups, chunks, 4, 4, kh * kw).transpose(3, 4)
    # co = 16 tile + 8 rm + g; r = 8 rh + 2 t + e
    w = w.reshape(cout_pad // 16, 2, 8, groups, chunks, 2, 4, 2, kh * kw)
    return w.permute(3, 4, 8, 0, 2, 6, 5, 1, 7).contiguous()


def weight_taps_major(weight: torch.Tensor) -> torch.Tensor:
    """The weight [cout, cin, kh, kw] laid out [kh*kw, cout, cin] in float32
    (a bf16 weight widened, exactly), as the backward-data kernel stages it:
    ``wt[k, co, c] = weight[co, c, k // kw, k % kw]``, so a tap's slice for
    a chunk of channels is ``cout`` runs of contiguous channels."""
    cout, cin, kh, kw = weight.shape
    wt = torch.empty((kh * kw, cout, cin), dtype=torch.float32, device=weight.device)
    return wt.copy_(weight.permute(2, 3, 0, 1).reshape(kh * kw, cout, cin))


class ForwardPlan(NamedTuple):
    """How ``aanet_deform_conv_f32`` cuts one conv: blocks of ``tile_h`` x
    ``TILE_W`` output pixels by ``co_tile`` output channels, each walking
    the chunks of ``FWD_CHUNK`` input channels (``splits`` blocks share a
    tile's chunks, each storing a slab of sums that a second kernel adds in
    a fixed order) with ``threads`` threads
    (``ksplit`` groups of them split a chunk's rows), staging a window of
    ``win_h`` x ``win_w`` per channel in ``smem_bytes`` of shared memory;
    ``resident`` blocks fit one SM and the grid holds ``blocks``."""

    tile_h: int
    co_tile: int
    ksplit: int
    splits: int
    threads: int
    win_h: int
    win_w: int
    smem_bytes: int
    resident: int
    blocks: int


def channel_tiles(op: str, cout: int) -> list[int]:
    """The output-channel tiles the forward and the weight gradient try
    for ``cout`` channels, in order: the largest multiple of 8 up to 128
    that divides ``cout`` (no idle channel); then, for n = ceil(cout / 128)
    tiles and more, ``8 * ceil(ceil(cout / n) / 8)``, zero-padded: the last
    tile's channels at or above ``cout`` are idle, fewer than 8 a tile. The
    plans take the first tile that some tiling of theirs fits (a block of
    9, 11, 13 or 15 register tiles of 8 channels has no whole warps)."""
    if cout < 1:
        raise ValueError(f"{op}: {cout} output channels")
    tiles = [c for c in range(8, min(cout, 128) + 1, 8) if cout % c == 0][-1:]
    for n in range(_ceil_div(cout, 128), _ceil_div(cout, 8) + 1):
        tile = 8 * _ceil_div(_ceil_div(cout, n), 8)
        if tile not in tiles:
            tiles.append(tile)
    return tiles


def _fwd_smem(taps, tile_h, co_tile, win_h, win_w, ksplit):
    """Bytes of the forward kernel's shared memory (``fwd_smem_words`` in
    the kernel): the (tap, pixel) table, a float4 each; two x windows; the
    column tile [taps x FWD_CHUNK][pixels]; two chunks' weights [taps x
    FWD_CHUNK][co_tile]. The ksplit - 1 partial tiles of the final sum
    reuse the space. The kernel refuses a plan whose ``smem_bytes``
    differ."""
    pixels = tile_h * TILE_W
    rows = taps * FWD_CHUNK
    main = 4 * taps * pixels + 2 * FWD_CHUNK * win_h * win_w + rows * pixels + 2 * rows * co_tile
    return 4 * max(main, (ksplit - 1) * co_tile * pixels)


@functools.lru_cache(maxsize=None)
def forward_plan(batch: int, cin: int, cout: int, out_h: int, out_w: int, kh: int, kw: int,
                 stride: int, dilation: int, groups: int, sms: int) -> ForwardPlan:
    """The forward kernel's tiling for a conv of these shapes on a card of
    ``sms`` SMs.

    - The channel tile: the first of ``channel_tiles`` that a tiling fits:
      the largest multiple of 8 that divides ``cout``, up to 128 (all of
      them at 16, 32, 48, 64 and 128: no idle channel, and each sampled
      column serves every output channel); else zero-padded tiles
      (``ceil(cout / co_tile)`` of them in the grid).
    - The tile height, of ``FWD_TILE_H``: for each, ``ksplit`` is the least
      power of two that gives a block 128 threads (whole warps, at most
      ``FWD_MAX_THREADS``), and ``resident`` the blocks one SM holds by
      shared memory, threads and registers. The plan takes the most
      resident warps up to 12, then a ksplit of at most 2, then the taller
      tile (less halo and table per pixel): the kernel is bound by latency
      below 12 warps an SM, and a ksplit of 4 or more spends more on the
      final sum and on syncs than it gains.
    - ``splits``: 1, or a multiple of ``groups`` that divides the chunks
      (a block then tabulates one group only); the fewest that give two
      waves of resident blocks (``2 * sms * resident``), with at least
      min(8, chunks / 2) chunks a block: each block pays for its group's
      table and its slab.
    On an H100 this was within 6 % of the fastest plan timed at every
    shape of the ``aanet`` train step. Raises if nothing fits."""
    if cin % groups:
        raise ValueError(f"deform conv: {groups} groups do not divide {cin} channels")
    cg, taps = cin // groups, kh * kw
    nchunks = groups * _ceil_div(cg, FWD_CHUNK)
    best = None
    for co_tile in channel_tiles("deform conv", cout):
        for tile_h in FWD_TILE_H:
            base = (co_tile // 8) * (2 * tile_h)
            ksplit = 1
            while base * ksplit < 128 and 2 * ksplit <= taps * FWD_CHUNK:
                ksplit *= 2
            threads = base * ksplit
            if threads % 32 or threads > FWD_MAX_THREADS:
                continue
            win_h = (tile_h - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
            win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
            smem = _fwd_smem(taps, tile_h, co_tile, win_h, win_w, ksplit)
            if smem > SMEM_BYTES:
                continue
            resident = min(SM_SMEM_BYTES // (smem + 1024), SM_THREADS // threads,
                           65536 // (FWD_REGISTERS * threads))
            key = (-min(resident * threads // 32, 12), ksplit > 2, -tile_h)
            if best is None or key < best[0]:
                best = (key, (co_tile, tile_h, ksplit, threads, win_h, win_w, smem, resident))
        if best is not None:
            break
    if best is None:
        raise ValueError(
            f"deform conv: no forward tiling of {cin} -> {cout} channels (stride {stride}, "
            f"dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared memory")
    co_tile, tile_h, ksplit, threads, win_h, win_w, smem, resident = best[1]
    tiles = _ceil_div(out_h, tile_h) * _ceil_div(out_w, TILE_W) * _ceil_div(cout, co_tile) * batch
    most = max(1, nchunks // min(8, max(1, nchunks // 2)))
    options = [s for s in range(1, most + 1) if s == 1 or (s % groups == 0 and nchunks % s == 0)]
    splits = next((s for s in options if tiles * s >= 2 * sms * resident), options[-1])
    return ForwardPlan(tile_h, co_tile, ksplit, splits, threads, win_h, win_w, smem, resident,
                       tiles * splits)


class BackwardWeightPlan(NamedTuple):
    """How ``aanet_deform_conv_backward_weight_f32`` cuts one conv's weight
    gradient: blocks of ``co_tile`` output channels by a ``chunk`` of input
    channels of one group (with all taps), each summing over a run of the
    batch's tiles of ``tile_h`` x ``TILE_W`` output pixels (``splits`` runs,
    contiguous in (batch, tile) order), a tile in steps of ``step_h`` rows,
    with ``threads`` threads (``ksplit`` groups of them take alternate pixel
    quads of a step), staging a tile's window of ``win_h`` x ``win_w`` per
    channel; ``smem_bytes`` of shared memory; the kernel's ``build`` for 1
    or 2 blocks an SM (its registers);
    ``resident`` blocks fit one SM and the grid holds ``blocks``. Each split
    writes its slab of the workspace (``workspace`` floats: ``splits``
    slabs of cout x cin x taps), and the kernel's second launch sums the
    slabs in a fixed order."""

    tile_h: int
    step_h: int
    co_tile: int
    chunk: int
    ksplit: int
    splits: int
    threads: int
    win_h: int
    win_w: int
    smem_bytes: int
    build: int
    resident: int
    blocks: int
    workspace: int


def _wg_smem(taps, step_h, co_tile, chunk, win_h, win_w, ksplit):
    """Bytes of the weight-gradient kernel's shared memory (``wg_smem_words``
    in the kernel): two steps' offsets and masks (3 x taps rows of the
    step's pixels); two steps' gout tiles and column tiles [chunk x
    ``WG_MAX_TAPS``], rows of the step's pixels plus ``WG_PAD`` words; two x windows of the
    chunk (a tile's). The ksplit - 1 thread
    groups' partial sums at the end reuse the space. The kernel refuses a
    plan whose ``smem_bytes`` differ."""
    pixels = step_h * TILE_W
    rs = pixels + WG_PAD
    main = (6 * taps * pixels + 2 * co_tile * rs + 2 * chunk * win_h * win_w
            + 2 * WG_MAX_TAPS * chunk * rs)
    return 4 * max(main, (ksplit - 1) * WG_MAX_TAPS * co_tile * chunk)


class _WgTiling(NamedTuple):
    tile_h: int
    step_h: int
    chunk: int
    ksplit: int
    threads: int
    win_h: int
    win_w: int
    smem_bytes: int
    build: int
    resident: int


def weight_grad_tilings(cin, cout, kh, kw, stride, dilation, groups):
    """The output-channel tile (the first of ``channel_tiles`` that a tiling
    fits) and every tiling the weight-gradient kernel takes for this conv
    with it: a tile height of ``WG_TILE_H``, a step height of
    ``WG_STEP_H`` that divides it, a chunk of ``WG_CHUNKS`` and a power of
    two ``ksplit`` (at most one pixel quad of a step for each group) that
    give whole warps, at most ``WG_MAX_THREADS``, in a block's shared
    memory, with each of the kernel's ``WG_BUILDS``; ``resident``: the
    blocks one SM holds by shared memory, threads and the build's
    registers."""
    if cin % groups:
        raise ValueError(f"deform conv weight gradient: {groups} groups do not divide {cin} channels")
    taps = kh * kw
    if taps > WG_MAX_TAPS:
        raise ValueError(f"deform conv weight gradient: {taps} taps, the kernel takes at most "
                         f"{WG_MAX_TAPS}")
    tiles = channel_tiles("deform conv weight gradient", cout)
    for co_tile in tiles:
        out = []
        for tile_h in WG_TILE_H:
            win_h = (tile_h - 1) * stride + (kh - 1) * dilation + 2 * HALO + 2
            win_w = (TILE_W - 1) * stride + (kw - 1) * dilation + 2 * HALO + 2
            for step_h in (s for s in WG_STEP_H if tile_h % s == 0):
                for chunk in WG_CHUNKS:
                    ksplit = 1
                    while ksplit <= step_h * TILE_W // 4:
                        threads = co_tile // WG_TM * chunk * ksplit
                        smem = _wg_smem(taps, step_h, co_tile, chunk, win_h, win_w, ksplit)
                        if threads % 32 == 0 and threads <= WG_MAX_THREADS and smem <= SMEM_BYTES:
                            for build in WG_BUILDS:
                                registers = 65536 // (build * WG_MAX_THREADS)
                                resident = min(SM_SMEM_BYTES // (smem + 1024),
                                               SM_THREADS // threads,
                                               65536 // (registers * threads))
                                out.append(_WgTiling(tile_h, step_h, chunk, ksplit, threads, win_h,
                                                     win_w, smem, build, resident))
                        ksplit *= 2
        if out:
            return co_tile, out
    return tiles[0], []


def weight_grad_plan_of(tiling, co_tile, batch, cin, cout, out_h, out_w, kh, kw, groups, sms,
                        waves=WG_WAVES):
    """The plan of one tiling: ``splits``, the most that keep the grid
    within ``waves`` waves of resident blocks (``waves * sms * resident``:
    a few blocks more would run as a tail of their own), at least one, at
    most one a tile of the batch."""
    units = batch * _ceil_div(out_h, tiling.tile_h) * _ceil_div(out_w, TILE_W)
    base = groups * _ceil_div(cin // groups, tiling.chunk) * _ceil_div(cout, co_tile)
    splits = max(1, min(units, waves * sms * tiling.resident // base, 65535))
    return BackwardWeightPlan(tiling.tile_h, tiling.step_h, co_tile, tiling.chunk, tiling.ksplit,
                              splits, tiling.threads, tiling.win_h, tiling.win_w,
                              tiling.smem_bytes, tiling.build, tiling.resident, base * splits,
                              splits * cout * cin * kh * kw)


@functools.lru_cache(maxsize=None)
def backward_weight_plan(batch: int, cin: int, cout: int, out_h: int, out_w: int, kh: int,
                         kw: int, stride: int, dilation: int, groups: int,
                         sms: int) -> BackwardWeightPlan:
    """The weight-gradient kernel's tiling for a conv of these shapes on a
    card of ``sms`` SMs.

    - The channel tile: as the forward's, the first of ``channel_tiles``
      that a tiling fits (the largest multiple of 8 up to 128 that divides
      ``cout``, else zero-padded tiles): each sampled column serves all of
      them.
    - Of ``weight_grad_tilings``: the fewest idle channels (none where a
      multiple of 4 divides the group's channels), then the most resident
      warps up to ``WG_WARPS``, then the most pixel quads a thread
      contracts between two barriers (step_h * 4 / ksplit), then the
      taller tile (less halo per pixel), the more threads, the build with
      more registers, and the larger chunk.
    - ``splits``: the most that keep the grid within ``WG_WAVES`` wave of
      resident blocks, at most one a tile of the batch; so it shrinks with
      the SM count, and only a batch too small for it caps it.
    On an H100 this picked the fastest of every plan the kernel takes at
    four of the six step shapes and was within 8 % at the others
    (``tools/torch_deform_wgrad_sweep.py``). Raises if nothing fits."""
    co_tile, tilings = weight_grad_tilings(cin, cout, kh, kw, stride, dilation, groups)
    cg = cin // groups

    def key(t):
        idle = _ceil_div(cg, t.chunk) * t.chunk - cg
        return (idle, -min(t.resident * t.threads // 32, WG_WARPS), -(t.step_h * 4 // t.ksplit),
                -t.tile_h, -t.threads, t.build, -t.chunk)

    if not tilings:
        raise ValueError(
            f"deform conv weight gradient: no tiling of {cin} -> {cout} channels (stride "
            f"{stride}, dilation {dilation}, {groups} groups) fits {SMEM_BYTES} bytes of shared "
            "memory")
    return weight_grad_plan_of(min(tilings, key=key), co_tile, batch, cin, cout, out_h, out_w,
                               kh, kw, groups, sms)


def weight_taps_cin_major(weight: torch.Tensor, cout_pad: Optional[int] = None) -> torch.Tensor:
    """The weight [cout, cin, kh, kw] laid out [kh*kw, cin, cout_pad], as
    the forward kernel stages it: ``wt[k, c, co] = weight[co, c, k // kw, k
    % kw]`` for co < cout, zero for the padded channels up to ``cout_pad``
    (default ``cout``), so a tap's rows for a chunk of channels are runs of
    contiguous output channels, each tile's 16-byte aligned."""
    cout, cin, kh, kw = weight.shape
    wt = weight.permute(2, 3, 1, 0).reshape(kh * kw, cin, cout)
    if cout_pad is None or cout_pad == cout:
        return wt.contiguous()
    return torch.nn.functional.pad(wt, (0, cout_pad - cout))


def _check_shapes(x, offset, mask, weight, stride, padding, dilation, g):
    b, cin, h, w = x.shape
    cout, wcin, kh, kw = weight.shape
    k2 = kh * kw
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    if wcin != cin or cin % g:
        raise ValueError(f"deform conv: weight {tuple(weight.shape)} and groups {g} do not fit x {tuple(x.shape)}")
    if offset.shape != (b, g * k2 * 2, ho, wo):
        raise ValueError(f"deform conv: offset {tuple(offset.shape)}, expected {(b, g * k2 * 2, ho, wo)}")
    if mask is not None and mask.shape != (b, g * k2, ho, wo):
        raise ValueError(f"deform conv: mask {tuple(mask.shape)}, expected {(b, g * k2, ho, wo)}")
    return ho, wo


def _check_kernel_inputs(op, x, offset, mask, **dense):
    """Raise unless the tensors suit the CUDA kernels: x and ``dense``
    contiguous CUDA tensors, offset and mask contiguous within each batch
    entry (channel slices allowed); x, the mask, the weight and the output
    gradient of x's dtype, the offsets and the bias float32."""
    def arg(name, t):
        return t, x.dtype if name in ("x", "mask", "weight", "gout") else torch.float32

    sliced = dict(offset=offset) if mask is None else dict(offset=offset, mask=mask)
    _build.check_cuda(op, **{k: arg(k, v) for k, v in dict(x=x, **dense).items() if v is not None},
                      **{k: arg(k, v[0]) for k, v in sliced.items()})


def _shape_args(x, weight, ho, wo, stride, padding, dilation, g):
    b, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    return (b, cin, h, w, cout, ho, wo, kh, kw, stride, padding, dilation, g,
            x.device.index, _build.stream(x))


def _forward(x, offset, mask, weight, bias, *, stride, padding, dilation, deformable_groups):
    """The forward: the plain version for a CPU tensor; for a CUDA tensor
    ``aanet_deform_conv_f32`` with ``forward_plan``'s tiling or, for bf16 x,
    ``aanet_deform_conv_bf16`` with ``forward_plan_bf16``'s (a split plan's
    float32 slabs summed in a fixed order)."""
    g = deformable_groups
    ho, wo = _check_shapes(x, offset, mask, weight, stride, padding, dilation, g)
    if x.device.type == "cpu":
        return modulated_deform_conv2d_plain(
            x, offset, mask, weight, bias, stride=stride, padding=padding,
            dilation=dilation, deformable_groups=g,
        )
    form = _build.form("deform conv", x.dtype)
    _check_kernel_inputs("deform conv", x, offset, mask, weight=weight, bias=bias)
    b, cin, _, _ = x.shape
    cout, _, kh, kw = weight.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if form == "bf16":
        return _forward_bf16(x, offset, mask, weight, bias, ho, wo, sms, stride=stride,
                             padding=padding, dilation=dilation, deformable_groups=g)
    plan = forward_plan(b, cin, cout, ho, wo, kh, kw, stride, dilation, g, sms)
    out = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    # each split its float32 slab, which a second kernel sums in order (and rounds, bf16)
    sums = (torch.empty((plan.splits, b, cout, ho, wo), dtype=torch.float32, device=x.device)
            if plan.splits > 1 else None)
    cout_pad = _ceil_div(cout, plan.co_tile) * plan.co_tile  # zero channels up to whole tiles
    wt = weight_taps_cin_major(weight, cout_pad)
    *shape, device, stream = _shape_args(x, weight, ho, wo, stride, padding, dilation, g)
    _build.launch(
        "deform_conv", f"aanet_deform_conv_{form}", _ARGTYPES,
        _build.ptr(x), _build.ptr(offset), offset.stride(0),
        _build.ptr(mask), 0 if mask is None else mask.stride(0),
        _build.ptr(wt), _build.ptr(bias), _build.ptr(out), _build.ptr(sums), *shape, plan.tile_h,
        plan.co_tile, cout_pad, plan.ksplit, plan.splits, plan.smem_bytes, device, stream,
    )
    _build.count_launch(modulated_deform_conv2d, form)
    return out


def _forward_bf16(x, offset, mask, weight, bias, ho, wo, sms, *, stride, padding, dilation,
                  deformable_groups):
    """``aanet_deform_conv_bf16``, the tensor-core forward, with
    ``forward_plan_bf16``'s tiling and the weight in fragment order."""
    g = deformable_groups
    b, cin, _, _ = x.shape
    cout, _, kh, kw = weight.shape
    plan = forward_plan_bf16(b, cin, cout, ho, wo, kh, kw, stride, padding, dilation, g, sms)
    out = torch.empty((b, cout, ho, wo), dtype=x.dtype, device=x.device)
    sums = (torch.empty((plan.splits, b, cout, ho, wo), dtype=torch.float32, device=x.device)
            if plan.splits > 1 else None)
    wf = weight_fwd_fragments(weight, g, _ceil_div(cout, plan.co_tile) * plan.co_tile)
    *shape, device, stream = _shape_args(x, weight, ho, wo, stride, padding, dilation, g)
    _build.launch(
        "deform_conv", "aanet_deform_conv_bf16", _FWD_BF16_ARGTYPES,
        _build.ptr(x), _build.ptr(offset), offset.stride(0),
        _build.ptr(mask), 0 if mask is None else mask.stride(0),
        _build.ptr(wf), _build.ptr(bias), _build.ptr(out), _build.ptr(sums), *shape, plan.co_tile,
        plan.splits, plan.smem_bytes, device, stream,
    )
    _build.count_launch(modulated_deform_conv2d, "bf16")
    return out


def backward_data_scratch(x, offset, mask, chunks):
    """The backward-data kernel's scratch, as its C entry point takes it:
    ``bound`` (3 float64: the largest |gout|, weight column sum and |mask|,
    zeroed), ``x_acc`` (int64 of x's shape: grad_x in fixed point, zeroed),
    ``x_flags`` (int32, 2 bits an element of x: its non-finite terms,
    zeroed), ``offset_sums`` (float32 [chunks, offset's shape] where a
    group spans several chunks, else None) and ``mask_sums`` (float32
    [chunks, mask's shape] where it does or the mask is bf16; None without
    a mask). The kernel writes the slabs in full."""
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    slabs = mask is not None and (chunks > 1 or mask.dtype == torch.bfloat16)
    return dict(
        bound=torch.zeros(3, dtype=torch.float64, device=dev),
        x_acc=torch.zeros(x.shape, dtype=torch.int64, device=dev),
        x_flags=torch.zeros(_ceil_div(x.numel(), 16), dtype=torch.int32, device=dev),
        offset_sums=torch.empty((chunks, *offset.shape), **f32) if chunks > 1 else None,
        mask_sums=torch.empty((chunks, *mask.shape), **f32) if slabs else None,
    )


def modulated_deform_conv2d_backward_data(
    gout, x, offset, mask, weight, *, stride=1, padding=0, dilation=1, deformable_groups=1
):
    """Gradients for x, offset and mask (None for a unit mask) given the
    output gradient ``gout``, each in its primal's dtype. A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``aanet_deform_conv_backward_data_f32`` (``backward_data_plan``, the
    weight ``weight_taps_major``) or, for a bf16 x,
    ``aanet_deform_conv_backward_data_bf16`` (``backward_data_plan_bf16``,
    the weight ``weight_bwd_fragments``); the same bits every launch: the x
    gradient summed in fixed point, a group's chunks' offset and mask
    gradients in slabs summed in a fixed order."""
    g = deformable_groups
    ho, wo = _check_shapes(x, offset, mask, weight, stride, padding, dilation, g)
    if x.device.type == "cpu":
        return modulated_deform_conv2d_backward_data_plain(
            gout, x, offset, mask, weight, stride=stride, padding=padding,
            dilation=dilation, deformable_groups=g,
        )
    form = _build.form("deform conv backward", x.dtype)
    _check_kernel_inputs("deform conv backward", x, offset, mask, gout=gout, weight=weight)
    cout, cin, kh, kw = weight.shape
    if form == "bf16":
        plan = backward_data_plan_bf16(cin, cout, kh, kw, stride, padding, dilation, g)
        wt = weight_bwd_fragments(weight, g)
    else:
        plan = backward_data_plan(cin, cout, kh, kw, stride, dilation, g)
        wt = weight_taps_major(weight)
    scratch = backward_data_scratch(x, offset, mask, plan.chunks)
    grad_x = torch.empty_like(x)
    grad_off = torch.empty(offset.shape, dtype=torch.float32, device=x.device)
    grad_mask = None if mask is None else torch.empty(mask.shape, dtype=mask.dtype, device=x.device)
    *shape, device, stream = _shape_args(x, weight, ho, wo, stride, padding, dilation, g)
    _build.launch(
        "deform_conv", f"aanet_deform_conv_backward_data_{form}", _BWD_DATA_ARGTYPES,
        _build.ptr(gout), _build.ptr(x), _build.ptr(offset), offset.stride(0),
        _build.ptr(mask), 0 if mask is None else mask.stride(0), _build.ptr(wt),
        *map(_build.ptr, (scratch["bound"], scratch["x_acc"], scratch["x_flags"], grad_x,
                          scratch["offset_sums"], grad_off, scratch["mask_sums"], grad_mask)),
        *shape, plan.chunk, plan.tile_h, plan.blocks, plan.smem_bytes, device, stream,
    )
    _build.count_launch(modulated_deform_conv2d_backward_data, form)
    return grad_x, grad_off, grad_mask


def modulated_deform_conv2d_backward_weight(
    gout, x, offset, mask, weight, *, stride=1, padding=0, dilation=1, deformable_groups=1
):
    """Gradient for the weight, in its dtype, given the output gradient
    ``gout``. A CPU tensor takes the plain version; a CUDA tensor launches
    ``aanet_deform_conv_backward_weight_f32`` with ``backward_weight_plan``'s
    tiling or, for a bf16 x, ``aanet_deform_conv_backward_weight_bf16`` (the
    tensor-core kernel) with ``backward_weight_plan_bf16``'s; each split's
    partial sums added in a fixed order: the result is bit-reproducible."""
    g = deformable_groups
    ho, wo = _check_shapes(x, offset, mask, weight, stride, padding, dilation, g)
    if x.device.type == "cpu":
        return modulated_deform_conv2d_backward_weight_plain(
            gout, x, offset, mask, weight, stride=stride, padding=padding,
            dilation=dilation, deformable_groups=g,
        )
    form = _build.form("deform conv weight gradient", x.dtype)
    _check_kernel_inputs("deform conv weight gradient", x, offset, mask, gout=gout, weight=weight)
    b, cin, _, _ = x.shape
    cout, _, kh, kw = weight.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if form == "bf16":
        plan = backward_weight_plan_bf16(b, cin, cout, ho, wo, kh, kw, stride, padding, dilation,
                                         g, sms)
        argtypes, tiling = _BWD_WEIGHT_BF16_ARGTYPES, (plan.tile_h, plan.co_tile, plan.splits)
    else:
        plan = backward_weight_plan(b, cin, cout, ho, wo, kh, kw, stride, dilation, g, sms)
        argtypes, tiling = _BWD_WEIGHT_ARGTYPES, (plan.tile_h, plan.step_h, plan.co_tile,
                                                  plan.chunk, plan.ksplit, plan.splits)
    # each split writes its slab; the kernel's second launch sums them in
    # a fixed order
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    grad_w = torch.empty_like(weight)
    *shape, device, stream = _shape_args(x, weight, ho, wo, stride, padding, dilation, g)
    _build.launch(
        "deform_conv", f"aanet_deform_conv_backward_weight_{form}", argtypes,
        _build.ptr(gout), _build.ptr(x), _build.ptr(offset), offset.stride(0),
        _build.ptr(mask), 0 if mask is None else mask.stride(0), _build.ptr(ws),
        _build.ptr(grad_w), *shape, *tiling, plan.build, plan.smem_bytes, device, stream,
    )
    _build.count_launch(modulated_deform_conv2d_backward_weight, form)
    return grad_w


class _ModulatedDeformConv(torch.autograd.Function):
    """Forward and backward of the deformable conv; each half runs its
    kernels for CUDA tensors and its plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, conf):
        ctx.conf = conf
        ctx.save_for_backward(x, offset, mask, weight)
        return _forward(x, offset, mask, weight, bias, **conf)

    @staticmethod
    def backward(ctx, gout):
        x, offset, mask, weight = ctx.saved_tensors
        need_x, need_off, need_mask, need_w, need_b, _ = ctx.needs_input_grad
        gout = gout.contiguous()
        grad_x = grad_off = grad_mask = grad_w = grad_b = None
        if need_x or need_off or need_mask:
            grad_x, grad_off, grad_mask = modulated_deform_conv2d_backward_data(
                gout, x, offset, mask, weight, **ctx.conf
            )
        if need_w:
            grad_w = modulated_deform_conv2d_backward_weight(gout, x, offset, mask, weight, **ctx.conf)
        if need_b:  # in the bias's dtype (float32 under bf16 too), as the JAX op adds it
            grad_b = gout.sum((0, 2, 3), dtype=torch.promote_types(gout.dtype, torch.float32))
        return (grad_x if need_x else None, grad_off if need_off else None,
                grad_mask if need_mask else None, grad_w, grad_b, None)


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
      x: [B, Cin, H, W], float32 or bfloat16.
      offset: [B, G*K*2, Ho, Wo], channel order (g, k, (dy, dx)); float32.
      mask: [B, G*K, Ho, Wo] modulation, or None for a unit mask.
      weight: [Cout, Cin, kh, kw].
      bias: [Cout] or None; float32.
    Returns:
      [B, Cout, Ho, Wo] in x's dtype, differentiable in every tensor
      argument.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels. ``offset`` and ``mask`` may be channel slices of a larger
    tensor: only each batch entry must be contiguous. For a bf16 x the
    mask and the weight are rounded to bf16, as the JAX op rounds them.
    """
    if x.dtype == torch.bfloat16:
        mask, weight = _bf16_operands(x, mask, weight)
    conf = dict(stride=stride, padding=padding, dilation=dilation, deformable_groups=deformable_groups)
    return _ModulatedDeformConv.apply(x, offset, mask, weight, bias, conf)


modulated_deform_conv2d.launches = 0
modulated_deform_conv2d.launches_bf16 = 0
modulated_deform_conv2d_backward_data.launches = 0
modulated_deform_conv2d_backward_data.launches_bf16 = 0
modulated_deform_conv2d_backward_weight.launches = 0
modulated_deform_conv2d_backward_weight.launches_bf16 = 0
