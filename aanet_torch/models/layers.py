"""Shared building blocks (aanet_tpu/models/layers.py) as NCHW ``nn.Module``s.

Submodules carry the names of the flax modules' path segments (``Conv_0``,
``Norm_1``, ``ZeroNorm_0``, ``DeformConv2dLayer_0``, ``offset_conv``, ...),
and the ``Conv`` and ``Norm`` wrappers hold their layer under the name the
flax wrapper gives its inner module (``Conv_0``, ``BatchNorm_0``). A flax
parameter path then maps onto a state_dict key segment for segment
(``aanet_torch/convert.py``).

BatchNorm (``Norm``) follows flax's ``nn.BatchNorm`` (layers.py:168-206):
eps 1e-5; in training the batch statistics normalise and the running
statistics move by momentum 0.1 (flax's 0.9) towards the batch mean and
the *biased* batch variance (torch's own BatchNorm would store the
unbiased one). In eval mode, or when ``freeze_bn`` has put the BatchNorms
in eval mode while the rest of the network trains (the reference's
fine-tune protocol, layers.py:30-47), the running statistics normalise.

Under a compute dtype (``aanet_torch.ops.precision``, installed by the
model's forward) the layers cast as their flax counterparts do: ``Conv``,
``ConvTranspose`` and the bare convs (``DtypeConv2d``) cast their input,
kernel and bias to it (flax's ``nn.Conv(dtype=...)``); ``Norm``
normalises in float32 and returns the compute dtype (flax's
``_normalize``); ``DeformConv2dLayer`` runs its offset head in float32 on
a float32 copy of its input, and its op rounds the mask and the weight to
the input's dtype. Parameters and statistics stay float32.

Under data-parallel training (a process group of more than one rank,
``aanet_torch.parallel.mesh``) a training ``Norm`` takes its statistics
over the global batch, as flax's BatchNorm does under the JAX package's
global-view jit: each rank's per-channel mean, biased variance and count
are gathered and combined exactly, in float64, into the global mean and
biased variance, which normalise and move the running statistics
identically on every rank; the gradient flows back through the gather
to every rank's share, as SyncBatchNorm's does. A recomputed block (see
``remat``) gathers again, on every rank alike; eval mode and ``freeze_bn``
gather nothing.

``remat`` is the port's activation rematerialisation (flax ``nn.remat``):
``torch.utils.checkpoint`` with the BatchNorm statistics updated only on
the first, saved forward, never again when backward recomputes the block,
and the recomputation under the first forward's compute dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from aanet_torch.ops import deform as deform_ops
from aanet_torch.ops.precision import compute_dtype, precision
from aanet_torch.parallel import mesh

BN_MOMENTUM = 0.1  # torch convention; flax's momentum 0.9
# False while torch.utils.checkpoint recomputes a block in backward: the
# block's BatchNorms then normalise as before but leave their statistics.
_UPDATE_STATS = True


def remat(fn, *args):
    """``fn(*args)`` under activation checkpointing: only ``args`` are saved
    and ``fn`` runs again in backward. Nested calls compose; BatchNorm
    statistics update on the first forward only; the recomputation runs
    under the compute dtype of the first forward (backward runs outside
    the model's ``precision`` scope)."""
    calls = []
    dtype = compute_dtype()

    def run(*inner):
        global _UPDATE_STATS
        outer = _UPDATE_STATS
        _UPDATE_STATS = outer and not calls
        calls.append(None)
        try:
            with precision(dtype):
                return fn(*inner)
        finally:
            _UPDATE_STATS = outer

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def add_numbered(module: nn.Module, blocks) -> list[str]:
    """Add ``blocks`` to ``module`` as ``<class>_<n>``, as flax auto-names
    them in creation order; return the names in order."""
    counts: dict = {}
    names = []
    for block in blocks:
        kind = type(block).__name__
        name = f"{kind}_{counts.get(kind, 0)}"
        counts[kind] = counts.get(kind, 0) + 1
        module.add_module(name, block)
        names.append(name)
    return names


def set_train_mode(model: nn.Module, freeze_bn: bool = False) -> nn.Module:
    """``model.train()``, with every BatchNorm (2-D and 3-D) left in eval
    mode under ``freeze_bn`` (running statistics, no updates)."""
    model.train()
    if freeze_bn:
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.eval()
    return model


_SLOPE = 0.2  # the leaky ReLU's negative slope (aanet_tpu/models/layers.py:209)
# the slope in each value type: XLA multiplies a bf16 x by the slope rounded
# to bf16 (flax's ``nn.leaky_relu`` with a weak-typed 0.2), and the product
# of two bf16 values is exact in float32, so F.leaky_relu with the rounded
# slope rounds the product once, as XLA's bf16 multiply does
_SLOPES = {dt: float(torch.tensor(_SLOPE, dtype=dt))
           for dt in (torch.float32, torch.bfloat16, torch.float64)}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=_SLOPES[x.dtype])


def in_compute_dtype(*tensors):
    """``tensors`` cast to the compute dtype (None stays None); as they are
    without one."""
    dt = compute_dtype()
    if dt is None:
        return tensors
    return tuple(None if t is None else t.to(dt) for t in tensors)


def add_bias(y, bias):
    """``y`` plus ``bias`` over its channels (dim 1), or ``y`` without one."""
    return y if bias is None else y + bias.view((1, -1) + (1,) * (y.ndim - 2))


class _ComputeDtypeConv:
    """A conv run in the compute dtype: its input, kernel and bias cast to
    it, as flax's ``nn.Conv(dtype=compute_dtype())`` promotes all three;
    the bias is added to the rounded product, as flax adds it."""

    def forward(self, x):
        if compute_dtype() is None:
            return super().forward(x)
        x, weight, bias = in_compute_dtype(x, self.weight, self.bias)
        return add_bias(self._conv_forward(x, weight, None), bias)


class DtypeConv2d(_ComputeDtypeConv, nn.Conv2d):
    """``nn.Conv2d`` in the compute dtype (the same parameters)."""


class DtypeConv3d(_ComputeDtypeConv, nn.Conv3d):
    """``nn.Conv3d`` in the compute dtype (the same parameters)."""


class Conv(nn.Module):
    """A Conv2d with torch padding arithmetic, no bias by default; a Conv3d
    over (D, H, W) when ``kernel_size`` is a 3-tuple, as the flax
    ``Conv`` (layers.py:77-130); in the compute dtype."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=0, dilation=1,
                 groups=1, bias=False):
        super().__init__()
        conv = DtypeConv3d if isinstance(kernel_size, (tuple, list)) and len(kernel_size) == 3 else DtypeConv2d
        self.Conv_0 = conv(cin, cout, kernel_size, stride, padding, dilation, groups, bias=bias)
        nn.init.kaiming_normal_(self.Conv_0.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x):
        return self.Conv_0(x)


class ConvTranspose(nn.Module):
    """A transposed conv with torch's output size, (in - 1) * stride -
    2 * padding + k + output_padding (layers.py:132-165).

    The JAX package runs it as a conv of the input dilated by ``stride``,
    padded (k - 1 - padding, k - 1 - padding + output_padding), with an
    unflipped kernel. ``Conv_0.weight`` holds that kernel, [Cout, Cin, k...]
    after the usual HWIO -> OIHW conversion; the forward hands
    ``F.conv_transpose{2,3}d`` its spatially flipped, in/out-swapped view,
    which is the same map.
    """

    def __init__(self, cin, cout, kernel_size=3, stride=2, padding=1, output_padding=1,
                 bias=False):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel_size, bias=bias).Conv_0
        self.stride, self.padding, self.output_padding = stride, padding, output_padding

    def forward(self, x):
        x, weight, bias = in_compute_dtype(x, self.Conv_0.weight, self.Conv_0.bias)
        flipped = weight.flip(tuple(range(2, weight.ndim))).transpose(0, 1)
        fn = F.conv_transpose3d if weight.ndim == 5 else F.conv_transpose2d
        if compute_dtype() is None:
            return fn(x, flipped, bias, self.stride, self.padding, self.output_padding)
        return add_bias(fn(x, flipped, None, self.stride, self.padding, self.output_padding), bias)


class Norm(nn.Module):
    """BatchNorm with flax's training semantics (module docstring), over
    [B, C, H, W] or, with ``dims=3``, over [B, C, D, H, W]. Under a compute
    dtype it normalises in float32 and returns the compute dtype, as flax's
    ``_normalize`` promotes its input to the float32 statistics and casts
    the result."""

    def __init__(self, channels, zero_init=False, dims=2):
        super().__init__()
        bn = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}[dims]
        self.BatchNorm_0 = bn(channels, eps=1e-5, momentum=BN_MOMENTUM)
        if zero_init:  # ZeroNorm: zero-init residual branch (nets/resnet.py:146-151)
            nn.init.zeros_(self.BatchNorm_0.weight)

    def forward(self, x):
        dt = compute_dtype()
        if dt is None:
            return self._normalize(x)
        if x.dtype == dt and not self.BatchNorm_0.training:
            # one batch_norm of the bf16 input with the float32 statistics
            # and parameters: float32 arithmetic, the result rounded once
            return self.BatchNorm_0(x)
        return self._normalize(x.float()).to(dt)

    def _normalize(self, x):
        bn = self.BatchNorm_0
        if not bn.training:
            return bn(x)
        dims = (0,) + tuple(range(2, x.ndim))
        if mesh.world_size() > 1:
            return self._normalize_global(x, dims)
        if _UPDATE_STATS:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=dims, correction=0)
                bn.running_mean.lerp_(mean, BN_MOMENTUM)
                bn.running_var.lerp_(var, BN_MOMENTUM)
                bn.num_batches_tracked.add_(1)
        if x.numel() == x.shape[1]:
            # one value per channel (PSMNet's 64-px SPP branch on a 256-px
            # crop at batch 1): torch's batch_norm refuses it, flax
            # normalises it to the bias
            var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
            shape = (1, -1) + (1,) * (x.ndim - 2)
            return (x - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(shape) + bn.bias.view(shape)
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)

    def _normalize_global(self, x, dims):
        """Training over several ranks: the statistics of the global batch
        (module docstring). Every rank calls this in the same order."""
        bn = self.BatchNorm_0
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        count = torch.full_like(mean, x.numel() // x.shape[1], dtype=torch.float64)
        parts = mesh.gather_ranks(torch.stack([mean.double(), var.double(), count]))
        counts = parts[:, 2]
        total = counts.sum(0)
        mean64 = (counts * parts[:, 0]).sum(0) / total
        var64 = (counts * (parts[:, 1] + (parts[:, 0] - mean64).square())).sum(0) / total
        mean, var = mean64.float(), var64.float()
        if _UPDATE_STATS:
            with torch.no_grad():
                bn.running_mean.lerp_(mean, BN_MOMENTUM)
                bn.running_var.lerp_(var, BN_MOMENTUM)
                bn.num_batches_tracked.add_(1)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        return (x - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)


class DeformConv2dLayer(nn.Module):
    """A (modulated) deformable conv with its grouped offset head
    (``layers.py:247-325``; reference nets/deform.py:17-97).

    ``offset_conv`` yields G*3*K^2 channels: offsets ``[:, :2*G*K^2]`` in the
    (g, k, (dy, dx)) order, then mask logits in the (g, k) order; the mask is
    sigmoid, times 2 under ``double_mask``. ``offset_conv`` starts at zero,
    so a fresh layer is a plain dilated conv. The offset head runs in
    float32 on a float32 copy of x, whatever the compute dtype
    (``layers.py:272-287``): the offsets place the bilinear samples.
    """

    def __init__(self, cin, cout, kernel_size=3, stride=1, dilation=2,
                 deformable_groups=2, modulation=True, double_mask=True, bias=False):
        super().__init__()
        k2 = kernel_size * kernel_size
        self.stride, self.dilation = stride, dilation
        self.groups, self.modulation, self.double_mask = deformable_groups, modulation, double_mask
        self.n_offset = deformable_groups * 2 * k2
        per = 3 if modulation else 2
        self.offset_conv = nn.Conv2d(
            cin, deformable_groups * per * k2, kernel_size, stride, padding=dilation,
            dilation=dilation, groups=deformable_groups, bias=True,
        )
        nn.init.zeros_(self.offset_conv.weight)
        nn.init.zeros_(self.offset_conv.bias)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        offset_mask = self.offset_conv(x.to(torch.promote_types(x.dtype, torch.float32)))
        mask = None
        if self.modulation:
            mask = torch.sigmoid(offset_mask[:, self.n_offset:])
            if self.double_mask:
                mask = mask * 2.0
            offset_mask = offset_mask[:, : self.n_offset]
        return deform_ops.modulated_deform_conv2d(
            x, offset_mask, mask, self.weight, self.bias, stride=self.stride,
            padding=self.dilation, dilation=self.dilation, deformable_groups=self.groups,
        )


class BasicBlock(nn.Module):
    """Two-conv residual block (reference nets/feature.py:42-76), dense
    layout. The JAX package's space-to-depth execution of it is the same
    math and the same parameters."""

    def __init__(self, cin, features, stride=1, dilation=1, leaky=True, downsample=False):
        super().__init__()
        self.act = leaky_relu if leaky else F.relu
        self.Conv_0 = Conv(cin, features, 3, stride, dilation, dilation)
        self.Norm_0 = Norm(features)
        self.Conv_1 = Conv(features, features, 3, 1, dilation, dilation)
        self.Norm_1 = Norm(features)
        self.has_identity = downsample or stride != 1 or cin != features
        if self.has_identity:
            self.Conv_2 = Conv(cin, features, 1, stride)
            self.Norm_2 = Norm(features)

    def forward(self, x):
        out = self.act(self.Norm_0(self.Conv_0(x)))
        out = self.Norm_1(self.Conv_1(out))
        identity = self.Norm_2(self.Conv_2(x)) if self.has_identity else x
        return self.act(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual bottleneck with zero-init last BN
    (reference nets/resnet.py:58-99)."""

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False, expansion=4):
        super().__init__()
        out_ch = planes * expansion
        self.Conv_0 = Conv(cin, planes, 1)
        self.Norm_0 = Norm(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride, dilation, dilation)
        self.Norm_1 = Norm(planes)
        self.Conv_2 = Conv(planes, out_ch, 1)
        self.ZeroNorm_0 = Norm(out_ch, zero_init=True)
        self.has_identity = downsample or stride != 1 or cin != out_ch
        if self.has_identity:
            self.Conv_3 = Conv(cin, out_ch, 1, stride)
            self.Norm_2 = Norm(out_ch)

    def forward(self, x):
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = F.relu(self.Norm_1(self.Conv_1(out)))
        out = self.ZeroNorm_0(self.Conv_2(out))
        identity = self.Norm_2(self.Conv_3(x)) if self.has_identity else x
        return F.relu(out + identity)


class DeformBottleneck(nn.Module):
    """Bottleneck whose 3x3 is a modulated deformable conv (dilation 2,
    reference nets/deform.py:100-141)."""

    def __init__(self, cin, planes, stride=1, downsample=False, expansion=4):
        super().__init__()
        out_ch = planes * expansion
        self.Conv_0 = Conv(cin, planes, 1)
        self.Norm_0 = Norm(planes)
        self.DeformConv2dLayer_0 = DeformConv2dLayer(planes, planes, stride=stride)
        self.Norm_1 = Norm(planes)
        self.Conv_1 = Conv(planes, out_ch, 1)
        self.ZeroNorm_0 = Norm(out_ch, zero_init=True)
        self.has_identity = downsample or stride != 1 or cin != out_ch
        if self.has_identity:
            self.Conv_2 = Conv(cin, out_ch, 1, stride)
            self.Norm_2 = Norm(out_ch)

    def forward(self, x):
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = F.relu(self.Norm_1(self.DeformConv2dLayer_0(out)))
        out = self.ZeroNorm_0(self.Conv_1(out))
        identity = self.Norm_2(self.Conv_2(x)) if self.has_identity else x
        return F.relu(out + identity)


class SimpleBottleneck(nn.Module):
    """Bottleneck without channel expansion (reference nets/deform.py:144)."""

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.Conv_0 = Conv(cin, planes, 1)
        self.Norm_0 = Norm(planes)
        self.Conv_1 = Conv(planes, planes, 3, stride, 1)
        self.Norm_1 = Norm(planes)
        self.Conv_2 = Conv(planes, planes, 1)
        self.Norm_2 = Norm(planes)
        self.has_identity = stride != 1 or cin != planes
        if self.has_identity:
            self.Conv_3 = Conv(cin, planes, 1, stride)
            self.Norm_3 = Norm(planes)

    def forward(self, x):
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = F.relu(self.Norm_1(self.Conv_1(out)))
        out = self.Norm_2(self.Conv_2(out))
        identity = self.Norm_3(self.Conv_3(x)) if self.has_identity else x
        return F.relu(out + identity)


class DeformSimpleBottleneck(nn.Module):
    """Simple bottleneck with a modulated deformable 3x3: the ISA block
    (reference nets/deform.py:187-236)."""

    def __init__(self, cin, planes, stride=1, mdconv_dilation=2, deformable_groups=2,
                 modulation=True, double_mask=True):
        super().__init__()
        self.Conv_0 = Conv(cin, planes, 1)
        self.Norm_0 = Norm(planes)
        self.DeformConv2dLayer_0 = DeformConv2dLayer(
            planes, planes, stride=stride, dilation=mdconv_dilation,
            deformable_groups=deformable_groups, modulation=modulation,
            double_mask=double_mask,
        )
        self.Norm_1 = Norm(planes)
        self.Conv_1 = Conv(planes, planes, 1)
        self.Norm_2 = Norm(planes)
        self.has_identity = stride != 1 or cin != planes
        if self.has_identity:
            self.Conv_2 = Conv(cin, planes, 1, stride)
            self.Norm_3 = Norm(planes)

    def forward(self, x):
        out = F.relu(self.Norm_0(self.Conv_0(x)))
        out = F.relu(self.Norm_1(self.DeformConv2dLayer_0(out)))
        out = self.Norm_2(self.Conv_1(out))
        identity = self.Norm_3(self.Conv_2(x)) if self.has_identity else x
        return F.relu(out + identity)


class BasicConv(nn.Module):
    """A conv, or with ``deconv`` a transposed conv of output size
    ``in * stride``, then BatchNorm and ReLU (2-D; ``layers.py:481-524``,
    reference nets/feature.py:314-339; the JAX module's optional BatchNorm
    and ReLU are on in every use)."""

    def __init__(self, cin, features, kernel_size=3, stride=1, padding=0, deconv=False):
        super().__init__()
        self.deconv = deconv
        if deconv:
            # the output padding that makes the output in * stride (0 for
            # the reference's k=4, s=2, p=1)
            output_padding = stride - (kernel_size - 2 * padding)
            self.ConvTranspose_0 = ConvTranspose(cin, features, kernel_size, stride, padding,
                                                 output_padding)
        else:
            self.Conv_0 = Conv(cin, features, kernel_size, stride, padding)
        self.Norm_0 = Norm(features)

    def forward(self, x):
        conv = self.ConvTranspose_0 if self.deconv else self.Conv_0
        return F.relu(self.Norm_0(conv(x)))


class Conv2x(nn.Module):
    """A stride-2 conv (k=3) or transposed conv (k=4) to ``features``
    channels, then the skip ``rem`` merged: concatenated and fused by a 3x3
    BasicConv, or under ``mdconv`` by a deformable conv (no BatchNorm, no
    ReLU), or without ``concat`` added before the 3x3 BasicConv
    (``layers.py:527-558``, reference nets/feature.py:342-376)."""

    def __init__(self, cin, features, deconv=False, concat=True, mdconv=False):
        super().__init__()
        self.concat, self.mdconv = concat, concat and mdconv
        self.BasicConv_0 = BasicConv(cin, features, 4 if deconv else 3, 2, 1, deconv=deconv)
        if self.mdconv:
            self.DeformConv2dLayer_0 = DeformConv2dLayer(2 * features, features)
        else:
            self.BasicConv_1 = BasicConv(2 * features if concat else features, features, 3, 1, 1)

    def forward(self, x, rem):
        x = self.BasicConv_0(x)
        assert x.shape == rem.shape, (x.shape, rem.shape)
        if not self.concat:
            return self.BasicConv_1(x + rem)
        x = torch.cat([x, rem], 1)
        return self.DeformConv2dLayer_0(x) if self.mdconv else self.BasicConv_1(x)


UNET_CHANNELS = (32, 48, 64, 96, 128)  # at 1, 1/2, 1/4, 1/8 and 1/16 of the input


def unet_layers(mdconv: bool) -> list[nn.Module]:
    """The layers of the deformable UNet that GANet's extractor and the
    hourglass refinement share (``feature.py:168-202``,
    ``refinement.py:176-210``), in flax's creation order: four stride-2
    convs down from 32 channels (the last two deformable under
    ``mdconv``), then twelve Conv2x: up, down (the last two merging by
    deformable convs under ``mdconv``) and up again. Run them with
    ``unet_forward``."""
    c = UNET_CHANNELS
    down = [BasicConv(c[0], c[1], 3, 2, 1), BasicConv(c[1], c[2], 3, 2, 1)]
    if mdconv:
        down += [DeformConv2dLayer(c[2], c[3], stride=2), DeformConv2dLayer(c[3], c[4], stride=2)]
    else:
        down += [BasicConv(c[2], c[3], 3, 2, 1), BasicConv(c[3], c[4], 3, 2, 1)]
    up = lambda: [Conv2x(c[i + 1], c[i], deconv=True) for i in (3, 2, 1, 0)]  # noqa: E731
    return down + up() + [Conv2x(c[i], c[i + 1], mdconv=mdconv and i >= 2) for i in range(4)] + up()


def unet_forward(x, layers, call=None):
    """``unet_layers``' UNet on ``x`` (32 channels, H and W multiples of
    16); ``call(layer, *inputs)`` runs each layer (default: the layer
    itself)."""
    call = call or (lambda layer, *inputs: layer(*inputs))
    rem = [x]  # the skips at 1, 1/2, 1/4, 1/8, 1/16
    for layer in layers[:4]:
        x = call(layer, x)
        rem.append(x)
    for i, layer in enumerate(layers[4:8]):  # up to 1/8, ..., 1
        x = rem[3 - i] = call(layer, x, rem[3 - i])
    for i, layer in enumerate(layers[8:12]):  # down to 1/2, ..., 1/16
        x = rem[i + 1] = call(layer, x, rem[i + 1])
    for i, layer in enumerate(layers[12:]):  # up to 1/8, ..., 1
        x = call(layer, x, rem[3 - i])
    return x
