#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aanet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit; pins float32 (TF32 off);
2. builds the four CUDA kernels from aanet_torch/csrc/ and times the build;
3. drives the ``aanet`` preset's forward (batch 1, 384x1248, float32,
   seeded random weights with non-zero offset heads and ZeroNorm scales,
   BatchNorm statistics calibrated on the input) once through the plain
   PyTorch versions of the kernels, recording every kernel call's shape,
   and holds each kernel against its plain version at each of those
   shapes on seeded inputs, timing kernel, plain version and, where one
   exists, the single PyTorch call that computes the same function;
4. sets every launch counter to 0, drives the same forward through the
   kernels, checks the launch counts and holds the pyramid against the
   plain run's; times the forward and reads its peak memory;
5. runs the ``predict`` CLI on the card on two 375x1242 PNG pairs (pad to
   a multiple of 48, crop back) with the seeded weights;
5b. the 3-D-aggregation baselines and ``stereonet-aa``: for the PSMNet
   baseline (concat volume, three 3-D hourglasses), the StereoNet baseline
   (difference volume, four 3-D convs, two refinements) and the
   ``stereonet-aa`` preset, each at 384x1248, batch 1, max_disp 192,
   seeded and calibrated: the forward through the plain twins with every
   kernel call's shape, each kernel against its twin at those shapes
   (the difference and concat volumes bit for bit), the forward through
   the kernels with its launch counts and its pyramid against the plain
   one, its latency, peak memory, idle share and top device kernels; then
   ``predict`` with the PSMNet baseline's flags on two 375x1242 pairs;
6. times each backward kernel (and each forward kernel again) against its
   plain version at the shapes that one plain train step of the ``aanet``
   preset at batch 16, 288x576 records, with the bound and, for warp,
   F.grid_sample's forward plus backward as the library yardstick;
7. runs one train step through the kernels and the same step through the
   plain twins (seeded weights, batch 2, 288x576) and compares the loss,
   every parameter's gradient and the BatchNorm statistics; every
   parameter must get a non-zero gradient, and three steps on the batch
   must lower the loss;
8. the full-width train step: batch 16, 288x576, float32, remat on; the
   launch counts of one step, then the median step time over 10 steps
   after 3 warm-ups, samples/s, peak memory and the device idle share;
9. runs ``python -m aanet_torch.cli train`` for 3 steps at batch 16 on a
   synthetic SceneFlow-layout dataset that it writes itself (48 pairs of
   540x960 PNGs with PFM disparities and filename lists), checks the
   losses and the checkpoint, and predicts with the written weights;
10. prints the kernels' JSON line and, last, {"ok": true, "device": ...}.

Any failure raises, so the exit code is non-zero and the last line is not
printed. Without CUDA, or without the aanet_torch package beside it, the
script exits non-zero before printing anything.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
DEVICE = "cuda"  # the card the run drives; without one the script fails
HEIGHT, WIDTH = 384, 1248  # KITTI, the reference's inference protocol
PREDICT_HW = (375, 1242)  # a KITTI image size that is not a multiple of 48
# one forward of the aanet preset: 6 layer3 + 9 ISA deformable convs, 3
# scales of correlation and soft-argmin, refinements at H/2 and H
EXPECTED_LAUNCHES = {"deform_conv": 15, "correlation": 3, "soft_argmin": 3, "disp_warp": 2,
                     "difference_volume": 0, "concat_volume": 0}
# the training slice: the SceneFlow crop (aanet_tpu/config.py:59-60,174) at
# the reference's per-card batch (64 over 4 cards, BASELINE.md:27)
TRAIN_HW = (288, 576)
TRAIN_BATCH = 16
COMPARE_BATCH = 2  # the kernel-vs-plain train step
# one train step with remat: the 21 deformable convs (12 of layer3 over two
# feature passes, 9 ISA) and the 2 warps run again when backward recomputes
# their checkpointed block
EXPECTED_TRAIN_LAUNCHES = {
    "deform_conv": 42, "deform_conv_backward_data": 21, "deform_conv_backward_weight": 21,
    "correlation": 3, "correlation_backward": 3, "soft_argmin": 3, "soft_argmin_backward": 3,
    "disp_warp": 4, "disp_warp_backward": 2, "difference_volume": 0, "concat_volume": 0,
}
# the 3-D-aggregation baselines (reached through the model flags, as in the
# JAX CLI) and the stereonet-aa preset, at the inference protocol's size;
# launches per forward and the pyramid's resolutions as divisors of H, W
BASELINES = {
    "psmnet": dict(
        flags=dict(feature_type="psmnet", feature_similarity="concat",
                   aggregation_type="psmnet_hourglass", refinement_type="None"),
        launches={"concat_volume": 1, "soft_argmin": 1}, levels=(1,)),
    "stereonet": dict(
        flags=dict(feature_type="stereonet", feature_similarity="difference",
                   aggregation_type="stereonet", refinement_type="stereonet"),
        launches={"difference_volume": 1, "soft_argmin": 1}, levels=(4, 2, 1)),
    "stereonet-aa": dict(
        preset="stereonet-aa",
        launches={"correlation": 1, "deform_conv": 4, "soft_argmin": 1}, levels=(4, 2, 1)),
}
CLI_PAIRS, CLI_HW = 48, (540, 960)  # SceneFlow's image size
VAL_HW = (576, 960)  # the SceneFlow recipe's validation crop (pads 540 to 576)
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, float32 FLOP/s
# outside the tensor cores (the kernels run float32 FMA on the CUDA cores)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


class Timer:
    """Median over CUDA events of ``iters`` runs after ``warmup`` runs; the
    L2 cache (50 MB) is flushed before each timed run, so every run reads
    its inputs from device memory as a layer of the forward mostly does."""

    def __init__(self, device):
        self.scratch = torch.empty(64 * 2**20, dtype=torch.float32, device=device)

    def ms(self, fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.scratch.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


# --------------------------------------------------------------------------
# The four kernel ops: their plain twins, call signatures, seeded inputs,
# tolerances, bounds and single-call yardsticks
# --------------------------------------------------------------------------


def kernel_specs():
    from aanet_torch.ops import cost_volume, deform, softargmin, warp

    def deform_sig(x, offset, mask, weight, bias=None, *, stride=1, padding=0,
                   dilation=1, deformable_groups=1):
        return (tuple(x.shape), tuple(weight.shape), mask is not None, bias is not None,
                stride, padding, dilation, deformable_groups)

    def deform_inputs(sig, gen, dev):
        xs, ws, has_mask, has_bias, stride, pad, dil, g = sig
        b, cin, h, w = xs
        cout, _, kh, kw = ws
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2 = kh * kw
        rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
        args = (
            torch.randn(xs, generator=gen, device=dev),
            rand(b, g * k2 * 2, ho, wo) * 6 - 3,  # fractional offsets in (-3, 3) px
            rand(b, g * k2, ho, wo) * 2 if has_mask else None,  # masks in (0, 2)
            torch.randn(ws, generator=gen, device=dev) / (cin * k2) ** 0.5,
            torch.randn(cout, generator=gen, device=dev) if has_bias else None,
        )
        return args, dict(stride=stride, padding=pad, dilation=dil, deformable_groups=g)

    def deform_cost(sig):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, has_bias, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        elems = (b * cin * h * w + pix * g * k2 * (3 if has_mask else 2)
                 + cout * cin * k2 + (cout if has_bias else 0) + pix * cout)
        # contraction FMAs + bilinear blend of each sample (4 mul, 3 add, 1 mask)
        flops = pix * (2 * cout * cin * k2 + 8 * cin * k2)
        return 4 * elems, flops

    def corr_inputs(sig, gen, dev):
        shape, d = sig
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev), d), {}

    def corr_cost(sig):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))  # only w >= d is computed
        return 4 * (2 * b * c * h * w + b * d * h * w), 2 * b * c * h * band

    def sa_inputs(sig, gen, dev):
        shape, match = sig
        return (torch.randn(shape, generator=gen, device=dev) * 3, match), {}

    def sa_cost(sig):
        (b, d, h, w), _ = sig
        # per element: compare, subtract, exp, add, multiply-add
        return 4 * (b * d * h * w + b * h * w), 5 * b * d * h * w

    def warp_inputs(sig, gen, dev):
        (shape,) = sig
        b, c, h, w = shape
        disp = torch.rand((b, h, w), generator=gen, device=dev) * 216 - 16  # off both edges
        return (torch.randn(shape, generator=gen, device=dev), disp), {}

    def warp_cost(sig):
        ((b, c, h, w),) = sig
        return 4 * (2 * b * c * h * w + 2 * b * h * w), b * h * w * (3 * c + 10)

    def warp_library(img, disp):
        """F.grid_sample with border padding at (x - disp, y): the warped image."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1)
        return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

    def vol_inputs(sig, gen, dev):
        shape, d = sig
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev), d), {}

    def vol_cost(sig, concat):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))  # one subtraction per w >= d
        return 4 * (2 * b * c * h * w + (2 if concat else 1) * b * c * d * h * w), (
            0 if concat else b * c * h * band)

    def rel(scale):
        return lambda ref: scale * float(ref.abs().max())

    fwd = [
        dict(name="deform_conv", module=deform, attr="modulated_deform_conv2d",
             plain=deform.modulated_deform_conv2d_plain, sig=deform_sig,
             inputs=deform_inputs, cost=deform_cost, library=None,
             tol=rel(2e-4), tol_text="2e-4 * max|ref|",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="correlation", module=cost_volume, attr="correlation_cost_volume",
             plain=cost_volume.correlation_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d),
             inputs=corr_inputs, cost=corr_cost, library=None,
             tol=lambda ref: 1e-4, tol_text="1e-4",
             source="aanet_torch/csrc/correlation.cu",
             replaces="aanet_tpu/ops/cost_volume.py:72"),
        dict(name="soft_argmin", module=softargmin, attr="soft_argmin",
             plain=softargmin.soft_argmin_plain,
             sig=lambda cost, match_similarity=True: (tuple(cost.shape), match_similarity),
             inputs=sa_inputs, cost=sa_cost, library=None,
             # float32 sums over up to 192 candidates: relative to the
             # largest disparity beyond 50 px
             tol=lambda ref: max(1e-4, 2e-6 * float(ref.abs().max())),
             tol_text="max(1e-4, 2e-6 * max|ref|)",
             source="aanet_torch/csrc/softargmin.cu",
             replaces="aanet_tpu/ops/softargmin.py:16"),
        dict(name="disp_warp", module=warp, attr="disp_warp", plain=warp.disp_warp_plain,
             sig=lambda img, disp: (tuple(img.shape),), inputs=warp_inputs, cost=warp_cost,
             library=warp_library, tol=lambda ref: 1e-5, tol_text="1e-5",
             source="aanet_torch/csrc/warp.cu", replaces="aanet_tpu/ops/warp.py:17"),
        dict(name="difference_volume", module=cost_volume, attr="difference_cost_volume",
             plain=cost_volume.difference_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d), inputs=vol_inputs,
             cost=lambda sig: vol_cost(sig, False), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu",
             replaces="aanet_tpu/ops/cost_volume.py:127"),
        dict(name="concat_volume", module=cost_volume, attr="concat_cost_volume",
             plain=cost_volume.concat_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d), inputs=vol_inputs,
             cost=lambda sig: vol_cost(sig, True), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu",
             replaces="aanet_tpu/ops/cost_volume.py:144"),
    ]

    # The backward kernels: inputs made from the forward's signature plus a
    # seeded output gradient; bounds count every input read once and every
    # gradient written once.
    def deform_bwd_inputs(sig, gen, dev):
        (x, offset, mask, weight, _), kwargs = deform_inputs(sig, gen, dev)
        b, _, ho, wo = offset.shape
        gout = torch.randn((b, weight.shape[0], ho, wo), generator=gen, device=dev)
        return (gout, x, offset, mask, weight), kwargs

    def deform_bwd_cost(sig, weight_grad):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, _, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        sampling = pix * g * k2 * (3 if has_mask else 2)
        reads = pix * cout + b * cin * h * w + sampling
        if weight_grad:  # reads + grad_w; contraction FMAs + the sampling
            return 4 * (reads + cout * cin * k2), pix * cin * k2 * (2 * cout + 8)
        # reads incl. the weight + grad_x, grad_offset, grad_mask; the gcol
        # FMAs, then per (c, k, p) the sample, its two derivatives and the
        # four scattered adds (28 operations)
        writes = b * cin * h * w + sampling
        return 4 * (reads + cout * cin * k2 + writes), pix * cin * k2 * (2 * cout + 28)

    def corr_bwd_inputs(sig, gen, dev):
        shape, d = sig
        left, right = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        b, _, h, w = shape
        return (torch.randn((b, d, h, w), generator=gen, device=dev), left, right), {}

    def corr_bwd_cost(sig):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))
        return 4 * (b * d * h * w + 4 * b * c * h * w), 4 * b * c * h * band

    def sa_bwd_inputs(sig, gen, dev):
        (b, d, h, w), match = sig
        cost = torch.randn((b, d, h, w), generator=gen, device=dev) * 3
        return (torch.randn((b, h, w), generator=gen, device=dev), cost, match), {}

    def sa_bwd_cost(sig):
        (b, d, h, w), _ = sig
        # two passes over the volume: compare, exp, sums; then exp, products
        return 4 * (b * h * w + 2 * b * d * h * w), 10 * b * d * h * w

    def warp_bwd_inputs(sig, gen, dev):
        (img, disp), _ = warp_inputs(sig, gen, dev)
        return (torch.randn(img.shape, generator=gen, device=dev), img, disp), {}

    def warp_bwd_cost(sig):
        ((b, c, h, w),) = sig
        return 4 * (2 * b * c * h * w + 2 * b * h * w), b * h * w * (3 * c + 10)

    def warp_bwd_library(grad, img, disp):
        """F.grid_sample forward plus its backward for the grid."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1)

        def run():
            with torch.enable_grad():
                g = grid.detach().requires_grad_(True)
                F.grid_sample(img, g, mode="bilinear", padding_mode="border",
                              align_corners=True).backward(grad)
        return run

    by_name = {f["name"]: f for f in fwd}
    bwd = [
        dict(name="deform_conv_backward_data", forward="deform_conv", module=deform,
             attr="modulated_deform_conv2d_backward_data",
             plain=deform.modulated_deform_conv2d_backward_data_plain,
             inputs=deform_bwd_inputs, cost=lambda sig: deform_bwd_cost(sig, False),
             library=None, tol=rel(1e-4), tol_text="1e-4 * max|ref| per gradient",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="deform_conv_backward_weight", forward="deform_conv", module=deform,
             attr="modulated_deform_conv2d_backward_weight",
             plain=deform.modulated_deform_conv2d_backward_weight_plain,
             inputs=deform_bwd_inputs, cost=lambda sig: deform_bwd_cost(sig, True),
             library=None, tol=rel(1e-4), tol_text="1e-4 * max|ref|",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="correlation_backward", forward="correlation", module=cost_volume,
             attr="correlation_cost_volume_backward",
             plain=cost_volume.correlation_cost_volume_backward_plain,
             inputs=corr_bwd_inputs, cost=corr_bwd_cost, library=None, tol=rel(1e-5),
             tol_text="1e-5 * max|ref| per gradient", source="aanet_torch/csrc/correlation.cu",
             replaces="aanet_tpu/ops/cost_volume.py:72"),
        dict(name="soft_argmin_backward", forward="soft_argmin", module=softargmin,
             attr="soft_argmin_backward", plain=softargmin.soft_argmin_backward_plain,
             inputs=sa_bwd_inputs, cost=sa_bwd_cost, library=None, tol=rel(1e-5),
             tol_text="1e-5 * max|ref|", source="aanet_torch/csrc/softargmin.cu",
             replaces="aanet_tpu/ops/softargmin.py:16"),
        dict(name="disp_warp_backward", forward="disp_warp", module=warp,
             attr="disp_warp_backward", plain=warp.disp_warp_backward_plain,
             inputs=warp_bwd_inputs, cost=warp_bwd_cost, library=warp_bwd_library,
             tol=rel(1e-5), tol_text="1e-5 * max|ref|", source="aanet_torch/csrc/warp.cu",
             replaces="aanet_tpu/ops/warp.py:17"),
    ]
    for b in bwd:
        b["sig"] = by_name[b["forward"]]["sig"]
    return fwd, bwd


@contextlib.contextmanager
def plain_ops(specs, calls=None, recomputed=None):
    """Swap each kernel op for its plain twin; count calls by signature,
    the forwards that backward recomputes (in a checkpointed block) apart
    in ``recomputed``."""
    from aanet_torch.models import layers

    def recording(spec):
        def op(*args, **kwargs):
            if calls is not None:
                first = layers._UPDATE_STATS or recomputed is None
                counter = calls if first else recomputed
                counter[spec["name"]][spec["sig"](*args, **kwargs)] += 1
            return spec["plain"](*args, **kwargs)
        return op

    with contextlib.ExitStack() as stack:
        for spec in specs:
            stack.enter_context(mock.patch.object(spec["module"], spec["attr"], recording(spec)))
        yield


def stage_breakdown(model, left, right, iters=10):
    """Median device time (CUDA events) and peak memory of each top-level
    stage of the forward, over ``iters`` forwards."""
    names = [n for n in ("feature_extractor", "fpn", "aggregation", "refinement_0", "refinement_1")
             if isinstance(getattr(model, n, None), torch.nn.Module)]
    spans = {n: [] for n in names}
    peaks = dict.fromkeys(names, 0)

    def pre(name):
        def hook(mod, inputs):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            spans[name].append([start, None])
        return hook

    def post(name):
        def hook(mod, inputs, output):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans[name][-1][1] = end
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        return hook

    handles = []
    for n in names:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(pre(n)), mod.register_forward_hook(post(n))]
    try:
        for _ in range(iters):
            model(left, right)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {n: dict(ms=statistics.median(s.elapsed_time(e) for s, e in spans[n]),
                    peak_memory_bytes=peaks[n]) for n in names}


def device_breakdown(run, iters=3, top=12):
    """``run`` under torch.profiler, ``iters`` times: per call, the window
    (CUDA events around the calls), the device busy time (the union of the
    kernels' intervals, so overlap is not counted twice), the idle share,
    and device time by kernel name for the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and e.time_range.end > e.time_range.start)
    check(spans, "the profiler recorded no device activity")
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    busy_us += cur_end - cur_start
    window_ms = start.elapsed_time(end) / iters
    busy_ms = busy_us / 1e3 / iters
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
         for e in prof.key_averages() if e.device_type == cuda),
        key=lambda r: -r[1],
    )
    return dict(window_ms=window_ms, busy_ms=busy_ms, idle_share=1.0 - busy_ms / window_ms,
                kernel_sum_ms=sum(r[1] for r in rows),
                top=[dict(kernel=name[:90], ms=ms, calls=calls) for name, ms, calls in rows[:top]])


def launches(specs):
    return {s["name"]: getattr(s["module"], s["attr"]).launches for s in specs}


def reset_launches(specs):
    for s in specs:
        getattr(s["module"], s["attr"]).launches = 0


# --------------------------------------------------------------------------
# The model: seeded weights, calibrated BatchNorm, a synthetic stereo pair
# --------------------------------------------------------------------------


def seed_weights_(model, seed):
    """Every parameter from RandomState(seed), with non-zero offset heads
    (fractional offsets, masks around 1) and non-zero ZeroNorm scales.

    The offset heads and the residual branches' ZeroNorm scales are drawn
    small. With ZeroNorm scales near 1 the random network is chaotic: the
    kernels' rounding (about 1e-6 relative) grew past the 5e-2 px
    tolerance at the final level on an H100. With small scales the
    network stays well inside it, and still runs every residual branch
    and every offset head.
    """
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 4:  # 2-D and 3-D conv kernels
                std = (0.3 if "offset_conv" in name else 1.0) / np.sqrt(p[0].numel())
                val = rs.randn(*p.shape) * std
            elif name.endswith("ZeroNorm_0.BatchNorm_0.weight"):
                val = rs.uniform(0.1, 0.3, p.shape)
            elif name.endswith("BatchNorm_0.weight"):
                val = rs.uniform(0.5, 1.5, p.shape)
            else:
                val = rs.randn(*p.shape) * 0.1
            p.copy_(torch.from_numpy(val.astype(np.float32)))


def calibrate_bn_(model, specs, left, right):
    """Set each BatchNorm's running statistics to those of its input on
    this pair, so the random network's activations stay near unit scale."""
    def hook(mod, inputs):
        x = inputs[0]
        dims = (0,) + tuple(range(2, x.ndim))
        mod.running_mean.copy_(x.mean(dims))
        mod.running_var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    try:
        with plain_ops(specs):
            model(left, right)
    finally:
        for h in handles:
            h.remove()


def stereo_pair(gen, dev, h, w, shift=20):
    """Normalised smoothed-noise images, the left one shifted by ``shift`` px."""
    from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    base = torch.rand((1, 3, h, w + shift), generator=gen, device=dev)
    base = F.avg_pool2d(base, 3, stride=1, padding=1, count_include_pad=False)
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    left = ((base[..., shift:] - mean) / std).contiguous()
    right = ((base[..., :w] - mean) / std).contiguous()
    return left, right


def write_pngs(root, n, hw, seed):
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = hw
    for sub in ("left", "right"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        base = rs.randint(0, 256, (h, w + 16, 3), dtype=np.uint8)
        Image.fromarray(base[:, 12: w + 12]).save(os.path.join(root, "left", f"{i:06d}.png"))
        Image.fromarray(base[:, :w]).save(os.path.join(root, "right", f"{i:06d}.png"))


def measure(spec, sig, n, gen, dev, timer, iters=20):
    """Hold ``spec``'s kernel against its plain version on seeded inputs of
    signature ``sig`` (``n`` launches per run of the path), output by
    output; time kernel, plain version and the library yardstick."""
    args, kwargs = spec["inputs"](sig, gen, dev)
    op = getattr(spec["module"], spec["attr"])
    got, want = op(*args, **kwargs), spec["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [(float((g - w).abs().max()), spec["tol"](w)) for g, w in zip(got, want) if w is not None]
    for err, tol in errs:
        check(err <= tol, f"{spec['name']} {sig}: max error {err} > {tol}")
    err, tol = max(errs, key=lambda e: e[0] / e[1] if e[1] > 0 else e[0])
    nbytes, flops = spec["cost"](sig)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
    lib = spec["library"](*args) if spec["library"] else None
    row = dict(
        shape=str(sig), launches=n, max_err=err, tolerance=tol,
        kernel_ms=timer.ms(lambda: op(*args, **kwargs), iters=iters),
        plain_ms=timer.ms(lambda: spec["plain"](*args, **kwargs), iters=iters),
        library_ms=timer.ms(lib, iters=iters) if lib else None,
        bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    print(f"{spec['name']} {sig} x{n}: err {err:.3g} (tol {tol:.3g}) kernel {row['kernel_ms']:.4f} ms "
          f"plain {row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} ms"
          + (f" library {row['library_ms']:.4f} ms" if lib else ""), flush=True)
    return row


def totals(rows, has_library):
    """A kernel's totals over one run of its path: each shape's time times
    that shape's launches, summed."""
    total = lambda key: sum(r[key] * r["launches"] for r in rows)  # noqa: E731
    return dict(
        ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
        library_ms=total("library_ms") if has_library else None,
        max_abs_err=max(r["max_err"] for r in rows),
    )


def train_batch(gen, dev, n, hw, max_shift=40):
    """``n`` normalised smoothed-noise pairs with a known constant disparity
    each (left[x] = right[x - d], d in [3, max_shift)) and its ground truth."""
    from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    h, w = hw
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    shifts = torch.randint(3, max_shift, (n,), generator=gen, device=dev)
    base = torch.rand((n, 3, h, w + max_shift), generator=gen, device=dev)
    base = F.avg_pool2d(base, 3, stride=1, padding=1, count_include_pad=False)
    left = base[..., :w]
    right = torch.stack([base[i, :, :, int(d): int(d) + w] for i, d in enumerate(shifts)])
    disp = shifts.view(n, 1, 1).float().expand(n, h, w).contiguous()
    return dict(left=((left - mean) / std).contiguous(), right=((right - mean) / std).contiguous(),
                disp=disp)


def write_sceneflow(root, n, hw, seed, n_val=4):
    """A SceneFlow-layout dataset: ``n`` PNG pairs with a constant disparity
    each and its PFM, and the train (all pairs) and val (the first
    ``n_val``) filename lists. Returns (data_dir, filename_root)."""
    from PIL import Image

    from aanet_torch.data.file_io import write_pfm

    rs = np.random.RandomState(seed)
    h, w = hw
    data, lists = os.path.join(root, "data"), os.path.join(root, "lists")
    for sub in ("left", "right", "disp"):
        os.makedirs(os.path.join(data, sub))
    os.makedirs(os.path.join(lists, "filenames"))
    lines = []
    for i in range(n):
        d = int(rs.randint(3, 40))
        base = rs.randint(0, 256, (h, w + d, 3), dtype=np.uint8)
        Image.fromarray(base[:, :w]).save(os.path.join(data, "left", f"{i}.png"))
        Image.fromarray(base[:, d: d + w]).save(os.path.join(data, "right", f"{i}.png"))
        write_pfm(os.path.join(data, "disp", f"{i}.pfm"), np.full((h, w), float(d), np.float32))
        lines.append(f"left/{i}.png right/{i}.png disp/{i}.pfm")
    for split, chosen in (("train", lines), ("val", lines[:n_val])):
        with open(os.path.join(lists, "filenames", f"SceneFlow_finalpass_{split}.txt"), "w") as f:
            f.write("\n".join(chosen) + "\n")
    return data, lists


def seeded_model(cfg, dev):
    model = cfg.build()
    seed_weights_(model, SEED)
    return model.to(dev)

def forward_record(name, model, left, right, plain_ms, errs, timer, smi):
    """Latency (median of 20 after 3 warm-ups, L2 flushed), peak memory,
    stage times, the dense convs' and matmuls' FLOPs (torch's flop
    counter; the hand-written kernels are not counted) and the device's
    busy time, idle share and top kernels of ``model``'s forward on
    (left, right)."""
    from torch.utils.flop_counter import FlopCounterMode

    fwd_ms = timer.ms(lambda: model(left, right))
    with FlopCounterMode(display=False) as counter:
        model(left, right)
    dense_flops = counter.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # weights, inputs, the timer's scratch
    final = model(left, right)[-1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stages = stage_breakdown(model, left, right)
    device = device_breakdown(lambda: model(left, right))
    return dict(
        config=name, batch=1, height=left.shape[2], width=left.shape[3], dtype="float32",
        latency_ms=fwd_ms, plain_latency_ms=plain_ms, dense_flops=dense_flops,
        dense_tflop_s=dense_flops / fwd_ms / 1e9, peak_memory_bytes=peak,
        resident_before_bytes=resident, forward_memory_bytes=peak - resident,
        max_err_px=errs[-1][0], mean_err_px=errs[-1][1], pyramid_err_px=errs,
        final_disp_mean=float(final.mean()), final_disp_std=float(final.std()), stages=stages,
        # cost volumes, soft-argmin, image downscaling and concatenations
        other_stage_ms=fwd_ms - sum(st["ms"] for st in stages.values()),
        device_ms=device["busy_ms"], profiled_window_ms=device["window_ms"],
        device_idle_share=device["idle_share"], top_kernels=device["top"], card=smi,
    )


def compare_pyramids(pyramid, plain_pyramid, shapes, what):
    """Shapes, finiteness, and kernel vs plain within 5e-2 px max and 5e-3
    px mean per level; returns the (max, mean) errors per level."""
    check([tuple(p.shape) for p in pyramid] == shapes,
          f"{what}: pyramid shapes {[tuple(p.shape) for p in pyramid]}, expected {shapes}")
    errs = []
    for got, want in zip(pyramid, plain_pyramid):
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite disparity")
        diff = (got - want).abs()
        errs.append((float(diff.max()), float(diff.mean())))
    check(all(mx <= 5e-2 and mn <= 5e-3 for mx, mn in errs),
          f"{what}: kernel path vs plain path (max, mean) px per level: {errs}")
    return errs


def baseline_phases(specs, gen, dev, timer, smi, left, right):
    """Phase 5b: the PSMNet and StereoNet baselines and stereonet-aa at
    384x1248. Returns, per configuration, each kernel's rows at its shapes
    and the launches of one forward through the kernels."""
    from aanet_torch import cli
    from aanet_torch.config import ModelConfig, preset

    out = {}
    for name, spec in BASELINES.items():
        cfg = preset(spec["preset"]) if "preset" in spec else ModelConfig(**spec["flags"])
        expected = {s["name"]: spec["launches"].get(s["name"], 0) for s in specs}
        model = seeded_model(cfg, dev).eval()
        calibrate_bn_(model, specs, left, right)
        calls = {s["name"]: collections.Counter() for s in specs}
        with plain_ops(specs, calls):
            plain_pyramid = model(left, right)
        with plain_ops(specs):
            plain_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
        made = {n: sum(c.values()) for n, c in calls.items()}
        check(made == expected, f"{name}: plain forward made {made}, expected {expected}")
        rows = {s["name"]: [measure(s, sig, n, gen, dev, timer) for sig, n in calls[s["name"]].items()]
                for s in specs}
        reset_launches(specs)
        pyramid = model(left, right)
        torch.cuda.synchronize()
        counts = launches(specs)
        print(f"{name} launches: {counts}", flush=True)
        check(counts == expected, f"{name}: launches {counts}, expected {expected}")
        shapes = [(1, HEIGHT // k, WIDTH // k) for k in spec["levels"]]
        errs = compare_pyramids(pyramid, plain_pyramid, shapes, name)
        record = forward_record(name, model, left, right, plain_ms, errs, timer, smi)
        print(json.dumps({"baseline_forward": record}), flush=True)
        out[name] = dict(rows=rows, launches=counts)
        if name == "psmnet":  # the predict entry point with the baseline's flags
            with tempfile.TemporaryDirectory() as tmp:
                weights = os.path.join(tmp, "weights.pt")
                torch.save(model.state_dict(), weights)
                data, pred_dir = os.path.join(tmp, "pairs"), os.path.join(tmp, "pred")
                write_pngs(data, 2, PREDICT_HW, SEED)
                flags = [f"--{k}={v}" for k, v in spec["flags"].items()]
                reset_launches(specs)
                cli.main(["predict", *flags, "--data_dir", data, "--output_dir", pred_dir,
                          "--pretrained", weights, "--device", DEVICE, "--save_type", "npy"])
                counts = launches(specs)
                check(counts == {k: 2 * v for k, v in expected.items()}, f"psmnet predict launches {counts}")
                for i in range(2):
                    pred = np.load(os.path.join(pred_dir, f"{i:06d}.npy"))
                    check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                          f"psmnet prediction {i}: shape {pred.shape}")
            print(f"psmnet predict: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]}, launches {counts}",
                  flush=True)
        del model, plain_pyramid, pyramid
        torch.cuda.empty_cache()
    return out


def train_phases(specs, bwd_specs, gen, dev, timer, smi):
    """Phases 6-9: the training slice. Returns each kernel's rows at the
    train step's shapes and its launches in one full-width train step."""
    from aanet_torch.config import preset
    from aanet_torch.models.layers import set_train_mode
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_loss_fn, make_train_step

    torch.set_grad_enabled(True)
    cfg = preset("aanet")
    all_specs = specs + bwd_specs
    model = seeded_model(cfg, dev)
    batch = train_batch(gen, dev, TRAIN_BATCH, TRAIN_HW)

    # 6. the shapes of one plain train step, and every kernel against its
    # plain version at them
    first = {s["name"]: collections.Counter() for s in specs}
    again = {s["name"]: collections.Counter() for s in specs}
    scratch = copy.deepcopy(model)
    with plain_ops(specs, first, again):
        make_train_step(scratch, make_optimizer(scratch, 1e-3), cfg.max_disp)(batch)
    torch.cuda.synchronize()
    del scratch
    made = {n: sum(first[n].values()) + sum(again[n].values()) for n in first}
    made.update({b["name"]: sum(first[b["forward"]].values()) for b in bwd_specs})
    print(f"plain train step: first forwards {dict(first)}, recomputed {dict(again)}", flush=True)
    check(made == EXPECTED_TRAIN_LAUNCHES, f"plain train step made {made}, expected {EXPECTED_TRAIN_LAUNCHES}")
    rows = {}
    for spec in specs:
        rows[spec["name"]] = [
            measure(spec, sig, n + again[spec["name"]][sig], gen, dev, timer, iters=10)
            for sig, n in first[spec["name"]].items()
        ]
    for spec in bwd_specs:
        rows[spec["name"]] = [measure(spec, sig, n, gen, dev, timer, iters=10)
                              for sig, n in first[spec["forward"]].items()]

    # 7. one train step through the kernels against the same step through
    # the plain twins: same weights, same batch (batch 2)
    small = train_batch(gen, dev, COMPARE_BATCH, TRAIN_HW)
    m_kernel = seeded_model(cfg, dev)
    m_plain, m_floor = copy.deepcopy(m_kernel), copy.deepcopy(m_kernel)
    step_kernel = make_train_step(m_kernel, make_optimizer(m_kernel, 1e-3), cfg.max_disp)
    step_plain = make_train_step(m_plain, make_optimizer(m_plain, 1e-3), cfg.max_disp)
    met_kernel = step_kernel(small)
    with plain_ops(specs):
        met_plain = step_plain(small)
        # the plain step's own spread: its gradients at a 1e-6 relative
        # change of the left image (some gradients are sums that nearly
        # cancel, and move by far more than 1e-6 under it)
        set_train_mode(m_floor)
        noise = torch.randn(small["left"].shape, generator=gen, device=dev)
        nudged = dict(small, left=small["left"] * (1 + 1e-6 * noise))
        make_loss_fn(m_floor, cfg.max_disp)(nudged)[0].backward()
    loss_k, loss_p = float(met_kernel["total_loss"]), float(met_plain["total_loss"])
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), f"train-step loss kernel {loss_k} plain {loss_p}")
    plain_params = dict(m_plain.named_parameters())
    floor_params = dict(m_floor.named_parameters())
    worst, floored, dk2, df2, dp2 = [], [], 0.0, 0.0, 0.0
    for name, p in m_kernel.named_parameters():
        gk, gp, gf = p.grad, plain_params[name].grad, floor_params[name].grad
        check(gk is not None and float(gk.abs().sum()) > 0, f"{name}: no gradient on the kernel path")
        scale = float(gp.norm())
        rel_err, spread = float((gk - gp).norm()) / scale, float((gf - gp).norm()) / scale
        check(rel_err <= max(1e-3, 2 * spread),
              f"{name}: gradient relative error {rel_err} (plain spread {spread})")
        if rel_err > 1e-3:
            floored.append((name, rel_err, spread))
        worst.append((rel_err, spread, name))
        dk2 += float((gk - gp).square().sum())
        df2 += float((gf - gp).square().sum())
        dp2 += float(gp.square().sum())
    worst = sorted(worst)[-8:]
    grad_rel, grad_spread = (dk2 / dp2) ** 0.5, (df2 / dp2) ** 0.5
    print(f"gradients: kernel vs plain {grad_rel:.3g}, plain spread {grad_spread:.3g}; "
          f"worst (error, spread, parameter): {worst}", flush=True)
    check(grad_rel <= max(1e-3, 2 * grad_spread),
          f"all gradients: relative error {grad_rel} (plain spread {grad_spread})")
    plain_bufs = dict(m_plain.named_buffers())
    stats_err = max(float(((b - plain_bufs[n]).abs() / (plain_bufs[n].abs() + 1)).max())
                    for n, b in m_kernel.named_buffers() if b.is_floating_point())
    check(stats_err <= 1e-4, f"BatchNorm statistics differ by {stats_err}")
    losses = [loss_k] + [float(step_kernel(small)["total_loss"]) for _ in range(2)]
    check(losses[-1] < losses[0], f"three steps did not lower the loss: {losses}")
    compare = dict(batch=COMPARE_BATCH, loss_kernel=loss_k, loss_plain=loss_p,
                   grad_rel_err=grad_rel, grad_plain_spread=grad_spread, worst_params=worst,
                   params_within_plain_spread_only=floored, bn_stats_rel_err=stats_err,
                   losses_three_steps=losses)
    print(json.dumps({"train_step_compare": compare}), flush=True)
    del m_kernel, m_plain, m_floor, step_kernel, step_plain

    # 8. the full-width step: the launches of one step, then the timing
    optimizer = make_optimizer(model, 1e-3)
    step = make_train_step(model, optimizer, cfg.max_disp)
    reset_launches(all_specs)
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = launches(all_specs)
    print(f"train-step launches: {counts}", flush=True)
    check(counts == EXPECTED_TRAIN_LAUNCHES, f"train-step launches {counts}, expected {EXPECTED_TRAIN_LAUNCHES}")
    step_losses = [float(metrics["total_loss"])]
    for _ in range(2):  # warm-ups 2 and 3
        step_losses.append(float(step(batch)["total_loss"]))
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch)
        end.record()
        times.append((start, end))
        step_losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times)
    step_losses = [float(x) for x in step_losses]
    check(all(np.isfinite(step_losses)), f"non-finite losses {step_losses}")
    torch.cuda.reset_peak_memory_stats(dev)
    step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    device = device_breakdown(lambda: step(batch), iters=2, top=25)
    full = dict(
        preset="aanet", batch=TRAIN_BATCH, height=TRAIN_HW[0], width=TRAIN_HW[1], dtype="float32",
        remat=cfg.remat, step_ms=step_ms, samples_per_s=TRAIN_BATCH / step_ms * 1e3,
        step_ms_all=[s.elapsed_time(e) for s, e in times], peak_memory_bytes=peak,
        device_ms=device["busy_ms"], profiled_window_ms=device["window_ms"],
        device_idle_share=device["idle_share"], launches=counts,
        losses=step_losses, top_kernels=device["top"], card=smi,
    )
    print(json.dumps({"train_step": full}), flush=True)
    del optimizer, step

    # 9. the train entry point on the card, then predict with its weights
    with tempfile.TemporaryDirectory() as tmp:
        data, lists = write_sceneflow(tmp, CLI_PAIRS, CLI_HW, SEED)
        ckpt = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "aanet_torch.cli", "train", "--preset", "aanet",
               "--data_dir", data, "--filename_root", lists, "--checkpoint_dir", ckpt,
               "--img_height", str(TRAIN_HW[0]), "--img_width", str(TRAIN_HW[1]),
               "--val_img_height", str(VAL_HW[0]), "--val_img_width", str(VAL_HW[1]),
               "--batch_size", str(TRAIN_BATCH), "--val_batch_size", "4", "--max_epoch", "1",
               "--print_freq", "1", "--num_workers", "8", "--milestones", "10", "--device", DEVICE]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
        cli_losses = [r["total_loss"] for r in records if r["kind"] == "train"]
        check(len(cli_losses) == CLI_PAIRS // TRAIN_BATCH and all(np.isfinite(cli_losses)),
              f"cli train losses {cli_losses}")
        val = [r for r in records if r["kind"] == "val"]
        latest = os.path.join(ckpt, "aanet_latest.pt")
        check(os.path.exists(latest) and len(val) == 1, f"cli train wrote {os.listdir(ckpt)}")
        pairs = os.path.join(tmp, "pairs")
        for sub in ("left", "right"):
            os.makedirs(os.path.join(pairs, sub))
            shutil.copy(os.path.join(data, sub, "0.png"), os.path.join(pairs, sub, "0.png"))
        from aanet_torch import cli

        cli.main(["predict", "--preset", "aanet", "--data_dir", pairs, "--pretrained", latest,
                  "--save_type", "npy", "--device", DEVICE])
        pred = np.load(os.path.join(pairs, "pred", "0.npy"))
        check(pred.shape == CLI_HW and np.isfinite(pred).all(), f"prediction {pred.shape}")
    print(json.dumps({"cli_train": dict(seconds=cli_s, losses=cli_losses, val=val[0],
                                        predict_shape=list(pred.shape))}), flush=True)
    return dict(rows=rows, launches=counts)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from aanet_torch import _build, cli
    from aanet_torch.config import preset

    # 1. the card, and float32 semantics
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)

    specs, bwd_specs = kernel_specs()
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.set_grad_enabled(False)

    # 3a. the model, and its forward through the plain versions
    cfg = preset("aanet")
    model = cfg.build()
    seed_weights_(model, SEED)
    model = model.to(dev).eval()
    left, right = stereo_pair(gen, dev, HEIGHT, WIDTH)
    calibrate_bn_(model, specs, left, right)
    calls = {s["name"]: collections.Counter() for s in specs}
    with plain_ops(specs, calls):
        plain_pyramid = model(left, right)
    with plain_ops(specs):
        plain_fwd_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
    check({n: sum(c.values()) for n, c in calls.items()} == EXPECTED_LAUNCHES,
          f"plain forward made {calls}, expected {EXPECTED_LAUNCHES} kernel calls")

    # 3b. each kernel against its plain version at each shape of the path
    report = [(spec, [measure(spec, sig, n, gen, dev, timer) for sig, n in calls[spec["name"]].items()])
              for spec in specs]

    # 4. the main path through the kernels
    reset_launches(specs)
    pyramid = model(left, right)
    torch.cuda.synchronize()
    counts_main = launches(specs)
    print(f"main-path launches: {counts_main}", flush=True)
    check(counts_main == EXPECTED_LAUNCHES,
          f"launches {counts_main}, expected {EXPECTED_LAUNCHES}")
    shapes = [(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)]
    errs = compare_pyramids(pyramid, plain_pyramid, shapes, "aanet")
    forward = forward_record("aanet", model, left, right, plain_fwd_ms, errs, timer, smi)
    print(json.dumps({"forward": forward}), flush=True)

    # 5. the predict entry point on the card
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), weights)
        data = os.path.join(tmp, "pairs")
        write_pngs(data, 2, PREDICT_HW, SEED)
        out = os.path.join(tmp, "pred")
        reset_launches(specs)
        t0 = time.perf_counter()
        cli.main(["predict", "--preset", "aanet", "--data_dir", data, "--output_dir", out,
                  "--pretrained", weights, "--device", DEVICE, "--save_type", "npy"])
        predict_s = time.perf_counter() - t0
        counts = launches(specs)
        check(counts == {k: 2 * v for k, v in EXPECTED_LAUNCHES.items()},
              f"predict launches {counts}")
        for i in range(2):
            pred = np.load(os.path.join(out, f"{i:06d}.npy"))
            check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                  f"prediction {i}: shape {pred.shape}")
    print(f"predict: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]} in {predict_s:.2f} s, "
          f"launches {counts}", flush=True)

    # 5b. the 3-D-aggregation baselines and stereonet-aa
    baselines = baseline_phases(specs, gen, dev, timer, smi, left, right)
    del model
    torch.cuda.empty_cache()

    train = train_phases(specs, bwd_specs, gen, dev, timer, smi)

    # 10. the record: every kernel with its totals over the path it serves
    # first: one train step of aanet (the training slice's main path), or,
    # for the 4-D volumes, one forward of the baseline that runs it; the
    # forward kernels also over one aanet inference forward and over one
    # forward of each baseline that runs them
    inference = {sp["name"]: r for sp, r in report}
    kernels = []
    for spec in specs + bwd_specs:
        name, lib = spec["name"], bool(spec["library"])
        rows, count = train["rows"][name], train["launches"][name]
        runs = {cfg: (b["rows"][name], b["launches"][name])
                for cfg, b in baselines.items() if b["launches"].get(name)}
        path = "aanet train step"
        if not count:  # a 4-D volume: its baseline's forward is its main path
            (path, (rows, count)), = runs.items()
        entry = dict(name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
                     launches=count, tolerance=spec["tol_text"], path=path, **totals(rows, lib))
        if inference.get(name):
            entry["inference"] = dict(launches=counts_main[name], **totals(inference[name], lib),
                                      shapes=inference[name])
        if path == "aanet train step" and runs:
            entry["baselines"] = {cfg: dict(launches=n, **totals(r, lib), shapes=r)
                                  for cfg, (r, n) in runs.items()}
        entry["shapes"] = rows
        kernels.append(entry)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
