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
6. prints the kernels' JSON line and, last, {"ok": true, "device": ...}.

Any failure raises, so the exit code is non-zero and the last line is not
printed. Without CUDA, or without the aanet_torch package beside it, the
script exits non-zero before printing anything.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
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
EXPECTED_LAUNCHES = {"deform_conv": 15, "correlation": 3, "soft_argmin": 3, "disp_warp": 2}
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

    def max_err(got, want):
        if isinstance(got, tuple):
            return max(max_err(g, w) for g, w in zip(got, want))
        return float((got - want).abs().max())

    return [
        dict(name="deform_conv", module=deform, attr="modulated_deform_conv2d",
             plain=deform.modulated_deform_conv2d_plain, sig=deform_sig,
             inputs=deform_inputs, cost=deform_cost, library=None,
             tol=lambda ref: 2e-4 * float(ref.abs().max()), tol_text="2e-4 * max|ref|",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112",
             max_err=max_err),
        dict(name="correlation", module=cost_volume, attr="correlation_cost_volume",
             plain=cost_volume.correlation_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d),
             inputs=corr_inputs, cost=corr_cost, library=None,
             tol=lambda ref: 1e-4, tol_text="1e-4",
             source="aanet_torch/csrc/correlation.cu",
             replaces="aanet_tpu/ops/cost_volume.py:72", max_err=max_err),
        dict(name="soft_argmin", module=softargmin, attr="soft_argmin",
             plain=softargmin.soft_argmin_plain,
             sig=lambda cost, match_similarity=True: (tuple(cost.shape), match_similarity),
             inputs=sa_inputs, cost=sa_cost, library=None,
             tol=lambda ref: 1e-4, tol_text="1e-4",
             source="aanet_torch/csrc/softargmin.cu",
             replaces="aanet_tpu/ops/softargmin.py:16", max_err=max_err),
        dict(name="disp_warp", module=warp, attr="disp_warp", plain=warp.disp_warp_plain,
             sig=lambda img, disp: (tuple(img.shape),), inputs=warp_inputs, cost=warp_cost,
             library=warp_library, tol=lambda ref: 1e-5, tol_text="1e-5",
             source="aanet_torch/csrc/warp.cu", replaces="aanet_tpu/ops/warp.py:17",
             max_err=max_err),
    ]


@contextlib.contextmanager
def plain_ops(specs, calls=None):
    """Swap each kernel op for its plain twin; count calls by signature."""
    def recording(spec):
        def op(*args, **kwargs):
            if calls is not None:
                calls[spec["name"]][spec["sig"](*args, **kwargs)] += 1
            return spec["plain"](*args, **kwargs)
        return op

    with contextlib.ExitStack() as stack:
        for spec in specs:
            stack.enter_context(mock.patch.object(spec["module"], spec["attr"], recording(spec)))
        yield


def stage_breakdown(model, left, right, iters=10):
    """Median device time (CUDA events) and peak memory of each top-level
    stage of the forward, over ``iters`` forwards."""
    names = ["feature_extractor", "fpn", "aggregation", "refinement_0", "refinement_1"]
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


def device_breakdown(model, left, right, iters=3, top=12):
    """Device time per forward by kernel name (torch.profiler), summed over
    every kernel of the forward and listed for the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            model(left, right)
        torch.cuda.synchronize()
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
         for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    return sum(r[1] for r in rows), [
        dict(kernel=name[:90], ms=ms, calls=calls) for name, ms, calls in rows[:top]
    ]


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
            if p.ndim == 4:
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
        mod.running_mean.copy_(x.mean((0, 2, 3)))
        mod.running_var.copy_(x.var((0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
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

    specs = kernel_specs()
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
    report = []
    for spec in specs:
        op = getattr(spec["module"], spec["attr"])
        shapes = []
        for sig, mult in calls[spec["name"]].items():
            args, kwargs = spec["inputs"](sig, gen, dev)
            got = op(*args, **kwargs)
            want = spec["plain"](*args, **kwargs)
            torch.cuda.synchronize()
            err = spec["max_err"](got, want)
            ref = want[0] if isinstance(want, tuple) else want
            tol = spec["tol"](ref)
            check(err <= tol, f"{spec['name']} {sig}: max error {err} > {tol}")
            nbytes, flops = spec["cost"](sig)
            bytes_ms, ops_ms = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_FLOP_S * 1e3
            bound = max(bytes_ms, ops_ms)
            lib = spec["library"](*args) if spec["library"] else None
            shapes.append(dict(
                shape=str(sig), launches=mult, max_err=err, tolerance=tol,
                kernel_ms=timer.ms(lambda: op(*args, **kwargs)),
                plain_ms=timer.ms(lambda: spec["plain"](*args, **kwargs)),
                library_ms=timer.ms(lib) if lib else None,
                bound_ms=bound, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            ))
            print(f"{spec['name']} {sig} x{mult}: err {err:.3g} (tol {tol:.3g}) "
                  f"kernel {shapes[-1]['kernel_ms']:.4f} ms plain {shapes[-1]['plain_ms']:.4f} ms "
                  f"bound {bound:.4f} ms", flush=True)
        report.append((spec, shapes))

    # 4. the main path through the kernels
    reset_launches(specs)
    pyramid = model(left, right)
    torch.cuda.synchronize()
    counts_main = launches(specs)
    print(f"main-path launches: {counts_main}", flush=True)
    check(counts_main == EXPECTED_LAUNCHES,
          f"launches {counts_main}, expected {EXPECTED_LAUNCHES}")
    hw = [(HEIGHT // 12, WIDTH // 12), (HEIGHT // 6, WIDTH // 6), (HEIGHT // 3, WIDTH // 3),
          (HEIGHT // 2, WIDTH // 2), (HEIGHT, WIDTH)]
    check([tuple(p.shape) for p in pyramid] == [(1, h, w) for h, w in hw],
          f"pyramid shapes {[tuple(p.shape) for p in pyramid]}")
    errs = []
    for got, want in zip(pyramid, plain_pyramid):
        check(bool(torch.isfinite(got).all()), "non-finite disparity")
        diff = (got - want).abs()
        errs.append((float(diff.max()), float(diff.mean())))
    check(all(mx <= 5e-2 and mn <= 5e-3 for mx, mn in errs),
          f"kernel path vs plain path (max, mean) px per level: {errs}")
    fwd_ms = timer.ms(lambda: model(left, right))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)  # weights, inputs, the timer's scratch
    model(left, right)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    stages = stage_breakdown(model, left, right)
    device_ms, top_kernels = device_breakdown(model, left, right)
    final = pyramid[-1]
    forward = dict(
        preset="aanet", batch=1, height=HEIGHT, width=WIDTH, dtype="float32",
        latency_ms=fwd_ms, plain_latency_ms=plain_fwd_ms, peak_memory_bytes=peak,
        resident_before_bytes=resident, forward_memory_bytes=peak - resident,
        max_err_px=errs[-1][0], mean_err_px=errs[-1][1],
        pyramid_err_px=errs, final_disp_mean=float(final.mean()),
        final_disp_std=float(final.std()), stages=stages,
        # cost volumes, soft-argmin, image downscaling and concatenations
        other_stage_ms=fwd_ms - sum(s["ms"] for s in stages.values()),
        # kernels run on one stream, so their summed time is the busy time
        device_ms=device_ms, device_idle_share=1.0 - device_ms / fwd_ms,
        top_kernels=top_kernels,
    )
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

    # 6. the record
    kernels = []
    for spec, shapes in report:
        # every time is the kernel's total over one forward: per-shape times
        # weighted by that shape's launches
        total = lambda key: sum(s[key] * s["launches"] for s in shapes)  # noqa: E731
        kernels.append(dict(
            name=spec["name"], route="cuda", source=spec["source"], replaces=spec["replaces"],
            launches=counts_main[spec["name"]],
            max_abs_err=max(s["max_err"] for s in shapes), tolerance=spec["tol_text"],
            ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
            library_ms=total("library_ms") if spec["library"] else None,
            shapes=shapes,
        ))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
