#!/usr/bin/env python3
"""Time the deformable conv's weight-gradient kernel under many plans on one
NVIDIA GPU, beside the plan that ``ops.deform.backward_weight_plan`` picks.

    python3 tools/torch_deform_wgrad_sweep.py [--quick] [--out FILE]

For each deformable conv of the ``aanet`` and ``stereonet-aa`` train steps
(batch 16, 288x576): builds ``csrc/deform_conv.cu``, prints nvcc's register
and spill counts for it (``-Xptxas -v``), holds the op (its picked plan)
against the plain twin with ``chip_smoke``'s tolerance (1e-4 * max|ref|),
checks that two launches give bitwise the same gradient, and times every
candidate plan (tile and step heights, chunk, ksplit, register build, one
or two waves of splits),
each launched through the C entry point with a hand-made
``BackwardWeightPlan`` and held against the twin too, with
``chip_smoke.Timer`` (L2 flushed, median over CUDA events), and times the
deform forward at the same shape. ``--quick`` times only the picked plan
and the forward. One JSON
line per shape goes to standard output and, with ``--out``, to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from aanet_torch import _build  # noqa: E402
from aanet_torch.ops import deform  # noqa: E402

# (x shape, cout, stride, launches per step, path)
SHAPES = [
    ((16, 128, 48, 96), 128, 2, 2, "aanet"), ((16, 128, 24, 48), 128, 1, 10, "aanet"),
    ((16, 64, 96, 192), 64, 1, 3, "aanet"), ((16, 32, 48, 96), 32, 1, 3, "aanet"),
    ((16, 16, 24, 48), 16, 1, 3, "aanet"), ((16, 48, 72, 144), 48, 1, 4, "stereonet-aa"),
]
K, PAD, DIL, GROUPS = 3, 2, 2, 2


def candidates(batch, cin, cout, ho, wo, stride, sms):
    """Every plan the kernel takes at this shape with no idle channel, at one
    and two waves of splits."""
    co_tile, tilings = deform.weight_grad_tilings(cin, cout, K, K, stride, DIL, GROUPS)
    for tiling in tilings:
        if (cin // GROUPS) % tiling.chunk == 0:
            for waves in (1, 2):
                yield deform.weight_grad_plan_of(tiling, co_tile, batch, cin, cout, ho, wo, K, K,
                                                 GROUPS, sms, waves), waves


def launch(plan, gout, x, offset, mask, weight, stride):
    """The C entry point under ``plan``: grad_w."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    _, _, ho, wo = gout.shape
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    grad_w = torch.empty_like(weight)
    _build.launch(
        "deform_conv", "aanet_deform_conv_backward_weight_f32", deform._BWD_WEIGHT_ARGTYPES,
        _build.ptr(gout), _build.ptr(x), _build.ptr(offset), offset.stride(0), _build.ptr(mask),
        mask.stride(0), _build.ptr(ws), _build.ptr(grad_w), b, cin, h, w, cout, ho, wo, K, K,
        stride, PAD, DIL, GROUPS, plan.tile_h, plan.step_h, plan.co_tile, plan.chunk, plan.ksplit,
        plan.splits, plan.build, plan.smem_bytes, x.device.index, _build.stream(x))
    return grad_w


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build(("deform_conv",))
    ptxas = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
         str(_build.CSRC / "deform_conv.cu")], capture_output=True, text=True)
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = chip_smoke.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd, bwd = chip_smoke.kernel_specs()
    spec = next(s for s in bwd if s["name"] == "deform_conv_backward_weight")
    fwd_spec = next(s for s in fwd if s["name"] == "deform_conv")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    with open(args.out or os.devnull, "w") as out:
        for (b, cin, h, w), cout, stride, n, path in SHAPES:
            sig = ((b, cin, h, w), (cout, cin, K, K), True, False, stride, PAD, DIL, GROUPS)
            (gout, x, offset, mask, weight), kwargs = spec["inputs"](sig, gen, dev)
            _, _, ho, wo = gout.shape
            want = spec["plain"](gout, x, offset, mask, weight, **kwargs)
            tol = spec["tol"](want)
            op = deform.modulated_deform_conv2d_backward_weight
            got, again = op(gout, x, offset, mask, weight, **kwargs), op(gout, x, offset, mask, weight, **kwargs)
            err = float((got - want).abs().max())
            chip_smoke.check(err <= tol, f"{sig}: error {err} > {tol}")
            chip_smoke.check(torch.equal(got, again), f"{sig}: two launches differ")
            picked = deform.backward_weight_plan(b, cin, cout, ho, wo, K, K, stride, DIL, GROUPS, sms)
            ms = timer.ms(lambda: op(gout, x, offset, mask, weight, **kwargs), iters=10)
            totals[path] = totals.get(path, 0.0) + n * ms
            row = dict(shape=list(sig[0]), cout=cout, stride=stride, launches=n, err=err, tol=tol,
                       picked=picked._asdict(), picked_ms=ms, card=smi)
            fargs, fkw = fwd_spec["inputs"](sig, gen, dev)
            f = getattr(fwd_spec["module"], fwd_spec["attr"])
            row["forward_ms"] = timer.ms(lambda: f(*fargs, **fkw), iters=10)
            if not args.quick:
                rows = []
                for plan, waves in candidates(b, cin, cout, ho, wo, stride, sms):
                    g = launch(plan, gout, x, offset, mask, weight, stride)
                    e = float((g - want).abs().max())
                    chip_smoke.check(e <= tol, f"{sig} {plan}: error {e} > {tol}")
                    t = timer.ms(lambda: launch(plan, gout, x, offset, mask, weight, stride), iters=10)
                    rows.append(dict(tile_h=plan.tile_h, step_h=plan.step_h, chunk=plan.chunk,
                                     ksplit=plan.ksplit, build=plan.build,
                                     waves=waves, splits=plan.splits, resident=plan.resident,
                                     threads=plan.threads, smem=plan.smem_bytes, ms=t))
                rows.sort(key=lambda r: r["ms"])
                row["plans"] = rows
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            print(f"{sig[0]} x{n}: picked {picked.tile_h}/{picked.step_h}/{picked.chunk}/"
                  f"{picked.ksplit}/{picked.splits} {ms:.4f} ms; best {row.get('plans', [{}])[0]}", flush=True)
    print(f"weight gradient per step, picked plans (ms): {totals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
