#!/usr/bin/env python3
"""Time the deformable conv's weight-gradient kernel under many plans on one
NVIDIA GPU, beside the plan that ``ops.deform.backward_weight_plan`` picks
(with ``--dtype bfloat16``: the tensor-core bf16 kernel and
``backward_weight_plan_bf16``).

    python3 tools/torch_deform_wgrad_sweep.py [--quick] [--dtype bfloat16] [--out FILE]
        [--package DIR]

For each deformable conv of the ``aanet`` and ``stereonet-aa`` train steps
(batch 16, 288x576): builds ``csrc/deform_conv.cu``, prints nvcc's register
and spill counts for it (``-Xptxas -v``), holds the op (its picked plan)
against the plain twin with ``chip_smoke``'s tolerance (1e-4 * max|ref|),
checks that two launches give bitwise the same gradient, and times every
candidate plan (tile and step heights, chunk, ksplit, register build, one
or two waves of splits; in bf16 the tile height and one or two waves),
each launched through the C entry point with a hand-made
``BackwardWeightPlan`` (``BackwardWeightPlanBf16``) and held against the
twin too (in bf16 within one bf16 ulp), with
``chip_smoke.Timer`` (L2 flushed, median over CUDA events), and times the
deform forward at the same shape. ``--quick`` times only the picked plan
and the forward. With ``--package DIR`` the kernels timed are those of the
``aanet_torch`` package in DIR (an older checkout, e.g. a ``git archive`` of
the parent commit unpacked under ``_archive/``), through its wrappers at its
own tilings, at the same shapes and held against its twins (implies
``--quick``). One JSON line per shape goes to standard output and, with
``--out``, to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  this tree's shapes, inputs, tolerances and timer



def import_package(package):
    """``aanet_torch``'s ``_build`` and ``ops.deform`` from ``package`` (an
    older checkout) or this tree, before anything else imports them."""
    if package:
        sys.path.insert(0, os.path.abspath(package))
    from aanet_torch import _build
    from aanet_torch.ops import deform
    return _build, deform

# (x shape, cout, stride, launches per step, path)
SHAPES = [
    ((16, 128, 48, 96), 128, 2, 2, "aanet"), ((16, 128, 24, 48), 128, 1, 10, "aanet"),
    ((16, 64, 96, 192), 64, 1, 3, "aanet"), ((16, 32, 48, 96), 32, 1, 3, "aanet"),
    ((16, 16, 24, 48), 16, 1, 3, "aanet"), ((16, 48, 72, 144), 48, 1, 4, "stereonet-aa"),
]
K, PAD, DIL, GROUPS = 3, 2, 2, 2


def candidates(deform, batch, cin, cout, ho, wo, stride, sms):
    """Every plan the kernel takes at this shape with no idle channel, at one
    and two waves of splits."""
    co_tile, tilings = deform.weight_grad_tilings(cin, cout, K, K, stride, DIL, GROUPS)
    for tiling in tilings:
        if (cin // GROUPS) % tiling.chunk == 0:
            for waves in (1, 2):
                yield deform.weight_grad_plan_of(tiling, co_tile, batch, cin, cout, ho, wo, K, K,
                                                 GROUPS, sms, waves), waves


def candidates_bf16(deform, batch, cin, cout, ho, wo, stride, sms):
    """Every plan the bf16 kernel takes at this shape: each tile height whose
    shared memory fits a block, at one and two waves of splits."""
    picked = deform.backward_weight_plan_bf16(batch, cin, cout, ho, wo, K, K, stride, PAD, DIL,
                                              GROUPS, sms)
    units = lambda tile_h: batch * -(-ho // tile_h) * -(-wo // deform.TILE_W)  # noqa: E731
    base = picked.blocks // picked.splits
    for tile_h in deform.MMA_WG_TILE_H:
        win_h = (tile_h - 1) * stride + (K - 1) * DIL + 2 * deform.HALO + 2
        smem = deform._wgrad_mma_smem(picked.co_tile, win_h, picked.win_w, PAD)
        if smem > deform.SMEM_BYTES:
            continue
        resident = min(picked.build, deform.SM_SMEM_BYTES // (smem + 1024))
        for waves in (1, 2):
            splits = max(1, min(units(tile_h), waves * sms * resident // base, 65535))
            yield picked._replace(tile_h=tile_h, win_h=win_h, smem_bytes=smem, resident=resident,
                                  splits=splits, blocks=base * splits,
                                  workspace=splits * cout * cin * K * K), waves


def launch(_build, deform, plan, gout, x, offset, mask, weight, stride):
    """The C entry point under ``plan`` (a float32 or a bf16 plan): grad_w."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    _, _, ho, wo = gout.shape
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    grad_w = torch.empty_like(weight)
    if isinstance(plan, deform.BackwardWeightPlanBf16):
        symbol, argtypes = "aanet_deform_conv_backward_weight_bf16", deform._BWD_WEIGHT_BF16_ARGTYPES
        tiling = (plan.tile_h, plan.co_tile, plan.splits)
    else:
        symbol, argtypes = "aanet_deform_conv_backward_weight_f32", deform._BWD_WEIGHT_ARGTYPES
        tiling = (plan.tile_h, plan.step_h, plan.co_tile, plan.chunk, plan.ksplit, plan.splits)
    _build.launch(
        "deform_conv", symbol, argtypes,
        _build.ptr(gout), _build.ptr(x), _build.ptr(offset), offset.stride(0), _build.ptr(mask),
        mask.stride(0), _build.ptr(ws), _build.ptr(grad_w), b, cin, h, w, cout, ho, wo, K, K,
        stride, PAD, DIL, GROUPS, *tiling, plan.build, plan.smem_bytes, x.device.index,
        _build.stream(x))
    return grad_w


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--package", help="time the kernels of the aanet_torch package in this "
                        "directory instead (no plan sweep)")
    args = parser.parse_args()
    _build, deform = import_package(args.package)
    bf16 = args.dtype == "bfloat16"
    quick = args.quick or bool(args.package)
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
    if bf16:
        fwd, bwd = chip_smoke.bf16_kernel_specs(fwd), chip_smoke.bf16_backward_specs(bwd)
    suffix = "_bf16" if bf16 else ""
    spec = next(s for s in bwd if s["name"] == "deform_conv_backward_weight" + suffix)
    fwd_spec = next(s for s in fwd if s["name"] == "deform_conv" + suffix)
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
            err = float((got.float() - want.float()).abs().max())
            chip_smoke.check(err <= tol, f"{sig}: error {err} > {tol}")
            chip_smoke.check(torch.equal(got, again), f"{sig}: two launches differ")
            if bf16 and hasattr(deform, "backward_weight_plan_bf16"):
                picked = deform.backward_weight_plan_bf16(b, cin, cout, ho, wo, K, K, stride, PAD,
                                                          DIL, GROUPS, sms)
            else:
                picked = deform.backward_weight_plan(b, cin, cout, ho, wo, K, K, stride, DIL,
                                                     GROUPS, sms)
            ms = timer.ms(lambda: op(gout, x, offset, mask, weight, **kwargs), iters=10)
            totals[path] = totals.get(path, 0.0) + n * ms
            row = dict(shape=list(sig[0]), cout=cout, stride=stride, launches=n, err=err, tol=tol,
                       picked=picked._asdict(), picked_ms=ms, card=smi)
            fargs, fkw = fwd_spec["inputs"](sig, gen, dev)
            f = getattr(fwd_spec["module"], fwd_spec["attr"])
            row["forward_ms"] = timer.ms(lambda: f(*fargs, **fkw), iters=10)
            if not quick:
                rows = []
                plans = (candidates_bf16 if bf16 else candidates)(deform, b, cin, cout, ho, wo,
                                                                  stride, sms)
                for plan, waves in plans:
                    g = launch(_build, deform, plan, gout, x, offset, mask, weight, stride)
                    e = float((g.float() - want.float()).abs().max())
                    chip_smoke.check(e <= tol, f"{sig} {plan}: error {e} > {tol}")
                    t = timer.ms(lambda: launch(_build, deform, plan, gout, x, offset, mask, weight,
                                                stride), iters=10)
                    rows.append(dict(plan._asdict(), waves=waves, ms=t))
                rows.sort(key=lambda r: r["ms"])
                row["plans"] = rows
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            print(f"{sig[0]} x{n}: picked {picked} {ms:.4f} ms; best {row.get('plans', [{}])[0]}",
                  flush=True)
    print(f"weight gradient per step, picked plans (ms): {totals}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
