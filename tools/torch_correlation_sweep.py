#!/usr/bin/env python3
"""Time the correlation cost volume's kernels (``csrc/correlation.cu``) under
every plan they take, at the shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_correlation_sweep.py [--quick] [--dtype bfloat16] [--out FILE]
        [--package DIR]

Builds ``csrc/correlation.cu`` and prints nvcc's register and spill counts
for it (``-Xptxas -v``). For each correlation of the ``aanet`` train step
(batch 16, 288x576) and inference forward (384x1248) and of
``stereonet-aa``'s (``chip_smoke.CORR_PATHS``): holds the forward and the
backward (their picked plans, ``ops.cost_volume.forward_plan`` and
``backward_plan``) against the plain
twins with ``chip_smoke``'s tolerances (forward 1e-4; backward 1e-5 *
max|ref| per gradient), checks that two launches give the same bits, and
times them with ``chip_smoke.Timer`` (L2 flushed, median over CUDA events)
beside the bound; then times every other plan of ``forward_plans`` /
``backward_plans``, each launched through the C entry point and held
against the twin. With ``--dtype bfloat16`` the same for the bf16 forms
(one bf16 ulp of max|ref|): the forward on the tensor cores under its own
plans, ``forward_plan_bf16`` picked from ``forward_plans_bf16``, the
backward under its own, ``backward_plan_bf16`` picked from
``backward_plans(..., value_bytes=2)``. ``--quick`` times the picked plans
only; ``--package DIR`` times the kernels of the ``aanet_torch`` package in
DIR (an older checkout unpacked under ``_archive/``) through its wrappers
at its own tilings, at the same shapes (implies ``--quick``). A line per
shape and kernel goes to standard output and, with ``--out``, its JSON
record (with every plan's time) to a file.
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
    """``aanet_torch``'s ``_build`` and ``ops.cost_volume`` from ``package``
    (an older checkout) or this tree, before anything else imports them."""
    if package:
        sys.path.insert(0, os.path.abspath(package))
    from aanet_torch import _build
    from aanet_torch.ops import cost_volume
    return _build, cost_volume


def launch_forward(_build, cost_volume, plan, left, right, d):
    b, c, h, w = left.shape
    out = torch.empty((b, d, h, w), device=left.device, dtype=left.dtype)
    P = _build.ptr
    if left.dtype == torch.bfloat16:  # the tensor-core kernel's plan
        args, tiling = cost_volume._CORR_MMA_ARGTYPES, (plan.tile_w, plan.chunk, plan.ntg)
    else:
        args, tiling = cost_volume._CORR_ARGTYPES, (plan.tile_w, plan.dd, plan.ksplit, plan.chunk)
    _build.launch("correlation", f"aanet_correlation_{_build.form('correlation', left.dtype)}",
                  args, P(left), P(right), P(out), b, c, h, w, d, *tiling, plan.smem_bytes,
                  left.device.index, _build.stream(left))
    return (out,)


def launch_backward(_build, cost_volume, plan, grad, left, right):
    b, c, h, w = left.shape
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    form = _build.form("correlation backward", left.dtype)
    P = _build.ptr
    _build.launch("correlation", f"aanet_correlation_backward_{form}",
                  cost_volume._CORR_BWD_ARGTYPES,
                  P(grad), P(left), P(right), P(gl), P(gr), b, c, h, w, grad.shape[1], plan.tile_w,
                  plan.chunk, plan.smem_bytes, left.device.index, _build.stream(left))
    return gl, gr


def errors(got, want, tol):
    errs = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, want)]
    tols = [tol(w) for w in want]
    for e, t in zip(errs, tols):
        chip_smoke.check(e <= t, f"error {e} > {t}")
    return max(errs), min(tols)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--quick", action="store_true", help="time the picked plans only")
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--package", help="time the kernels of the aanet_torch package in this "
                        "directory instead (no plan sweep)")
    args = parser.parse_args()
    _build, cost_volume = import_package(args.package)
    bf16 = args.dtype == "bfloat16"
    quick = args.quick or bool(args.package)
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build(("correlation",))
    ptxas = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
         str(_build.CSRC / "correlation.cu")], capture_output=True, text=True)
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
    specs = {"forward": next(s for s in fwd if s["name"] == "correlation" + suffix),
             "backward": next(s for s in bwd if s["name"] == "correlation_backward" + suffix)}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    with open(args.out or os.devnull, "w") as out:
        for path, sig in ((p, sig) for p, sigs in chip_smoke.CORR_PATHS.items() for sig in sigs):
            shape, d = sig
            b, c, h, w = shape
            for kind, spec in specs.items():
                ins, _ = spec["inputs"](sig, gen, dev)
                op = getattr(spec["module"], spec["attr"])
                want = spec["plain"](*ins)
                want = want if isinstance(want, tuple) else (want,)
                got = op(*ins)
                got = got if isinstance(got, tuple) else (got,)
                again = op(*ins)
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                err, tol = errors(got, want, spec["tol"])
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                chip_smoke.check(same, f"{kind} {sig}: two launches differ")
                bound = max(chip_smoke.bound_times(spec["cost"](sig)))
                if kind == "forward" and bf16 and hasattr(cost_volume, "forward_plan_bf16"):
                    picked = cost_volume.forward_plan_bf16(b, c, h, w, d, sms)
                    plans = cost_volume.forward_plans_bf16(b, c, h, w, d)
                    launch = launch_forward
                elif kind == "forward":
                    picked = cost_volume.forward_plan(b, c, h, w, d, sms)
                    plans, launch = cost_volume.forward_plans(b, c, h, w, d), launch_forward
                elif bf16 and hasattr(cost_volume, "backward_plan_bf16"):
                    picked = cost_volume.backward_plan_bf16(b, c, h, w, d, sms)
                    plans = cost_volume.backward_plans(b, c, h, w, d, value_bytes=2)
                    launch = launch_backward
                else:
                    picked = cost_volume.backward_plan(b, c, h, w, d, sms)
                    plans, launch = cost_volume.backward_plans(b, c, h, w, d), launch_backward
                ms = timer.ms(lambda: op(*ins), iters=10)
                row = dict(kernel=kind, shape=list(shape), max_disp=d, path=path, err=err, tol=tol,
                           identical=same, picked=picked._asdict(), picked_ms=ms, bound_ms=bound,
                           card=smi)
                totals[(path, kind)] = totals.get((path, kind), 0.0) + ms
                rows = []
                for plan in [] if quick else plans:
                    errors(launch(_build, cost_volume, plan, *ins), want, spec["tol"])
                    t = timer.ms(lambda: launch(_build, cost_volume, plan, *ins), iters=10)
                    rows.append(dict(plan._asdict(), ms=t))
                rows.sort(key=lambda r: r["ms"])
                row["plans"] = rows
                out.write(json.dumps(row) + "\n")
                print(f"{kind} {sig} ({path}): picked {ms:.4f} ms, bound {bound:.4f}; best "
                      f"{rows[0] if rows else None}", flush=True)
                del ins, want, got, again
    print("per run of the path, ms: " + json.dumps({" / ".join(k): v for k, v in totals.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
