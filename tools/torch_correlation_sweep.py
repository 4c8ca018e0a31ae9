#!/usr/bin/env python3
"""Time the correlation cost volume's kernels (``csrc/correlation.cu``) under
every plan they take, at the shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_correlation_sweep.py [--out FILE]

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
against the twin. A line per shape and kernel goes to standard output and,
with ``--out``, its JSON record (with every plan's time) to a file.
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
from aanet_torch.ops import cost_volume  # noqa: E402

P = _build.ptr


def launch_forward(plan, left, right, d):
    b, c, h, w = left.shape
    out = torch.empty((b, d, h, w), device=left.device)
    _build.launch("correlation", "aanet_correlation_f32", cost_volume._CORR_ARGTYPES,
                  P(left), P(right), P(out), b, c, h, w, d, plan.tile_w, plan.dd, plan.ksplit,
                  plan.chunk, plan.smem_bytes, left.device.index, _build.stream(left))
    return (out,)


def launch_backward(plan, grad, left, right):
    b, c, h, w = left.shape
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    _build.launch("correlation", "aanet_correlation_backward_f32", cost_volume._CORR_BWD_ARGTYPES,
                  P(grad), P(left), P(right), P(gl), P(gr), b, c, h, w, grad.shape[1], plan.tile_w,
                  plan.chunk, plan.smem_bytes, left.device.index, _build.stream(left))
    return gl, gr


def errors(got, want, tol):
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    tols = [tol(w) for w in want]
    for e, t in zip(errs, tols):
        chip_smoke.check(e <= t, f"error {e} > {t}")
    return max(errs), min(tols)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the JSON lines to this file")
    args = parser.parse_args()
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
    specs = {"forward": next(s for s in fwd if s["name"] == "correlation"),
             "backward": next(s for s in bwd if s["name"] == "correlation_backward")}
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
                nbytes, flops = spec["cost"](sig)
                bound = max(nbytes / chip_smoke.PEAK_BYTES_S, flops / chip_smoke.PEAK_F32_FLOP_S) * 1e3
                if kind == "forward":
                    picked = cost_volume.forward_plan(b, c, h, w, d, sms)
                    plans, launch = cost_volume.forward_plans(b, c, h, w, d), launch_forward
                else:
                    picked = cost_volume.backward_plan(b, c, h, w, d, sms)
                    plans, launch = cost_volume.backward_plans(b, c, h, w, d), launch_backward
                ms = timer.ms(lambda: op(*ins), iters=10)
                row = dict(kernel=kind, shape=list(shape), max_disp=d, path=path, err=err, tol=tol,
                           identical=same, picked=picked._asdict(), picked_ms=ms, bound_ms=bound,
                           card=smi)
                totals[(path, kind)] = totals.get((path, kind), 0.0) + ms
                rows = []
                for plan in plans:
                    errors(launch(plan, *ins), want, spec["tol"])
                    t = timer.ms(lambda: launch(plan, *ins), iters=10)
                    rows.append(dict(plan._asdict(), ms=t))
                rows.sort(key=lambda r: r["ms"])
                row["plans"] = rows
                out.write(json.dumps(row) + "\n")
                print(f"{kind} {sig} ({path}): picked {ms:.4f} ms, bound {bound:.4f}; best {rows[0]}",
                      flush=True)
                del ins, want, got, again
    print("per run of the path, ms: " + json.dumps({" / ".join(k): v for k, v in totals.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
