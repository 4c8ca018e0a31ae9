#!/usr/bin/env python3
"""Time the correlation cost volume's kernels (``csrc/correlation.cu``) under
every plan they take, at the shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_correlation_sweep.py [--quick] [--dtype bfloat16] [--out FILE]
        [--package DIR]

Builds ``csrc/correlation.cu`` and prints nvcc's register and spill counts
for it (``-Xptxas -v``). For each correlation of the paths
(``chip_smoke.CORR_PATHS``): holds the forward and the backward (their
picked plans, ``ops.cost_volume.forward_plan`` and ``backward_plan``)
against the plain twins with ``chip_smoke``'s tolerances (forward 1e-4;
backward 1e-5 * max|ref| per gradient), checks that two launches give the
same bits, and times them with ``chip_smoke.Timer`` (L2 flushed, median
over CUDA events) beside the bound; then times every other plan of
``forward_plans`` / ``backward_plans``, each launched through the C entry
point and held against the twin. With ``--dtype bfloat16`` the same for the
bf16 forms (one bf16 ulp of each output's max|ref|), both on the tensor
cores under their own plans: the forward's ``forward_plan_bf16`` of
``forward_plans_bf16``, the backward's ``backward_plan_bf16`` of
``backward_plans_bf16``. ``--quick`` times the picked plans only.

``--package DIR`` also builds the correlation library of the
``aanet_torch`` package in DIR (an older checkout, e.g. a ``git archive``
of the parent commit unpacked under ``_archive/``) and, at each shape,
times its kernels at its own plans (its ``ops/cost_volume.py``'s) and this
tree's in turns in this process (parent, this, this, parent), each launched
through its C entry point, and compares their outputs (each against the
twin, and their largest difference; implies ``--quick``). A line per shape
and kernel goes to standard output and, with ``--out``, its JSON record
(with every plan's time) to a file.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  this tree's shapes, inputs, tolerances and timer
from aanet_torch import _build  # noqa: E402
from aanet_torch.ops import cost_volume  # noqa: E402


def load_package(package, tmp):
    """The older checkout's plans (its ``ops/cost_volume.py``, loaded under
    another name) and its correlation library, built with this tree's flags."""
    root = os.path.abspath(package)
    spec = importlib.util.spec_from_file_location(
        "parent_cost_volume", os.path.join(root, "aanet_torch", "ops", "cost_volume.py"))
    plans = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plans)
    lib_path = os.path.join(tmp, "libcorrelation_parent.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(root, "aanet_torch", "csrc", "correlation.cu")], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.aanet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aanet_cuda_error_string.restype = ctypes.c_char_p
    return plans, lib


def call(lib, symbol, argtypes, *args):
    """Entry point ``symbol`` of ``lib``, or of this tree's library where
    ``lib`` is None; raises on a CUDA error."""
    if lib is None:
        return _build.launch("correlation", symbol, argtypes, *args)
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*args)
    chip_smoke.check(err == 0, f"{symbol}: CUDA error {err} ({lib.aanet_cuda_error_string(err)})")


def launch_forward(plan, left, right, d, lib=None):
    b, c, h, w = left.shape
    out = torch.empty((b, d, h, w), device=left.device, dtype=left.dtype)
    P = _build.ptr
    if left.dtype == torch.bfloat16:  # the tensor-core kernel's plan
        args, tiling = cost_volume._CORR_MMA_ARGTYPES, (plan.tile_w, plan.chunk, plan.ntg)
    else:
        args, tiling = cost_volume._CORR_ARGTYPES, (plan.tile_w, plan.dd, plan.ksplit, plan.chunk)
    call(lib, f"aanet_correlation_{_build.form('correlation', left.dtype)}", args, P(left), P(right),
         P(out), b, c, h, w, d, *tiling, plan.smem_bytes, left.device.index, _build.stream(left))
    return (out,)


def launch_backward(plan, grad, left, right, lib=None):
    b, c, h, w = left.shape
    gl, gr = torch.empty_like(left), torch.empty_like(right)
    form = _build.form("correlation backward", left.dtype)
    P = _build.ptr
    call(lib, f"aanet_correlation_backward_{form}", cost_volume._CORR_BWD_ARGTYPES, P(grad), P(left),
         P(right), P(gl), P(gr), b, c, h, w, grad.shape[1], plan.tile_w, plan.chunk, plan.smem_bytes,
         left.device.index, _build.stream(left))
    return gl, gr


def pick(module, kind, bf16, shape, d, sms):
    """The picked plan and the plan list of ``module`` (this tree's
    ``cost_volume`` or an older one's) for one kernel and dtype."""
    b, c, h, w = shape
    name = ("forward" if kind == "forward" else "backward") + "_plan" + ("_bf16" if bf16 else "")
    picked = getattr(module, name)(b, c, h, w, d, sms)
    plans = getattr(module, name.replace("_plan", "_plans"), lambda *a: [])(b, c, h, w, d)
    return picked, plans


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
                        "directory in turns with this tree's (no plan sweep)")
    args = parser.parse_args()
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
    tmp = tempfile.TemporaryDirectory()
    parent_plans, parent_lib = load_package(args.package, tmp.name) if args.package else (None, None)
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
                picked, plans = pick(cost_volume, kind, bf16, shape, d, sms)
                launch = launch_forward if kind == "forward" else launch_backward
                ms = timer.ms(lambda: op(*ins), iters=10)
                row = dict(kernel=kind, shape=list(shape), max_disp=d, path=path, err=err, tol=tol,
                           identical=same, picked=picked._asdict(), picked_ms=ms, bound_ms=bound,
                           card=smi)
                totals[(path, kind)] = totals.get((path, kind), 0.0) + ms
                line = f"{kind} {sig} ({path}): picked {ms:.4f} ms, bound {bound:.4f}"
                if parent_lib is not None:
                    old, _ = pick(parent_plans, kind, bf16, shape, d, sms)
                    theirs = launch(old, *ins, lib=parent_lib)
                    torch.cuda.synchronize()
                    errors(theirs, want, spec["tol"])
                    diff = max(float((x.float() - y.float()).abs().max()) for x, y in zip(theirs, got))
                    bits = all(torch.equal(x, y) for x, y in zip(theirs, got))
                    turns = [timer.ms(lambda: launch(p, *ins, lib=lib), iters=10)
                             for p, lib in ((old, parent_lib), (picked, None), (picked, None),
                                            (old, parent_lib))]
                    row.update(parent_plan=old._asdict(), in_turns=dict(parent=[turns[0], turns[3]],
                                                                        this=turns[1:3]),
                               parent_max_diff=diff, parent_bits_equal=bits)
                    totals[(path, kind, "parent in turns")] = (
                        totals.get((path, kind, "parent in turns"), 0.0) + (turns[0] + turns[3]) / 2)
                    totals[(path, kind, "this in turns")] = (
                        totals.get((path, kind, "this in turns"), 0.0) + (turns[1] + turns[2]) / 2)
                    line += (f"; in turns parent {turns[0]:.4f}, this {turns[1]:.4f}, {turns[2]:.4f}, "
                             f"parent {turns[3]:.4f} (outputs: the same bits {bits}, largest "
                             f"difference {diff:.3g})")
                rows = []
                for plan in [] if quick else plans:
                    errors(launch(plan, *ins), want, spec["tol"])
                    t = timer.ms(lambda: launch(plan, *ins), iters=10)
                    rows.append(dict(plan._asdict(), ms=t))
                rows.sort(key=lambda r: r["ms"])
                row["plans"] = rows
                out.write(json.dumps(row) + "\n")
                print(line + (f"; best {rows[0]}" if rows else ""), flush=True)
                del ins, want, got, again
    print("per run of the path, ms: " + json.dumps({" / ".join(k): v for k, v in totals.items()}),
          flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
