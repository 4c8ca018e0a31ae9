#!/usr/bin/env python3
"""Time the soft-argmin kernels (``csrc/softargmin.cu``) under every plan
they take, at the shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_softargmin_sweep.py [--quick] [--dtype bfloat16] [--out FILE]
        [--package DIR]

Builds ``csrc/softargmin.cu`` and prints nvcc's register and spill counts
for it (``-Xptxas -v``). For each soft-argmin of the paths
(``chip_smoke.SA_PATHS``: the ``aanet`` train step and inference forward,
the baselines' and ``stereonet-aa``'s forwards and train steps): holds the
forward and the backward (their picked plans, ``ops.softargmin.forward_plan``
and ``backward_plan``) against the plain twins with ``chip_smoke``'s
tolerances (forward max(1e-4, 2e-6 * max|ref|); backward 1e-5 * max|ref|),
checks that two launches give the same bits, and times them with
``chip_smoke.Timer`` (L2 flushed, median over CUDA events) beside the
bound, and again after a flush that leaves the L2 clean
(``Timer(clean=True)``); then times every other plan of ``forward_plans`` /
``backward_plans``, each launched through the C entry point and held
against the twin; last, each kernel at a volume of one tile and one
candidate (the timer's floor for one launch). A line per shape and kernel
goes to standard output and, with ``--out``, its JSON record (with every
plan's time) to a file. With ``--dtype bfloat16`` the same for the bf16
forms (a bf16 volume; the forward within the float32 form's tolerance, the
backward within one bf16 ulp of max|ref|): the forward, a kernel of its
own, under ``forward_plan_bf16`` picked from ``forward_plans_bf16``
(tiles of 256 pixels, 1 to 8 slices), the backward under ``backward_plan_bf16``
picked from ``backward_plans(..., value_bytes=2)`` (the raw bf16 slab).
``--quick`` times the picked plans only.

With ``--package DIR`` the kernels timed are those of the ``aanet_torch``
package in DIR (an older checkout, e.g. a ``git archive`` of the parent
commit unpacked under ``_archive/``), through its wrappers at its own
tilings, at the same shapes and held against its twins: no plans are swept.
For the float32 forms this tree's ``softargmin.cu`` is built too and its
kernels, launched at the package's plans, must give the package's bits; they
are timed beside the package's in the same process, on the same inputs, in
turns (package, this, this, package).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def errors(got, want, tol):
    err, bound = float((got.float() - want.float()).abs().max()), tol(want)
    if err > bound:
        raise RuntimeError(f"error {err} > {bound}")
    return err, bound


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    parser.add_argument("--quick", action="store_true", help="time the picked plans only")
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--package", help="time the kernels of the aanet_torch package in this "
                        "directory instead (no plan sweep)")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # this tree's shapes, inputs, tolerances and timer

    if args.package:  # its aanet_torch comes first on the path
        sys.path.insert(0, os.path.abspath(args.package))
    from aanet_torch import _build
    from aanet_torch.ops import softargmin

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"kernels of {os.path.dirname(os.path.dirname(softargmin.__file__))}", flush=True)
    _build.build(("softargmin",))
    bf16 = args.dtype == "bfloat16"
    sweep = not (args.package or args.quick)
    if sweep:
        ptxas = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
             str(_build.CSRC / "softargmin.cu")], capture_output=True, text=True)
        for line in (ptxas.stdout + ptxas.stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(line.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = chip_smoke.Timer(dev)
    clean = chip_smoke.Timer(dev, clean=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd, bwd = chip_smoke.kernel_specs()
    sa32 = next(s for s in fwd if s["name"] == "soft_argmin")
    if bf16:
        fwd, bwd = chip_smoke.bf16_kernel_specs(fwd), chip_smoke.bf16_backward_specs(bwd)
    suffix, form = ("_bf16", "bf16") if bf16 else ("", "f32")
    specs = {"forward": next(s for s in fwd if s["name"] == "soft_argmin" + suffix),
             "backward": next(s for s in bwd if s["name"] == "soft_argmin_backward" + suffix)}
    # the bf16 forward over the baselines' 96-192 candidates with the float32
    # form's tolerance, as chip_smoke.py's phase 16 holds it
    specs["forward"] = dict(specs["forward"], tol=sa32["tol"])
    P = _build.ptr

    def launch_forward(plan, cost, match):
        b, d, h, w = cost.shape
        out = torch.empty((b, h, w), device=cost.device)
        _build.launch("softargmin", f"aanet_softargmin_{form}", softargmin._ARGTYPES, P(cost),
                      P(out), b, d, h * w, int(not match), plan.tile, plan.slices,
                      plan.smem_bytes, cost.device.index, _build.stream(cost))
        return out

    def launch_backward(plan, grad, cost, match):
        b, d, h, w = cost.shape
        out = torch.empty_like(cost)
        _build.launch("softargmin", f"aanet_softargmin_backward_{form}",
                      softargmin._BWD_ARGTYPES, P(grad), P(cost), P(out), b, d, h * w,
                      int(not match), plan.tile, plan.slices, plan.smem_bytes, cost.device.index,
                      _build.stream(cost))
        return out

    # this tree's float32 kernels, to be held bit for bit against an older package's
    this, tmp = None, tempfile.TemporaryDirectory()
    if args.package and not bf16:
        lib = os.path.join(tmp.name, "libsoftargmin_this.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                        os.path.join(ROOT, "aanet_torch", "csrc", "softargmin.cu")], check=True)
        this = ctypes.CDLL(lib)
        this.aanet_softargmin_f32.argtypes = softargmin._ARGTYPES
        this.aanet_softargmin_backward_f32.argtypes = softargmin._BWD_ARGTYPES

    def this_tree(kind, ins):
        """This tree's float32 kernel at the package's plan."""
        if kind == "forward":
            cost, match = ins
            b, d, h, w = cost.shape
            plan, fn, args_ = softargmin.forward_plan(b, d, h * w, sms), this.aanet_softargmin_f32, ()
            out_ = torch.empty((b, h, w), device=cost.device)
        else:
            grad, cost, match = ins
            b, d, h, w = cost.shape
            plan, fn = softargmin.backward_plan(b, d, h * w, sms), this.aanet_softargmin_backward_f32
            out_, args_ = torch.empty_like(cost), (P(grad),)
        err = fn(*args_, P(cost), P(out_), b, d, h * w, int(not match), plan.tile, plan.slices,
                 plan.smem_bytes, cost.device.index, _build.stream(cost))
        chip_smoke.check(err == 0, f"this tree's {kind}: CUDA error {err}")
        return out_

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    with open(args.out or os.devnull, "w") as out:
        for path, sig in ((p, sig) for p, sigs in chip_smoke.SA_PATHS.items() for sig in sigs):
            (b, d, h, w), match = sig
            for kind, spec in specs.items():
                ins, _ = spec["inputs"](sig, gen, dev)
                op = getattr(spec["module"], spec["attr"])
                want = spec["plain"](*ins)
                got, again = op(*ins), op(*ins)
                torch.cuda.synchronize()
                err, tol = errors(got, want, spec["tol"])
                same = torch.equal(got, again)
                chip_smoke.check(same, f"{kind} {sig}: two launches differ")
                if this is not None:
                    chip_smoke.check(torch.equal(this_tree(kind, ins), got),
                                     f"{kind} {sig}: this tree's float32 kernel gives other bits")
                del got, again
                bound = max(chip_smoke.bound_times(spec["cost"](sig)))
                ms = timer.ms(lambda: op(*ins), iters=10)
                ms_clean = clean.ms(lambda: op(*ins), iters=10)
                row = dict(kernel=kind, shape=[b, d, h, w], match_similarity=match, path=path,
                           err=err, tol=tol, identical=same, ms=ms, ms_clean_l2=ms_clean,
                           bound_ms=bound, card=smi, this_tree_bits_equal=this is not None or None)
                if this is not None:
                    row["in_turns"] = [timer.ms(fn, iters=10) for fn in (
                        lambda: op(*ins), lambda: this_tree(kind, ins), lambda: this_tree(kind, ins),
                        lambda: op(*ins))]
                totals[(path, kind)] = totals.get((path, kind), 0.0) + ms
                best = ""
                if sweep:
                    if kind == "forward" and bf16:
                        picked = softargmin.forward_plan_bf16(b, d, h * w, sms)
                        plans = softargmin.forward_plans_bf16(b, d, h * w)
                        launch = launch_forward
                    elif kind == "forward":
                        picked = softargmin.forward_plan(b, d, h * w, sms)
                        plans, launch = softargmin.forward_plans(b, d, h * w), launch_forward
                    elif bf16:
                        picked = softargmin.backward_plan_bf16(b, d, h * w, sms)
                        plans = softargmin.backward_plans(b, d, h * w, value_bytes=2)
                        launch = launch_backward
                    else:
                        picked = softargmin.backward_plan(b, d, h * w, sms)
                        plans, launch = softargmin.backward_plans(b, d, h * w), launch_backward
                    rows = []
                    for plan in plans:
                        errors(launch(plan, *ins), want, spec["tol"])
                        t = timer.ms(lambda: launch(plan, *ins), iters=10)
                        rows.append(dict(plan._asdict(), ms=t))
                    rows.sort(key=lambda r: r["ms"])
                    row.update(picked=picked._asdict(), plans=rows)
                    best = f" ({picked.tile}/{picked.slices}); best {rows[0]}"
                out.write(json.dumps(row) + "\n")
                turns = (", in turns with this tree's (package, this, this, package) "
                         + ", ".join(f"{t:.4f}" for t in row["in_turns"])) if this is not None else ""
                print(f"{kind} {sig} ({path}): err {err:.3g} (tol {tol:.3g}) {ms:.4f} ms "
                      f"({ms_clean:.4f} after a clean flush), bound {bound:.4f}{best}{turns}",
                      flush=True)
                del ins, want
                torch.cuda.empty_cache()
    # the timer's floor for one launch: a volume of one candidate and one tile
    for kind, spec in specs.items():
        ins, _ = spec["inputs"](((1, 1, 1, 128), True), gen, dev)
        op = getattr(spec["module"], spec["attr"])
        print(f"{kind} at [1, 1, 1, 128]: {timer.ms(lambda: op(*ins), iters=10):.4f} ms "
              f"({clean.ms(lambda: op(*ins), iters=10):.4f} after a clean flush)", flush=True)
    print("per path, one launch of each listed shape, ms: "
          + json.dumps({" / ".join(k): v for k, v in totals.items()}), flush=True)
    if this is not None:
        print("this tree's float32 kernels gave the package's bits at every shape", flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
