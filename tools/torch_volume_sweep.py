#!/usr/bin/env python3
"""Time the 4-D cost-volume kernels (``csrc/volume4d.cu``: the difference
and concat volumes, forward and backward) under every plan they take, at the
shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_volume_sweep.py [--out FILE] [--package DIR] [--picked]

Builds ``csrc/volume4d.cu`` and prints nvcc's register and spill counts for
it (``-Xptxas -v``). For each volume of the paths (``chip_smoke.VOL_PATHS``:
the PSMNet, GC-Net and StereoNet forwards at 384x1248 and their train steps
at 288x576): holds the forward and the backward (their picked plans,
``ops.cost_volume.volume_forward_plan`` and ``volume_backward_plan``)
against the plain twins bit for bit, checks that two launches give the same
bits, and times them with ``chip_smoke.Timer`` (L2 flushed, median over CUDA
events) beside the bound (``chip_smoke``'s ``vol_cost`` / ``vol_bwd_cost``);
then times every other plan of ``volume_forward_plans`` /
``volume_backward_plans``, each launched through the C entry point and held
against the twin bit for bit. A line per shape and kernel goes to standard
output and, with ``--out``, its JSON record (with every plan's time) to a
file. ``--picked`` times the picked plans only.

With ``--package DIR`` the kernels timed are those of the ``aanet_torch``
package in DIR (an older checkout, e.g. a ``git archive`` of the parent
commit unpacked under ``_archive/``), through its wrappers at its own
tilings, at the same shapes and held against its twins: no plans are swept.
Run parent, change, change, parent in one call to compare the two.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--package", help="time the kernels of the aanet_torch package in this "
                        "directory instead (no plan sweep)")
    parser.add_argument("--picked", action="store_true", help="time the picked plans only")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # this tree's shapes, inputs, bounds and timer

    if args.package:  # its aanet_torch comes first on the path
        sys.path.insert(0, os.path.abspath(args.package))
    from aanet_torch import _build
    from aanet_torch.ops import cost_volume

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"kernels of {os.path.dirname(os.path.dirname(cost_volume.__file__))}", flush=True)
    _build.build(("volume4d",))
    sweep = not args.package and not args.picked
    if not args.package:
        ptxas = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
             str(_build.CSRC / "volume4d.cu")], capture_output=True, text=True)
        for line in (ptxas.stdout + ptxas.stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(line.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timer = chip_smoke.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd, bwd = chip_smoke.kernel_specs()
    by_name = {s["name"]: s for s in fwd + bwd}
    P = _build.ptr

    def launch_forward(kind, plan, left, right, d):
        b, c, h, w = left.shape
        out = torch.empty((b, (2 if kind == "concat" else 1) * c, d, h, w), device=left.device)
        _build.launch("volume4d", f"aanet_{kind}_volume_f32", cost_volume._VOL_ARGTYPES,
                      P(left), P(right), P(out), b, c, h, w, d, plan.dchunk, left.device.index,
                      _build.stream(left))
        return out

    def launch_backward(kind, plan, grad, left, right):
        b, c, h, w = left.shape
        gl, gr = torch.empty_like(left), torch.empty_like(right)
        _build.launch("volume4d", f"aanet_{kind}_volume_backward_f32",
                      cost_volume._VOL_BWD_ARGTYPES, P(grad), P(gl), P(gr), b, c, h, w,
                      grad.shape[2], plan.rows, plan.tile, plan.smem_bytes,
                      left.device.index, _build.stream(left))
        return gl, gr

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(torch.equal(g, w) for g, w in zip(got, want))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    with open(args.out or os.devnull, "w") as out:
        for path, (sig, concat) in chip_smoke.VOL_PATHS.items():
            (b, c, h, w), d = sig
            kind = "concat" if concat else "difference"
            for direction in ("forward", "backward"):
                spec = by_name[f"{kind}_volume" + ("_backward" if direction == "backward" else "")]
                ins, _ = spec["inputs"](sig, gen, dev)
                op = getattr(spec["module"], spec["attr"])
                want = spec["plain"](*ins)
                got, again = op(*ins), op(*ins)
                torch.cuda.synchronize()
                chip_smoke.check(same(got, want), f"{kind} {direction} {sig}: differs from the twin")
                chip_smoke.check(same(got, again), f"{kind} {direction} {sig}: two launches differ")
                del got, again
                nbytes, flops = spec["cost"](sig)
                bound = max(nbytes / chip_smoke.PEAK_BYTES_S,
                            flops / chip_smoke.PEAK_F32_FLOP_S) * 1e3
                ms = timer.ms(lambda: op(*ins), iters=10)
                row = dict(kernel=f"{kind} {direction}", shape=[b, c, h, w], max_disp=d, path=path,
                           bitwise=True, identical=True, ms=ms, bound_ms=bound, card=smi)
                totals[f"{path} / {direction}"] = ms
                best = ""
                if sweep:
                    if direction == "forward":
                        picked = cost_volume.volume_forward_plan(b, c, h, w, d, sms)
                        plans = cost_volume.volume_forward_plans(b, c, h, w, d)
                        launch = lambda p: launch_forward(kind, p, *ins)  # noqa: E731
                    else:
                        picked = cost_volume.volume_backward_plan(b, c, h, w, concat, sms)
                        plans = cost_volume.volume_backward_plans(b, c, h, w, concat)
                        launch = lambda p: launch_backward(kind, p, *ins)  # noqa: E731
                    rows = []
                    for plan in plans:
                        chip_smoke.check(same(launch(plan), want),
                                         f"{kind} {direction} {sig} under {plan}: differs from the twin")
                        t = timer.ms(lambda: launch(plan), iters=10)
                        rows.append(dict(plan._asdict(), ms=t))
                    rows.sort(key=lambda r: r["ms"])
                    row.update(picked=picked._asdict(), plans=rows)
                    best = f" ({tuple(picked)[:-1]}); best {rows[0]}"
                out.write(json.dumps(row) + "\n")
                print(f"{kind} {direction} {sig} ({path}): bitwise, {ms:.4f} ms, bound {bound:.4f}"
                      f"{best}", flush=True)
                del ins, want
                torch.cuda.empty_cache()
    print("per path, one launch, ms: " + json.dumps(totals), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
