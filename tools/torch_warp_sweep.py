#!/usr/bin/env python3
"""Time the warp's kernels (``csrc/warp.cu``: ``warp_kernel`` and
``warp_bwd_kernel``, bf16 and float32) at the shapes of the port's paths, on
one NVIDIA GPU.

    python3 tools/torch_warp_sweep.py [--out FILE] [--package DIR]

Builds ``csrc/warp.cu`` and prints nvcc's register and spill counts for it
(``-Xptxas -v``). For each warp of the paths (``chip_smoke.WARP_PATHS``: the
``aanet`` train step's two and inference's two) and the widths beyond them
(``chip_smoke.WARP_EDGE_SHAPES``): holds the bf16 forward against the plain
twin (one bf16 ulp of max|ref|, the mask exactly) and the backward for the
disparity in both dtypes against theirs (1e-5 of max|ref|), checks that two
launches give the same bits, and at the path shapes times each with
``chip_smoke.Timer`` (L2 flushed, median over CUDA events) beside the bound
(``chip_smoke``'s bytes), its float32 form and ``F.grid_sample`` (in bf16;
for the backward, its forward and backward for the grid); the backward only
at the train step's shapes. A line per shape and kernel goes to standard
output and, with ``--out``, its JSON record to a file.

With ``--package DIR`` the warp library of the ``aanet_torch`` package in
DIR (an older checkout, e.g. a ``git archive`` of the parent commit unpacked
under ``_archive/``) is built too, and at the path shapes its kernels and
this tree's are timed in turns in this process (parent, this, this,
parent), bf16 and float32, each through its C entry point, and their
outputs compared bit for bit.
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


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", help="also write the JSON lines to this file")
    parser.add_argument("--package", help="time the warp of the aanet_torch package in this "
                        "directory in turns with this tree's")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # this tree's shapes, inputs, tolerances and timer
    from aanet_torch import _build
    from aanet_torch.ops import warp

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build(("warp",))
    ptxas = subprocess.run(
        [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
         str(_build.CSRC / "warp.cu")], capture_output=True, text=True)
    for line in (ptxas.stdout + ptxas.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip(), flush=True)
    parent = None
    tmp = tempfile.TemporaryDirectory()
    if args.package:
        lib = os.path.join(tmp.name, "libwarp_parent.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                        os.path.join(os.path.abspath(args.package), "aanet_torch", "csrc", "warp.cu")],
                       check=True)
        parent = ctypes.CDLL(lib)
    dev = torch.device("cuda")
    timer = chip_smoke.Timer(dev)
    fwd, bwd = chip_smoke.kernel_specs()
    specs = {"forward": next(s for s in chip_smoke.bf16_kernel_specs(fwd)
                             if s["name"] == "disp_warp_bf16"),
             "backward": next(s for s in chip_smoke.bf16_backward_specs(bwd)
                              if s["name"] == "disp_warp_backward_bf16")}
    P = _build.ptr

    def launch(kind, ins, lib=None):
        """One launch of this tree's entry point, or of ``lib``'s: the same
        arguments through ctypes, so the two are timed alike."""
        if kind == "forward":
            img, disp = ins
            b, c, h, w = img.shape
            outs = (torch.empty_like(img), torch.empty((b, 1, h, w), dtype=img.dtype, device=dev))
            ptrs, symbol = (P(img), P(disp), *map(P, outs)), "aanet_warp"
        else:
            grad, img, disp = ins
            outs = (torch.empty_like(disp),)
            ptrs, symbol = (P(grad), P(img), P(disp), P(outs[0])), "aanet_warp_backward"
        symbol += "_bf16" if img.dtype == torch.bfloat16 else "_f32"
        args = (*ptrs, *img.shape, img.device.index, _build.stream(img))
        if lib is None:
            _build.launch("warp", symbol, warp._ARGTYPES, *args)
        else:
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = warp._ARGTYPES, ctypes.c_int
            err = fn(*args)
            chip_smoke.check(err == 0, f"the package's {symbol}: CUDA error {err}")
        return outs

    def errors(spec, got, want):
        errs = [(float((g.float() - w.float()).abs().max()), spec["tol"](w)) for g, w in zip(got, want)]
        chip_smoke.check(all(e <= t for e, t in errs), f"errors {errs}")
        if len(got) == 2:  # the forward's mask: exactly
            chip_smoke.check(torch.equal(got[1], want[1]), "the mask differs")
        return max(errs)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    shapes = [(p, s) for p, ss in chip_smoke.WARP_PATHS.items() for s in ss]
    shapes += [("beyond the paths", s) for s in chip_smoke.WARP_EDGE_SHAPES]
    with open(args.out or os.devnull, "w") as out:
        for path, shape in shapes:
            for kind, spec in specs.items():
                if kind == "backward" and path not in ("aanet step", "beyond the paths"):
                    continue  # the backward runs in training only
                gen = torch.Generator(device=dev).manual_seed(0)
                ins, _ = spec["inputs"]((shape,), gen, dev)
                op = getattr(spec["module"], spec["attr"])
                spec32 = next(s for s in fwd + bwd if s["name"] == spec["name"][: -len("_bf16")])
                for sp, xs in ((spec, ins), (spec32, spec["f32_args"](ins))):  # bf16, then float32
                    dtype = "bfloat16" if xs[0].dtype == torch.bfloat16 else "float32"
                    want, got, again = sp["plain"](*xs), op(*xs), op(*xs)
                    want, got, again = (v if isinstance(v, tuple) else (v,) for v in (want, got, again))
                    torch.cuda.synchronize()
                    err, tol = errors(sp, got, want)
                    same = all(torch.equal(x, y) for x, y in zip(got, again))
                    chip_smoke.check(same, f"{kind} {dtype} {shape}: two launches differ")
                    row = dict(kernel=kind, dtype=dtype, shape=list(shape), path=path, err=err,
                               tol=tol, identical=same, card=smi)
                    line = f"{kind} {dtype} {shape} ({path}): err {err:.3g} (tol {tol:.3g})"
                    if path != "beyond the paths":
                        row.update(ms=timer.ms(lambda: op(*xs), iters=20),
                                   bound_ms=max(chip_smoke.bound_times(sp["cost"]((shape,)))),
                                   library_ms=timer.ms(sp["library"](*xs), iters=20))
                        totals[(path, kind, dtype)] = totals.get((path, kind, dtype), 0.0) + row["ms"]
                        line += (f" {row['ms']:.4f} ms, bound {row['bound_ms']:.4f}, F.grid_sample "
                                 f"{row['library_ms']:.4f}")
                        if parent is not None:
                            chip_smoke.check(all(torch.equal(x, y) for x, y in
                                                 zip(launch(kind, xs, parent), launch(kind, xs))),
                                             f"{kind} {dtype} {shape}: the package's outputs differ "
                                             "from this tree's")
                            turns = [timer.ms(lambda: launch(kind, xs, lib), iters=20)
                                     for lib in (parent, None, None, parent)]
                            row.update(in_turns=dict(parent=[turns[0], turns[3]], this=turns[1:3]),
                                       parent_bits_equal=True)
                            for who, ts in (("parent", turns[::3]), ("this", turns[1:3])):
                                key = (path, kind, dtype, f"{who} in turns")
                                totals[key] = totals.get(key, 0.0) + sum(ts) / 2
                            line += (f"; in turns parent {turns[0]:.4f}, this {turns[1]:.4f}, "
                                     f"{turns[2]:.4f}, parent {turns[3]:.4f} (the same bits)")
                    out.write(json.dumps(row) + "\n")
                    print(line, flush=True)
                del ins
                torch.cuda.empty_cache()
    print("per path, one launch of each listed shape, ms: "
          + json.dumps({" / ".join(k): v for k, v in totals.items()}), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
