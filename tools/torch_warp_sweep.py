#!/usr/bin/env python3
"""Time the warp forward (``csrc/warp.cu``: ``warp_kernel``, bf16 and
float32) at the shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_warp_sweep.py [--out FILE] [--package DIR]

Builds ``csrc/warp.cu`` and prints nvcc's register and spill counts for it
(``-Xptxas -v``). For each warp of the paths (``chip_smoke.WARP_PATHS``: the
``aanet`` train step's two and inference's two) and the widths beyond them
(``chip_smoke.WARP_EDGE_SHAPES``): holds the bf16 kernel against the plain
twin (one bf16 ulp of max|ref|, the mask exactly), checks that two launches
give the same bits, and at the path shapes times it with ``chip_smoke.Timer``
(L2 flushed, median over CUDA events) beside the bound
(``chip_smoke.bf16_kernel_specs``' bytes), the float32 kernel and
``F.grid_sample`` in bf16. A line per shape goes to standard output and,
with ``--out``, its JSON record to a file.

With ``--package DIR`` the warp library of the ``aanet_torch`` package in
DIR (an older checkout, e.g. a ``git archive`` of the parent commit unpacked
under ``_archive/``) is built too, and at the path shapes its kernels and
this tree's are timed in turns in this process (parent, this, this, parent),
bf16 and float32, and their outputs compared bit for bit.
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
        for fn in (parent.aanet_warp_bf16, parent.aanet_warp_f32):
            fn.argtypes = warp._ARGTYPES
            fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    timer = chip_smoke.Timer(dev)
    fwd, _ = chip_smoke.kernel_specs()
    spec = next(s for s in chip_smoke.bf16_kernel_specs(fwd) if s["name"] == "disp_warp_bf16")
    P = _build.ptr

    def outputs(img):
        b, c, h, w = img.shape
        return torch.empty_like(img), torch.empty((b, 1, h, w), dtype=img.dtype, device=img.device)

    def launch(img, disp, lib=None):
        """One launch of this tree's entry point, or of ``lib``'s: the same
        arguments through ctypes, so the two are timed alike."""
        warped, valid = outputs(img)
        form = "bf16" if img.dtype == torch.bfloat16 else "f32"
        args = (P(img), P(disp), P(warped), P(valid), *img.shape, img.device.index,
                _build.stream(img))
        if lib is None:
            _build.launch("warp", f"aanet_warp_{form}", warp._ARGTYPES, *args)
        else:
            err = getattr(lib, f"aanet_warp_{form}")(*args)
            chip_smoke.check(err == 0, f"the package's warp: CUDA error {err}")
        return warped, valid

    def errors(got, want):
        (gw, gv), (ww, wv) = got, want
        err, tol = float((gw.float() - ww.float()).abs().max()), spec["tol"](ww)
        chip_smoke.check(err <= tol and torch.equal(gv, wv), f"error {err} > {tol}, or the mask differs")
        return err, tol

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    totals = {}
    shapes = [(p, s) for p, ss in chip_smoke.WARP_PATHS.items() for s in ss]
    shapes += [("beyond the paths", s) for s in chip_smoke.WARP_EDGE_SHAPES]
    with open(args.out or os.devnull, "w") as out:
        for path, shape in shapes:
            gen = torch.Generator(device=dev).manual_seed(0)
            ins, _ = spec["inputs"]((shape,), gen, dev)
            want = spec["plain"](*ins)
            got, again = warp.disp_warp(*ins), warp.disp_warp(*ins)
            torch.cuda.synchronize()
            err, tol = errors(got, want)
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            chip_smoke.check(same, f"{shape}: two launches differ")
            row = dict(shape=list(shape), path=path, err=err, tol=tol, identical=same, card=smi)
            line = f"{shape} ({path}): err {err:.3g} (tol {tol:.3g})"
            if path != "beyond the paths":
                row.update(ms=timer.ms(lambda: warp.disp_warp(*ins), iters=20),
                           bound_ms=max(chip_smoke.bound_times(spec["cost"]((shape,)))),
                           f32_kernel_ms=timer.ms(lambda: warp.disp_warp(*spec["f32_args"](ins)),
                                                  iters=20),
                           library_ms=timer.ms(spec["library"](*ins), iters=20))
                totals[path] = totals.get(path, 0.0) + row["ms"]
                line += (f" {row['ms']:.4f} ms, bound {row['bound_ms']:.4f}, float32 "
                         f"{row['f32_kernel_ms']:.4f}, F.grid_sample {row['library_ms']:.4f}")
                if parent is not None:
                    f32 = spec["f32_args"](ins)
                    for xs in (ins, f32):
                        chip_smoke.check(all(torch.equal(x, y) for x, y in
                                             zip(launch(*xs, parent), launch(*xs))),
                                         f"{shape} {xs[0].dtype}: the package's outputs differ "
                                         "from this tree's")
                    turns, turns32 = ([timer.ms(lambda: launch(*xs, lib), iters=20)
                                       for lib in (parent, None, None, parent)] for xs in (ins, f32))
                    row.update(in_turns=dict(parent=[turns[0], turns[3]], this=turns[1:3]),
                               f32_in_turns=dict(parent=[turns32[0], turns32[3]], this=turns32[1:3]),
                               parent_bits_equal=True)
                    line += (f"; in turns parent {turns[0]:.4f}, this {turns[1]:.4f}, "
                             f"{turns[2]:.4f}, parent {turns[3]:.4f} (the same bits); float32 "
                             f"in turns {', '.join(f'{t:.4f}' for t in turns32)} (the same bits)")
            out.write(json.dumps(row) + "\n")
            print(line, flush=True)
            del ins, want, got, again
            torch.cuda.empty_cache()
    print("per path, one launch of each listed shape, ms: " + json.dumps(totals), flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
