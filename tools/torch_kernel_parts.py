#!/usr/bin/env python3
"""Profile a kernel by taking parts out of it: time a kernel whole and again
with its loads, its arithmetic, its merge or its stores removed, at the
shapes of the port's paths, on one NVIDIA GPU.

    python3 tools/torch_kernel_parts.py --kernel {softargmin,warp,corrbwd,warpbwd,warpbwd32}
        [--out FILE]

Kernels: the bf16 soft-argmin forward, the bf16 warp forward, the bf16
correlation backward, and the warp backward in bf16 and float32. For each
variant (``full``: the source as it is; then one part removed at a time;
``skeleton``: every part removed) the tool copies ``csrc/``, rewrites the
kernel's source by the variant's text edits, builds every variant with nvcc
in parallel, and times the package's own wrapper with the variant's library
loaded in place of the built one (``chip_smoke.Timer``: L2 flushed, median
over CUDA events). A removed part leaves the work around it in place:
removed loads (and ``cp.async`` copies) are replaced by values made from
the indices, stored where the loads would have put them, a removed
arithmetic by a sum that keeps every load alive or a loop that runs no
trip, removed stores by a store under a condition on the values stored that
never holds. Each shape is timed once a launch and summed over the path
(``chip_smoke.SA_PATHS``, ``WARP_PATHS`` and ``CORR_PATHS``: one launch of
each listed shape; the backward kernels at the train steps' shapes). The
``full`` variant is held against the plain twin.

The edits are text written for the kernels' source; the tool fails if one
of them does not occur exactly once there.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Variant sets by kernel: (source file, {part: [(old text, new text), ...]}).
_WARP = {
    "disparity": [
        ("const float4 q = __ldcs(reinterpret_cast<const float4*>(drow + w0));",
         "const float4 q = make_float4(0.37f * w0, 0.11f * n, 0.37f * w0 + 1.f, 0.13f * n);"),
        ("if (i < n) d[i] = __ldcs(drow + w0 + i);", "if (i < n) d[i] = 0.37f * (w0 + i);"),
    ],
    "gathers": [
        ("    for (int c = 0; c < C; ++c)\n#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
         "        lo[c][i] = load_f32(irow + c * plane + x0[i]);\n"
         "        hi[c][i] = load_f32(irow + c * plane + x0[i] + 1);",
         "    for (int c = 0; c < C; ++c)\n#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
         "        lo[c][i] = 0.01f * (x0[i] + c);\n        hi[c][i] = 0.02f * x0[i];"),
    ],
    "stores": [
        ("  auto store = [&](T* dst, const float (&v)[4]) {\n",
         "  auto store = [&](T* dst, const float (&v)[4]) {\n"
         "    if (v[0] + v[1] + v[2] + v[3] != 1234.5f) return;\n"),
    ],
}
_SA_BF16 = {
    "loads": [
        ("raw[u] = live && in ? ldcs16(row + 8 * o) : make_uint4(0u, 0u, 0u, 0u);",
         "raw[u] = live && in ? make_uint4(0x3f803f80u + d0 + u, 0x3f803f80u + o, 0x3f803f80u, "
         "0x3f803f80u) : make_uint4(0u, 0u, 0u, 0u);"),
        ("w[i] = in_i ? ldcs2(row + pixel_of(o, i)) : 0u;", "w[i] = in_i ? 0x3f80u + d0 + u + i : 0u;"),
    ],
    "statistics": [
        ("    if (d0 + UNROLL <= end) {\n      st.template add<false>(raw, d0, UNROLL);\n    } else {\n"
         "      st.template add<true>(raw, d0, end - d0);\n    }",
         "#pragma unroll\n    for (int u = 0; u < UNROLL; ++u)\n      st.sum[0] += "
         "__uint_as_float((raw[u].x ^ raw[u].y ^ raw[u].z ^ raw[u].w) & 0x3fffffffu);"),
    ],
    "merge": [
        ("    st.publish(sa_part, s, lane, VEC);\n    __syncthreads();\n    if (slices == 2) {\n"
         "      merge_store<2>(sa_part, o, left, s, lane, VEC);\n    } else if (slices == 4) {\n"
         "      merge_store<4>(sa_part, o, left, s, lane, VEC);\n    } else {\n"
         "      merge_store<8>(sa_part, o, left, s, lane, VEC);\n    }",
         "    if (s == 0) {\n      st.store(o, left, lane, VEC);\n    } else if (st.sum[0] == 1234.5f) {\n"
         "      o[0] = st.wsum[0];\n    }"),
    ],
    "stores": [
        ("  if (vec && p + PL <= left) {",
         "  float all = 0.f;\n  for (int k = 0; k < PL; ++k) all += r[k];\n  if (all != 1234.5f) return;\n"
         "  if (vec && p + PL <= left) {"),
        ("    if (vec) {\n      if (8 * o < left) {",
         "    float all = 0.f;\n    for (int i = 0; i < 8; ++i) all += r[i];\n    if (all != 1234.5f) return;\n"
         "    if (vec) {\n      if (8 * o < left) {"),
    ],
}
_CORR_BWD = {
    "staging": [
        ("        stage_piece(dst0 + cc * lw + piece * q, in ? base + (c0 + cc) * plane + w : any, in, piece);",
         "        bf16* dst = dst0 + cc * lw + piece * q;\n"
         "        if (piece == 8) {\n"
         "          *reinterpret_cast<uint4*>(dst) = make_uint4(in ? cc : 0u, q, 0u, 0u);\n"
         "        } else {\n"
         "          for (int i = 0; i < piece; ++i) dst[i] = __ushort_as_bfloat16(in ? cc + i : 0);\n"
         "        }"),
    ],
    "band": [
        ("        vl[i] = d < max_disp && w0 + j < width ? __ldg(graw + at) : 0;\n"
         "        vr[i] = d < max_disp && w0 + j + d < width ? __ldg(graw + at + d) : 0;",
         "        vl[i] = d < max_disp ? 0x3c00 + d : 0;\n        vr[i] = d < max_disp ? 0x3c00 + j : 0;"),
    ],
    "contraction": [
        ("    for (int k = 0; k < nk; ++k) {\n      unsigned a[4];",
         "    for (int k = 0; k < nk * (inv_c == 1234.5f); ++k) {\n      unsigned a[4];"),
    ],
    "stores": [
        ("      copy_piece(out + j, s_out + sc * lo + j, piece);",
         "      if (__bfloat162float(s_out[sc * lo + j]) == 1234.5f) copy_piece(out + j, s_out + sc * lo + j, piece);"),
    ],
}
_WARP_BWD = {
    "disparity": _WARP["disparity"],
    "gathers": [
        ("      gradient(grow + c * plane, g[c]);\n#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
         "        lo[c][i] = load_f32(irow + c * plane + x0[i]);\n"
         "        hi[c][i] = load_f32(irow + c * plane + x0[i] + 1);",
         "      gradient(grow + c * plane, g[c]);\n#pragma unroll\n      for (int i = 0; i < 4; ++i) {\n"
         "        lo[c][i] = 0.01f * (x0[i] + c);\n        hi[c][i] = 0.02f * x0[i];"),
    ],
    "gradient": [
        ("      const float4 q = ldcs4_f32(src + w0);",
         "      const float4 q = make_float4(0.1f * w0, 0.2f, 0.3f, 0.4f);"),
        ("      for (int i = 0; i < 4; ++i) g[i] = i < n ? ldcs_f32(src + w0 + i) : 0.f;",
         "      for (int i = 0; i < 4; ++i) g[i] = 0.1f * (w0 + i);"),
    ],
    "stores": [
        ("  if (vec) {\n    *reinterpret_cast<float4*>(orow + w0) = make_float4(v[0], v[1], v[2], v[3]);",
         "  if (v[0] + v[1] + v[2] + v[3] != 1234.5f) return;\n"
         "  if (vec) {\n    *reinterpret_cast<float4*>(orow + w0) = make_float4(v[0], v[1], v[2], v[3]);"),
    ],
}
_STEPS = ("aanet step", "aanet+ step")
# by kernel: (source file, edits, the chip_smoke spec timed, the path shapes)
KERNELS = {
    "softargmin": ("softargmin.cu", _SA_BF16, "soft_argmin_bf16",
                   lambda cs: [(p, sig) for p, ss in cs.SA_PATHS.items() for sig in ss]),
    "warp": ("warp.cu", _WARP, "disp_warp_bf16",
             lambda cs: [(p, (s,)) for p, ss in cs.WARP_PATHS.items() for s in ss]),
    "corrbwd": ("correlation.cu", _CORR_BWD, "correlation_backward_bf16",
                lambda cs: [(p, sig) for p in _STEPS for sig in cs.CORR_PATHS[p]]),
    "warpbwd": ("warp.cu", _WARP_BWD, "disp_warp_backward_bf16",
                lambda cs: [("aanet step", (s,)) for s in cs.WARP_PATHS["aanet step"]]),
    "warpbwd32": ("warp.cu", _WARP_BWD, "disp_warp_backward",
                  lambda cs: [("aanet step", (s,)) for s in cs.WARP_PATHS["aanet step"]]),
}


def variants(source, parts):
    """{variant: source}: ``full``, each part removed, and ``skeleton``
    with every part removed."""
    edits = [e for es in parts.values() for e in es]
    missing = [old for old, _ in edits if source.count(old) != 1]
    if missing:
        raise SystemExit(f"these edits do not occur once in the source: {missing}")
    out = {"full": source}
    for part, es in parts.items():
        text = source
        for old, new in es:
            text = text.replace(old, new)
        out[f"no {part}"] = text
    text = source
    for old, new in edits:
        text = text.replace(old, new)
    out["skeleton"] = text
    return out


def build_variants(build, csrc, filename, sources, tmp):
    """One library a variant, nvcc in parallel; returns {variant: path}."""
    procs, paths = {}, {}
    for i, (name, text) in enumerate(sources.items()):
        src_dir = os.path.join(tmp, f"v{i}")
        shutil.copytree(csrc, src_dir)
        with open(os.path.join(src_dir, filename), "w") as f:
            f.write(text)
        paths[name] = os.path.join(tmp, f"lib_v{i}.so")
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-o", paths[name],
               os.path.join(src_dir, filename)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc, variant {name!r} (exit {proc.returncode}):\n{out}{err}")
    return paths


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kernel", choices=sorted(KERNELS), required=True)
    parser.add_argument("--out", help="also write the JSON record to this file")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke  # this tree's shapes, inputs, tolerances and timer

    from aanet_torch import _build

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    filename, parts, spec_name, shapes = KERNELS[args.kernel]
    with open(_build.CSRC / filename) as f:
        sources = variants(f.read(), parts)
    print(f"{_build.CSRC / filename}: variants {list(sources)}", flush=True)

    dev = torch.device("cuda")
    timer = chip_smoke.Timer(dev)
    fwd, bwd = chip_smoke.kernel_specs()
    by_name = {s["name"]: s for s in (fwd + bwd + chip_smoke.bf16_kernel_specs(fwd)
                                      + chip_smoke.bf16_backward_specs(bwd))}
    spec = by_name[spec_name]
    if args.kernel == "softargmin":  # over the baselines' 96-192 candidates: the float32 form's
        spec = dict(spec, tol=by_name["soft_argmin"]["tol"])
    op = getattr(spec["module"], spec["attr"])
    sigs = shapes(chip_smoke)
    lib_name = filename[: -len(".cu")]
    record = dict(kernel=args.kernel, card=smi, shapes={}, paths={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(_build, _build.CSRC, filename, sources, tmp)
        for path, sig in sigs:
            gen = torch.Generator(device=dev).manual_seed(0)
            ins, _ = spec["inputs"](sig, gen, dev)
            times = {}
            for name, lib_path in libs.items():
                lib = ctypes.CDLL(lib_path)
                lib.aanet_cuda_error_string.argtypes = [ctypes.c_int]
                lib.aanet_cuda_error_string.restype = ctypes.c_char_p
                _build._libraries[lib_name] = lib
                if name == "full":
                    got, want = op(*ins), spec["plain"](*ins)
                    got = got if isinstance(got, tuple) else (got,)
                    want = want if isinstance(want, tuple) else (want,)
                    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
                    chip_smoke.check(err <= max(spec["tol"](w) for w in want),
                                     f"{args.kernel} {sig}: error {err}")
                times[name] = timer.ms(lambda: op(*ins), iters=20)
            record["shapes"][str(sig)] = times
            for name, ms in times.items():
                record["paths"].setdefault(path, {}).setdefault(name, 0.0)
                record["paths"][path][name] += ms
            print(f"{args.kernel} {sig} ({path}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in times.items()) + " ms", flush=True)
            del ins
            torch.cuda.empty_cache()
    for path, times in record["paths"].items():
        print(f"{path}, summed ms: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(record) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
