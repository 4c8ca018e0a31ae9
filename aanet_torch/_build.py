"""Builds the CUDA kernels in ``csrc/`` with nvcc and binds them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and becomes one shared
library, ``lib<name>.so``, compiled for Hopper (``sm_90a``) at first use.
The libraries go into ``_build_out/<key>/`` beside this file, where the key
is a hash of every source in ``csrc/`` and of the nvcc flags, so an edited
source builds anew. All missing libraries build at once, one nvcc process
for each source.

There is no fallback: a missing nvcc or a failed build raises with nvcc's
own output, and a launch that CUDA refuses raises with its error code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build_out"
KERNELS = ("softargmin", "warp", "correlation", "deform_conv", "volume4d")
# Hopper's shared memory, which the kernels' plans (ops.deform, ops.cost_volume) fit
SMEM_BYTES = 232448  # one block may use (227 KB)
SM_SMEM_BYTES = 233472  # one SM holds (228 KB), 1 KB of it reserved per block
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's default prefix
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc under ``$CUDA_HOME/bin``, else on ``PATH``, else ``DEFAULT_NVCC``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        f"nvcc not found (looked in $CUDA_HOME/bin, on PATH and at {DEFAULT_NVCC}): "
        "the CUDA kernels of aanet_torch cannot be built"
    )


def build_dir() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            digest.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every library of ``names`` not yet built; return all paths."""
    out_dir = build_dir()
    paths = {n: out_dir / f"lib{n}.so" for n in names}
    missing = {n: p for n, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, path in missing.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ), tmp)
        errors = []
        for name, (proc, tmp) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{out}{err}")
            else:
                os.replace(tmp, missing[name])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.aanet_cuda_error_string.argtypes = [ctypes.c_int]
            lib.aanet_cuda_error_string.restype = ctypes.c_char_p
            _libraries[name] = lib
        return lib


def launch(name: str, symbol: str, argtypes, *args) -> None:
    """Call C entry point ``symbol`` of library ``name``; raise if CUDA
    refused the launch (the entry point returns ``cudaGetLastError()``).

    Every entry point takes the index of its tensors' device and that
    device's stream as its last two arguments, and sets that device
    current (``cudaSetDevice``). The call runs under
    ``torch.cuda.device(index)``, so the launch lands on the tensors' card
    whatever device the calling thread had current, and that device is
    current again afterwards."""
    device = args[-2]
    if not isinstance(device, int) or device < 0:
        raise ValueError(f"{symbol}: the device index argument is {device!r}")
    lib = library(name)
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        msg = lib.aanet_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


# The value types the kernels take, each the suffix of its C entry points
# (``aanet_deform_conv_f32``, ``aanet_deform_conv_bf16``,
# ``aanet_softargmin_backward_bf16``, ...)
FORMS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def form(op: str, dtype: torch.dtype) -> str:
    """The entry-point suffix of the kernel form for values of ``dtype``;
    raise for a dtype no form takes."""
    if dtype not in FORMS:
        raise TypeError(f"{op}: values of {dtype}; the kernels take "
                        + " or ".join(str(d) for d in FORMS))
    return FORMS[dtype]


def count_launch(wrapper, form_: str) -> None:
    """Add one to ``wrapper``'s count of launches of the kernel form
    ``form_``: ``launches`` for float32, ``launches_bf16`` for bf16."""
    name = "launches" if form_ == "f32" else f"launches_{form_}"
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def check_cuda(op: str, **tensors) -> None:
    """Each keyword is ``name=(tensor, dtype)``: raise unless the tensor is
    a contiguous CUDA tensor of that dtype, on the same card as the
    others."""
    first = None
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{op}: {arg} lies on {t.device}, the kernel takes CUDA tensors")
        if first is None:
            first = (arg, t.device)
        elif t.device != first[1]:
            raise ValueError(f"{op}: {arg} lies on {t.device} and {first[0]} on {first[1]}; "
                             "the kernel takes tensors of one card")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {arg} is {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {arg} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
