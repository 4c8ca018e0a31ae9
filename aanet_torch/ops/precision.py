"""Mixed-precision policy (aanet_tpu/ops/precision.py).

A module-level compute dtype is consulted by every layer wrapper when it
runs (``aanet_torch.models.layers``). ``AANet.forward`` installs the
model's configured dtype for the duration of the forward, so one flag on
the model flips the whole network; parameters and BatchNorm statistics
stay float32, and the numerically sensitive places compute in float32
whatever the compute dtype: the deformable convs' offset heads and sample
coordinates, soft-argmin, the refinements' ``disp + residual``, the
disparity upsampling, the losses and the metrics.

The layers cast explicitly, as flax's ``dtype=`` arguments do, rather
than under ``torch.autocast``, whose per-op lists are not flax's: a conv
promotes its input, kernel and bias to the compute dtype; a BatchNorm
normalises in float32 and returns the compute dtype. ``None`` means no
policy: every layer keeps its input's dtype (float32). ``"float32"`` is
that same default, as ``dtype=float32`` is flax's: it installs no policy,
so a float32 model runs one code path whatever its config says.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_COMPUTE_DTYPE: Optional[torch.dtype] = None  # None => the inputs' dtype (flax default)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype() -> Optional[torch.dtype]:
    return _COMPUTE_DTYPE


def canonical_dtype(name) -> Optional[torch.dtype]:
    """'bfloat16' (or torch.bfloat16) -> torch.bfloat16; 'float32' (or
    torch.float32), None, 'none' and '' -> None, the float32 default."""
    if name is None or name in ("none", ""):
        return None
    if not isinstance(name, torch.dtype):
        if name not in DTYPES:
            raise ValueError(f"unknown compute dtype {name!r}; have {sorted(DTYPES)}")
        name = DTYPES[name]
    return None if name == torch.float32 else name


@contextlib.contextmanager
def precision(dtype):
    """Scoped compute-dtype override (installed around the model's forward)."""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = canonical_dtype(dtype)
    try:
        yield
    finally:
        _COMPUTE_DTYPE = prev
