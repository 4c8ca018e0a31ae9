"""MATLAB-format analysis export with scipy.io (own copy of
aanet_tpu/utils/matlab_export.py; reference utils/utilsForMatlab.py):

* ``LossRecord``: per-epoch arrays of the losses and metrics;
* ``save_loss_for_matlab``: the record as ``<dir>/lossRecord.mat``;
* ``save_img_error_analysis``: one validation sample's image, ground
  truth, prediction pyramid and signed error map at the fixed indices.

scipy is imported where a file is written, so the module imports
without it.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

# the validation samples whose analysis the reference dumps (utilsForMatlab.py:64-66)
DEFAULT_ANALYSIS_INDICES = (0, 100, 200, 300, 400, 500)


class LossRecord:
    """Accumulates per-epoch scalar arrays for MATLAB analysis."""

    def __init__(self, keys: Optional[Iterable[str]] = None):
        self.data: Dict[str, List[float]] = {k: [] for k in keys or ()}

    def append(self, record: Dict[str, float]):
        for k, v in record.items():
            self.data.setdefault(k, []).append(float(v))

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v, np.float64) for k, v in self.data.items()}


def save_loss_for_matlab(record: LossRecord, checkpoint_dir: str,
                         filename: str = "lossRecord.mat") -> str:
    """Write the record as a .mat file (utilsForMatlab.py:32-44)."""
    from scipy.io import savemat

    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, filename)
    savemat(path, record.as_arrays())
    return path


def save_img_error_analysis(checkpoint_dir: str, epoch: int, sample_index: int,
                            left: np.ndarray, gt_disp: np.ndarray,
                            pred_pyramid: Iterable[np.ndarray],
                            analysis_indices: Iterable[int] = DEFAULT_ANALYSIS_INDICES
                            ) -> Optional[str]:
    """One validation sample's bundle (the left image, the ground truth,
    every pyramid level as ``pred_scale_<i>``, the final map's signed
    error, the epoch) as ``matlab_analysis/epochEEE_sampleSSSSS.mat``;
    nothing for an index outside ``analysis_indices``."""
    if sample_index not in set(analysis_indices):
        return None
    from scipy.io import savemat

    out_dir = os.path.join(checkpoint_dir, "matlab_analysis")
    os.makedirs(out_dir, exist_ok=True)
    pyramid = [np.asarray(p, np.float32) for p in pred_pyramid]
    gt = np.asarray(gt_disp, np.float32)
    bundle = {
        "left": np.asarray(left, np.float32),
        "gt_disp": gt,
        "error": pyramid[-1] - gt,
        "epoch": np.asarray(epoch),
    }
    for i, p in enumerate(pyramid):
        bundle[f"pred_scale_{i}"] = p
    path = os.path.join(out_dir, f"epoch{epoch:03d}_sample{sample_index:05d}.mat")
    savemat(path, bundle)
    return path
