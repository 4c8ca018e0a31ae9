"""Filename-list-driven stereo datasets (own copy of
aanet_tpu/data/datasets.py:85-168).

Text files with ``left right [disp]`` relative paths per line, organised
per dataset (SceneFlow / KITTI2012 / KITTI2015 / KITTI_mix) and mode
(train / train_all / val / test), under a split preset's directory
(debug / overfit / subset-N / full). The lists are read from
``filename_root`` or, without one, from the working directory and then
from the port's own copy of the reference's split lists,
``aanet_torch/filenames/`` (a byte-for-byte copy of the JAX package's
vendored lists with their ``MANIFEST.json``), so that ``--split_preset
subset_1200`` resolves out of the box (aanet_tpu/data/datasets.py:21-36).
"""
from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from aanet_torch.data.file_io import read_disp, read_img

# split preset -> filename-list directory (reference dataloader/dataloader.py:31-42)
SPLIT_DIRS = {
    "debug": "fileNames_debug",
    "overfit": "fileNames_overfit",
    "subset_1200": "fileNames_subsetTrain_1200",
    "subset_2400": "fileNames_subsetTrain_2400",
    "subset_4800": "fileNames_subsetTrain_4800",
    "subset_9600": "fileNames_subsetTrain_9600",
    "subset_19200": "fileNames_subsetTrain_19200",
    "full": "filenames",
}

DATASET_FILES = {
    "SceneFlow": {
        "train": "SceneFlow_finalpass_train.txt",
        "val": "SceneFlow_finalpass_val.txt",
        "test": "SceneFlow_finalpass_test.txt",
    },
    "KITTI2012": {
        "train": "KITTI_2012_train.txt",
        "train_all": "KITTI_2012_train_all.txt",
        "val": "KITTI_2012_val.txt",
        "test": "KITTI_2012_test.txt",
    },
    "KITTI2015": {
        "train": "KITTI_2015_train.txt",
        "train_all": "KITTI_2015_train_all.txt",
        "val": "KITTI_2015_val.txt",
        "test": "KITTI_2015_test.txt",
    },
    "KITTI_mix": {
        "train": "KITTI_mix.txt",
        "test": "KITTI_2015_test.txt",
    },
}


# the vendored split lists, gzipped (filenames/MANIFEST.json: lines and sha256 of each)
VENDORED_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "filenames")


def _resolve_list(filename_root: Optional[str], split_dir: str, fname: str) -> str:
    """The list ``split_dir/fname`` (or its ``.gz``) under ``filename_root``,
    or without one under the working directory, then ``VENDORED_ROOT``."""
    candidates = []
    for root in ([filename_root] if filename_root else [".", VENDORED_ROOT]):
        candidates += [os.path.join(root, split_dir, fname), os.path.join(root, split_dir, fname + ".gz")]
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"no filename list for {split_dir}/{fname}; looked in {candidates}")


def _open_list(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


class StereoDataset:
    """Map-style dataset over a filename list.

    Args:
      data_dir: dataset root the list paths are relative to.
      dataset_name: SceneFlow | KITTI2012 | KITTI2015 | KITTI_mix.
      mode: train | train_all | val | test.
      split_preset: key of SPLIT_DIRS.
      filename_root: directory holding the split directories (default: the
        working directory).
      load_pseudo_gt: also load the pseudo-GT disparity.
      transform: called with (sample, rng).
    """

    def __init__(self, data_dir: str, dataset_name: str = "SceneFlow", mode: str = "train",
                 split_preset: str = "full", filename_root: Optional[str] = None,
                 load_pseudo_gt: bool = False, save_filename: bool = True, transform=None):
        self.data_dir = data_dir
        self.dataset_name = dataset_name
        self.mode = mode
        self.transform = transform
        self.save_filename = save_filename
        files = DATASET_FILES[dataset_name]
        if mode not in files:
            raise KeyError(f"{dataset_name} has no mode {mode!r}")
        list_path = _resolve_list(filename_root, SPLIT_DIRS[split_preset], files[mode])

        self.samples = []
        with _open_list(list_path) as f:
            for line in f:
                splits = line.split()
                if not splits:
                    continue
                left, right = splits[:2]
                disp = splits[2] if len(splits) > 2 else None
                sample = {
                    "left_name": left,
                    "left": os.path.join(data_dir, left),
                    "right": os.path.join(data_dir, right),
                    "disp": os.path.join(data_dir, disp) if disp else None,
                    "pseudo_disp": None,
                }
                if load_pseudo_gt and disp:
                    if "disp_occ_0" in disp:  # KITTI 2015
                        p = disp.replace("disp_occ_0", "disp_occ_0_pseudo_gt")
                    elif "disp_occ" in disp:  # KITTI 2012
                        p = disp.replace("disp_occ", "disp_occ_pseudo_gt")
                    else:
                        raise NotImplementedError(disp)
                    sample["pseudo_disp"] = os.path.join(data_dir, p)
                self.samples.append(sample)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int, rng: Optional[np.random.Generator] = None) -> dict:
        path = self.samples[index]
        sample = {}
        if self.save_filename:
            sample["left_name"] = path["left_name"]
        sample["left"] = read_img(path["left"])
        sample["right"] = read_img(path["right"])
        subset = "subset" in self.dataset_name
        if path["disp"] is not None:
            sample["disp"] = read_disp(path["disp"], subset=subset)
        if path["pseudo_disp"] is not None:
            sample["pseudo_disp"] = read_disp(path["pseudo_disp"], subset=subset)
        if self.transform is not None:
            sample = self.transform(sample, rng if rng is not None else np.random.default_rng())
        return sample

    __getitem__ = load
