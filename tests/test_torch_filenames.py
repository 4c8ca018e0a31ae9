"""The port's copy of the reference's split lists (``aanet_torch/filenames/``)
against the JAX package's vendored ones (``aanet_tpu/filenames/``): the
copy is byte-identical and agrees with its ``MANIFEST.json`` (line counts
and sha256 of the text), and a ``StereoDataset`` with no
``filename_root``, in a working directory without lists, resolves every
vendored list to the same samples as the JAX dataset."""
import gzip
import hashlib
import json
import os

import pytest

import aanet_torch
import aanet_tpu
from aanet_tpu.data.datasets import StereoDataset as JaxStereoDataset
from aanet_torch.data.datasets import DATASET_FILES, SPLIT_DIRS, StereoDataset

PORT = os.path.join(os.path.dirname(aanet_torch.__file__), "filenames")
JAX = os.path.join(os.path.dirname(aanet_tpu.__file__), "filenames")


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_copy_is_byte_identical_and_agrees_with_its_manifest():
    assert tree(PORT) == tree(JAX)
    for rel in tree(JAX):
        with open(os.path.join(PORT, rel), "rb") as a, open(os.path.join(JAX, rel), "rb") as b:
            assert a.read() == b.read(), rel
    with open(os.path.join(PORT, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert sorted(manifest) == sorted(r[:-3] for r in tree(PORT) if r.endswith(".gz"))
    for rel, entry in manifest.items():
        with gzip.open(os.path.join(PORT, rel + ".gz"), "rb") as f:
            text = f.read()
        assert hashlib.sha256(text).hexdigest() == entry["sha256"], rel
        assert len(text.splitlines()) == entry["lines"], rel


VENDORED = [(preset, name, mode) for preset, split in SPLIT_DIRS.items()
            for name, modes in DATASET_FILES.items() for mode, fname in modes.items()
            if os.path.exists(os.path.join(PORT, split, fname + ".gz"))]


@pytest.mark.parametrize("preset,name,mode", VENDORED)
def test_dataset_resolves_the_vendored_list_as_jax_does(preset, name, mode, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = StereoDataset("/data", name, mode=mode, split_preset=preset)
    want = JaxStereoDataset("/data", name, mode=mode, split_preset=preset)
    assert len(got) > 0
    assert got.samples == want.samples


def test_missing_list_names_every_path_tried(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError) as err:
        StereoDataset("/data", "SceneFlow", mode="train", split_preset="full")
    message = str(err.value)
    for root in (".", PORT):
        assert os.path.join(root, "filenames", "SceneFlow_finalpass_train.txt.gz") in message
