"""The port's ``train`` entry point end to end on the CPU: a synthetic
SceneFlow-layout dataset (PNG pairs with a constant shift, PFM ground
truth, filename lists), two train steps and a validation through
``python -m aanet_torch.cli train --device cpu``, then ``predict`` on the
checkpoint it wrote."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from aanet_torch import cli, infer
from aanet_torch.config import preset
from aanet_torch.data.file_io import write_pfm
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

CUT = ["--max_disp", "48", "--num_fusions", "2", "--num_deform_blocks", "1"]


def write_dataset(root, n, h, w, seed=0):
    """``n`` pairs with left[x] = right[x - d], d from 3 to 8, under
    ``root/data``; lists for train and val under ``root/lists/filenames``."""
    rs = np.random.RandomState(seed)
    data, lists = os.path.join(root, "data"), os.path.join(root, "lists", "filenames")
    for sub in ("left", "right", "disp"):
        os.makedirs(os.path.join(data, sub))
    os.makedirs(lists)
    lines = []
    for i in range(n):
        d = int(rs.randint(3, 9))
        base = rs.randint(0, 256, (h, w + d, 3), dtype=np.uint8)
        Image.fromarray(base[:, d:]).save(os.path.join(data, "left", f"{i}.png"))
        Image.fromarray(base[:, :w]).save(os.path.join(data, "right", f"{i}.png"))
        write_pfm(os.path.join(data, "disp", f"{i}.pfm"), np.full((h, w), float(d), np.float32))
        lines.append(f"left/{i}.png right/{i}.png disp/{i}.pfm")
    for split in ("train", "val"):
        with open(os.path.join(lists, f"SceneFlow_finalpass_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return data, os.path.join(root, "lists")


def train_args(data, lists, ckpt):
    return ["train", "--data_dir", data, "--filename_root", lists, "--checkpoint_dir", ckpt,
            "--img_height", "48", "--img_width", "96", "--val_img_height", "48",
            "--val_img_width", "96", "--batch_size", "2", "--val_batch_size", "2",
            "--num_workers", "2", "--max_epoch", "1", "--print_freq", "1", "--milestones", "10",
            *CUT]


def test_cli_train_on_cpu_two_steps_then_predict(tmp_path):
    data, lists = write_dataset(str(tmp_path), 4, 48, 96)
    ckpt = str(tmp_path / "run")
    cli.main(train_args(data, lists, ckpt) + ["--device", "cpu"])
    records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["total_loss"] > 0 for r in train)
    assert [r["kind"] for r in records].count("val") == 1
    for name in ("aanet_latest.pt", "aanet_best.pt", "args.json", "trainLog.txt", "val_results.txt"):
        assert os.path.exists(os.path.join(ckpt, name)), name
    saved = torch.load(os.path.join(ckpt, "aanet_latest.pt"), weights_only=True)
    assert saved["step"] == 2 and saved["epoch"] == 1 and "optimizer" in saved
    # predict reads the checkpoint the run wrote
    pairs = tmp_path / "pairs"
    for sub in ("left", "right"):
        os.makedirs(pairs / sub)
        Image.open(os.path.join(data, sub, "0.png")).save(pairs / sub / "0.png")
    cfg = dataclasses.replace(preset("aanet"), max_disp=48, num_fusions=2, num_deform_blocks=1)
    out = infer.predict_pairs(cfg, str(pairs), save_type="npy", device="cpu",
                              pretrained=os.path.join(ckpt, "aanet_latest.pt"))
    pred = np.load(out[0])
    assert pred.shape == (48, 96) and np.isfinite(pred).all()
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


STEREONET = ["--feature_type", "stereonet", "--feature_similarity", "difference",
             "--aggregation_type", "stereonet", "--refinement_type", "stereonet"]


def test_cli_train_runs_the_stereonet_baseline_on_cpu(tmp_path):
    """``train`` reaches a 3-D-aggregation baseline through the model flags
    (the JAX package has no recipe for it): two steps through the
    difference volume's backward, then a validation, and the checkpoint
    holds the baseline's weights."""
    data, lists = write_dataset(str(tmp_path), 4, 48, 96)
    ckpt = str(tmp_path / "run")
    args = train_args(data, lists, ckpt)[: -len(CUT)] + ["--max_disp", "48", *STEREONET]
    cli.main(args + ["--device", "cpu"])
    records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["total_loss"]) and r["total_loss"] > 0 for r in train)
    assert [r["kind"] for r in records].count("val") == 1
    saved = torch.load(os.path.join(ckpt, "aanet_latest.pt"), weights_only=True)
    assert any(k.startswith("aggregation.Conv_4.") for k in saved["model"])
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


def test_cli_train_without_device_raises_when_cuda_is_absent(tmp_path, monkeypatch):
    data, lists = write_dataset(str(tmp_path), 2, 48, 96)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(train_args(data, lists, str(tmp_path / "run")))
    assert torch.backends.cudnn.allow_tf32 is False and torch.backends.cuda.matmul.allow_tf32 is False
