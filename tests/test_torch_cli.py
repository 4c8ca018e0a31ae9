"""The port's entry points end to end on the CPU: a synthetic
SceneFlow-layout dataset (PNG pairs with a constant shift, PFM ground
truth, filename lists), two train steps and a validation through
``python -m aanet_torch.cli train --device cpu``, then ``predict``,
``evaluate`` and ``inference`` on the checkpoint it wrote, and
``evaluate`` of the JAX package's trained checkpoint."""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
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


ARTIFACT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "artifacts", "aanet_synthetic_best.msgpack.gz")
DATA_FLAGS = ["--val_img_height", "48", "--val_img_width", "96", "--val_batch_size", "2",
              "--num_workers", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU runs: the test workers
    share the cores, and torch's default of one thread a core slows these
    runs by tens of times when the workers oversubscribe the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory, one_torch_thread):
    """One port ``train`` run (two steps, one validation) on the CPU:
    (data, lists, checkpoint dir)."""
    root = str(tmp_path_factory.mktemp("run"))
    data, lists = write_dataset(root, 4, 48, 96)
    ckpt = os.path.join(root, "run")
    cli.main(train_args(data, lists, ckpt) + ["--device", "cpu"])
    return data, lists, ckpt


def test_cli_train_on_cpu_two_steps_then_predict(trained_run, tmp_path):
    data, lists, ckpt = trained_run
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


def _evaluate(data, lists, ckpt, capsys, *flags):
    capsys.readouterr()
    cli.main(["evaluate", "--data_dir", data, "--filename_root", lists, "--checkpoint_dir", ckpt,
              *DATA_FLAGS, *flags, "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_evaluate_reproduces_the_last_validation_of_train(trained_run, tmp_path, capsys):
    """``evaluate`` of the run's checkpoint (aanet_best) prints exactly the
    metrics of the run's last validation, and writes no checkpoint."""
    data, lists, ckpt = trained_run
    run = str(tmp_path / "run")
    shutil.copytree(ckpt, run)
    before = {name: os.path.getmtime(os.path.join(run, name)) for name in os.listdir(run)}
    got = _evaluate(data, lists, run, capsys, *CUT)
    val = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))
           if json.loads(line)["kind"] == "val"][-1]
    assert got == {k: v for k, v in val.items() if k not in ("kind", "epoch")}
    assert all(os.path.getmtime(os.path.join(run, n)) == t for n, t in before.items()
               if n.endswith(".pt"))


def test_evaluate_only_writes_no_aanet_best(trained_run, tmp_path, capsys):
    """Without aanet_best, ``evaluate`` takes aanet_latest; it writes no
    aanet_best (``evaluate_only``), where a training validation would."""
    data, lists, ckpt = trained_run
    run = str(tmp_path / "run")
    shutil.copytree(ckpt, run)
    os.remove(os.path.join(run, "aanet_best.pt"))
    got = _evaluate(data, lists, run, capsys, *CUT)
    assert np.isfinite(got["epe"])
    assert not os.path.exists(os.path.join(run, "aanet_best.pt"))
    assert os.path.exists(os.path.join(run, "val_results.txt"))


def test_cli_evaluate_without_a_checkpoint_raises(trained_run, tmp_path):
    data, lists, _ = trained_run
    with pytest.raises(FileNotFoundError, match="no --pretrained given"):
        cli.main(["evaluate", "--data_dir", data, "--filename_root", lists, "--checkpoint_dir",
                  str(tmp_path / "empty"), *DATA_FLAGS, *CUT, "--device", "cpu"])


def test_cli_evaluate_the_trained_flax_checkpoint(tmp_path, capsys):
    """The JAX package's trained anchor (``aanet`` at max_disp 48), read
    from its gzipped flax file, on the synthetic set it was trained on
    (``chip_smoke.write_synthetic``, 16 pairs of 96x192): EPE below 2.0 px,
    as tests/test_torch_trained.py holds the JAX model to."""
    data, lists = chip_smoke.write_synthetic(str(tmp_path / "synthetic"))
    got = _evaluate(data, lists, str(tmp_path / "eval"), capsys, "--preset", "aanet",
                    "--max_disp", "48", "--pretrained", ARTIFACT, "--strict", "--val_img_height", "96",
                    "--val_img_width", "192", "--val_batch_size", "4")
    assert got["epe"] < 2.0, got


def test_synthetic_set_is_the_tools(tmp_path):
    """``chip_smoke.write_synthetic`` writes the files of
    ``tools/synthetic_dataset.py`` byte for byte."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "synthetic_dataset", os.path.join(os.path.dirname(ARTIFACT), "..", "tools",
                                          "synthetic_dataset.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.generate(str(tmp_path / "tool"), pairs=3, height=24, width=40)
    chip_smoke.write_synthetic(str(tmp_path / "port"), pairs=3, hw=(24, 40))
    for sub in ("data/left", "data/right", "data/disp", "lists/filenames"):
        names = sorted(os.listdir(tmp_path / "tool" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and names
        for name in names:
            assert (tmp_path / "tool" / sub / name).read_bytes() == \
                (tmp_path / "port" / sub / name).read_bytes(), (sub, name)


def _test_split(root, n, h, w):
    """A dataset of ``n`` pairs of h x w with a test list."""
    data, lists = write_dataset(root, n, h, w, seed=5)
    shutil.copy(os.path.join(lists, "filenames", "SceneFlow_finalpass_val.txt"),
                os.path.join(lists, "filenames", "SceneFlow_finalpass_test.txt"))
    return data, lists


def test_cli_inference_writes_cropped_pfms(trained_run, tmp_path):
    """Three 40x90 pairs in batches of 2 (the last one ragged) padded at
    the top and right to 48x96, predicted and cropped back: each PFM is
    the ``predict`` of its pair with the same weights, which pads the same
    way."""
    from aanet_torch.data.file_io import read_disp

    data, lists = _test_split(str(tmp_path), 3, 40, 90)
    weights = os.path.join(trained_run[2], "aanet_latest.pt")
    out = str(tmp_path / "out")
    cli.main(["inference", "--data_dir", data, "--filename_root", lists, "--img_height", "48",
              "--img_width", "96", "--batch_size", "2", "--num_workers", "2", *CUT,
              "--pretrained", weights, "--output_dir", out, "--save_type", "pfm", "--device", "cpu"])
    assert sorted(os.listdir(os.path.join(out, "left"))) == ["0.pfm", "1.pfm", "2.pfm"]
    cfg = dataclasses.replace(preset("aanet"), max_disp=48, num_fusions=2, num_deform_blocks=1)
    pairs = tmp_path / "pairs"
    for sub in ("left", "right"):
        shutil.copytree(os.path.join(data, sub), pairs / sub)
    want = infer.predict_pairs(cfg, str(pairs), save_type="npy", device="cpu", pretrained=weights)
    for i, path in enumerate(want):
        got = read_disp(os.path.join(out, "left", f"{i}.pfm"))
        assert got.shape == (40, 90) and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.load(path), rtol=0, atol=1e-4)
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)


def test_cli_inference_count_time_prints_the_mean(trained_run, tmp_path, capsys):
    data, lists = _test_split(str(tmp_path), 2, 48, 96)
    capsys.readouterr()
    cli.main(["inference", "--data_dir", data, "--filename_root", lists, "--img_height", "48",
              "--img_width", "96", "--batch_size", "2", "--num_workers", "2", *CUT,
              "--pretrained", os.path.join(trained_run[2], "aanet_latest.pt"), "--count_time",
              "--num_images", "2", "--output_dir", str(tmp_path / "out"), "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == ["mean_inference_seconds"] and got["mean_inference_seconds"] > 0
    assert not os.path.exists(tmp_path / "out")


@pytest.mark.parametrize("command", ["evaluate", "inference"])
def test_cli_evaluate_and_inference_without_device_raise_when_cuda_is_absent(
        trained_run, command, monkeypatch):
    data, lists, ckpt = trained_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([command, "--data_dir", data, "--filename_root", lists, *CUT,
                  "--pretrained", os.path.join(ckpt, "aanet_latest.pt")])
