"""The port's ``train`` entry point with the ``aanet+_sceneflow`` recipe on
the CPU: ``--save_ckpt_freq`` writes ``models/aanet_epoch_NNN.pt`` (no
optimizer) with its flax pair (``.msgpack``, ``.json``), and a run stopped after its first epoch and continued with
``--resume`` from ``aanet_latest.pt`` takes the same second step as a run
that never stopped: the same loss, learning rate and weights.

Sizes: ``aanet+`` cut to max_disp 48, 2 fusions with 1 deformable, on two
96x96 pairs (one step of batch 2 an epoch), the learning rate halved after
the first epoch, so that the resumed schedule shows too.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from aanet_torch import cli
from aanet_torch.ops import BACKWARD_OPS, KERNEL_OPS

CUT = ["--max_disp", "48", "--num_fusions", "2", "--num_deform_blocks", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's small CPU runs: the test workers
    share the cores, and torch's default of one thread a core slows these
    runs by tens of times when the workers oversubscribe the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_periodic_checkpoints_and_resume_match_an_uninterrupted_run(tmp_path):
    data, lists = chip_smoke.write_synthetic(str(tmp_path / "set"), pairs=2, hw=(96, 96))

    def train(ckpt, epochs, *extra):
        cli.main(["train", "--recipe", "aanet+_sceneflow", *CUT, "--data_dir", data,
                  "--filename_root", lists, "--checkpoint_dir", ckpt, "--img_height", "96",
                  "--img_width", "96", "--batch_size", "2", "--num_workers", "1",
                  "--max_epoch", str(epochs), "--milestones", "1", "--print_freq", "1",
                  "--no_validate", "--save_ckpt_freq", "1", "--device", "cpu", *extra])

    def records(ckpt):
        with open(os.path.join(ckpt, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    whole, split = str(tmp_path / "whole"), str(tmp_path / "split")
    train(whole, 2)
    train(split, 1)
    # each torch file with the JAX package's flax pair beside it
    assert sorted(os.listdir(os.path.join(split, "models"))) == [
        "aanet_epoch_001.json", "aanet_epoch_001.msgpack", "aanet_epoch_001.pt"]
    train(split, 2, "--resume")
    with open(os.path.join(split, "trainLog.txt")) as f:
        assert "resumed from epoch 1, step 1" in f.read()

    assert [r["step"] for r in records(whole)] == [r["step"] for r in records(split)] == [1, 2]
    assert records(split)[1]["total_loss"] == records(whole)[1]["total_loss"]
    for ckpt in (whole, split):
        saved = sorted(os.listdir(os.path.join(ckpt, "models")))
        assert saved == [f"aanet_epoch_00{e}.{suffix}" for e in (1, 2)
                         for suffix in ("json", "msgpack", "pt")]
        for name in saved[2::3]:
            assert "optimizer" not in torch.load(os.path.join(ckpt, "models", name),
                                                 weights_only=True)
    latest = [torch.load(os.path.join(ckpt, "aanet_latest.pt"), weights_only=True)
              for ckpt in (whole, split)]
    assert [(c["epoch"], c["step"]) for c in latest] == [(2, 2), (2, 2)]
    assert all(torch.equal(v, latest[1]["model"][k]) for k, v in latest[0]["model"].items())
    assert np.isfinite(records(whole)[1]["total_loss"])
    assert all(op.launches == 0 for op in KERNEL_OPS + BACKWARD_OPS)
