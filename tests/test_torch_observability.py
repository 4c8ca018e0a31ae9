"""The port's training observability against the JAX package's, on the
CPU: each visualisation function against ``aanet_tpu.utils.visualization``
on seeded arrays, exactly (the error image's dilation against the JAX
module's ``cv2.dilate`` path); ``FileSummaryWriter``'s PNGs and JSONL
against the JAX writer's, byte for byte; the ``.mat`` records and the
analysis bundle against ``aanet_tpu.utils.matlab_export``'s, read back
with ``scipy.io.loadmat``; ``StepTimer``'s arithmetic; ``time_fn`` and
``trace``; and a ``Trainer`` run of two steps and one validation with
``summary_freq`` 1 on a one-conv network with a BatchNorm: the
TensorBoard event file, both records, the analysis file of sample 0, the
ETA line and the flax pair, the BatchNorm statistics unmoved by the
summaries' eval forwards, and under ``evaluate_only`` no summaries and no
records (the analysis bundle is written, as the JAX trainer writes it).
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import scipy.io
import torch

from aanet_tpu.utils import matlab_export as jmat
from aanet_tpu.utils import profiling as jprof
from aanet_tpu.utils import visualization as jvis
from aanet_torch.config import Config, DataConfig, TrainConfig, preset
from aanet_torch.models import layers
from aanet_torch.train.trainer import Trainer
from aanet_torch.utils import matlab_export, profiling, visualization
from aanet_torch.utils.checkpoint import read_flax_msgpack

from _torch_parallel_worker import numpy_batches


def disparities(seed, shape):
    rs = np.random.RandomState(seed)
    gt = rs.uniform(-2, 40, shape).astype(np.float32)
    gt[rs.rand(*shape) < 0.2] = 0
    return (gt + rs.randn(*shape) * rs.choice([0.1, 2, 10], shape)).astype(np.float32), gt


@pytest.mark.parametrize("shape", [(13, 17), (3, 9, 11), (1, 1)])
@pytest.mark.parametrize("radius", [0, 1, 2])
def test_disp_error_img_equals_jax(shape, radius):
    est, gt = disparities(sum(shape) + radius, shape)
    got = visualization.disp_error_img(est, gt, dilate_radius=radius)
    want = jvis.disp_error_img(est, gt, dilate_radius=radius)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_colormaps_panels_and_histograms_equal_jax():
    np.testing.assert_array_equal(visualization.gen_error_colormap(), jvis.gen_error_colormap())
    est, gt = disparities(5, (2, 12, 20))
    for max_disp in (None, 30.0, 1e-3):
        np.testing.assert_array_equal(visualization.disp_to_color(est[0], max_disp),
                                      jvis.disp_to_color(est[0], max_disp))
    mask = gt > 5
    np.testing.assert_array_equal(visualization.disp_error_hist(est, gt), jvis.disp_error_hist(est, gt))
    np.testing.assert_array_equal(visualization.disp_error_hist(est, gt, mask),
                                  jvis.disp_error_hist(est, gt, mask))
    image = np.random.RandomState(6).uniform(0, 255, (12, 20, 3)).astype(np.float32)
    for item in (est[0], image, image / 255.0, image[..., :1]):
        np.testing.assert_array_equal(visualization._to_chw(item), jvis._to_chw(item))


def test_file_summary_writer_equals_jax(tmp_path):
    est, gt = disparities(7, (2, 12, 20))
    left = np.random.RandomState(8).randn(2, 12, 20, 3).astype(np.float32)
    dirs = {}
    for name, module in (("port", visualization), ("jax", jvis)):
        writer = module.FileSummaryWriter(str(tmp_path / name))
        writer.add_scalar("train/epe", 1.25, 3)
        writer.add_scalar("base_lr", np.float32(1e-3), 4)
        panels = {"left": left, "gt_disp": gt, "pred_disp": est,
                  "disp_error": module.disp_error_img(est[:1], gt[:1])}
        module.save_images(writer, "val0", panels, 2)
        module.save_images(writer, "train", {"pred_disp": est}, 5, max_items=2)
        module.save_hist(writer, "val0", est, gt, 2)
        module.save_hist(writer, "empty", est, np.zeros_like(gt), 2)
        writer.flush()
        writer.close()
        dirs[name] = tmp_path / name
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names and "scalars.jsonl" in names
    assert sum(n.endswith(".png") for n in names) == 6
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["jax"] / n).read_bytes(), n


def test_matlab_records_and_analysis_equal_jax(tmp_path):
    records = [{"epoch": 1, "epe": 2.5, "d1": np.float32(0.25)}, {"epoch": 2, "epe": 1.75, "d1": 0.125}]
    est, gt = disparities(9, (12, 20))
    left = np.random.RandomState(10).randn(12, 20, 3).astype(np.float32)
    pyramid = [est[::2, ::2], est]
    for name, module in (("port", matlab_export), ("jax", jmat)):
        record = module.LossRecord(["loss"])
        for r in records:
            record.append(r)
        module.save_loss_for_matlab(record, str(tmp_path / name), "valLossRecord.mat")
        assert module.save_img_error_analysis(str(tmp_path / name), 3, 7, left, gt, pyramid) is None
        module.save_img_error_analysis(str(tmp_path / name), 3, 100, left, gt, pyramid)
    assert matlab_export.DEFAULT_ANALYSIS_INDICES == jmat.DEFAULT_ANALYSIS_INDICES
    for rel in ("valLossRecord.mat", "matlab_analysis/epoch003_sample00100.mat"):
        got, want = (scipy.io.loadmat(str(tmp_path / name / rel)) for name in ("port", "jax"))
        keys = sorted(k for k in want if not k.startswith("__"))
        assert sorted(k for k in got if not k.startswith("__")) == keys and keys
        for k in keys:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_step_timer_arithmetic(monkeypatch):
    clock = iter([100.0, 103.0, 110.0])
    for module in (profiling, jprof):
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
    timer = profiling.StepTimer(total_steps=10)
    first = timer.lap(2)
    assert first == {"window_seconds": 3.0, "seconds_per_step": 1.5, "eta_hours": 1.5 * 8 / 3600.0}
    second = timer.lap(4)
    assert second == {"window_seconds": 7.0, "seconds_per_step": 1.75, "eta_hours": 1.75 * 4 / 3600.0}
    assert timer.steps_done == 6


def test_time_fn_and_trace(tmp_path):
    calls = []
    assert profiling.time_fn(lambda x: calls.append(x), 1, warmup=2, iters=3) >= 0
    assert calls == [1] * 5
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


class NormNet(torch.nn.Module):
    """One conv and one BatchNorm: a disparity map from a pair."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(6, 4, 3, padding=1)
        self.Norm_0 = layers.Norm(4)
        self.head = torch.nn.Conv2d(4, 1, 1)

    def forward(self, left, right):
        x = torch.relu(self.Norm_0(self.conv(torch.cat([left, right], 1))))
        return [torch.relu(self.head(x))[:, 0] * 10]


def run_trainer(ckpt, summary_freq=1, evaluate_only=False):
    cfg = Config(model=dataclasses.replace(preset("aanet"), max_disp=24),
                 data=DataConfig(batch_size=2, val_batch_size=4),
                 train=TrainConfig(checkpoint_dir=ckpt, print_freq=1, summary_freq=summary_freq,
                                   max_epoch=1, evaluate_only=evaluate_only))
    trainer = Trainer(cfg, steps_per_epoch=2, model=NormNet(), device="cpu")
    if not evaluate_only:
        trainer.train_epoch(numpy_batches(4, 2, 12, 16, seed=1))
    trainer.validate(numpy_batches(6, 4, 12, 16, seed=2))
    return trainer


def test_trainer_writes_the_summaries_records_and_flax_pair(tmp_path):
    ckpt = str(tmp_path / "run")
    trainer = run_trainer(ckpt)
    assert glob.glob(os.path.join(ckpt, "tb", "events.out.tfevents.*"))
    with open(os.path.join(ckpt, "trainLog.txt")) as f:
        log = f.read()
    assert "time " in log and "ETA " in log and "step     2" in log
    losses = scipy.io.loadmat(os.path.join(ckpt, "lossRecord.mat"))
    assert losses["epoch"].ravel().tolist() == [1] and np.isfinite(losses["total_loss"]).all()
    val = scipy.io.loadmat(os.path.join(ckpt, "valLossRecord.mat"))
    assert val["epoch"].ravel().tolist() == [1] and "epe" in val
    bundle = scipy.io.loadmat(os.path.join(ckpt, "matlab_analysis", "epoch001_sample00000.mat"))
    assert bundle["left"].shape == (12, 16, 3) and bundle["pred_scale_0"].shape == (12, 16)
    assert os.listdir(os.path.join(ckpt, "matlab_analysis")) == ["epoch001_sample00000.mat"]
    flax = read_flax_msgpack(os.path.join(ckpt, "aanet_latest.msgpack"))
    np.testing.assert_array_equal(flax["batch_stats"]["Norm_0"]["BatchNorm_0"]["mean"],
                                  trainer.model.Norm_0.BatchNorm_0.running_mean.numpy())
    assert os.path.exists(os.path.join(ckpt, "aanet_best.json"))
    # the summaries' eval forwards leave the BatchNorm statistics
    quiet = run_trainer(str(tmp_path / "quiet"), summary_freq=100)
    for name, value in quiet.model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[name], value), name
    assert not glob.glob(os.path.join(str(tmp_path / "quiet"), "tb", "*.png"))


def test_evaluate_only_writes_no_summaries_and_no_records(tmp_path):
    ckpt = str(tmp_path / "eval")
    trainer = run_trainer(ckpt, evaluate_only=True)
    assert trainer.writer is None
    names = set(os.listdir(ckpt))
    assert not names & {"tb", "lossRecord.mat", "valLossRecord.mat", "aanet_best.pt",
                        "aanet_best.msgpack"}, names
    assert {"val_results.txt", "metrics.jsonl", "matlab_analysis"} <= names
