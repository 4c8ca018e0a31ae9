"""Train and eval steps and the epoch orchestrator
(aanet_tpu/train/trainer.py:52-160, 163-265, 295-356, 401-509).

* ``make_train_step``: one optimizer update per global batch. With
  gradient accumulation A the batch is split into A microbatches that run
  one after the other on the same parameters; their gradients are
  averaged (each microbatch loss is scaled by 1/A) and one update is
  applied, and the BatchNorm statistics move once per microbatch, as the
  JAX step's ``lax.scan`` carries them. ``freeze_bn`` keeps every
  BatchNorm on its running statistics while the rest trains.
* ``make_eval_step``: the eval forward and the metric suite; it upsamples
  the prediction only when it is smaller than the ground truth, as the
  JAX step does (trainer.py:149), which is matched here and not fixed.
* ``Trainer``: epochs of train steps with the learning rate from the
  piecewise-constant schedule, validation averaged per batch, and the
  checkpoints as torch files: ``aanet_latest`` after every epoch,
  ``models/aanet_epoch_NNN`` (no optimizer) every ``save_ckpt_freq``
  epochs and ``aanet_best`` on the best validation (none under
  ``evaluate_only``, the ``evaluate`` entry point's setting). ``resume``
  continues from ``aanet_latest``: weights, optimizer, epoch, step and the
  best metric and its epoch (trainer.py:232-251). A bfloat16 model
  config trains as the JAX package's does: the bf16 model on float32
  parameters, its casts' backward handing Adam float32 gradients, the
  BatchNorm statistics, the pyramid and the losses in float32; the
  checkpoints hold the float32 parameters. The ``.mat`` export and the
  TensorBoard panels of the JAX trainer are not ported.

Batches arrive as numpy NHWC arrays from ``aanet_torch.data.pipeline``
and become NCHW torch tensors on the device here, at the batch boundary.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from aanet_torch.config import Config
from aanet_torch.infer import load_weights_into, resolve_device
from aanet_torch.models.layers import set_train_mode
from aanet_torch.ops.resize import upsample_disparity
from aanet_torch.train.loss import pyramid_loss
from aanet_torch.train.metrics import all_metrics, validity_mask
from aanet_torch.train.optimizer import make_optimizer, piecewise_constant_schedule, set_learning_rate

def make_loss_fn(model, max_disp: int, highest_loss_only: bool = False):
    """loss_fn(batch) -> (total loss, detached metrics) for a batch of NCHW
    images ``left``/``right`` and [B, H, W] ``disp`` (and ``pseudo_disp``)."""

    def loss_fn(batch):
        pyramid = model(batch["left"], batch["right"])
        gt = batch["disp"]
        mask = validity_mask(gt, max_disp)
        pseudo = batch.get("pseudo_disp")
        pseudo_mask = None if pseudo is None else validity_mask(pseudo, max_disp) & ~mask
        total, aux = pyramid_loss(
            pyramid, gt, mask, pseudo_gt_disp=pseudo, pseudo_mask=pseudo_mask,
            highest_loss_only=highest_loss_only,
        )
        with torch.no_grad():
            pred = pyramid[-1]
            if pred.shape[1:] != gt.shape[1:]:
                pred = upsample_disparity(pred, tuple(gt.shape[1:]))
            metrics = all_metrics(pred, gt, mask)
            metrics["total_loss"] = total.detach()
            metrics["disp_loss"] = torch.as_tensor(aux["disp_loss"]).detach()
        return total, metrics

    return loss_fn


def make_train_step(model, optimizer, max_disp: int, accumulation_steps: int = 1,
                    freeze_bn: bool = False, highest_loss_only: bool = False):
    """train_step(batch) -> metrics (means over the microbatches) after one
    optimizer update from the global ``batch``."""
    loss_fn = make_loss_fn(model, max_disp, highest_loss_only)
    a = accumulation_steps
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        set_train_mode(model, freeze_bn)
        n = batch["left"].shape[0]
        if n % a:
            raise ValueError(f"batch of {n} does not split into {a} microbatches")
        optimizer.zero_grad(set_to_none=True)
        history = []
        for i in range(a):
            micro = {k: v[i * n // a:(i + 1) * n // a] for k, v in batch.items()}
            loss, metrics = loss_fn(micro)
            (loss / a).backward()
            history.append(metrics)
        for p in params:
            # a parameter the loss does not reach (under highest_loss_only
            # the heads of the coarser maps) gets a zero gradient, so that
            # Adam decays it as the JAX step does; torch's skips a None
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return {k: torch.stack([m[k] for m in history]).mean() for k in history[0]}

    return train_step


def make_eval_step(model, max_disp: int):
    """eval_step(batch) -> (prediction, metrics, pyramid) in eval mode."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]):
        model.eval()
        pyramid = model(batch["left"], batch["right"])
        gt = batch["disp"]
        pred = pyramid[-1]
        if pred.shape[1] < gt.shape[1] or pred.shape[2] < gt.shape[2]:
            pred = upsample_disparity(pred, tuple(gt.shape[1:]))
        mask = validity_mask(gt, max_disp)
        metrics = all_metrics(pred, gt, mask)
        metrics["valid"] = mask.any().to(torch.float32)
        return pred, metrics, pyramid

    return eval_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch (NHWC images, [B, H, W] disparities) -> torch NCHW on
    ``device``; names and other non-array entries are dropped."""
    out = {}
    for key, value in batch.items():
        if not isinstance(value, np.ndarray):
            continue
        t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
        if key in ("left", "right"):
            t = t.permute(0, 3, 1, 2).contiguous()
        out[key] = t.to(device, non_blocking=True)
    return out


def get_logger(log_file: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger("aanet_torch.train")
    logger.setLevel(logging.INFO)
    if log_file and not any(getattr(h, "baseFilename", None) == os.path.abspath(log_file)
                            for h in logger.handlers):
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        handler = logging.FileHandler(log_file)
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
    return logger


class Trainer:
    """Epoch orchestrator: train, validate, checkpoint, log."""

    def __init__(self, cfg: Config, steps_per_epoch: int, model=None, logger=None, device="cuda"):
        self.cfg = cfg
        t = cfg.train
        self.device = resolve_device(device)
        torch.manual_seed(t.seed)
        self.model = (model if model is not None else cfg.model.build()).to(self.device)
        self.logger = logger or get_logger(os.path.join(t.checkpoint_dir, "trainLog.txt"))
        if t.pretrained:
            self.logger.info(f"loading pretrained weights: {t.pretrained}")
            missing = load_weights_into(self.model, t.pretrained, strict=t.strict_load)
            if missing:
                self.logger.info(f"not loaded: {missing}")
        self.steps_per_epoch = max(1, steps_per_epoch)
        self.schedule = piecewise_constant_schedule(
            t.learning_rate, {int(m) * self.steps_per_epoch: t.lr_decay_gamma for m in t.milestones}
        )
        self.optimizer = make_optimizer(
            self.model, t.learning_rate, weight_decay=t.weight_decay, offset_lr_mult=t.offset_lr_mult
        )
        self.train_step = make_train_step(
            self.model, self.optimizer, cfg.model.max_disp,
            accumulation_steps=t.accumulation_steps, freeze_bn=t.freeze_bn,
            highest_loss_only=t.highest_loss_only,
        )
        self.eval_step = make_eval_step(self.model, cfg.model.max_disp)
        self.epoch = 0
        self.step = 0
        self.best_metric = 999.0
        self.best_epoch = -1
        if t.resume:
            self._resume(os.path.join(t.checkpoint_dir, "aanet_latest.pt"))
        os.makedirs(t.checkpoint_dir, exist_ok=True)
        self._metrics_file = os.path.join(t.checkpoint_dir, "metrics.jsonl")

    def _log_jsonl(self, record: dict):
        with open(self._metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    def train_epoch(self, batches: Iterable[Dict[str, np.ndarray]]) -> dict:
        cfg = self.cfg.train
        history = []
        for i, batch in enumerate(batches):
            lr = self.schedule(self.step)
            set_learning_rate(self.optimizer, lr)
            metrics = self.train_step(to_device(batch, self.device))
            self.step += 1
            history.append(metrics)
            if (i + 1) % cfg.print_freq == 0:
                values = {k: float(v) for k, v in metrics.items()}
                self.logger.info(
                    "Epoch [%3d/%3d] step %5d  lr %.2e  loss %.3f  epe %.3f"
                    % (self.epoch + 1, cfg.max_epoch, self.step, lr,
                       values["total_loss"], values["epe"])
                )
                self._log_jsonl({"kind": "train", "epoch": self.epoch + 1, "step": self.step, **values})
        self.epoch += 1
        means = {}
        if history:
            means = {k: float(torch.stack([m[k] for m in history]).mean()) for k in history[0]}
        self._save("aanet_latest", with_optimizer=True)
        if self.epoch % cfg.save_ckpt_freq == 0:
            self._save(os.path.join("models", f"aanet_epoch_{self.epoch:03d}"),
                       with_optimizer=False)
        return means

    def validate(self, batches: Iterable[Dict[str, np.ndarray]]) -> dict:
        """Metrics averaged per batch over the batches with any valid pixel
        (reference model.py:337-345, 371-377); a ragged last batch runs at
        its own size. Appends ``val_results.txt`` and keeps ``aanet_best``,
        unless ``evaluate_only`` (aanet_tpu/train/trainer.py:503)."""
        cfg = self.cfg.train
        sums: Dict[str, float] = {}
        valid_batches = 0
        for batch in batches:
            _, metrics, _ = self.eval_step(to_device(batch, self.device))
            metrics = {k: float(v) for k, v in metrics.items()}
            if metrics.pop("valid") == 0.0:
                continue
            valid_batches += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        means = {k: v / max(1, valid_batches) for k, v in sums.items()}
        self.logger.info(
            "validation epoch %d: " % self.epoch
            + "  ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
        )
        self._log_jsonl({"kind": "val", "epoch": self.epoch, **means})
        with open(os.path.join(cfg.checkpoint_dir, "val_results.txt"), "a") as f:
            f.write("epoch: %03d\t" % self.epoch)
            for k in ("epe", "d1", "thres1", "thres2", "thres3", "thres10", "thres20"):
                if k in means:
                    f.write(f"{k}: {means[k]:.4f}\t")
            f.write("\n")
        if means and not cfg.evaluate_only:
            current = means.get(cfg.val_metric, means.get("epe", 999.0))
            if current < self.best_metric:
                self.best_metric = current
                self.best_epoch = self.epoch
                self._save("aanet_best", with_optimizer=True, epe=current)
        return means

    def _resume(self, path: str):
        """Continue the run whose ``aanet_latest`` checkpoint is ``path``;
        without one, start afresh as the JAX trainer does."""
        if not os.path.exists(path):
            self.logger.info(f"no {path} to resume from; starting afresh")
            return
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        self.epoch, self.step = payload["epoch"], payload["step"]
        self.best_metric, self.best_epoch = payload["best_epe"], payload["best_epoch"]
        self.logger.info(f"resumed from epoch {self.epoch}, step {self.step}")

    def _save(self, name: str, with_optimizer: bool, epe: float = -1.0) -> str:
        path = os.path.join(self.cfg.train.checkpoint_dir, name + ".pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = dict(
            model=self.model.state_dict(), epoch=self.epoch, step=self.step, epe=epe,
            best_epe=self.best_metric, best_epoch=self.best_epoch,
        )
        if with_optimizer:
            payload["optimizer"] = self.optimizer.state_dict()
        torch.save(payload, path)
        return path
