"""Train and eval steps and the epoch orchestrator
(aanet_tpu/train/trainer.py:52-160, 163-509).

* ``make_train_step``: one optimizer update per global batch. With
  gradient accumulation A the batch is split into A microbatches that run
  one after the other on the same parameters; their gradients are
  averaged (each microbatch loss is scaled by 1/A) and one update is
  applied, and the BatchNorm statistics move once per microbatch, as the
  JAX step's ``lax.scan`` carries them. ``freeze_bn`` keeps every
  BatchNorm on its running statistics while the rest trains.
* Under a process group (``aanet_torch.parallel.mesh``) the step is the
  JAX step of the global batch: each rank holds its share of the batch
  and splits it into its A microbatches, global microbatch k being the
  union of the ranks' k-th; the valid-pixel counts of every microbatch
  are summed over the ranks first, so each rank's loss is its share of
  the global masked mean (aanet_tpu/train/loss.py:35-37) and the
  reported metrics are global means; BatchNorm takes global statistics
  (``models.layers.Norm``); the gradients are summed over the ranks once,
  after the last microbatch, in rank order, so every rank applies the
  same update bit for bit.
* ``make_eval_step``: the eval forward and the metric suite; it upsamples
  the prediction only when it is smaller than the ground truth, as the
  JAX step does (trainer.py:149), which is matched here and not fixed.
* ``Trainer``: epochs of train steps with the learning rate from the
  piecewise-constant schedule, validation averaged per batch, and the
  checkpoints: ``aanet_latest`` after every epoch,
  ``models/aanet_epoch_NNN`` (no optimizer) every ``save_ckpt_freq``
  epochs and ``aanet_best`` on the best validation (none under
  ``evaluate_only``, the ``evaluate`` entry point's setting), each a
  torch file (``.pt``) and beside it the JAX package's flax pair
  (``.msgpack`` and ``.json``: parameters and statistics, no optimizer).
  ``resume`` continues from ``aanet_latest.pt``: weights, optimizer,
  epoch, step and the best metric and its epoch (trainer.py:232-251). The
  observability of the JAX trainer (trainer.py:268-283, 334-397,
  425-486): the ``time %.2fs  ETA %.2fh`` log line (``StepTimer``), the
  summary writer in ``<checkpoint_dir>/tb`` (none under
  ``evaluate_only``) with ``base_lr`` and ``train/*`` scalars every
  ``print_freq`` steps, image panels and the signed-error histogram of
  an eval forward of the current global batch every ``summary_freq``
  steps, the
  validation's panels at five evenly spaced batches and ``val/*``
  scalars, ``lossRecord.mat`` and ``valLossRecord.mat`` after every epoch
  and validation, and the analysis ``.mat`` of the samples at
  ``DEFAULT_ANALYSIS_INDICES``. A bfloat16 model config trains as the
  JAX package's does: the bf16 model on float32 parameters, its casts'
  backward handing Adam float32 gradients, the BatchNorm statistics, the
  pyramid and the losses in float32; the checkpoints hold the float32
  parameters.
* Under a process group every rank builds, resumes and steps alike and
  only rank 0 writes (checkpoints, ``trainLog.txt``, ``metrics.jsonl``,
  ``val_results.txt``, the summaries and the ``.mat`` files); the ranks
  send rank 0 what the panels, histograms and analysis files need.
  Validation runs the batches ``make_val_loader`` gives each rank
  (batch i to rank i mod the world size) and gathers the per-batch
  metrics on every rank, so its means are the single process's and
  every rank reaches the same best-model decision.

Batches arrive as numpy NHWC arrays from ``aanet_torch.data.pipeline``
and become NCHW torch tensors on the device here, at the batch boundary.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from aanet_torch.config import Config
from aanet_torch.infer import load_weights_into, resolve_device
from aanet_torch.models.layers import set_train_mode
from aanet_torch.ops.resize import upsample_disparity
from aanet_torch.parallel import mesh
from aanet_torch.train.loss import pyramid_loss
from aanet_torch.train.metrics import all_metrics, validity_mask
from aanet_torch.train.optimizer import make_optimizer, piecewise_constant_schedule, set_learning_rate
from aanet_torch.utils.checkpoint import save_flax_checkpoint
from aanet_torch.utils.logging_util import get_logger
from aanet_torch.utils.matlab_export import (
    DEFAULT_ANALYSIS_INDICES, LossRecord, save_img_error_analysis, save_loss_for_matlab,
)
from aanet_torch.utils.profiling import StepTimer
from aanet_torch.utils.visualization import disp_error_img, make_summary_writer, save_hist, save_images


def _masks(batch, max_disp):
    """The loss's masks of a batch: the valid ground truth and, with a
    pseudo ground truth, its valid pixels where the ground truth is not."""
    mask = validity_mask(batch["disp"], max_disp)
    pseudo = batch.get("pseudo_disp")
    return mask, None if pseudo is None else validity_mask(pseudo, max_disp) & ~mask


def make_loss_fn(model, max_disp: int, highest_loss_only: bool = False):
    """loss_fn(batch, counts=None) -> (total loss, detached metrics) for a
    batch of NCHW images ``left``/``right`` and [B, H, W] ``disp`` (and
    ``pseudo_disp``); ``counts``, the global valid-pixel counts of the
    mask and the pseudo mask, make both this rank's shares of the global
    batch's means."""

    def loss_fn(batch, counts=None):
        pyramid = model(batch["left"], batch["right"])
        gt = batch["disp"]
        mask, pseudo_mask = _masks(batch, max_disp)
        count, pseudo_count = (None, None) if counts is None else counts
        total, aux = pyramid_loss(
            pyramid, gt, mask, pseudo_gt_disp=batch.get("pseudo_disp"), pseudo_mask=pseudo_mask,
            highest_loss_only=highest_loss_only, count=count, pseudo_count=pseudo_count,
        )
        with torch.no_grad():
            pred = pyramid[-1]
            if pred.shape[1:] != gt.shape[1:]:
                pred = upsample_disparity(pred, tuple(gt.shape[1:]))
            metrics = all_metrics(pred, gt, mask, count)
            metrics["total_loss"] = total.detach()
            metrics["disp_loss"] = torch.as_tensor(aux["disp_loss"]).detach()
        return total, metrics

    return loss_fn


def _global_counts(micros, max_disp):
    """[A, 2] int64: each microbatch's count of valid and of pseudo-valid
    pixels, summed over the ranks."""
    local = []
    for micro in micros:
        mask, pseudo_mask = _masks(micro, max_disp)
        count = mask.sum()
        local.append(torch.stack([count, count.new_zeros(()) if pseudo_mask is None
                                  else pseudo_mask.sum()]))
    return mesh.sum_over_ranks(torch.stack(local))


def make_train_step(model, optimizer, max_disp: int, accumulation_steps: int = 1,
                    freeze_bn: bool = False, highest_loss_only: bool = False):
    """train_step(batch) -> metrics (means over the microbatches) after one
    optimizer update from ``batch``: the global batch, or under a process
    group this rank's share of it (module docstring)."""
    loss_fn = make_loss_fn(model, max_disp, highest_loss_only)
    a = accumulation_steps
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        set_train_mode(model, freeze_bn)
        n = batch["left"].shape[0]
        if n % a:
            raise ValueError(f"batch of {n} does not split into {a} microbatches")
        optimizer.zero_grad(set_to_none=True)
        micros = [{k: v[i * n // a:(i + 1) * n // a] for k, v in batch.items()} for i in range(a)]
        counts = _global_counts(micros, max_disp) if mesh.distributed() else [None] * a
        history = []
        for micro, count in zip(micros, counts):
            loss, metrics = loss_fn(micro, count)
            (loss / a).backward()
            history.append(metrics)
        for p in params:
            # a parameter the loss does not reach (under highest_loss_only
            # the heads of the coarser maps) gets a zero gradient, so that
            # Adam decays it as the JAX step does; torch's skips a None
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
        if mesh.distributed():
            flat = mesh.sum_over_ranks(torch.cat([p.grad.reshape(-1) for p in params]))
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p.grad))
            # every rank's shares of each microbatch's metrics, summed
            table = mesh.sum_over_ranks(torch.stack([v.double() for v in metrics.values()]))
            metrics = {k: row.to(v.dtype) for (k, v), row in zip(metrics.items(), table)}
        optimizer.step()
        return {k: v.mean() for k, v in metrics.items()}

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




def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


class Trainer:
    """Epoch orchestrator: train, validate, checkpoint, log, summarise."""

    def __init__(self, cfg: Config, steps_per_epoch: int, model=None, logger=None, device="cuda"):
        self.cfg = cfg
        t = cfg.train
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # the kernels and the collectives run on the current card
            torch.cuda.set_device(self.device)
        self.rank, self.world = mesh.rank(), mesh.world_size()
        self.is_writer = self.rank == 0  # only rank 0 writes files
        torch.manual_seed(t.seed)
        self.model = (model if model is not None else cfg.model.build()).to(self.device)
        self.logger = logger or get_logger(
            os.path.join(t.checkpoint_dir, "trainLog.txt") if self.is_writer else None)
        if t.pretrained:
            self._log(f"loading pretrained weights: {t.pretrained}")
            missing = load_weights_into(self.model, t.pretrained, strict=t.strict_load)
            if missing:
                self._log(f"not loaded: {missing}")
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
        self._metrics_file = os.path.join(t.checkpoint_dir, "metrics.jsonl")
        self.writer = None
        if self.is_writer:
            os.makedirs(t.checkpoint_dir, exist_ok=True)
            if not t.evaluate_only:
                self.writer = make_summary_writer(os.path.join(t.checkpoint_dir, "tb"))
        self.train_record, self.val_record = LossRecord(), LossRecord()
        self.step_timer = StepTimer(total_steps=self.steps_per_epoch * max(1, t.max_epoch))

    def _log(self, message: str):
        if self.is_writer:
            self.logger.info(message)

    def _log_jsonl(self, record: dict):
        if self.is_writer:
            with open(self._metrics_file, "a") as f:
                f.write(json.dumps(record) + "\n")

    def train_epoch(self, batches: Iterable[Dict[str, np.ndarray]]) -> dict:
        cfg = self.cfg.train
        history = []
        for i, batch in enumerate(batches):
            lr = self.schedule(self.step)
            set_learning_rate(self.optimizer, lr)
            tensors = to_device(batch, self.device)
            metrics = self.train_step(tensors)
            self.step += 1
            history.append(metrics)
            if (i + 1) % cfg.print_freq == 0:
                values = {k: float(v) for k, v in metrics.items()}
                timing = self.step_timer.lap(cfg.print_freq)
                # seconds of the window and hours left (reference model.py:157-167)
                self._log(
                    "Epoch [%3d/%3d] step %5d  time %.2fs  ETA %.2fh  lr %.2e  loss %.3f  epe %.3f"
                    % (self.epoch + 1, cfg.max_epoch, self.step, timing["window_seconds"],
                       timing["eta_hours"], lr, values["total_loss"], values["epe"])
                )
                self._log_jsonl({"kind": "train", "epoch": self.epoch + 1, "step": self.step, **values})
                if self.writer is not None:
                    self.writer.add_scalar("base_lr", lr, self.step)
                    for k, v in values.items():
                        self.writer.add_scalar(f"train/{k}", v, self.step)
            if not cfg.evaluate_only and (i + 1) % cfg.summary_freq == 0:
                self._train_summary(tensors)
        self.epoch += 1
        means = {}
        if history:
            means = {k: float(torch.stack([m[k] for m in history]).mean()) for k in history[0]}
            # the per-epoch record (reference train.py:269, utilsForMatlab.py:8-44)
            self.train_record.append({"epoch": self.epoch, **means})
            self._export_matlab()
        self._save("aanet_latest", with_optimizer=True)
        if self.epoch % cfg.save_ckpt_freq == 0:
            self._save(os.path.join("models", f"aanet_epoch_{self.epoch:03d}"),
                       with_optimizer=False)
        return means

    def _train_summary(self, batch: Dict[str, torch.Tensor]):
        """Image panels and the signed-error histogram of an eval forward
        of the current global batch (reference model.py:171-223): every
        rank predicts its share and rank 0 draws them in rank order. The
        BatchNorm statistics stay."""
        pred, _, _ = self.eval_step(batch)
        shares = mesh.gather_to_first((pred.cpu().numpy(), batch["disp"].cpu().numpy()))
        if shares is None:
            return
        pred, gt = (np.concatenate(part) for part in zip(*shares))
        panels = {"left": _nhwc(batch["left"]), "right": _nhwc(batch["right"]), "gt_disp": gt,
                  "pred_disp": pred, "disp_error": disp_error_img(pred[:1], gt[:1])}
        save_images(self.writer, "train", panels, self.step)
        save_hist(self.writer, "train", pred, gt, self.step)

    def _export_matlab(self):
        """lossRecord.mat, and valLossRecord.mat once there is a validation."""
        if not self.is_writer:
            return
        save_loss_for_matlab(self.train_record, self.cfg.train.checkpoint_dir, "lossRecord.mat")
        if self.val_record.data:
            save_loss_for_matlab(self.val_record, self.cfg.train.checkpoint_dir, "valLossRecord.mat")

    def validate(self, batches: Iterable[Optional[Dict[str, np.ndarray]]]) -> dict:
        """Metrics averaged per batch over the batches with any valid pixel
        (reference model.py:337-345, 371-377); a ragged last batch runs at
        its own size. A rank runs the batches it is given and skips the
        Nones, which are other ranks' (``make_val_loader`` splits the set);
        the per-batch metrics are gathered to every rank and added in batch
        order, and the ranks' batches must make up the set once. Panels at
        five evenly spaced batches, the analysis ``.mat`` of the samples at
        ``DEFAULT_ANALYSIS_INDICES`` (batch i holds samples from
        i * ``val_batch_size`` on), written by rank 0 from what the ranks
        send it; ``val/*`` scalars and ``valLossRecord.mat``; appends
        ``val_results.txt`` and keeps ``aanet_best``, unless
        ``evaluate_only`` (aanet_tpu/train/trainer.py:401-500)."""
        cfg = self.cfg.train
        try:  # five evenly spaced panels where the number of batches is known
            n_batches = len(batches)
            panel_gate = {n_batches // 6 * k for k in range(1, 6)}
        except TypeError:
            panel_gate = {0, 1, 2, 3, 4}
        analysis = set(DEFAULT_ANALYSIS_INDICES)
        own, extras = [], []
        seen = 0
        for i, batch in enumerate(batches):
            seen = i + 1
            if batch is None:
                continue
            base = i * self.cfg.data.val_batch_size
            tensors = to_device(batch, self.device)
            pred, metrics, pyramid = self.eval_step(tensors)
            own.append({"i": i, "metrics": {k: float(v) for k, v in metrics.items()}})
            real_bs = tensors["disp"].shape[0]
            samples = [a for a in sorted(analysis) if base <= a < base + real_bs]
            do_panel = i in panel_gate and not cfg.evaluate_only
            if not (do_panel or samples):
                continue
            pred_np, gt_np = pred.cpu().numpy(), tensors["disp"].cpu().numpy()
            left_np = _nhwc(tensors["left"])
            extra = {"i": i}
            if do_panel:
                extra["panel"] = dict(left=left_np[:1], gt=gt_np, pred=pred_np)
            if samples:
                pyr = [p.cpu().numpy() for p in pyramid]
                extra["analysis"] = [(a, left_np[a - base], gt_np[a - base],
                                      [p[a - base] for p in pyr]) for a in samples]
            extras.append(extra)
        results = sorted((r for part in mesh.gather_objects(own) for r in part),
                         key=lambda r: r["i"])
        if [r["i"] for r in results] != list(range(seen)):
            raise ValueError(f"the ranks ran validation batches {[r['i'] for r in results]}, "
                             f"not each of the {seen} once")
        sent = mesh.gather_to_first(extras)
        if sent is not None:  # rank 0 writes what the ranks sent
            panel_count = 0
            for extra in sorted((e for part in sent for e in part), key=lambda e: e["i"]):
                if "panel" in extra:
                    p = extra["panel"]
                    panels = {"left": p["left"], "gt_disp": p["gt"], "pred_disp": p["pred"],
                              "disp_error": disp_error_img(p["pred"][:1], p["gt"][:1])}
                    save_images(self.writer, f"val{panel_count}", panels, self.epoch)
                    save_hist(self.writer, f"val{panel_count}", p["pred"], p["gt"], self.epoch)
                    panel_count += 1
                # the analysis bundles (reference model.py:345-347, utilsForMatlab.py:51-89)
                for a, left, gt, pyr in extra.get("analysis", ()):
                    save_img_error_analysis(cfg.checkpoint_dir, self.epoch, a, left, gt, pyr)
        sums: Dict[str, float] = {}
        valid_batches = 0
        for r in results:
            metrics = dict(r["metrics"])
            if metrics.pop("valid") == 0.0:
                continue
            valid_batches += 1
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + v
        means = {k: v / max(1, valid_batches) for k, v in sums.items()}
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(f"val/{k}", v, self.epoch)
        if means:
            self.val_record.append({"epoch": self.epoch, **means})
            if not cfg.evaluate_only:
                self._export_matlab()
        self._log(
            "validation epoch %d: " % self.epoch
            + "  ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()))
        )
        self._log_jsonl({"kind": "val", "epoch": self.epoch, **means})
        if self.is_writer:
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
            self._log(f"no {path} to resume from; starting afresh")
            return
        payload = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(payload["model"])
        if "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        self.epoch, self.step = payload["epoch"], payload["step"]
        self.best_metric, self.best_epoch = payload["best_epe"], payload["best_epoch"]
        self._log(f"resumed from epoch {self.epoch}, step {self.step}")

    def _save(self, name: str, with_optimizer: bool, epe: float = -1.0) -> Optional[str]:
        """``<name>.pt`` and the flax pair ``<name>.msgpack``/``.json``
        beside it, on rank 0; returns the ``.pt`` path there."""
        if not self.is_writer:
            return None
        ckpt_dir = self.cfg.train.checkpoint_dir
        path = os.path.join(ckpt_dir, name + ".pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        meta = dict(epoch=self.epoch, step=self.step, epe=epe, best_epe=self.best_metric,
                    best_epoch=self.best_epoch)
        payload = dict(model=self.model.state_dict(), **meta)
        if with_optimizer:
            payload["optimizer"] = self.optimizer.state_dict()
        torch.save(payload, path)
        save_flax_checkpoint(ckpt_dir, name, self.model, **meta)
        return path
