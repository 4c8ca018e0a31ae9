#!/usr/bin/env python3
"""Smoke run of the PyTorch port (aanet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit; pins float32 (TF32 off);
2. builds the kernel libraries (five sources in aanet_torch/csrc/, one
   nvcc each, in parallel) and times the build;
3. drives the ``aanet`` preset's forward (batch 1, 384x1248, float32,
   seeded random weights with non-zero offset heads and ZeroNorm scales,
   BatchNorm statistics calibrated on the input) once through the plain
   PyTorch versions of the kernels, recording every kernel call's shape,
   and holds each kernel against its plain version at each of those
   shapes on seeded inputs, timing kernel, plain version and, where one
   exists, the single PyTorch call that computes the same function;
4. sets every launch counter to 0, drives the same forward through the
   kernels, checks the launch counts and holds the pyramid against the
   plain run's; times the forward and reads its peak memory;
5. runs the ``predict`` CLI on the card on two 375x1242 PNG pairs (pad to
   a multiple of 48, crop back) with the seeded weights;
5b. the 3-D-aggregation baselines and ``stereonet-aa``: for the PSMNet
   baseline (concat volume, three 3-D hourglasses) and PSMNet with the
   basic aggregation, the StereoNet baseline (difference volume, four 3-D
   convs, two refinements), GC-Net (concat volume at H/2, the 3-D
   encoder-decoder; its map is 383x1247) and the ``stereonet-aa`` preset,
   each at 384x1248, batch 1, max_disp 192, seeded and calibrated: the
   forward through the plain twins with every kernel call's shape, each
   kernel against its twin at those shapes (the difference and concat
   volumes bit for bit), the forward through the kernels with its launch
   counts and its pyramid against the plain one, its latency, peak
   memory, idle share and top device kernels; then ``predict`` with the
   PSMNet baseline's flags on two 375x1242 pairs;
6. times each backward kernel (and each forward kernel again) against its
   plain version at the shapes that one plain train step of the ``aanet``
   preset at batch 16, 288x576 records, with the bound and, for warp,
   F.grid_sample's forward plus backward as the library yardstick;
6b. holds the deformable conv's forward, its input/offset/mask gradient
   and its weight gradient against their twins beyond the path's inputs
   (offsets in (-16, 16) px, integer offsets, mask-less with one group, a
   stride-2 shape of odd sizes; for the forward also a shape whose plan
   splits the input channels over blocks) and times each with the wide
   offsets at the step's largest shape; checks that two launches of the
   weight gradient give the same bits at every step shape; the warp
   forward at widths that are not a multiple of 4; the warp backward: two
   launches give the same bits at the step's shapes, each timed beside its
   bound, and against its twin at ``WARP_EDGE_SHAPES``; the correlation's
   forward and backward: two launches give the same bits at every path
   shape (the aanet step's and inference's, stereonet-aa's), each timed
   beside its bound, and both against their twins at widths 37 and 53,
   channels 3 and 37, D > W, D = 1, 24 and 40, batch 3, and the backward
   at D = 0; the soft-argmin's forward and backward: two launches give the
   same bits at every path shape (the aanet step's and inference's, each
   baseline's and stereonet-aa's, ``SA_PATHS``), each timed beside its
   bound, both against their twins with both signs at planes that are not
   a multiple of 4, planes smaller than a tile, D = 1, 37 and 191, batch 3,
   and at D = 0 the forward gives zeros and the backward an empty gradient;
   the three deformable-conv kernels at 4, 6, 12 and 20 output channels
   (no multiple of 8 up to 128 divides them: zero-padded channel tiles)
   with narrow, wide and integer offsets at 96x192 and 24x48, two
   weight-gradient launches bitwise, each timed at batch 16, 96x192;
7. on each of three seeded batches (batch 2, 288x576), runs one train
   step through the kernels and the same step through the plain twins
   (seeded weights) and compares the loss, every parameter's gradient
   (against the plain step's largest change under three 1e-6 input
   changes) and the BatchNorm statistics; every parameter must get a
   non-zero gradient, and three steps on the batch must lower the loss;
8. the full-width train step: batch 16, 288x576, float32, remat on; the
   launch counts of one step, then the median step time over 10 steps
   after 2 warm-ups, samples/s, peak memory and the device idle share;
9. runs ``python -m aanet_torch.cli train`` under ``python -m
   torch.distributed.run --standalone --nproc_per_node 1`` (a process
   group of one: NCCL comes up on the card) with ``--print_freq 1
   --summary_freq 1`` for 2 steps at batch 16 on a synthetic
   SceneFlow-layout dataset that it writes itself (32 pairs of 540x960
   PNGs with PFM disparities and filename lists), checks the losses, the
   checkpoint, the ``time ... ETA`` log lines, the summaries under
   ``tb/``, ``lossRecord.mat`` and ``valLossRecord.mat``, validation
   sample 0's analysis ``.mat`` and the flax pair (read back strictly into
   a fresh model whose forward equals the ``.pt`` weights' bit for bit),
   and predicts with the written weights;
9b. the trained anchor's setting: the ``aanet`` preset at max_disp 48 (ISA
   deformable convs of 16, 8 and 4 output channels): its forward at
   384x1248 through the kernels against the plain run, one train step at
   batch 2, 288x576 against the plain step, and ``python -m
   aanet_torch.cli predict --preset aanet --max_disp 48`` on two 375x1242
   pairs;
10. the train steps of phase 5b's five configurations (the PSMNet
   baseline with either aggregation, StereoNet, GC-Net, ``stereonet-aa``)
   at 288x576, max_disp 192, remat on: a kernel
   step against a plain step at batch 2, whose plain run records every
   kernel call's shape; each forward and backward kernel against its
   twin at those shapes at the full step's batch (the two volume
   backwards bit for bit); then the full-width step at batch 16, halved
   until a step fits the card, with its launch counts per step, the
   median step time over 3 steps after 2 warm-ups, samples/s, peak
   memory, idle share and top device kernels (one profiled step); then
   ``python -m aanet_torch.cli train`` with the PSMNet baseline's flags for 4 steps
   at batch 8 on phase 9's dataset, and ``predict`` with the weights it
   wrote;
10b. the 4-D volume kernels (difference and concat, forward and
   backward): two launches give the same bits at every path shape
   (``VOL_PATHS``, which must hold the shapes phases 5b and 10 recorded),
   each timed beside its bound; and bit for bit against their twins at
   widths that are not a multiple of 4, W < D, D = 1, odd C, batch 3, rows
   wider than a backward block, and the backward at D = 0;
11. the adaptive-aggregation presets on PSMNet's and GC-Net's features,
   ``psmnet-aa`` and ``gcnet-aa`` (the strided feature pyramid, one
   aggregated volume; ISA convs of 48/24/12 and 96/48/24 channels), at
   max_disp 192: each forward at 384x1248, batch 1, seeded and calibrated,
   through the plain twins with every kernel call's shape, each kernel
   against its twin at those shapes, then through the kernels with its
   launch counts (deform 9, correlation 3, soft-argmin 1, warp 2 or 1),
   its pyramid against the plain one (and, recorded, the plain path's
   change under a 1e-6 input change and the kernel path's re-run), its
   latency, peak memory and idle share; ``python -m aanet_torch.cli
   predict --preset psmnet-aa`` on two 375x1242 pairs; a kernel train
   step against a plain one at batch 2, 288x576, for each (``gcnet-aa``'s with the final map's loss only: the
   loss has no weights for its pyramid of two), and ``psmnet-aa``'s full
   step at batch 16, halved until it fits, with its launches, step time,
   samples/s, peak memory and idle share, and each kernel against its twin
   at that step's shapes;
12. the JAX package's trained anchor (artifacts/aanet_synthetic_best.msgpack.gz,
   ``aanet`` at max_disp 48) through the port's entry points on the set it
   was trained on (``write_synthetic``: 16 pairs of 96x192): ``python -m
   aanet_torch.cli evaluate`` (EPE below 2.0 px), the same evaluation in
   this process through the plain twins (EPE within 1e-3 px), and
   ``inference --count_time --save_type pfm`` (its mean seconds per pair);
13. AANet+ and ``ganet-aa`` (GANet's UNet features at H/3 through the
   strided pyramid; ``aanet+`` with five maps and two hourglass
   refinements, ``ganet-aa`` with one aggregated volume and two StereoDRNet
   refinements) at max_disp 192, as phase 11 runs its presets: each
   forward at 384x1248 (its seeded BatchNorm scales drawn in (0.25, 0.75):
   ``PLUS_FORWARD_BN_SCALE``) through the plain twins with every kernel
   call's shape, each kernel against its twin at those shapes, then
   through the kernels with its launch counts (deform 24 or 14,
   correlation 3, soft-argmin 3 or 1, warp 2), its pyramid against the
   plain one (and, recorded, the plain path's change under a 1e-6 input
   change and the kernel path's re-run), its latency, peak memory and
   idle share; ``python -m aanet_torch.cli
   predict --preset aanet+`` on two 375x1242 pairs; a kernel train step
   against a plain one for each on phase 7's three seeded batches (each
   parameter against the plain step's spread and the kernel step's own
   re-run, three steps lowering the loss), ``aanet+``'s full step at batch
   16, halved until it fits, with its launches, step time, samples/s, peak
   memory and idle share, and each kernel against its twin at that step's
   shapes; then ``python -m aanet_torch.cli train --preset aanet+
   --save_ckpt_freq 1`` for one epoch on phase 9's dataset and again with
   ``--resume --max_epoch 2``, which must restore epoch 1 and its step;
14. bf16 serving: ``aanet`` and ``aanet+`` at max_disp 192 with phases 4's
   and 13's seeded, calibrated weights in ``dtype="bfloat16"``: each
   forward at 384x1248 through the plain bf16 twins with every bf16 kernel
   call's shape, each bf16 kernel (the ``_bf16`` entry points of the
   deformable conv, correlation, soft-argmin and warp forwards) against its
   twin at those shapes (one bf16 ulp of the output's scale; soft-argmin's
   float32 disparity 1e-4 px), timed beside its bound, its float32 kernel
   at the same shapes and, for the warp, F.grid_sample in bf16; then
   through the kernels with its launch counts (deform 15 or 24,
   correlation 3, soft-argmin 3, warp 2; no float32 kernel), every kernel
   call of that path against its twin on the path's own inputs, the
   pyramid against the plain bf16 one and the float32 one (a loose guard:
   the random networks are chaotic in bf16), its latency, peak memory and
   idle share beside the float32 forward's of phases 4 and 13, and the
   float32 and bf16 forwards in turns with the host's enqueue time beside
   each latency; the trained anchor at 384x1248 in bf16 through the
   kernels (the same launch counts as ``aanet``), its pyramid against the
   plain bf16 one within 0.3 px (max) and 0.03 px (mean) per level and
   its final map against float32 within 0.05 px (mean) and 0.2 px (99th
   percentile); ``python -m aanet_torch.cli predict --preset aanet+ --dtype
   bfloat16`` on two 375x1242 pairs; the trained anchor through
   ``evaluate --dtype bfloat16`` on phase 12's set (EPE within 0.15 px of
   phase 12's float32 EPE) and ``inference --count_time --dtype
   bfloat16``;
15. bf16 training (``bf16_training_phases``, ``anchor_bf16_finetune``):
   one plain bf16 train step of ``aanet`` and of ``aanet+`` at batch 2,
   288x576, records every bf16 kernel call; each bf16 form of the five
   backward kernels (the deformable conv's input/offset/mask and weight
   gradients, the correlation's, soft-argmin's and the warp's) against its
   twin at those shapes, also with offsets in (-16, 16) px, at 4, 6, 12 and
   20 output channels, mask-less and at an odd stride-2 shape (one bf16 ulp
   of each bf16 gradient's scale, the float32 form's tolerance for the
   float32 offset and disparity gradients), and the bf16 deform forward at
   those shapes; the bf16 correlation forward (on the tensor cores) and
   backward (both on the tensor cores) at ``CORR_EDGE_SHAPES`` and D = 0,
   the backward also at every ``CORR_PATH_SHAPES`` shape, the bf16
   soft-argmin backward (its slab raw) at ``SA_EDGE_SHAPES`` with both
   signs, the bf16 soft-argmin forward (a kernel of its own) there too and
   at D = 0, the bf16 warp forward and backward at ``WARP_EDGE_SHAPES``
   (the backward's two launches bitwise at the step's shapes, timed); two
   launches of the deform forward, the weight gradient and the correlation
   backward bitwise, and of the correlation forward, the soft-argmin
   backward and the soft-argmin and warp forwards at every step shape, each
   timed beside its bound; every backward kernel call of a kernel
   step against its twin on the path's own inputs; the ``aanet`` bf16
   kernel step against the plain bf16 step on phase 7's three seeded
   batches (loss, all gradients and the BatchNorm statistics within 2 times
   the plain step's spread under one-ulp changes of the left image, and no
   farther than the plain bf16 step from the float32 one; every parameter
   a non-zero gradient; three steps lowering the loss); the full-width
   bf16 steps of ``aanet`` and ``aanet+`` (batch 16) with their launches
   (no float32 kernel), step time, samples/s, peak memory and idle share
   beside phases 8's and 13's float32 steps, and each bf16 kernel, forward
   and backward, at their shapes, timed beside its bound and its float32
   form; then ``python -m
   aanet_torch.cli train --dtype bfloat16`` from the trained anchor for one
   epoch on phase 12's set (its losses beside the same epoch in float32)
   and ``evaluate`` of its float32 checkpoint, in float32 (EPE < 2.0 px)
   and in bf16; then two launches of the deformable conv's float32 and bf16
   forwards at every path shape whose plan splits (slabs summed in a fixed
   order), and of its backward-data kernel in both forms at every path
   shape with narrow and wide offsets (a fixed-point scatter), bit for bit
   (``deform_same_bits``); phases 9b and 13 also read the kernel step's
   re-run change at exactly 0 (both sides under ``deterministic``) and
   record each parameter's distance to the plain step in float64 from the
   kernel step and from the plain float32 step;
16. the 4-D volumes in bf16 (``bf16_volume_phases``): each bf16 volume
   kernel (difference and concat, forward and backward) against its twin
   bit for bit at ``VOL_PATHS`` (two launches bitwise, timed beside its
   bound and its float32 form) and ``VOL_EDGE_SHAPES``; PSMNet (either
   aggregation), StereoNet and GC-Net in ``dtype="bfloat16"`` with phase
   5b's weights: the forward at 384x1248 through the plain bf16 twins,
   each bf16 kernel at its shapes, through the kernels with its launches
   (bf16 forms only), every path call against its twin, the map against
   the plain bf16 and the float32 one, its latency beside phase 5b's
   float32 forward; a bf16 kernel step against the plain one at batch 2
   under phase 15's guard; the full-width bf16 step (batch 16 halved until
   it fits) beside phase 10's float32 step with its top device kernels,
   each bf16 kernel at its shapes (the soft-argmin forward's two launches
   bitwise);
17. data-parallel training on the one card: two processes, a gloo group
   (NCCL refuses two ranks on one device), run the ``aanet`` kernel train
   step at 288x576, float32, global batch 4 (2 a rank, half of one
   sample's disparities beyond max_disp) at accumulation 1 and 2: the
   ranks' parameters, BatchNorm statistics and gradients equal bit for
   bit, within phase 7's limits of the single-process kernel step on the
   same global batch (both under ``deterministic``; the gradients within
   max(1e-3, 2x that step's spread under three 1e-6 input changes)), and
   each rank's launches phase 8's per-step counts times the accumulation;
18. prints the kernels' JSON line (the bf16 forms too) and, last,
   {"ok": true, "device": ...}.

Any failure raises, so the exit code is non-zero and the last line is not
printed. Without CUDA, or without the aanet_torch package beside it, the
script exits non-zero before printing anything.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import copy
import dataclasses
import functools
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
DEVICE = "cuda"  # the card the run drives; without one the script fails
HEIGHT, WIDTH = 384, 1248  # KITTI, the reference's inference protocol
PREDICT_HW = (375, 1242)  # a KITTI image size that is not a multiple of 48
# one forward of the aanet preset: 6 layer3 + 9 ISA deformable convs, 3
# scales of correlation and soft-argmin, refinements at H/2 and H
EXPECTED_LAUNCHES = {"deform_conv": 15, "correlation": 3, "soft_argmin": 3, "disp_warp": 2,
                     "difference_volume": 0, "concat_volume": 0}
# the training slice: the SceneFlow crop (aanet_tpu/config.py:59-60,174) at
# the reference's per-card batch (64 over 4 cards, BASELINE.md:27)
TRAIN_HW = (288, 576)
TRAIN_BATCH = 16
COMPARE_BATCH = 2  # the kernel-vs-plain train step
COMPARE_SEEDS = (0, 1, 2)  # phase 7's batches: one generator each
NUDGES = 3  # 1e-6 input changes that estimate the plain step's spread
# one train step with remat: the 21 deformable convs (12 of layer3 over two
# feature passes, 9 ISA) and the 2 warps run again when backward recomputes
# their checkpointed block
EXPECTED_TRAIN_LAUNCHES = {
    "deform_conv": 42, "deform_conv_backward_data": 21, "deform_conv_backward_weight": 21,
    "correlation": 3, "correlation_backward": 3, "soft_argmin": 3, "soft_argmin_backward": 3,
    "disp_warp": 4, "disp_warp_backward": 2, "difference_volume": 0, "concat_volume": 0,
    "difference_volume_backward": 0, "concat_volume_backward": 0,
}
# the 3-D-aggregation baselines (reached through the model flags, as in the
# JAX CLI) and the stereonet-aa preset, at the inference protocol's size:
# launches per forward, the pyramid's shapes at 384x1248, and the launches
# per train step (remat on: stereonet-aa's deformable convs run again when
# backward recomputes their AAModule; the 3-D aggregations are
# checkpointed as a whole, and the volumes and soft-argmin lie outside)
_FULL, _STEREO = [(1, HEIGHT, WIDTH)], [(1, HEIGHT // k, WIDTH // k) for k in (4, 2, 1)]
BASELINES = {
    "psmnet": dict(
        flags=dict(feature_type="psmnet", feature_similarity="concat",
                   aggregation_type="psmnet_hourglass", refinement_type="None"),
        launches={"concat_volume": 1, "soft_argmin": 1}, shapes=_FULL,
        train_launches={"concat_volume": 1, "concat_volume_backward": 1,
                        "soft_argmin": 3, "soft_argmin_backward": 3}),
    "psmnet_basic": dict(
        flags=dict(feature_type="psmnet", feature_similarity="concat",
                   aggregation_type="psmnet_basic", refinement_type="None"),
        launches={"concat_volume": 1, "soft_argmin": 1}, shapes=_FULL,
        train_launches={"concat_volume": 1, "concat_volume_backward": 1,
                        "soft_argmin": 1, "soft_argmin_backward": 1}),
    "stereonet": dict(
        flags=dict(feature_type="stereonet", feature_similarity="difference",
                   aggregation_type="stereonet", refinement_type="stereonet"),
        launches={"difference_volume": 1, "soft_argmin": 1}, shapes=_STEREO,
        train_launches={"difference_volume": 1, "difference_volume_backward": 1,
                        "soft_argmin": 1, "soft_argmin_backward": 1}),
    "gcnet": dict(
        flags=dict(feature_type="gcnet", feature_similarity="concat", aggregation_type="gcnet",
                   num_downsample=1, refinement_type="None"),
        # the reference's transposed-conv arithmetic: one pixel short
        launches={"concat_volume": 1, "soft_argmin": 1}, shapes=[(1, HEIGHT - 1, WIDTH - 1)],
        train_launches={"concat_volume": 1, "concat_volume_backward": 1,
                        "soft_argmin": 1, "soft_argmin_backward": 1}),
    "stereonet-aa": dict(
        preset="stereonet-aa",
        launches={"correlation": 1, "deform_conv": 4, "soft_argmin": 1}, shapes=_STEREO,
        train_launches={"correlation": 1, "correlation_backward": 1, "deform_conv": 8,
                        "deform_conv_backward_data": 4, "deform_conv_backward_weight": 4,
                        "soft_argmin": 1, "soft_argmin_backward": 1}),
}
# parameters whose gradient is zero in exact arithmetic (rounding noise on
# both paths): the bias of StereoNet's last 3-D conv adds one constant to
# every candidate of the volume, and soft-argmin is invariant to that
ZERO_GRADIENT = {"aggregation.Conv_4.Conv_0.bias"}
CLI_PAIRS, CLI_HW = 32, (540, 960)  # SceneFlow's image size
CLI_BASELINE, CLI_BASELINE_BATCH = "psmnet", 8  # phase 10's train entry point
VAL_HW = (576, 960)  # the SceneFlow recipe's validation crop (pads 540 to 576)
# The correlation volumes of the paths ((L and R shape), max_disp), by path:
# the aanet train step's and inference forward's three scales, stereonet-aa's
# one at inference and in its train step, and the three scales of
# psmnet-aa's (H/4, 32/64/128 channels) and gcnet-aa's (H/2) pyramids at
# inference and of psmnet-aa's train step, and those of GANet's features
# (H/3, 32/64/128 channels) in aanet+'s and ganet-aa's forwards and
# aanet+'s step
CORR_PATHS = {
    "aanet step": (((16, 128, 96, 192), 64), ((16, 128, 48, 96), 32), ((16, 128, 24, 48), 16)),
    "aanet inference": (((1, 128, 128, 416), 64), ((1, 128, 64, 208), 32), ((1, 128, 32, 104), 16)),
    "stereonet-aa inference": (((1, 32, 96, 312), 48),),
    "stereonet-aa step": (((16, 32, 72, 144), 48),),
    "psmnet-aa inference": (((1, 32, 96, 312), 48), ((1, 64, 48, 156), 24), ((1, 128, 24, 78), 12)),
    "gcnet-aa inference": (((1, 32, 192, 624), 96), ((1, 64, 96, 312), 48),
                           ((1, 128, 48, 156), 24)),
    "psmnet-aa step": (((16, 32, 72, 144), 48), ((16, 64, 36, 72), 24), ((16, 128, 18, 36), 12)),
    "aanet+ inference": (((1, 32, 128, 416), 64), ((1, 64, 64, 208), 32), ((1, 128, 32, 104), 16)),
    "ganet-aa inference": (((1, 32, 128, 416), 64), ((1, 64, 64, 208), 32),
                           ((1, 128, 32, 104), 16)),
    "aanet+ step": (((16, 32, 96, 192), 64), ((16, 64, 48, 96), 32), ((16, 128, 24, 48), 16)),
}
CORR_PATH_SHAPES = list(dict.fromkeys(sig for sigs in CORR_PATHS.values() for sig in sigs))
# and the shapes beyond them: widths that are not a multiple of 4 (37, 53),
# channels off the chunks (3, 37), D > W, D = 1, 24 and 40, batch 3; the
# backward also at D = 0
CORR_EDGE_SHAPES = [
    ((2, 128, 6, 37), 64), ((2, 128, 6, 53), 32), ((2, 3, 6, 64), 16), ((2, 37, 6, 64), 48),
    ((1, 32, 4, 24), 64), ((2, 32, 6, 64), 1), ((2, 32, 6, 64), 24), ((2, 32, 6, 64), 40),
    ((3, 64, 6, 96), 32),
]
# The soft-argmin volumes of the paths (([B, D, H, W]), match_similarity), by
# path: the aanet train step's and inference forward's three scales (a
# correlation volume is a similarity), the baselines' one at inference
# (384x1248) and in their train steps (288x576, at the batch phase 10 fits;
# the PSMNet hourglass step launches its shape three times). A difference or
# GC-Net's concat volume is a matching cost, PSMNet's a similarity; psmnet-aa's
# and gcnet-aa's single aggregated volume is a similarity at H/4 and H/2,
# ganet-aa's at H/3; aanet+'s three are aanet's.
SA_PATHS = {
    "aanet step": (((16, 64, 96, 192), True), ((16, 32, 48, 96), True), ((16, 16, 24, 48), True)),
    "aanet inference": (((1, 64, 128, 416), True), ((1, 32, 64, 208), True),
                        ((1, 16, 32, 104), True)),
    "psmnet inference": (((1, 192, 384, 1248), True),),
    "gcnet inference": (((1, 191, 383, 1247), False),),
    "stereonet inference": (((1, 48, 96, 312), False),),
    "stereonet-aa inference": (((1, 48, 96, 312), True),),
    "psmnet step": (((16, 192, 288, 576), True),),
    "gcnet step": (((8, 191, 287, 575), False),),
    "stereonet step": (((16, 48, 72, 144), False),),
    "stereonet-aa step": (((16, 48, 72, 144), True),),
    "psmnet-aa inference": (((1, 48, 96, 312), True),),
    "gcnet-aa inference": (((1, 96, 192, 624), True),),
    "psmnet-aa step": (((16, 48, 72, 144), True),),
    "aanet+ inference": (((1, 64, 128, 416), True), ((1, 32, 64, 208), True),
                         ((1, 16, 32, 104), True)),
    "ganet-aa inference": (((1, 64, 128, 416), True),),
    "aanet+ step": (((16, 64, 96, 192), True), ((16, 32, 48, 96), True), ((16, 16, 24, 48), True)),
}
SA_PATH_SHAPES = list(dict.fromkeys(sig for sigs in SA_PATHS.values() for sig in sigs))
# and the shapes beyond them, each with both signs: planes that are not a
# multiple of 4 (63, 135, 15), planes smaller than one tile (63, 15), a
# ragged last tile (480), D = 1, 37 and 191, batch 3
SA_EDGE_SHAPES = [
    (shape, match) for shape in ((2, 37, 7, 9), (2, 1, 6, 64), (3, 191, 5, 27), (3, 37, 12, 40),
                                 (1, 24, 3, 5), (2, 191, 16, 100))
    for match in (True, False)
]
# The warps of the paths (the right image [B, 3, H, W] at each refinement's
# scale), by path: the aanet train step's two (each launched twice, remat
# recomputing its refinement) and inference's two; aanet+, psmnet-aa and
# ganet-aa warp at the same shapes, gcnet-aa at the second only
WARP_PATHS = {
    "aanet step": ((16, 3, 288, 576), (16, 3, 144, 288)),
    "aanet inference": ((1, 3, 384, 1248), (1, 3, 192, 624)),
}
# and the widths beyond them, none a multiple of 8 (all but 1244 not of 4:
# rows unaligned, a last partial quad; 2: the narrowest image the warp
# takes), at batch 2
WARP_EDGE_SHAPES = [(2, 3, 5, w) for w in (2, 9, 63, 575, 1244)] + [(2, 3, 37, 61)]
# The 4-D volumes of the paths (([B, C, H, W] of L and R, D), concat), by
# path: the baselines' at inference (384x1248: PSMNet, either aggregation,
# and GC-Net concat, StereoNet difference) and in their train steps
# (288x576, at the batch phase 10 fits)
VOL_PATHS = {
    "psmnet inference": (((1, 32, 96, 312), 48), True),
    "gcnet inference": (((1, 32, 192, 624), 96), True),
    "stereonet inference": (((1, 32, 96, 312), 48), False),
    "psmnet step": (((16, 32, 72, 144), 48), True),
    "gcnet step": (((8, 32, 144, 288), 96), True),
    "stereonet step": (((16, 32, 72, 144), 48), False),
}
# and the shapes beyond them, for both volumes: widths that are not a
# multiple of 4 (37, 53, 61, 4099), odd C (3), W < D, D = 1, batch 3, rows
# wider than a backward block (4099, 29056); the backward also at D = 0
VOL_EDGE_SHAPES = [
    ((2, 3, 6, 37), 5), ((2, 4, 5, 53), 48), ((2, 4, 6, 20), 32), ((3, 8, 6, 64), 1),
    ((3, 3, 4, 61), 24), ((1, 2, 3, 4099), 40), ((1, 2, 2, 29056), 12),
]
# Phase 6b's output-channel counts of the deformable conv that its
# forward and weight gradient reach with zero-padded channel tiles
ODD_COUTS = (4, 6, 12, 20)
# the trained anchor and its setting; phase 12 holds its EPE on the set it
# was trained on below ANCHOR_EPE px, as tests/test_torch_trained.py holds
# the JAX model's
ANCHOR = os.path.join("artifacts", "aanet_synthetic_best.msgpack.gz")
ANCHOR_MAX_DISP = 48
ANCHOR_EPE = 2.0
# Phase 11: the adaptive aggregation on PSMNet's and GC-Net's features
# (the strided pyramid, one aggregated volume) at max_disp 192: launches per
# forward (9 deformable ISA convs, the last 3 of 6 fusions at 3 scales; a
# correlation a scale; one soft-argmin; a warp a refinement), the pyramid's
# shapes at 384x1248, and the launches per train step (remat on: the
# deformable convs and the warps run again when backward recomputes their
# AAModule and refinement stage). gcnet-aa trains on its final map only.
_AA_STEP = {"deform_conv": 18, "deform_conv_backward_data": 9, "deform_conv_backward_weight": 9,
            "correlation": 3, "correlation_backward": 3, "soft_argmin": 1,
            "soft_argmin_backward": 1}
AA_PRESETS = {
    "psmnet-aa": dict(
        launches={"deform_conv": 9, "correlation": 3, "soft_argmin": 1, "disp_warp": 2},
        shapes=[(1, HEIGHT // k, WIDTH // k) for k in (4, 2, 1)], couts=[12, 24, 48],
        train_launches=dict(_AA_STEP, disp_warp=4, disp_warp_backward=2), highest_loss_only=False),
    "gcnet-aa": dict(
        launches={"deform_conv": 9, "correlation": 3, "soft_argmin": 1, "disp_warp": 1},
        shapes=[(1, HEIGHT // k, WIDTH // k) for k in (2, 1)], couts=[24, 48, 96],
        train_launches=dict(_AA_STEP, disp_warp=2, disp_warp_backward=1), highest_loss_only=True),
}
AA_FULL_STEP = "psmnet-aa"  # the preset whose full-width step phase 11 times
# The seeded networks draw their BatchNorm scales uniform in BN_SCALE. Phase
# 13's forwards draw them in PLUS_FORWARD_BN_SCALE: with BN_SCALE the
# networks on GANet's features are chaotic in eval mode (a 1e-6 relative
# change of the left image moved the plain path's final map by 0.058 px,
# aanet+, and 0.091 px, ganet-aa, on an H100, past the 5e-2 px tolerance,
# and the kernel path sat at 0.027 and 0.046 px from the plain one; the
# smaller scales calm the aggregation and the UNet). Their train steps keep
# BN_SCALE, as every other phase's: with the smaller scales the plain
# step's spread under input changes shrinks below float32's own rounding
# of a few near-cancelling sums (PERF.md §6).
BN_SCALE = (0.5, 1.5)
PLUS_FORWARD_BN_SCALE = (0.25, 0.75)
# Phase 13: GANet's UNet features at H/3 (five deformable convs) through the
# strided pyramid at max_disp 192; aanet+ with intermediate supervision and
# two hourglass refinements (five deformable convs each), ganet-aa with one
# output and two StereoDRNet refinements. Launches per forward, the
# pyramid's shapes at 384x1248, the deformable convs' output channels (ISA
# 64/32/16, the UNet's 32/96/128), and per train step (remat on: each view's
# feature pass, each AAModule and each refinement stage run again in
# backward, and the hourglass's Conv2x a third time inside its stage). The
# train steps are compared on phase 7's three seeded batches, each parameter
# against the plain step's spread and the kernel step's own re-runs.
_PLUS_COUTS = [16, 32, 64, 96, 128]
PLUS_PRESETS = {
    "aanet+": dict(
        launches={"deform_conv": 24, "correlation": 3, "soft_argmin": 3, "disp_warp": 2},
        shapes=[(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)], couts=_PLUS_COUTS,
        train_launches={"deform_conv": 62, "deform_conv_backward_data": 29,
                        "deform_conv_backward_weight": 29, "correlation": 3,
                        "correlation_backward": 3, "soft_argmin": 3, "soft_argmin_backward": 3,
                        "disp_warp": 4, "disp_warp_backward": 2},
        highest_loss_only=False, seeds=COMPARE_SEEDS, forward_bn_scale=PLUS_FORWARD_BN_SCALE),
    "ganet-aa": dict(
        launches={"deform_conv": 14, "correlation": 3, "soft_argmin": 1, "disp_warp": 2},
        shapes=[(1, HEIGHT // k, WIDTH // k) for k in (3, 2, 1)], couts=_PLUS_COUTS,
        train_launches={"deform_conv": 38, "deform_conv_backward_data": 19,
                        "deform_conv_backward_weight": 19, "correlation": 3,
                        "correlation_backward": 3, "soft_argmin": 1, "soft_argmin_backward": 1,
                        "disp_warp": 4, "disp_warp_backward": 2},
        highest_loss_only=False, seeds=COMPARE_SEEDS, forward_bn_scale=PLUS_FORWARD_BN_SCALE),
}
PLUS_FULL_STEP = "aanet+"  # the preset whose full-width step and entry points phase 13 runs
# Phase 14: the presets served in bfloat16, with phase 4's and phase 13's
# seeded weights (and BatchNorm scales), their bf16 launches per forward and
# the pyramid's shapes at 384x1248
BF16_PRESETS = {
    "aanet": dict(bn_scale=BN_SCALE, shapes=[(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)],
                  launches={"deform_conv_bf16": 15, "correlation_bf16": 3, "soft_argmin_bf16": 3,
                            "disp_warp_bf16": 2}),
    "aanet+": dict(bn_scale=PLUS_FORWARD_BN_SCALE,
                   shapes=[(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)],
                   launches={"deform_conv_bf16": 24, "correlation_bf16": 3, "soft_argmin_bf16": 3,
                             "disp_warp_bf16": 2}),
}
# the trained anchor's EPE through evaluate in bf16 against phase 12's
# float32 EPE (tests/test_bf16_trained.py's mean bound for the maps)
ANCHOR_BF16_EPE = 0.15
# Phase 14's whole-network bf16 check: the trained anchor at 384x1248 on an
# in-distribution pair (the smoothed noise of its training set, shifted by
# ANCHOR_SHIFT px). Its bf16 pyramid through the kernels against the plain
# bf16 one, (max, mean) px per level: an H100 read at most 0.129 and 0.0167
# (the final level), and the kernel path 0.096 and 0.0073 from itself when
# run again (the split deform plans then added with float atomics, and one
# flipped bf16 rounding moves the maps as far as bf16 itself does: the plain bf16
# path sat 0.147 and 0.0176 from float32). Its final map against its
# float32 forward's, (mean, 99th percentile) px: read 0.0176 and 0.0587
ANCHOR_SHIFT = 6
ANCHOR_BF16_PYRAMID_PX = (0.3, 0.03)
ANCHOR_BF16_F32_PX = (0.05, 0.2)
# Phase 15: bf16 training. Launches per bf16 train step (remat: as the
# float32 steps', every one in its bf16 form), of ``aanet`` (phases 7 and 8)
# and ``aanet+`` (phase 13)
BF16_TRAIN_PRESETS = {
    "aanet": {"deform_conv_bf16": 42, "deform_conv_backward_data_bf16": 21,
              "deform_conv_backward_weight_bf16": 21, "correlation_bf16": 3,
              "correlation_backward_bf16": 3, "soft_argmin_bf16": 3, "soft_argmin_backward_bf16": 3,
              "disp_warp_bf16": 4, "disp_warp_backward_bf16": 2},
    "aanet+": {"deform_conv_bf16": 62, "deform_conv_backward_data_bf16": 29,
               "deform_conv_backward_weight_bf16": 29, "correlation_bf16": 3,
               "correlation_backward_bf16": 3, "soft_argmin_bf16": 3,
               "soft_argmin_backward_bf16": 3, "disp_warp_bf16": 4, "disp_warp_backward_bf16": 2},
}
# the anchor's bf16 fine-tune through the train entry point: one epoch at
# the anchor's last learning rate scaled down (it ended at 2.5e-4, and
# one epoch at that rate moved its EPE from 1.945 to 1.996 px on the CPU,
# in either dtype), so that EPE < ANCHOR_EPE still tells a working
# fine-tune from a broken one
ANCHOR_FINETUNE_LR = 2e-5
ANCHOR_FINETUNE_BATCH = 4
# H100 SXM peaks (NVIDIA data sheet, at 700 W, dense): HBM bytes/s, float32
# FLOP/s outside the tensor cores (the kernels run float32 FMA on the CUDA
# cores), and bf16 FLOP/s on the tensor cores with float32 accumulation, the
# least time of a product of two bf16 operands
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
PLAIN_ITERS = 5  # timed runs of a plain twin (a yardstick, many times slower than its kernel)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_times(cost):
    """(bytes ms, operations ms) of a spec's ``cost``: (bytes, FLOPs) or
    (bytes, FLOPs, the FLOPs of those that multiply two bf16 operands).
    Those go at the bf16 tensor-core peak, the rest at the float32 peak;
    the two units run side by side, so the operations take the longer."""
    nbytes, flops, tensor = (*cost, 0)[:3]
    ops_s = max((flops - tensor) / PEAK_F32_FLOP_S, tensor / PEAK_BF16_FLOP_S)
    return nbytes / PEAK_BYTES_S * 1e3, ops_s * 1e3


class Timer:
    """Median over CUDA events of ``iters`` runs after ``warmup`` runs; the
    L2 cache (50 MB) is flushed before each timed run, so every run reads
    its inputs from device memory as a layer of the forward mostly does.

    After the flush the device spins for ``SPIN_CYCLES`` clock cycles
    before the start event, while the host enqueues the run: without it,
    the device idled from the end of the flush until the run's first
    kernel arrived (the op's Python path: autograd, checks, allocations,
    the ctypes call), and that idle time was counted as the run's."""

    SPIN_CYCLES = 1_000_000  # about 0.5 ms at the H100's clocks

    def __init__(self, device, clean=False):
        self.scratch = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
        # the flush leaves the L2 full of dirty lines, which the run's reads
        # then evict to device memory; with ``clean`` the flush goes on to
        # read a 64 MB buffer, so the run finds clean lines
        self.clean = torch.zeros(16 * 2**20, dtype=torch.float32, device=device) if clean else None

    def ms(self, fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            self.scratch.zero_()
            if self.clean is not None:
                self.clean.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


# --------------------------------------------------------------------------
# The kernel ops: their plain twins, call signatures, seeded inputs,
# tolerances, bounds and single-call yardsticks
# --------------------------------------------------------------------------


def kernel_specs():
    from aanet_torch.ops import cost_volume, deform, softargmin, warp

    def deform_sig(x, offset, mask, weight, bias=None, *, stride=1, padding=0,
                   dilation=1, deformable_groups=1):
        return (tuple(x.shape), tuple(weight.shape), mask is not None, bias is not None,
                stride, padding, dilation, deformable_groups)

    def deform_inputs(sig, gen, dev, offsets="narrow"):
        """Seeded inputs; ``offsets``: "narrow" fractional in (-3, 3) px,
        "wide" fractional in (-16, 16) px (beyond the backward-data
        kernel's window halo), "integer" in {-3, ..., 3} (jnp.clip's tie)."""
        xs, ws, has_mask, has_bias, stride, pad, dil, g = sig
        b, cin, h, w = xs
        cout, _, kh, kw = ws
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2 = kh * kw
        rand = lambda *s: torch.rand(s, generator=gen, device=dev)  # noqa: E731
        if offsets == "integer":
            offset = torch.randint(-3, 4, (b, g * k2 * 2, ho, wo), generator=gen, device=dev).float()
        else:
            reach = {"narrow": 3.0, "wide": 16.0}[offsets]
            offset = (rand(b, g * k2 * 2, ho, wo) * 2 - 1) * reach
        args = (
            torch.randn(xs, generator=gen, device=dev),
            offset,
            rand(b, g * k2, ho, wo) * 2 if has_mask else None,  # masks in (0, 2)
            torch.randn(ws, generator=gen, device=dev) / (cin * k2) ** 0.5,
            torch.randn(cout, generator=gen, device=dev) if has_bias else None,
        )
        return args, dict(stride=stride, padding=pad, dilation=dil, deformable_groups=g)

    def deform_cost(sig):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, has_bias, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        elems = (b * cin * h * w + pix * g * k2 * (3 if has_mask else 2)
                 + cout * cin * k2 + (cout if has_bias else 0) + pix * cout)
        # contraction FMAs + bilinear blend of each sample (4 mul, 3 add, 1 mask)
        flops = pix * (2 * cout * cin * k2 + 8 * cin * k2)
        return 4 * elems, flops

    def corr_inputs(sig, gen, dev):
        shape, d = sig
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev), d), {}

    def corr_cost(sig):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))  # only w >= d is computed
        return 4 * (2 * b * c * h * w + b * d * h * w), 2 * b * c * h * band

    def sa_inputs(sig, gen, dev):
        shape, match = sig
        return (torch.randn(shape, generator=gen, device=dev) * 3, match), {}

    def sa_cost(sig):
        (b, d, h, w), _ = sig
        # per element: compare, subtract, exp, add, multiply-add
        return 4 * (b * d * h * w + b * h * w), 5 * b * d * h * w

    def warp_inputs(sig, gen, dev):
        (shape,) = sig
        b, c, h, w = shape
        disp = torch.rand((b, h, w), generator=gen, device=dev) * 216 - 16  # off both edges
        return (torch.randn(shape, generator=gen, device=dev), disp), {}

    def warp_cost(sig):
        ((b, c, h, w),) = sig
        return 4 * (2 * b * c * h * w + 2 * b * h * w), b * h * w * (3 * c + 10)

    def warp_library(img, disp):
        """F.grid_sample with border padding at (x - disp, y): the warped image."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1)
        return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

    def vol_inputs(sig, gen, dev):
        shape, d = sig
        return (torch.randn(shape, generator=gen, device=dev),
                torch.randn(shape, generator=gen, device=dev), d), {}

    def vol_cost(sig, concat):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))  # one subtraction per w >= d
        return 4 * (2 * b * c * h * w + (2 if concat else 1) * b * c * d * h * w), (
            0 if concat else b * c * h * band)

    def vol_bwd_inputs(sig, gen, dev, concat):
        shape, d = sig
        left, right = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        b, c, h, w = shape
        grad = torch.randn((b, (2 if concat else 1) * c, d, h, w), generator=gen, device=dev)
        return (grad, left, right), {}

    def vol_bwd_cost(sig, concat):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))  # the pairs with w >= d
        # the band of grad read once (w < d never reaches dL or dR), dL and
        # dR written once; one addition per pair for each of the two sums
        return 4 * ((2 if concat else 1) * b * c * h * band + 2 * b * c * h * w), 2 * b * c * h * band

    def rel(scale):
        return lambda ref: scale * float(ref.abs().max())

    fwd = [
        dict(name="deform_conv", module=deform, attr="modulated_deform_conv2d",
             plain=deform.modulated_deform_conv2d_plain, sig=deform_sig,
             inputs=deform_inputs, cost=deform_cost, library=None,
             tol=rel(2e-4), tol_text="2e-4 * max|ref|",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="correlation", module=cost_volume, attr="correlation_cost_volume",
             # the float32 form's own function: the mean summed in float64,
             # rounded once (the kernel agrees to the bit but at ties)
             plain=functools.partial(cost_volume.correlation_cost_volume_plain, exact=True),
             sig=lambda left, right, d: (tuple(left.shape), d),
             inputs=corr_inputs, cost=corr_cost, library=None,
             tol=lambda ref: 1e-4, tol_text="1e-4",
             source="aanet_torch/csrc/correlation.cu",
             replaces="aanet_tpu/ops/cost_volume.py:72"),
        dict(name="soft_argmin", module=softargmin, attr="soft_argmin",
             plain=softargmin.soft_argmin_plain,
             sig=lambda cost, match_similarity=True: (tuple(cost.shape), match_similarity),
             inputs=sa_inputs, cost=sa_cost, library=None,
             # float32 sums over up to 192 candidates: relative to the
             # largest disparity beyond 50 px
             tol=lambda ref: max(1e-4, 2e-6 * float(ref.abs().max())),
             tol_text="max(1e-4, 2e-6 * max|ref|)",
             source="aanet_torch/csrc/softargmin.cu",
             replaces="aanet_tpu/ops/softargmin.py:16"),
        dict(name="disp_warp", module=warp, attr="disp_warp", plain=warp.disp_warp_plain,
             sig=lambda img, disp: (tuple(img.shape),), inputs=warp_inputs, cost=warp_cost,
             library=warp_library, tol=lambda ref: 1e-5, tol_text="1e-5",
             source="aanet_torch/csrc/warp.cu", replaces="aanet_tpu/ops/warp.py:17"),
        dict(name="difference_volume", module=cost_volume, attr="difference_cost_volume",
             plain=cost_volume.difference_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d), inputs=vol_inputs,
             cost=lambda sig: vol_cost(sig, False), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu",
             replaces="aanet_tpu/ops/cost_volume.py:127"),
        dict(name="concat_volume", module=cost_volume, attr="concat_cost_volume",
             plain=cost_volume.concat_cost_volume_plain,
             sig=lambda left, right, d: (tuple(left.shape), d), inputs=vol_inputs,
             cost=lambda sig: vol_cost(sig, True), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu",
             replaces="aanet_tpu/ops/cost_volume.py:144"),
    ]

    # The backward kernels: inputs made from the forward's signature plus a
    # seeded output gradient; bounds count every input read once and every
    # gradient written once.
    def deform_bwd_inputs(sig, gen, dev, offsets="narrow"):
        (x, offset, mask, weight, _), kwargs = deform_inputs(sig, gen, dev, offsets)
        b, _, ho, wo = offset.shape
        gout = torch.randn((b, weight.shape[0], ho, wo), generator=gen, device=dev)
        return (gout, x, offset, mask, weight), kwargs

    def deform_bwd_cost(sig, weight_grad):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, _, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        sampling = pix * g * k2 * (3 if has_mask else 2)
        reads = pix * cout + b * cin * h * w + sampling
        if weight_grad:  # reads + grad_w; contraction FMAs + the sampling
            return 4 * (reads + cout * cin * k2), pix * cin * k2 * (2 * cout + 8)
        # reads incl. the weight + grad_x, grad_offset, grad_mask; the gcol
        # FMAs, then per (c, k, p) the sample, its two derivatives and the
        # four scattered adds (28 operations)
        writes = b * cin * h * w + sampling
        return 4 * (reads + cout * cin * k2 + writes), pix * cin * k2 * (2 * cout + 28)

    def corr_bwd_inputs(sig, gen, dev):
        shape, d = sig
        left, right = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
        b, _, h, w = shape
        return (torch.randn((b, d, h, w), generator=gen, device=dev), left, right), {}

    def corr_bwd_cost(sig):
        (b, c, h, w), d = sig
        band = sum(max(w - i, 0) for i in range(d))
        return 4 * (b * d * h * w + 4 * b * c * h * w), 4 * b * c * h * band

    def sa_bwd_inputs(sig, gen, dev):
        (b, d, h, w), match = sig
        cost = torch.randn((b, d, h, w), generator=gen, device=dev) * 3
        return (torch.randn((b, h, w), generator=gen, device=dev), cost, match), {}

    def sa_bwd_cost(sig):
        (b, d, h, w), _ = sig
        # g and the volume read once, the volume's gradient written once;
        # per element: compare, exp, sums; then exp, products
        return 4 * (b * h * w + 2 * b * d * h * w), 10 * b * d * h * w

    def warp_bwd_inputs(sig, gen, dev):
        (img, disp), _ = warp_inputs(sig, gen, dev)
        return (torch.randn(img.shape, generator=gen, device=dev), img, disp), {}

    def warp_bwd_cost(sig):
        ((b, c, h, w),) = sig
        return 4 * (2 * b * c * h * w + 2 * b * h * w), b * h * w * (3 * c + 10)

    def warp_bwd_library(grad, img, disp):
        """F.grid_sample forward plus its backward for the grid."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1)

        def run():
            with torch.enable_grad():
                g = grid.detach().requires_grad_(True)
                F.grid_sample(img, g, mode="bilinear", padding_mode="border",
                              align_corners=True).backward(grad)
        return run

    by_name = {f["name"]: f for f in fwd}
    bwd = [
        dict(name="deform_conv_backward_data", forward="deform_conv", module=deform,
             attr="modulated_deform_conv2d_backward_data",
             plain=deform.modulated_deform_conv2d_backward_data_plain,
             inputs=deform_bwd_inputs, cost=lambda sig: deform_bwd_cost(sig, False),
             library=None, tol=rel(1e-4), tol_text="1e-4 * max|ref| per gradient",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="deform_conv_backward_weight", forward="deform_conv", module=deform,
             attr="modulated_deform_conv2d_backward_weight",
             plain=deform.modulated_deform_conv2d_backward_weight_plain,
             inputs=deform_bwd_inputs, cost=lambda sig: deform_bwd_cost(sig, True),
             library=None, tol=rel(1e-4), tol_text="1e-4 * max|ref|",
             source="aanet_torch/csrc/deform_conv.cu", replaces="aanet_tpu/ops/deform.py:112"),
        dict(name="correlation_backward", forward="correlation", module=cost_volume,
             attr="correlation_cost_volume_backward",
             plain=cost_volume.correlation_cost_volume_backward_plain,
             inputs=corr_bwd_inputs, cost=corr_bwd_cost, library=None, tol=rel(1e-5),
             tol_text="1e-5 * max|ref| per gradient", source="aanet_torch/csrc/correlation.cu",
             replaces="aanet_tpu/ops/cost_volume.py:72"),
        dict(name="soft_argmin_backward", forward="soft_argmin", module=softargmin,
             attr="soft_argmin_backward", plain=softargmin.soft_argmin_backward_plain,
             inputs=sa_bwd_inputs, cost=sa_bwd_cost, library=None, tol=rel(1e-5),
             tol_text="1e-5 * max|ref|", source="aanet_torch/csrc/softargmin.cu",
             replaces="aanet_tpu/ops/softargmin.py:16"),
        dict(name="disp_warp_backward", forward="disp_warp", module=warp,
             attr="disp_warp_backward", plain=warp.disp_warp_backward_plain,
             inputs=warp_bwd_inputs, cost=warp_bwd_cost, library=warp_bwd_library,
             tol=rel(1e-5), tol_text="1e-5 * max|ref|", source="aanet_torch/csrc/warp.cu",
             replaces="aanet_tpu/ops/warp.py:17"),
        dict(name="difference_volume_backward", forward="difference_volume", module=cost_volume,
             attr="difference_cost_volume_backward",
             plain=cost_volume.difference_cost_volume_backward_plain,
             inputs=lambda sig, gen, dev: vol_bwd_inputs(sig, gen, dev, False),
             cost=lambda sig: vol_bwd_cost(sig, False), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu", replaces="aanet_tpu/ops/cost_volume.py:127"),
        dict(name="concat_volume_backward", forward="concat_volume", module=cost_volume,
             attr="concat_cost_volume_backward",
             plain=cost_volume.concat_cost_volume_backward_plain,
             inputs=lambda sig, gen, dev: vol_bwd_inputs(sig, gen, dev, True),
             cost=lambda sig: vol_bwd_cost(sig, True), library=None,
             tol=lambda ref: 0.0, tol_text="0 (bit for bit)",
             source="aanet_torch/csrc/volume4d.cu", replaces="aanet_tpu/ops/cost_volume.py:144"),
    ]
    for b in bwd:
        b["sig"] = by_name[b["forward"]]["sig"]
    return fwd, bwd


def bf16_ulp(ref):
    """One bf16 ulp at the scale of ``ref``'s largest value (0 for zeros)."""
    top = float(ref.float().abs().max()) if ref.numel() else 0.0
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def bf16_kernel_specs(specs):
    """The bf16 forms of the four forward kernels that serve in bfloat16
    (phase 14), derived from their float32 specs: the same wrapper, twin
    and signature; launches counted in the wrapper's ``launches_bf16``;
    seeded inputs as the bf16 path hands them over (bf16 x, mask and weight
    rounded by the op from float32, bf16 features, volumes and images,
    float32 offsets, biases and disparities); bytes at 2 a bf16 value and 4
    a float32 one; the float32 kernel timed at the same shapes
    (``f32_args``). The correlation's FLOPs are products of two bf16
    values, bounded at the bf16 tensor-core peak (``bound_times``). The
    deformable conv's kernel splits the float32 sampled column (the
    bilinear blend times the mask, not rounded) exactly into three bf16
    planes and multiplies each by the bf16 weight on the tensor cores: its
    contraction is three bf16 x bf16 products at that peak, its sampling
    stays at the float32 peak; ``cost_before`` is the bound with the one
    contraction at the float32 peak, as it stood before the kernel moved to
    the tensor cores (kept in each row for comparison). Tolerance: one bf16
    ulp of the output's scale (both round the same float32 sums, in
    another order, once), soft-argmin's float32 disparity within 1e-4 px."""
    by_name = {s["name"]: s for s in specs}
    bf = torch.bfloat16
    one_ulp = bf16_ulp

    def deform_cost(sig):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, has_bias, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        # x, mask, weight and the output at 2 bytes; offsets and bias at 4
        nbytes = (2 * (b * cin * h * w + (pix * g * k2 if has_mask else 0) + cout * cin * k2
                       + pix * cout) + 4 * (pix * g * k2 * 2 + (cout if has_bias else 0)))
        flops = by_name["deform_conv"]["cost"](sig)[1]  # the contraction and the sampling
        contraction = 2 * pix * cout * cin * k2
        # three planes' bf16 x bf16 products at the tensor-core peak, the sampling at float32's
        return nbytes, flops + 2 * contraction, 3 * contraction

    def deform_cost_before(sig):  # the one float32 contraction at the float32 peak
        return deform_cost(sig)[0], by_name["deform_conv"]["cost"](sig)[1]

    def corr_cost(sig):
        (b, c, h, w), d = sig
        flops = by_name["correlation"]["cost"](sig)[1]  # every one a bf16 x bf16 product
        return 2 * (2 * b * c * h * w + b * d * h * w), flops, flops

    def sa_cost(sig):
        (b, d, h, w), _ = sig
        return 2 * b * d * h * w + 4 * b * h * w, by_name["soft_argmin"]["cost"](sig)[1]

    def warp_cost(sig):
        ((b, c, h, w),) = sig
        # image and warped image, the mask at 2 bytes; the disparity at 4
        return 2 * (2 * b * c * h * w + b * h * w) + 4 * b * h * w, by_name["disp_warp"]["cost"](sig)[1]

    def warp_library(img, disp):
        """F.grid_sample of the bf16 image with a bf16 grid (it takes one
        dtype): the warped image."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1).to(img.dtype)
        return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                                     align_corners=True)

    def to_f32(args):
        return tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)

    def inputs_of(name, convert):
        def make(sig, gen, dev):
            args, kwargs = by_name[name]["inputs"](sig, gen, dev)
            return convert(args), kwargs
        return make

    images = lambda args: (args[0].to(bf), args[1])  # noqa: E731
    out = []
    for name, inputs, cost, tol, tol_text, library in (
        ("deform_conv", inputs_of("deform_conv", lambda a: (a[0].to(bf), *a[1:])), deform_cost,
         one_ulp, "1 bf16 ulp of max|ref|", None),
        ("correlation", inputs_of("correlation", lambda a: (a[0].to(bf), a[1].to(bf), a[2])),
         corr_cost, one_ulp, "1 bf16 ulp of max|ref|", None),
        ("soft_argmin", inputs_of("soft_argmin", lambda a: (a[0].to(bf), a[1])), sa_cost,
         lambda ref: 1e-4, "1e-4 px", None),
        ("disp_warp", inputs_of("disp_warp", images), warp_cost, one_ulp,
         "1 bf16 ulp of max|ref| (the mask: exactly)", warp_library),
    ):
        spec = dict(by_name[name], name=f"{name}_bf16", counter="launches_bf16", inputs=inputs,
                    cost=cost, tol=tol, tol_text=tol_text, library=library, f32_args=to_f32)
        if name == "deform_conv":
            spec["cost_before"] = deform_cost_before
        out.append(spec)
    return out


def bf16_backward_specs(bwd_specs):
    """The bf16 forms of the five backward kernels (phase 15), derived from
    their float32 specs as ``bf16_kernel_specs`` derives the forwards': the
    same wrapper, twin and signature (the bf16 forward spec's name in
    ``forward``); launches in ``launches_bf16``; inputs as the bf16 path
    hands them over (bf16 output gradients, x, masks, weights, features,
    volumes and images; the float32 offsets, disparities and soft-argmin's
    disparity gradient); bytes at 2 a bf16 value and 4 a float32 one; the
    products of two bf16 operands (the data gradient's gout.W contraction,
    the correlation's) at the bf16 tensor-core peak (``bound_times``); the
    weight gradient's kernel splits the float32 sampled column exactly into
    three bf16 planes and multiplies each by the bf16 gout on the tensor
    cores, so its contraction is three bf16 x bf16 products at that peak and
    its sampling stays at the float32 peak (``cost_before``: the one
    contraction at the float32 peak, gout times the float32 column, as the
    bound stood before the kernel moved to the tensor cores; kept in each
    row as ``bound_before_ms``); the float32 kernel timed at the same
    shapes. Tolerance: one bf16 ulp of
    each bf16 gradient's scale (the kernel and the twin sum in float32 in
    other orders and round once); the float32 form's tolerance for the
    float32 gradients (the offsets' and the disparity's: the same float32
    arithmetic on bf16-valued inputs, nothing rounded)."""
    by_name = {s["name"]: s for s in bwd_specs}
    bf = torch.bfloat16

    # the backward kernels with a float32 gradient (the offsets', the
    # disparity's) beside their bf16 ones
    with_f32_gradient = {"deform_conv_backward_data", "disp_warp_backward"}

    def by_dtype(f32_tol, ref):
        """One bf16 ulp for a bf16 gradient; the float32 form's tolerance
        for a float32 one (the offsets' and the disparity's)."""
        return bf16_ulp(ref) if ref.dtype == bf else f32_tol(ref)

    def to_bf16(keep):
        """Tensors to bf16 but those at the indices ``keep``."""
        def convert(args):
            return tuple(a.to(bf) if isinstance(a, torch.Tensor) and i not in keep else a
                         for i, a in enumerate(args))
        return convert

    def inputs_of(name, convert):
        def make(sig, gen, dev, **kw):
            args, kwargs = by_name[name]["inputs"](sig, gen, dev, **kw)
            return convert(args), kwargs
        return make

    def deform_cost(sig, weight_grad, name):
        (b, cin, h, w), (cout, _, kh, kw), has_mask, _, stride, pad, dil, g = sig
        ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
        wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
        k2, pix = kh * kw, b * ho * wo
        masks, offsets = (pix * g * k2 if has_mask else 0), pix * g * k2 * 2
        # gout, x and the masks at 2 bytes, the offsets at 4; the data
        # gradient also reads the weight and writes dx, d offset and d mask,
        # the weight gradient writes dW
        reads = 2 * (pix * cout + b * cin * h * w + masks) + 4 * offsets
        flops = by_name[name]["cost"](sig)[1]
        if weight_grad:  # the column's three planes times gout on the tensor cores
            contraction = 2 * pix * cout * cin * k2
            return reads + 2 * cout * cin * k2, flops + 2 * contraction, 3 * contraction
        # the gout.W contraction multiplies two bf16 operands on the tensor
        # cores; the sampling and scatter are float32
        nbytes = reads + 2 * cout * cin * k2 + 2 * (b * cin * h * w + masks) + 4 * offsets
        return nbytes, flops, pix * cin * k2 * 2 * cout

    def corr_cost(sig):
        (b, c, h, w), d = sig
        flops = by_name["correlation_backward"]["cost"](sig)[1]  # bf16 dcost x bf16 features
        return 2 * (b * d * h * w + 4 * b * c * h * w), flops, flops

    def sa_cost(sig):
        (b, d, h, w), _ = sig
        return 4 * b * h * w + 2 * 2 * b * d * h * w, by_name["soft_argmin_backward"]["cost"](sig)[1]

    def warp_cost(sig):
        ((b, c, h, w),) = sig
        # the warped image's gradient and the image at 2 bytes; the
        # disparity and its gradient at 4
        return 2 * 2 * b * c * h * w + 4 * 2 * b * h * w, by_name["disp_warp_backward"]["cost"](sig)[1]

    def warp_library(grad, img, disp):
        """F.grid_sample of the bf16 image with a bf16 grid, forward plus its
        backward for the grid."""
        b, c, h, w = img.shape
        xs = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) - disp
        ys = torch.arange(h, device=img.device, dtype=torch.float32).view(1, h, 1).expand(b, h, w)
        grid = torch.stack((2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1), dim=-1).to(img.dtype)

        def run():
            with torch.enable_grad():
                g = grid.detach().requires_grad_(True)
                F.grid_sample(img, g, mode="bilinear", padding_mode="border",
                              align_corners=True).backward(grad)
        return run

    def to_f32(args):
        return tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)

    def wgrad_cost_before(sig):  # gout times the float32 column at the float32 peak
        return deform_cost(sig, True, "deform_conv_backward_weight")[0], by_name[
            "deform_conv_backward_weight"]["cost"](sig)[1]

    out = []
    for name, convert, cost, library in (
        ("deform_conv_backward_data", to_bf16({2}),
         lambda sig: deform_cost(sig, False, "deform_conv_backward_data"), None),
        ("deform_conv_backward_weight", to_bf16({2}),
         lambda sig: deform_cost(sig, True, "deform_conv_backward_weight"), None),
        ("correlation_backward", to_bf16(set()), corr_cost, None),
        ("soft_argmin_backward", to_bf16({0}), sa_cost, None),
        ("disp_warp_backward", to_bf16({2}), warp_cost, warp_library),
    ):
        spec = by_name[name]
        out.append(dict(spec, name=f"{name}_bf16", forward=f"{spec['forward']}_bf16",
                        counter="launches_bf16", inputs=inputs_of(name, convert), cost=cost,
                        tol=functools.partial(by_dtype, spec["tol"]),
                        tol_text="1 bf16 ulp of each bf16 gradient's max|ref|" + (
                            f"; the float32 gradient {spec['tol_text']}" if name in with_f32_gradient
                            else ""),
                        library=library, f32_args=to_f32))
        if name == "deform_conv_backward_weight":
            out[-1]["cost_before"] = wgrad_cost_before
    return out


@contextlib.contextmanager
def plain_ops(specs, calls=None, recomputed=None):
    """Swap each kernel op for its plain twin; count calls by signature,
    the forwards that backward recomputes (in a checkpointed block) apart
    in ``recomputed``."""
    from aanet_torch.models import layers

    def recording(spec):
        def op(*args, **kwargs):
            if calls is not None:
                first = layers._UPDATE_STATS or recomputed is None
                counter = calls if first else recomputed
                counter[spec["name"]][spec["sig"](*args, **kwargs)] += 1
            return spec["plain"](*args, **kwargs)
        return op

    with contextlib.ExitStack() as stack:
        for spec in specs:
            stack.enter_context(mock.patch.object(spec["module"], spec["attr"], recording(spec)))
        yield


def stage_breakdown(model, left, right, iters=10):
    """Median device time (CUDA events) and peak memory of each top-level
    stage of the forward, over ``iters`` forwards."""
    names = [n for n in ("feature_extractor", "fpn", "aggregation", "refinement_0", "refinement_1")
             if isinstance(getattr(model, n, None), torch.nn.Module)]
    spans = {n: [] for n in names}
    peaks = dict.fromkeys(names, 0)

    def pre(name):
        def hook(mod, inputs):
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            spans[name].append([start, None])
        return hook

    def post(name):
        def hook(mod, inputs, output):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            spans[name][-1][1] = end
            peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        return hook

    handles = []
    for n in names:
        mod = getattr(model, n)
        handles += [mod.register_forward_pre_hook(pre(n)), mod.register_forward_hook(post(n))]
    try:
        for _ in range(iters):
            model(left, right)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {n: dict(ms=statistics.median(s.elapsed_time(e) for s, e in spans[n]),
                    peak_memory_bytes=peaks[n]) for n in names}


def device_breakdown(run, iters=3, top=12):
    """``run`` under torch.profiler, ``iters`` times: per call, the window
    (CUDA events around the calls), the device busy time (the union of the
    kernels' intervals, so overlap is not counted twice), the idle share,
    and device time by kernel name for the ``top`` largest."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda and e.time_range.end > e.time_range.start)
    check(spans, "the profiler recorded no device activity")
    busy_us, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    busy_us += cur_end - cur_start
    window_ms = start.elapsed_time(end) / iters
    busy_ms = busy_us / 1e3 / iters
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3 / iters, e.count / iters)
         for e in prof.key_averages() if e.device_type == cuda),
        key=lambda r: -r[1],
    )
    return dict(window_ms=window_ms, busy_ms=busy_ms, idle_share=1.0 - busy_ms / window_ms,
                kernel_sum_ms=sum(r[1] for r in rows),
                top=[dict(kernel=name[:90], ms=ms, calls=calls) for name, ms, calls in rows[:top]])


def launches(specs):
    return {s["name"]: getattr(getattr(s["module"], s["attr"]), s.get("counter", "launches"))
            for s in specs}


def reset_launches(specs):
    for s in specs:
        setattr(getattr(s["module"], s["attr"]), s.get("counter", "launches"), 0)


# --------------------------------------------------------------------------
# The model: seeded weights, calibrated BatchNorm, a synthetic stereo pair
# --------------------------------------------------------------------------


def seed_weights_(model, seed, bn_scale=BN_SCALE):
    """Every parameter from RandomState(seed), with non-zero offset heads
    (fractional offsets, masks around 1) and non-zero ZeroNorm scales; the
    other BatchNorm scales uniform in ``bn_scale``.

    The offset heads and the residual branches' ZeroNorm scales are drawn
    small. With ZeroNorm scales near 1 the random network is chaotic: the
    kernels' rounding (about 1e-6 relative) grew past the 5e-2 px
    tolerance at the final level on an H100. With small scales the
    network stays well inside it, and still runs every residual branch
    and every offset head.
    """
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 4:  # 2-D and 3-D conv kernels
                std = (0.3 if "offset_conv" in name else 1.0) / np.sqrt(p[0].numel())
                val = rs.randn(*p.shape) * std
            elif name.endswith("ZeroNorm_0.BatchNorm_0.weight"):
                val = rs.uniform(0.1, 0.3, p.shape)
            elif name.endswith("BatchNorm_0.weight"):
                val = rs.uniform(*bn_scale, p.shape)
            else:
                val = rs.randn(*p.shape) * 0.1
            p.copy_(torch.from_numpy(val.astype(np.float32)))


def calibrate_bn_(model, specs, left, right):
    """Set each BatchNorm's running statistics to those of its input on
    this pair, so the random network's activations stay near unit scale."""
    def hook(mod, inputs):
        x = inputs[0]
        dims = (0,) + tuple(range(2, x.ndim))
        mod.running_mean.copy_(x.mean(dims))
        mod.running_var.copy_(x.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    try:
        with plain_ops(specs):
            model(left, right)
    finally:
        for h in handles:
            h.remove()


def stereo_pair(gen, dev, h, w, shift=20):
    """Normalised smoothed-noise images, the left one shifted by ``shift`` px."""
    from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    base = torch.rand((1, 3, h, w + shift), generator=gen, device=dev)
    base = F.avg_pool2d(base, 3, stride=1, padding=1, count_include_pad=False)
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    left = ((base[..., shift:] - mean) / std).contiguous()
    right = ((base[..., :w] - mean) / std).contiguous()
    return left, right


def write_pngs(root, n, hw, seed):
    from PIL import Image

    rs = np.random.RandomState(seed)
    h, w = hw
    for sub in ("left", "right"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        base = rs.randint(0, 256, (h, w + 16, 3), dtype=np.uint8)
        Image.fromarray(base[:, 12: w + 12]).save(os.path.join(root, "left", f"{i:06d}.png"))
        Image.fromarray(base[:, :w]).save(os.path.join(root, "right", f"{i:06d}.png"))


def measure(spec, sig, n, gen, dev, timer, iters=20, timed=True):
    """Hold ``spec``'s kernel against its plain version on seeded inputs of
    signature ``sig`` (``n`` launches per run of the path), output by
    output; unless not ``timed``, time kernel, plain version and the
    library yardstick."""
    args, kwargs = spec["inputs"](sig, gen, dev)
    op = getattr(spec["module"], spec["attr"])
    got, want = op(*args, **kwargs), spec["plain"](*args, **kwargs)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [(float((g.float() - w.float()).abs().max()), spec["tol"](w)) for g, w in zip(got, want)
            if w is not None]
    for err, tol in errs:
        check(err <= tol, f"{spec['name']} {sig}: max error {err} > {tol}")
    err, tol = max(errs, key=lambda e: e[0] / e[1] if e[1] > 0 else e[0])
    if not timed:
        print(f"{spec['name']} {sig}: err {err:.3g} (tol {tol:.3g})", flush=True)
        return dict(shape=str(sig), max_err=err, tolerance=tol)
    bytes_ms, ops_ms = bound_times(spec["cost"](sig))
    lib = spec["library"](*args) if spec["library"] else None
    row = dict(
        shape=str(sig), launches=n, max_err=err, tolerance=tol,
        kernel_ms=timer.ms(lambda: op(*args, **kwargs), iters=iters),
        # the twin only as a yardstick: a few repetitions
        plain_ms=timer.ms(lambda: spec["plain"](*args, **kwargs), warmup=1, iters=PLAIN_ITERS),
        library_ms=timer.ms(lib, iters=iters) if lib else None,
        bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    if "cost_before" in spec:  # the bound as it stood before the kernel's redesign
        row["bound_before_ms"] = max(bound_times(spec["cost_before"](sig)))
    if "f32_args" in spec:  # a bf16 form: its float32 kernel at the same shape
        f32 = spec["f32_args"](args)
        row["f32_kernel_ms"] = timer.ms(lambda: op(*f32, **kwargs), iters=iters)
    print(f"{spec['name']} {sig} x{n}: err {err:.3g} (tol {tol:.3g}) kernel {row['kernel_ms']:.4f} ms "
          f"plain {row['plain_ms']:.4f} ms bound {row['bound_ms']:.4f} ms"
          + (f" library {row['library_ms']:.4f} ms" if lib else "")
          + (f" float32 kernel {row['f32_kernel_ms']:.4f} ms" if "f32_args" in spec else ""),
          flush=True)
    return row


def totals(rows, has_library):
    """A kernel's totals over one run of its path: each shape's time times
    that shape's launches, summed."""
    total = lambda key: sum(r[key] * r["launches"] for r in rows)  # noqa: E731
    out = dict(
        ms=total("kernel_ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by="bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
        library_ms=total("library_ms") if has_library else None,
        max_abs_err=max(r["max_err"] for r in rows),
    )
    for key in ("f32_kernel_ms", "bound_before_ms"):
        if all(key in r for r in rows):
            out[key] = total(key)
    return out


def train_batch(gen, dev, n, hw, max_shift=40):
    """``n`` normalised smoothed-noise pairs with a known constant disparity
    each (left[x] = right[x - d], d in [3, max_shift)) and its ground truth."""
    from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    h, w = hw
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    shifts = torch.randint(3, max_shift, (n,), generator=gen, device=dev)
    base = torch.rand((n, 3, h, w + max_shift), generator=gen, device=dev)
    base = F.avg_pool2d(base, 3, stride=1, padding=1, count_include_pad=False)
    left = base[..., :w]
    right = torch.stack([base[i, :, :, int(d): int(d) + w] for i, d in enumerate(shifts)])
    disp = shifts.view(n, 1, 1).float().expand(n, h, w).contiguous()
    return dict(left=((left - mean) / std).contiguous(), right=((right - mean) / std).contiguous(),
                disp=disp)


def write_sceneflow(root, n, hw, seed, n_val=4):
    """A SceneFlow-layout dataset: ``n`` PNG pairs with a constant disparity
    each and its PFM, and the train (all pairs) and val (the first
    ``n_val``) filename lists. Returns (data_dir, filename_root)."""
    from PIL import Image

    from aanet_torch.data.file_io import write_pfm

    rs = np.random.RandomState(seed)
    h, w = hw
    data, lists = os.path.join(root, "data"), os.path.join(root, "lists")
    for sub in ("left", "right", "disp"):
        os.makedirs(os.path.join(data, sub))
    os.makedirs(os.path.join(lists, "filenames"))
    lines = []
    for i in range(n):
        d = int(rs.randint(3, 40))
        base = rs.randint(0, 256, (h, w + d, 3), dtype=np.uint8)
        Image.fromarray(base[:, :w]).save(os.path.join(data, "left", f"{i}.png"))
        Image.fromarray(base[:, d: d + w]).save(os.path.join(data, "right", f"{i}.png"))
        write_pfm(os.path.join(data, "disp", f"{i}.pfm"), np.full((h, w), float(d), np.float32))
        lines.append(f"left/{i}.png right/{i}.png disp/{i}.pfm")
    for split, chosen in (("train", lines), ("val", lines[:n_val])):
        with open(os.path.join(lists, "filenames", f"SceneFlow_finalpass_{split}.txt"), "w") as f:
            f.write("\n".join(chosen) + "\n")
    return data, lists


def write_synthetic(root, pairs=16, hw=(96, 192), min_disp=3, max_disp_gt=10, seed=0):
    """The constant-shift set of ``tools/synthetic_dataset.py`` (the same
    draws, files and lists, written by the port's own PFM writer): pair i
    has one disparity d_i in [min_disp, max_disp_gt], left[x] = right[x -
    d_i] of horizontally smoothed noise, the PFM ground truth, and the same
    list for train, val and test. With the defaults it is the set the
    trained anchor was trained on (docs/CONVERGENCE_r04.md). Returns
    (data_dir, filename_root)."""
    from PIL import Image

    from aanet_torch.data.file_io import write_pfm

    h, w = hw
    data, lists = os.path.join(root, "data"), os.path.join(root, "lists")
    os.makedirs(os.path.join(lists, "filenames"), exist_ok=True)
    for side in ("left", "right", "disp"):
        os.makedirs(os.path.join(data, side), exist_ok=True)
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(pairs):
        d = int(rs.randint(min_disp, max_disp_gt + 1))
        base = rs.rand(h, w + max_disp_gt + 1, 3)
        base = (base + np.roll(base, 1, 1) + np.roll(base, 2, 1)) / 3
        Image.fromarray((base[:, d: w + d] * 255).astype(np.uint8)).save(
            os.path.join(data, "left", f"{i}.png"))
        Image.fromarray((base[:, :w] * 255).astype(np.uint8)).save(
            os.path.join(data, "right", f"{i}.png"))
        write_pfm(os.path.join(data, "disp", f"{i}.pfm"), np.full((h, w), float(d), np.float32))
        lines.append(f"left/{i}.png right/{i}.png disp/{i}.pfm")
    for split in ("train", "val", "test"):
        with open(os.path.join(lists, "filenames", f"SceneFlow_finalpass_{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return data, lists


def seeded_model(cfg, dev, bn_scale=BN_SCALE):
    model = cfg.build()
    seed_weights_(model, SEED, bn_scale)
    return model.to(dev)

def forward_record(name, model, left, right, plain_ms, errs, timer, smi, dtype="float32"):
    """Latency (median of 20 after 3 warm-ups, L2 flushed), peak memory,
    stage times, the dense convs' and matmuls' FLOPs (torch's flop
    counter; the hand-written kernels are not counted) and the device's
    busy time, idle share and top kernels of ``model``'s forward on
    (left, right)."""
    from torch.utils.flop_counter import FlopCounterMode

    fwd_ms = timer.ms(lambda: model(left, right))
    with FlopCounterMode(display=False) as counter:
        model(left, right)
    dense_flops = counter.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # weights, inputs, the timer's scratch
    final = model(left, right)[-1]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stages = stage_breakdown(model, left, right)
    device = device_breakdown(lambda: model(left, right))
    return dict(
        config=name, batch=1, height=left.shape[2], width=left.shape[3], dtype=dtype,
        latency_ms=fwd_ms, plain_latency_ms=plain_ms, dense_flops=dense_flops,
        dense_tflop_s=dense_flops / fwd_ms / 1e9, peak_memory_bytes=peak,
        resident_before_bytes=resident, forward_memory_bytes=peak - resident,
        max_err_px=errs[-1][0], mean_err_px=errs[-1][1], pyramid_err_px=errs,
        final_disp_mean=float(final.mean()), final_disp_std=float(final.std()), stages=stages,
        # cost volumes, soft-argmin, image downscaling and concatenations
        other_stage_ms=fwd_ms - sum(st["ms"] for st in stages.values()),
        device_ms=device["busy_ms"], profiled_window_ms=device["window_ms"],
        device_idle_share=device["idle_share"], top_kernels=device["top"], card=smi,
    )


def compare_pyramids(pyramid, plain_pyramid, shapes, what):
    """Shapes, finiteness, and kernel vs plain within 5e-2 px max and 5e-3
    px mean per level; returns the (max, mean) errors per level."""
    check([tuple(p.shape) for p in pyramid] == shapes,
          f"{what}: pyramid shapes {[tuple(p.shape) for p in pyramid]}, expected {shapes}")
    errs = []
    for got, want in zip(pyramid, plain_pyramid):
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite disparity")
        diff = (got - want).abs()
        errs.append((float(diff.max()), float(diff.mean())))
    check(all(mx <= 5e-2 and mn <= 5e-3 for mx, mn in errs),
          f"{what}: kernel path vs plain path (max, mean) px per level: {errs}")
    return errs


def pyramid_spread(model, specs, left, right, plain_pyramid, pyramid):
    """What moves the pyramid besides the kernels, per level (max, mean)
    px: the plain path's own change under a 1e-6 relative change of the
    left image, and the kernel path's change when it runs again (cuDNN's
    algorithms may add in another order; the port's kernels do not)."""
    def diff(a, b):
        return [(float((x - y).abs().max()), float((x - y).abs().mean())) for x, y in zip(a, b)]

    gen = torch.Generator(device=left.device).manual_seed(SEED + 1)  # the run's draws stay
    noise = torch.randn(left.shape, generator=gen, device=left.device)
    with plain_ops(specs):
        nudged = model(left * (1 + 1e-6 * noise), right)
    again = model(left, right)
    return dict(plain_nudge_err_px=diff(nudged, plain_pyramid),
                kernel_rerun_err_px=diff(again, pyramid))


def baseline_config(name):
    from aanet_torch.config import ModelConfig, preset

    spec = BASELINES[name]
    return preset(spec["preset"]) if "preset" in spec else ModelConfig(**spec["flags"])


def baseline_phases(specs, gen, dev, timer, smi, left, right):
    """Phase 5b: the 3-D-aggregation baselines and stereonet-aa at
    384x1248. Returns, per configuration, each kernel's rows at its
    shapes and the launches of one forward through the kernels."""
    from aanet_torch import cli

    out = {}
    for name, spec in BASELINES.items():
        cfg = baseline_config(name)
        expected = {s["name"]: spec["launches"].get(s["name"], 0) for s in specs}
        model = seeded_model(cfg, dev).eval()
        calibrate_bn_(model, specs, left, right)
        calls = {s["name"]: collections.Counter() for s in specs}
        with plain_ops(specs, calls):
            plain_pyramid = model(left, right)
        with plain_ops(specs):
            plain_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
        made = {n: sum(c.values()) for n, c in calls.items()}
        check(made == expected, f"{name}: plain forward made {made}, expected {expected}")
        rows = {s["name"]: [measure(s, sig, n, gen, dev, timer) for sig, n in calls[s["name"]].items()]
                for s in specs}
        reset_launches(specs)
        pyramid = model(left, right)
        torch.cuda.synchronize()
        counts = launches(specs)
        print(f"{name} launches: {counts}", flush=True)
        check(counts == expected, f"{name}: launches {counts}, expected {expected}")
        errs = compare_pyramids(pyramid, plain_pyramid, spec["shapes"], name)
        record = forward_record(name, model, left, right, plain_ms, errs, timer, smi)
        print(json.dumps({"baseline_forward": record}), flush=True)
        out[name] = dict(rows=rows, launches=counts, record=record)
        if name == "psmnet":  # the predict entry point with the baseline's flags
            with tempfile.TemporaryDirectory() as tmp:
                weights = os.path.join(tmp, "weights.pt")
                torch.save(model.state_dict(), weights)
                data, pred_dir = os.path.join(tmp, "pairs"), os.path.join(tmp, "pred")
                write_pngs(data, 2, PREDICT_HW, SEED)
                flags = [f"--{k}={v}" for k, v in spec["flags"].items()]
                reset_launches(specs)
                cli.main(["predict", *flags, "--data_dir", data, "--output_dir", pred_dir,
                          "--pretrained", weights, "--device", DEVICE, "--save_type", "npy"])
                counts = launches(specs)
                check(counts == {k: 2 * v for k, v in expected.items()}, f"psmnet predict launches {counts}")
                for i in range(2):
                    pred = np.load(os.path.join(pred_dir, f"{i:06d}.npy"))
                    check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                          f"psmnet prediction {i}: shape {pred.shape}")
            print(f"psmnet predict: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]}, launches {counts}",
                  flush=True)
        del model, plain_pyramid, pyramid
        torch.cuda.empty_cache()
    return out


def relative_nudge(left, gen):
    """``left`` times (1 + 1e-6 noise): the float32 steps' input change."""
    return left * (1 + 1e-6 * torch.randn(left.shape, generator=gen, device=left.device))


def one_ulp_nudge(left, gen):
    """``left`` rounded to bf16, then every value moved by one bf16 ulp of
    its binade, up or down (a seeded sign each; zeros stay), as float32: a
    1e-6 change would round away at the model's cast. The result is
    representable in bf16."""
    base = left.to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(base.abs())) - 7)  # 0 where base is 0
    sign = torch.randint(0, 2, base.shape, generator=gen, device=base.device).float() * 2 - 1
    return base + sign * ulp


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms for the duration
    (``CUBLAS_WORKSPACE_CONFIG`` set before the first cuBLAS call: ``main``
    sets it): with them the port's train steps repeat to the bit wherever
    its own kernels do."""
    saved = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])


def compare_train_steps(cfg, specs, small, gen, dev, rerun=False, **kw):
    """``_compare_train_steps``; with ``rerun`` every step of it (the kernel
    step and its re-run, the plain step, its nudges and the float64 step)
    runs under ``deterministic``, so that both sides take the same cuDNN
    and PyTorch algorithms."""
    with deterministic() if rerun else contextlib.nullcontext():
        return _compare_train_steps(cfg, specs, small, gen, dev, rerun=rerun, **kw)


def _compare_train_steps(cfg, specs, small, gen, dev, per_parameter=False, calls=None,
                         recomputed=None, rerun=False, highest_loss_only=False,
                         nudge=relative_nudge, guard=None):
    """One train step through the kernels against the same step through
    the plain twins ``specs`` (same seeded weights, the batch ``small``),
    and the plain step's own spread: the largest change of its loss,
    gradients and BatchNorm statistics over ``NUDGES`` changes of the left
    image by ``nudge`` (some gradients are sums that nearly cancel, and
    move by far more than the input under it; one change is too few to
    tell how far); with ``rerun``, also the change of the kernel step's
    gradients when it runs again on the same inputs, which must be exactly
    0 (the port's kernels add in a fixed order, cuDNN's and PyTorch's
    deterministic algorithms do the rest), and the float64 record: the
    same step's plain path in float64, each parameter's gradient distance
    to it from the kernel step and from the plain float32 step (it says
    whose error a parameter's miss is; it is recorded, not checked).
    Every parameter but those of ``ZERO_GRADIENT`` must get a non-zero
    gradient. Without ``guard`` (a float32 step): the loss within rtol
    1e-5, all gradients together (and, with ``per_parameter``, each
    parameter's) within max(1e-3, 2x the spread), the BatchNorm statistics
    within 1e-4. With ``guard``, a (config, plain specs) pair of the
    float32 step for a bf16 ``cfg``: the loss, all gradients together and
    the statistics each within 2x the spread and no farther from the plain
    step than the plain step is from the guard's (its float32 step on the
    same weights). Every check is made after the record is printed. The
    plain step records its kernel calls into ``calls`` and ``recomputed``
    (``plain_ops``). With ``highest_loss_only`` the loss takes the final
    map only. Returns the record, the kernel step's model and its step."""
    from aanet_torch.models.layers import set_train_mode
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_loss_fn, make_train_step

    last = dict(highest_loss_only=highest_loss_only)

    def train_step(model):
        return make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp, **last)

    m_kernel = seeded_model(cfg, dev)
    m_plain = copy.deepcopy(m_kernel)
    step_kernel = train_step(m_kernel)
    met_kernel = step_kernel(small)
    with plain_ops(specs, calls, recomputed):
        met_plain = train_step(m_plain)(small)
    loss_k, loss_p = float(met_kernel["total_loss"]), float(met_plain["total_loss"])
    plain_params = dict(m_plain.named_parameters())
    plain_bufs = {n: b for n, b in m_plain.named_buffers() if b.is_floating_point()}

    def stats_from_plain(model):
        """The BatchNorm statistics' largest |a - plain| / (|plain| + 1)."""
        return max(float(((b - plain_bufs[n]).abs() / (plain_bufs[n].abs() + 1)).max())
                   for n, b in model.named_buffers() if b.is_floating_point())

    def moved_from(model, reference):
        """Per parameter, the squared change of its gradient from ``reference``'s."""
        return {name: float((p.grad - reference[name].grad).square().sum())
                for name, p in model.named_parameters()}

    # per parameter, the squared change of its gradient under each nudge
    # (and re-run); the loss's and statistics' changes under each nudge
    moved, moved_loss, moved_stats = {name: [] for name in plain_params}, [], []
    with plain_ops(specs):
        for _ in range(NUDGES):
            m_floor = seeded_model(cfg, dev)
            set_train_mode(m_floor)
            loss = make_loss_fn(m_floor, cfg.max_disp, **last)(dict(small, left=nudge(small["left"], gen)))[0]
            loss.backward()
            for name, sq in moved_from(m_floor, plain_params).items():
                moved[name].append(sq)
            moved_loss.append(abs(loss.item() - loss_p))
            moved_stats.append(stats_from_plain(m_floor))
            del m_floor
    kernel_params = dict(m_kernel.named_parameters())
    if rerun:
        m_again = seeded_model(cfg, dev)
        train_step(m_again)(small)
        for name, sq in moved_from(m_again, kernel_params).items():
            moved[name].append(sq)
        del m_again
        # the plain path in float64: whose error is a parameter's distance
        m64 = seeded_model(cfg, dev).double()
        with plain_ops(specs):
            train_step(m64)({k: v.double() if v.is_floating_point() else v for k, v in small.items()})
        ref64 = dict(m64.named_parameters())
        del m64
    failures = []
    worst, floored, dk2, dp2 = [], [], 0.0, 0.0
    df2 = [0.0] * (NUDGES + rerun)
    for name, p in m_kernel.named_parameters():
        gk, gp = p.grad, plain_params[name].grad
        check(gk is not None, f"{name}: no gradient on the kernel path")
        dk2 += float((gk - gp).square().sum())
        df2 = [a + b for a, b in zip(df2, moved[name])]
        dp2 += float(gp.square().sum())
        if name in ZERO_GRADIENT:
            continue
        if float(gk.abs().sum()) == 0:
            failures.append(f"{name}: a zero gradient on the kernel path")
        scale = float(gp.norm())
        rel_err, spread = float((gk - gp).norm()) / scale, max(moved[name]) ** 0.5 / scale
        if per_parameter and rel_err > max(1e-3, 2 * spread):
            failures.append(f"{name}: gradient relative error {rel_err} (plain spread {spread})")
        if guard is None and rel_err > 1e-3:  # within the spread only
            floored.append((name, rel_err, spread))
        worst.append((rel_err / max(1e-3, 2 * spread), rel_err, spread, name))
    worst = sorted(worst)[-8:]
    grad_rel, grad_spread = (dk2 / dp2) ** 0.5, (max(df2) / dp2) ** 0.5
    stats_err = stats_from_plain(m_kernel)
    print(f"gradients: kernel vs plain {grad_rel:.3g}, plain spread {grad_spread:.3g} (largest of "
          f"{len(df2)}: {[round((x / dp2) ** 0.5, 6) for x in df2]}); worst (error / allowed, error, "
          f"spread, parameter): {worst}", flush=True)
    record = dict(batch=small["left"].shape[0], loss_kernel=loss_k, loss_plain=loss_p,
                  grad_rel_err=grad_rel, grad_plain_spread=grad_spread,
                  grad_plain_spread_per_nudge=[(x / dp2) ** 0.5 for x in df2],
                  per_parameter_margin=worst[-1][0], worst_params=worst,
                  params_within_plain_spread_only=floored, bn_stats_rel_err=stats_err,
                  loss_plain_spread=max(moved_loss), bn_stats_plain_spread=max(moved_stats))
    if rerun:
        # the kernel step's own change when it runs again: exactly 0
        record["rerun_sq_change"] = df2[-1]
        print(f"kernel step re-run: squared gradient change {df2[-1]!r} (must be 0)", flush=True)
        if df2[-1] != 0:
            failures.append(f"the kernel step's gradients changed when it ran again: {df2[-1]}")

        def off64(g, name):
            ref = ref64[name].grad
            return float((g.double() - ref).norm() / ref.norm()) if float(ref.norm()) else None

        per = {name: (off64(p.grad, name), off64(plain_params[name].grad, name))
               for name, p in m_kernel.named_parameters()}

        def total(params):
            """All gradients' distance to the float64 step's, relative."""
            off = sum(float((params[n].grad.double() - r.grad).square().sum()) for n, r in ref64.items())
            return (off / sum(float(r.grad.square().sum()) for r in ref64.values())) ** 0.5

        record["float64"] = dict(
            all_gradients=dict(kernel=total(kernel_params), plain32=total(plain_params)),
            worst_params={name: dict(kernel=per[name][0], plain32=per[name][1])
                          for *_, name in worst},
            kernel_farther=sorted(((n, k, p) for n, (k, p) in per.items()
                                   if k is not None and p is not None and k > p),
                                  key=lambda e: e[2] - e[1])[:8],
            kernel_farther_count=sum(1 for k, p in per.values()
                                     if k is not None and p is not None and k > p))
        print(f"float64 record: all gradients kernel {record['float64']['all_gradients']['kernel']:.4g}, "
              f"plain float32 {record['float64']['all_gradients']['plain32']:.4g}; the worst margins' "
              f"parameters {record['float64']['worst_params']}", flush=True)
    distances = (abs(loss_k - loss_p), grad_rel, stats_err)
    if guard is None:
        limits = (1e-5 * abs(loss_p), max(1e-3, 2 * grad_spread), 1e-4)
    else:
        cfg_guard, specs_guard = guard
        m_guard = seeded_model(cfg_guard, dev)
        with plain_ops(specs_guard):
            met_guard = make_train_step(m_guard, make_optimizer(m_guard, 1e-3), cfg.max_disp,
                                        **last)(small)
        guard_grad = sum(moved_from(m_guard, plain_params).values())
        record.update(loss_guard=float(met_guard["total_loss"]),
                      grad_plain_vs_guard=(guard_grad / dp2) ** 0.5,
                      bn_stats_plain_vs_guard=stats_from_plain(m_guard))
        own = (abs(record["loss_guard"] - loss_p), record["grad_plain_vs_guard"],
               record["bn_stats_plain_vs_guard"])
        spreads = (record["loss_plain_spread"], grad_spread, record["bn_stats_plain_spread"])
        limits = tuple(min(2 * s, g) for s, g in zip(spreads, own))
        del m_guard
    for what, dist, limit in zip(("loss", "all gradients", "BatchNorm statistics"), distances, limits):
        if dist > limit:
            failures.append(f"{what}: kernel vs plain {dist} > {limit}")
    record.update(limits=limits, failures=failures)
    return record, m_kernel, step_kernel


def seeded_compares(cfg, specs, dev, seeds, calls=None, recomputed=None, rerun=False,
                    highest_loss_only=False, per_parameter=True, label="train_step_compare",
                    **kw):
    """Phase 7's protocol: one train step through the kernels against the
    same step through the plain twins (same weights, batch 2) on each of
    ``seeds``' batches, each with its nudges from a generator of its own
    (``compare_train_steps``, which takes ``kw``: each parameter against
    the spread with ``per_parameter``; with ``rerun`` the spread also takes
    the kernel step's own re-run), and three kernel steps on the batch must
    lower the loss. The first plain step records its kernel calls into
    ``calls`` and ``recomputed``. Every record is printed under ``label``,
    and returned, before any is checked: the failures are in each record's
    ``failures``."""
    compares = []
    for i, seed in enumerate(seeds):
        seed_gen = torch.Generator(device=dev).manual_seed(seed)
        small = train_batch(seed_gen, dev, COMPARE_BATCH, TRAIN_HW)
        recording = dict(calls=calls, recomputed=recomputed) if i == 0 else {}
        compare, m_kernel, step_kernel = compare_train_steps(
            cfg, specs, small, seed_gen, dev, per_parameter=per_parameter, rerun=rerun,
            highest_loss_only=highest_loss_only, **recording, **kw)
        losses = [compare["loss_kernel"]] + [float(step_kernel(small)["total_loss"]) for _ in range(2)]
        if losses[-1] >= losses[0]:
            compare["failures"].append(f"three steps did not lower the loss: {losses}")
        compare.update(seed=seed, losses_three_steps=losses)
        print(json.dumps({label: compare}), flush=True)
        compares.append(compare)
        del m_kernel, step_kernel
        torch.cuda.empty_cache()
    return compares


def edge_cases(specs, bwd_specs, deform_sigs, corr_sigs, sa_sigs, warp_sigs, rows, gen, dev, timer):
    """Phase 6b: the redesigned kernels against their twins where the main
    path's inputs do not reach, with the path's tolerances. The deformable
    conv's forward, its input/offset/mask gradient and its weight gradient
    at every shape of the step ``deform_sigs`` with offsets in (-16, 16) px
    (corners beyond the kernels' window halo take their device-memory path)
    and with integer offsets (jnp.clip's half gradient), the mask-less
    single-group case, and a stride-2 shape of odd sizes; the forward also
    at a shape whose plan splits the input channels over blocks
    (inference's layer 3, whose splits sum slabs in a fixed order); each
    timed with the wide offsets at the step's largest shape, beside that
    shape's time with the path's narrow offsets (``rows``). The weight
    gradient sums its splits in a fixed order: two launches on the same
    inputs must give the same bits at every step shape. The warp forward
    at widths that are not a multiple of 4, timed beside F.grid_sample; the
    warp backward at the step's shapes ``warp_sigs`` and beyond them
    (``warp_backward_edge_cases``). The correlation kernels
    (``correlation_edge_cases``) and the soft-argmin kernels
    (``softargmin_edge_cases``)."""
    from aanet_torch.ops import deform

    by_name = {s["name"]: s for s in specs + bwd_specs}

    def with_offsets(spec, offsets):
        return dict(spec, inputs=functools.partial(spec["inputs"], offsets=offsets))

    records = []
    largest = max(deform_sigs, key=lambda sig: np.prod(sig[0]))
    odd = ((2, 24, 37, 53), (24, 24, 3, 3), True, False, 2, 2, 2, 2)
    cases = ((odd, "stride 2, odd sizes"),
             (odd[:2] + (False, False) + odd[4:7] + (1,), "stride 2, odd sizes, mask-less, G=1"),
             (largest[:2] + (False, False) + largest[4:7] + (1,), "mask-less, G=1"))
    for name in ("deform_conv", "deform_conv_backward_data", "deform_conv_backward_weight"):
        spec = by_name[name]
        narrow = next(r for r in rows[name] if r["shape"] == str(largest))
        wide = measure(with_offsets(spec, "wide"), largest, 1, gen, dev, timer, iters=10)
        print(f"{name} {largest}: offsets in (-3, 3) px {narrow['kernel_ms']:.4f} ms, "
              f"in (-16, 16) px {wide['kernel_ms']:.4f} ms", flush=True)
        records.append(dict(wide, kernel=name, case="wide offsets, timed",
                            narrow_kernel_ms=narrow["kernel_ms"]))
        for sig in deform_sigs:
            for offsets in ("wide", "integer"):
                if (sig, offsets) != (largest, "wide"):
                    records.append(dict(measure(with_offsets(spec, offsets), sig, 1, gen, dev, timer,
                                                timed=False), kernel=name, case=f"{offsets} offsets"))
        for sig, case in cases:
            for offsets in ("narrow", "wide"):
                records.append(dict(measure(with_offsets(spec, offsets), sig, 1, gen, dev, timer,
                                            timed=False), kernel=name, case=f"{case}, {offsets} offsets"))
    # the weight gradient: the same bits from two launches
    spec = by_name["deform_conv_backward_weight"]
    op = getattr(spec["module"], spec["attr"])
    for sig in deform_sigs:
        args, kwargs = spec["inputs"](sig, gen, dev)
        first, second = op(*args, **kwargs), op(*args, **kwargs)
        torch.cuda.synchronize()
        same = torch.equal(first, second)
        print(f"deform_conv_backward_weight {sig}: two launches bitwise identical: {same}", flush=True)
        check(same, f"deform_conv_backward_weight {sig}: two launches on the same inputs differ")
        records.append(dict(kernel="deform_conv_backward_weight", case="two launches, bitwise",
                            shape=str(sig), identical=same))
    # the forward where its plan splits the chunks over blocks
    split = ((2, 128, 32, 104), (128, 128, 3, 3), True, True, 1, 2, 2, 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = deform.forward_plan(2, 128, 128, 32, 104, 3, 3, 1, 2, 2, sms)
    check(plan.splits > 1, f"deform_conv {split}: the plan {plan} splits nothing")
    for offsets in ("narrow", "wide"):
        records.append(dict(measure(with_offsets(by_name["deform_conv"], offsets), split, 1, gen, dev,
                                    timer, timed=False),
                            kernel="deform_conv", case=f"split over {plan.splits} blocks, {offsets} offsets"))
    for shape in ((2, 3, 37, 61), (1, 3, 375, 1242)):
        records.append(dict(measure(by_name["disp_warp"], (shape,), 1, gen, dev, timer),
                            kernel="disp_warp", case="width not a multiple of 4"))
    return (records + odd_cout_cases(by_name, with_offsets, gen, dev, timer)
            + warp_backward_edge_cases(by_name["disp_warp_backward"], warp_sigs, gen, dev, timer)
            + correlation_edge_cases(by_name, corr_sigs, gen, dev, timer)
            + softargmin_edge_cases(by_name, sa_sigs, gen, dev, timer))


def warp_backward_edge_cases(spec, step_sigs, gen, dev, timer):
    """The warp backward (``spec``: its float32 or bf16 form): at every shape
    of the step ``step_sigs`` two launches give the same bits, timed beside
    the bound; against its twin at ``WARP_EDGE_SHAPES`` (widths off the
    quads, a last partial quad, the narrowest image)."""
    records = [dict(same_bits_timed(spec, sig, gen, dev, timer),
                    case="step shape: two launches, bitwise; timed")
               for sig in sorted(set(step_sigs), key=str)]
    for shape in WARP_EDGE_SHAPES:
        records.append(dict(measure(spec, (shape,), 1, gen, dev, timer, timed=False),
                            kernel=spec["name"], case="beyond the path"))
    return records


def odd_cout_cases(by_name, with_offsets, gen, dev, timer):
    """Phase 6b for the deformable conv's zero-padded channel tiles: the
    three kernels against their twins at ``ODD_COUTS`` output channels (cin
    = cout, 2 deformable groups where cin is even, else 1; mask and bias)
    at 96x192 and 24x48 (288x576 / 3 and / 12), batch 2, with narrow, wide
    and integer offsets and the path's tolerances; two weight-gradient
    launches give the same bits; each kernel timed beside its twin at
    batch 16, 96x192."""
    from aanet_torch.ops import deform

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = ("deform_conv", "deform_conv_backward_data", "deform_conv_backward_weight")
    records = []
    for cout in ODD_COUTS:
        g = 2 if cout % 2 == 0 else 1

        def sig(batch, h, w):
            return ((batch, cout, h, w), (cout, cout, 3, 3), True, True, 1, 2, 2, g)

        fwd = deform.forward_plan(16, cout, cout, 96, 192, 3, 3, 1, 2, g, sms)
        wgt = deform.backward_weight_plan(16, cout, cout, 96, 192, 3, 3, 1, 2, g, sms)
        print(f"deform_conv cout {cout}: forward tile {fwd.co_tile}, weight gradient tile "
              f"{wgt.co_tile}", flush=True)
        for h, w in ((96, 192), (24, 48)):
            for name in names:
                for offsets in ("narrow", "wide", "integer"):
                    records.append(dict(measure(with_offsets(by_name[name], offsets), sig(2, h, w),
                                                1, gen, dev, timer, timed=False),
                                        kernel=name, case=f"cout {cout}, {offsets} offsets"))
            spec = by_name["deform_conv_backward_weight"]
            args, kwargs = spec["inputs"](sig(2, h, w), gen, dev)
            op = getattr(spec["module"], spec["attr"])
            first, second = op(*args, **kwargs), op(*args, **kwargs)
            torch.cuda.synchronize()
            check(torch.equal(first, second),
                  f"deform_conv_backward_weight {sig(2, h, w)}: two launches on the same inputs differ")
            records.append(dict(kernel="deform_conv_backward_weight", identical=True,
                                case=f"cout {cout}: two launches, bitwise", shape=str(sig(2, h, w))))
        for name in names:
            records.append(dict(measure(by_name[name], sig(16, 96, 192), 1, gen, dev, timer, iters=10),
                                kernel=name, case=f"cout {cout}, timed"))
    return records


def same_bits_timed(spec, sig, gen, dev, timer):
    """Two launches of ``spec``'s kernel on the same seeded inputs of
    signature ``sig`` must give the same bits; the kernel is timed beside
    its bound."""
    same = same_bits(spec, sig, gen, dev)
    check(same, f"{spec['name']} {sig}: two launches on the same inputs differ")
    args, kwargs = spec["inputs"](sig, gen, dev)
    op = getattr(spec["module"], spec["attr"])
    bound = max(bound_times(spec["cost"](sig)))
    ms = timer.ms(lambda: op(*args, **kwargs), iters=10)
    print(f"{spec['name']} {sig}: two launches bitwise identical: {same}; {ms:.4f} ms, "
          f"bound {bound:.4f} ms", flush=True)
    return dict(kernel=spec["name"], case="path shape: two launches, bitwise; timed",
                shape=str(sig), identical=same, kernel_ms=ms, bound_ms=bound)


def same_bits(spec, sig, gen, dev, **inputs):
    """Whether two launches of ``spec``'s kernel on the same seeded inputs of
    signature ``sig`` (``inputs``: the spec's input options, e.g. offsets)
    give the same bits."""
    args, kwargs = spec["inputs"](sig, gen, dev, **inputs)
    op = getattr(spec["module"], spec["attr"])
    first, second = op(*args, **kwargs), op(*args, **kwargs)
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    return all(torch.equal(x, y) for x, y in zip(first, second) if x is not None)


def deform_same_bits(by_name, paths, gen, dev):
    """The deformable conv's kernels give the same bits on every launch:
    two launches on the same inputs compared bit for bit, of the float32
    forward at every path shape whose plan splits the chunks over blocks
    (slabs summed in a fixed order; its bf16 form likewise), and of the
    backward-data kernel, in
    its float32 and bf16 forms, at every path shape with the path's
    offsets in (-3, 3) px and with wide ones in (-16, 16) px (its scatter
    sums in fixed point). ``paths``: label -> a run's rows (kernel name ->
    rows with their ``shape``). Returns the records; raises on a
    difference."""
    from aanet_torch.ops import deform

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = collections.defaultdict(dict)  # kernel -> signature -> the first path that has it
    for label, rows in paths.items():
        for name in ("deform_conv", "deform_conv_bf16", "deform_conv_backward_data",
                     "deform_conv_backward_data_bf16"):
            for row in rows.get(name, []):
                shapes[name].setdefault(ast.literal_eval(row["shape"]), label)
    records, differ = [], []
    for name, sigs in shapes.items():
        for sig, label in sigs.items():
            (b, cin, h, w), (cout, _, kh, kw), _, _, stride, pad, dil, g = sig
            if name.startswith("deform_conv") and "backward" not in name:
                ho = (h + 2 * pad - dil * (kh - 1) - 1) // stride + 1
                wo = (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1
                plan = deform.forward_plan(b, cin, cout, ho, wo, kh, kw, stride, dil, g, sms)
                if plan.splits == 1:
                    continue
                cases = {f"{plan.splits} splits": {}}
            else:
                cases = {"narrow offsets": {}, "wide offsets": dict(offsets="wide")}
            for case, inputs in cases.items():
                same = same_bits(by_name[name], sig, gen, dev, **inputs)
                records.append(dict(kernel=name, path=label, shape=str(sig), case=case, identical=same))
                if not same:
                    differ.append((name, sig, case))
            torch.cuda.empty_cache()
    print(f"deform kernels, two launches bitwise at {len(records)} path shapes and cases: "
          f"{len(records) - len(differ)} identical", flush=True)
    check(not differ, f"deform kernels: two launches on the same inputs differ: {differ}")
    return records


def fixed_point_precision(spec, rows, gen, dev):
    """A reading, not a check: the backward-data kernel's x gradient
    (summed in fixed point, one exponent for the whole tensor) element by
    element against the plain version in float64 on the same inputs,
    beside the plain version's in float32, at the largest shape of
    ``rows`` (the float32 step's): with the path's inputs, and with the
    output gradient scaled by 10^(-4 b / (B - 1)) in batch entry b, so that
    the last entry's gradients lie four decades below the largest term.
    Per case and side: the relative error |g - r| / |r| over the elements
    with r != 0, its median, 99.9th percentile and largest, and the share
    of elements beyond 2^-20 (16 float32 ulps)."""
    sig = max((ast.literal_eval(r["shape"]) for r in rows), key=lambda s: math.prod(s[0]))
    (gout, *rest), kwargs = spec["inputs"](sig, gen, dev)
    b = gout.shape[0]
    decades = torch.tensor([4.0 * i / max(b - 1, 1) for i in range(b)], device=dev)
    record = dict(shape=str(sig), cases={})
    for case, g in (("path inputs", gout), ("four decades over the batch",
                                              gout * torch.pow(10.0, -decades).view(-1, 1, 1, 1))):
        args = (g, *rest)
        kernel = getattr(spec["module"], spec["attr"])(*args, **kwargs)[0]
        plain = spec["plain"](*args, **kwargs)[0]
        ref = spec["plain"](*(a.double() if a is not None else None for a in args), **kwargs)[0]
        torch.cuda.synchronize()
        nonzero = ref != 0
        sides = {}
        for side, grad in (("kernel", kernel), ("plain float32", plain)):
            rel = ((grad.double() - ref).abs() / ref.abs())[nonzero].sort().values
            n = rel.numel()
            sides[side] = dict(median=float(rel[n // 2]), p999=float(rel[min(n - 1, int(n * 0.999))]),
                               max=float(rel[-1]), beyond_2e_20=float((rel > 2.0 ** -20).sum()) / n)
            del rel
        record["cases"][case] = dict(elements=int(nonzero.sum()), **sides)
        del kernel, plain, ref
        torch.cuda.empty_cache()
    print(f"fixed-point x gradient at {sig}: {record['cases']}", flush=True)
    return record


def correlation_edge_cases(by_name, corr_sigs, gen, dev, timer):
    """Phase 6b for the correlation kernels: at every path shape
    (``CORR_PATH_SHAPES``, which must hold the step's ``corr_sigs``) two
    launches of each kernel give the same bits, and each is timed beside its
    bound; at ``CORR_EDGE_SHAPES`` (and the backward at D = 0) both are held
    against their twins with the path's tolerances."""
    check(set(corr_sigs) <= set(CORR_PATH_SHAPES),
          f"correlation: the step's shapes {corr_sigs} are not all in CORR_PATH_SHAPES")
    records = [same_bits_timed(spec, sig, gen, dev, timer) for sig in CORR_PATH_SHAPES
               for spec in (by_name["correlation"], by_name["correlation_backward"])]
    for sig in CORR_EDGE_SHAPES:
        for name in ("correlation", "correlation_backward"):
            records.append(dict(measure(by_name[name], sig, 1, gen, dev, timer, timed=False),
                                kernel=name, case="beyond the path"))
    zero = (CORR_EDGE_SHAPES[-1][0], 0)
    records.append(dict(measure(by_name["correlation_backward"], zero, 1, gen, dev, timer, timed=False),
                        kernel="correlation_backward", case="D = 0"))
    return records


def softargmin_edge_cases(by_name, sa_sigs, gen, dev, timer):
    """Phase 6b for the soft-argmin kernels: at every path shape
    (``SA_PATH_SHAPES``, which must hold the step's ``sa_sigs``) two launches
    of each kernel give the same bits, and each is timed beside its bound; at
    ``SA_EDGE_SHAPES`` both are held against their twins with the path's
    tolerances; at D = 0 the forward returns zeros and the backward an empty
    gradient."""
    check(set(sa_sigs) <= set(SA_PATH_SHAPES),
          f"soft_argmin: the step's shapes {sa_sigs} are not all in SA_PATH_SHAPES")
    fwd, bwd = by_name["soft_argmin"], by_name["soft_argmin_backward"]
    records = []
    for sig in SA_PATH_SHAPES:
        for spec in (fwd, bwd):
            records.append(same_bits_timed(spec, sig, gen, dev, timer))
            torch.cuda.empty_cache()  # the PSMNet step's volume is 2 GB
    for sig in SA_EDGE_SHAPES:
        for spec in (fwd, bwd):
            records.append(dict(measure(spec, sig, 1, gen, dev, timer, timed=False),
                                kernel=spec["name"], case="beyond the path"))
    for match in (True, False):
        cost = torch.randn((2, 0, 6, 10), generator=gen, device=dev)
        grad = torch.randn((2, 6, 10), generator=gen, device=dev)
        disp = getattr(fwd["module"], fwd["attr"])(cost, match)
        dcost = getattr(bwd["module"], bwd["attr"])(grad, cost, match)
        torch.cuda.synchronize()
        check(disp.shape == (2, 6, 10) and torch.equal(disp, torch.zeros_like(disp)),
              f"soft_argmin at D = 0: {disp}, expected zeros")
        check(dcost.shape == (2, 0, 6, 10), f"soft_argmin_backward at D = 0: {tuple(dcost.shape)}")
        print(f"soft_argmin at D = 0 (match_similarity={match}): zeros; backward {tuple(dcost.shape)}",
              flush=True)
        records.append(dict(kernel="soft_argmin", case="D = 0: zeros", shape=str(((2, 0, 6, 10), match)),
                            max_err=float(disp.abs().max()), tolerance=0.0))
    return records


def volume_edge_cases(by_name, recorded, gen, dev, timer):
    """Phase 10b for the 4-D volume kernels: at every path shape
    (``VOL_PATHS``, which must hold the shapes of ``recorded``: each volume
    kernel's rows from phases 5b and 10) two launches of each kernel give
    the same bits, and each is timed beside its bound; at
    ``VOL_EDGE_SHAPES`` both volumes' kernels, and the backwards at D = 0,
    are held against their twins bit for bit."""
    listed = {n: {str(sig) for sig, concat in VOL_PATHS.values()
                  if concat == n.startswith("concat")}
              for n in ("difference_volume", "concat_volume")}
    for name, shapes in recorded.items():
        kind = name.replace("_backward", "")
        check(set(shapes) <= listed[kind], f"{name}: the paths' shapes {shapes} are not all in VOL_PATHS")
    records = []
    for sig, concat in VOL_PATHS.values():
        kind = "concat_volume" if concat else "difference_volume"
        for name in (kind, f"{kind}_backward"):
            records.append(same_bits_timed(by_name[name], sig, gen, dev, timer))
            torch.cuda.empty_cache()  # GC-Net's inference volume is 2.9 GB
    for sig in VOL_EDGE_SHAPES + [(VOL_EDGE_SHAPES[0][0], 0)]:
        for kind in ("difference_volume", "concat_volume"):
            for name in ((kind, f"{kind}_backward") if sig[1] else (f"{kind}_backward",)):
                records.append(dict(measure(by_name[name], sig, 1, gen, dev, timer, timed=False),
                                    kernel=name, case="beyond the path" if sig[1] else "D = 0"))
    return records


def anchor_phase(specs, gen, dev, left, right):
    """Phase 9b: the ``aanet`` preset at ``ANCHOR_MAX_DISP`` (the committed
    trained anchor's setting; its ISA deformable convs have 16, 8 and 4
    output channels): the forward at 384x1248 through the kernels against
    the plain run (launches and pyramid tolerances as phase 4's), one train
    step at batch 2, 288x576 against the plain step (phase 7's comparison,
    one seeded batch, the spread also taking the kernel step's own change
    when it runs again), and the predict entry point with the preset and
    ``--max_disp`` on two 375x1242 pairs, which must exit 0."""
    from aanet_torch.config import preset

    cfg = dataclasses.replace(preset("aanet"), max_disp=ANCHOR_MAX_DISP)
    record = dict(preset="aanet", max_disp=ANCHOR_MAX_DISP)
    with torch.no_grad():
        model = seeded_model(cfg, dev).eval()
        calibrate_bn_(model, specs, left, right)
        calls = {s["name"]: collections.Counter() for s in specs}
        with plain_ops(specs, calls):
            plain_pyramid = model(left, right)
        couts = sorted({sig[1][0] for sig in calls["deform_conv"]})
        print(f"anchor: deformable convs' output channels {couts}", flush=True)
        check(set(ANCHOR_MAX_DISP // 3 // 2**i for i in range(3)) <= set(couts),
              f"anchor: the ISA convs' output channels are not among {couts}")
        reset_launches(specs)
        pyramid = model(left, right)
        torch.cuda.synchronize()
        counts = launches(specs)
        check(counts == EXPECTED_LAUNCHES, f"anchor: launches {counts}, expected {EXPECTED_LAUNCHES}")
        shapes = [(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)]
        record.update(deform_couts=couts, launches=counts,
                      pyramid_err_px=compare_pyramids(pyramid, plain_pyramid, shapes, "anchor"))
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), weights)
        del model, plain_pyramid, pyramid
        data = os.path.join(tmp, "pairs")
        write_pngs(data, 2, PREDICT_HW, SEED)
        cmd = [sys.executable, "-m", "aanet_torch.cli", "predict", "--preset", "aanet",
               "--max_disp", str(ANCHOR_MAX_DISP), "--data_dir", data, "--pretrained", weights,
               "--device", DEVICE, "--save_type", "npy"]
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"anchor predict exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        for i in range(2):
            pred = np.load(os.path.join(data, "pred", f"{i:06d}.npy"))
            check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                  f"anchor prediction {i}: shape {pred.shape}")
        record["predict_returncode"] = proc.returncode
    torch.set_grad_enabled(True)
    seed_gen = torch.Generator(device=dev).manual_seed(COMPARE_SEEDS[0])
    small = train_batch(seed_gen, dev, COMPARE_BATCH, TRAIN_HW)
    # each parameter against the plain step's spread; the kernel step's own
    # change from run to run must be 0
    compare, m_kernel, step_kernel = compare_train_steps(cfg, specs, small, seed_gen, dev,
                                                         per_parameter=True, rerun=True)
    del m_kernel, step_kernel
    torch.cuda.empty_cache()
    record["train_step_compare"] = compare
    print(json.dumps({"anchor": record}), flush=True)
    check(not compare["failures"], f"anchor kernel vs plain train step: {compare['failures']}")
    return record


def train_phases(specs, bwd_specs, gen, dev, timer, smi, data, lists):
    """Phases 6-9: the training slice of the ``aanet`` preset; phase 9
    trains on the synthetic dataset (data, lists). Returns each kernel's
    rows at the train step's shapes and its launches in one full-width
    train step."""
    from aanet_torch.config import preset
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    torch.set_grad_enabled(True)
    cfg = preset("aanet")
    all_specs = specs + bwd_specs
    model = seeded_model(cfg, dev)
    batch = train_batch(gen, dev, TRAIN_BATCH, TRAIN_HW)

    # 6. the shapes of one plain train step, and every kernel against its
    # plain version at them
    first = {s["name"]: collections.Counter() for s in specs}
    again = {s["name"]: collections.Counter() for s in specs}
    scratch = copy.deepcopy(model)
    with plain_ops(specs, first, again):
        make_train_step(scratch, make_optimizer(scratch, 1e-3), cfg.max_disp)(batch)
    torch.cuda.synchronize()
    del scratch
    made = {n: sum(first[n].values()) + sum(again[n].values()) for n in first}
    made.update({b["name"]: sum(first[b["forward"]].values()) for b in bwd_specs})
    print(f"plain train step: first forwards {dict(first)}, recomputed {dict(again)}", flush=True)
    check(made == EXPECTED_TRAIN_LAUNCHES, f"plain train step made {made}, expected {EXPECTED_TRAIN_LAUNCHES}")
    rows = {}
    for spec in specs:
        rows[spec["name"]] = [
            measure(spec, sig, n + again[spec["name"]][sig], gen, dev, timer, iters=10)
            for sig, n in first[spec["name"]].items()
        ]
    for spec in bwd_specs:
        rows[spec["name"]] = [measure(spec, sig, n, gen, dev, timer, iters=10)
                              for sig, n in first[spec["forward"]].items()]
    # 6b. the redesigned kernels beyond the path's inputs
    edges = edge_cases(specs, bwd_specs, list(first["deform_conv"]), list(first["correlation"]),
                       list(first["soft_argmin"]), list(first["disp_warp"]), rows, gen, dev, timer)
    print(json.dumps({"edge_cases": edges}), flush=True)

    # 7. one train step through the kernels against the same step through
    # the plain twins on each of COMPARE_SEEDS batches
    failures = [f"seed {c['seed']}: {f}" for c in seeded_compares(cfg, specs, dev, COMPARE_SEEDS)
                for f in c["failures"]]
    check(not failures, "kernel vs plain train step: " + "; ".join(failures))

    # 8. the full-width step: the launches of one step, then the timing
    optimizer = make_optimizer(model, 1e-3)
    step = make_train_step(model, optimizer, cfg.max_disp)
    reset_launches(all_specs)
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = launches(all_specs)
    print(f"train-step launches: {counts}", flush=True)
    check(counts == EXPECTED_TRAIN_LAUNCHES, f"train-step launches {counts}, expected {EXPECTED_TRAIN_LAUNCHES}")
    timed = time_steps(step, batch, metrics, dev, top=25)
    full = dict(preset="aanet", batch=TRAIN_BATCH, height=TRAIN_HW[0], width=TRAIN_HW[1],
                dtype="float32", remat=cfg.remat, launches=counts, card=smi, **timed)
    print(json.dumps({"train_step": full}), flush=True)
    del optimizer, step

    # 9. the train entry point on the card, then predict with its weights
    cli = cli_train_and_predict(data, lists, ["--preset", "aanet"], TRAIN_BATCH, launcher=True)
    print(json.dumps({"cli_train": cli}), flush=True)
    return dict(rows=rows, launches=counts, edge_cases=edges, step=full)


def time_steps(step, batch, metrics, dev, top, timed=10, profiled=2):
    """After ``step``'s first run on ``batch`` (its ``metrics``): one more
    warm-up, the median step time over ``timed`` steps (CUDA events),
    samples/s, the losses (all finite), the peak memory of those steps and
    the device breakdown of ``profiled``."""
    n = batch["left"].shape[0]
    step_losses = [metrics["total_loss"], step(batch)["total_loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batch)
        end.record()
        times.append((start, end))
        step_losses.append(metrics["total_loss"])
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in times)
    step_losses = [float(x) for x in step_losses]
    check(all(np.isfinite(step_losses)), f"non-finite losses {step_losses}")
    peak = torch.cuda.max_memory_allocated(dev)
    device = device_breakdown(lambda: step(batch), iters=profiled, top=top)
    return dict(step_ms=step_ms, samples_per_s=n / step_ms * 1e3,
                step_ms_all=[s.elapsed_time(e) for s, e in times], peak_memory_bytes=peak,
                device_ms=device["busy_ms"], profiled_window_ms=device["window_ms"],
                device_idle_share=device["idle_share"], losses=step_losses,
                top_kernels=device["top"])


def cli_train_and_predict(data, lists, model_args, batch, launcher=False):
    """``python -m aanet_torch.cli train`` with ``model_args`` for one epoch
    at ``batch`` on the synthetic dataset (data, lists), as a user runs it;
    checks its losses, its validation and its checkpoint, then predicts
    the first pair with the weights it wrote. With ``launcher`` (phase 9)
    it runs under ``python -m torch.distributed.run --standalone
    --nproc_per_node 1``, a process group of one that brings NCCL up on
    the card, with ``--summary_freq 1``, and checks what rank 0 writes
    (``launcher_outputs``)."""
    from aanet_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "aanet_torch.cli", "train", *model_args,
               "--data_dir", data, "--filename_root", lists, "--checkpoint_dir", ckpt,
               "--img_height", str(TRAIN_HW[0]), "--img_width", str(TRAIN_HW[1]),
               "--val_img_height", str(VAL_HW[0]), "--val_img_width", str(VAL_HW[1]),
               "--batch_size", str(batch), "--val_batch_size", "4", "--max_epoch", "1",
               "--print_freq", "1", "--num_workers", "8", "--milestones", "10", "--device", DEVICE]
        if launcher:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "1", *cmd[1:], "--summary_freq", "1"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli train exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
        cli_losses = [r["total_loss"] for r in records if r["kind"] == "train"]
        check(len(cli_losses) == CLI_PAIRS // batch and all(np.isfinite(cli_losses)),
              f"cli train losses {cli_losses}")
        val = [r for r in records if r["kind"] == "val"]
        latest = os.path.join(ckpt, "aanet_latest.pt")
        check(os.path.exists(latest) and len(val) == 1, f"cli train wrote {os.listdir(ckpt)}")
        outputs = launcher_outputs(ckpt, model_args) if launcher else None
        pairs = os.path.join(tmp, "pairs")
        for sub in ("left", "right"):
            os.makedirs(os.path.join(pairs, sub))
            shutil.copy(os.path.join(data, sub, "0.png"), os.path.join(pairs, sub, "0.png"))
        cli.main(["predict", *model_args, "--data_dir", pairs, "--pretrained", latest,
                  "--save_type", "npy", "--device", DEVICE])
        pred = np.load(os.path.join(pairs, "pred", "0.npy"))
        check(pred.shape == CLI_HW and np.isfinite(pred).all(), f"prediction {pred.shape}")
    return dict(model_args=model_args, batch=batch, seconds=cli_s, losses=cli_losses, val=val[0],
                predict_shape=list(pred.shape), launcher=launcher, outputs=outputs)


def launcher_outputs(ckpt, model_args):
    """What phase 9's ``train`` under the launcher wrote: the ``time ... ETA``
    log line, the summaries under ``tb/`` (TensorBoard's event file where
    ``tensorboard`` is installed, else the file writer's JSONL and PNG
    panels), ``lossRecord.mat`` and ``valLossRecord.mat`` (read with
    scipy), the analysis bundle of validation sample 0, and the flax pair
    ``aanet_latest.msgpack``/``.json``, which the port's reader loads
    strictly into a fresh model whose forward equals the ``.pt`` weights'
    bit for bit."""
    import scipy.io

    from aanet_torch.config import preset
    from aanet_torch.utils.checkpoint import load_pretrained

    with open(os.path.join(ckpt, "trainLog.txt")) as f:
        eta = [line for line in f if " time " in line and " ETA " in line]
    check(len(eta) == CLI_PAIRS // TRAIN_BATCH, f"{len(eta)} ETA lines in trainLog.txt")
    tb = os.listdir(os.path.join(ckpt, "tb"))
    try:  # the import make_summary_writer tries
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401
        events = [n for n in tb if n.startswith("events.out.tfevents.")]
        check(events, f"no TensorBoard event file under tb/: {tb}")
    except ImportError:
        events = [n for n in tb if n == "scalars.jsonl" or n.endswith(".png")]
        check("scalars.jsonl" in events and any(n.startswith("train_pred_disp") for n in events)
              and any(n.startswith("val0_") for n in events), f"the file writer wrote {tb}")
    records = {name: scipy.io.loadmat(os.path.join(ckpt, name))
               for name in ("lossRecord.mat", "valLossRecord.mat")}
    for name, rec in records.items():
        check(rec["epoch"].ravel().tolist() == [1] and np.isfinite(rec["epe"]).all(),
              f"{name}: {sorted(rec)}")
    bundle = scipy.io.loadmat(os.path.join(ckpt, "matlab_analysis", "epoch001_sample00000.mat"))
    check(bundle["pred_scale_4"].shape == VAL_HW and bundle["left"].shape == (*VAL_HW, 3),
          f"analysis bundle {[(k, v.shape) for k, v in bundle.items() if hasattr(v, 'shape')]}")
    with open(os.path.join(ckpt, "aanet_latest.json")) as f:
        meta = json.load(f)
    check(meta["epoch"] == 1 and meta["step"] == CLI_PAIRS // TRAIN_BATCH, f"flax sidecar {meta}")
    check(model_args[0] == "--preset", f"model args {model_args}")
    cfg = preset(model_args[1])
    dev = torch.device(DEVICE)
    from_pt = cfg.build()
    from_pt.load_state_dict(torch.load(os.path.join(ckpt, "aanet_latest.pt"), map_location="cpu",
                                       weights_only=True)["model"])
    from_flax = cfg.build()
    skipped = load_pretrained(from_flax, os.path.join(ckpt, "aanet_latest.msgpack"), strict=True)
    check(skipped == [], f"flax pair left {skipped}")
    pair = train_batch(torch.Generator(device=dev).manual_seed(SEED), dev, 1, TRAIN_HW)
    with torch.no_grad(), deterministic():
        maps = [m.to(dev).eval()(pair["left"], pair["right"]) for m in (from_pt, from_flax)]
    check(all(torch.equal(a, b) for a, b in zip(*maps)),
          "the flax pair's forward differs from the .pt weights'")
    return dict(eta_lines=len(eta), tb=sorted(events)[:4], records=sorted(records),
                flax_meta=meta, forward_bitwise=True)


# Phase 17: data-parallel training on the one card, as gloo ranks (NCCL
# refuses two ranks on one device)
DP_WORLD = 2
DP_BATCH = 4  # the global batch, DP_BATCH // DP_WORLD a rank
DP_ACCUMULATIONS = (1, 2)


def dp_batch(dev):
    """Phase 17's global batch: DP_BATCH of phase 7's seeded pairs, sample
    1's disparity beyond max_disp on half its pixels, so that its rank's
    valid-pixel count is the smaller."""
    batch = train_batch(torch.Generator(device=dev).manual_seed(SEED), dev, DP_BATCH, TRAIN_HW)
    batch["disp"][1, :, : TRAIN_HW[1] // 2] = 250.0  # beyond max_disp 192
    return batch


def dp_step(dev, batch, accumulation, all_specs):
    """One kernel train step of the seeded ``aanet`` preset on ``batch``
    (this rank's share under a process group) under ``deterministic``:
    its metrics, its kernel launches and its model."""
    from aanet_torch.config import preset
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    cfg = preset("aanet")
    with deterministic(), torch.enable_grad():
        model = seeded_model(cfg, dev)
        step = make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp,
                               accumulation_steps=accumulation)
        reset_launches(all_specs)
        metrics = step(batch)
        torch.cuda.synchronize()
        counts = launches(all_specs)
    return metrics, counts, model


def dp_rank(rank, init_file, batch_path, out_dir):
    """A rank of phase 17 (spawned): rows ``rank::DP_WORLD`` of the global
    batch, a step at each of ``DP_ACCUMULATIONS``; saves its losses,
    launches, state and gradients."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=DP_WORLD)
    try:
        specs, bwd_specs = kernel_specs()
        batch = {k: v[rank::DP_WORLD].to(dev) for k, v in torch.load(batch_path).items()}
        out = {}
        for a in DP_ACCUMULATIONS:
            metrics, counts, model = dp_step(dev, batch, a, specs + bwd_specs)
            out[a] = dict(loss=float(metrics["total_loss"]), launches=counts,
                          state={k: v.cpu() for k, v in model.state_dict().items()},
                          grads={n: p.grad.cpu() for n, p in model.named_parameters()})
            del model
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def data_parallel_phase(all_specs, dev, smi):
    """Phase 17: the ``aanet`` kernel train step at 288x576, float32, over
    ``DP_WORLD`` gloo ranks on the card (global batch ``DP_BATCH``, half of
    sample 1's disparities out of range) at each of ``DP_ACCUMULATIONS``,
    against the single-process kernel step on the same global batch, both
    sides under ``deterministic``: the ranks' parameters, BatchNorm
    statistics and gradients equal bit for bit; against one process phase
    7's limits (the loss within rtol 1e-5, all gradients together within
    max(1e-3, 2x the one-process step's spread: its gradients' largest
    change under ``NUDGES`` 1e-6 changes of the left images; a rank's batch
    of 2 takes other kernel plans and cuDNN algorithms than the batch of
    4), the statistics within 1e-4 relative to |value| + 1); each rank's
    launches phase 8's per-step counts, times the accumulation."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    batch = dp_batch(dev)
    with tempfile.TemporaryDirectory() as tmp:
        batch_path = os.path.join(tmp, "batch.pt")
        torch.save({k: v.cpu() for k, v in batch.items()}, batch_path)
        ranks = mp.spawn(dp_rank, args=(os.path.join(tmp, "rendezvous"), batch_path, tmp),
                         nprocs=DP_WORLD, join=False)
        try:
            # the single-process steps while the ranks start, and (phase 7's
            # spread) their gradients' largest change under NUDGES 1e-6
            # changes of the left images
            reference, gen = {}, torch.Generator(device=dev).manual_seed(SEED)
            for a in DP_ACCUMULATIONS:
                metrics, _, model = dp_step(dev, batch, a, all_specs)
                grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
                reference[a] = dict(loss=float(metrics["total_loss"]), grads=grads,
                                    bufs={n: b.cpu() for n, b in model.named_buffers()
                                          if b.is_floating_point()}, moved=[])
                del model
                for _ in range(NUDGES):
                    nudged = dict(batch, left=relative_nudge(batch["left"], gen))
                    _, _, model = dp_step(dev, nudged, a, all_specs)
                    reference[a]["moved"].append(sum(
                        float((p.grad.cpu() - grads[n]).square().sum())
                        for n, p in model.named_parameters()))
                    del model
            while not ranks.join():
                pass
        finally:  # no rank outlives a failure
            for proc in ranks.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        results = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(DP_WORLD)]
    torch.cuda.empty_cache()
    record, failures = {}, []
    for a in DP_ACCUMULATIONS:
        ref, first = reference[a], results[0][a]
        same = all(torch.equal(v, r[a]["state"][k]) for r in results[1:]
                   for k, v in first["state"].items())
        same_grads = all(torch.equal(v, r[a]["grads"][k]) for r in results[1:]
                         for k, v in first["grads"].items())
        dk2 = sum(float((g - ref["grads"][n]).square().sum()) for n, g in first["grads"].items())
        dp2 = sum(float(g.square().sum()) for g in ref["grads"].values())
        stats = max(float(((first["state"][n] - b).abs() / (b.abs() + 1)).max())
                    for n, b in ref["bufs"].items())
        expected = {k: a * v for k, v in EXPECTED_TRAIN_LAUNCHES.items()}
        spread = (max(ref["moved"]) / dp2) ** 0.5
        rec = dict(accumulation=a, loss_ranks=[r[a]["loss"] for r in results],
                   loss_one_process=ref["loss"], grad_rel_err=(dk2 / dp2) ** 0.5,
                   grad_spread=spread, grad_limit=max(1e-3, 2 * spread),
                   bn_stats_rel_err=stats, ranks_bitwise=same, grads_bitwise=same_grads,
                   launches=[r[a]["launches"] for r in results])
        record[a] = rec
        for what, ok in (
                ("ranks' parameters and statistics differ", same),
                ("ranks' gradients differ", same_grads),
                (f"loss {first['loss']} vs {ref['loss']}",
                 abs(first["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])),
                (f"all gradients {rec['grad_rel_err']} > {rec['grad_limit']}",
                 rec["grad_rel_err"] <= rec["grad_limit"]),
                (f"BatchNorm statistics {stats} > 1e-4", stats <= 1e-4),
                (f"launches {rec['launches']}, expected {expected} each",
                 all(c == expected for c in rec["launches"]))):
            if not ok:
                failures.append(f"accumulation {a}: {what}")
    seconds = time.perf_counter() - t0
    print(json.dumps({"data_parallel": dict(world=DP_WORLD, batch=DP_BATCH, hw=TRAIN_HW,
                                            backend="gloo", card=smi, seconds=seconds,
                                            steps=record)}), flush=True)
    check(not failures, "data-parallel step: " + "; ".join(failures))
    print(f"phase 17 took {seconds:.1f} s", flush=True)
    return record


def rebatch(sig, n):
    """A kernel call's signature with its batch (the first axis of its
    first shape) set to ``n``."""
    return ((n,) + tuple(sig[0][1:]),) + tuple(sig[1:])


def fit_batch(cfg, gen, dev, specs):
    """The per-card batch rule: TRAIN_BATCH, halved until one train step
    fits the card. Returns the model, its step, the batch, the first
    step's metrics and launch counts, and the batches that did not fit."""
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    n, refused = TRAIN_BATCH, []
    while True:
        model = seeded_model(cfg, dev)
        step = make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp)
        batch = train_batch(gen, dev, n, TRAIN_HW)
        reset_launches(specs)
        fits = True
        try:
            metrics = step(batch)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            fits = False
        if fits:
            return model, step, batch, metrics, launches(specs), refused
        refused.append(n)
        del model, step, batch
        gc.collect()
        torch.cuda.empty_cache()
        check(n > 1, f"{cfg}: a train step does not fit the card at batch 1")
        n //= 2


def baseline_train_phases(specs, bwd_specs, gen, dev, timer, smi, data, lists):
    """Phase 10: the train steps of the 3-D-aggregation networks and
    stereonet-aa at 288x576, max_disp 192. Returns, per network, each
    kernel's rows at the full step's shapes and the launches of one
    full-width step."""
    torch.set_grad_enabled(True)
    all_specs = specs + bwd_specs
    out = {}
    for name in BASELINES:
        cfg = baseline_config(name)
        print(f"--- {name} train step", flush=True)
        # a kernel step against a plain step at batch 2; the plain step
        # records every kernel call's shape
        first = {s["name"]: collections.Counter() for s in specs}
        again = {s["name"]: collections.Counter() for s in specs}
        small = train_batch(gen, dev, COMPARE_BATCH, TRAIN_HW)
        compare, m_kernel, step_kernel = compare_train_steps(cfg, specs, small, gen, dev,
                                                             calls=first, recomputed=again)
        del m_kernel, step_kernel, small
        made = {n: sum(first[n].values()) + sum(again[n].values()) for n in first}
        made.update({b["name"]: sum(first[b["forward"]].values()) for b in bwd_specs})
        expected = {s["name"]: BASELINES[name]["train_launches"].get(s["name"], 0) for s in all_specs}
        check(made == expected, f"{name}: plain train step made {made}, expected {expected}")
        torch.cuda.empty_cache()

        # the full-width step at the batch rule, and its launches per step
        model, step, batch, metrics, counts, refused = fit_batch(cfg, gen, dev, all_specs)
        n = batch["left"].shape[0]
        print(f"{name} train-step launches at batch {n}: {counts}", flush=True)
        check(counts == expected, f"{name}: train-step launches {counts}, expected {expected}")
        # three timed steps and one profiled: these device-bound steps
        # repeat within 1 %
        timed = time_steps(step, batch, metrics, dev, top=15, timed=3, profiled=1)
        del model, step, batch
        torch.cuda.empty_cache()

        # each kernel against its twin at the full step's shapes: a forward
        # with its recomputations, a backward at its forward's calls (the
        # deform forward's plan depends on the batch)
        rows = {spec["name"]: [measure(spec, rebatch(sig, n), k + again[spec["name"]][sig], gen,
                                       dev, timer, iters=10)
                               for sig, k in first[spec["name"]].items()]
                for spec in specs}
        rows.update({spec["name"]: [measure(spec, rebatch(sig, n), k, gen, dev, timer, iters=10)
                                    for sig, k in first[spec["forward"]].items()]
                     for spec in bwd_specs})
        record = dict(network=name, batch=n, batches_out_of_memory=refused,
                      height=TRAIN_HW[0], width=TRAIN_HW[1], max_disp=cfg.max_disp,
                      dtype="float32", remat=cfg.remat, launches=counts, compare=compare,
                      card=smi, **timed)
        print(json.dumps({"baseline_train_step": record}), flush=True)
        check(not compare["failures"], f"{name} kernel vs plain train step: {compare['failures']}")
        out[name] = dict(rows=rows, launches=counts, step=record)
        torch.cuda.empty_cache()

    # the train entry point with the PSMNet baseline's flags, then predict
    flags = [f"--{k}={v}" for k, v in BASELINES[CLI_BASELINE]["flags"].items()]
    cli = cli_train_and_predict(data, lists, flags, CLI_BASELINE_BATCH)
    print(json.dumps({"baseline_cli_train": cli}), flush=True)
    return out


def adaptive_preset_phases(presets, full_step, specs, bwd_specs, gen, dev, timer, smi, left,
                           right):
    """Phases 11 and 13: each preset of ``presets`` at max_disp 192, its
    forward at 384x1248 (plain, each kernel against its twin at the plain
    run's shapes, through the kernels), ``full_step``'s predict entry
    point, a kernel train step against a plain one at batch 2 (on the
    preset's ``seeds``, phase 7's protocol, where it has them, else on one
    batch), and ``full_step``'s full-width step. Returns, per preset, each
    kernel's rows at its forward's shapes and the launches of one forward
    through the kernels; and for ``full_step`` each kernel's rows at its
    full-width step's shapes and the launches of one step."""
    from aanet_torch.config import preset

    out, steps = {}, {}
    for name, spec in presets.items():
        cfg = preset(name)
        expected = {s["name"]: spec["launches"].get(s["name"], 0) for s in specs}
        with torch.no_grad():
            model = seeded_model(cfg, dev, spec.get("forward_bn_scale", BN_SCALE)).eval()
            calibrate_bn_(model, specs, left, right)
            calls = {s["name"]: collections.Counter() for s in specs}
            with plain_ops(specs, calls):
                plain_pyramid = model(left, right)
            with plain_ops(specs):
                plain_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
            made = {n: sum(c.values()) for n, c in calls.items()}
            check(made == expected, f"{name}: plain forward made {made}, expected {expected}")
            couts = sorted({sig[1][0] for sig in calls["deform_conv"]})
            check(couts == spec["couts"], f"{name}: deformable convs' output channels {couts}")
            rows = {s["name"]: [measure(s, sig, n, gen, dev, timer) for sig, n in calls[s["name"]].items()]
                    for s in specs}
            reset_launches(specs)
            pyramid = model(left, right)
            torch.cuda.synchronize()
            counts = launches(specs)
            print(f"{name} launches: {counts}", flush=True)
            check(counts == expected, f"{name}: launches {counts}, expected {expected}")
            spread = pyramid_spread(model, specs, left, right, plain_pyramid, pyramid)
            print(f"{name} spread (max, mean) px per level: {spread}", flush=True)
            errs = compare_pyramids(pyramid, plain_pyramid, spec["shapes"], name)
            record = forward_record(name, model, left, right, plain_ms, errs, timer, smi)
        record.update(deform_couts=couts, launches=counts, **spread)
        print(json.dumps({"aa_forward": record}), flush=True)
        out[name] = dict(rows=rows, launches=counts, record=record)
        if name == full_step:  # the predict entry point with the preset
            with tempfile.TemporaryDirectory() as tmp:
                weights = os.path.join(tmp, "weights.pt")
                torch.save(model.state_dict(), weights)
                data = os.path.join(tmp, "pairs")
                write_pngs(data, 2, PREDICT_HW, SEED)
                cmd = [sys.executable, "-m", "aanet_torch.cli", "predict", "--preset", name,
                       "--data_dir", data, "--pretrained", weights, "--device", DEVICE,
                       "--save_type", "npy"]
                proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                      capture_output=True, text=True, timeout=600)
                check(proc.returncode == 0, f"{name} predict exited {proc.returncode}:\n{proc.stderr[-4000:]}")
                for i in range(2):
                    pred = np.load(os.path.join(data, "pred", f"{i:06d}.npy"))
                    check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                          f"{name} prediction {i}: shape {pred.shape}")
            print(f"{name} predict: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]}, exit 0", flush=True)
        del model, plain_pyramid, pyramid
        torch.cuda.empty_cache()

    torch.set_grad_enabled(True)
    all_specs = specs + bwd_specs
    for name, spec in presets.items():
        cfg = preset(name)
        # a kernel step against a plain step at batch 2; the (first) plain
        # step records every kernel call
        first = {s["name"]: collections.Counter() for s in specs}
        again = {s["name"]: collections.Counter() for s in specs}
        last = dict(highest_loss_only=spec["highest_loss_only"])
        if "seeds" in spec:
            compare = seeded_compares(cfg, specs, dev, spec["seeds"], calls=first,
                                      recomputed=again, rerun=True, **last)
            failures = [f for c in compare for f in c["failures"]]
        else:
            small = train_batch(gen, dev, COMPARE_BATCH, TRAIN_HW)
            compare, m_kernel, step_kernel = compare_train_steps(
                cfg, specs, small, gen, dev, calls=first, recomputed=again, **last)
            failures = compare["failures"]
            del m_kernel, step_kernel, small
        made = {n: sum(first[n].values()) + sum(again[n].values()) for n in first}
        made.update({b["name"]: sum(first[b["forward"]].values()) for b in bwd_specs})
        expected = {s["name"]: spec["train_launches"].get(s["name"], 0) for s in all_specs}
        record = dict(preset=name, highest_loss_only=spec["highest_loss_only"],
                      height=TRAIN_HW[0], width=TRAIN_HW[1], max_disp=cfg.max_disp, dtype="float32",
                      remat=cfg.remat, compare=compare, card=smi)
        torch.cuda.empty_cache()
        if name == full_step:  # the full-width step at the batch rule
            model, step, batch, metrics, counts, refused = fit_batch(cfg, gen, dev, all_specs)
            n = batch["left"].shape[0]
            print(f"{name} train-step launches at batch {n}: {counts}", flush=True)
            check(counts == expected, f"{name}: train-step launches {counts}, expected {expected}")
            # three timed steps and one profiled, as phase 10's
            record.update(batch=n, batches_out_of_memory=refused, launches=counts,
                          **time_steps(step, batch, metrics, dev, top=15, timed=3, profiled=1))
            del model, step, batch
            torch.cuda.empty_cache()
            # each kernel against its twin at the full step's shapes
            rows = {sp["name"]: [measure(sp, rebatch(sig, n), k + again[sp["name"]][sig], gen, dev,
                                         timer, iters=10)
                                 for sig, k in first[sp["name"]].items()] for sp in specs}
            rows.update({sp["name"]: [measure(sp, rebatch(sig, n), k, gen, dev, timer, iters=10)
                                      for sig, k in first[sp["forward"]].items()]
                         for sp in bwd_specs})
            steps[name] = dict(rows=rows, launches=counts, batch=n, step=record)
        print(json.dumps({"aa_train_step": record}), flush=True)
        check(made == expected, f"{name}: plain train step made {made}, expected {expected}")
        check(not failures, f"{name} kernel vs plain train step: {failures}")
    return out, steps


def cli_train_and_resume(data, lists, name, batch):
    """``python -m aanet_torch.cli train --preset name --save_ckpt_freq 1``
    for one epoch at ``batch`` on phase 9's dataset, as a user runs it, then
    the same command with ``--resume`` and ``--max_epoch 2``: the second run
    restores epoch 1 and its step, takes the next epoch's steps from there,
    and each run writes its epoch's periodic checkpoint with its flax pair."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run")
        cmd = [sys.executable, "-m", "aanet_torch.cli", "train", "--preset", name,
               "--data_dir", data, "--filename_root", lists, "--checkpoint_dir", ckpt,
               "--img_height", str(TRAIN_HW[0]), "--img_width", str(TRAIN_HW[1]),
               "--batch_size", str(batch), "--num_workers", "8", "--milestones", "10",
               "--print_freq", "1", "--no_validate", "--save_ckpt_freq", "1", "--device", DEVICE]
        runs = []
        for extra in (["--max_epoch", "1"], ["--max_epoch", "2", "--resume"]):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd + extra, cwd=os.path.dirname(os.path.abspath(__file__)),
                                  capture_output=True, text=True, timeout=600)
            runs.append(time.perf_counter() - t0)
            check(proc.returncode == 0, f"cli train {extra} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        steps = CLI_PAIRS // batch
        with open(os.path.join(ckpt, "trainLog.txt")) as f:
            log = f.read()
        check(f"resumed from epoch 1, step {steps}" in log, "cli train --resume: no resume logged")
        records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
        losses = [r["total_loss"] for r in records if r["kind"] == "train"]
        check([r["step"] for r in records] == list(range(1, 2 * steps + 1))
              and all(np.isfinite(losses)), f"cli train and resume: {records}")
        latest = torch.load(os.path.join(ckpt, "aanet_latest.pt"), map_location="cpu",
                            weights_only=True)
        saved = sorted(os.listdir(os.path.join(ckpt, "models")))
        check((latest["epoch"], latest["step"]) == (2, 2 * steps)
              and saved == [f"aanet_epoch_00{e}.{suffix}" for e in (1, 2)
                            for suffix in ("json", "msgpack", "pt")],
              f"cli train and resume: latest at epoch {latest['epoch']} step {latest['step']}, "
              f"periodic {saved}")
    return dict(preset=name, batch=batch, seconds=runs, losses=losses, periodic=saved,
                resumed_epoch=latest["epoch"], resumed_step=latest["step"])


def anchor_entry_points(specs, smi):
    """Phase 12: the trained anchor through ``evaluate`` and ``inference``
    as a user runs them, on the set it was trained on; the evaluation again
    in this process through the plain twins. Returns the record."""
    from aanet_torch import cli

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data, lists = write_synthetic(tmp)
        model = ["--preset", "aanet", "--max_disp", str(ANCHOR_MAX_DISP), "--pretrained",
                 os.path.join(root, ANCHOR), "--strict", "--data_dir", data, "--filename_root", lists,
                 "--num_workers", "4", "--device", DEVICE]
        val = ["--val_img_height", "96", "--val_img_width", "192", "--val_batch_size", "4"]

        def run(*args):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "aanet_torch.cli", *args], cwd=root,
                                  capture_output=True, text=True, timeout=600)
            check(proc.returncode == 0, f"cli {args[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            return json.loads(proc.stdout.strip().splitlines()[-1]), time.perf_counter() - t0

        kernel, eval_s = run("evaluate", *model, *val, "--checkpoint_dir", os.path.join(tmp, "eval"))
        out = io.StringIO()
        with plain_ops(specs), contextlib.redirect_stdout(out):
            cli.main(["evaluate", *model, *val, "--checkpoint_dir", os.path.join(tmp, "plain")])
        plain = json.loads(out.getvalue().strip().splitlines()[-1])
        timed, inference_s = run("inference", *model, "--img_height", "96", "--img_width", "192",
                                 "--batch_size", "1", "--count_time", "--save_type", "pfm",
                                 "--output_dir", os.path.join(tmp, "inference"))
    mean_s = timed["mean_inference_seconds"]
    print(f"anchor inference --count_time: {mean_s} s per pair at 96x192, batch 1 ({smi})", flush=True)
    record = dict(evaluate_kernel=kernel, evaluate_plain=plain, evaluate_s=eval_s,
                  epe_difference=abs(kernel["epe"] - plain["epe"]), mean_inference_seconds=mean_s,
                  inference_s=inference_s, card=smi)
    print(json.dumps({"anchor_entry_points": record}), flush=True)
    check(kernel["epe"] < ANCHOR_EPE, f"anchor evaluate: EPE {kernel['epe']} >= {ANCHOR_EPE}")
    check(record["epe_difference"] <= 1e-3,
          f"anchor evaluate: kernel EPE {kernel['epe']}, plain {plain['epe']}")
    check(np.isfinite(mean_s) and mean_s > 0, f"anchor inference: {mean_s} s per pair")
    return record


@contextlib.contextmanager
def checked_ops(specs, errs):
    """Run each op of ``specs`` (its kernel) and then its plain twin on the
    same inputs, and append (name, error, tolerance) of every call to
    ``errs``: the kernels held against their twins on the path's own data.
    The twins launch nothing; the kernels' launches go to counters of the
    wrapper (a copy of the op's), which nothing reads."""
    def checking(spec, op):
        @functools.wraps(op)  # the op counts its launches on the module's name
        def run(*args, **kwargs):
            got = op(*args, **kwargs)
            want = spec["plain"](*args, **kwargs)
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            for g, w in pairs:
                if w is None:  # a mask-less conv's mask gradient
                    continue
                errs.append((spec["name"], float((g.float() - w.float()).abs().max()), spec["tol"](w)))
            return got
        return run

    with contextlib.ExitStack() as stack:
        for spec in specs:
            op = getattr(spec["module"], spec["attr"])
            stack.enter_context(mock.patch.object(spec["module"], spec["attr"], checking(spec, op)))
        yield


def pyramid_errors(a, b):
    return [(float((x - y).abs().max()), float((x - y).abs().mean())) for x, y in zip(a, b)]


def interleaved_latency(runs, iters=10, warmup=2):
    """Each (label, fn) of ``runs`` in turns, in the order a, b, b, a:
    ``iters`` calls a block, each started on an idle device, timed by the
    host (until the call returns: the time to enqueue it) and by CUDA
    events (from the call to the end of its work; no L2 flush). Returns,
    per label, the medians of each block."""
    out = {label: [] for label, _ in runs}
    for label, fn in list(runs) + list(reversed(runs)):
        for _ in range(warmup):
            fn()
        enqueue, latency = [], []
        for _ in range(iters):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            enqueue.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            latency.append(start.elapsed_time(end))
        out[label].append(dict(enqueue_ms=statistics.median(enqueue),
                               latency_ms=statistics.median(latency)))
    return out


def anchor_pair(dev, h=HEIGHT, w=WIDTH, shift=ANCHOR_SHIFT):
    """A pair like the trained anchor's training set at h x w (numpy seed
    ``SEED``): horizontally smoothed noise, left[x] = right[x + shift],
    normalised as the data pipeline does."""
    from aanet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

    rs = np.random.RandomState(SEED)
    base = rs.rand(h, w + 16, 3)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 2, 1)) / 3
    mean, std = np.array(IMAGENET_MEAN), np.array(IMAGENET_STD)

    def image(a):
        a = ((a - mean) / std).astype(np.float32).transpose(2, 0, 1)[None]
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return image(base[:, shift: w + shift]), image(base[:, :w])


def anchor_bf16_pyramid(specs, specs16, dev, smi):
    """Phase 14, the whole network in bf16 at trained weights: the anchor
    (``aanet`` at ``ANCHOR_MAX_DISP``) at 384x1248 on ``anchor_pair``, in
    float32 and in bf16, through the kernels and through the plain twins.
    The bf16 kernel path launches the bf16 kernels only (deform 15,
    correlation 3, soft-argmin 3, warp 2); its pyramid is held to the plain
    bf16 one within ``ANCHOR_BF16_PYRAMID_PX`` per level, and its final map
    to the float32 kernel path's within ``ANCHOR_BF16_F32_PX``. Returns the
    record."""
    from aanet_torch.config import preset
    from aanet_torch.utils.checkpoint import load_pretrained

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = dataclasses.replace(preset("aanet"), max_disp=ANCHOR_MAX_DISP)
    left, right = anchor_pair(dev)
    expected = BF16_PRESETS["aanet"]["launches"]
    models = {}
    for dtype in ("float32", "bfloat16"):
        model = dataclasses.replace(cfg, dtype=dtype).build()
        load_pretrained(model, os.path.join(root, ANCHOR), strict=True)
        models[dtype] = model.to(dev).eval()
    with torch.no_grad():
        f32 = models["float32"](left, right)
        with plain_ops(specs16):
            plain = models["bfloat16"](left, right)
        reset_launches(specs + specs16)
        pyramid = models["bfloat16"](left, right)
        torch.cuda.synchronize()
        counts = launches(specs16)
        f32_counts = {k: v for k, v in launches(specs).items() if v}
        again = models["bfloat16"](left, right)
    del models
    shapes = BF16_PRESETS["aanet"]["shapes"]
    check([tuple(p.shape) for p in pyramid] == shapes
          and all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid),
          f"anchor bf16: pyramid {[(tuple(p.shape), p.dtype) for p in pyramid]}")
    check(counts == expected and not f32_counts,
          f"anchor bf16: launches {counts} (float32 kernels {f32_counts}), expected {expected}")
    final = (pyramid[-1] - f32[-1]).abs().flatten()
    record = dict(
        preset="aanet", max_disp=ANCHOR_MAX_DISP, height=HEIGHT, width=WIDTH, shift=ANCHOR_SHIFT,
        launches=counts, kernel_vs_plain_bf16_px=pyramid_errors(pyramid, plain),
        kernel_rerun_px=pyramid_errors(again, pyramid),
        plain_bf16_vs_float32_px=pyramid_errors(plain, f32),
        kernel_bf16_vs_float32_px=pyramid_errors(pyramid, f32),
        final_vs_float32_mean_p99_px=(float(final.mean()), float(torch.quantile(final, 0.99))),
        final_epe_px=dict(float32=float((f32[-1] - ANCHOR_SHIFT).abs().mean()),
                          bfloat16=float((pyramid[-1] - ANCHOR_SHIFT).abs().mean())),
        card=smi)
    print(json.dumps({"anchor_bf16_pyramid": record}), flush=True)
    limit_max, limit_mean = ANCHOR_BF16_PYRAMID_PX
    check(all(mx <= limit_max and mn <= limit_mean for mx, mn in record["kernel_vs_plain_bf16_px"]),
          f"anchor bf16: kernel vs plain bf16 (max, mean) px per level "
          f"{record['kernel_vs_plain_bf16_px']}, limits {ANCHOR_BF16_PYRAMID_PX}")
    mean, p99 = record["final_vs_float32_mean_p99_px"]
    check(mean < ANCHOR_BF16_F32_PX[0] and p99 < ANCHOR_BF16_F32_PX[1],
          f"anchor bf16 vs float32 at the final level: mean {mean}, p99 {p99} px")
    return record


def bf16_serving_phases(specs, specs16, gen, dev, timer, smi, left, right, f32_records):
    """Phase 14: ``aanet`` and ``aanet+`` served in bfloat16 at max_disp
    192, 384x1248, batch 1 (the seeded, calibrated weights of phases 4 and
    13): the forward through the plain twins recording every bf16 kernel
    call, each bf16 kernel against its twin at those shapes (timed beside
    its bound, its float32 kernel and, for the warp, F.grid_sample in
    bf16), then through the kernels with its launch counts, every kernel
    call of that path against its twin on the path's own inputs, and the
    pyramid against the plain bf16 one and the float32 one; latency, peak
    memory and idle share beside the float32 forward's (``f32_records``,
    this run's phases 4 and 13). Returns, per preset, each bf16 kernel's
    rows and the launches of one forward."""
    from aanet_torch.config import preset

    out = {}
    for name, spec in BF16_PRESETS.items():
        cfg = preset(name)
        expected = {s["name"]: spec["launches"][s["name"]] for s in specs16}
        with torch.no_grad():
            model32 = seeded_model(cfg, dev, spec["bn_scale"]).eval()
            calibrate_bn_(model32, specs, left, right)
            model = dataclasses.replace(cfg, dtype="bfloat16").build()
            model.load_state_dict(model32.state_dict())
            model = model.to(dev).eval()
            with plain_ops(specs):
                plain32 = model32(left, right)
            calls = {s["name"]: collections.Counter() for s in specs16}
            with plain_ops(specs16, calls):
                plain = model(left, right)
            with plain_ops(specs16):
                plain_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
            made = {n: sum(c.values()) for n, c in calls.items()}
            check(made == expected, f"{name} bf16: plain forward made {made}, expected {expected}")
            rows = {s["name"]: [measure(s, sig, n, gen, dev, timer) for sig, n in calls[s["name"]].items()]
                    for s in specs16}
            reset_launches(specs + specs16)
            pyramid = model(left, right)
            torch.cuda.synchronize()
            counts = launches(specs16)
            f32_counts = {k: v for k, v in launches(specs).items() if v}
            print(f"{name} bf16 launches: {counts}", flush=True)
            check(counts == expected and not f32_counts,
                  f"{name} bf16: launches {counts} (float32 kernels {f32_counts}), expected {expected}")
            calls_checked = []
            with checked_ops(specs16, calls_checked):
                model(left, right)
            worst = max(calls_checked, key=lambda e: e[1] / e[2] if e[2] > 0 else e[1])
            check(len(calls_checked) == sum(expected.values()) + expected["disp_warp_bf16"]
                  and all(err <= tol for _, err, tol in calls_checked),
                  f"{name} bf16: a path call off its twin: {[e for e in calls_checked if e[1] > e[2]]}")
            shapes = spec["shapes"]
            check([tuple(p.shape) for p in pyramid] == shapes
                  and all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid),
                  f"{name} bf16: pyramid {[(tuple(p.shape), p.dtype) for p in pyramid]}")
            kernel_plain = pyramid_errors(pyramid, plain)
            plain_f32 = pyramid_errors(plain, plain32)
            kernel_f32 = pyramid_errors(pyramid, plain32)
            # The random network in bf16 is chaotic: a rounding flip moves
            # its maps by pixels, with either BatchNorm scale (aanet+ draws
            # PLUS_FORWARD_BN_SCALE). A loose guard per level: the kernel
            # path no farther (in the mean) from the plain bf16 path than
            # the plain bf16 path is from float32, and no farther from
            # float32 than 1.5 times it. The tight whole-network check is
            # the trained anchor's (anchor_bf16_pyramid).
            check(all(kp[1] <= pf[1] and kf[1] <= 1.5 * pf[1]
                      for kp, pf, kf in zip(kernel_plain, plain_f32, kernel_f32)),
                  f"{name} bf16: (max, mean) px per level, kernel vs plain bf16 {kernel_plain}, "
                  f"plain bf16 vs float32 {plain_f32}, kernel bf16 vs float32 {kernel_f32}")
            # float32 and bf16 in turns on the same weights and inputs, the
            # host's enqueue time beside each latency
            turns = interleaved_latency([("float32", lambda: model32(left, right)),
                                         ("bfloat16", lambda: model(left, right))])
            del model32
            record = forward_record(f"{name} bf16", model, left, right, plain_ms, kernel_plain,
                                    timer, smi, dtype="bfloat16")
        f32 = f32_records[name]
        record.update(
            launches=counts, path_calls_checked=len(calls_checked),
            worst_path_call=dict(kernel=worst[0], err=worst[1], tolerance=worst[2]),
            plain_bf16_vs_float32_px=plain_f32, kernel_bf16_vs_float32_px=kernel_f32,
            in_turns=turns,
            float32=dict(latency_ms=f32["latency_ms"], peak_memory_bytes=f32["peak_memory_bytes"],
                         forward_memory_bytes=f32["forward_memory_bytes"],
                         device_idle_share=f32["device_idle_share"], device_ms=f32["device_ms"]),
        )
        print(f"{name} bf16 forward {record['latency_ms']:.4f} ms (float32 {f32['latency_ms']:.4f} "
              f"ms), idle {record['device_idle_share']:.4f} (float32 "
              f"{f32['device_idle_share']:.4f}), peak {record['peak_memory_bytes']} B (float32 "
              f"{f32['peak_memory_bytes']} B) on {smi}", flush=True)
        print(f"{name} in turns (float32, bf16, bf16, float32; enqueue and latency ms): "
              f"{turns}", flush=True)
        print(json.dumps({"bf16_forward": record}), flush=True)
        out[f"{name} bf16"] = dict(rows=rows, launches=counts)
        if name == "aanet+":  # the predict entry point in bf16
            with tempfile.TemporaryDirectory() as tmp:
                weights = os.path.join(tmp, "weights.pt")
                torch.save(model.state_dict(), weights)
                data = os.path.join(tmp, "pairs")
                write_pngs(data, 2, PREDICT_HW, SEED)
                cmd = [sys.executable, "-m", "aanet_torch.cli", "predict", "--preset", name,
                       "--dtype", "bfloat16", "--data_dir", data, "--pretrained", weights,
                       "--device", DEVICE, "--save_type", "npy"]
                proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                                      capture_output=True, text=True, timeout=600)
                check(proc.returncode == 0, f"{name} bf16 predict exited {proc.returncode}:\n"
                      f"{proc.stderr[-4000:]}")
                for i in range(2):
                    pred = np.load(os.path.join(data, "pred", f"{i:06d}.npy"))
                    check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                          f"{name} bf16 prediction {i}: shape {pred.shape}")
            print(f"{name} predict --dtype bfloat16: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]}, "
                  "exit 0", flush=True)
        del model, plain, plain32, pyramid
        torch.cuda.empty_cache()
    return out


def anchor_bf16_entry_points(f32_record, smi):
    """Phase 14, continued: the trained anchor through ``evaluate
    --dtype bfloat16`` on phase 12's set (its EPE within
    ``ANCHOR_BF16_EPE`` px of phase 12's float32 EPE) and ``inference
    --count_time --dtype bfloat16``. Returns the record."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data, lists = write_synthetic(tmp)
        model = ["--preset", "aanet", "--max_disp", str(ANCHOR_MAX_DISP), "--pretrained",
                 os.path.join(root, ANCHOR), "--strict", "--dtype", "bfloat16", "--data_dir", data,
                 "--filename_root", lists, "--num_workers", "4", "--device", DEVICE]

        def run(*args):
            return subprocess.run([sys.executable, "-m", "aanet_torch.cli", *args], cwd=root,
                                  capture_output=True, text=True, timeout=600)

        results = {}
        for args in (["evaluate", *model, "--val_img_height", "96", "--val_img_width", "192",
                      "--val_batch_size", "4", "--checkpoint_dir", os.path.join(tmp, "eval")],
                     ["inference", *model, "--img_height", "96", "--img_width", "192",
                      "--batch_size", "1", "--count_time", "--output_dir", os.path.join(tmp, "inf")]):
            proc = run(*args)
            check(proc.returncode == 0, f"cli {args[0]} --dtype bfloat16 exited {proc.returncode}:\n"
                  f"{proc.stderr[-4000:]}")
            results[args[0]] = json.loads(proc.stdout.strip().splitlines()[-1])
    epe16, epe32 = results["evaluate"]["epe"], f32_record["evaluate_kernel"]["epe"]
    record = dict(evaluate_bf16=results["evaluate"], evaluate_float32_epe=epe32,
                  epe_difference=abs(epe16 - epe32),
                  mean_inference_seconds_bf16=results["inference"]["mean_inference_seconds"],
                  mean_inference_seconds_float32=f32_record["mean_inference_seconds"], card=smi)
    print(json.dumps({"anchor_bf16_entry_points": record}), flush=True)
    check(record["epe_difference"] <= ANCHOR_BF16_EPE,
          f"anchor evaluate --dtype bfloat16: EPE {epe16}, float32 {epe32}")
    return record


def bf16_training_phases(specs, bwd_specs, specs16, bwd16, gen, dev, timer, smi, f32_steps):
    """Phase 15: bf16 training on the card. (a) One plain bf16 train step of
    ``aanet`` and of ``aanet+`` at batch 2, 288x576, records every bf16
    kernel call; each bf16 backward kernel is held against its twin at
    each of those shapes (one bf16 ulp of each gradient's scale), with
    offsets in (-16, 16) px, at ``ODD_COUTS`` output channels, mask-less
    and at an odd stride-2 shape, the correlation forward and backward at
    ``CORR_EDGE_SHAPES`` and D = 0 (the backward also at every
    ``CORR_PATH_SHAPES`` shape, two launches bitwise), the soft-argmin
    backward at ``SA_EDGE_SHAPES`` (both signs) and the warp backward at
    ``WARP_EDGE_SHAPES``, two launches of it bitwise at the full step's
    shapes, timed (``warp_backward_edge_cases``); the bf16 deform forward against its twin
    at the step's shapes; two launches of the deform forward, the weight
    gradient and the correlation backward give the same bits at every step
    shape, and of the correlation forward and the soft-argmin backward too,
    each timed beside its bound (``same_bits_timed``);
    and one kernel step of each holds every backward kernel call against
    its twin on the path's own inputs; a bf16 step of each other
    correlation preset through the kernels (its float32 step's launches in
    bf16 forms only, a finite loss and gradients). (b) The bf16 kernel
    step against the plain bf16 step on phase 7's three seeded batches
    (``seeded_compares`` with ``one_ulp_nudge`` and the float32 step as the
    guard), three kernel steps lowering the loss.
    (c) The full-width bf16 steps (batch 16) of ``aanet`` and ``aanet+``
    with their launch counts (no float32 kernel), timed over 5 steps (phase
    8 times 10), beside the float32 steps (``f32_steps``), and each bf16 backward
    kernel and each bf16 forward kernel (the deform forward's 42 and 62
    launches a step with remat's recompute; the correlation's, soft-argmin's
    and warp's 3, 3 and 4) against its twin at their shapes, timed. Returns,
    per step, those kernels' rows and the step's launches."""
    from aanet_torch.config import preset
    from aanet_torch.models.layers import set_train_mode
    from aanet_torch.train.optimizer import make_optimizer
    from aanet_torch.train.trainer import make_train_step

    torch.set_grad_enabled(True)
    t0 = time.perf_counter()
    all16 = specs16 + bwd16
    by_name = {s["name"]: s for s in bwd16}
    shapes, recomputed, edges = {}, {}, []
    for name, expected in BF16_TRAIN_PRESETS.items():
        cfg = dataclasses.replace(preset(name), dtype="bfloat16")
        first = {s["name"]: collections.Counter() for s in specs16}
        again = {s["name"]: collections.Counter() for s in specs16}
        model = seeded_model(cfg, dev)
        small = train_batch(gen, dev, COMPARE_BATCH, TRAIN_HW)
        with plain_ops(specs16, first, again):
            make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp)(small)
        made = {n: sum(first[n].values()) + sum(again[n].values()) for n in first}
        made.update({b["name"]: sum(first[b["forward"]].values()) for b in bwd16})
        check(made == expected, f"{name} bf16: plain train step made {made}, expected {expected}")
        shapes[name], recomputed[name] = first, again
        # every backward kernel call of a kernel step on the path's own inputs
        set_train_mode(model)
        calls_checked = []
        with checked_ops(bwd16, calls_checked):
            make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp)(small)
        want = sum(v for k, v in expected.items() if "backward" in k)
        bad = [e for e in calls_checked if e[1] > e[2]]
        edges.append(dict(case=f"{name} bf16 step at batch 2: every backward call on its own inputs",
                          calls=len(calls_checked), worst=max(calls_checked, key=lambda e: e[1] / e[2]
                                                              if e[2] > 0 else e[1])))
        check(len(calls_checked) >= want and not bad, f"{name} bf16: backward calls off their twins: {bad}")
        del model, small
        torch.cuda.empty_cache()
    # the other correlation presets' bf16 steps through the kernels: their
    # float32 steps' launches, each in its bf16 form, and no float32 kernel
    others = {name: dict(spec, preset=name) for name, spec in (
        ("stereonet-aa", dict(BASELINES["stereonet-aa"], highest_loss_only=False)),
        *AA_PRESETS.items(), ("ganet-aa", PLUS_PRESETS["ganet-aa"]))}
    for name, spec in others.items():
        cfg = dataclasses.replace(preset(name), dtype="bfloat16")
        expected = {f"{k}_bf16": v for k, v in spec["train_launches"].items() if v}
        model = seeded_model(cfg, dev)
        step = make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp,
                               highest_loss_only=spec["highest_loss_only"])
        small = train_batch(gen, dev, COMPARE_BATCH, TRAIN_HW)
        reset_launches(specs + bwd_specs + all16)
        loss = float(step(small)["total_loss"])
        torch.cuda.synchronize()
        counts = {k: v for k, v in launches(all16).items() if v}
        f32_counts = {k: v for k, v in launches(specs + bwd_specs).items() if v}
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        print(f"{name} bf16 step at batch {COMPARE_BATCH}: loss {loss}, launches {counts}", flush=True)
        edges.append(dict(case=f"{name} bf16 step at batch {COMPARE_BATCH}", loss=loss, launches=counts))
        check(counts == expected and not f32_counts and np.isfinite(loss) and finite,
              f"{name} bf16 step: launches {counts} (float32 kernels {f32_counts}), expected "
              f"{expected}; loss {loss}, finite gradients {finite}")
        del model, step, small
        torch.cuda.empty_cache()
    # each bf16 backward kernel at the aanet and aanet+ steps' shapes, with
    # the path's offsets and wide ones; two launches bitwise for the weight
    # gradient, the correlation backward and the deform forward (its split
    # plans sum float32 slabs in a fixed order)
    def two_launches_bitwise(spec, sig):
        same = same_bits(spec, sig, gen, dev)
        check(same, f"{spec['name']} {sig}: two launches on the same inputs differ")
        edges.append(dict(kernel=spec["name"], case="two launches, bitwise", shape=str(sig),
                          identical=same))

    fwd16 = next(s for s in specs16 if s["name"] == "deform_conv_bf16")
    corr_fwd16 = next(s for s in specs16 if s["name"] == "correlation_bf16")
    for name, first in shapes.items():
        for sig in first[fwd16["name"]]:
            edges.append(dict(measure(fwd16, sig, 1, gen, dev, timer, timed=False),
                              kernel=fwd16["name"], case=f"{name} step shape"))
            two_launches_bitwise(fwd16, sig)
        for sig in first[corr_fwd16["name"]]:
            edges.append(dict(same_bits_timed(corr_fwd16, sig, gen, dev, timer),
                              case=f"{name} step shape: two launches, bitwise; timed"))
        for spec in bwd16:
            for sig in first[spec["forward"]]:
                edges.append(dict(measure(spec, sig, 1, gen, dev, timer, timed=False),
                                  kernel=spec["name"], case=f"{name} step shape"))
                if spec["name"].startswith("deform"):
                    wide = dict(spec, inputs=functools.partial(spec["inputs"], offsets="wide"))
                    edges.append(dict(measure(wide, sig, 1, gen, dev, timer, timed=False),
                                      kernel=spec["name"], case=f"{name} step shape, wide offsets"))
                if spec["name"] in ("deform_conv_backward_weight_bf16", "correlation_backward_bf16"):
                    two_launches_bitwise(spec, sig)
                if spec["name"] == "soft_argmin_backward_bf16":
                    edges.append(dict(same_bits_timed(spec, sig, gen, dev, timer),
                                      case=f"{name} step shape: two launches, bitwise; timed"))
    # phase 6b's edges: ODD_COUTS channels, mask-less with one group, an odd
    # stride-2 shape, with narrow, wide and integer offsets
    odd = ((2, 24, 37, 53), (24, 24, 3, 3), True, False, 2, 2, 2, 2)
    cases = [(((2, c, 96, 192), (c, c, 3, 3), True, True, 1, 2, 2, 2 if c % 2 == 0 else 1), f"cout {c}")
             for c in ODD_COUTS]
    cases += [(odd, "stride 2, odd sizes"),
              (odd[:2] + (False, False) + odd[4:7] + (1,), "stride 2, odd sizes, mask-less, G=1")]
    for sig, case in cases:
        for kernel in ("deform_conv_backward_data_bf16", "deform_conv_backward_weight_bf16"):
            for offsets in ("narrow", "wide", "integer"):
                spec = dict(by_name[kernel], inputs=functools.partial(by_name[kernel]["inputs"],
                                                                      offsets=offsets))
                edges.append(dict(measure(spec, sig, 1, gen, dev, timer, timed=False), kernel=kernel,
                                  case=f"{case}, {offsets} offsets"))
    # the bf16 correlation forward and backward beyond the path (phase 6b's
    # shapes: widths off the 16- and 8-byte pieces, channels off the chunks,
    # D > W, D = 1, 24, 40, and D = 0: an empty volume, no gradient), and the
    # bf16 soft-argmin backward (odd planes: values staged by a load and a
    # store; planes smaller than a tile, D = 1, 37 and 191, both signs)
    corr16 = by_name["correlation_backward_bf16"]
    for sig in CORR_EDGE_SHAPES:
        edges.append(dict(measure(corr_fwd16, sig, 1, gen, dev, timer, timed=False),
                          kernel=corr_fwd16["name"], case="beyond the path"))
    zero = (CORR_EDGE_SHAPES[-1][0], 0)
    (left, right, _), _ = corr_fwd16["inputs"](zero, gen, dev)
    empty = getattr(corr_fwd16["module"], corr_fwd16["attr"])(left, right, 0)
    torch.cuda.synchronize()
    check(empty.shape == (left.shape[0], 0, *left.shape[2:]) and empty.dtype == torch.bfloat16,
          f"correlation_bf16 at D = 0: {tuple(empty.shape)} {empty.dtype}")
    edges.append(dict(kernel=corr_fwd16["name"], case="D = 0: an empty volume", shape=str(zero),
                      max_err=0.0, tolerance=0.0))
    for sig in CORR_EDGE_SHAPES + [zero]:
        edges.append(dict(measure(corr16, sig, 1, gen, dev, timer, timed=False),
                          kernel=corr16["name"], case="beyond the path" if sig[1] else "D = 0"))
    for sig in CORR_PATH_SHAPES:  # every path's gradient, also those no bf16 step here runs
        edges.append(dict(measure(corr16, sig, 1, gen, dev, timer, timed=False),
                          kernel=corr16["name"], case="path shape"))
        two_launches_bitwise(corr16, sig)
    warp_sigs = [rebatch(sig, TRAIN_BATCH) for first in shapes.values()
                 for sig in first["disp_warp_bf16"]]
    edges += warp_backward_edge_cases(by_name["disp_warp_backward_bf16"], warp_sigs, gen, dev, timer)
    sa16 = by_name["soft_argmin_backward_bf16"]
    for sig in SA_EDGE_SHAPES:
        edges.append(dict(measure(sa16, sig, 1, gen, dev, timer, timed=False), kernel=sa16["name"],
                          case="beyond the path"))
    edges += bf16_forward_edge_cases(specs, specs16, shapes, gen, dev, timer)
    print(json.dumps({"bf16_backward_edge_cases": edges}), flush=True)
    t_a = time.perf_counter()

    # (b) the kernel bf16 step against the plain bf16 step, the float32
    # step the guard
    cfg32 = preset("aanet")
    compares = seeded_compares(dataclasses.replace(cfg32, dtype="bfloat16"), specs16, dev,
                               COMPARE_SEEDS, per_parameter=False, label="bf16_train_step_compare",
                               nudge=one_ulp_nudge, guard=(cfg32, specs))
    failures = [f"seed {c['seed']}: {f}" for c in compares for f in c["failures"]]
    check(not failures, "bf16 kernel vs plain train step: " + "; ".join(failures))
    t_b = time.perf_counter()

    # (c) the full-width bf16 steps, then each bf16 backward kernel at their shapes
    out = {}
    for name, expected in BF16_TRAIN_PRESETS.items():
        cfg = dataclasses.replace(preset(name), dtype="bfloat16")
        model = seeded_model(cfg, dev)
        step = make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp)
        batch = train_batch(gen, dev, TRAIN_BATCH, TRAIN_HW)
        reset_launches(specs + bwd_specs + all16)
        metrics = step(batch)
        torch.cuda.synchronize()
        counts = launches(all16)
        f32_counts = {k: v for k, v in launches(specs + bwd_specs).items() if v}
        print(f"{name} bf16 train-step launches: {counts}", flush=True)
        check(counts == expected and not f32_counts,
              f"{name} bf16: train-step launches {counts} (float32 kernels {f32_counts}), "
              f"expected {expected}")
        timed = time_steps(step, batch, metrics, dev, top=15, timed=5, profiled=1)
        f32 = f32_steps[name]
        record = dict(preset=name, batch=TRAIN_BATCH, height=TRAIN_HW[0], width=TRAIN_HW[1],
                      dtype="bfloat16", remat=cfg.remat, launches=counts, card=smi, **timed,
                      float32={k: f32[k] for k in ("batch", "step_ms", "samples_per_s",
                                                   "peak_memory_bytes", "device_idle_share",
                                                   "device_ms")})
        print(f"{name} bf16 step {record['step_ms']:.4f} ms (float32 {f32['step_ms']:.4f} ms), "
              f"peak {record['peak_memory_bytes']} B (float32 {f32['peak_memory_bytes']} B), idle "
              f"{record['device_idle_share']:.4f} (float32 {f32['device_idle_share']:.4f}) on {smi}",
              flush=True)
        print(json.dumps({"bf16_train_step": record}), flush=True)
        del model, step, batch
        torch.cuda.empty_cache()
        rows = {sp["name"]: [measure(sp, rebatch(sig, TRAIN_BATCH), k, gen, dev, timer, iters=10)
                             for sig, k in shapes[name][sp["forward"]].items()] for sp in bwd16}
        # each bf16 forward at the step's shapes: its first pass and remat's recompute
        for sp in specs16:
            calls = shapes[name][sp["name"]] + recomputed[name][sp["name"]]
            rows[sp["name"]] = [measure(sp, rebatch(sig, TRAIN_BATCH), k, gen, dev, timer, iters=10)
                                for sig, k in calls.items()]
        out[f"{name} bf16"] = dict(rows=rows, launches=counts, step=record)
    print(f"phase 15: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, (c) "
          f"{time.perf_counter() - t_b:.1f} s", flush=True)
    return out


def bf16_forward_edge_cases(specs, specs16, shapes, gen, dev, timer):
    """Phase 15(a) for the bf16 soft-argmin and warp forwards: at every
    shape of the steps ``shapes`` recorded, at the full step's batch, two
    launches give the same bits (timed beside the bound); the soft-argmin
    against its twin at ``SA_EDGE_SHAPES`` (both signs; planes not a
    multiple of 8 take a value a load) with its float32 form's tolerance,
    and zeros at D = 0; the warp at ``WARP_EDGE_SHAPES``."""
    sa32 = next(s for s in specs if s["name"] == "soft_argmin")
    sa_fwd = dict(next(s for s in specs16 if s["name"] == "soft_argmin_bf16"), tol=sa32["tol"],
                  tol_text=sa32["tol_text"])
    warp16 = next(s for s in specs16 if s["name"] == "disp_warp_bf16")
    edges = []
    for spec in (sa_fwd, warp16):
        sigs = {rebatch(sig, TRAIN_BATCH) for first in shapes.values() for sig in first[spec["name"]]}
        for sig in sorted(sigs, key=str):
            edges.append(dict(same_bits_timed(spec, sig, gen, dev, timer),
                              case="step shape: two launches, bitwise; timed"))
    for sig in SA_EDGE_SHAPES:
        edges.append(dict(measure(sa_fwd, sig, 1, gen, dev, timer, timed=False), kernel=sa_fwd["name"],
                          case="beyond the path"))
    op = getattr(sa_fwd["module"], sa_fwd["attr"])
    for match in (True, False):
        disp = op(torch.randn((2, 0, 6, 10), generator=gen, device=dev).to(torch.bfloat16), match)
        torch.cuda.synchronize()
        check(disp.shape == (2, 6, 10) and torch.equal(disp, torch.zeros_like(disp)),
              f"soft_argmin_bf16 at D = 0: {disp}, expected zeros")
        edges.append(dict(kernel=sa_fwd["name"], case="D = 0: zeros", shape=str(((2, 0, 6, 10), match)),
                          max_err=float(disp.abs().max()), tolerance=0.0))
    for shape in WARP_EDGE_SHAPES:
        edges.append(dict(measure(warp16, (shape,), 1, gen, dev, timer, timed=False),
                          kernel=warp16["name"], case="width not a multiple of 8"))
    return edges


def bf16_volume_specs(specs, bwd_specs):
    """The bf16 forms of the 4-D volume kernels (phase 16), forward and
    backward, derived from their float32 specs as ``bf16_kernel_specs``
    derives the others': the same wrapper, twin and signature; launches in
    ``launches_bf16``; bf16 features and volume gradients; bytes at 2 a
    value, half the float32 forms' bound (their FLOPs are float32
    subtractions and sums); the float32 kernel timed at the same shapes.
    Tolerance: bit for bit (the twin computes in float32 and rounds where
    the kernel does)."""
    by_name = {s["name"]: s for s in specs + bwd_specs}
    bf = torch.bfloat16

    def inputs_of(name):
        def make(sig, gen, dev):
            args, kwargs = by_name[name]["inputs"](sig, gen, dev)
            return tuple(a.to(bf) if isinstance(a, torch.Tensor) else a for a in args), kwargs
        return make

    def half_bytes(name):
        def cost(sig):
            nbytes, flops = by_name[name]["cost"](sig)
            return nbytes // 2, flops
        return cost

    def to_f32(args):
        return tuple(a.float() if isinstance(a, torch.Tensor) else a for a in args)

    out = []
    for name in ("difference_volume", "concat_volume", "difference_volume_backward",
                 "concat_volume_backward"):
        spec = by_name[name]
        extra = dict(forward=f"{spec['forward']}_bf16") if "forward" in spec else {}
        out.append(dict(spec, name=f"{name}_bf16", counter="launches_bf16", inputs=inputs_of(name),
                        cost=half_bytes(name), f32_args=to_f32, **extra))
    return out


def bf16_volume_phases(specs, bwd_specs, specs16, vol16, gen, dev, timer, smi, left, right,
                       f32_forwards, f32_steps):
    """Phase 16: the 4-D volumes in bf16, and PSMNet (either aggregation),
    StereoNet and GC-Net serving and training in bfloat16. (a) Each bf16
    volume kernel against its twin bit for bit at ``VOL_PATHS`` (two
    launches bitwise, timed beside its bound and its float32 form) and at
    ``VOL_EDGE_SHAPES`` (the backward also at D = 0). (b) Each network's
    forward at 384x1248, batch 1, seeded and calibrated (phase 5b's
    weights) in ``dtype="bfloat16"``: through the plain bf16 twins with
    every kernel call's shape, each bf16 kernel against its twin at those
    shapes, then through the kernels with its launches (bf16 forms only),
    every kernel call of the path against its twin on the path's own
    inputs, the map against the plain bf16 one and float32's (phase 14's
    guard), its latency beside phase 5b's float32 forward (``f32_forwards``)
    and its device breakdown. (c) A bf16 kernel step against the plain bf16
    step at batch 2 on phase 7's first seeded batch, under phase 15's guard
    (``seeded_compares`` with ``one_ulp_nudge`` and the float32 step as the
    guard). (d) The full-width bf16 step at batch 16, halved until it fits,
    with its launches, step time (median of 5), samples/s, peak memory and
    device breakdown beside phase 10's float32 step (``f32_steps``), and
    each bf16 volume and soft-argmin kernel against its twin at its
    shapes, timed. Returns, per path, each bf16 kernel's rows and the
    path's launches."""
    t0 = time.perf_counter()
    by_name = {s["name"]: s for s in vol16}
    # soft-argmin's bf16 form over these networks' 96-192 candidates, with
    # its float32 form's tolerance: the same float32 sums, relative to
    # disparities beyond 50 px (phase 14's 1e-4 px is for D <= 64)
    sa32 = next(s for s in specs if s["name"] == "soft_argmin")
    sa16 = dict(next(s for s in specs16 if s["name"] == "soft_argmin_bf16"), tol=sa32["tol"],
                tol_text=sa32["tol_text"])
    fwd16 = [sa16] + [s for s in vol16 if "backward" not in s["name"]]
    bwd16 = [s for s in vol16 if "backward" in s["name"]]
    sa_bwd16 = next(s for s in bf16_backward_specs(bwd_specs) if s["name"] == "soft_argmin_backward_bf16")
    all16 = fwd16 + bwd16 + [sa_bwd16]
    # (a) the kernels at the paths' shapes and beyond them
    edges = []
    for sig, concat in VOL_PATHS.values():
        kind = "concat_volume_bf16" if concat else "difference_volume_bf16"
        for name in (kind, kind.replace("_bf16", "_backward_bf16")):
            row = measure(by_name[name], sig, 1, gen, dev, timer, iters=10)
            same = same_bits(by_name[name], sig, gen, dev)
            check(same, f"{name} {sig}: two launches on the same inputs differ")
            edges.append(dict(row, kernel=name, case="path shape: two launches bitwise", identical=same))
            torch.cuda.empty_cache()
    for sig in VOL_EDGE_SHAPES + [(VOL_EDGE_SHAPES[0][0], 0)]:
        for kind in ("difference_volume", "concat_volume"):
            names = (kind, f"{kind}_backward") if sig[1] else (f"{kind}_backward",)
            for name in names:
                edges.append(dict(measure(by_name[f"{name}_bf16"], sig, 1, gen, dev, timer, timed=False),
                                  kernel=f"{name}_bf16", case="beyond the path" if sig[1] else "D = 0"))
    print(json.dumps({"bf16_volume_edge_cases": edges}), flush=True)
    t_a = time.perf_counter()

    forwards, steps = {}, {}
    for name in ("psmnet", "psmnet_basic", "stereonet", "gcnet"):
        cfg = baseline_config(name)
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        fwd_expected = {f"{k}_bf16": v for k, v in BASELINES[name]["launches"].items()}
        expected = {s["name"]: fwd_expected.get(s["name"], 0) for s in fwd16}
        # (b) the forward at 384x1248
        with torch.no_grad():
            model32 = seeded_model(cfg, dev).eval()
            calibrate_bn_(model32, specs, left, right)
            model = cfg16.build()
            model.load_state_dict(model32.state_dict())
            model = model.to(dev).eval()
            with plain_ops(specs):
                plain32 = model32(left, right)
            del model32
            calls = {s["name"]: collections.Counter() for s in fwd16}
            with plain_ops(fwd16, calls):
                plain = model(left, right)
            with plain_ops(fwd16):
                plain_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
            made = {n: sum(c.values()) for n, c in calls.items()}
            check(made == expected, f"{name} bf16: plain forward made {made}, expected {expected}")
            rows = {s["name"]: [measure(s, sig, k, gen, dev, timer) for sig, k in calls[s["name"]].items()]
                    for s in fwd16}
            reset_launches(specs + all16)
            pyramid = model(left, right)
            torch.cuda.synchronize()
            counts = launches(fwd16)
            f32_counts = {k: v for k, v in launches(specs).items() if v}
            print(f"{name} bf16 launches: {counts}", flush=True)
            check(counts == expected and not f32_counts,
                  f"{name} bf16: launches {counts} (float32 kernels {f32_counts}), expected {expected}")
            calls_checked = []
            with checked_ops(fwd16, calls_checked):
                model(left, right)
            check(len(calls_checked) == sum(expected.values())
                  and all(err <= tol for _, err, tol in calls_checked),
                  f"{name} bf16: a path call off its twin: {calls_checked}")
            shapes = BASELINES[name]["shapes"]
            check([tuple(p.shape) for p in pyramid] == shapes
                  and all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in pyramid),
                  f"{name} bf16: pyramid {[(tuple(p.shape), p.dtype) for p in pyramid]}")
            kernel_plain = pyramid_errors(pyramid, plain)
            plain_f32 = pyramid_errors(plain, plain32)
            # phase 14's guard: the kernel path no farther (mean) from the
            # plain bf16 path than the plain bf16 path is from float32
            check(all(kp[1] <= pf[1] for kp, pf in zip(kernel_plain, plain_f32)),
                  f"{name} bf16: (max, mean) px, kernel vs plain bf16 {kernel_plain}, plain bf16 vs "
                  f"float32 {plain_f32}")
            record = forward_record(f"{name} bf16", model, left, right, plain_ms, kernel_plain, timer,
                                    smi, dtype="bfloat16")
        f32 = f32_forwards[name]["record"]
        record.update(launches=counts, path_calls_checked=len(calls_checked),
                      plain_bf16_vs_float32_px=plain_f32,
                      float32=dict(latency_ms=f32["latency_ms"], device_ms=f32["device_ms"],
                                   peak_memory_bytes=f32["peak_memory_bytes"],
                                   device_idle_share=f32["device_idle_share"]))
        print(f"{name} bf16 forward {record['latency_ms']:.4f} ms (float32 {f32['latency_ms']:.4f} ms), "
              f"device {record['device_ms']:.4f} ms (float32 {f32['device_ms']:.4f}), peak "
              f"{record['peak_memory_bytes']} B (float32 {f32['peak_memory_bytes']} B) on {smi}",
              flush=True)
        print(json.dumps({"bf16_3d_forward": record}), flush=True)
        forwards[f"{name} bf16"] = dict(rows=rows, launches=counts, record=record)
        del model, plain, plain32, pyramid
        torch.cuda.empty_cache()

        # (c) the kernel step against the plain step at batch 2
        torch.set_grad_enabled(True)
        first = {s["name"]: collections.Counter() for s in fwd16}
        again = {s["name"]: collections.Counter() for s in fwd16}
        (compare,) = seeded_compares(cfg16, fwd16, dev, COMPARE_SEEDS[:1], calls=first, recomputed=again,
                                     per_parameter=False, label="bf16_3d_train_step_compare",
                                     nudge=one_ulp_nudge, guard=(cfg, specs))
        check(not compare["failures"], f"{name} bf16 kernel vs plain train step: {compare['failures']}")
        # (d) the full-width step
        train_expected = {f"{k}_bf16": v for k, v in BASELINES[name]["train_launches"].items()}
        expected = {s["name"]: train_expected.get(s["name"], 0) for s in all16}
        model, step, batch, metrics, counts, refused = fit_batch(cfg16, gen, dev, specs + bwd_specs + all16)
        n = batch["left"].shape[0]
        counts = launches(all16)
        f32_counts = {k: v for k, v in launches(specs + bwd_specs).items() if v}
        print(f"{name} bf16 train-step launches at batch {n}: {counts}", flush=True)
        check(counts == expected and not f32_counts,
              f"{name} bf16: train-step launches {counts} (float32 kernels {f32_counts}), expected {expected}")
        timed = time_steps(step, batch, metrics, dev, top=12, timed=5, profiled=1)
        del model, step, batch
        torch.cuda.empty_cache()
        f32 = f32_steps[name]["step"]
        record = dict(network=name, batch=n, batches_out_of_memory=refused, height=TRAIN_HW[0],
                      width=TRAIN_HW[1], max_disp=cfg.max_disp, dtype="bfloat16", remat=cfg.remat,
                      launches=counts, compare=compare, card=smi, **timed,
                      float32={k: f32[k] for k in ("batch", "step_ms", "samples_per_s",
                                                   "peak_memory_bytes", "device_idle_share",
                                                   "device_ms", "top_kernels")})
        print(f"{name} bf16 step {record['step_ms']:.4f} ms at batch {n} (float32 {f32['step_ms']:.4f} ms "
              f"at {f32['batch']}), peak {record['peak_memory_bytes']} B (float32 "
              f"{f32['peak_memory_bytes']} B) on {smi}", flush=True)
        print(json.dumps({"bf16_3d_train_step": record}), flush=True)
        rows = {sp["name"]: [measure(sp, rebatch(sig, n), k + again[sp["name"]][sig], gen, dev, timer,
                                     iters=10) for sig, k in first[sp["name"]].items()] for sp in fwd16}
        rows.update({sp["name"]: [measure(sp, rebatch(sig, n), k, gen, dev, timer, iters=10)
                                  for sig, k in first[sp["forward"]].items()] for sp in bwd16 + [sa_bwd16]})
        for sig in first[sa16["name"]]:  # the bf16 soft-argmin forward: two launches bitwise
            check(same_bits(sa16, rebatch(sig, n), gen, dev),
                  f"soft_argmin_bf16 {rebatch(sig, n)}: two launches on the same inputs differ")
        steps[f"{name} bf16 step"] = dict(rows=rows, launches=counts, step=record)
        torch.set_grad_enabled(False)
        torch.cuda.empty_cache()
    t_d = time.perf_counter()
    entry = bf16_baseline_entry_points(smi)
    print(f"phase 16: (a) {t_a - t0:.1f} s, (b-d) {t_d - t_a:.1f} s, (e) "
          f"{time.perf_counter() - t_d:.1f} s", flush=True)
    return forwards, steps, dict(edge_cases=edges, entry_points=entry)


def bf16_baseline_entry_points(smi):
    """Phase 16(e): the entry points with a baseline's model flags and
    ``--dtype bfloat16``, in this process: ``predict`` with PSMNet's on two
    375x1242 pairs (pad to 384x1248, crop back); ``train`` with StereoNet's
    for one epoch on ``write_synthetic``'s 16 pairs, then ``evaluate`` and
    ``inference --count_time`` of its float32 checkpoint in bf16. Returns
    the record."""
    from aanet_torch import cli

    def flags(name):
        return [f"--{k}={v}" for k, v in BASELINES[name]["flags"].items()]

    bf16 = ["--dtype", "bfloat16", "--device", DEVICE]
    record = dict(card=smi)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = os.path.join(tmp, "pairs")
        write_pngs(pairs, 2, PREDICT_HW, SEED)
        cli.main(["predict", *flags("psmnet"), *bf16, "--data_dir", pairs, "--save_type", "npy"])
        preds = [np.load(os.path.join(pairs, "pred", f"{i:06d}.npy")) for i in range(2)]
        check(all(p.shape == PREDICT_HW and np.isfinite(p).all() for p in preds),
              f"predict --dtype bfloat16 with PSMNet's flags: {[p.shape for p in preds]}")
        data, lists = write_synthetic(tmp)
        stereonet = [*flags("stereonet"), *bf16, "--data_dir", data, "--filename_root", lists,
                     "--num_workers", "4"]
        ckpt = os.path.join(tmp, "run")
        with contextlib.redirect_stdout(io.StringIO()), torch.enable_grad():
            cli.main(["train", *stereonet, "--checkpoint_dir", ckpt, "--img_height", "96",
                      "--img_width", "192", "--batch_size", "4", "--max_epoch", "1",
                      "--milestones", "10", "--print_freq", "1", "--no_validate"])
        losses = [json.loads(line)["total_loss"] for line in open(os.path.join(ckpt, "metrics.jsonl"))]
        weights = os.path.join(ckpt, "aanet_latest.pt")
        saved = torch.load(weights, map_location="cpu", weights_only=True)
        float32_state = all(t.dtype in (torch.float32, torch.int64) for t in saved["model"].values())
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["evaluate", *stereonet, "--pretrained", weights, "--checkpoint_dir",
                      os.path.join(tmp, "eval"), "--val_img_height", "96", "--val_img_width", "192",
                      "--val_batch_size", "4"])
            epe = json.loads(out.getvalue().strip().splitlines()[-1])["epe"]
            cli.main(["inference", *stereonet, "--pretrained", weights, "--img_height", "96",
                      "--img_width", "192", "--batch_size", "1", "--count_time",
                      "--output_dir", os.path.join(tmp, "inference")])
        seconds = json.loads(out.getvalue().strip().splitlines()[-1])["mean_inference_seconds"]
    record.update(psmnet_predict_shapes=[list(p.shape) for p in preds], stereonet_losses=losses,
                  float32_checkpoint=float32_state, stereonet_epe=epe,
                  stereonet_mean_inference_seconds=seconds)
    print(json.dumps({"bf16_baseline_entry_points": record}), flush=True)
    check(len(losses) == 4 and all(np.isfinite(losses)) and float32_state and np.isfinite(epe)
          and seconds > 0, f"the entry points with StereoNet's flags in bf16: {record}")
    return record


def anchor_bf16_finetune(smi):
    """Phase 15(d): ``python -m aanet_torch.cli train --dtype bfloat16``
    from the trained anchor on phase 12's 16 pairs for one epoch, as a user
    runs it, beside the same epoch in float32 (in this process); then
    ``evaluate`` of the bf16 run's checkpoint in float32 (EPE below
    ``ANCHOR_EPE``) and with ``--dtype bfloat16``. Returns the record."""
    from aanet_torch import cli

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data, lists = write_synthetic(tmp)
        model = ["--preset", "aanet", "--max_disp", str(ANCHOR_MAX_DISP), "--data_dir", data,
                 "--filename_root", lists, "--device", DEVICE]
        train = [*model, "--pretrained", os.path.join(root, ANCHOR), "--strict", "--img_height", "96",
                 "--img_width", "192", "--batch_size", str(ANCHOR_FINETUNE_BATCH), "--max_epoch", "1",
                 "--learning_rate", str(ANCHOR_FINETUNE_LR), "--milestones", "10", "--print_freq", "1",
                 "--num_workers", "4", "--no_validate"]
        losses, seconds = {}, {}
        for dtype in ("bfloat16", "float32"):
            ckpt = os.path.join(tmp, dtype)
            args = ["train", *train, "--dtype", dtype, "--checkpoint_dir", ckpt]
            t0 = time.perf_counter()
            if dtype == "bfloat16":
                proc = subprocess.run([sys.executable, "-m", "aanet_torch.cli", *args], cwd=root,
                                      capture_output=True, text=True, timeout=600)
                check(proc.returncode == 0,
                      f"cli train --dtype bfloat16 exited {proc.returncode}:\n{proc.stderr[-4000:]}")
            else:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(args)
            seconds[dtype] = time.perf_counter() - t0
            records = [json.loads(line) for line in open(os.path.join(ckpt, "metrics.jsonl"))]
            losses[dtype] = [r["total_loss"] for r in records if r["kind"] == "train"]
        saved = torch.load(os.path.join(tmp, "bfloat16", "aanet_latest.pt"), map_location="cpu",
                           weights_only=True)
        float32_state = all(t.dtype in (torch.float32, torch.int64) for t in saved["model"].values())
        epe = {}
        for dtype in ("float32", "bfloat16"):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                cli.main(["evaluate", *model, "--pretrained",
                          os.path.join(tmp, "bfloat16", "aanet_latest.pt"), "--dtype", dtype,
                          "--val_img_height", "96", "--val_img_width", "192",
                          "--val_batch_size", "4", "--num_workers", "4",
                          "--checkpoint_dir", os.path.join(tmp, f"eval_{dtype}")])
            epe[dtype] = json.loads(out.getvalue().strip().splitlines()[-1])["epe"]
    record = dict(learning_rate=ANCHOR_FINETUNE_LR, batch=ANCHOR_FINETUNE_BATCH, losses=losses,
                  seconds=seconds, float32_checkpoint=float32_state, epe_after=epe, card=smi)
    print(f"anchor bf16 fine-tune losses {losses['bfloat16']} (float32 {losses['float32']}); "
          f"EPE after, evaluated in float32 {epe['float32']}, in bf16 {epe['bfloat16']}", flush=True)
    print(json.dumps({"anchor_bf16_finetune": record}), flush=True)
    steps = 16 // ANCHOR_FINETUNE_BATCH
    check(len(losses["bfloat16"]) == len(losses["float32"]) == steps
          and all(np.isfinite(losses["bfloat16"])), f"anchor bf16 fine-tune losses {losses}")
    check(float32_state, "the bf16 run's checkpoint holds tensors that are not float32")
    check(epe["float32"] < ANCHOR_EPE and np.isfinite(epe["bfloat16"]),
          f"anchor after one bf16 epoch: EPE {epe}")
    return record


def kernels_record(all_specs, report, counts_main, train, baselines, baseline_train):
    """Every kernel with its totals over the first path that runs it: one
    train step of aanet (the training slice's main path); for the 4-D
    volumes' forward, one forward of the first baseline that runs it
    (PSMNet, StereoNet); for their backward, one train step of the same
    baseline. The other paths that run a kernel ride along: one aanet
    inference forward, each baseline and adaptive-preset forward
    (``baselines`` holds both, phase 13's presets too) and each baseline
    train step, ``AA_FULL_STEP``'s and ``PLUS_FULL_STEP``'s
    (``baseline_train``). Without ``train`` (the bf16 forms, which serve
    only) the first path is the first of ``baselines``."""
    inference = {sp["name"]: r for sp, r in report}
    kernels = []
    for spec in all_specs:
        name, lib = spec["name"], bool(spec["library"])
        paths = [("aanet train step", train)] if train else []
        paths += [(f"{cfg} forward", b) for cfg, b in baselines.items()]
        paths += [(f"{cfg} train step", b) for cfg, b in baseline_train.items()]
        runs = [(path, run["rows"][name], run["launches"][name]) for path, run in paths
                if run["launches"].get(name) and name in run["rows"]]
        check(runs, f"{name}: no path launched it")
        (path, rows, count), others = runs[0], runs[1:]
        entry = dict(name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
                     launches=count, tolerance=spec["tol_text"], path=path, **totals(rows, lib))
        if inference.get(name):
            entry["inference"] = dict(launches=counts_main[name], **totals(inference[name], lib),
                                      shapes=inference[name])
        if others:
            entry["other_paths"] = {p: dict(launches=k, **totals(r, lib), shapes=r)
                                    for p, r, k in others}
        entry["shapes"] = rows
        edges = [r for r in train["edge_cases"] if r["kernel"] == name] if train else []
        if edges:
            entry["edge_cases"] = edges
        kernels.append(entry)
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # deterministic cuBLAS for ``deterministic``, set before any cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from aanet_torch import _build, cli
    from aanet_torch.config import preset

    # 1. the card, and float32 semantics
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # 2. build
    start = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - start:.1f} s", flush=True)

    def elapsed(done):
        print(f"{done} at {time.perf_counter() - start:.1f} s", flush=True)

    specs, bwd_specs = kernel_specs()
    timer = Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.set_grad_enabled(False)

    # 3a. the model, and its forward through the plain versions
    cfg = preset("aanet")
    model = cfg.build()
    seed_weights_(model, SEED)
    model = model.to(dev).eval()
    left, right = stereo_pair(gen, dev, HEIGHT, WIDTH)
    calibrate_bn_(model, specs, left, right)
    calls = {s["name"]: collections.Counter() for s in specs}
    with plain_ops(specs, calls):
        plain_pyramid = model(left, right)
    with plain_ops(specs):
        plain_fwd_ms = timer.ms(lambda: model(left, right), warmup=1, iters=5)
    check({n: sum(c.values()) for n, c in calls.items()} == EXPECTED_LAUNCHES,
          f"plain forward made {calls}, expected {EXPECTED_LAUNCHES} kernel calls")

    # 3b. each kernel against its plain version at each shape of the path
    report = [(spec, [measure(spec, sig, n, gen, dev, timer) for sig, n in calls[spec["name"]].items()])
              for spec in specs]

    # 4. the main path through the kernels
    reset_launches(specs)
    pyramid = model(left, right)
    torch.cuda.synchronize()
    counts_main = launches(specs)
    print(f"main-path launches: {counts_main}", flush=True)
    check(counts_main == EXPECTED_LAUNCHES,
          f"launches {counts_main}, expected {EXPECTED_LAUNCHES}")
    shapes = [(1, HEIGHT // k, WIDTH // k) for k in (12, 6, 3, 2, 1)]
    errs = compare_pyramids(pyramid, plain_pyramid, shapes, "aanet")
    forward = forward_record("aanet", model, left, right, plain_fwd_ms, errs, timer, smi)
    print(json.dumps({"forward": forward}), flush=True)

    # 5. the predict entry point on the card
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(model.state_dict(), weights)
        data = os.path.join(tmp, "pairs")
        write_pngs(data, 2, PREDICT_HW, SEED)
        out = os.path.join(tmp, "pred")
        reset_launches(specs)
        t0 = time.perf_counter()
        cli.main(["predict", "--preset", "aanet", "--data_dir", data, "--output_dir", out,
                  "--pretrained", weights, "--device", DEVICE, "--save_type", "npy"])
        predict_s = time.perf_counter() - t0
        counts = launches(specs)
        check(counts == {k: 2 * v for k, v in EXPECTED_LAUNCHES.items()},
              f"predict launches {counts}")
        for i in range(2):
            pred = np.load(os.path.join(out, f"{i:06d}.npy"))
            check(pred.shape == PREDICT_HW and np.isfinite(pred).all(),
                  f"prediction {i}: shape {pred.shape}")
    print(f"predict: 2 pairs of {PREDICT_HW[0]}x{PREDICT_HW[1]} in {predict_s:.2f} s, "
          f"launches {counts}", flush=True)

    # 5b. the 3-D-aggregation baselines and stereonet-aa
    baselines = baseline_phases(specs, gen, dev, timer, smi, left, right)
    elapsed("phases 1-5b done")
    del model
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        data, lists = write_sceneflow(tmp, CLI_PAIRS, CLI_HW, SEED)
        train = train_phases(specs, bwd_specs, gen, dev, timer, smi, data, lists)
        torch.cuda.empty_cache()
        anchor_phase(specs, gen, dev, left, right)
        elapsed("phases 6-9b done")
        baseline_train = baseline_train_phases(specs, bwd_specs, gen, dev, timer, smi, data, lists)
        torch.cuda.empty_cache()
        elapsed("phase 10 done")

        # 10b. the 4-D volume kernels beyond the paths
        by_name = {s["name"]: s for s in specs + bwd_specs}
        recorded = {name: [r["shape"] for run in (*baselines.values(), *baseline_train.values())
                           if run["launches"].get(name) for r in run["rows"][name]]
                    for name in by_name if "volume" in name}
        vol_edges = volume_edge_cases(by_name, recorded, gen, dev, timer)
        print(json.dumps({"volume_edge_cases": vol_edges}), flush=True)
        train["edge_cases"] += vol_edges

        # 11. psmnet-aa and gcnet-aa
        aa, aa_train = adaptive_preset_phases(AA_PRESETS, AA_FULL_STEP, specs, bwd_specs, gen, dev,
                                              timer, smi, left, right)
        torch.cuda.empty_cache()
        elapsed("phases 10b-11 done")

        # 12. the trained anchor through the evaluate and inference entry points
        anchor = anchor_entry_points(specs, smi)
        elapsed("phase 12 done")

        # 13. aanet+ and ganet-aa, then aanet+'s train entry point and its resume
        plus, plus_train = adaptive_preset_phases(PLUS_PRESETS, PLUS_FULL_STEP, specs, bwd_specs,
                                                  gen, dev, timer, smi, left, right)
        torch.cuda.empty_cache()
        plus_cli = cli_train_and_resume(data, lists, PLUS_FULL_STEP,
                                        plus_train[PLUS_FULL_STEP]["batch"])
        print(json.dumps({"plus_cli_train": plus_cli}), flush=True)
        elapsed("phase 13 done")

    # 14. bf16 serving: aanet and aanet+ in bfloat16, the anchor's evaluate
    # and inference in bf16, and bf16 training refused
    t14 = time.perf_counter()
    specs16 = bf16_kernel_specs(specs)
    served = bf16_serving_phases(specs, specs16, gen, dev, timer, smi, left, right,
                                 {"aanet": forward, "aanet+": plus["aanet+"]["record"]})
    torch.cuda.empty_cache()
    anchor_bf16_pyramid(specs, specs16, dev, smi)
    torch.cuda.empty_cache()
    anchor_bf16_entry_points(anchor, smi)
    print(f"phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)
    elapsed("phase 14 done")

    # 15. bf16 training: the bf16 backward kernels, the kernel step against
    # the plain one, the full-width steps, the train entry point from the anchor
    t15 = time.perf_counter()
    bwd16 = bf16_backward_specs(bwd_specs)
    trained16 = bf16_training_phases(
        specs, bwd_specs, specs16, bwd16, gen, dev, timer, smi,
        {"aanet": train["step"], PLUS_FULL_STEP: plus_train[PLUS_FULL_STEP]["step"]})
    torch.cuda.empty_cache()
    anchor_bf16_finetune(smi)
    # the deformable conv's kernels give the same bits every launch, at
    # every path shape of phases 3-15
    by_name = {s["name"]: s for s in specs + bwd_specs + specs16 + bwd16}
    paths = {"aanet inference": {sp["name"]: rows for sp, rows in report},
             "aanet train step": train["rows"],
             **{f"{k} forward": v["rows"] for k, v in {**baselines, **aa, **plus, **served}.items()},
             **{f"{k} train step": v["rows"]
                for k, v in {**baseline_train, **aa_train, **plus_train, **trained16}.items()}}
    print(json.dumps({"deform_same_bits": deform_same_bits(by_name, paths, gen, dev)}), flush=True)
    print(json.dumps({"fixed_point_precision": fixed_point_precision(
        by_name["deform_conv_backward_data"], train["rows"]["deform_conv_backward_data"], gen,
        dev)}), flush=True)
    print(f"phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)
    elapsed("phase 15 done")

    # 16. the 4-D volumes in bf16: PSMNet (both aggregations), StereoNet and
    # GC-Net serve and train in bfloat16
    t16 = time.perf_counter()
    vol16 = bf16_volume_specs(specs, bwd_specs)
    forwards16, steps16, _ = bf16_volume_phases(specs, bwd_specs, specs16, vol16, gen, dev, timer, smi,
                                                left, right, baselines, baseline_train)
    del left, right
    torch.cuda.empty_cache()
    print(f"phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)
    elapsed("phase 16 done")

    # 17. data-parallel training: two gloo ranks on the card against one process
    data_parallel_phase(specs + bwd_specs, dev, smi)
    elapsed("phase 17 done")

    # 18. the record
    kernels = kernels_record(specs + bwd_specs, report, counts_main, train,
                             {**baselines, **aa, **plus}, {**baseline_train, **aa_train, **plus_train})
    kernels += kernels_record(specs16 + bwd16, [], {}, None, served, trained16)
    kernels += kernels_record(vol16, [], {}, None, forwards16, steps16)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
