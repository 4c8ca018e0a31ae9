#!/usr/bin/env python3
"""Time the ``aanet`` preset's full-width float32 train step (chip_smoke.py
phase 8: batch 16, 288x576, remat on, seeded weights) of this tree and of
older checkouts, in turns on the same card.

    python3 tools/torch_step_turns.py --package _archive/parent [--rounds 2]

Each turn runs in a process of its own, so that two versions of
``aanet_torch`` never share one: with one ``--package`` the order is
package, this tree, this tree, package (``--rounds`` repeats it). A turn
builds its package's kernels (a package whose sources equal this tree's
takes this tree's libraries), runs two warm-up steps, then times
``--steps`` steps with CUDA events and prints one JSON line with the
median and every step's milliseconds. The card's name and power limit
are printed first; unpack an older commit with ``git archive``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r'''
import json, statistics, sys, os
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke
from aanet_torch import _build
from aanet_torch.config import preset
from aanet_torch.train.optimizer import make_optimizer
from aanet_torch.train.trainer import make_train_step
_build.build()
dev = torch.device("cuda")
cfg = preset("aanet")
model = chip_smoke.seeded_model(cfg, dev)
gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
batch = chip_smoke.train_batch(gen, dev, chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_HW)
step = make_train_step(model, make_optimizer(model, 1e-3), cfg.max_disp)
for _ in range(2):
    step(batch)
torch.cuda.synchronize()
times = []
for _ in range(int(sys.argv[1])):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss = step(batch)["total_loss"]
    end.record()
    times.append((start, end))
torch.cuda.synchronize()
ms = [s.elapsed_time(e) for s, e in times]
print(json.dumps({"package": os.getcwd(), "step_ms": statistics.median(ms), "step_ms_all": ms,
                  "loss": float(loss)}), flush=True)
'''


def share_build(package: str):
    """Copy this tree's kernel libraries into ``package`` where its sources
    (and so its build key) are the same."""
    sys.path.insert(0, HERE)
    from aanet_torch import _build

    ours = _build.build_dir()
    theirs = os.path.join(package, "aanet_torch", "_build_out", ours.name)
    same = all(
        open(os.path.join(package, "aanet_torch", "csrc", f.name), "rb").read() == f.read_bytes()
        for f in _build.CSRC.iterdir() if f.suffix in (".cu", ".cuh"))
    if same and ours.exists() and not os.path.exists(theirs):
        shutil.copytree(ours, theirs)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--package", action="append", default=[],
                        help="root of an older checkout to time in turns with this tree")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, HERE)
    from aanet_torch import _build

    _build.build()
    for package in args.package:
        share_build(package)
    order = []
    for _ in range(args.rounds):
        for package in args.package:
            order += [package, HERE, HERE, package]
        if not args.package:
            order.append(HERE)
    for root in order:
        proc = subprocess.run([sys.executable, "-c", TURN, str(args.steps)], cwd=root,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
