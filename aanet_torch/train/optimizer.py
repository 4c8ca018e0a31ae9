"""Adam with the offset_conv learning-rate group and the piecewise-constant
schedule (aanet_tpu/train/optimizer.py, trainer.py:189-193).

``torch.optim.Adam(weight_decay=...)`` adds the decay to the gradient
before the moments, as ``optax.add_decayed_weights`` before
``optax.scale_by_adam`` does. Every parameter whose name contains
``offset_conv`` sits in a second group at ``offset_lr_mult`` times the
learning rate (the reference's filter_specific_params,
utils/utils.py:155-169). The schedule scales the learning rate by gamma at
each milestone, counted in optimizer steps.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def make_optimizer(model: torch.nn.Module, learning_rate: float, weight_decay: float = 1e-4,
                   offset_lr_mult: float = 0.1, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8) -> torch.optim.Adam:
    """Adam over two groups: the offset heads at ``offset_lr_mult`` x LR and
    every other parameter at the LR. Each group keeps its multiplier under
    ``lr_mult`` for ``set_learning_rate``."""
    named = list(model.named_parameters())
    groups = [
        dict(params=[p for n, p in named if "offset_conv" not in n], lr_mult=1.0),
        dict(params=[p for n, p in named if "offset_conv" in n], lr_mult=offset_lr_mult),
    ]
    groups = [g for g in groups if g["params"]]
    for g in groups:
        g["lr"] = learning_rate * g["lr_mult"]
    return torch.optim.Adam(groups, lr=learning_rate, betas=(b1, b2), eps=eps,
                            weight_decay=weight_decay)


def piecewise_constant_schedule(base_lr: float, boundaries: Dict[int, float]) -> Callable[[int], float]:
    """lr(step) = base_lr times every scale whose boundary is <= step (the
    semantics of optax.piecewise_constant_schedule, where ``step`` is the
    number of updates applied before this one)."""
    def schedule(step: int) -> float:
        lr = base_lr
        for boundary, scale in sorted(boundaries.items()):
            if step >= boundary:
                lr *= scale
        return lr

    return schedule


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
