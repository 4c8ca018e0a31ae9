"""Process groups and the collectives of data-parallel training (the
counterpart of aanet_tpu/parallel/mesh.py and aanet_tpu/cli.py:39-90).

The JAX package trains under one global-view jit over a ``data`` mesh, in
which XLA sums the gradients and takes the BatchNorm statistics over the
global batch. The port runs one process per card, started by a launcher
(``torchrun --nproc_per_node N -m aanet_torch.cli train ...``), and makes
the same reductions itself:

* ``maybe_init_distributed`` starts the process group from the
  launcher's environment (NCCL for a CUDA device, gloo for the CPU);
* ``rank``, ``world_size`` and ``local_device`` say where a process runs;
* ``sum_over_ranks`` adds a tensor over the ranks in rank order, the same
  bits on every rank: the gradients, the loss's valid-pixel counts and
  the metrics go through it;
* ``gather_ranks`` stacks a tensor of every rank, differentiably: the
  cross-replica BatchNorm statistics (``models.layers.Norm``) go through
  it, and its backward sums each rank's share of the gradient in rank
  order, as SyncBatchNorm's backward does;
* ``gather_objects`` hands every rank the picklable values of all, and
  ``gather_to_first`` hands them to rank 0 alone.

Every collective is a no-op without a process group. With one, each is
called by every rank in the same order; a gloo group moves CUDA tensors
through the host.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def distributed() -> bool:
    """A process group is running (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if distributed() else 1


def local_rank() -> int:
    """This process's index on its host (the launcher's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def local_device(device="cuda") -> torch.device:
    """``device``, with a bare ``cuda`` mapped to ``cuda:LOCAL_RANK``: each
    process of a host drives its own card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def maybe_init_distributed(device="cuda") -> bool:
    """Start the process group that a launcher describes (``torchrun``:
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), NCCL for a CUDA ``device`` and gloo for the CPU;
    return whether a group runs. Without ``WORLD_SIZE`` in the environment
    nothing starts and this returns False; under ``--nproc_per_node 1`` a
    group of one starts (its first barrier brings the backend up)."""
    if distributed():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    dist.barrier()
    return True


def stop_distributed():
    """End the process group, where one runs."""
    if distributed():
        dist.destroy_process_group()


def local_batch_size(global_batch: int, world: Optional[int] = None) -> int:
    """The batch of one process: ``global_batch`` / the world size, which
    must divide it (aanet_tpu/data/pipeline.py:106)."""
    world = world_size() if world is None else world
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split over "
                         f"{world} processes")
    return global_batch // world


def pad_batch(batch: dict, batch_size: int) -> dict:
    """Pad dim 0 of every array to ``batch_size`` and add a ``sample_valid``
    flag array (aanet_tpu/parallel/mesh.py:84-100)."""
    first = next(v for v in batch.values() if hasattr(v, "shape"))
    b = first.shape[0]
    valid = np.zeros((batch_size,), np.float32)
    valid[:b] = 1.0
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and v.shape[0] < batch_size:
            v = np.pad(np.asarray(v), [(0, batch_size - v.shape[0])] + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    out["sample_valid"] = valid
    return out


def _gather(t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` in rank order."""
    via_host = t.device.type != "cpu" and dist.get_backend() == "gloo"
    work = t.detach().contiguous()
    if via_host:
        work = work.cpu()
    parts = [torch.empty_like(work) for _ in range(world_size())]
    dist.all_gather(parts, work)
    return torch.stack(parts).to(t.device)


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, rank 0's first: the same bits on every
    rank and in every run (the backend's own all-reduce may add in another
    order). ``t`` itself without a process group."""
    if not distributed():
        return t
    parts = _gather(t)
    total = parts[0].clone()
    for part in parts[1:]:
        total += part
    return total


class _GatherRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _gather(t)

    @staticmethod
    def backward(ctx, grad):
        # rank r's input is entry r of every rank's output: its gradient is
        # the sum over the ranks of their entry r
        return sum_over_ranks(grad.contiguous())[rank()]


def gather_ranks(t: torch.Tensor) -> torch.Tensor:
    """[world, *t.shape], every rank's ``t`` in rank order, with a
    gradient to each rank's own ``t``; ``t[None]`` without a group."""
    if not distributed():
        return t[None]
    return _GatherRanks.apply(t)


def gather_objects(obj) -> list:
    """Every rank's ``obj`` (picklable) in rank order; ``[obj]`` without a
    group."""
    if not distributed():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def gather_to_first(obj) -> Optional[list]:
    """Every rank's ``obj`` (picklable) in rank order on rank 0, None on
    the others; ``[obj]`` without a group."""
    if not distributed():
        return [obj]
    out = [None] * world_size() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
