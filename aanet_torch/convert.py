"""Flax parameter trees <-> a state_dict of the port's ``AANet``.

The port names its submodules after the flax path segments, so a flax
leaf ``a/b/c/kernel`` is the state_dict entry ``a.b.c.weight``:

* conv ``kernel`` HWIO -> ``weight`` OIHW (a grouped ``offset_conv``
  kernel (3, 3, Cin/G, Cout) becomes (Cout, Cin/G, 3, 3), output channels
  in the same order, as torch and flax both split them into G blocks), and
  a 3-D kernel DHWIO -> OIDHW (a ``ConvTranspose`` kernel too: the port's
  layer holds the JAX orientation, ``models/layers.py``);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, plus torch's ``num_batches_tracked``;
* biases unchanged.

The inputs are nested dicts of numpy arrays, as ``jax.device_get`` or the
port's own flax-checkpoint reader (``aanet_torch/utils/checkpoint.py``,
which loads a ``.msgpack`` or ``.msgpack.gz`` file through this map) give
them. ``flax_from_state_dict`` is the inverse map: the reader's template
of a model's trees, and the trees of the port's trained state that
``utils/checkpoint.save_flax_checkpoint`` writes as a flax file.
"""
from __future__ import annotations

import numpy as np
import torch

_PARAM = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params, batch_stats) -> dict[str, torch.Tensor]:
    """Map flax ``params`` and ``batch_stats`` trees onto state_dict keys."""
    state = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        if name not in _PARAM:
            raise KeyError(f"unexpected flax parameter {'/'.join(path)}")
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        if name == "kernel":
            if arr.ndim not in (4, 5):
                raise ValueError(f"{'/'.join(path)}: a conv kernel of rank {arr.ndim}")
            spatial = tuple(range(arr.ndim - 2))
            arr = np.ascontiguousarray(arr.transpose(arr.ndim - 1, arr.ndim - 2, *spatial))
        state[".".join(mods + [_PARAM[name]])] = torch.from_numpy(arr)
    for path, leaf in _flatten(batch_stats):
        *mods, name = path
        if name not in _STAT:
            raise KeyError(f"unexpected flax batch statistic {'/'.join(path)}")
        state[".".join(mods + [_STAT[name]])] = torch.from_numpy(
            np.array(leaf, dtype=np.float32)
        )
        state[".".join(mods + ["num_batches_tracked"])] = torch.tensor(0, dtype=torch.long)
    return state


def flax_from_state_dict(state) -> tuple[dict, dict]:
    """The inverse of ``state_dict_from_flax``: (params, batch_stats) as
    nested dicts of numpy arrays. A 4-D or 5-D ``weight`` is a conv kernel
    (OIHW -> HWIO, OIDHW -> DHWIO), a 1-D ``weight`` a BatchNorm scale;
    ``num_batches_tracked`` has no flax counterpart and is dropped."""
    params: dict = {}
    batch_stats: dict = {}
    for key, value in state.items():
        *mods, name = key.split(".")
        arr = value.detach().cpu().numpy().astype(np.float32)
        if name == "num_batches_tracked":
            continue
        if name in ("running_mean", "running_var"):
            tree, leaf = batch_stats, "mean" if name == "running_mean" else "var"
        elif name == "weight" and arr.ndim == 1:
            tree, leaf = params, "scale"
        elif name == "weight" and arr.ndim in (4, 5):
            tree, leaf = params, "kernel"
            arr = np.ascontiguousarray(arr.transpose(*range(2, arr.ndim), 1, 0))
        elif name == "bias":
            tree, leaf = params, "bias"
        else:
            raise KeyError(f"unexpected state_dict entry {key}")
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr
    return params, batch_stats
