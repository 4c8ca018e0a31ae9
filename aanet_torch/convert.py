"""Flax parameter trees -> a state_dict of the port's ``AANet``.

The port names its submodules after the flax path segments, so a flax
leaf ``a/b/c/kernel`` is the state_dict entry ``a.b.c.weight``:

* conv ``kernel`` HWIO -> ``weight`` OIHW (a grouped ``offset_conv``
  kernel (3, 3, Cin/G, Cout) becomes (Cout, Cin/G, 3, 3), output channels
  in the same order, as torch and flax both split them into G blocks);
* BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, plus torch's ``num_batches_tracked``;
* biases unchanged.

The inputs are nested dicts of numpy arrays, as ``jax.device_get`` gives
them; the port reads no flax file itself.
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
            if arr.ndim != 4:
                raise NotImplementedError(f"{'/'.join(path)}: only 2-D conv kernels are ported")
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
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
