"""Helpers shared by the tests of the PyTorch port (tests/test_torch_*.py):
random flax variables made from a numpy seed, carried into the port's
modules through ``aanet_torch.convert``, and layout changes at the
JAX (NHWC) / port (NCHW) boundary."""
import numpy as np
import torch

import jax

from aanet_torch.convert import state_dict_from_flax


def _map_leaves(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, np.asarray(tree))


def randomize(variables, seed):
    """Every leaf of a flax init drawn anew from ``RandomState(seed)``.

    The fresh init has zero ``offset_conv`` weights (every deformable conv a
    plain dilated conv) and zero ZeroNorm scales (every residual branch
    dead); here both are non-zero. Offsets come out at about a pixel.
    """
    rs = np.random.RandomState(seed)

    def param(path, a):
        name = path[-1]
        if name == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            std = (0.5 if "offset_conv" in path else 1.0) / np.sqrt(fan_in)
            return (rs.randn(*a.shape) * std).astype(np.float32)
        if name == "scale":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)  # biases

    def stat(path, a):
        if path[-1] == "var":
            return rs.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)

    variables = jax.device_get(variables)
    out = {"params": _map_leaves(variables["params"], param)}
    if "batch_stats" in variables:
        out["batch_stats"] = _map_leaves(variables["batch_stats"], stat)
    return out


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Load flax ``variables`` into the port's ``module`` (strict) in eval mode."""
    state = state_dict_from_flax(variables["params"], variables.get("batch_stats", {}))
    module.load_state_dict(state, strict=True)
    return module.eval()


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)
