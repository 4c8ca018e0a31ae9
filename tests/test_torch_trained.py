"""The PyTorch port at the committed trained checkpoint
(artifacts/aanet_synthetic_best.msgpack.gz: the ``aanet`` preset at
max_disp 48), loaded with flax on the JAX side as in
tests/test_bf16_trained.py:39-59 and carried across by
``aanet_torch.convert``, on that test's in-distribution synthetic pair.

Tolerances: the final disparity within 5e-2 px max and 5e-3 px mean of
the JAX forward, and the EPE within 1e-3 of the JAX EPE.
"""
import dataclasses
import gzip
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_torch.config import preset

from _torch_port import load_flax, nchw

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts",
    "aanet_synthetic_best.msgpack.gz",
)


def test_trained_checkpoint_matches_jax():
    from flax import serialization

    h, w, shift = 96, 192, 6
    jmodel = dataclasses.replace(jax_preset("aanet"), max_disp=48).build()
    variables = jax.jit(lambda r, a, b: jmodel.init(r, a, b, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 3))
    )
    with gzip.open(ARTIFACT, "rb") as f:
        variables = serialization.from_bytes(
            {
                "params": jax.device_get(variables["params"]),
                "batch_stats": jax.device_get(variables["batch_stats"]),
            },
            f.read(),
        )

    # smoothed noise with a constant integer shift (tools/synthetic_dataset.py)
    rs = np.random.RandomState(7)
    base = rs.rand(h, w + 16, 3)
    base = (base + np.roll(base, 1, 1) + np.roll(base, 2, 1)) / 3
    right = base[:, :w].astype(np.float32)
    left = base[:, shift: w + shift].astype(np.float32)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    lb = ((left - mean) / std)[None]
    rb = ((right - mean) / std)[None]

    want = np.asarray(
        jax.jit(lambda v, l, r: jmodel.apply(v, l, r, train=False)[-1])(variables, lb, rb)
    )
    port = load_flax(dataclasses.replace(preset("aanet"), max_disp=48).build(), variables)
    with torch.no_grad():
        got = port(nchw(lb), nchw(rb))[-1].numpy()

    err = np.abs(got - want)
    assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    epe_jax = float(np.abs(want - shift).mean())
    epe_port = float(np.abs(got - shift).mean())
    assert epe_jax < 2.0, epe_jax  # the checkpoint is trained
    assert abs(epe_port - epe_jax) <= 1e-3, (epe_port, epe_jax)
