"""The PyTorch port's ``aanet`` forward against the JAX package's, on the
CPU, with randomised weights (every offset_conv and ZeroNorm scale
non-zero) carried across by ``aanet_torch.convert``.

Tolerance: the full pyramid within 5e-2 px max and 5e-3 px mean
(tests/test_parity_torch.py:13-16).
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aanet_tpu.config import preset as jax_preset
from aanet_torch.config import preset
from aanet_torch.ops import KERNEL_OPS

from _torch_port import load_flax, nchw, randomize

CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)


def test_aanet_pyramid_matches_jax_at_random_weights():
    h, w = 96, 192
    rs = np.random.RandomState(0)
    left = rs.randn(1, h, w, 3).astype(np.float32)
    right = rs.randn(1, h, w, 3).astype(np.float32)
    jmodel = dataclasses.replace(jax_preset("aanet"), **CUT).build()
    variables = jax.jit(lambda k, a, b: jmodel.init(k, a, b, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)), jnp.zeros((1, h, w, 3))
    )
    variables = randomize(variables, 1)
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, left, right)

    port = load_flax(dataclasses.replace(preset("aanet"), **CUT).build(), variables)
    with torch.no_grad():
        got = port(nchw(left), nchw(right))

    assert [tuple(g.shape) for g in got] == [
        (1, h // 12, w // 12), (1, h // 6, w // 6), (1, h // 3, w // 3),
        (1, h // 2, w // 2), (1, h, w),
    ]
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - np.asarray(wv))
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    # the CPU forward took the plain versions only
    assert [op.launches for op in KERNEL_OPS] == [0] * len(KERNEL_OPS)
