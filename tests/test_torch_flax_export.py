"""The port's flax-checkpoint writer (``aanet_torch.utils.checkpoint``)
against flax and the JAX package, on the CPU:

* ``encode_msgpack``'s bytes equal ``flax.serialization.to_bytes`` of the
  same nested dict (flax's own order of keys), also at a small chunk size
  with flax's ``MAX_CHUNK_SIZE`` patched to it, and the port's reader
  reads them back; a bf16 leaf (a torch tensor) is flax's bf16 array;
* ``save_flax_checkpoint``'s files equal the JAX package's
  ``save_checkpoint`` of the same trees, byte for byte, the sidecar
  included; ``load_pretrained_params(..., strict=True)`` loads a file the
  port wrote, and the JAX forward of those weights equals the port's at
  test_torch_model.py's tolerances (5e-2 px max, 5e-3 px mean), on the
  cut ``aanet`` preset at 48x96.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from aanet_tpu.config import preset as jax_preset
from aanet_tpu.utils.checkpoint import load_pretrained_params, save_checkpoint
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict
from aanet_torch.utils import checkpoint

from _torch_port import load_flax, nchw, random_variables

CUT = dict(max_disp=48, num_fusions=2, num_deform_blocks=1)


def nested_tree():
    rs = np.random.RandomState(0)
    return {
        "params": {"b_conv": {"kernel": rs.randn(3, 3, 4, 5).astype(np.float32),
                              "bias": rs.randn(5).astype(np.float32)},
                   "a_norm": {"scale": rs.randn(300).astype(np.float32)}},
        "batch_stats": {},
        "counts": np.arange(70000, dtype=np.int64),
        "empty": np.zeros((0, 3), np.float32),
        "bools": np.array([True, False]),
        **{f"k{i:02d}": np.full(i, -i, np.int16) for i in range(20)},  # a map of 16+ keys
    }


@pytest.mark.parametrize("chunk", [None, 1000], ids=["whole", "chunked"])
def test_encoder_bytes_equal_flax_to_bytes(chunk, monkeypatch):
    tree = nested_tree()
    if chunk is not None:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        got = checkpoint.encode_msgpack(tree, chunk_bytes=chunk)
    else:
        got = checkpoint.encode_msgpack(tree)
    assert got == serialization.to_bytes(tree)
    back = checkpoint.decode_msgpack(got)
    assert list(back) == list(tree)
    for key in ("counts", "empty"):
        np.testing.assert_array_equal(back[key], tree[key])
    np.testing.assert_array_equal(back["params"]["b_conv"]["kernel"], tree["params"]["b_conv"]["kernel"])
    for key in ("bools", "k00", "k19"):
        np.testing.assert_array_equal(back[key], tree[key])
        assert back[key].dtype == tree[key].dtype


def test_bf16_leaf_round_trips():
    values = jnp.asarray(np.random.RandomState(1).randn(7, 3) * 100, jnp.bfloat16)
    leaf = torch.from_numpy(np.array(values.astype(jnp.float32))).to(torch.bfloat16)
    got = checkpoint.encode_msgpack({"w": leaf})
    assert got == serialization.to_bytes({"w": np.asarray(values)})
    back = checkpoint.decode_msgpack(got)["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, leaf.float().numpy())
    restored = serialization.msgpack_restore(got)["w"]
    np.testing.assert_array_equal(np.asarray(restored, np.float32), back)


@pytest.fixture(scope="module")
def cut_model():
    h, w = 48, 96
    jmodel = dataclasses.replace(jax_preset("aanet"), **CUT).build()
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
                            jnp.zeros((1, h, w, 3)), train=False), 2)
    port = load_flax(dataclasses.replace(preset("aanet"), **CUT).build(), variables)
    return jmodel, variables, port, (h, w)


def test_port_written_checkpoint_is_the_jax_packages(cut_model, tmp_path):
    _, variables, port, _ = cut_model
    meta = dict(step=12, epoch=3, epe=1.25, best_epe=1.0, best_epoch=2)
    path = checkpoint.save_flax_checkpoint(str(tmp_path / "port"), "aanet_best", port, **meta)
    params, stats = flax_from_state_dict(port.state_dict())
    save_checkpoint(str(tmp_path / "jax"), "aanet_best", params=params, batch_stats=stats, **meta)
    for suffix in (".msgpack", ".json"):
        with open(path[: -len(".msgpack")] + suffix, "rb") as f:
            got = f.read()
        with open(os.path.join(tmp_path, "jax", "aanet_best" + suffix), "rb") as f:
            assert got == f.read(), suffix
    with open(path[: -len(".msgpack")] + ".json") as f:
        assert json.load(f) == meta
    assert not os.path.exists(path + ".tmp")


def test_jax_package_loads_the_port_file_strictly(cut_model, tmp_path):
    jmodel, variables, port, (h, w) = cut_model
    path = checkpoint.save_flax_checkpoint(str(tmp_path), "aanet_latest", port)
    template = jax.tree.map(np.zeros_like, variables)
    params, stats = load_pretrained_params(path, template["params"], template["batch_stats"],
                                           strict=True)
    rs = np.random.RandomState(3)
    left, right = (rs.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(
        {"params": params, "batch_stats": stats}, left, right)
    with torch.no_grad():
        got = port.eval()(nchw(left), nchw(right))
    assert len(got) == len(want)
    for g, wv in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(wv))
        assert err.max() <= 5e-2 and err.mean() <= 5e-3, (err.max(), err.mean())
    # and the port's reader takes the file back into a fresh model
    fresh = dataclasses.replace(preset("aanet"), **CUT).build()
    assert checkpoint.load_pretrained(fresh, path, strict=True) == []
    for name, value in port.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[name], value), name
