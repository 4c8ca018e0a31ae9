"""The port's reader of the JAX package's checkpoints
(``aanet_torch/utils/checkpoint.py``) against flax, on the CPU: the
msgpack decoder against ``flax.serialization.msgpack_restore`` on a
``to_bytes`` payload of every dtype and scalar kind a tree can hold, on
flax's chunked form of a large array, and on the committed trained
checkpoint; the sidecar metadata; and ``load_pretrained`` against the JAX
package's ``load_pretrained_params``, strict and not. All comparisons are
exact."""
import ast
import dataclasses
import gzip
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from aanet_tpu.utils.checkpoint import load_pretrained_params, save_checkpoint
from aanet_torch.config import preset
from aanet_torch.convert import flax_from_state_dict, state_dict_from_flax
from aanet_torch.infer import load_model
from aanet_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "artifacts", "aanet_synthetic_best.msgpack.gz")


def test_reader_imports_neither_flax_nor_msgpack():
    """The reader runs where neither is installed: it imports the standard
    library, numpy and the port only."""
    with open(checkpoint.__file__) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert roots - sys.stdlib_module_names <= {"numpy", "aanet_torch"}, roots


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def assert_same_tree(got, want):
    """Same paths, and equal values of the same kind at each: arrays of
    the same dtype (bfloat16 compared as its float32 value) and bits."""
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        if isinstance(w, (np.ndarray, np.generic)):
            if w.dtype == jnp.bfloat16:
                w = np.asarray(w, np.float32)
            assert isinstance(g, type(w)) and g.dtype == w.dtype and g.shape == w.shape, path
            assert np.array_equal(g, w), path
        else:
            assert type(g) is type(w) and g == w, path


def _payload():
    rs = np.random.RandomState(0)
    arrays = {
        "float32": rs.randn(3, 4).astype(np.float32),
        "float64": rs.randn(2, 2, 2),
        "float16": rs.randn(5).astype(np.float16),
        "bfloat16": jnp.asarray(rs.randn(2, 3), jnp.bfloat16),
        "int32": rs.randint(-2**31, 2**31 - 1, (4,), dtype=np.int32),
        "int64": rs.randint(-2**62, 2**62, (3,), dtype=np.int64),
        "uint8": rs.randint(0, 256, (7,), dtype=np.uint8),
        "bool": rs.rand(6) > 0.5,
        "empty": np.zeros((0, 3), np.float32),
        "scalar_array": np.array(2.5, np.float32),
    }
    scalars = {
        "np_int32": np.int32(-7), "np_float32": np.float32(0.125), "np_bool": np.bool_(True),
        "int": 12, "negative": -3, "big": 2**40, "huge": 2**63 + 5, "min": -2**63,
        "float": 1.5, "true": True, "none": None, "name": "a" * 40,
    }
    wide = {f"k{i}": np.full((i % 3 + 1,), i, np.int32) for i in range(20)}  # a map16
    return {"params": {"arrays": arrays, "scalars": scalars, "wide": wide}, "step": np.int32(3),
            "opt_state": [np.zeros(2, np.float32), {"count": np.int32(1)}]}


def test_decoder_matches_flax_on_every_kind():
    data = serialization.to_bytes(_payload())
    assert_same_tree(checkpoint.decode_msgpack(data), serialization.msgpack_restore(data))


def test_decoder_joins_flax_chunked_arrays():
    """flax splits arrays above MAX_CHUNK_SIZE bytes into flat chunks
    (``_chunk``); with the limit lowered a small array takes that form."""
    tree = {"params": {"big": np.arange(1000, dtype=np.float32).reshape(10, 100),
                       "small": np.ones(3, np.int32)}}
    with mock.patch.object(serialization, "MAX_CHUNK_SIZE", 256):
        data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = checkpoint.decode_msgpack(data)
    assert_same_tree(got, serialization.msgpack_restore(data))
    assert_same_tree(got, tree)


def test_decoder_refuses_malformed_data():
    data = serialization.to_bytes({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.decode_msgpack(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack object"):
        checkpoint.decode_msgpack(data + b"\x00")
    with pytest.raises(ValueError, match="not valid"):
        checkpoint.decode_msgpack(b"\xc1")


def test_reads_the_trained_checkpoint_as_flax_does():
    with gzip.open(ARTIFACT, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = checkpoint.read_flax_msgpack(ARTIFACT)
    assert sorted(got) == ["batch_stats", "opt_state", "params"]
    assert_same_tree(got, want)


def test_reads_a_checkpoint_and_its_metadata_as_the_jax_package_writes_them(tmp_path):
    params = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(1, 1, 2, 3)}}
    path = save_checkpoint(str(tmp_path), "aanet_best", params=params, batch_stats={},
                           step=7, epoch=2, epe=1.25, best_epe=1.25, best_epoch=2)
    with open(path, "rb") as f:
        assert_same_tree(checkpoint.read_flax_msgpack(path), serialization.msgpack_restore(f.read()))
    meta = dict(step=7, epoch=2, epe=1.25, best_epe=1.25, best_epoch=2)
    assert checkpoint.read_metadata(path) == meta
    gz = path + ".gz"
    with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
        dst.write(src.read())
    assert checkpoint.read_metadata(gz) == meta
    assert_same_tree(checkpoint.read_flax_msgpack(gz), checkpoint.read_flax_msgpack(path))
    assert checkpoint.read_metadata(str(tmp_path / "other.msgpack")) == {}


def _model():
    return dataclasses.replace(preset("gcnet-aa"), max_disp=48, num_fusions=1,
                               num_deform_blocks=1).build()


def _file(tmp_path, params, batch_stats, name="ckpt.msgpack"):
    """The trees as flax's to_bytes writes a checkpoint, with an opt_state
    the model does not have."""
    path = str(tmp_path / name)
    payload = {"params": params, "batch_stats": batch_stats,
               "opt_state": {"0": {"count": np.int32(4)}}}
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(payload))
    return path


def _randomised(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: rs.randn(*a.shape).astype(np.float32), tree)


def test_load_pretrained_copies_every_leaf_strictly(tmp_path):
    model = _model()
    params, stats = flax_from_state_dict(model.state_dict())
    params, stats = _randomised(params, 1), _randomised(stats, 2)
    path = _file(tmp_path, params, stats)
    assert checkpoint.load_pretrained(model, path, strict=True) == []
    want = state_dict_from_flax(params, stats)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # and a loaded model is the one load_model builds from the file
    loaded = load_model(dataclasses.replace(preset("gcnet-aa"), max_disp=48, num_fusions=1,
                                            num_deform_blocks=1), path, device="cpu")
    assert all(torch.equal(v, got[k]) for k, v in loaded.state_dict().items())


@pytest.mark.parametrize("strict", [False, True])
def test_load_pretrained_matches_load_pretrained_params(tmp_path, strict):
    """A file short of one leaf and with one leaf of another shape: not
    strict, both loaders copy the rest and keep the template's two leaves;
    strict, both raise, KeyError for the missing leaf and ValueError for
    the shape."""
    model = _model()
    template = flax_from_state_dict(model.state_dict())
    params, stats = _randomised(template[0], 3), _randomised(template[1], 4)
    del params["fpn"]["Conv_1"]["Conv_0"]["kernel"]
    stats["fpn"]["Norm_0"]["BatchNorm_0"]["mean"] = np.zeros(5, np.float32)
    path = _file(tmp_path, params, stats)
    if strict:
        with pytest.raises(KeyError, match="fpn/Conv_1/Conv_0/kernel"):
            load_pretrained_params(path, *template, strict=True)
        with pytest.raises(KeyError, match="fpn/Conv_1/Conv_0/kernel"):
            checkpoint.load_pretrained(model, path, strict=True)
        params["fpn"]["Conv_1"]["Conv_0"]["kernel"] = template[0]["fpn"]["Conv_1"]["Conv_0"]["kernel"]
        path = _file(tmp_path, params, stats, "shape.msgpack")
        with pytest.raises(ValueError, match="shape mismatch at batch_stats/fpn/Norm_0"):
            load_pretrained_params(path, *template, strict=True)
        with pytest.raises(ValueError, match="shape mismatch at batch_stats/fpn/Norm_0"):
            checkpoint.load_pretrained(model, path, strict=True)
        return
    want = state_dict_from_flax(*load_pretrained_params(path, *template, strict=False))
    skipped = checkpoint.load_pretrained(model, path, strict=False)
    assert skipped == ["params/fpn/Conv_1/Conv_0/kernel",
                       "batch_stats/fpn/Norm_0/BatchNorm_0/mean"]
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert torch.equal(got["fpn.Conv_1.Conv_0.weight"],
                       torch.from_numpy(template[0]["fpn"]["Conv_1"]["Conv_0"]["kernel"]
                                        .transpose(3, 2, 0, 1)))
