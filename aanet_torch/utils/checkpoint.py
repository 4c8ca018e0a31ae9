"""Reading the JAX package's checkpoints (the reading half of
aanet_tpu/utils/checkpoint.py:66-77,93-125), with the standard library
and numpy only: the port imports neither flax nor ``msgpack``.

A checkpoint is the msgpack file ``flax.serialization.to_bytes`` writes
(optionally gzipped, as ``artifacts/aanet_synthetic_best.msgpack.gz``),
with its scalar metadata in a sidecar ``.json`` beside it. The decoder
reads the subset of msgpack that flax writes (maps, arrays, strings,
binaries, ints, floats, nil and bool) and flax's extension types 1 (an
ndarray, a packed ``(shape, dtype name, bytes)``) and 3 (a numpy scalar,
packed as a 0-d ndarray), then joins the arrays that flax splits into
chunks of at most 2^30 bytes (``__msgpack_chunked_array__``). A bfloat16
array, which numpy cannot hold, is returned as float32 (exact).
"""
from __future__ import annotations

import gzip
import json
import os
import struct

import numpy as np

from aanet_torch.convert import flax_from_state_dict, state_dict_from_flax

FLAX_SUFFIXES = (".msgpack", ".msgpack.gz")
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax.serialization._MsgpackExtType
_CHUNKED = "__msgpack_chunked_array__"


class _Decoder:
    """A msgpack decoder over one buffer; strings are ``str`` unless
    ``raw`` (flax packs an ndarray's dtype name that way)."""

    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def value(self):
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[t - 0xC4])))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[t - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if t in (0xCA, 0xCB):
            return self.unpack(">f" if t == 0xCA else ">d")
        if 0xCC <= t <= 0xCF:
            return self.unpack(">" + "BHIQ"[t - 0xCC])
        if 0xD0 <= t <= 0xD3:
            return self.unpack(">" + "bhiq"[t - 0xD0])
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(self.unpack(">b"), 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack(">" + "BHI"[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if t == 0xDC else ">I"))
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{t:02x} at offset {self.pos - 1} is not valid")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack extension type {code} is not one flax writes for arrays")


def _ndarray(payload) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
    shape, name, buffer = _Decoder(payload, raw=True).value()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":  # the upper half of a float32
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """Join flax's chunked arrays (``flax.serialization._unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def decode_msgpack(data: bytes):
    """The tree ``flax.serialization.msgpack_restore(data)`` gives."""
    decoder = _Decoder(data)
    tree = decoder.value()
    if decoder.pos != len(decoder.data):
        raise ValueError(f"{len(decoder.data) - decoder.pos} bytes after the msgpack object")
    return _unchunk(tree)


def read_flax_msgpack(path: str):
    """flax's nested dict of numpy arrays from a ``.msgpack`` file, or a
    gzipped one (``.msgpack.gz``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return decode_msgpack(data)


def read_metadata(path: str) -> dict:
    """The checkpoint's sidecar metadata (step, epoch, epe, best_epe,
    best_epoch), or {} when there is none: ``x.json`` beside ``x.msgpack``
    or ``x.msgpack.gz``."""
    stem = path[:-3] if path.endswith(".gz") else path
    meta_path = os.path.splitext(stem)[0] + ".json"
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _merge(dst, src, where: str, strict: bool, skipped: list):
    """``load_pretrained_params``'s merge: ``src``'s leaf wherever its path
    and shape match ``dst``'s, else ``dst``'s (or, under ``strict``, a
    ``KeyError`` for a missing leaf and a ``ValueError`` for a shape)."""
    if isinstance(dst, dict):
        out = {}
        for k, v in dst.items():
            if isinstance(src, dict) and k in src:
                out[k] = _merge(v, src[k], f"{where}/{k}", strict, skipped)
            elif strict:
                raise KeyError(f"missing {where}/{k} in checkpoint")
            else:
                out[k] = v
                skipped.append(f"{where}/{k}")
        return out
    src_arr = np.asarray(src)
    if tuple(dst.shape) != tuple(src_arr.shape):
        if strict:
            raise ValueError(f"shape mismatch at {where}: {dst.shape} vs {src_arr.shape}")
        skipped.append(where)
        return dst
    return src_arr.astype(dst.dtype)


def load_pretrained(model, path: str, strict: bool = False) -> list[str]:
    """Load a flax checkpoint into the port's ``model`` with the JAX
    package's ``load_pretrained_params`` semantics: every ``params`` and
    ``batch_stats`` leaf of the model whose path and shape the file holds
    is copied; the others keep the model's values, or, under ``strict``,
    raise (``KeyError`` missing, ``ValueError`` shape). Entries of the
    file the model lacks (``opt_state``, other modules) are ignored.
    Returns the flax paths that were not loaded."""
    raw = read_flax_msgpack(path)
    params, batch_stats = flax_from_state_dict(model.state_dict())
    skipped: list[str] = []
    params = _merge(params, raw.get("params", {}), "params", strict, skipped)
    batch_stats = _merge(batch_stats, raw.get("batch_stats", {}), "batch_stats", strict, skipped)
    model.load_state_dict(state_dict_from_flax(params, batch_stats), strict=True)
    return skipped
