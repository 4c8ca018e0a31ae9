"""Reading and writing the JAX package's checkpoints
(aanet_tpu/utils/checkpoint.py), with the standard library and numpy
only: the port imports neither flax nor ``msgpack``.

A checkpoint is the msgpack file ``flax.serialization.to_bytes`` writes
(optionally gzipped, as ``artifacts/aanet_synthetic_best.msgpack.gz``),
with its scalar metadata in a sidecar ``.json`` beside it. The decoder
reads the subset of msgpack that flax writes (maps, arrays, strings,
binaries, ints, floats, nil and bool) and flax's extension types 1 (an
ndarray, a packed ``(shape, dtype name, bytes)``) and 3 (a numpy scalar,
packed as a 0-d ndarray), then joins the arrays that flax splits into
chunks of at most 2^30 bytes (``__msgpack_chunked_array__``). A bfloat16
array, which numpy cannot hold, is returned as float32 (exact).

The encoder writes the subset a checkpoint needs: maps with string keys
in their insertion order, arrays as extension type 1 (a torch bf16 tensor
under the dtype name ``bfloat16``), and arrays over
``chunk_bytes`` (flax's ``MAX_CHUNK_SIZE``, 2^30) split into flat chunks,
so its bytes are ``flax.serialization.to_bytes``'s of the same tree.
``save_flax_checkpoint`` writes a model's ``params`` and ``batch_stats``
so: the JAX package loads the pair with ``load_pretrained_params``
(``--pretrained``); it holds no optimizer state, so not with ``--resume``.
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
MAX_CHUNK_BYTES = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE


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


def _pack_int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if n < 1 << (8 * struct.calcsize(fmt)):
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if n >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_sized(n: int, fixed, codes) -> bytes:
    """A header for ``n`` entries or bytes: ``fixed`` = (first code, limit)
    or None; ``codes`` the 8-, 16- and 32-bit (or 16- and 32-bit) forms."""
    if fixed is not None and n < fixed[1]:
        return bytes([fixed[0] | n])
    fmts = (">B", ">H", ">I")[-len(codes):]
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} entries or bytes exceed msgpack's 32-bit sizes")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _pack_sized(n, None, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _array_parts(leaf):
    """(shape, dtype name, C-order bytes) of a numpy array or a torch
    tensor (bf16 as its 2-byte words, named as flax names it)."""
    if hasattr(leaf, "detach"):  # a torch tensor
        t = leaf.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":  # its bits, the upper half of the float32
            bits = (t.float().numpy().view(np.uint32) >> 16).astype(np.uint16)
            return tuple(t.shape), "bfloat16", bits.tobytes()
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _pack_ndarray(leaf) -> bytes:
    """flax's ``_ndarray_to_bytes`` inside its extension type: the triple
    (shape, dtype name, bytes) packed as a msgpack array."""
    shape, name, raw = _array_parts(leaf)
    inner = (_pack_sized(3, (0x90, 16), (0xDC, 0xDD))
             + _pack_sized(len(shape), (0x90, 16), (0xDC, 0xDD))
             + b"".join(_pack_int(int(d)) for d in shape)
             + _pack_str(name)
             + _pack_sized(len(raw), None, (0xC4, 0xC5, 0xC6)) + raw)
    return _pack_ext(_EXT_NDARRAY, inner)


def _pack_str(text: str) -> bytes:
    raw = text.encode("utf-8")
    return _pack_sized(len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB)) + raw


def _itemsize(leaf) -> int:
    return leaf.element_size() if hasattr(leaf, "detach") else leaf.dtype.itemsize


def _nbytes(leaf) -> int:
    return (leaf.numel() if hasattr(leaf, "detach") else leaf.size) * _itemsize(leaf)


def _chunked(leaf, chunk_bytes: int) -> dict:
    """flax's ``_chunk``: the flat array in pieces of ``chunk_bytes``."""
    size = max(1, int(chunk_bytes / _itemsize(leaf)))
    flat = leaf.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
            "chunks": {str(j): flat[i: i + size] for j, i in enumerate(range(0, n, size))}}


def encode_msgpack(tree, chunk_bytes: int = MAX_CHUNK_BYTES) -> bytes:
    """``tree`` (nested dicts with string keys of numpy arrays and torch
    tensors) as the msgpack bytes ``flax.serialization.to_bytes`` gives the
    same dict; arrays of more than ``chunk_bytes`` bytes are chunked as
    flax chunks them (a map of the shape's ints, a true flag and the
    pieces)."""
    out = []

    def put(value):
        if isinstance(value, dict):
            out.append(_pack_sized(len(value), (0x80, 16), (0xDE, 0xDF)))
            for key, item in value.items():
                if not isinstance(key, str):
                    raise TypeError(f"msgpack map key {key!r}: flax writes string keys")
                out.append(_pack_str(key))
                put(item)
        elif isinstance(value, np.ndarray) or hasattr(value, "detach"):
            if _nbytes(value) > chunk_bytes:
                put(_chunked(value, chunk_bytes))
            else:
                out.append(_pack_ndarray(value))
        elif isinstance(value, bool):
            out.append(b"\xc3" if value else b"\xc2")
        elif isinstance(value, int):
            out.append(_pack_int(value))
        else:
            raise TypeError(f"cannot encode {type(value).__name__} as flax does")

    put(tree)
    return b"".join(out)


def save_flax_checkpoint(ckpt_dir: str, name: str, model, *, step: int = 0, epoch: int = 0,
                         epe: float = -1.0, best_epe: float = 999.0, best_epoch: int = -1) -> str:
    """``model``'s ``params`` and ``batch_stats`` as ``<ckpt_dir>/<name>.msgpack``,
    the bytes the JAX package's ``save_checkpoint`` writes for those trees
    (aanet_tpu/utils/checkpoint.py:29-65: its ``jax.tree.map`` sorts every
    map's keys; written to a temporary and moved into place), and the
    sidecar ``<name>.json`` with its keys. Returns the msgpack's path."""
    def sort(tree):
        return {k: sort(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree

    params, batch_stats = (sort(t) for t in flax_from_state_dict(model.state_dict()))
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{name}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(encode_msgpack({"params": params, "batch_stats": batch_stats}))
    os.replace(tmp, path)
    meta = {"step": int(step), "epoch": int(epoch), "epe": float(epe),
            "best_epe": float(best_epe), "best_epoch": int(best_epoch)}
    with open(os.path.join(ckpt_dir, f"{name}.json"), "w") as f:
        json.dump(meta, f)
    return path


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
