"""Image and disparity file IO (own copy of aanet_tpu/data/file_io.py,
PIL and numpy only; the JAX package's native decoder is not carried over).

* images: RGB float32;
* PFM disparities (SceneFlow; bottom-up scanlines, the endianness in the
  sign of the scale line; 'subset' variants store negated values);
* KITTI disparity png: uint16 / 256;
* npy passthrough.
"""
from __future__ import annotations

import re
import sys

import numpy as np
from PIL import Image


def read_img(filename: str) -> np.ndarray:
    """[H, W, 3] float32 RGB."""
    with Image.open(filename) as img:
        return np.array(img.convert("RGB"), dtype=np.float32)


def write_pfm(filename: str, image: np.ndarray, scale: float = 1.0) -> None:
    if image.dtype.name != "float32":
        raise ValueError("PFM image must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("image must be HxWx3, HxWx1 or HxW")
    image = np.flipud(image)
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(b"%f\n" % scale)
        image.tofile(f)


def read_pfm(filename: str) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (data, scale); rows flipped to top-down."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")
        m = re.match(r"^(\d+)\s(\d+)\s*$", f.readline().decode("ascii"))
        if not m:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape)).copy(), abs(scale)


def read_disp(filename: str, subset: bool = False) -> np.ndarray:
    """[H, W] float32 disparity; dispatch on the extension."""
    if filename.endswith("pfm"):
        disp = np.ascontiguousarray(read_pfm(filename)[0], dtype=np.float32)
        return -disp if subset else disp
    if filename.endswith("png"):  # KITTI: uint16 / 256, 0 is invalid
        with Image.open(filename) as img:
            return np.array(img).astype(np.float32) / 256.0
    if filename.endswith("npy"):
        return np.load(filename)
    raise ValueError(f"unknown disparity format: {filename}")
