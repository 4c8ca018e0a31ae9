"""Image and disparity file IO (own copy of the parts of
aanet_tpu/data/file_io.py that prediction needs; PIL only)."""
from __future__ import annotations

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
