"""PFM (portable float map) IO — the depth/confidence interchange format.

Implements the PFM spec as used by the MVS ecosystem (behavioral contract:
reference datasets/data_io.py:6-79): 'Pf' (gray) / 'PF' (color) header,
width/height line, scale line whose sign encodes endianness, rows stored
bottom-up (hence the vertical flip).
"""

from __future__ import annotations

import re
import sys

import numpy as np


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file. Returns (data [H, W] or [H, W, 3], scale)."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dim_line = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dim_line)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dim_line!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)

        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = data.reshape(shape)
    return np.flipud(data).copy(), scale


def save_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 image as PFM (grayscale [H, W] or color [H, W, 3])."""
    if image.dtype != np.float32:
        raise ValueError("PFM image dtype must be float32")
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"bad PFM image shape {image.shape}")

    little = image.dtype.byteorder == "<" or (
        image.dtype.byteorder == "=" and sys.byteorder == "little"
    )
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale if little else scale:f}\n".encode())
        np.flipud(image).tofile(f)
