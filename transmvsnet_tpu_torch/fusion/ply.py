"""Minimal binary PLY point-cloud IO (numpy; no plyfile dependency), the
port's own copy of the JAX package's ``fusion/ply.py``.

Writes the same vertex layout the reference emits (x/y/z float32 +
red/green/blue uchar, binary little-endian; reference
dynamic_fusion.py:267-280, gipuma displayUtils.h:10-55) so downstream DTU
evaluation tooling reads our clouds unchanged.
"""

from __future__ import annotations

import numpy as np

_DTYPE = np.dtype(
    [
        ("x", "<f4"),
        ("y", "<f4"),
        ("z", "<f4"),
        ("red", "u1"),
        ("green", "u1"),
        ("blue", "u1"),
    ]
)


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None) -> None:
    """xyz: [N, 3] float; rgb: [N, 3] uint8 (defaults to white)."""
    n = len(xyz)
    if rgb is None:
        rgb = np.full((n, 3), 255, dtype=np.uint8)
    rec = np.empty(n, dtype=_DTYPE)
    rec["x"], rec["y"], rec["z"] = (
        xyz[:, 0].astype(np.float32),
        xyz[:, 1].astype(np.float32),
        xyz[:, 2].astype(np.float32),
    )
    rec["red"], rec["green"], rec["blue"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        "property uchar red\n"
        "property uchar green\n"
        "property uchar blue\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def read_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Returns (xyz [N, 3] float32, rgb [N, 3] uint8 or None).

    Handles binary-little-endian and ascii PLY with x/y/z (+ rgb) props.
    """
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element"):
                parts = line.split()
                in_vertex = parts[1] == b"vertex"
                if in_vertex:
                    n = int(parts[2])
            elif line.startswith(b"property") and in_vertex:
                parts = line.split()
                props.append((parts[1].decode(), parts[2].decode()))
            elif line == b"end_header":
                break

        type_map = {
            "float": "<f4",
            "float32": "<f4",
            "double": "<f8",
            "uchar": "u1",
            "uint8": "u1",
            "int": "<i4",
            "int32": "<i4",
        }
        if fmt == "binary_little_endian":
            dt = np.dtype([(name, type_map[t]) for t, name in props])
            rec = np.fromfile(f, dtype=dt, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, max_rows=n)
            rec = {name: data[:, i] for i, (t, name) in enumerate(props)}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    xyz = np.stack(
        [np.asarray(rec["x"]), np.asarray(rec["y"]), np.asarray(rec["z"])], axis=1
    ).astype(np.float32)
    names = [name for _, name in props]
    rgb = None
    if {"red", "green", "blue"} <= set(names):
        rgb = np.stack(
            [np.asarray(rec["red"]), np.asarray(rec["green"]), np.asarray(rec["blue"])],
            axis=1,
        ).astype(np.uint8)
    return xyz, rgb
