"""Builds the CUDA kernels under ``transmvsnet_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process (all started together) into ``build/kernels/<name>-<hash>.so``
at the repository root, then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is rebuilt and an unchanged one
is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libraries: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:12]}.so"


def build_all() -> float:
    """Compile every kernel source not yet built; returns wall seconds."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device; torch.cuda.is_available() is false")
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        target = _target(src)
        if src.stem in _libraries:
            continue
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, target, tmp, proc))
        else:
            _libraries[src.stem] = ctypes.CDLL(str(target))
    failed = []
    for src, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        build_log[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            continue
        os.replace(tmp, target)
        _libraries[src.stem] = ctypes.CDLL(str(target))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building the kernels first
    if needed."""
    if name not in _libraries:
        build_all()
    return _libraries[name]


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: {fn(code).decode()} ({code})")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
