"""Builds the CUDA kernels under ``transmvsnet_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process (all started together) into ``build/kernels/<name>-<hash>.so``
at the repository root, then loaded with ``ctypes``. The hash covers the
source, every header under ``csrc`` (``*.cuh``, which a source may
include) and the flags, so an edited source or header is rebuilt and an
unchanged one is reused. ``LINK_FLAGS`` adds libraries per source
(``image_codec.cu`` links the CUDA toolkit's ``libnvjpeg``); a source
without any hashes as before. ``csrc/png_unfilter.cu`` holds host code
only (the PNG decoder's row unfilter), built the same way. The first call
builds under a lock: the data loader's threads may ask at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = {"image_codec": ["-lnvjpeg"]}

_libraries: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
build_log: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _link_flags(src: pathlib.Path) -> list[str]:
    """The source's libraries, found at run time where nvcc's toolkit keeps
    them (rpath)."""
    libs = LINK_FLAGS.get(src.stem, [])
    if not libs:
        return []
    lib_dir = pathlib.Path(_nvcc()).resolve().parents[1] / "lib64"
    return [f"-L{lib_dir}", "-Xlinker", f"-rpath,{lib_dir}", *libs]


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    if src.stem in LINK_FLAGS:
        h.update(" ".join(_link_flags(src)).encode())
    digest = h.hexdigest()
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src), *_link_flags(src)]
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
        with _build_lock:
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


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """Count one launch of a kernel templated on the activation type:
    ``wrapper.launches`` counts its bf16 instantiation,
    ``wrapper.launches_f32`` its float32 one."""
    attr = "launches_f32" if dtype == torch.float32 else "launches"
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)
