"""Build and load the package's CUDA sources as plain-C shared libraries.

Each source under gslam_tpu_torch/csrc/ is compiled by `nvcc` for sm_90a
into gslam_tpu_torch/_build/, keyed by a hash of the source text, of every
local file it includes (`#include "..."`, followed recursively) and of the
compiler flags, at its first use in a process, and loaded with ctypes.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "gslam_tpu_torch's kernels")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_digest(src: Path) -> str:
    """Hash of `src`, of the local files it includes (each once, found
    beside the file that includes it) and of NVCC_FLAGS."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    todo, seen = [src.resolve()], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(str(len(text)).encode() + b":" + text)
        for inc in _LOCAL_INCLUDE.findall(text):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_file():
                todo.append(dep)
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Build csrc/<name>.cu if its hash has no library yet; return the path."""
    src = CSRC / f"{name}.cu"
    digest = source_digest(src)
    lib = BUILD / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (built on first use)."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def function(name: str, fn_name: str, argtypes: list):
    """Entry point fn_name of csrc/<name>.cu's library, with its argument
    types; it returns an int, 0 or a CUDA error."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise where an entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")
