"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers), so
`nvcc` builds it into a shared library in seconds; `ctypes` loads it. The
build happens at first use, never at import, into `build/kernels/` at the
root of the checkout (listed in .gitignore). A library's file name carries
a hash of its source and flags, so an edited source is rebuilt. Builds are
serialised across processes (ranks that start together) by an exclusive
`flock` on `build/kernels/build.lock`, which the kernel drops when its
holder exits: the first process compiles, the others find the library.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile every named source that is not built yet, one `nvcc` process
    per source, all started together. Returns {name: (library, compiler
    log)}; the log holds ptxas's register and shared-memory report. Raises
    RuntimeError with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names: Sequence[str]) -> Dict[str, Tuple[Path, str]]:
    procs = {}
    out: Dict[str, Tuple[Path, str]] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path, _ = build_all([name])[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
