"""Build the hand-written CUDA sources and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header (only CUDA's and the ``csrc/*.cuh`` beside it), so ``nvcc`` builds
it in seconds. The shared library goes to
``build/repro_torch/`` at the repository root, named after a hash of the
source and the flags, so a changed source is never served a stale build;
it is built at first use. Nothing here runs at import time: CPU-only torch
imports the package without a compiler.

A variant builds the same source again with defines of its own
(``VARIANTS``: ``pso_step`` with ``-DPSO_T_BF16`` holds the bfloat16
kernels) into a library, tag and compiler report of its own, so the plain
build of a source is the same with and without its variants.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: A variant's defines, added to ``NVCC_FLAGS`` for ``<source>_<variant>``.
VARIANTS = {"bf16": ("-DPSO_T_BF16",)}


def nvcc() -> str:
    """The CUDA compiler: on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "kernels are built with the CUDA toolkit at first use")


def _flags(variant: str) -> Tuple[str, ...]:
    return NVCC_FLAGS + (VARIANTS[variant] if variant else ())


def tag(name: str, variant: str = "") -> str:
    """The build tag of ``csrc/<name>.cu`` (in ``variant``, a key of
    ``VARIANTS``, or plain): a hash of the source, the headers beside it
    (``csrc/*.cuh``, which the sources include) and the flags, which names
    its library (and fingerprints the serving compile cache's
    manifest)."""
    parts = [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))
    return hashlib.sha1(b"".join(p.read_bytes() for p in parts)
                        + " ".join(_flags(variant)).encode()).hexdigest()[:12]


_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def build(name: str, variant: str = "") -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` (in ``variant``) unless its build exists;
    returns the library path and the compiler's report (``-Xptxas -v``:
    registers, shared memory and spills of every kernel). A thread that
    asks for a library another thread is building waits for that build."""
    src = CSRC / f"{name}.cu"
    stem = f"{name}_{variant}" if variant else name
    lib = BUILD_DIR / f"lib{stem}-{tag(name, variant)}.so"
    with _LOCKS_GUARD:
        lock = _LOCKS.setdefault(lib, threading.Lock())
    with lock:
        return _build(src, variant, lib)


def _build(src: Path, variant: str, lib: Path) -> Tuple[Path, str]:
    log = lib.with_suffix(".log")
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *_flags(variant), "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def load(name: str, variant: str = "") -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` (in ``variant``) once
    per process."""
    lib, _ = build(name, variant)
    return ctypes.CDLL(str(lib))
