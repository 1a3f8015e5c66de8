"""Builds the port's CUDA sources into shared libraries loaded with ctypes.

Every ``kernels/**/csrc/*.cu`` compiles on its own with ``nvcc`` for
``sm_90a`` into ``<repo>/build/kernels/<stem>-<hash>.so``, at first
use. The hash covers the source text, the shared headers
(``kernels/csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is loaded as built. The sources
expose a plain C interface: no PyTorch header is compiled, which keeps
a build to seconds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.glob("**/csrc/*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes()
                       for h in sorted(KERNELS_DIR.glob("**/csrc/*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(src: Path):
    """Start nvcc for ``src`` unless its library is built; returns
    (target, process or None)."""
    out = _target(src)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, (proc, tmp)


def _finish(src: Path, out: Path, job) -> str:
    """Wait for one nvcc job; returns its log (ptxas register report)."""
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Build every CUDA source at once (one nvcc each, all started
    together); returns {source stem: nvcc log}."""
    jobs = [(src, *_start(src)) for src in sources()]
    return {src.stem: _finish(src, out, job) for src, out, job in jobs}


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu``, built first if needed."""
    (src,) = [s for s in sources() if s.stem == stem]
    out, job = _start(src)
    _finish(src, out, job)
    return ctypes.CDLL(str(out))
