"""Build and load the hand-written CUDA kernels in ``tbist_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc`` into
its own shared library, loaded with ``ctypes``; no PyTorch headers are
involved, so a source builds in seconds. The libraries go to
``<repo>/build/tbist_kernels/<stem>-<hash>.so``, keyed by a hash of the
source and the flags, so an unchanged source is not rebuilt. ``build``
starts one ``nvcc`` per missing library, all at once, and waits for them.

Nothing is compiled at import: the first kernel launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tbist_kernels")
SOURCES = ("gram.cu", "pool_bwd.cu", "sam_attn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(source: str) -> str:
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest[:16]}.so")


def build(sources: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together. Returns ``{source: compiler output}`` for the
    sources built (``--ptxas-options=-v`` lists each kernel's registers,
    shared memory and spills). Raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    started = {}
    try:
        for source in sources:
            target = library_path(source)
            if os.path.exists(target):
                continue
            tmp = f"{target}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            started[source] = (proc, tmp, target, time.perf_counter())
        logs, failures = {}, []
        for source, (proc, tmp, target, t0) in started.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {source} failed ({proc.returncode}):\n{out}")
                continue
            os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
            logs[source] = f"built in {time.perf_counter() - t0:.1f}s\n{out}"
        if failures:
            raise RuntimeError("\n".join(failures))
        return logs
    finally:
        for proc, tmp, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    build([source])
    return ctypes.CDLL(library_path(source))
