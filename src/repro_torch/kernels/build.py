"""Build and load the port's CUDA kernel libraries.

Each source in ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` at first use into
``<repo>/build/kernels/`` and loaded with ``ctypes``. The libraries are
named by one digest of every source and the flags, so a change to any of
them rebuilds all; the ``nvcc`` processes of one build run side by side.
A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SOURCES", "BuiltLibrary",
           "load_libraries"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"flash_attention": _CSRC / "flash_attention.cu",
           "cross_entropy": _CSRC / "cross_entropy.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuiltLibrary:
    name: str
    path: Path
    build_log: str            # nvcc/ptxas output (registers, smem, spills)
    lib: ctypes.CDLL


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin): the CUDA kernels cannot be "
                           "built")
    return cand


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SOURCES):
        h.update(name.encode() + SOURCES[name].read_bytes())
    return h.hexdigest()[:12]


@functools.lru_cache(maxsize=None)
def load_libraries() -> Dict[str, BuiltLibrary]:
    """Build what is missing (every source at once) and load all."""
    digest = _digest()
    paths = {n: BUILD_DIR / f"lib{n}_{digest}.so" for n in SOURCES}
    todo = [n for n, so in paths.items() if not so.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_name(f"{paths[n].name}.{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{SOURCES[n].name}: nvcc exited with "
                              f"{proc.returncode}:\n{out}")
                continue
            paths[n].with_suffix(".log").write_text(out)
            os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    out = {}
    for n, so in paths.items():
        log_path = so.with_suffix(".log")
        out[n] = BuiltLibrary(
            name=n, path=so,
            build_log=log_path.read_text() if log_path.exists() else "",
            lib=ctypes.CDLL(str(so)))
    return out
