"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), all
``nvcc`` processes started together. Libraries go to ``build/kernels/`` at
the root of the checkout, named by a hash of the sources, the shared
headers and the flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. The build runs at the first CUDA call, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention.cu", "chunked_prefill_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    """Where the library of ``source`` lands, keyed by its content hash."""
    h = hashlib.sha256()
    for p in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all at once. Returns the compiler's output (register and
    shared-memory use from ``-Xptxas -v``) by source; raises
    ``RuntimeError`` with the log of every source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in SOURCES:
        target = library_path(source)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, target)
    logs, failed = {}, []
    for source, (proc, tmp, target) in procs.items():
        logs[source], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- {source} (exit {proc.returncode})\n"
                          f"{logs[source]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building it first if needed."""
    if not library_path(source).exists():
        build_all()
    return ctypes.CDLL(str(library_path(source)))
