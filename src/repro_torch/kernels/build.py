"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C
interface. It is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library under ``build/torch_kernels/`` at the repository root, named
by a hash of the source, the headers beside it (``csrc/*.cuh``) and the
flags (an edited source or header is rebuilt), and loaded with ctypes.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills,
warnings) is kept beside the library as ``<library>.log``.

``build_all`` starts one ``nvcc`` per source at once and waits for all of
them, so a caller that needs several kernels pays for the slowest build,
not the sum. Nothing here runs at import: the CPU tests import the kernel
modules on hosts without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "SHARED_MEMORY_BUDGET", "library_path",
           "build_all", "build", "load", "compiler_report"]

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SHARED_MEMORY_BUDGET = 232_448  # bytes one block may use on an H100 (227 KB)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built on this host")
    return path


def library_path(source: Path) -> Path:
    """Where the library built from `source` lives (content-addressed: the
    source, every header in its directory, which a source may include,
    and the flags)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> List[Path]:
    """Compile every library not built yet, all at once; return their paths.

    Raises ``RuntimeError`` naming each source whose build failed.
    """
    libs = [library_path(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        lib.with_name(lib.name + ".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return libs


def build(source: Path) -> Path:
    """Compile one library if it is not built yet; return its path."""
    return build_all([source])[0]


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed. The caller
    declares ``argtypes``/``restype`` of the functions it calls."""
    return ctypes.CDLL(str(build(source)))


def compiler_report(lib: Path) -> List[str]:
    """The register, spill and performance-warning lines of a library's
    build (ptxas says there when it serialises wgmma for want of
    registers)."""
    log = lib.with_name(lib.name + ".log")
    return [line.strip() for line in log.read_text().splitlines()
            if "registers" in line or "spill" in line
            or "Performance Loss" in line]
