"""Build the CUDA sources under ``src/repro_torch/csrc`` with ``nvcc`` and
load them with ``ctypes`` (a plain C interface: pointers and the stream
as ``c_void_p``, sizes as ``c_int``).

Each source becomes its own shared library in ``build/torch_kernels/`` at
the repository root, named by a hash of the source, every header under
``csrc/`` (``*.cuh``, which the sources include) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. All
missing libraries are compiled at once, one ``nvcc`` process per source started
together. Nothing here runs at import: the first kernel launch (or
``build_all``) triggers the build, so CPU-only hosts never need ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "torch_kernels"
SOURCES = ("bspmm.cu", "bspmm_t.cu", "paged_attention.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def library_path(source: str, csrc: Path = CSRC) -> Path:
    h = hashlib.sha256((csrc / source).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    {source: library path}. Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in SOURCES}
    todo = {s: p for s, p in paths.items() if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        procs = {}
        for s, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
            procs[s] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for s, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{s}:\n{out}")
            else:
                os.replace(tmp, paths[s])
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return paths


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use)."""
    if source not in _loaded:
        path = build_all()[source]
        _loaded[source] = ctypes.CDLL(str(path))
    return _loaded[source]
