"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` source compiles on its own, with a plain C
interface, into one shared library::

    nvcc -O3 -std=c++17 -shared -Xcompiler -fPIC \
         -gencode arch=compute_90a,code=sm_90a -o lib<name>_<hash>.so <name>.cu

and is loaded with :mod:`ctypes`; no PyTorch headers, no ninja.  The
libraries live in ``build/repro_torch_ext/`` at the repository root (listed
in ``.gitignore``), named by a hash of the source, every shared header
``csrc/*.cuh`` (any source may include any of them) and the flags, so an
edit of either rebuilds.  All sources compile in parallel, one ``nvcc`` each, at the first
CUDA use — never at import.  A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library",
           "build_log", "targets"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _target(src: Path, headers: bytes) -> Path:
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def targets(csrc: Path = CSRC) -> Dict[str, Path]:
    """``{name: shared object}`` of every ``csrc/*.cu``, named by the
    source's, the headers' and the flags' hash."""
    headers = b"".join(h.name.encode() + b"\0" + h.read_bytes()
                       for h in sorted(csrc.glob("*.cuh")))
    return {src.stem: _target(src, headers)
            for src in sorted(csrc.glob("*.cu"))}


def build_all() -> Dict[str, Path]:
    """Compile every stale ``csrc/*.cu`` (one ``nvcc`` per source, all
    started together) and return ``{name: shared object}``.  Raises with
    the compiler's output if any build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = targets()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for src in sources:
        dst = libs[src.stem]
        if dst.is_file():
            continue
        nvcc = nvcc or _nvcc()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, dst, tmp, proc in procs:
        out, _ = proc.communicate()
        _logs[src.stem] = out
        if proc.returncode:
            os.unlink(tmp)
            failures.append(f"{src.name} (exit {proc.returncode}):\n{out}")
        else:
            dst.with_suffix(".log").write_text(out)
            os.replace(tmp, dst)   # atomic: a concurrent build sees whole files
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu`` (building
    every stale source first)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and spill report) of the
    build of ``csrc/<name>.cu``, kept beside the library; empty if none."""
    if name in _logs:
        return _logs[name]
    log = targets()[name].with_suffix(".log")
    return log.read_text() if log.is_file() else ""
