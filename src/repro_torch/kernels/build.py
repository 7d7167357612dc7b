"""Build the CUDA sources under ``src/repro_torch/csrc/`` at first use.

Each ``<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, written to ``build/kernels/`` at
the root of the checkout (listed in .gitignore), and loaded with ctypes.
The sources include no PyTorch headers, so a build takes seconds. Nothing
is fetched: the build reads only the sources in the repository and the
CUDA toolkit (``nvcc`` on PATH, else ``$CUDA_HOME/bin`` or
``/usr/local/cuda/bin``).

A library's file name carries a hash of its source and of ``NVCC_FLAGS``,
so a changed source or flag builds a new library and never loads one built
from another; a build that fails raises with nvcc's output, and no caller
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built on this machine")


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source {src}")
    key = hashlib.sha256(src.read_bytes() + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"lib{name}-{key[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lies (or will)."""
    return _paths(name)[1]


def _start(name: str):
    """Start one nvcc for ``name`` (None when the library is current).
    Returns (process, tmp path, final path, log path)."""
    src, lib = _paths(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    log = BUILD_DIR / f"{name}.log"
    proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, lib, log


def _finish(name: str, job) -> None:
    proc, tmp, lib, log = job
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)       # atomic: a concurrent loader sees old or new


def build_all(names) -> None:
    """Compile several sources at once (one nvcc each, started together)."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(n, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
