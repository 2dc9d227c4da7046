"""Build and load the hand-written CUDA kernels of ``cavmd_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a shared
library under ``cavmd_tpu_torch/_build/`` (listed in ``.gitignore``), named
by a hash of its source and flags so an edited source is rebuilt. The
library is loaded with ``ctypes``; the hash also covers the shared headers
``csrc/*.cuh``. Every C entry point returns the
``cudaError_t`` of its launch (``cudaGetLastError()``); :func:`check` raises
on a non-zero code. Nothing here runs at import time.

Launch counts: each kernel wrapper calls :func:`count_launch` right after a
successful launch, and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict = {}
_lock = threading.Lock()
launches: collections.Counter = collections.Counter()
build_log: dict = {}  # source name -> nvcc stderr (ptxas register report)


def count_launch(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``, or
    ``nvcc`` on PATH. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of cavmd_tpu_torch are built "
            "with the CUDA toolkit at first use on a CUDA device")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (if not already built) and return the
    path of its shared library."""
    src = CSRC / f"{name}.cu"
    flags = ARCH_FLAGS + NVCC_FLAGS
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # the shared headers
        digest.update(header.read_bytes())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {src} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    build_log[name] = proc.stderr
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (once) and load ``csrc/<name>.cu``; ``signatures`` maps each C
    entry point to its ``argtypes``. Every entry returns an int error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {code}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
