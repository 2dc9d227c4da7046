"""ctypes loader for the port's native host I/O library.

Port of ``cavmd_tpu/io/native.py``. ``csrc/cavmd_native.cc`` (the port's
own copy of the JAX package's ``native/cavmd_native.cc``) is compiled with
``g++ -O3 -fPIC -std=c++17 -shared`` at first use into
``cavmd_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
hashed from the source and the flags. The compiler writes a temporary
file of its own (process and thread in its name), which ``os.replace``
then moves into place, as ``ops/_cuda.py`` does for the kernels: processes
that build at once (test workers, ranks) each load a whole library,
whoever renames last. The JAX loader compiles straight to its final path
and races there (``ROADMAP.md`` Queue 3).

Two consumers: :class:`NativeGSDWriter` (``io/gsd.py``'s
``HOOMDTrajectory`` in write mode with ``prefer_native=True``) and
:func:`format_table` (``observe/trackers.py``'s ``EnergyTracker``). Both write the bytes of
their Python counterparts. They fall back to Python only where there is
no ``g++`` (``load`` returns None); a library that fails to build or load
with a compiler present raises. This is host I/O: nothing here touches
the device. Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cavmd_native.cc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_TYPE_IDS = {
    np.dtype(np.uint8): 1, np.dtype(np.uint16): 2, np.dtype(np.uint32): 3,
    np.dtype(np.uint64): 4, np.dtype(np.int8): 5, np.dtype(np.int16): 6,
    np.dtype(np.int32): 7, np.dtype(np.int64): 8, np.dtype(np.float32): 9,
    np.dtype(np.float64): 10,
}
_SIGNATURES = {
    "cavmd_gsd_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_char_p, ctypes.c_uint32]),
    "cavmd_gsd_write_chunk": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint8, ctypes.c_uint64]),
    "cavmd_gsd_end_frame": (ctypes.c_int, [ctypes.c_void_p]),
    "cavmd_gsd_nframes": (ctypes.c_uint64, [ctypes.c_void_p]),
    "cavmd_gsd_close": (None, [ctypes.c_void_p]),
    "cavmd_format_table": (ctypes.c_long, [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_long]),
}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libcavmd_native_{digest.hexdigest()[:12]}.so"


def build(compiler: str) -> Path:
    """Compile the library with ``compiler`` unless it is built; returns
    its path. Raises ``RuntimeError`` when the compiler fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([compiler, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE} (rc {proc.returncode})"
                           f":\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load():
    """The native library, built at first use; None when it is not built
    and there is no ``g++`` (the callers then format in Python)."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                compiler = shutil.which("g++")
                if compiler is None:
                    return None
                path = build(compiler)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


class NativeGSDWriter:
    """Write-only GSD file through the C++ codec: the file
    :class:`cavmd_tpu_torch.io.gsd.GSDFile` writes, byte for byte, with the
    frame interface ``HOOMDTrajectory`` uses. Raises ``RuntimeError`` when
    there is no library (no ``g++``)."""

    def __init__(self, path, application="cavmd_tpu_torch", schema="hoomd",
                 schema_version=(1, 4)):
        lib = load()
        if lib is None:
            raise RuntimeError("the native I/O library needs g++, and "
                               "there is none")
        self._lib = lib
        ver = (schema_version[0] << 16) | schema_version[1]
        self._h = lib.cavmd_gsd_open(os.fsencode(path), application.encode(),
                                     schema.encode(), ver)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write_chunk(self, name: str, data):
        data = np.ascontiguousarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError("chunks must be 1D or 2D")
        tid = _TYPE_IDS.get(data.dtype)
        if tid is None:
            raise TypeError(f"no GSD type for {data.dtype}")
        rc = self._lib.cavmd_gsd_write_chunk(
            self._h, name.encode(), data.ctypes.data_as(ctypes.c_void_p),
            data.shape[0], data.shape[1], tid, data.dtype.itemsize)
        if rc != 0:
            raise OSError(f"native GSD write of {name} failed ({rc})")

    def begin_frame(self):
        pass

    def end_frame(self):
        if self._lib.cavmd_gsd_end_frame(self._h) != 0:
            raise OSError("native GSD end of frame failed")

    @property
    def nframes(self) -> int:
        return int(self._lib.cavmd_gsd_nframes(self._h))

    def close(self):
        if self._h:
            self._lib.cavmd_gsd_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def format_table(data, decimals=6, int_col=1):
    """A 2-D float array as text, one row a line, values space-separated
    in ``%.{decimals}f`` and column ``int_col`` as an integer: the bytes of
    the trackers' Python formatting. None when there is no library (the
    caller formats in Python) or the buffer was too small."""
    lib = load()
    if lib is None:
        return None
    arr = np.ascontiguousarray(data, dtype=np.float64)
    nrows, ncols = arr.shape
    cap = nrows * ncols * 32 + nrows + 64
    buf = ctypes.create_string_buffer(cap)
    n = lib.cavmd_format_table(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), nrows, ncols,
        decimals, int_col, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode()
