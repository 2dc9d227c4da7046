"""GSD trajectory I/O: a codec for the GSD v1 file format with the HOOMD
schema.

Port of ``cavmd_tpu/io/gsd.py`` (the port's own copy; NumPy on the host):
the same on-disk format, so files move between the two packages. Frames
are read into port ``Snapshot``s on the requested device and written from
snapshots on any device. In write mode ``HOOMDTrajectory`` writes in
Python unless given ``prefer_native=True``: then through the C++ codec of
``io/native.py`` (the same bytes; Python without ``g++``). The JAX package
prefers the codec; here it is opt-in, as it wrote an N = 100,001 frame
slower than Python on the card's host (``PERF.md``).

File layout (GSD v1):
  header(256B): magic, index_location, index_allocated_entries,
    namelist_location, namelist_allocated_entries, schema_version,
    gsd_version, application[64], schema[64], reserved[80]
  index: 32B entries (frame u64, N u64, location i64, M u32, id u16,
    type u8, flags u8), sorted by (frame, id); location 0 = unused
  namelist: 64B zero-padded names
  data: raw arrays
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np
import torch

MAGIC = 0x65DF65DF65DF65DF
GSD_VERSION = (1 << 16) | 0  # 1.0
HEADER_FMT = "<QQQQQII64s64s80s"
HEADER_SIZE = struct.calcsize(HEADER_FMT)
INDEX_FMT = "<QQqIHBB"
INDEX_SIZE = struct.calcsize(INDEX_FMT)
NAME_SIZE = 64

_TYPES = {
    1: np.uint8, 2: np.uint16, 3: np.uint32, 4: np.uint64,
    5: np.int8, 6: np.int16, 7: np.int32, 8: np.int64,
    9: np.float32, 10: np.float64,
}
_TYPE_IDS = {np.dtype(v): k for k, v in _TYPES.items()}

assert HEADER_SIZE == 256


class GSDFile:
    """Low-level chunked frame store (the ``gsd.fl`` layer)."""

    def __init__(self, path, mode="r", application="cavmd_tpu_torch", schema="hoomd",
                 schema_version=(1, 4)):
        self.path = path
        self.mode = mode
        self._names: list[str] = []
        self._name_to_id: dict[str, int] = {}
        self._index: list[tuple] = []  # (frame, N, location, M, id, type, flags)
        self._lookup: dict[tuple, tuple] = {}  # (frame, name_id) -> entry
        self._pending: list[tuple] = []
        self._nframes = 0
        self._index_location = 0
        self._index_capacity = 0
        self._names_location = 0
        self._names_capacity = 0
        if mode == "r" or (mode == "a" and os.path.exists(path)):
            self._f = open(path, "r+b" if mode == "a" else "rb")
            self._read_metadata()
        elif mode in ("w", "a"):
            self._f = open(path, "w+b")
            self.application = application
            self.schema = schema
            self.schema_version = (schema_version[0] << 16) | schema_version[1]
            self._f.write(b"\0" * HEADER_SIZE)
            self._allocate_regions(index_capacity=256, names_capacity=64)
        else:
            raise ValueError(f"bad mode {mode}")

    # -------------------------------------------------------------- metadata
    def _read_metadata(self):
        self._f.seek(0)
        raw = self._f.read(HEADER_SIZE)
        (magic, index_loc, index_n, name_loc, name_n, schema_version,
         gsd_version, app, schema, _res) = struct.unpack(HEADER_FMT, raw)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: not a GSD file (bad magic)")
        self._index_location = index_loc
        self._index_capacity = index_n
        self._names_location = name_loc
        self._names_capacity = name_n
        self.application = app.rstrip(b"\0").decode()
        self.schema = schema.rstrip(b"\0").decode()
        self.schema_version = schema_version
        self._f.seek(name_loc)
        names_raw = self._f.read(name_n * NAME_SIZE)
        self._names = []
        for i in range(name_n):
            nm = names_raw[i * NAME_SIZE:(i + 1) * NAME_SIZE].rstrip(b"\0")
            if nm:
                self._names.append(nm.decode())
        self._name_to_id = {n: i for i, n in enumerate(self._names)}
        self._f.seek(index_loc)
        idx_raw = self._f.read(index_n * INDEX_SIZE)
        self._index = []
        for i in range(index_n):
            entry = struct.unpack_from(INDEX_FMT, idx_raw, i * INDEX_SIZE)
            if entry[2] != 0:  # location 0 = unused slot
                self._index.append(entry)
        # O(1) chunk lookup keyed by (frame, name_id) — a linear index scan
        # per read is O(frames^2 * chunks) over a long trajectory
        self._lookup = {(e[0], e[4]): e for e in self._index}
        self._nframes = (max(e[0] for e in self._index) + 1) if self._index else 0

    def _write_header(self):
        header = struct.pack(
            HEADER_FMT, MAGIC, self._index_location, self._index_capacity,
            self._names_location, self._names_capacity,
            self.schema_version, GSD_VERSION,
            self.application.encode()[:64].ljust(64, b"\0"),
            self.schema.encode()[:64].ljust(64, b"\0"), b"\0" * 80,
        )
        self._f.seek(0)
        self._f.write(header)
        self._f.flush()

    def _allocate_regions(self, index_capacity, names_capacity):
        """Reserve zero-filled index and namelist regions at EOF.

        Entries are later written *in place* (the index grows append-only:
        sorted by (frame, id) with monotonically increasing frames), so
        metadata cost is O(frames), not O(frames^2). Readers skip the
        zero-filled slack (location == 0 / empty name).
        """
        f = self._f
        f.seek(0, os.SEEK_END)
        self._index_location = f.tell()
        self._index_capacity = index_capacity
        f.write(b"\0" * (INDEX_SIZE * index_capacity))
        self._names_location = f.tell()
        self._names_capacity = names_capacity
        f.write(b"\0" * (NAME_SIZE * names_capacity))
        # write any existing entries into the fresh regions
        f.seek(self._index_location)
        for e in sorted(self._index, key=lambda e: (e[0], e[4])):
            f.write(struct.pack(INDEX_FMT, *e))
        f.seek(self._names_location)
        for n in self._names:
            f.write(n.encode().ljust(NAME_SIZE, b"\0")[:NAME_SIZE])
        self._write_header()

    def _write_metadata(self):
        """Persist new index entries / names, growing regions as needed.

        The index is kept sorted by (frame, id): frames only grow, and each
        frame's entries are sorted by id before appending, so new entries
        always extend the tail — written in place, O(entries/frame) each.
        """
        if (
            len(self._index) > self._index_capacity
            or len(self._names) > self._names_capacity
        ):
            self._allocate_regions(
                index_capacity=max(self._index_capacity * 2, len(self._index)),
                names_capacity=max(self._names_capacity * 2, len(self._names)),
            )
            self._meta_written = (len(self._index), len(self._names))
            return
        f = self._f
        idx_written, names_written = getattr(
            self, "_meta_written", (0, 0)
        )
        f.seek(self._index_location + idx_written * INDEX_SIZE)
        for e in self._index[idx_written:]:
            f.write(struct.pack(INDEX_FMT, *e))
        f.seek(self._names_location + names_written * NAME_SIZE)
        for n in self._names[names_written:]:
            f.write(n.encode().ljust(NAME_SIZE, b"\0")[:NAME_SIZE])
        self._meta_written = (len(self._index), len(self._names))
        f.flush()

    # ------------------------------------------------------------------- api
    @property
    def nframes(self) -> int:
        return self._nframes

    def __len__(self):
        return self._nframes

    def write_chunk(self, name: str, data: np.ndarray):
        data = np.ascontiguousarray(data)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError("chunks must be 1D or 2D")
        if name not in self._name_to_id:
            self._name_to_id[name] = len(self._names)
            self._names.append(name)
        self._f.seek(0, os.SEEK_END)
        loc = self._f.tell()
        self._f.write(data.tobytes())
        self._pending.append((
            self._nframes, data.shape[0], loc, data.shape[1],
            self._name_to_id[name], _TYPE_IDS[data.dtype], 0,
        ))

    def end_frame(self):
        # keep (frame, id) global ordering: frames grow monotonically and
        # each frame's entries are id-sorted
        new = sorted(self._pending, key=lambda e: e[4])
        self._index.extend(new)
        self._lookup.update({(e[0], e[4]): e for e in new})
        self._pending = []
        self._nframes += 1
        self._write_metadata()

    def begin_frame(self):
        self._pending = []

    def chunk_exists(self, frame: int, name: str) -> bool:
        nid = self._name_to_id.get(name)
        return nid is not None and (frame, nid) in self._lookup

    def read_chunk(self, frame: int, name: str) -> Optional[np.ndarray]:
        nid = self._name_to_id.get(name)
        if nid is None:
            return None
        e = self._lookup.get((frame, nid))
        if e is None:
            return None
        _, n, loc, m, _, tid, _ = e
        dtype = _TYPES[tid]
        self._f.seek(loc)
        raw = self._f.read(n * m * np.dtype(dtype).itemsize)
        arr = np.frombuffer(raw, dtype=dtype).reshape(n, m)
        return arr[:, 0] if m == 1 else arr

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _encode_types(types) -> np.ndarray:
    """Type names as an (n, max_len+1) int8 array (HOOMD schema convention)."""
    if not types:
        types = ("A",)
    width = max(len(t) for t in types) + 1
    out = np.zeros((len(types), width), dtype=np.int8)
    for i, t in enumerate(types):
        b = t.encode()
        out[i, : len(b)] = np.frombuffer(b, dtype=np.int8)
    return out


def _decode_types(arr) -> tuple:
    if arr is None:
        return ("A",)
    arr = np.atleast_2d(np.asarray(arr, dtype=np.int8))
    return tuple(
        bytes(row[row != 0].astype(np.uint8)).decode() for row in arr
    )


class HOOMDTrajectory:
    """Frame-level reader/writer mapping Snapshot <-> HOOMD-schema chunks.

    Mirrors ``gsd.hoomd.open`` usage in the reference driver
    (05_advanced_run.py:404-419): indexing by frame (negative indices OK),
    frame-0 default inheritance for static chunks.
    """

    def __init__(self, path, mode="r", prefer_native=False):
        self.file = None
        if mode == "w" and prefer_native:
            # the C++ codec (same bytes), opt-in: it wrote an N = 100,001
            # frame slower than the Python writer (PERF.md, phase 14c of
            # chip_smoke.py); Python without g++
            from cavmd_tpu_torch.io.native import NativeGSDWriter, load

            if load() is not None:
                self.file = NativeGSDWriter(path)
        if self.file is None:
            self.file = GSDFile(path, mode)

    def __len__(self):
        return self.file.nframes

    def close(self):
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # ----------------------------------------------------------------- write
    def append(self, snapshot, *, step: int = 0, dtype=np.float32,
               log_data=None):
        """Write one frame from a Snapshot.

        ``log_data``: optional {name: scalar/array} written as ``log/<name>``
        chunks — parity with HOOMD's GSD-embedded logger data
        (``gsd_writer.logger``, reference 05_advanced_run.py:1239).
        """
        f = self.file
        f.begin_frame()
        if log_data:
            for name, value in log_data.items():
                arr = np.atleast_1d(np.asarray(value, np.float64))
                f.write_chunk(f"log/{name}", arr)
        n = snapshot.N
        box = _np(snapshot.box_L).astype(np.float32)
        f.write_chunk("configuration/step", np.asarray([step], np.uint64))
        f.write_chunk("configuration/dimensions", np.asarray([3], np.uint8))
        f.write_chunk(
            "configuration/box",
            np.asarray([box[0], box[1], box[2], 0, 0, 0], np.float32),
        )
        f.write_chunk("particles/N", np.asarray([n], np.uint32))
        f.write_chunk("particles/types", _encode_types(snapshot.types))
        f.write_chunk("particles/typeid", np.asarray(_np(snapshot.typeid), np.uint32))
        f.write_chunk("particles/position", np.asarray(_np(snapshot.position), dtype))
        f.write_chunk("particles/velocity", np.asarray(_np(snapshot.velocity), dtype))
        f.write_chunk("particles/image", np.asarray(_np(snapshot.image), np.int32))
        f.write_chunk("particles/mass", np.asarray(_np(snapshot.mass), dtype))
        f.write_chunk("particles/charge", np.asarray(_np(snapshot.charge), dtype))
        f.write_chunk("particles/diameter", np.asarray(_np(snapshot.diameter), dtype))
        nb = snapshot.n_bonds
        f.write_chunk("bonds/N", np.asarray([nb], np.uint32))
        if nb:
            f.write_chunk("bonds/types", _encode_types(snapshot.bond_types))
            f.write_chunk("bonds/typeid", np.asarray(_np(snapshot.bond_typeid), np.uint32))
            f.write_chunk("bonds/group", np.asarray(_np(snapshot.bond_group), np.uint32))
        f.end_frame()

    # ------------------------------------------------------------------ read
    def _chunk(self, frame, name, default=None):
        """Read with frame-0 fallback (GSD default inheritance)."""
        v = self.file.read_chunk(frame, name)
        if v is None and frame != 0:
            v = self.file.read_chunk(0, name)
        return default if v is None else v

    def read_frame(self, frame: int, dtype=None, device=None):
        """Read one frame into a Snapshot (negative indices allowed) on
        ``device`` (None: the CUDA device)."""
        from cavmd_tpu_torch.core.device import resolve_device
        from cavmd_tpu_torch.core.snapshot import Snapshot

        nf = len(self)
        if nf == 0:
            raise IndexError("empty trajectory")
        if frame < 0:
            frame = max(nf + frame, 0)
        if frame >= nf:
            raise IndexError(f"frame {frame} out of range ({nf} frames)")

        n = int(self._chunk(frame, "particles/N")[0])
        box = self._chunk(frame, "configuration/box")
        types = _decode_types(self._chunk(frame, "particles/types"))
        zeros3 = np.zeros((n, 3))
        nb_arr = self._chunk(frame, "bonds/N", np.asarray([0], np.uint32))
        nb = int(nb_arr[0])
        bond_types = (
            _decode_types(self._chunk(frame, "bonds/types")) if nb else ()
        )
        return Snapshot.create(
            position=np.asarray(self._chunk(frame, "particles/position", zeros3)),
            box_L=np.asarray(box[:3], float),
            velocity=np.asarray(self._chunk(frame, "particles/velocity", zeros3)),
            image=np.asarray(self._chunk(frame, "particles/image", zeros3), np.int32),
            mass=np.asarray(self._chunk(frame, "particles/mass", np.ones(n))),
            charge=np.asarray(self._chunk(frame, "particles/charge", np.zeros(n))),
            diameter=np.asarray(self._chunk(frame, "particles/diameter", np.ones(n))),
            typeid=np.asarray(self._chunk(frame, "particles/typeid", np.zeros(n)), np.int32),
            types=types,
            bond_group=(
                np.asarray(self._chunk(frame, "bonds/group"), np.int32)
                if nb else None
            ),
            bond_typeid=(
                np.asarray(self._chunk(frame, "bonds/typeid"), np.int32)
                if nb else None
            ),
            bond_types=bond_types,
            dtype=dtype,
            device=resolve_device(device),
        )

    def __getitem__(self, frame):
        return self.read_frame(frame)

    def read_log(self, frame: int, name: str):
        """Read a ``log/<name>`` chunk written via ``append(log_data=...)``."""
        return self.file.read_chunk(frame, f"log/{name}")


def _np(x):
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def open_gsd(path, mode="r"):
    """Open a HOOMD-schema GSD trajectory (``gsd.hoomd.open`` analog)."""
    return HOOMDTrajectory(path, mode)


def gather_tracker_log(trackers, time_ps, dt_au):
    """Collect the ``log/*`` payload for one GSD frame from a tracker list.

    Parity with the ~30-quantity Logger the reference attaches to its GSD
    writer (05_advanced_run.py:1239-1249): every tracker's ``current`` dict
    plus autocorrelation values, keyed ``<TrackerClass>/<quantity>``. Shared
    by the sequential ``GSDWriter`` and the vmapped-replica driver path.
    """
    log = {"md/time_ps": float(time_ps), "md/dt_au": float(dt_au)}
    for tr in trackers:
        prefix = type(tr).__name__
        cur = getattr(tr, "current", None)
        if isinstance(cur, dict):
            for k, v in cur.items():
                log[f"{prefix}/{k}"] = v
        ca = getattr(tr, "current_autocorr", None)
        if ca is not None:
            log[f"{prefix}/autocorr"] = ca
    return log


class GSDWriter:
    """Periodic trajectory writer (parity: ``hoomd.write.GSD`` attached to
    the reference workflow, 05_advanced_run.py:1231-1249). Writes a frame
    whenever simulated time crosses the output period; append or truncate.

    Each frame embeds ``log/*`` chunks gathered from the simulation's
    trackers (every tracker ``current`` dict plus autocorrelation values) —
    parity with the ~30-quantity Logger the reference attaches to its GSD
    writer (05_advanced_run.py:1239-1249). Disable with
    ``log_trackers=False``."""

    def __init__(self, path, output_period_ps=50.0, truncate=False,
                 dtype=np.float32, log_trackers=True):
        mode = "w" if truncate or not os.path.exists(path) else "a"
        self.traj = HOOMDTrajectory(path, mode)
        self.output_period_ps = output_period_ps
        self.last_output_ps = -1e30
        self.dtype = dtype
        self.log_trackers = log_trackers

    def _gather_log(self, sim):
        return gather_tracker_log(
            getattr(sim, "trackers", ()), sim.elapsed_ps, float(sim.state.dt)
        )

    def write_now(self, sim):
        log = self._gather_log(sim) if self.log_trackers else None
        self.traj.append(
            sim.get_snapshot(), step=sim.timestep, dtype=self.dtype,
            log_data=log,
        )

    def consume(self, obs, sim):
        t_ps = sim.elapsed_ps
        if t_ps - self.last_output_ps >= self.output_period_ps:
            self.write_now(sim)
            self.last_output_ps = t_ps

    def close(self):
        self.traj.close()
