"""The port's native host I/O library (``cavmd_tpu_torch/io/native.py`` over
``csrc/cavmd_native.cc``) against the JAX package's
(``cavmd_tpu/io/native.py``) and against the Python formatting:

- the GSD writer writes the bytes of JAX's ``NativeGSDWriter`` for the same
  frames, and the port's Python ``GSDFile`` reads them back;
- ``format_table`` gives the bytes of the Python formatting on the JAX
  test's cases (tests/test_native.py:58-80), and ``EnergyTracker`` writes
  the same file with and without the library;
- two processes that build into one empty build directory at once both
  load the library (the build renames into place).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu.core import make_diatomic_system as j_make_diatomic_system
from cavmd_tpu.io import HOOMDTrajectory as JHOOMDTrajectory
from cavmd_tpu.io import native as j_native
from cavmd_tpu_torch.io import HOOMDTrajectory, native, open_gsd
from cavmd_tpu_torch.io.gsd import GSDFile
from cavmd_tpu_torch.observe import EnergyTracker

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def lib():
    """The library; this machine has g++, so it must load."""
    out = native.load()
    assert out is not None
    return out


def _python_table(data):
    """The trackers' Python formatting (the JAX package's fallback)."""
    return "".join(" ".join(str(int(v)) if j == 1 else f"{v:.6f}"
                            for j, v in enumerate(row)) + "\n"
                   for row in data)


def test_format_table_matches_python(lib):
    data = np.array([[0.123456789, 42.0, -1.5], [2.0, 100.0, 3.25]])
    assert native.format_table(data, decimals=6, int_col=1) == \
        "0.123457 42 -1.500000\n2.000000 100 3.250000\n"
    rng = np.random.default_rng(0)
    data = rng.normal(size=(50, 20))
    data[:, 1] = np.arange(50)
    text = native.format_table(data, decimals=6, int_col=1)
    assert text == _python_table(data)
    if j_native.load() is not None:
        assert text == j_native.format_table(data, decimals=6, int_col=1)


def _energy_chunks(n_chunks=3, rows=40, seed=1):
    """Observable chunks of the energy audit's keys, seeded, with
    timesteps counting on across chunks."""
    rng = np.random.default_rng(seed)
    keys = ("harmonic", "lj", "ewald_short", "ewald_long",
            "cavity_harmonic", "cavity_coupling", "cavity_dipole_self",
            "kinetic_molecular", "kinetic_cavity",
            "bussi_reservoir_molecular", "bussi_reservoir_cavity",
            "langevin_reservoir_molecular", "langevin_reservoir_cavity")
    out = []
    for c in range(n_chunks):
        o = {k: rng.normal(scale=10.0, size=rows) for k in keys}
        o["timestep"] = np.arange(c * rows + 1, (c + 1) * rows + 1)
        o["time_au"] = o["timestep"] * 10.3
        out.append(o)
    return out


def test_energy_tracker_writes_the_same_bytes_without_the_library(
        lib, tmp_path, monkeypatch):
    for side in ("native", "python"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        if side == "python":
            monkeypatch.setattr(native, "load", lambda: None)
        tr = EnergyTracker(output_prefix="prod-1", output_period_steps=3,
                           n_molecular_dof=60)
        for o in _energy_chunks():
            tr.consume(o)
    got, want = (tmp_path / s / "prod-1_energy_tracker.txt"
                 for s in ("native", "python"))
    assert got.read_bytes() == want.read_bytes()
    assert len(want.read_text().splitlines()) > 30


def _write_frames(traj, snaps):
    for k, s in enumerate(snaps):
        traj.append(s, step=7 * k, dtype=np.float64,
                    log_data={"md/time_ps": 0.5 * k, "md/dt_au": 4.1})


def test_gsd_writer_matches_the_jax_native_writer(lib, tmp_path):
    """The same two frames (the JAX scene, its second frame shifted)
    through both packages' native writers, under one application name:
    equal bytes; the port's Python reader gets the frames back."""
    jsnap = j_make_diatomic_system(8, box_L=18.0, seed=2)
    dtype = torch.from_numpy(np.asarray(jsnap.position)).dtype
    tsnap = pt.make_diatomic_system(8, box_L=18.0, seed=2, dtype=dtype,
                                    device="cpu")
    for k in ("position", "velocity", "mass", "charge", "diameter"):
        np.testing.assert_array_equal(getattr(tsnap, k).numpy(),
                                      np.asarray(getattr(jsnap, k)))
    paths = [str(tmp_path / "t.gsd"), str(tmp_path / "j.gsd")]
    t = HOOMDTrajectory(paths[0], "w", prefer_native=True)
    assert isinstance(t.file, native.NativeGSDWriter)
    with t:
        _write_frames(t, [tsnap, tsnap.replace(position=tsnap.position
                                               + 1.0)])
    if j_native.load() is None:  # its in-place build raced (ROADMAP.md)
        pytest.skip("the JAX package's native library did not load")
    # JAX's frame writer over JAX's native codec, under the port's name
    j = JHOOMDTrajectory(paths[1], "w", prefer_native=False)
    j.file.close()
    j.file = j_native.NativeGSDWriter(paths[1],
                                      application="cavmd_tpu_torch")
    _write_frames(j, [jsnap, jsnap.replace(position=jsnap.position + 1.0)])
    j.close()
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
    with open_gsd(paths[0]) as r:
        assert len(r) == 2 and r.file.application == "cavmd_tpu_torch"
        f1 = r.read_frame(1, device="cpu")
        np.testing.assert_array_equal(f1.position.numpy(),
                                      np.asarray(jsnap.position) + 1.0)
        assert f1.types == tsnap.types
        assert float(r.read_log(1, "md/time_ps")[0]) == 0.5


def test_native_and_python_gsd_writers_write_the_same_bytes(lib, tmp_path):
    snap = pt.make_diatomic_system(5, box_L=16.0, seed=3,
                                   dtype=torch.float64, device="cpu")
    paths = [str(tmp_path / "n.gsd"), str(tmp_path / "p.gsd")]
    for path, prefer in zip(paths, (True, False)):
        with HOOMDTrajectory(path, "w", prefer_native=prefer) as t:
            assert isinstance(t.file, native.NativeGSDWriter
                              if prefer else GSDFile)
            _write_frames(t, [snap] * 3)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two fresh processes point the loader at one empty build directory
    and load at once: both get a working library, the directory holds the
    one hashed library and no temporary file."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from cavmd_tpu_torch.io import native\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "lib = native.load()\n"
        "assert lib is not None\n"
        "import numpy as np\n"
        "assert native.format_table(np.ones((1, 2))) == '1.000000 1\\n'\n"
        "print(native.library_path().name)\n")
    build = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(os.listdir(build)) == sorted(names)
