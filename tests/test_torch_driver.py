"""The port's FIRE minimizer and advanced_run CLI against the JAX
package's (CPU): FIRE to 1e-9 bohr in float64, and the CLI's files,
headers, columns and timestep column against the JAX CLI on the
arguments of tests/test_driver.py, plus the flags that are not ported."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from cavmd_tpu.core import make_diatomic_system as j_make
from cavmd_tpu.drivers import advanced_run as j_cli
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.utils import fire_minimize as j_fire
from cavmd_tpu_torch.drivers import advanced_run as t_cli
from cavmd_tpu_torch.utils import fire_minimize as t_fire

from test_torch_ops import port_forcefield

CLI_ARGS = [
    "--runtime", "0.02", "--device", "CPU", "--n-molecules", "20",
    "--enable-energy-tracker", "--enable-fkt",
    "--fkt-wavevectors", "10", "--fkt-ref-interval", "0.005",
    "--energy-output-period-ps", "0.001",
    "--fkt-output-period-ps", "0.001",
    "--gsd-output-period-ps", "0.01",
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_fire_minimize_matches_jax():
    """300 FIRE steps (the driver's call) on 12 molecules, float64. Both
    sides take the same branches (the FIRE power test is far from 0 at
    every step here), so the positions agree to the rounding of the force
    sums: 1e-9 bohr."""
    js = j_make(12, box_L=16.0, seed=4)
    jff = JForceField.create(js, enable_cavity=False)
    j_out = j_fire(js, jff, n_steps=300)
    from cavmd_tpu_torch.core import make_diatomic_system as t_make

    ts = t_make(12, box_L=16.0, seed=4, device="cpu")
    t_out = t_fire(ts, port_forcefield(jff, js), n_steps=300)
    moved = np.abs(np.asarray(j_out.position) - np.asarray(js.position))
    assert moved.max() > 1e-3  # the minimizer did move the scene
    np.testing.assert_allclose(t_out.position.numpy(),
                               np.asarray(j_out.position), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(t_out.image.numpy(),
                                  np.asarray(j_out.image))


def _run(main, path, extra):
    cwd = os.getcwd()
    os.makedirs(path)
    os.chdir(path)
    try:
        assert main(CLI_ARGS + extra) == 0
    finally:
        os.chdir(cwd)
    out = os.path.join(path, "cavity_coupling_1eneg03")
    return out, sorted(os.listdir(out))


def _split(path):
    """(header lines, data rows as float arrays) of one text output."""
    head, rows = [], []
    for line in open(path):
        if line.startswith("#") or line.startswith("time"):
            head.append(line)
        else:
            rows.append([float(x) for x in line.split()])
    return head, rows


@pytest.mark.parametrize("fixed", [False, True])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, fixed):
    """Same file set, header lines and column counts as the JAX CLI; under
    --fixed-timestep also the same timestep column. On the arguments of
    tests/test_driver.py (adaptive dt) the port's universe column (18)
    stays within that test's 1e-4 Ha of its first row; the fixed 1 fs step
    is too coarse for that bound in either package (the JAX CLI drifts
    6.61e-4 Ha), so there it gets 3x the JAX reading. Values are not
    compared across the CLIs: their thermostat streams differ by
    design."""
    monkeypatch.setenv("CAVMD_JIT_CACHE", "0")
    extra = ["--fixed-timestep"] if fixed else []
    j_out, j_files = _run(j_cli.main, str(tmp_path / "jax"), extra)
    t_out, t_files = _run(t_cli.main, str(tmp_path / "torch"), extra)
    assert t_files == j_files
    assert {"prod-1_energy_tracker.txt", "prod-1_cavity_mode.txt",
            "prod-1.gsd", "prod-1_ref0.txt",
            "dipole_autocorr_0.txt"} <= set(t_files)
    assert os.path.exists(tmp_path / "torch" / "init-0.gsd")
    for f in t_files:
        if not f.endswith(".txt"):
            continue
        jh, jr = _split(os.path.join(j_out, f))
        th, tr = _split(os.path.join(t_out, f))
        if not fixed:
            # an F(k,t) reference starts at a time that follows the
            # trajectory's own adaptive dt
            th, jh = ([re.sub(r"at t=\S+ ps", "at t=<t> ps", h) for h in hs]
                      for hs in (th, jh))
        assert th == jh, f
        assert {len(r) for r in tr} == {len(r) for r in jr}, f
        if fixed:
            np.testing.assert_array_equal(
                [r[1 if "energy" in f else 0] for r in tr],
                [r[1 if "energy" in f else 0] for r in jr], err_msg=f)
    _, rows = _split(os.path.join(t_out, "prod-1_energy_tracker.txt"))
    uni = np.array(rows)[:, 18]
    assert len(uni) >= 10
    # adaptive dt (the arguments of tests/test_driver.py): that test's
    # bound; fixed 1 fs: 3x the JAX CLI's own 6.61e-4 Ha on these arguments
    assert np.abs(uni - uni[0]).max() < (2e-3 if fixed else 1e-4)
    from cavmd_tpu.io import open_gsd as j_open

    with j_open(os.path.join(t_out, "prod-1.gsd")) as t:
        assert t[-1].N == 41 and len(t) >= 2


def test_pad_atoms_matches_jax_cli(tmp_path, monkeypatch):
    """``--pad-atoms 8`` (41 -> 48 rows, unsharded) in the form of
    ``test_cli_matches_jax_cli``: the same file set, header lines and
    column counts as the JAX CLI's ``--pad-atoms 8`` run (the thermostat
    streams differ by design, so values are not compared across the
    CLIs); its GSD frames hold the 41 real rows and no ghost type; and in
    float64 with a fixed 0.5 fs step its trajectory equals the port's
    unpadded run from the same input scene (the ghosts are inert and take
    no draw): the energy, cavity-mode and dipole rows and the frames to
    1e-10. The F(k,t) rows are not held: rho(k) sums every row, ghosts
    too, in both packages."""
    monkeypatch.setenv("CAVMD_JIT_CACHE", "0")
    short = ["--fixed-timestep", "--runtime", "0.01", "--pad-atoms", "8"]
    t_out, t_files = _run(t_cli.main, str(tmp_path / "torch"), short)
    # every other run starts from this run's minimised scene
    start = ["--input-gsd", str(tmp_path / "torch" / "init-0.gsd")]
    j_out, j_files = _run(j_cli.main, str(tmp_path / "jax"), short + start)
    assert t_files == j_files
    for f in t_files:
        if f.endswith(".txt"):
            th, tr = _split(os.path.join(t_out, f))
            jh, jr = _split(os.path.join(j_out, f))
            assert th == jh, f
            assert {len(r) for r in tr} == {len(r) for r in jr}, f
    from cavmd_tpu_torch.io import open_gsd

    with open_gsd(os.path.join(t_out, "prod-1.gsd")) as t:
        assert len(t) >= 2
        for k in range(len(t)):
            frame = t.read_frame(k, device="cpu")
            assert frame.N == 41 and "__ghost__" not in frame.types

    fixed = ["--fixed-timestep", "--timestep", "0.5", "--precision", "f64",
             "--runtime", "0.005"] + start
    outs = [_run(t_cli.main, str(tmp_path / side), fixed + extra)
            for side, extra in (("f64", []),
                                ("f64_pad", ["--pad-atoms", "8"]))]
    assert outs[0][1] == outs[1][1]
    for f in outs[0][1]:
        a, b = (os.path.join(out, f) for out, _ in outs)
        if f.endswith(".txt") and "_ref" not in f:
            (ah, ar), (bh, br) = _split(a), _split(b)
            assert ah == bh and len(ar) == len(br) >= 2, f
            np.testing.assert_allclose(br, ar, rtol=1e-10, atol=1e-10,
                                       err_msg=f)
        elif f.endswith(".gsd"):
            with open_gsd(a) as ga, open_gsd(b) as gb:
                assert len(ga) == len(gb) >= 2
                for k in range(len(ga)):
                    np.testing.assert_allclose(
                        gb.read_frame(k, device="cpu").position.numpy(),
                        ga.read_frame(k, device="cpu").position.numpy(),
                        rtol=0, atol=1e-10)


# --rng-impl has no port; the slabs (alone or with a replica batch) run on
# ranks, and without a process group of the right size here they exit 2,
# naming the JAX driver's one-process GSPMD mesh, which is not taken
@pytest.mark.parametrize("flag", [
    ["--vmap-replicas", "--shard-atoms", "2"],
    ["--shard-replicas", "2", "--shard-atoms", "2", "--replicas", "1-2"],
    ["--shard-atoms", "2"], ["--rng-impl", "threefry"]])
def test_unported_flags_exit_nonzero(tmp_path, monkeypatch, capsys, flag):
    monkeypatch.chdir(tmp_path)
    assert t_cli.main(["--device", "CPU"] + flag) == 2
    err = capsys.readouterr().err
    assert flag[0] in err and "ROADMAP.md" in err
    assert os.listdir(tmp_path) == []  # nothing ran


def test_gpu_device_without_cuda_fails(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["--runtime", "0.001", "--n-molecules", "4"]) != 0
    assert t_cli.main(["--device", "GPU", "--runtime", "0.001",
                       "--n-molecules", "4"]) != 0
    assert not os.path.exists(tmp_path / "init-0.gsd")


def test_parser_defaults_and_helpers():
    p = t_cli.build_parser()
    a = p.parse_args([])
    j = j_cli.build_parser().parse_args([])
    for name in vars(j):
        if name != "device":
            assert getattr(a, name) == getattr(j, name), name
    assert a.device == "GPU"
    for spec in ("1-3", "1,3,5", "2-3,1", None):
        assert t_cli.parse_replicas(spec) == j_cli.parse_replicas(spec)
    for argv in ([], ["--n-molecules", "2000"], ["--box-L", "50.0"]):
        assert t_cli.resolved_box(p.parse_args(argv)) == \
            j_cli.resolved_box(j_cli.build_parser().parse_args(argv))
    assert jax.devices()[0].platform == "cpu"
