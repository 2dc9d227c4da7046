"""The slab domain pipeline on several ranks: 2 and 4 local processes over
gloo (cavmd_tpu_torch.parallel.launch.run_ranks, one spawn per world size
for the whole module), against the port's unsharded Simulation on the
scene of tests/test_domain.py (550 diatomics + photon, 65-bohr box, r_cut
8, float64, Bussi + Langevin, 12 steps in chunks of 6, so two rebuilds at
the default cadence):

- the trajectory matches the unsharded run to 1e-10 over the two chunks
  (tests/test_domain.py:104, :130);
- a plan with a bucket capacity of 2 overflows, grows and retries, and
  matches a run that never overflowed (:179), its cadence untouched;
- Simulation(shard_atoms=2) routes adaptive dt and the dipole / rho(k)
  observables through the slab step (:206, :279);
- MTTK and Berendsen baths at S = 2 match the unsharded run to 1e-10;
- the CLI on 2 ranks (--shard-atoms 2 --device CPU) writes the files,
  headers and columns of the unsharded CLI;
- the CLI on 2 ranks with --pad-atoms 5 and molecular Langevin (the row
  path) pads once, to 90 rows, and writes the one-process --pad-atoms 10
  run's files.

This module imports no JAX: the spawned ranks run functions of the port
(the slab dry run and the CLI's main).
"""

import os

import numpy as np
import pytest
import torch

from cavmd_tpu_torch.drivers import advanced_run
from cavmd_tpu_torch.observe import generate_fibonacci_sphere
from cavmd_tpu_torch.parallel.launch import run_ranks, slab_dryrun

WV = generate_fibonacci_sphere(8) * 1.0
RUNS = {
    "plain": {},
    "overflow": dict(cap=2),
    "observables": dict(error_tolerance=5e-6, wavevectors=WV),
    "mttk": dict(bath="mttk"),
    "berendsen": dict(bath="berendsen"),
}
CLI_ARGS = ["--device", "CPU", "--n-molecules", "40", "--box-L", "64",
            "--runtime", "0.003", "--enable-energy-tracker", "--enable-fkt",
            "--seed", "0", "--energy-output-period-ps", "0.0005"]
# molecular Langevin: the slab plan refuses it, so the run splits rows
ROW_ARGS = CLI_ARGS + ["--molecular-bath", "langevin", "--fixed-timestep",
                       "--timestep", "0.5"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cli_in(directory, argv):
    """``advanced_run.main(argv)`` in ``directory`` (a ``run_ranks`` job,
    the last of its spawn): (exit code, what it printed)."""
    import contextlib
    import io

    os.chdir(directory)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = advanced_run.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def unsharded():
    return {name: slab_dryrun(**kw) for name, kw in RUNS.items()}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every 2-rank job in one spawn: the three dry runs and the CLI (run
    in a fresh directory)."""
    cli_dir = tmp_path_factory.mktemp("cli_2_ranks")
    rows_dir = tmp_path_factory.mktemp("cli_rows_2_ranks")
    cwd = os.getcwd()
    os.chdir(cli_dir)
    try:
        out = run_ranks([(slab_dryrun, kw) for kw in RUNS.values()]
                        + [(advanced_run.main, (CLI_ARGS
                                                + ["--shard-atoms", "2"],)),
                           (_cli_in, (str(rows_dir), ROW_ARGS + [
                               "--pad-atoms", "5", "--shard-atoms", "2"]))],
                        2)
    finally:
        os.chdir(cwd)
    results = dict(zip(RUNS, out[:len(RUNS)]))
    results["cli"] = (cli_dir, out[-2])
    results["cli_rows"] = (rows_dir, out[-1])
    return results


@pytest.fixture(scope="module")
def four_ranks():
    return dict(zip(["plain"], run_ranks([(slab_dryrun, RUNS["plain"])], 4)))


def _matches(ranks, ref, tol=1e-10):
    """Every rank's final state equals the reference to ``tol`` of the
    box, and every observable to 1e-9 of its own scale (the ranks agree
    with each other bit for bit)."""
    for r in ranks:
        np.testing.assert_array_equal(r["position"], ranks[0]["position"])
        np.testing.assert_allclose(r["position"], ref["position"], rtol=0,
                                   atol=tol * 65.0)
        np.testing.assert_allclose(r["velocity"], ref["velocity"], rtol=0,
                                   atol=tol * np.abs(ref["velocity"]).max())
        np.testing.assert_array_equal(r["image"], ref["image"])
        for k in ("mttk_xi", "mttk_eta"):
            np.testing.assert_allclose(
                r[k], ref[k], rtol=0,
                atol=tol * max(np.abs(ref[k]).max(), 1e-300), err_msg=k)
        for k, want in ref["obs"].items():
            np.testing.assert_allclose(
                r["obs"][k], want, rtol=0,
                atol=1e-9 * max(np.abs(want).max(), 1e-12), err_msg=k)
        assert not r["obs"]["cell_overflow"].any()


@pytest.mark.parametrize("S", [2, 4])
def test_trajectory_matches_unsharded(two_ranks, four_ranks, unsharded, S):
    ranks = (two_ranks if S == 2 else four_ranks)["plain"]
    assert len(ranks) == S and ranks[0]["rebuild_every"] == 20
    assert unsharded["plain"]["cap"] is None  # the reference is unsharded
    _matches(ranks, unsharded["plain"])


@pytest.mark.parametrize("bath", ["mttk", "berendsen"])
def test_baths_match_unsharded(two_ranks, unsharded, bath):
    """MTTK or Berendsen on the molecules at S = 2: the group kinetic
    energies of both halves summed over the ranks; the trajectory and
    (xi, eta) match the unsharded run to 1e-10."""
    ranks = two_ranks[bath]
    _matches(ranks, unsharded[bath])
    if bath == "mttk":
        assert ranks[0]["mttk_xi"][0] != 0.0
    else:
        assert not ranks[0]["mttk_xi"].any()


def test_overflow_grows_the_plan_and_retries(two_ranks, unsharded):
    """Cap 2 overflows at the first rebuild; the retry grows the plan
    (2 -> 6 -> 12) and keeps the cadence, and the run matches the
    unsharded one, which never overflowed."""
    ranks = two_ranks["overflow"]
    assert all(r["cap"] == 12 and r["rebuild_every"] == 20 for r in ranks)
    _matches(ranks, unsharded["overflow"])


def test_simulation_routes_adaptive_dt_and_observables(two_ranks,
                                                        unsharded):
    """Simulation(shard_atoms=2) runs the slab step (a plan exists) with
    adaptive dt and the dipole / rho(k) columns inside it."""
    ranks = two_ranks["observables"]
    assert ranks[0]["cap"] is not None
    ref = unsharded["observables"]
    for k in ("dipole", "rho_k_re", "rho_k_im", "error_tolerance", "dt"):
        assert k in ranks[0]["obs"], k
    assert np.ptp(ref["obs"]["dt"]) > 0  # the controller moved dt
    _matches(ranks, ref)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(
                d, f)
    return out


def _headers_and_columns(path):
    with open(path) as f:
        lines = f.read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")
            and not ln.startswith("# Reference 0 at t=")]
    rows = [ln.split() for ln in lines if ln and not ln.startswith("#")]
    return head, {len(r) for r in rows[1:]}


def test_cli_on_two_ranks_writes_the_unsharded_files(two_ranks, tmp_path,
                                                      monkeypatch):
    """The 2-rank CLI returns 0 on both ranks and writes (rank 0 alone)
    the files of the unsharded CLI with the same headers and column
    counts; its universe energy is conserved as the unsharded run's."""
    cli_dir, rcs = two_ranks["cli"]
    assert rcs == [0, 0]
    monkeypatch.chdir(tmp_path)
    assert advanced_run.main(CLI_ARGS) == 0
    got, want = _tree(cli_dir), _tree(tmp_path)
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith(".txt"):
            assert _headers_and_columns(got[name]) == \
                _headers_and_columns(want[name]), name
    table = os.path.join("cavity_coupling_1eneg03",
                         "prod-1_energy_tracker.txt")
    uni = np.loadtxt(got[table], comments=("#", "time"), ndmin=2)[:, 18]
    ref = np.loadtxt(want[table], comments=("#", "time"), ndmin=2)[:, 18]
    assert len(uni) == len(ref) >= 5
    assert np.abs(uni - uni[0]).max() < 1e-4
    assert abs(uni[0] - ref[0]) < 1e-5


def test_cli_row_path_pads_once(two_ranks, tmp_path, monkeypatch):
    """``--pad-atoms 5 --shard-atoms 2`` on 2 ranks with molecular
    Langevin (the slab plan refuses it): the row path pads the 81-row
    scene once, to a multiple of both (90 rows, one ghost type), and
    writes the files of the one-process ``--pad-atoms 10`` run in float64
    with a fixed step: every table to 1e-10, GSD frames of the 81 real
    rows at the same positions."""
    from cavmd_tpu_torch.io import open_gsd

    rows_dir, ranks = two_ranks["cli_rows"]
    assert [rc for rc, _ in ranks] == [0, 0]
    log = ranks[0][1]
    assert "Slab path refused" in log
    assert log.count("Padded ") == 1
    assert "Padded 9 ghost particles (N=90)" in log
    monkeypatch.chdir(tmp_path)
    assert advanced_run.main(ROW_ARGS + ["--pad-atoms", "10"]) == 0
    got, want = _tree(rows_dir), _tree(tmp_path)
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith(".txt"):
            a = np.loadtxt(got[name], comments=("#", "time"), ndmin=2)
            b = np.loadtxt(want[name], comments=("#", "time"), ndmin=2)
            assert a.shape == b.shape, name
            if name.endswith("energy_tracker.txt"):
                assert len(b) >= 5
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10,
                                       err_msg=name)
        elif name.endswith("prod-1.gsd"):
            with open_gsd(got[name]) as ga, open_gsd(want[name]) as gb:
                assert len(ga) == len(gb) >= 2
                for k in range(len(ga)):
                    fa = ga.read_frame(k, device="cpu")
                    assert fa.N == 81 and "__ghost__" not in fa.types
                    np.testing.assert_allclose(
                        fa.position.numpy(),
                        gb.read_frame(k, device="cpu").position.numpy(),
                        rtol=0, atol=1e-10)
