"""The port's multi-process dry run, the counterpart of
``__graft_entry__.dryrun_multichip``: an n-rank program over gloo on the
CPU, float64, held against the unsharded batch to 1e-10::

    python -c "from cavmd_tpu_torch.dryrun import dryrun_multichip; \
dryrun_multichip(4)"

The ranks are local processes (``parallel/launch.py:run_ranks``, file
rendezvous, no network port). The n ranks are cut into R = 2 replicas of
S = n / 2 slabs when n is even (R = 1, S = n otherwise), as the JAX dry
run cuts its mesh. Three cases:

1. replicas over ranks, the CLI's ``--shard-replicas n``: a batch of n
   replicas of the reference scene (250 diatomics in a 46-bohr box, the
   seeded scene of the JAX dry run given as ``--input-gsd``, + the
   photon; the CLI runs it in dense mode) on n ranks, one replica a rank,
   20 steps of 0.25 fs with the energy, cavity-mode, F(k,t) and dipole
   trackers and GSD frames, against the one-process ``--vmap-replicas``
   batch: every file, row for row and frame for frame;
2. replicas x slabs (``make_domain_runner(n_replicas=R)``): R replicas
   of the 550-diatomic scene in a 65-bohr box over R x S ranks, adaptive
   dt and the dipole / rho(k) observables inside the slab step, 12 steps
   rebuilt every 5, against ``run_replica_steps`` on the batch;
3. atom sharding by rows (``make_sharded_runner(batched=True)`` on
   ``make_mesh(R, S)``), the counterpart of the JAX dry run's GSPMD case:
   R replicas of the reference scene ghost-padded to a multiple of S, in
   dense mode, float64, 20 steps of 0.25 fs, rank (r, s) holding replica
   r and splitting atom rows s N/S .. over the S ranks, against
   ``run_replica_steps`` on the unsharded batch.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

TOL = 1e-10  # positions and dt, relative and absolute (the JAX dry run's)
OBS_TOL = 1e-8  # observables, relative (tests/test_domain.py:333)
# case 1: 20 steps of the reference scene, a tracker row every step, F(k,t)
# and dipole rows every step, GSD frames every 5 steps
CLI_ARGS = ["--device", "CPU", "--precision", "f64", "--fixed-timestep",
            "--timestep", "0.25", "--runtime", "0.005",
            "--enable-energy-tracker", "--energy-output-period-ps",
            "0.00025", "--enable-fkt", "--fkt-wavevectors", "8",
            "--fkt-output-period-ps", "0.00025", "--fkt-ref-interval",
            "0.0025", "--gsd-output-period-ps", "0.00125", "--seed", "7"]
CLI_DIR = "cavity_coupling_1eneg03"


def _hold(label, got, ref):
    """Raise unless the batch ``got`` matches the reference ``ref``."""
    for key in ("position", "velocity", "dt"):
        np.testing.assert_allclose(got[key], ref[key], rtol=TOL, atol=TOL,
                                   err_msg=f"[{label}] {key}")
    np.testing.assert_array_equal(got["image"], ref["image"],
                                  err_msg=f"[{label}] image")
    for key, want in ref["obs"].items():
        np.testing.assert_allclose(got["obs"][key], want, rtol=OBS_TOL,
                                   atol=1e-12, err_msg=f"[{label}] {key}")
    assert not got["obs"]["cell_overflow"].any(), f"[{label}] overflow"


def _hold_rows(label, got, ref):
    """Raise unless a rank's replica rows ``got["rows"]`` of the row-split
    batch match those rows of the unsharded batch ``ref``."""
    lo, hi = got["rows"]
    for key in ("position", "velocity", "dt"):
        np.testing.assert_allclose(got[key], ref[key][lo:hi], rtol=TOL,
                                   atol=TOL, err_msg=f"[{label}] {key}")
    np.testing.assert_array_equal(got["image"], ref["image"][lo:hi],
                                  err_msg=f"[{label}] image")
    for key, want in ref["obs"].items():
        np.testing.assert_allclose(got["obs"][key], want[:, lo:hi],
                                   rtol=OBS_TOL, atol=1e-12,
                                   err_msg=f"[{label}] {key}")


def text_rows(path):
    """(header lines, numeric rows) of a tracker's text file."""
    head, rows = [], []
    with open(path) as f:
        for line in f.read().splitlines():
            if line and (line[0].isdigit() or line[0] == "-"):
                rows.append([float(v) for v in line.split()])
            else:
                head.append(line)
    return head, np.array(rows)


def hold_run_files(got_dir, want_dir, tol: float) -> list:
    """Raise ``AssertionError`` unless ``got_dir`` holds the files of the
    CLI run in ``want_dir``: the same names; each text file's header
    lines equal and its numeric rows within ``tol`` (relative and
    absolute); each GSD file of the same frame count, with each frame's
    step, ``log/*`` chunks and positions within ``tol``. Returns the
    names."""
    from cavmd_tpu_torch.io import open_gsd

    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names, (names, got_dir)
    for name in names:
        got, want = (os.path.join(d, name) for d in (got_dir, want_dir))
        if name.endswith(".txt"):
            (gh, gr), (wh, wr) = text_rows(got), text_rows(want)
            assert gh == wh, name
            assert gr.shape == wr.shape, name
            np.testing.assert_allclose(gr, wr, rtol=tol, atol=tol,
                                       err_msg=name)
        if not name.endswith(".gsd"):
            continue
        with open_gsd(got) as g, open_gsd(want) as w:
            assert len(g) == len(w), name
            gf, wf = g.file, w.file
            logs = sorted(n for n in wf._names if n.startswith("log/"))
            assert sorted(n for n in gf._names
                          if n.startswith("log/")) == logs, name
            for f in range(len(w)):
                assert gf.read_chunk(f, "configuration/step")[0] == \
                    wf.read_chunk(f, "configuration/step")[0], (name, f)
                for n in logs:  # a chunk a frame may leave out
                    a, b = gf.read_chunk(f, n), wf.read_chunk(f, n)
                    assert (a is None) == (b is None), (name, f, n)
                    if b is not None:
                        np.testing.assert_allclose(
                            a, b, rtol=tol, atol=tol,
                            err_msg=f"{name} frame {f} {n}")
                np.testing.assert_allclose(
                    g.read_frame(f, device="cpu").position.numpy(),
                    w.read_frame(f, device="cpu").position.numpy(),
                    rtol=0, atol=tol, err_msg=f"{name} frame {f}")
    return names


def cli_in(directory, argv) -> int:
    """``advanced_run.main(argv)`` run in ``directory`` (a ``run_ranks``
    job: each rank changes its own working directory); returns its exit
    code."""
    from cavmd_tpu_torch.drivers import advanced_run

    cwd = os.getcwd()
    os.chdir(directory)
    try:
        return advanced_run.main(list(argv))
    finally:
        os.chdir(cwd)


def dryrun_multichip(n_devices: int) -> dict:
    """Run both cases on ``n_devices`` gloo ranks and hold every rank's
    result against the unsharded batch's; raises ``AssertionError`` on a
    mismatch. Returns the grid (``R``, ``S``), the CLI case's exit codes
    a rank (``cli_rcs``) and names of the files it compared
    (``cli_files``), and the replicas x slabs case as ``(reference,
    [per-rank results])`` (``replicas_x_slabs``)."""
    import torch

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.io import HOOMDTrajectory
    from cavmd_tpu_torch.parallel.launch import (
        replicas_x_slabs_dryrun,
        rows_dryrun,
        run_ranks,
    )

    n = int(n_devices)
    R = 2 if n % 2 == 0 else 1
    S = n // R
    with tempfile.TemporaryDirectory(prefix="cavmd_dryrun_") as tmp:
        one, ranks = (os.path.join(tmp, d) for d in ("one", "ranks"))
        os.makedirs(one)
        os.makedirs(ranks)
        start = os.path.join(tmp, "start.gsd")
        with HOOMDTrajectory(start, "w") as t:
            t.append(pt.make_diatomic_system(
                250, box_L=46.0, temperature_K=100.0, seed=0,
                dtype=torch.float64, device="cpu"), step=0,
                dtype=np.float64)
        batch = CLI_ARGS + ["--input-gsd", start, "--replicas",
                            f"0-{n - 1}"]
        xs_ref = replicas_x_slabs_dryrun(n_replicas=R)
        rows_ref = rows_dryrun(n_replicas=R, n_shards=S)
        rc_one = cli_in(one, batch + ["--vmap-replicas"])
        cli_rcs, xs_ranks, rows_ranks = run_ranks(
            [(cli_in, (ranks, batch + ["--shard-replicas", str(n)])),
             (replicas_x_slabs_dryrun, dict(n_replicas=R)),
             (rows_dryrun, dict(n_replicas=R, n_shards=S))], n)
        assert rc_one == 0 and cli_rcs == [0] * n, (rc_one, cli_rcs)
        files = hold_run_files(os.path.join(ranks, CLI_DIR),
                               os.path.join(one, CLI_DIR), TOL)
    assert sum(f.endswith(".gsd") for f in files) == n, files
    for k, got in enumerate(xs_ranks):
        _hold(f"replicas x slabs rank {k}", got, xs_ref)
    for k, got in enumerate(rows_ranks):
        _hold_rows(f"rows rank {k}", got, rows_ref)
    print(f"dryrun_multichip [replicas over ranks] OK: --shard-replicas "
          f"{n}, {n} replicas of N=501 one a rank over {n} gloo ranks, "
          f"{len(files)} files of 20 steps match the one-process batch's "
          "to 1e-10")
    print(f"dryrun_multichip [replicas x slabs {R}x{S}] OK: N="
          f"{xs_ref['position'].shape[1]}, adaptive dt + dipole/rho(k) "
          "inside the slab step, 12 steps (3 rebuild chunks) match "
          "run_replica_steps to 1e-10")
    print(f"dryrun_multichip [rows {R}x{S}] OK: N={rows_ref['N']} "
          "(ghost-padded), dense, 20 row-sharded steps match "
          "run_replica_steps to 1e-10")
    return dict(R=R, S=S, cli_rcs=cli_rcs, cli_files=files,
                replicas_x_slabs=(xs_ref, xs_ranks),
                rows=(rows_ref, rows_ranks))
