"""cavmd_tpu_torch.io against cavmd_tpu.io: GSD files written by either
package read back through the other with every array equal, and the
tracker log payload and console table equal."""

import io
import types

import numpy as np
import pytest
import torch

from cavmd_tpu import io as jio
from cavmd_tpu import observe as jobs_mod
from cavmd_tpu.io.gsd import gather_tracker_log as j_gather
from cavmd_tpu_torch import io as tio
from cavmd_tpu_torch import observe as tobs_mod
from cavmd_tpu_torch.io.gsd import gather_tracker_log as t_gather

from test_torch_observe import obs_chunks
from test_torch_ops import scene

FIELDS = ("position", "image", "velocity", "mass", "charge", "diameter",
          "typeid", "bond_group", "bond_typeid", "box_L")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _frames(n=3):
    js, ts = scene(n_mol=8, box_L=18.0, seed=2)
    rng = np.random.default_rng(1)
    out = []
    for k in range(n):
        d = rng.normal(scale=0.1, size=(js.N, 3))
        out.append((js.replace(position=np.asarray(js.position) + d),
                    ts.replace(position=ts.position + torch.as_tensor(d))))
    return out


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_gsd_round_trip_between_packages(tmp_path, writer, np_dtype):
    path = str(tmp_path / "traj.gsd")
    frames = _frames()
    log = {"md/time_ps": 0.25, "EnergyTracker/temperature": 101.5}
    if writer == "torch":
        with tio.HOOMDTrajectory(path, "w") as t:
            for k, (_, ts) in enumerate(frames):
                t.append(ts, step=10 * k, dtype=np_dtype, log_data=log)
        reader = jio.open_gsd(path)
    else:
        with jio.HOOMDTrajectory(path, "w", prefer_native=False) as t:
            for k, (js, _) in enumerate(frames):
                t.append(js, step=10 * k, dtype=np_dtype, log_data=log)
        reader = tio.open_gsd(path)
    with reader as r:
        assert len(r) == len(frames)
        for k, (js, _) in enumerate(frames):
            kw = dict(device="cpu") if writer == "jax" else {}
            snap = r.read_frame(k, **kw)
            for name in FIELDS:
                want = np.asarray(getattr(js, name))
                if name in ("position", "velocity", "mass", "charge",
                            "diameter"):
                    want = want.astype(np_dtype)
                got = _np(getattr(snap, name))
                np.testing.assert_array_equal(got.astype(want.dtype), want,
                                              err_msg=name)
            assert snap.types == js.types and snap.bond_types == js.bond_types
            assert r.file.read_chunk(k, "configuration/step")[0] == 10 * k
            assert float(r.read_log(k, "EnergyTracker/temperature")[0]) \
                == 101.5


def test_gsd_files_are_byte_identical_apart_from_the_application(tmp_path):
    """The same frames written by both packages' Python codecs give the
    same bytes, except the header's application name."""
    frames = _frames(2)
    paths = [str(tmp_path / "j.gsd"), str(tmp_path / "t.gsd")]
    with jio.HOOMDTrajectory(paths[0], "w", prefer_native=False) as t:
        for js, _ in frames:
            t.append(js, step=3, dtype=np.float64)
    with tio.HOOMDTrajectory(paths[1], "w") as t:
        for _, ts in frames:
            t.append(ts, step=3, dtype=np.float64)
    a, b = (open(p, "rb").read() for p in paths)
    assert len(a) == len(b)
    # header bytes 48:112 hold the application name
    assert a[:48] == b[:48] and a[112:] == b[112:]


def test_gsd_read_frame_defaults_to_cuda(tmp_path, monkeypatch):
    path = str(tmp_path / "one.gsd")
    with tio.HOOMDTrajectory(path, "w") as t:
        t.append(_frames(1)[0][1], step=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tio.open_gsd(path) as t:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t.read_frame(0)
        assert t.read_frame(0, device="cpu").device.type == "cpu"


def test_gather_tracker_log_and_table_writer_match_jax(tmp_path,
                                                       monkeypatch):
    chunks = obs_chunks(2)
    logs, tables = {}, {}
    for name, mod, gather, iomod in (
            ("jax", jobs_mod, j_gather, jio),
            ("torch", tobs_mod, t_gather, tio)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        trackers = [
            mod.EnergyTracker(output_prefix="p", output_period_steps=3,
                              n_molecular_dof=30),
            mod.CavityModeTracker(output_prefix="p", output_period_steps=3),
            mod.DipoleAutocorrelation(output_period_steps=2),
        ]
        perf = mod.PerformanceTracker(runtime_ps=1.0)
        buf = io.StringIO()
        table = iomod.TableWriter(perf, output_period_ps=0.0, file=buf)
        for o in chunks:
            for tr in trackers:
                tr.consume(o)
            # fixed rates, so the rows do not depend on the wall clock
            perf.tps, perf.ns_per_day, perf.eta_remaining = 12.5, 0.25, "0:01"
            table.consume(o, None)
        logs[name] = gather(trackers, 0.125, 3.5)
        tables[name] = buf.getvalue()
    assert logs["torch"] == logs["jax"]
    assert any(k.startswith("EnergyTracker/") for k in logs["torch"])
    assert tables["torch"] == tables["jax"]
    assert tables["torch"].count("\n") == 3  # header + one row per chunk


def test_gsd_writer_frames_from_a_simulation(tmp_path):
    """GSDWriter writes the initial frame and one per output period from a
    port Simulation, with the tracker log embedded."""
    from cavmd_tpu_torch import ForceField, MethodSpec, Simulation

    _, ts = scene(n_mol=6, box_L=15.0)
    ff = ForceField.create(ts, r_cut=6.0, pppm_mesh=(8, 8, 8))
    sim = Simulation(ts, ff, (MethodSpec(kind="nve", group="all"),),
                     dt=10.0, chunk_size=5)
    sim.trackers.append(tobs_mod.ElapsedTimeTracker(1.0))
    path = str(tmp_path / "w.gsd")
    w = tio.GSDWriter(path, output_period_ps=9.0 * 1.0e-4)
    w.write_now(sim)
    sim.writers.append(w)
    sim.run(n_steps=20)
    w.close()
    with jio.open_gsd(path) as t:
        steps = [int(t.file.read_chunk(k, "configuration/step")[0])
                 for k in range(len(t))]
        assert steps == [0, 5, 10, 15, 20]
        np.testing.assert_array_equal(
            np.asarray(t[-1].position),
            sim.state.position.numpy().astype(np.float32))
        assert t.read_log(len(t) - 1, "md/time_ps") is not None
