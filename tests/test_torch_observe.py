"""cavmd_tpu_torch.observe against cavmd_tpu.observe: the on-device
observables and ThermodynamicQuantities (float64, 1e-10 relative), every
tracker writing byte-identical files from the same observable chunks, and
the spectra functions (1e-12)."""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu import observe as jobs_mod
from cavmd_tpu.core import PhysicalConstants as PC
from cavmd_tpu.io import native as j_native
from cavmd_tpu_torch import observe as tobs_mod

from test_torch_ops import scene

OBS_SCALARS = (
    "harmonic", "lj", "ewald_short", "ewald_long", "cavity_harmonic",
    "cavity_coupling", "cavity_dipole_self", "kinetic_molecular",
    "kinetic_cavity", "bussi_reservoir_molecular", "bussi_reservoir_cavity",
    "langevin_reservoir_molecular", "langevin_reservoir_cavity", "dt",
)


def _rel(t, j, tol=1e-10):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * np.abs(j).max())


def test_dipole_density_field_sphere_match_jax():
    js, ts = scene(n_mol=20, box_L=24.0)
    _rel(tobs_mod.compute_total_dipole_moment(
        ts.position, ts.image, ts.box_L, ts.charge),
        jobs_mod.compute_total_dipole_moment(js.position, js.image,
                                             js.box_L, js.charge))
    for n in (10, 50):
        np.testing.assert_array_equal(
            tobs_mod.generate_fibonacci_sphere(n),
            jobs_mod.generate_fibonacci_sphere(n))
    wv = jobs_mod.generate_fibonacci_sphere(12) * 1.3
    rho = np.asarray(jobs_mod.compute_density_field(js.position,
                                                    jnp.asarray(wv)))
    re, im = tobs_mod.compute_density_field(ts.position, torch.as_tensor(wv))
    _rel(re, rho.real)
    _rel(im, rho.imag)
    # the step hook: same keys, shapes and values
    jx = jobs_mod.make_extra_obs(dipole=True, wavevectors=wv)
    tx = tobs_mod.make_extra_obs(dipole=True, wavevectors=wv)
    assert tx.dipole and np.array_equal(tx.wavevectors, jx.wavevectors)
    jo, to = jx(js), tx(ts)
    assert set(jo) == set(to) == {"dipole", "rho_k_re", "rho_k_im"}
    for k in jo:
        assert tuple(to[k].shape) == tuple(jo[k].shape)
        _rel(to[k], jo[k])
    ke, pe = 3.2e-4, 1.1e-3
    for a, b in zip(tobs_mod.cavity_mode_properties(ke, pe),
                    jobs_mod.cavity_mode_properties(ke, pe)):
        assert a == pytest.approx(float(b), rel=1e-12)
    assert tobs_mod.kinetic_temperature(0.25, 120) == pytest.approx(
        float(jobs_mod.kinetic_temperature(0.25, 120)), rel=1e-12)


def _fake_sim(state, l_typeid):
    return types.SimpleNamespace(
        state=state, ff=types.SimpleNamespace(l_typeid=l_typeid,
                                              ghost_typeid=-1))


@pytest.mark.parametrize("group", ["molecular", "cavity", "all"])
def test_thermodynamic_quantities_and_reservoir_views(group):
    js, ts = scene(n_mol=12, box_L=20.0)
    l_typeid = js.types.index("L")
    res = np.array([0.0123, -0.0042])
    inst = np.array([1.5e-5, -2e-6])
    lres = np.array([3e-6, 7e-4])
    jstate = types.SimpleNamespace(
        typeid=js.typeid, velocity=js.velocity, mass=js.mass,
        bussi_reservoir=jnp.asarray(res), bussi_reservoir_rot=jnp.zeros(2),
        bussi_instantaneous=jnp.asarray(inst),
        langevin_reservoir=jnp.asarray(lres))
    tstate = types.SimpleNamespace(
        typeid=ts.typeid, velocity=ts.velocity, mass=ts.mass,
        bussi_reservoir=torch.as_tensor(res),
        bussi_instantaneous=torch.as_tensor(inst),
        langevin_reservoir=torch.as_tensor(lres))
    jq = jobs_mod.ThermodynamicQuantities(_fake_sim(jstate, l_typeid), group)
    tq = tobs_mod.ThermodynamicQuantities(_fake_sim(tstate, l_typeid), group)
    for name in ("num_particles", "translational_degrees_of_freedom",
                 "rotational_degrees_of_freedom", "kinetic_energy",
                 "rotational_kinetic_energy", "kinetic_temperature"):
        assert getattr(tq, name) == pytest.approx(getattr(jq, name),
                                                  rel=1e-10, abs=0.0), name
    jb = jobs_mod.BussiReservoirView(_fake_sim(jstate, l_typeid), group)
    tb = tobs_mod.BussiReservoirView(_fake_sim(tstate, l_typeid), group)
    for name in ("reservoir_energy_translational",
                 "reservoir_energy_rotational", "total_reservoir_energy",
                 "instantaneous_reservoir_translational",
                 "instantaneous_reservoir_rotational",
                 "instantaneous_reservoir_total"):
        assert getattr(tb, name) == getattr(jb, name), name
    assert (tobs_mod.LangevinReservoirView(_fake_sim(tstate, l_typeid),
                                           group).reservoir_energy
            == jobs_mod.LangevinReservoirView(_fake_sim(jstate, l_typeid),
                                              group).reservoir_energy)


def obs_chunks(n_chunks=3, chunk=40, nk=6, seed=0):
    """Seeded observable chunks with the keys a run streams (adaptive dt,
    dipole and rho(k) columns included)."""
    rng = np.random.default_rng(seed)
    t0, step0 = 0.0, 0
    out = []
    for _ in range(n_chunks):
        o = {k: rng.normal(scale=1e-3, size=chunk) for k in OBS_SCALARS}
        o["dt"] = np.abs(o["dt"]) * 10 + 1.0
        o["time_au"] = t0 + np.cumsum(o["dt"])
        o["timestep"] = np.arange(step0 + 1, step0 + chunk + 1)
        o["error_tolerance"] = np.full(chunk, 0.5)
        o["dipole"] = rng.normal(size=(chunk, 3))
        o["rho_k_re"] = rng.normal(size=(chunk, nk))
        o["rho_k_im"] = rng.normal(size=(chunk, nk))
        t0, step0 = float(o["time_au"][-1]), step0 + chunk
        out.append(o)
    return out


def _trackers(mod):
    to_ps = PC.TIME_PS_CONVERSION
    return [
        mod.EnergyTracker(output_prefix="prod-1", output_period_steps=7,
                          max_time_ps=90.0 * to_ps,
                          n_molecular_dof=60),
        mod.CavityModeTracker(output_prefix="prod-1",
                              output_period_steps=5),
        mod.FieldAutocorrelationTracker(
            output_prefix="prod-1", output_period_steps=3,
            reference_interval_ps=30.0 * to_ps, max_references=3),
        mod.DipoleAutocorrelation(output_period_steps=4),
        mod.AutocorrelationTracker(key="dipole", output_prefix="mu",
                                   output_period_steps=2,
                                   new_reference_every=25),
        mod.ElapsedTimeTracker(0.01),
        mod.TimestepFormatter(),
    ]


def test_trackers_write_byte_identical_files(tmp_path, monkeypatch):
    """Every tracker of both packages, fed the same chunks in its own
    directory, writes the same files byte for byte (the JAX EnergyTracker
    through its Python formatting) and keeps the same current values."""
    monkeypatch.setattr(j_native, "format_table", lambda *a, **k: None)
    chunks = obs_chunks()
    trackers = {}
    for name, mod in (("jax", jobs_mod), ("torch", tobs_mod)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        trackers[name] = _trackers(mod)
        for o in chunks:
            for tr in trackers[name]:
                tr.consume(o)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch"))
    assert len(files) >= 7  # energy, cavity, 3 F(k,t) refs, 2+ C(t) files
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f
    assert "prod-1_ref2.txt" in files
    assert trackers["torch"][0].output_stopped  # max_time_ps cut the rows
    n_rows = sum(1 for line in open(tmp_path / "torch" /
                                    "prod-1_energy_tracker.txt")
                 if line[0].isdigit())
    assert 5 <= n_rows < 120 // 7
    for jt, tt in zip(trackers["jax"], trackers["torch"]):
        for attr in ("current", "current_autocorr", "elapsed_time", "done",
                     "dt_fs", "output_stopped", "last_output_step"):
            if hasattr(jt, attr):
                assert getattr(tt, attr) == getattr(jt, attr), attr


def test_performance_tracker_and_status():
    o = obs_chunks(1)[0]
    j = jobs_mod.PerformanceTracker(runtime_ps=1.0)
    t = tobs_mod.PerformanceTracker(runtime_ps=1.0)
    j.consume(o)
    t.consume(o)
    assert t.steps_done == j.steps_done == int(o["timestep"][-1])
    assert t.ns_per_day > 0 and t.tps > 0
    sim = types.SimpleNamespace(elapsed_ps=0.002)
    st = tobs_mod.Status(sim, runtime_ps=0.01)
    assert st.seconds_remaining >= 0 and float(st.nsd) >= 0


def test_spectra_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    lag = np.arange(400) * 0.002
    c = np.cos(2 * np.pi * 60.0 * lag) * np.exp(-lag / 0.3)
    c += 1e-3 * rng.normal(size=lag.size)
    for fn in ("spectrum_from_acf", "ir_absorption"):
        for window in ("hann", "none"):
            jf, js = getattr(jobs_mod, fn)(lag, c, window=window)
            tf, ts = getattr(tobs_mod, fn)(lag, c, window=window)
            np.testing.assert_allclose(tf, jf, rtol=1e-12, atol=0)
            np.testing.assert_allclose(ts, js, rtol=1e-12,
                                       atol=1e-12 * np.abs(js).max())
    jf, js = jobs_mod.spectrum_from_signal(c, 0.002)
    tf, ts = tobs_mod.spectrum_from_signal(c, 0.002)
    np.testing.assert_allclose(ts, js, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(
        tobs_mod.peak_frequencies(tf, ts, min_freq_cm1=100.0),
        jobs_mod.peak_frequencies(jf, js, min_freq_cm1=100.0))
    # segment and reference files, read back by both packages
    for k in range(3):
        with open(tmp_path / f"acf_{k}.txt", "w") as f:
            f.write("# timestep t(ps) C(t)\n")
            for i in range(50 + 5 * k):
                f.write(f"{i} {0.01 * i + k:.6f} {c[i]:.6f}\n")
        with open(tmp_path / f"fk_ref{k}.txt", "w") as f:
            f.write("# timestep lag_time(ps) field_autocorr\n")
            for i in range(40 + 3 * k):
                f.write(f"{i} {0.01 * i:.6f} {c[i + k]:.6f}\n")
    for fn, prefix in (("read_autocorr_segments", "acf"),
                       ("read_fkt_references", "fk")):
        jo = getattr(jobs_mod, fn)(prefix, str(tmp_path))
        to = getattr(tobs_mod, fn)(prefix, str(tmp_path))
        assert to[2] == jo[2]
        for a, b in zip(to[:2], jo[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


def test_spectrum_cli_matches_jax(tmp_path):
    from cavmd_tpu.drivers.spectrum import main as j_main
    from cavmd_tpu_torch.drivers.spectrum import main as t_main

    c = np.cos(2 * np.pi * 60.0 * np.arange(300) * 0.002)
    for k in range(2):
        with open(tmp_path / f"dipole_autocorr_{k}.txt", "w") as f:
            f.write("# timestep t(ps) C(t)\n")
            for i in range(300):
                f.write(f"{i} {0.002 * i:.6f} {c[i]:.6f}\n")
    outs = []
    for main, name in ((j_main, "jax.txt"), (t_main, "torch.txt")):
        outs.append(main(["dipole_autocorr", "--dir", str(tmp_path),
                          "--out", str(tmp_path / name)]))
    assert open(outs[0]).read() == open(outs[1]).read()
