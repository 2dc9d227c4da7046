"""cavmd_tpu_torch.core against cavmd_tpu.core: scene bits, box helpers,
unit table."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu import core as jcore
from cavmd_tpu.core import system as jsystem
from cavmd_tpu_torch import core as tcore
from cavmd_tpu_torch.core import system as tsystem

SNAPSHOT_FIELDS = ("position", "image", "velocity", "mass", "charge",
                   "diameter", "typeid", "bond_group", "bond_typeid", "box_L")


def _both_scenes(n_mol, box_L, temperature_K, seed, cav):
    js = jcore.make_diatomic_system(n_mol, box_L=box_L,
                                    temperature_K=temperature_K, seed=seed)
    ts = tcore.make_diatomic_system(n_mol, box_L=box_L,
                                    temperature_K=temperature_K, seed=seed,
                                    device="cpu")
    if cav:
        js = jcore.add_cavity_particle(js, **cav)
        ts = tcore.add_cavity_particle(ts, **cav)
    return js, ts


@pytest.mark.parametrize("n_mol,box_L,temperature_K,seed,cav", [
    (20, 24.0, 100.0, 0, dict(coupling=1e-3, freq_cm1=2000.0,
                              temperature_K=100.0, seed=1)),
    (250, 46.0, 100.0, 0, dict(coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)),
    (13, 19.0, None, 7, dict(coupling=2e-3, freq_cm1=1500.0,
                             temperature_K=300.0, finite_q=True, seed=4)),
    (8, 20.0, 50.0, 3, {}),
])
def test_scene_bits_identical(n_mol, box_L, temperature_K, seed, cav):
    """Same NumPy RNG call sequence -> bit-identical scenes, photon
    included."""
    js, ts = _both_scenes(n_mol, box_L, temperature_K, seed, cav)
    for name in SNAPSHOT_FIELDS:
        j = np.asarray(getattr(js, name))
        t = getattr(ts, name).numpy()
        assert j.dtype == t.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert ts.types == js.types
    assert ts.bond_types == js.bond_types
    assert ts.N == js.N and ts.n_bonds == js.n_bonds


def test_reference_box_and_tables_match():
    for n in (250, 2000, 50_000):
        assert tsystem.reference_box_for(n) == jsystem.reference_box_for(n)
    assert tsystem.BOND_PARAMS == jsystem.BOND_PARAMS
    assert tsystem.LJ_PARAMS == jsystem.LJ_PARAMS
    assert (tsystem.MASS_O, tsystem.MASS_N) == (jsystem.MASS_O,
                                                jsystem.MASS_N)


def test_unit_table_identical():
    for name in ("HARTREE_TO_CM_MINUS1", "KB_HARTREE_PER_K", "ENERGY_JOULES",
                 "LENGTH_METERS", "MASS_KG", "TIME_SECONDS",
                 "TIME_PS_CONVERSION"):
        assert getattr(tcore.PhysicalConstants, name) == getattr(
            jcore.PhysicalConstants, name)
    PCt, PCj = tcore.PhysicalConstants, jcore.PhysicalConstants
    for f, x in (("ps_to_atomic_units", 5.0), ("fs_to_atomic_units", 0.25),
                 ("gamma_from_tau_ps", 5.0), ("kT_from_kelvin", 100.0),
                 ("omega_from_cm1", 2000.0), ("atomic_units_to_fs", 10.0)):
        assert getattr(PCt, f)(x) == getattr(PCj, f)(x)
    with pytest.raises(ValueError):
        PCt.gamma_from_tau_ps(0.0)


def test_box_helpers_match_jax():
    rng = np.random.default_rng(11)
    box = np.array([20.0, 23.0, 31.0])
    pos = (rng.random((64, 3)) - 0.5) * 3.0 * box  # up to 1.5 boxes out
    img = rng.integers(-2, 3, size=(64, 3)).astype(np.int32)
    # exact half-box displacements exercise round-half-to-even
    dr = np.concatenate([pos[:32] - pos[32:], 0.5 * box[None, :] * np.array(
        [[1.0, -1.0, 3.0]])])

    t = lambda x: torch.as_tensor(x)  # noqa: E731
    tw, ti = tcore.wrap_positions(t(pos), t(box))
    jw, ji = jcore.wrap_positions(jnp.asarray(pos), jnp.asarray(box))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    tr, tim = tcore.rewrap(t(pos), t(img), t(box))
    jr, jim = jcore.rewrap(jnp.asarray(pos), jnp.asarray(img),
                           jnp.asarray(box))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tim.numpy(), np.asarray(jim))

    np.testing.assert_array_equal(
        tcore.unwrap_positions(t(pos), t(img), t(box)).numpy(),
        np.asarray(jcore.unwrap_positions(pos, img, box)))
    np.testing.assert_array_equal(
        tcore.minimum_image(t(dr), t(box)).numpy(),
        np.asarray(jcore.minimum_image(jnp.asarray(dr), jnp.asarray(box))))


def test_snapshot_astype_to_replace():
    ts = tcore.add_cavity_particle(
        tcore.make_diatomic_system(6, box_L=15.0, seed=2, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0)
    s32 = ts.astype(torch.float32)
    assert s32.position.dtype == torch.float32
    assert s32.mass.dtype == torch.float32
    assert s32.image.dtype == torch.int32 and s32.typeid.dtype == torch.int32
    assert s32.bond_group.dtype == torch.int32
    np.testing.assert_array_equal(
        s32.position.numpy(), ts.position.numpy().astype(np.float32))
    moved = ts.to("cpu")
    assert moved.device.type == "cpu" and moved.types == ts.types
    r = ts.replace(velocity=torch.ones_like(ts.velocity))
    assert float(r.velocity.sum()) == 3 * ts.N
    assert ts.types == ("O", "N", "L")


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device named, the entry points put their tensors on the CUDA
    device; without one they raise instead of running on the CPU. A named
    CPU device still works."""
    from cavmd_tpu_torch.integrate.rng import make_generator
    from cavmd_tpu_torch.interop import state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.make_diatomic_system(10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.Snapshot.create(np.zeros((2, 3)), np.ones(3))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_generator(0, 1)
    z = np.zeros(2)
    kw = dict(position=np.zeros((2, 3)), image=np.zeros((2, 3)),
              velocity=np.zeros((2, 3)), mass=np.ones(2), charge=z,
              typeid=z, box_L=np.ones(3), forces=np.zeros((2, 3)), dt=1.0,
              time_au=0.0, time_comp=0.0, timestep=0, bussi_reservoir=z,
              bussi_instantaneous=z, langevin_reservoir=z)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_numpy(**kw)
    assert state_from_numpy(**kw, device="cpu").device.type == "cpu"
    ts = tcore.make_diatomic_system(10, device="cpu")
    assert ts.device.type == "cpu"
    # the photon and the force field follow the snapshot's device
    ts = tcore.add_cavity_particle(ts, coupling=1e-3, freq_cm1=2000.0,
                                   temperature_K=100.0)
    from cavmd_tpu_torch import ForceField

    ff = ForceField.create(ts, r_cut=6.0, pppm_mesh=(8, 8, 8))
    assert ts.device.type == "cpu" and ff.lj_eps.device.type == "cpu"
    assert make_generator(0, 1, device="cpu").device.type == "cpu"
