"""cavmd_tpu_torch.ops against cavmd_tpu.ops (float64, CPU): bonds, cavity,
LJ, Ewald pieces; the tests/oracle.py loop oracles on the port; and the
N = 501 reference scene's full ForceField against ForceField.compute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import add_cavity_particle as j_add
from cavmd_tpu.core import make_diatomic_system as j_make
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.ops import bonds as jbonds
from cavmd_tpu.ops import cavity as jcavity
from cavmd_tpu.ops import ewald as jewald
from cavmd_tpu.ops import lj as jlj
from cavmd_tpu_torch.core import add_cavity_particle as t_add
from cavmd_tpu_torch.core import make_diatomic_system as t_make
from cavmd_tpu_torch.core.system import LJ_PARAMS
from cavmd_tpu_torch.integrate import ForceField
from cavmd_tpu_torch.interop import forcefield_from_numpy
from cavmd_tpu_torch.ops import bonds as tbonds
from cavmd_tpu_torch.ops import cavity as tcavity
from cavmd_tpu_torch.ops import ewald as tewald
from cavmd_tpu_torch.ops import lj as tlj

from oracle import (
    oracle_cavity,
    oracle_ewald_real,
    oracle_harmonic_bonds,
    oracle_lj_shifted,
)

RTOL = 1e-10  # relative to max|F| (forces) or |E| (energies), float64


def scene(n_mol=20, box_L=24.0, seed=0, jitter=0.05):
    """The tests/test_integrate.py scene in both packages, with the same
    seeded jitter (so bonds are off rest length) applied to both."""
    js = j_add(j_make(n_mol, box_L=box_L, temperature_K=100.0, seed=seed),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
               seed=seed + 1)
    ts = t_add(t_make(n_mol, box_L=box_L, temperature_K=100.0, seed=seed,
                      device="cpu"),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0,
               seed=seed + 1)
    if jitter:
        d = np.random.default_rng(seed + 9).normal(scale=jitter,
                                                   size=(js.N, 3))
        pos = np.asarray(js.position) + d
        js = js.replace(position=jnp.asarray(pos))
        ts = ts.replace(position=torch.as_tensor(pos))
    return js, ts


def port_forcefield(jff, jsnap, dtype=torch.float64, device="cpu"):
    """The port ForceField built from the JAX ForceField's leaves."""
    p = jff.lj_pair
    return forcefield_from_numpy(
        rows_eps=np.asarray(p.rows_eps), rows_sig2=np.asarray(p.rows_sig2),
        rows_rcut2=np.asarray(p.rows_rcut2),
        rows_vshift=np.asarray(p.rows_vshift), oh=np.asarray(p.oh),
        active=np.asarray(p.active),
        coulomb_active=np.asarray(jff.coulomb_active),
        kappa=np.asarray(jff.kappa), influence=np.asarray(jff.pppm.influence),
        volume=np.asarray(jff.pppm.volume),
        omegac=np.asarray(jff.cavity.omegac),
        couplstr=np.asarray(jff.cavity.couplstr),
        phmass=np.asarray(jff.cavity.phmass),
        bond_k=np.asarray(jff.bond_k), bond_r0=np.asarray(jff.bond_r0),
        bond_group=np.asarray(jsnap.bond_group),
        bond_typeid=np.asarray(jsnap.bond_typeid),
        l_typeid=jff.l_typeid, coulomb_rcut=jff.coulomb_rcut,
        pppm_order=jff.pppm_order, pppm_mesh=jff.pppm_mesh,
        enable_cavity=jff.enable_cavity, enable_coulomb=jff.enable_coulomb,
        enable_lj=jff.enable_lj, enable_bonds=jff.enable_bonds,
        dtype=dtype, device=device,
    )


def assert_forces(t, j, rtol=RTOL):
    j = np.asarray(j)
    t = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, j, rtol=0, atol=rtol * np.abs(j).max())


def assert_energy(t, j, rtol=RTOL, scale=None):
    j = float(j)
    assert abs(float(t) - j) <= rtol * (scale or max(abs(j), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_bonds_strided_and_scatter_match_jax():
    js, ts = scene()
    nb = js.n_bonds
    k = np.array([0.73, 1.43])
    r0 = np.array([2.28, 2.07])
    btid = np.asarray(js.bond_typeid)
    fj, ej = jbonds.harmonic_bond_force_strided(
        js.position, js.box_L, nb, jnp.asarray(k[btid]),
        jnp.asarray(r0[btid]))
    ft, et = tbonds.harmonic_bond_force_strided(
        ts.position, ts.box_L, nb, _t(k[btid]), _t(r0[btid]))
    assert_forces(ft, fj)
    assert_energy(et, ej)

    # a permuted, reversed bond table: not consecutive, takes the scatter path
    perm = np.random.default_rng(3).permutation(nb)
    bg = np.asarray(js.bond_group)[perm][:, ::-1].copy()
    assert not tbonds.bonds_are_consecutive(bg)
    fj, ej = jbonds.harmonic_bond_force(
        js.position, js.box_L, jnp.asarray(bg), jnp.asarray(btid[perm]),
        jnp.asarray(k), jnp.asarray(r0))
    ft, et = tbonds.harmonic_bond_force(
        ts.position, ts.box_L, _t(bg), _t(btid[perm]), _t(k), _t(r0))
    assert_forces(ft, fj)
    assert_energy(et, ej)


def test_bonds_match_oracle():
    js, ts = scene(n_mol=10, box_L=20.0)
    k = np.array([0.73, 1.43])
    r0 = np.array([2.28, 2.07])
    bg = ts.bond_group.numpy()
    btid = ts.bond_typeid.numpy()
    f_ref, e_ref = oracle_harmonic_bonds(ts.position.numpy(),
                                         ts.box_L.numpy(), bg, btid, k, r0)
    ft, et = tbonds.harmonic_bond_force(ts.position, ts.box_L, _t(bg),
                                        _t(btid), _t(k), _t(r0))
    np.testing.assert_allclose(ft.numpy(), f_ref, atol=1e-12)
    assert float(et) == pytest.approx(e_ref, rel=1e-12)


def test_cavity_matches_jax_and_oracle():
    js, ts = scene()
    l_tid = ts.types.index("L")
    omegac, g = 2000.0 / 219474.63, 2e-3
    fj, ej = jcavity.cavity_force(
        js.position, js.image, js.box_L, js.charge, js.typeid, l_tid,
        jcavity.CavityParams.create(omegac, g))
    ft, et = tcavity.cavity_force(
        ts.position, ts.image, ts.box_L, ts.charge, ts.typeid, l_tid,
        tcavity.CavityParams.create(omegac, g))
    assert_forces(ft, fj)
    for key in ("harmonic", "coupling", "dipole_self"):
        assert_energy(et[key], ej[key])
    f_ref, e_ref = oracle_cavity(
        ts.position.numpy(), ts.image.numpy(), ts.box_L.numpy(),
        ts.charge.numpy(), ts.typeid.numpy(), l_tid, omegac, g)
    np.testing.assert_allclose(ft.numpy(), f_ref, rtol=1e-12, atol=1e-16)
    for key in e_ref:
        assert float(et[key]) == pytest.approx(e_ref[key], rel=1e-12)


def test_cavity_without_photon_is_zero():
    ts = t_make(6, box_L=15.0, seed=1, device="cpu")
    f, e = tcavity.cavity_force(ts.position, ts.image, ts.box_L, ts.charge,
                                ts.typeid, 2,
                                tcavity.CavityParams.create(0.01, 1e-3))
    assert float(f.abs().max()) == 0.0
    assert all(float(v) == 0.0 for v in e.values())


def test_lj_tables_and_fused_pair_match_jax():
    js, ts = scene()
    types = list(ts.types)
    params = {k: {**v, "r_cut": 10.0} for k, v in
              LJ_PARAMS.items()}
    je, jsg, jrc = jlj.lj_pair_tables(types, params, dtype=jnp.float64)
    te, tsg, trc = tlj.lj_pair_tables(types, params)
    for a, b in ((te, je), (tsg, jsg), (trc, jrc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    excl = jlj.bond_exclusion_mask(js.N, js.bond_group)
    np.testing.assert_array_equal(
        tlj.bond_exclusion_mask(ts.N, ts.bond_group), np.asarray(excl))
    jpair = jlj.LJPairMatrices.create(js.typeid, je, jsg, jrc, excl)
    tpair = tlj.LJPairMatrices.create(ts.typeid, te, tsg, trc,
                                      np.asarray(excl))
    for name in ("rows_eps", "rows_sig2", "rows_rcut2", "rows_vshift", "oh",
                 "active"):
        np.testing.assert_array_equal(getattr(tpair, name).numpy(),
                                      np.asarray(getattr(jpair, name)),
                                      err_msg=name)

    q = np.asarray(js.charge)
    qq = q[:, None] * q[None, :]
    cact = (~np.eye(js.N, dtype=bool)) & (qq != 0) & ~np.asarray(excl)
    fj, elj_j, eew_j = jlj.fused_pair_force(
        js.position, js.box_L, jpair, jnp.asarray(qq), jnp.asarray(cact),
        0.3, 10.0)
    ft, elj_t, eew_t = tlj.fused_pair_force(
        ts.position, ts.box_L, tpair, _t(qq), _t(cact), 0.3, 10.0)
    assert_forces(ft, fj)
    assert_energy(elj_t, elj_j)
    assert_energy(eew_t, eew_j)


def test_lj_and_ewald_real_match_oracles():
    js, ts = scene(n_mol=10, box_L=20.0)
    types = list(ts.types)
    params = {k: {**v, "r_cut": 9.0} for k, v in
              LJ_PARAMS.items()}
    eps, sig, rc = tlj.lj_pair_tables(types, params)
    bg = ts.bond_group.numpy()
    excl = tlj.bond_exclusion_mask(ts.N, bg)
    pair = tlj.LJPairMatrices.create(ts.typeid, eps, sig, rc, excl)
    q = ts.charge.numpy()
    qq = q[:, None] * q[None, :]
    cact = (~np.eye(ts.N, dtype=bool)) & (qq != 0) & ~excl
    pos, box = ts.position.numpy(), ts.box_L.numpy()
    pairs = [tuple(b) for b in bg]

    f_lj, e_lj, _ = tlj.fused_pair_force(
        ts.position, ts.box_L, pair, _t(qq), _t(np.zeros_like(cact)), 0.3,
        9.0)
    f_ref, e_ref = oracle_lj_shifted(pos, box, ts.typeid.numpy(),
                                     eps.numpy(), sig.numpy(), rc.numpy(),
                                     excluded_pairs=pairs)
    np.testing.assert_allclose(f_lj.numpy(), f_ref, atol=1e-12)
    assert float(e_lj) == pytest.approx(e_ref, rel=1e-12)

    no_lj = tlj.LJPairMatrices(pair.rows_eps, pair.rows_sig2, pair.rows_rcut2,
                               pair.rows_vshift, pair.oh,
                               torch.zeros_like(pair.active))
    f_ew, _, e_ew = tlj.fused_pair_force(ts.position, ts.box_L, no_lj,
                                         _t(qq), _t(cact), 0.25, 9.0)
    f_ref, e_ref = oracle_ewald_real(pos, box, q, 0.25, 9.0,
                                     excluded_pairs=pairs)
    np.testing.assert_allclose(f_ew.numpy(), f_ref, atol=1e-12)
    assert float(e_ew) == pytest.approx(e_ref, rel=1e-12)


def test_ewald_pieces_match_jax():
    js, ts = scene()
    kappa = 0.27
    assert tewald.auto_kappa(15.0) == jewald.auto_kappa(15.0)
    assert tewald.auto_kappa(10.0, 1e-5) == jewald.auto_kappa(10.0, 1e-5)
    assert_energy(tewald.ewald_self_energy(ts.charge, kappa),
                  jewald.ewald_self_energy(js.charge, kappa))

    fj, ej = jewald.ewald_exclusion_correction_strided(
        js.position, js.box_L, js.charge, kappa, js.n_bonds)
    ft, et = tewald.ewald_exclusion_correction_strided(
        ts.position, ts.box_L, ts.charge, kappa, ts.n_bonds)
    assert_forces(ft, fj)
    assert_energy(et, ej)

    bg = np.asarray(js.bond_group)[::-1].copy()
    fj, ej = jewald.ewald_exclusion_correction(
        js.position, js.box_L, js.charge, kappa, jnp.asarray(bg))
    ft, et = tewald.ewald_exclusion_correction(
        ts.position, ts.box_L, ts.charge, kappa, _t(bg))
    assert_forces(ft, fj)
    assert_energy(et, ej)

    fj, ej = jewald.ewald_kspace_exact(js.position, js.charge, js.box_L,
                                       kappa, nmax=6)
    ft, et = tewald.ewald_kspace_exact(ts.position, ts.charge, ts.box_L,
                                       kappa, nmax=6)
    assert_forces(ft, fj)
    assert_energy(et, ej)


@pytest.mark.parametrize("build", ["create", "interop"])
def test_reference_scene_forcefield_matches_jax(build):
    """N = 501 reference scene, 32^3 order-6 mesh, r_cut 15: every force and
    energy component of the port's dense ForceField against
    ForceField.compute, to 1e-10 relative in float64."""
    js, ts = scene(n_mol=250, box_L=46.0)
    jff = JForceField.create(js, coupling=1e-3, freq_cm1=2000.0)
    assert jff.pair_mode == "dense" and jff.bonds_strided
    fj, ej = jax.jit(jff.compute)(js.position, js.image, js.box_L,
                                  js.charge, js.typeid, js.bond_group,
                                  js.bond_typeid)
    if build == "create":
        tff = ForceField.create(ts, coupling=1e-3, freq_cm1=2000.0)
    else:
        tff = port_forcefield(jff, js)
    ft, et = tff(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
    assert_forces(ft, fj)
    assert set(et) == {k for k in ej if k != "cell_overflow"}
    for key in et:
        assert_energy(et[key], ej[key]), key
    assert float(et["harmonic"]) > 1e-6  # the jitter stretched the bonds


def test_forcefield_rejects_unported_modes():
    """Dense, cell and zcol modes are ported (zcol builds where the box has
    3 columns per axis, and raises ValueError, as in the JAX package, where
    it has fewer); the TPU-only 'pallas' mode raises."""
    ts = t_make(4, box_L=12.0, seed=0, device="cpu")
    assert ForceField.create(ts, pair_mode="cell",
                             pppm_mesh=(8, 8, 8)).pair_mode == "cell"
    with pytest.raises(ValueError, match="columns per xy axis"):
        ForceField.create(ts, pair_mode="zcol", pppm_mesh=(8, 8, 8))
    wide = t_make(60, box_L=40.0, seed=3, device="cpu")
    ff = ForceField.create(wide, pair_mode="zcol", r_cut=12.0,
                           pppm_mesh=(8, 8, 8))
    assert ff.pair_mode == "zcol" and ff.cell_cfg.ncells == (3, 3, 1)
    assert ff.zcol_W >= 1 and ff.cell_neighbors is None
    with pytest.raises(NotImplementedError):
        ForceField.create(ts, pair_mode="pallas")
