"""The rest of the documented API against the JAX package (float64, CPU):
``Box`` and the package root's exports, ``molecular_dipole`` and
``cavity_total_energy``, ``lj_dense`` and ``lj_dense_pair``,
``ewald_real_space`` and ``ewald_real_space_pair``,
``coulomb_direct_reference``, ``pppm_reciprocal_energy`` (one scene and a
small replica batch) and ``make_pppm_force_energy``, and
``field_autocorrelation``; each to 1e-10 of its scale, on the N = 501
reference scene of tests/test_torch_ops.py. The port's whole Ewald sum
is held to the brute-force image sum on a small neutral scene as
closely as the JAX package's own sum comes to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cavmd_tpu
import cavmd_tpu_torch as pt
from cavmd_tpu.observe import observables as jobs
from cavmd_tpu.ops import cavity as jcavity
from cavmd_tpu.ops import ewald as jewald
from cavmd_tpu.ops import lj as jlj
from cavmd_tpu.ops import pppm as jpppm
from cavmd_tpu_torch.core.system import LJ_PARAMS
from cavmd_tpu_torch.observe import observables as tobs
from cavmd_tpu_torch.ops import cavity as tcavity
from cavmd_tpu_torch.ops import ewald as tewald
from cavmd_tpu_torch.ops import lj as tlj
from cavmd_tpu_torch.ops import pppm as tpppm

from test_torch_ops import assert_energy, assert_forces, scene

RTOL = 1e-10
MESH, ORDER, KAPPA = (32, 32, 32), 6, 0.27


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: the suite runs six workers on
    the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref():
    """The N = 501 reference scene (250 O2/N2 + photon, 46 bohr, seeded
    jitter) in both packages."""
    return scene(n_mol=250, box_L=46.0)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_box_version_and_root_exports_match_jax():
    assert pt.__version__ == cavmd_tpu.__version__
    for jb, tb in ((cavmd_tpu.Box.cubic(12.5), pt.Box.cubic(12.5,
                                                            device="cpu")),
                   (cavmd_tpu.Box.from_lengths(9.0, 10.5, 31.0),
                    pt.Box.from_lengths(9.0, 10.5, 31.0, device="cpu"))):
        np.testing.assert_array_equal(tb.L.numpy(), np.asarray(jb.L))
        assert float(tb.volume) == float(jb.volume)
    f32 = pt.Box.cubic(3.0, dtype=torch.float32, device="cpu")
    assert f32.L.dtype == torch.float32 and f32.L.device.type == "cpu"

    pos = np.random.default_rng(4).normal(scale=30.0, size=(40, 3))
    box = np.array([9.0, 10.5, 31.0])
    wj, ij = cavmd_tpu.wrap_positions(jnp.asarray(pos), jnp.asarray(box))
    wt, it = pt.wrap_positions(_t(pos), _t(box))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(
        pt.unwrap_positions(wt, it, _t(box)).numpy(),
        np.asarray(cavmd_tpu.unwrap_positions(wj, ij, jnp.asarray(box))))


def test_box_defaults_to_the_card():
    """Without ``device`` a Box goes to the CUDA device, and raises
    without one (core/device.py), as every entry point does."""
    if torch.cuda.is_available():
        assert pt.Box.cubic(5.0).L.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Box.cubic(5.0)


def test_molecular_dipole_and_cavity_total_energy_match_jax(ref):
    js, ts = ref
    l_tid = ts.types.index("L")
    dj = jcavity.molecular_dipole(js.position, js.image, js.box_L,
                                  js.charge, js.typeid == l_tid)
    dt = tcavity.molecular_dipole(ts.position, ts.image, ts.box_L,
                                  ts.charge, ts.typeid == l_tid)
    assert_forces(dt, dj)
    params = dict(omegac=2000.0 / 219474.63, couplstr=2e-3)
    _, ej = jcavity.cavity_force(js.position, js.image, js.box_L, js.charge,
                                 js.typeid, l_tid,
                                 jcavity.CavityParams.create(**params))
    _, et = tcavity.cavity_force(ts.position, ts.image, ts.box_L, ts.charge,
                                 ts.typeid, l_tid,
                                 tcavity.CavityParams.create(**params))
    assert_energy(tcavity.cavity_total_energy(et),
                  jcavity.cavity_total_energy(ej))


def test_molecular_dipole_batch_matches_jax_per_replica(ref):
    """A batch of 3 (positions jittered, a box and a charge row a
    replica) against JAX's function on each replica."""
    js, ts = ref
    l_tid = ts.types.index("L")
    rng = np.random.default_rng(5)
    B, N = 3, ts.N
    pos = ts.position.numpy() + rng.normal(0.0, 0.05, (B, N, 3))
    img = np.broadcast_to(ts.image.numpy(), (B, N, 3)).copy()
    img[1, :4, 0] += 1
    box = ts.box_L.numpy() * np.array([[1.0], [1.01], [0.99]])
    charge = ts.charge.numpy() * np.array([[1.0], [0.5], [2.0]])
    mask = ts.typeid.numpy() == l_tid
    got = tcavity.molecular_dipole(
        torch.tensor(pos), torch.tensor(img), torch.tensor(box),
        torch.tensor(charge), torch.tensor(mask))
    assert got.shape == (B, 3)
    want = np.stack([np.asarray(jcavity.molecular_dipole(
        jnp.asarray(pos[b]), jnp.asarray(img[b]), jnp.asarray(box[b]),
        jnp.asarray(charge[b]), jnp.asarray(mask))) for b in range(B)])
    assert_forces(got, want)
    shared = tcavity.molecular_dipole(
        torch.tensor(pos), torch.tensor(img), ts.box_L, ts.charge,
        ts.typeid == l_tid)
    assert_forces(shared[0], np.asarray(jcavity.molecular_dipole(
        jnp.asarray(pos[0]), jnp.asarray(img[0]), js.box_L, js.charge,
        js.typeid == l_tid)))


def _lj_tables(types):
    params = {k: {**v, "r_cut": 15.0} for k, v in LJ_PARAMS.items()}
    return (jlj.lj_pair_tables(types, params, dtype=jnp.float64),
            tlj.lj_pair_tables(types, params))


@pytest.mark.parametrize("excluded", [True, False], ids=["bonds", "none"])
def test_lj_dense_and_lj_dense_pair_match_jax(ref, excluded):
    js, ts = ref
    jt, tt = _lj_tables(list(ts.types))
    excl = (np.array(jlj.bond_exclusion_mask(js.N, js.bond_group))
            if excluded else None)
    fj, ej = jlj.lj_dense(js.position, js.box_L, js.typeid, *jt,
                          None if excl is None else jnp.asarray(excl))
    ft, et = tlj.lj_dense(ts.position, ts.box_L, ts.typeid, *tt, excl)
    assert_forces(ft, fj)
    assert_energy(et, ej)

    jpair = jlj.LJPairMatrices.create(js.typeid, *jt, excl)
    tpair = tlj.LJPairMatrices.create(ts.typeid, *tt, excl)
    fj2, ej2 = jlj.lj_dense_pair(js.position, js.box_L, jpair)
    ft2, et2 = tlj.lj_dense_pair(ts.position, ts.box_L, tpair)
    assert_forces(ft2, fj2)
    assert_energy(et2, ej2)
    # the two forms are one function of the scene
    assert_forces(ft2, fj)


@pytest.mark.parametrize("excluded", [True, False], ids=["bonds", "none"])
def test_ewald_real_space_and_its_pair_form_match_jax(ref, excluded):
    js, ts = ref
    excl = (np.array(jlj.bond_exclusion_mask(js.N, js.bond_group))
            if excluded else None)
    fj, ej = jewald.ewald_real_space(
        js.position, js.box_L, js.charge, KAPPA, 15.0,
        None if excl is None else jnp.asarray(excl))
    ft, et = tewald.ewald_real_space(ts.position, ts.box_L, ts.charge,
                                     KAPPA, 15.0, excl)
    assert_forces(ft, fj)
    assert_energy(et, ej)

    q = np.asarray(js.charge)
    qq = q[:, None] * q[None, :]
    active = (~np.eye(js.N, dtype=bool)) & (qq != 0)
    if excl is not None:
        active &= ~excl
    fj2, ej2 = jewald.ewald_real_space_pair(
        js.position, js.box_L, jnp.asarray(qq), jnp.asarray(active), KAPPA,
        15.0)
    ft2, et2 = tewald.ewald_real_space_pair(ts.position, ts.box_L, _t(qq),
                                            _t(active), KAPPA, 15.0)
    assert_forces(ft2, fj2)
    assert_energy(et2, ej2)
    assert_forces(ft2, fj)


def _neutral_scene():
    """Four +-0.5 dimers (bond 2 bohr, net dipole near zero) spread
    through a 12-bohr box, the dimers 5-6 bohr apart: small and well
    separated, so the image sum out to 2 boxes is a usable reference."""
    centres = np.array([[-3.0, -3.0, -3.0], [3.0, 3.0, -3.0],
                        [3.0, -3.0, 3.0], [-3.0, 3.0, 3.0]])
    axis = np.array([[1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, -1.0, 0]])
    pos = np.concatenate([centres + axis, centres - axis]).reshape(
        2, 4, 3).transpose(1, 0, 2).reshape(8, 3)
    pos += np.random.default_rng(11).normal(scale=0.1, size=pos.shape)
    charge = np.tile([0.5, -0.5], 4)
    bonds = np.arange(8).reshape(4, 2)
    return pos, charge, bonds, np.full(3, 12.0)


def test_coulomb_direct_reference_matches_jax():
    pos, q, bonds, box = _neutral_scene()
    for bg in (bonds, None):
        want = jewald.coulomb_direct_reference(pos, box, q, bg, nmax_real=1)
        got = tewald.coulomb_direct_reference(_t(pos), _t(box), _t(q),
                                              None if bg is None else _t(bg),
                                              nmax_real=1)
        assert got == pytest.approx(want, rel=RTOL)


def _ewald_total(ew, pp, pos, q, bonds, box, kappa, r_cut, lib):
    """E_real + E_mesh - E_self - E_excluded through one package."""
    excl = np.zeros((len(q), len(q)), dtype=bool)
    excl[bonds[:, 0], bonds[:, 1]] = excl[bonds[:, 1], bonds[:, 0]] = True
    params, order = pp.PPPMParams.create(box, mesh=MESH, order=ORDER,
                                         kappa=kappa)
    _, e_real = ew.ewald_real_space(lib(pos), lib(box), lib(q), kappa, r_cut,
                                    lib(excl))
    e_mesh = pp.pppm_reciprocal_energy(lib(pos), lib(q), lib(box), params,
                                       order, MESH)
    _, e_excl = ew.ewald_exclusion_correction(lib(pos), lib(box), lib(q),
                                              kappa, lib(bonds))
    return float(e_real + e_mesh - ew.ewald_self_energy(lib(q), kappa)
                 - e_excl)


def test_ewald_total_meets_the_direct_image_sum_as_jax_does():
    """The JAX package's Ewald total (real space + mesh - self -
    exclusions) on this scene is 1.80e-5 Ha (relative 3.3e-3) from the
    image sum out to 2 boxes: the sum's own truncation, which moves it by
    1.2e-4 Ha from 1 box to 4. The port's must come no further, and agree
    with JAX's to 1e-10."""
    pos, q, bonds, box = _neutral_scene()
    kappa = tewald.auto_kappa(6.0, 1e-10)
    direct = tewald.coulomb_direct_reference(pos, box, q, bonds)
    e_jax = _ewald_total(jewald, jpppm, pos, q, bonds, box, kappa, 6.0,
                         jnp.asarray)
    e_port = _ewald_total(tewald, tpppm, pos, q, bonds, box, kappa, 6.0, _t)
    assert e_port == pytest.approx(e_jax, rel=RTOL)
    gap_jax = abs(e_jax - direct)
    assert gap_jax < 5e-3 * abs(direct)
    assert abs(e_port - direct) <= gap_jax * (1 + 1e-6)


@pytest.fixture(scope="module")
def batch(ref):
    """Three jittered copies of the N = 501 scene, the port's (B, N, 3)."""
    _, ts = ref
    rng = np.random.default_rng(21)
    return np.stack([ts.position.numpy()
                     + rng.normal(scale=0.05, size=(ts.N, 3))
                     for _ in range(3)])


def test_pppm_reciprocal_energy_matches_jax_one_and_batched(ref, batch):
    js, ts = ref
    jparams, order = jpppm.PPPMParams.create(np.asarray(js.box_L), mesh=MESH,
                                            order=ORDER, kappa=KAPPA)
    tparams, _ = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=MESH,
                                         order=ORDER, kappa=KAPPA)
    ej = jpppm.pppm_reciprocal_energy(js.position, js.charge, js.box_L,
                                      jparams, order, MESH)
    et = tpppm.pppm_reciprocal_energy(ts.position, ts.charge, ts.box_L,
                                      tparams, order, MESH)
    assert_energy(et, ej)
    _, e_fe = tpppm.pppm_force_and_energy(ts.position, ts.charge, ts.box_L,
                                          tparams, order, MESH)
    assert float(et) == float(e_fe)

    ebj = jpppm.pppm_reciprocal_energy_batched(
        jnp.asarray(batch), js.charge, js.box_L, jparams, order, MESH)
    ebt = tpppm.pppm_reciprocal_energy(_t(batch), ts.charge, ts.box_L,
                                       tparams, order, MESH)
    assert ebt.shape == (3,)
    for b in range(3):
        assert_energy(ebt[b], ebj[b])


def test_pppm_reciprocal_energy_is_differentiable(ref):
    """Its gradient is the mesh force, as JAX's ``jax.grad`` of it is."""
    _, ts = ref
    params, order = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=MESH,
                                            order=ORDER, kappa=KAPPA)
    pos = ts.position.clone().requires_grad_(True)
    e = tpppm.pppm_reciprocal_energy(pos, ts.charge, ts.box_L, params,
                                     order, MESH)
    (grad,) = torch.autograd.grad(e, pos)
    f, _ = tpppm.pppm_force_and_energy(ts.position, ts.charge, ts.box_L,
                                       params, order, MESH)
    np.testing.assert_array_equal(-grad.numpy(), f.numpy())


def test_make_pppm_force_energy_matches_jax_one_and_batched(ref, batch):
    js, ts = ref
    jparams, order = jpppm.PPPMParams.create(np.asarray(js.box_L), mesh=MESH,
                                            order=ORDER, kappa=KAPPA)
    tparams, _ = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=MESH,
                                         order=ORDER, kappa=KAPPA)
    jfe = jpppm.make_pppm_force_energy(order, MESH)
    tfe = tpppm.make_pppm_force_energy(order, MESH)
    fj, ej = jfe(js.position, js.charge, js.box_L, jparams)
    ft, et = tfe(ts.position, ts.charge, ts.box_L, tparams)
    assert_forces(ft, fj)
    assert_energy(et, ej)

    fbj, ebj = jax.vmap(jfe, in_axes=(0, None, None, None))(
        jnp.asarray(batch), js.charge, js.box_L, jparams)
    fbt, ebt = tfe(_t(batch), ts.charge, ts.box_L, tparams)
    for b in range(3):
        assert_forces(fbt[b], fbj[b])
        assert_energy(ebt[b], ebj[b])


def test_field_autocorrelation_matches_jax():
    rng = np.random.default_rng(5)
    f0, ft = (rng.normal(size=(64, 2)) @ np.array([1.0, 1j]) for _ in "ab")
    want = float(jobs.field_autocorrelation(jnp.asarray(f0), jnp.asarray(ft)))
    got = tobs.field_autocorrelation(torch.as_tensor(f0),
                                     torch.as_tensor(ft))
    assert float(got) == pytest.approx(want, rel=RTOL)
    assert float(tobs.field_autocorrelation(f0, ft)) == float(got)
