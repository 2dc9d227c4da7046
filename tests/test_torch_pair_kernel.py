"""Kernel 1's plain twin (ops/pair_kernels.py) against the JAX pair pass:
the XLA function fused_pair_force in float64 and the Pallas kernel
pallas_pair_apply in interpret mode in float32; and the wrapper's device
dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.ops.lj import fused_pair_force
from cavmd_tpu.ops.pallas_kernels import PallasPairPack, pallas_pair_apply
from cavmd_tpu_torch.integrate import ForceField
from cavmd_tpu_torch.ops import pair_kernels as pk

from test_torch_ops import port_forcefield, scene


def _pair_args(ff, snap):
    return (snap.position, snap.box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
            ff.lj_rcut2, ff.lj_vshift, snap.charge, ff.lj_active,
            ff.coulomb_active, ff.kappa_value, ff.coulomb_rcut ** 2)


def _jax_reference(jff, js, dtype):
    cast = (lambda x: x.astype(dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x)
    pair = type(jff.lj_pair)(*[cast(x) for x in (
        jff.lj_pair.rows_eps, jff.lj_pair.rows_sig2, jff.lj_pair.rows_rcut2,
        jff.lj_pair.rows_vshift, jff.lj_pair.oh)], jff.lj_pair.active)
    q = js.charge.astype(dtype)
    return fused_pair_force(
        js.position.astype(dtype), js.box_L.astype(dtype), pair,
        q[:, None] * q[None, :], jff.coulomb_active,
        jnp.asarray(jff.kappa, dtype), jff.coulomb_rcut)


@pytest.mark.parametrize("n_mol,box_L,r_cut", [(20, 24.0, 10.0),
                                               (40, 28.0, 12.0)])
def test_plain_twin_matches_xla_fused_pair_force_f64(n_mol, box_L, r_cut):
    js, ts = scene(n_mol=n_mol, box_L=box_L)
    jff = JForceField.create(js, coupling=1e-3, r_cut=r_cut,
                             pppm_mesh=(16, 16, 16))
    f_ref, elj_ref, eew_ref = _jax_reference(jff, js, jnp.float64)
    for tff in (ForceField.create(ts, coupling=1e-3, r_cut=r_cut,
                                  pppm_mesh=(16, 16, 16)),
                port_forcefield(jff, js)):
        f, elj, eew = pk.dense_pair_force(*_pair_args(tff, ts))
        scale = float(np.abs(np.asarray(f_ref)).max())
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                                   atol=1e-10 * scale)
        assert float(elj) == pytest.approx(float(elj_ref), rel=1e-10)
        assert float(eew) == pytest.approx(float(eew_ref), rel=1e-10)


@pytest.mark.parametrize("case", ["n3", "non_cubic"])
def test_plain_twin_matches_xla_at_n3_and_in_a_non_cubic_box_f64(case):
    """N = 3 (one molecule and the photon: every pair masked, the forces
    exactly zero) and a non-cubic box (each axis its own minimum image)."""
    n_mol, box = (1, None) if case == "n3" else (30, (24.0, 27.5, 31.0))
    js, ts = scene(n_mol=n_mol, box_L=24.0)
    if box is not None:
        js = js.replace(box_L=jnp.asarray(box))
        ts = ts.replace(box_L=torch.as_tensor(box, dtype=torch.float64))
    assert ts.N == 2 * n_mol + 1
    jff = JForceField.create(js, coupling=1e-3, r_cut=10.0,
                             pppm_mesh=(16, 16, 16))
    f_ref, elj_ref, eew_ref = _jax_reference(jff, js, jnp.float64)
    f, elj, eew = pk.dense_pair_force(*_pair_args(port_forcefield(jff, js),
                                                  ts))
    scale = float(np.abs(np.asarray(f_ref)).max())
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=1e-10 * scale)
    assert float(elj) == pytest.approx(float(elj_ref), rel=1e-10)
    assert float(eew) == pytest.approx(float(eew_ref), rel=1e-10)
    if case == "n3":
        assert scale == 0.0 and not bool(f.any())


def test_plain_twin_matches_pallas_kernel_f32():
    """Against the TPU kernel itself (interpret mode), with the bounds of
    tests/test_pallas.py: its erfc is the A&S approximation (1.5e-7 abs)."""
    js, ts = scene(n_mol=40, box_L=28.0, seed=5, jitter=0.0)
    jff = JForceField.create(js, coupling=1e-3, r_cut=12.0)
    q = np.asarray(js.charge)
    pack = PallasPairPack.create(jff.lj_pair, q[:, None] * q[None, :],
                                 np.asarray(jff.coulomb_active), js.N,
                                 tile=8)
    f_ref, elj_ref, eew_ref = pallas_pair_apply(
        js.position.astype(jnp.float32), js.box_L.astype(jnp.float32), pack,
        float(jff.kappa), jff.coulomb_rcut, tile=8, interpret=True)
    ts32 = ts.astype(torch.float32)
    tff = port_forcefield(jff, js, dtype=torch.float32)
    f, elj, eew = pk.dense_pair_force(*_pair_args(tff, ts32))
    assert f.dtype == torch.float32
    scale = float(np.abs(np.asarray(f_ref)).max())
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6 * scale)
    assert float(elj) == pytest.approx(float(elj_ref), rel=1e-5, abs=1e-9)
    assert float(eew) == pytest.approx(float(eew_ref), rel=1e-4, abs=1e-8)


def test_plain_twin_f32_matches_xla_f32():
    js, ts = scene(n_mol=20, box_L=24.0)
    jff = JForceField.create(js, coupling=1e-3, r_cut=10.0,
                             pppm_mesh=(16, 16, 16))
    f_ref, elj_ref, eew_ref = _jax_reference(jff, js, jnp.float32)
    tff = ForceField.create(ts.astype(torch.float32), coupling=1e-3,
                            r_cut=10.0, pppm_mesh=(16, 16, 16))
    f, elj, eew = pk.dense_pair_force(*_pair_args(tff, ts.astype(
        torch.float32)))
    scale = float(np.abs(np.asarray(f_ref)).max())
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=0,
                               atol=2e-6 * scale)
    assert float(elj) == pytest.approx(float(elj_ref), rel=1e-5)
    assert float(eew) == pytest.approx(float(eew_ref), rel=1e-5)


def test_photon_and_bonded_pairs_are_inert():
    """The photon row and column and the bonded pairs contribute nothing:
    moving the photon onto an atom changes no pair force or energy."""
    _, ts = scene(n_mol=10, box_L=20.0)
    ff = ForceField.create(ts, coupling=1e-3, r_cut=9.0,
                           pppm_mesh=(8, 8, 8))
    base = pk.dense_pair_force(*_pair_args(ff, ts))
    pos = ts.position.clone()
    pos[-1] = pos[0]
    moved = pk.dense_pair_force(*_pair_args(ff, ts.replace(position=pos)))
    for a, b in zip(base, moved):
        assert torch.equal(a, b)
    assert not ff.lj_active[0, 1] and not ff.coulomb_active[0, 1]
    assert not ff.lj_active[-1].any() and not ff.coulomb_active[:, -1].any()


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, ts = scene(n_mol=4, box_L=14.0)
    ff = ForceField.create(ts, coupling=1e-3, r_cut=6.0, pppm_mesh=(8, 8, 8))
    args = list(_pair_args(ff, ts))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.dense_pair_force(*args)
