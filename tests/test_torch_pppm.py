"""Kernels 2 and 3's plain twins (ops/pppm_kernels.py) and the mesh energy
(ops/pppm.py) against the JAX PPPM path: the XLA spread and
pppm_force_and_energy in float64, the Pallas spread kernel and its vjp in
interpret mode in float32, and the exact k-space Ewald sum."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.ops import pppm as jpppm
from cavmd_tpu.ops.pppm_pallas import spread_grid_pallas
from cavmd_tpu_torch.ops import ewald as tewald
from cavmd_tpu_torch.ops import pppm as tpppm
from cavmd_tpu_torch.ops import pppm_kernels as sk

from test_torch_ops import scene


def _jax_grid(pos, q, box, order, mesh):
    Sx, Sy, Sz = jpppm._spread_matrices(pos, box, order, mesh)
    return ((q[:, None] * Sx).T @ (Sy[:, :, None] * Sz[:, None, :]).reshape(
        pos.shape[0], -1)).reshape(mesh)


@partial(jax.jit, static_argnums=(4, 5))
def _jax_grid_and_vjp(pos, q, box, ct, order, mesh):
    """The XLA grid and its vjp against the cotangent ``ct``, one compile
    an order and mesh."""
    grid, vjp = jax.vjp(lambda p: _jax_grid(p, q, box, order, mesh), pos)
    return grid, vjp(ct)[0]


def _random_system(n, box, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) - 0.5) * np.asarray(box)
    q = rng.standard_normal(n)
    q[-1] = 0.0  # a photon-like neutral particle
    return pos, q


def test_bspline_weights_match_jax():
    frac = np.random.default_rng(1).random(200)
    for order in (4, 5, 6, 7):
        wj, wpj = jpppm.bspline_weights(jnp.asarray(frac), order)
        wt, wpt = tpppm.bspline_weights(torch.as_tensor(frac), order)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-15)
        np.testing.assert_allclose(wpt.numpy(), np.asarray(wpj), atol=1e-15)
        np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, atol=1e-14)
        assert tpppm.bspline_int_values(order).tolist() == \
            jpppm.bspline_int_values(order).tolist()


@pytest.mark.parametrize("mesh,box,order", [
    pytest.param((16, 16, 16), (24.0, 24.0, 24.0), 6, id="mesh0-box0"),
    pytest.param((8, 16, 32), (22.0, 30.0, 41.0), 6, id="mesh1-box1"),
    *[pytest.param((16, 16, 16), (24.0, 24.0, 24.0), p, id=f"order{p}")
      for p in (2, 3, 4, 5, 7, 8)]])
def test_spread_and_interpolation_match_xla_f64(mesh, box, order):
    """Kernels 2 and 3 are instantiated once an order (2-8): their twins
    are held to the XLA spread and its vjp at each."""
    pos, q = _random_system(48, box, 7)
    ct = np.random.default_rng(8).standard_normal(mesh)
    grid_j, dref = _jax_grid_and_vjp(jnp.asarray(pos), jnp.asarray(q),
                                     jnp.asarray(box), jnp.asarray(ct),
                                     order, mesh)
    t = torch.as_tensor
    grid_t = sk.spread_grid(t(pos), t(q), t(np.asarray(box)), order, mesh)
    scale = float(jnp.abs(grid_j).max())
    np.testing.assert_allclose(grid_t.numpy(), np.asarray(grid_j), rtol=0,
                               atol=1e-10 * scale)

    dpos = sk.interpolate_grad(t(ct), t(pos), t(q), t(np.asarray(box)),
                               order, mesh)
    scale = float(jnp.abs(dref).max())
    np.testing.assert_allclose(dpos.numpy(), np.asarray(dref), rtol=0,
                               atol=1e-10 * scale)
    assert float(dpos[-1].abs().max()) == 0.0


def test_spread_autograd_function_gradcheck():
    """The interpolation is the exact adjoint of the spread (finite
    differences of the forward against the backward)."""
    pos, q = _random_system(6, (9.0, 10.0, 11.0), 3)
    p = torch.as_tensor(pos).requires_grad_(True)
    qq, box = torch.as_tensor(q), torch.tensor([9.0, 10.0, 11.0],
                                               dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x: sk.spread_grid_autograd(x, qq, box, 4, (8, 8, 8)), (p,),
        eps=1e-6, atol=1e-7)


def test_pppm_force_and_energy_match_jax_f64():
    js, ts = scene(n_mol=20, box_L=24.0)
    mesh = (16, 16, 16)
    jparams, order = jpppm.PPPMParams.create(np.asarray(js.box_L), mesh=mesh,
                                            order=6, kappa=0.35)
    tparams, _ = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=mesh,
                                         order=6, kappa=0.35)
    np.testing.assert_array_equal(tparams.influence.numpy(),
                                  np.asarray(jparams.influence))
    fj, ej = jpppm.pppm_force_and_energy(js.position, js.charge, js.box_L,
                                         jparams, order, mesh)
    ft, et = tpppm.pppm_force_and_energy(ts.position, ts.charge, ts.box_L,
                                         tparams, order, mesh)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=1e-10 * float(jnp.abs(fj).max()))
    assert float(et) == pytest.approx(float(ej), rel=1e-10)
    assert not ft.requires_grad and not et.requires_grad


def test_grid_and_forces_match_pallas_kernel_f32():
    """Against spread_grid_pallas in interpret mode, with the bounds of
    tests/test_pppm_pallas.py."""
    js, ts = scene(n_mol=40, box_L=28.0, seed=3, jitter=0.0)
    mesh, order = (16, 16, 16), 6
    pos = jnp.asarray(js.position, jnp.float32)
    q = jnp.asarray(js.charge, jnp.float32)
    box = jnp.asarray(js.box_L, jnp.float32)
    jparams, _ = jpppm.PPPMParams.create(np.asarray(js.box_L), mesh=mesh,
                                         order=order, kappa=0.35,
                                         dtype=jnp.float32)
    tparams, _ = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=mesh,
                                         order=order, kappa=0.35,
                                         dtype=torch.float32)
    t32 = ts.astype(torch.float32)

    grid_p = spread_grid_pallas(pos, q, box, order, mesh, 64, True)
    grid_t = sk.spread_grid(t32.position, t32.charge, t32.box_L, order, mesh)
    np.testing.assert_allclose(grid_t.reshape(mesh[0], -1).numpy(),
                               np.asarray(grid_p), rtol=0, atol=5e-5)

    def e_fn(p):
        g = spread_grid_pallas(p, q, box, order, mesh, 64, True)
        return jpppm._mesh_energy(g.reshape(mesh[0], 1, *mesh[1:]), jparams,
                                  mesh)[0]

    e_p, grad = jax.value_and_grad(e_fn)(pos)
    f_t, e_t = tpppm.pppm_force_and_energy(t32.position, t32.charge,
                                           t32.box_L, tparams, order, mesh)
    assert f_t.dtype == torch.float32
    scale = float(jnp.abs(grad).max())
    np.testing.assert_allclose(f_t.numpy(), -np.asarray(grad), rtol=0,
                               atol=2e-5 * scale)
    assert float(e_t) == pytest.approx(float(e_p), rel=1e-5)

    ct = np.random.default_rng(5).standard_normal(mesh).astype(np.float32)
    d_p = jax.vjp(lambda p: spread_grid_pallas(p, q, box, order, mesh, 64,
                                               True), pos)[1](
        jnp.asarray(ct.reshape(mesh[0], -1)))[0]
    d_t = sk.interpolate_grad(torch.as_tensor(ct), t32.position, t32.charge,
                              t32.box_L, order, mesh)
    scale = float(jnp.abs(d_p).max())
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_p), rtol=0,
                               atol=3e-4 * scale)


@pytest.mark.parametrize("mesh", [(32, 32, 32), (128, 128, 128)],
                         ids=["32", "128"])
def test_pppm_matches_exact_kspace(mesh):
    """tests/test_ewald.py's bar on the port: PPPM order 6 against the
    exact reciprocal sum, on the 32^3 mesh and on 128^3 (the bar of
    tests/test_ewald.py's 128^3 test: the port's spread holds no (N, Ky
    Kz) factor, so nothing bounds the mesh)."""
    _, ts = scene(n_mol=20, box_L=24.0, seed=23, jitter=0.0)
    kappa = 0.25
    params, order = tpppm.PPPMParams.create(ts.box_L.numpy(), mesh=mesh,
                                            order=6, kappa=kappa)
    f, e = tpppm.pppm_force_and_energy(ts.position, ts.charge, ts.box_L,
                                       params, order, mesh)
    f_ex, e_ex = tewald.ewald_kspace_exact(ts.position, ts.charge, ts.box_L,
                                           kappa, nmax=14)
    assert float(e) == pytest.approx(float(e_ex), rel=2e-5)
    np.testing.assert_allclose(f.numpy(), f_ex.numpy(), rtol=0,
                               atol=2e-5 * float(f_ex.abs().max()))


def test_kernel_wrappers_reject_non_cpu_non_cuda_tensors():
    pos, q = _random_system(8, (10.0, 10.0, 10.0), 2)
    box = torch.tensor([10.0, 10.0, 10.0], dtype=torch.float64)
    meta = torch.as_tensor(pos).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sk.spread_grid(meta, torch.as_tensor(q), box, 6, (8, 8, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        sk.interpolate_grad(torch.zeros(8, 8, 8, dtype=torch.float64), meta,
                            torch.as_tensor(q), box, 6, (8, 8, 8))
