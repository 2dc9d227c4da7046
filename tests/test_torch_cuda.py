"""The CUDA kernels of cavmd_tpu_torch against their plain twins on the
card. Marked ``cuda``; each test skips when no CUDA device is present (run
them on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m
cuda``)."""

import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops import pair_kernels as pk
from cavmd_tpu_torch.ops import pppm_kernels as sk
from cavmd_tpu_torch.ops.pppm import mesh_energy

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.float64: 1e-11}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _scene(dtype, device, n_mol=20, box_L=24.0):
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                seed=0),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=10.0,
                              pppm_mesh=(16, 16, 16))
    return snap, ff


def _close(a, b, tol):
    return float((a - b).abs().max()) <= tol * float(b.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_kernel_matches_twin(cuda, dtype):
    snap, ff = _scene(dtype, cuda)
    args = (snap.position, snap.box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
            ff.lj_rcut2, ff.lj_vshift, snap.charge, ff.lj_active,
            ff.coulomb_active, ff.kappa_value, ff.coulomb_rcut ** 2)
    before = _cuda.launches["dense_pair"]
    out_k = pk.dense_pair_force(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["dense_pair"] == before + 1
    out_p = pk.dense_pair_force_plain(*args)
    for k, p in zip(out_k, out_p):
        assert _close(k, p, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_and_interpolation_kernels_match_twins(cuda, dtype):
    snap, ff = _scene(dtype, cuda)
    args = (snap.position, snap.charge, snap.box_L, ff.pppm_order,
            ff.pppm_mesh)
    g_k = sk.spread_grid(*args)
    g_p = sk.spread_grid_plain(*args)
    torch.cuda.synchronize()
    assert _close(g_k, g_p, TOL[dtype])
    grid = g_p.detach().requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, ff.pppm), grid)
    d_k = sk.interpolate_grad(ct, *args)
    d_p = sk.interpolate_grad_plain(ct, *args)
    torch.cuda.synchronize()
    assert _close(d_k, d_p, TOL[dtype])


def test_forcefield_on_cuda_matches_cpu_f64(cuda):
    snap, ff = _scene(torch.float64, torch.device("cpu"))
    f_cpu, e_cpu = ff(snap.position, snap.image, snap.box_L, snap.charge,
                      snap.typeid)
    gsnap, gff = snap.to(cuda), ff.to(cuda)
    f_gpu, e_gpu = gff(gsnap.position, gsnap.image, gsnap.box_L,
                       gsnap.charge, gsnap.typeid)
    assert _close(f_gpu.cpu(), f_cpu, 1e-11)
    for k in e_cpu:
        assert abs(float(e_gpu[k]) - float(e_cpu[k])) <= 1e-11 * max(
            abs(float(e_cpu[k])), 1e-12)
