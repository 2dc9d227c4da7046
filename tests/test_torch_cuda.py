"""The CUDA kernels of cavmd_tpu_torch against their plain twins on the
card. Marked ``cuda``; each test skips when no CUDA device is present (run
them on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m
cuda``)."""

import numpy as np
import pytest
import torch

import cavmd_tpu_torch as pt
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core.box import wrap_positions
from cavmd_tpu_torch.ops import _cuda
from cavmd_tpu_torch.ops import cell_kernels as ck
from cavmd_tpu_torch.ops import fused_integrator as fi
from cavmd_tpu_torch.ops import pair_kernels as pk
from cavmd_tpu_torch.ops import pppm_kernels as sk
from cavmd_tpu_torch.ops.neighbor import replica_list
from cavmd_tpu_torch.ops.pppm import PPPMParams, mesh_energy

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
                                seed=0, device="cpu"),
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


def _dense_inputs(dtype, device, n_mol, box=None, holes=False):
    """Kernel 1's arguments on the seeded scene of ``n_mol`` diatomics +
    photon: the reference density (the N = 501 scene in its 46-bohr box,
    r_cut 15) from 250 molecules up, a 24-bohr box with r_cut 10 below;
    ``box`` replaces the box (positions kept); ``holes`` drops a random
    fifth of both masks' pairs beyond the bonded ones."""
    from cavmd_tpu_torch.core.system import reference_box_for

    small = n_mol < 250
    box_L = 24.0 if small else (46.0 if n_mol == 250
                                else reference_box_for(n_mol))
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                seed=0, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    if box is not None:
        snap = snap.replace(box_L=torch.as_tensor(box, dtype=torch.float64))
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, pppm_mesh=(16, 16, 16),
                              **({"r_cut": 10.0} if small else {}))
    assert ff.pair_mode == "dense"
    lj, cw = ff.lj_active, ff.coulomb_active
    if holes:
        g = torch.Generator(device="cpu")
        g.manual_seed(9)
        keep = (torch.rand(lj.shape, generator=g) > 0.2).to(device)
        lj, cw = lj * keep, cw * keep
    return (snap.position, snap.box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
            ff.lj_rcut2, ff.lj_vshift, snap.charge, lj.contiguous(),
            cw.contiguous(), ff.kappa_value, ff.coulomb_rcut ** 2)


def _hold_dense(args, dtype):
    before = _cuda.launches["dense_pair"]
    out_k = pk.dense_pair_force(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["dense_pair"] == before + 1
    out_p = pk.dense_pair_force_plain(*args)
    for k, p in zip(out_k, out_p):
        assert bool(torch.isfinite(k).all())
        assert _close(k, p, TOL[dtype])
    return out_k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [3, 33, 501, 4001])
def test_pair_kernel_at_every_size(cuda, n, dtype):
    """Kernel 1 at N = 3 (every pair masked: exact zeros), 33, 501 (one row
    a block) and 4001 (four rows a block, four staged chunks)."""
    out = _hold_dense(_dense_inputs(dtype, cuda, (n - 1) // 2), dtype)
    if n == 3:
        assert not any(bool(t.any()) for t in out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["non_cubic", "holes"])
def test_pair_kernel_non_cubic_box_and_mask_holes(cuda, case, dtype):
    """A non-cubic box (each axis its own minimum image) and masks with
    random holes beyond the bonded pairs (the kernel reads the masks, not
    the bonds)."""
    args = (_dense_inputs(dtype, cuda, 250, box=(46.0, 50.0, 56.0))
            if case == "non_cubic"
            else _dense_inputs(dtype, cuda, 250, holes=True))
    _hold_dense(args, dtype)


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


def _spread_inputs(dtype, device, n_mol=250, scramble=False):
    """Positions, charges and box of the reference-density scene (250
    diatomics + photon: the N = 501 scene; molecules on a lattice in row
    order); ``scramble`` permutes the particles, so that a block's
    contiguous chunk is spread over the whole box."""
    from cavmd_tpu_torch.core.system import reference_box_for

    box_L = 46.0 if n_mol == 250 else reference_box_for(n_mol)
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                seed=0, device=device),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    snap = snap.astype(dtype)
    pos, q = snap.position, snap.charge
    if scramble:
        g = torch.Generator(device="cpu")
        g.manual_seed(5)
        perm = torch.randperm(snap.N, generator=g).to(device)
        pos, q = pos[perm].contiguous(), q[perm].contiguous()
    return pos, q, snap.box_L


def _hold_spread(pos, q, box, order, mesh, path="auto", tiled=None):
    """Kernel 2 on ``path`` against its twin at the file's TOL; returns the
    kernel's grid."""
    before = _cuda.launches["pppm_spread"]
    g_k = sk.spread_grid_cuda(pos, q, box, order, mesh, path=path,
                              tile_runs=tiled)
    torch.cuda.synchronize()
    assert _cuda.launches["pppm_spread"] == before + 1
    g_p = sk.spread_grid_plain(pos, q, box, order, mesh)
    assert g_k.shape == tuple(mesh) and bool(torch.isfinite(g_k).all())
    assert _close(g_k, g_p, TOL[pos.dtype])
    return g_k


SPREAD_MESHES = {"16": (16, 16, 16), "32": (32, 32, 32), "64": (64, 64, 64),
                 "128": (128, 128, 128), "20x24x32": (20, 24, 32)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["auto", "global", "tile"])
@pytest.mark.parametrize("mesh", sorted(SPREAD_MESHES))
def test_spread_kernel_at_every_mesh(cuda, mesh, path, dtype):
    """Kernel 2's global and tile paths and the wrapper's own pick against
    the twin, order 6, on cubic meshes from 16^3 to 128^3 and a non-cubic
    one."""
    pos, q, box = _spread_inputs(dtype, cuda)
    _hold_spread(pos, q, box, 6, SPREAD_MESHES[mesh], path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["global", "tile"])
@pytest.mark.parametrize("order", [4, 6, 8])
def test_spread_kernel_at_every_order(cuda, order, path, dtype):
    pos, q, box = _spread_inputs(dtype, cuda)
    _hold_spread(pos, q, box, order, (20, 24, 32), path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("path", ["global", "tile"])
@pytest.mark.parametrize("case", ["one_charge", "no_charge", "box_faces"])
def test_spread_kernel_edge_cases(cuda, case, path, dtype):
    """One charged particle; every charge zero (the grid stays zero); and
    particles exactly on the box faces (u = 0 and u = K: the columns
    wrap)."""
    pos, q, box = _spread_inputs(dtype, cuda)
    q = q.clone()
    if case == "one_charge":
        q[1:] = 0.0
    elif case == "no_charge":
        q.zero_()
    else:
        pos = pos.clone()
        L = box.to(dtype)
        pos[:64, 0] = -0.5 * L[0]
        pos[64:128, 1] = 0.5 * L[1]
        pos[128:192, 2] = -0.5 * L[2]
        pos[192:200] = 0.5 * L
    g = _hold_spread(pos, q, box, 6, (32, 32, 32), path)
    if case == "no_charge":
        assert not bool(g.any())
    if case == "one_charge":
        assert int((g != 0).sum()) == 6 ** 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_tile_path_falls_back_per_block(cuda, dtype):
    """In row order (the scenes' lattice) the tile path's blocks
    accumulate their runs of particles in their tiles; with the particles
    permuted, even a run of 32 reaches rows across the 32^3 mesh that do
    not fit the tile, and the block adds to the global mesh itself (all
    but a run of a few particles, such as the last block's one). Both hold
    against the twin."""
    counts = {}
    for scramble in (False, True):
        pos, q, box = _spread_inputs(dtype, cuda, n_mol=2000,
                                     scramble=scramble)
        tiled = torch.zeros(1, dtype=torch.int32, device=cuda)
        _hold_spread(pos, q, box, 6, (32, 32, 32), "tile", tiled)
        counts[scramble] = int(tiled)
    assert counts[False] > 10 * max(counts[True], 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spread_kernel_at_n_100001(cuda, dtype):
    """The default large-N scene (build_large_n(50_000)'s 50,000 diatomics
    + photon, 32^3): the wrapper takes the tile path, and its blocks
    accumulate runs of particles in their tiles."""
    pos, q, box = _spread_inputs(dtype, cuda, n_mol=50_000)
    assert pos.shape[0] == 100_001
    tiled = torch.zeros(1, dtype=torch.int32, device=cuda)
    _hold_spread(pos, q, box, 6, (32, 32, 32), "auto", tiled)
    assert int(tiled) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interpolation_kernel_on_the_128_mesh(cuda, dtype):
    """Kernel 3 against its twin on kernel 2's 128^3 grid of the N = 501
    scene, the cotangent from the mesh energy."""
    pos, q, box = _spread_inputs(dtype, cuda)
    mesh = (128, 128, 128)
    params, order = PPPMParams.create(
        box.cpu().numpy(), mesh=mesh, order=6, kappa=0.35, dtype=dtype,
        device=cuda)
    g_k = _hold_spread(pos, q, box, order, mesh)
    grid = g_k.detach().requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, params), grid)
    d_k = sk.interpolate_grad(ct, pos, q, box, order, mesh)
    d_p = sk.interpolate_grad_plain(ct, pos, q, box, order, mesh)
    torch.cuda.synchronize()
    assert _close(d_k, d_p, TOL[dtype])


def _hold_interpolate(pos, q, box, order, mesh, field=None):
    """Kernel 3 against its twin at the file's TOL, the cotangent from the
    mesh energy of the twin's grid of ``field`` (positions, charges; by
    default ``pos``, ``q``); returns the kernel's dE/dr."""
    dtype, device = pos.dtype, pos.device
    params, _ = PPPMParams.create(
        box.cpu().numpy(), mesh=mesh, order=order, kappa=0.35, dtype=dtype,
        device=device)
    grid = sk.spread_grid_plain(*(field or (pos, q)), box, order, mesh)
    grid.requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, params), grid)
    ct = ct.contiguous()
    before = _cuda.launches["pppm_interpolate"]
    d_k = sk.interpolate_grad(ct, pos, q, box, order, mesh)
    torch.cuda.synchronize()
    assert _cuda.launches["pppm_interpolate"] == before + 1
    d_p = sk.interpolate_grad_plain(ct, pos, q, box, order, mesh)
    assert d_k.shape == pos.shape and bool(torch.isfinite(d_k).all())
    assert _close(d_k, d_p, TOL[dtype])
    assert not bool(d_k[q == 0].any())  # q = 0 rows: exact zeros
    return d_k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [2, 3, 4, 5, 6, 7, 8])
def test_interpolation_kernel_at_every_order(cuda, order, dtype):
    """One instantiation an order: each against the twin, N = 501 on a
    non-cubic mesh."""
    pos, q, box = _spread_inputs(dtype, cuda)
    _hold_interpolate(pos, q, box, order, (20, 24, 32))


INTERP_SIZES = {"n1": (0, False), "n31": (15, False), "n501": (250, False),
                "n4001": (2000, False), "n100001": (50_000, False),
                "n100001_scrambled": (50_000, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", sorted(INTERP_SIZES))
def test_interpolation_kernel_at_every_size(cuda, size, dtype):
    """N = 1 (one charged particle: one warp of one particle), 31, 501,
    4001 (fewer particles a warp) and 100,001 (32 a warp) in lattice order
    and scrambled, order 6 on the 32^3 mesh. The lone particle sits in the
    field of the N = 501 scene: its own field's pull on it cancels to
    ~1e-5 of the terms summed, below float32's rounding of them."""
    n_mol, scramble = INTERP_SIZES[size]
    field = None
    if n_mol == 0:
        field_pos, field_q, box = _spread_inputs(dtype, cuda)
        field = (field_pos, field_q)
        pos, q = field_pos[:1].contiguous(), field_q[:1].contiguous()
        assert bool(q[0] != 0)
    else:
        pos, q, box = _spread_inputs(dtype, cuda, n_mol=n_mol,
                                     scramble=scramble)
    assert pos.shape[0] == max(1, 2 * n_mol + 1)
    _hold_interpolate(pos, q, box, 6, (32, 32, 32), field)


INTERP_MESHES = {"16": ((16, 16, 16), None), "32": ((32, 32, 32), None),
                 "8x16x32": ((8, 16, 32), (22.0, 30.0, 41.0))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mesh", sorted(INTERP_MESHES))
def test_interpolation_kernel_at_every_mesh(cuda, mesh, dtype):
    """Order 6 on cubic meshes and a non-cubic one in a non-cubic box (the
    N = 501 scene's positions scaled into it)."""
    shape, new_box = INTERP_MESHES[mesh]
    pos, q, box = _spread_inputs(dtype, cuda)
    if new_box is not None:
        nb = torch.as_tensor(new_box, dtype=box.dtype, device=cuda)
        pos, box = (pos * (nb / box).to(dtype)).contiguous(), nb
    _hold_interpolate(pos, q, box, 6, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_interpolation_kernel_on_the_box_faces(cuda, dtype):
    """Particles exactly on the box faces (u = 0 and u = K: the columns
    wrap) and a block of uncharged particles among them."""
    pos, q, box = _spread_inputs(dtype, cuda)
    pos, q = pos.clone(), q.clone()
    L = box.to(dtype)
    pos[:64, 0] = -0.5 * L[0]
    pos[64:128, 1] = 0.5 * L[1]
    pos[128:192, 2] = -0.5 * L[2]
    pos[192:200] = 0.5 * L
    q[40:80] = 0.0
    d = _hold_interpolate(pos, q, box, 6, (32, 32, 32))
    assert bool(d[:40].any()) and not bool(d[40:80].any())


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


def _integrator_inputs(dtype, device, n_mol=200, box_L=40.0):
    """K4/K5 inputs at a reference-density scene, with particles pushed
    across the +x face so the image update runs (all rows at N = 3)."""
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                seed=0, device=device),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    snap = snap.astype(dtype)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), 2)
    plan = fi.FusedIntegratorPlan(None, methods, snap.N, dtype)
    g = torch.Generator(device=device)
    g.manual_seed(3)
    pos = snap.position.clone()
    pos[:8, 0] = 0.5 * box_L - 1e-3
    vel = snap.velocity.clone()
    vel[:8, 0] = 5e-3
    frc = 1e-3 * torch.randn(pos.shape, generator=g, dtype=dtype,
                             device=device)
    dt = torch.tensor(20.0, dtype=dtype, device=device)
    scal = torch.randn(5, generator=g, dtype=dtype, device=device)
    mol = snap.typeid != 2
    pre = (plan, pos, snap.image, vel, frc, snap.mass, mol, snap.box_L, dt,
           torch.exp(-dt / methods[0].tau), kT, scal[0],
           torch.tensor(methods[0].dof - 1.0, dtype=dtype, device=device))
    c_ou = torch.exp(-methods[1].gamma * dt)
    sig = torch.sqrt((1.0 - c_ou * c_ou) * kT / snap.mass[plan.photon])
    post = (plan, vel, frc, snap.mass, mol, dt, c_ou, sig,
            scal[2:].reshape(1, 3))
    return pre, post


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_integrator_kernels_match_twins(cuda, dtype):
    """Each output within TOL of its twin's largest value, except the two
    reservoir deltas: they are small differences of kinetic energies, so
    their rounding scales with the energy they come from (K4: the
    molecules' KE; K5: the photon's KE before its OU step), as
    chip_smoke.py holds them."""
    pre, post = _integrator_inputs(dtype, cuda)
    before = dict(_cuda.launches)
    k = fi.pre_force_apply(*pre)
    p = fi.pre_force_apply_plain(*pre)
    kp = fi.post_force_apply(*post)
    pp = fi.post_force_apply_plain(*post)
    torch.cuda.synchronize()
    for name in ("fused_pre_force", "fused_post_force"):
        assert _cuda.launches[name] == before.get(name, 0) + 1
    assert torch.equal(k[1], p[1]) and not torch.equal(k[1], pre[2])
    for a, b in zip((k[0], k[2]) + tuple(kp[:3]), (p[0], p[2])
                    + tuple(pp[:3])):
        assert _close(a, b, TOL[dtype])
    vel, mass, mol = pre[3], pre[5], pre[6]
    ke_mol = float(0.5 * (mass[:, None] * vel * vel)[mol].sum())
    ke_photon = float(pp[2].abs() + pp[3].abs())
    for a, b, scale in ((k[3], p[3], ke_mol), (kp[3], pp[3], ke_photon)):
        assert float((a - b).abs()) <= TOL[dtype] * max(
            float(b.abs()), scale)


def _cell_inputs(dtype, device, n_mol, box_L, r_cut, squeeze=1.0,
                 cell_cap=None, seed=3):
    """Cell-kernel arguments on a seeded scene; ``squeeze`` < 1 scales the
    positions toward the box centre (bonds and exclusions kept), so most
    candidate pairs lie inside the cutoff."""
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                seed=seed, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=seed + 1)
    snap = snap.replace(position=snap.position * squeeze)
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=r_cut,
                              pppm_mesh=(8, 8, 8), pair_mode="cell",
                              cell_cap=cell_cap)
    clist = ff.build_cells(snap.position, snap.box_L)
    assert not bool(clist.overflow)
    return (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
            snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value)


def _hold_cell_kernel(args, dtype):
    name = ck.kernel_name(args[3])
    before = _cuda.launches[name]
    out_k = ck.cell_pair_force_fused(*args)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 1
    out_p = ck.cell_pair_force_fused_plain(*args)
    for k, p in zip(out_k, out_p):
        assert _close(k, p, TOL[dtype])


# (n_mol, box_L, r_cut): 3^3 cells (the K6 grid) and 2^3 cells (the K8
# grid, deduplicated neighbour table)
CELL_GRIDS = {"k6_3cells": (60, 40.0, 12.0), "k8_2cells": (60, 34.0, 15.0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", sorted(CELL_GRIDS))
def test_cell_kernel_matches_twin(cuda, grid, dtype):
    args = _cell_inputs(dtype, cuda, *CELL_GRIDS[grid])
    assert (min(args[3].ncells) >= 3) == (grid == "k6_3cells")
    _hold_cell_kernel(args, dtype)


# the OCO triatomic liquid of tests/test_polyatomic.py: bonds [[3m, 3m+1],
# [3m, 3m+2]], so each carbon's exclusion row holds two partners
TRI_R0 = 2.2
TRI_LJ = {
    ("C", "C"): dict(epsilon=2.0e-4, sigma=5.2),
    ("O", "O"): dict(epsilon=1.6e-4, sigma=5.8),
    ("C", "O"): dict(epsilon=1.8e-4, sigma=5.5),
}
TRI_BONDS = {"C-O": dict(k=0.8, r0=TRI_R0)}


def triatomic_arrays(n_mol=27, box_L=36.0, seed=0):
    """tests/test_polyatomic.py:make_triatomic_system as NumPy arrays for
    ``Snapshot.create``: a cubic lattice of linear OCO molecules with
    random orientations, strained by 0.08-bohr noise."""
    rng = np.random.default_rng(seed)
    n_side = int(np.ceil(n_mol ** (1 / 3)))
    spacing = box_L / n_side
    grid = np.arange(n_side) * spacing - box_L / 2 + spacing / 2
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                       axis=-1).reshape(-1, 3)[:n_mol]
    u = rng.normal(size=(n_mol, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.empty((3 * n_mol, 3))
    pos[0::3] = centers
    pos[1::3] = centers + TRI_R0 * u
    pos[2::3] = centers - TRI_R0 * u
    pos += rng.normal(scale=0.08, size=pos.shape)
    base = 3 * np.arange(n_mol)
    bond_group = np.stack([np.repeat(base, 2),
                           np.stack([base + 1, base + 2], 1).reshape(-1)],
                          axis=1)
    return dict(position=pos, box_L=[box_L] * 3,
                typeid=np.tile([0, 1, 1], n_mol),
                charge=np.tile([0.4, -0.2, -0.2], n_mol),
                mass=np.tile([21894.0, 29164.0, 29164.0], n_mol),
                types=("C", "O"), bond_group=bond_group,
                bond_typeid=np.zeros(len(bond_group), np.int64),
                bond_types=("C-O",))


def _triatomic(dtype, device, pair_mode, r_cut, n_mol=167, box_L=46.0):
    """The triatomic scene at the reference density (167 molecules, 501
    atoms in the N = 501 scene's 46-bohr box) and its force field."""
    from cavmd_tpu_torch.core.snapshot import Snapshot

    a = triatomic_arrays(n_mol, box_L)
    snap = Snapshot.create(a.pop("position"), dtype=dtype, device=device,
                           **a)
    ff = pt.ForceField.create(snap, enable_cavity=False, lj_params=TRI_LJ,
                              bond_params=TRI_BONDS, r_cut=r_cut,
                              pppm_mesh=(16, 16, 16), pair_mode=pair_mode)
    return snap, ff


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode,r_cut", [("dense", 15.0), ("cell", 12.0),
                                        ("cell", 15.0)])
def test_kernels_with_degree_two_exclusion_rows(cuda, mode, r_cut, dtype):
    """K1 (the dense mask of a shared-centre topology) and the cell kernel
    (exclusion rows of two partners; 3^3 cells at r_cut 12, the small
    grid at 15) on the triatomic scene against their twins; two calls
    bit-equal."""
    snap, ff = _triatomic(dtype, cuda, mode, r_cut)
    assert not ff.bonds_strided
    if mode == "dense":
        args = (snap.position, snap.box_L, snap.typeid, ff.lj_eps,
                ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift, snap.charge,
                ff.lj_active, ff.coulomb_active, ff.kappa_value,
                ff.coulomb_rcut ** 2)
        first = _hold_dense(args, dtype)
        second = pk.dense_pair_force(*args)
    else:
        assert ff.cell_exclusions.shape[1] == 2
        assert (min(ff.cell_cfg.ncells) >= 3) == (r_cut == 12.0)
        clist = ff.build_cells(snap.position, snap.box_L)
        assert not bool(clist.overflow)
        args = (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
                snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
        _hold_cell_kernel(args, dtype)
        first = ck.cell_pair_force_fused(*args)
        second = ck.cell_pair_force_fused(*args)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def _slab_scene(dtype, device, shift_x=0.0):
    """tests/test_domain.py's scene (550 diatomics + photon, 65-bohr box,
    r_cut 8, 7^3 cells), its x coordinates shifted by ``shift_x`` and
    wrapped (32.5 bohr puts 62 molecules across the periodic x face)."""
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(550, box_L=65.0, temperature_K=100.0,
                                seed=0, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    pos, image = wrap_positions(snap.position + torch.tensor(
        [shift_x, 0.0, 0.0], dtype=snap.position.dtype), snap.box_L)
    snap = snap.replace(position=pos, image=snap.image + image)
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=8.0,
                              pppm_mesh=(16, 16, 16), pair_mode="cell")
    return snap, ff


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,shift_x", [(1, 0.0), (1, 32.5), (2, 0.0)])
def test_slab_kernel_matches_twin(cuda, S, shift_x, dtype):
    """The slab tile kernel (K7's counterpart) against its plain twin on
    rank 0's extended grid of the first chunk; at S = 1 also with bonded
    pairs across the periodic x face (met through the halo copies). The
    Ewald energy of one slab is a small sum of larger terms of both signs
    (5e-6 Ha at S = 2), so its scale is the same sum over |q_i q_j|."""
    from cavmd_tpu_torch.integrate import init_state
    from cavmd_tpu_torch.parallel import domain as dm

    snap, ff = _slab_scene(dtype, cuda, shift_x)
    plan = dm.plan_domain(snap, ff, S)
    args, cells, key = dm.tile_pass_inputs(ff, plan,
                                           init_state(snap, ff, dt=1.0))
    before = _cuda.launches["cell_pair_slab"]
    out_k = ck.cell_pair_force_slab(*args, cells, key)
    torch.cuda.synchronize()
    assert _cuda.launches["cell_pair_slab"] == before + 1
    out_p = ck.cell_pair_force_fused_plain(*args, pair_key=key)
    abs_q = list(args)
    abs_q[5] = args[5].abs()
    ew_scale = float(ck.cell_pair_force_fused_plain(*abs_q,
                                                    pair_key=key)[2])
    tol = TOL[dtype]
    assert _close(out_k[0], out_p[0], tol)
    assert _close(out_k[1], out_p[1], tol)
    assert float((out_k[2] - out_p[2]).abs()) <= tol * ew_scale


def _zcol_scene(dtype, device, n_mol=500):
    """500 diatomics + photon at the reference density, r_cut 12: 4 x 4
    columns of capacity 128, hulls of up to 5 of the 9 j-blocks, some of
    them in two runs across the z seam. With ``n_mol=2000``: 7 x 7 columns
    of capacity 256 (tests/test_torch_zcol.py's drift scene)."""
    from cavmd_tpu_torch.core.system import reference_box_for

    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(n_mol, box_L=reference_box_for(n_mol),
                                temperature_K=100.0, seed=3, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=4)
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=12.0,
                              pppm_mesh=(8, 8, 8), pair_mode="zcol")
    return snap, ff


def _zcol_args(ff, snap, clist, position, W):
    return (position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
            snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("window", ["planned", "one"])
def test_zcol_kernel_matches_twin(cuda, window, dtype):
    """The zcol kernel (K9's counterpart) against its plain twin, on a
    scene with two-run hulls: with the planned window, and with W = 1,
    where both drop the same blocks and set the window flag."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    snap, ff = _zcol_scene(dtype, cuda)
    clist = ff.build_cells(snap.position, snap.box_L)
    pos_loc = zk.zcol_local_positions(snap.position, snap.box_L, clist)
    hull, _, _ = zk.zcol_hull(pos_loc, snap.box_L, clist, ff.cell_cfg,
                              ff.zcol_W)
    nb = 9 * ff.cell_cfg.cap // 128
    assert bool((hull[..., 2] < nb).any()), "no two-run hull"
    W = ff.zcol_W if window == "planned" else 1
    args = _zcol_args(ff, snap, clist, snap.position, W)
    before = _cuda.launches["zcol_pair"]
    out_k = zk.zcol_pair_force(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["zcol_pair"] == before + 1
    out_p = zk.zcol_pair_force_plain(*args)
    assert bool(out_k[3]) == bool(out_p[3]) == (window == "one")
    for k, p in zip(out_k[:3], out_p[:3]):
        assert _close(k, p, TOL[dtype])


def _zcol_drifted(dtype, device):
    """tests/test_torch_zcol.py's drift scene at its largest drift: the
    2000-molecule scene, its column list built at the start, then every
    particle moved by up to 0.49 skin (numpy seed 0) and re-wrapped, the
    list kept. Returns (snap, ff, clist, drifted positions)."""
    snap, ff = _zcol_scene(dtype, device, n_mol=2000)
    clist = ff.build_cells(snap.position, snap.box_L)
    direction = np.random.default_rng(0).uniform(-1, 1, size=(snap.N, 3))
    direction *= 0.49 * ff.cell_cfg.skin / np.abs(direction).max()
    box = snap.box_L.double().cpu().numpy()
    pos = snap.position.double().cpu().numpy() + direction
    pos = pos - box * np.round(pos / box)
    return snap, ff, clist, torch.as_tensor(pos, dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["scene", "drift", "window_one"])
def test_zcol_hull_kernel_equals_twins(cuda, case, dtype):
    """The hull kernel, launched as zcol_pair_force launches it: its hull
    and window flag bit-equal to the twins' (zcol_local_positions, then
    zcol_hull), and its table's rows to the twins' local coordinates and
    the charges: on the 500-molecule scene (two-run hulls across the z
    seam), on the 2000-molecule scene after a drift of 0.49 skin with the
    list kept, and at W = 1 (flag set)."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    if case == "drift":
        snap, ff, clist, position = _zcol_drifted(dtype, cuda)
    else:
        snap, ff = _zcol_scene(dtype, cuda)
        clist = ff.build_cells(snap.position, snap.box_L)
        position = snap.position
    W = 1 if case == "window_one" else ff.zcol_W
    before = _cuda.launches["zcol_hull"]
    hull, flags, loc, W_k = zk._launch_hull(position, snap.box_L, clist,
                                            ff.cell_cfg, snap.charge, W)
    torch.cuda.synchronize()
    assert _cuda.launches["zcol_hull"] == before + 1
    pos_loc = zk.zcol_local_positions(position, snap.box_L, clist)
    ref, ref_flag, W_t = zk.zcol_hull(pos_loc, snap.box_L, clist,
                                      ff.cell_cfg, W)
    assert hull.dtype == ref.dtype and torch.equal(hull, ref) and W_k == W_t
    assert bool(flags.any()) == bool(ref_flag) == (case == "window_one")
    slotted = clist.bucket_idx[clist.bucket_idx < snap.N].long()
    assert slotted.numel() == snap.N
    assert torch.equal(loc[slotted, :3], pos_loc[slotted])
    assert torch.equal(loc[slotted, 3], snap.charge[slotted])
    nb = 9 * ff.cell_cfg.cap // 128
    assert bool((ref[..., 2] < nb).any()), "no two-run hull"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zcol_kernel_matches_twin_after_drift(cuda, dtype):
    """The pair pass against its twin on the drifted 2000-molecule scene:
    local coordinates that re-wrapped since the build, hulls grown by the
    drift, and the z-chunk pruning on rows no longer exactly sorted."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    snap, ff, clist, position = _zcol_drifted(dtype, cuda)
    args = _zcol_args(ff, snap, clist, position, ff.zcol_W)
    out_k = zk.zcol_pair_force(*args)
    out_p = zk.zcol_pair_force_plain(*args)
    assert not bool(out_k[3]) and not bool(out_p[3])
    for k, p in zip(out_k[:3], out_p[:3]):
        assert _close(k, p, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_zcol_kernel_at_a_retry_grown_window(cuda, dtype):
    """The 500-molecule scene re-planned twice by the overflow retry
    (ForceField.with_cell_capacity: cap 128 -> 256 -> 512, W 7 -> 11),
    its window widened, where it is not already, past the 48 KB of shared
    memory a launch gets without raising the limit (17 in float32; 11 in
    float64 is past it): the launch raises the kernel's limit, and the
    pass holds against its twin."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    snap, ff = _zcol_scene(dtype, cuda)
    for _ in range(2):
        cap = ff.cell_cfg.cap
        ff = ff.with_cell_capacity(max(cap + 4, 2 * cap))
    assert ff.cell_cfg.cap == 512
    row_bytes = 128 * (4 * torch.empty((), dtype=dtype).element_size() + 8)
    W = max(ff.zcol_W, 48 * 1024 // row_bytes + 1)
    assert W * row_bytes > 48 * 1024 and W <= 9 * 512 // 128
    clist = ff.build_cells(snap.position, snap.box_L)
    args = _zcol_args(ff, snap, clist, snap.position, W)
    out_k = zk.zcol_pair_force(*args)
    torch.cuda.synchronize()
    out_p = zk.zcol_pair_force_plain(*args)
    assert not bool(out_k[3]) and not bool(out_p[3])
    for k, p in zip(out_k[:3], out_p[:3]):
        assert _close(k, p, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 3])
def test_zcol_kernel_row_blocks(cuda, B, dtype):
    """The zcol pair kernel with a row range (``zcol_pair_rows``) on three
    uneven row blocks of the 500-molecule scene (B = 1) and of three
    jittered replicas of it in one launch (B = 3): each block against its
    twin with the same range (TOL), zero outside its rows, one launch
    counted as ``zcol_pair_rows``; the blocks' forces summed equal the
    full launch's bit for bit and their energy shares summed within TOL
    of its energies."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    if B == 1:
        snap, ff = _zcol_scene(dtype, cuda)
        clist = ff.build_cells(snap.position, snap.box_L)
        args = _zcol_args(ff, snap, clist, snap.position, ff.zcol_W)
    else:
        ff, snap, _, clist, args = _batched_pair_inputs(dtype, cuda, B,
                                                        "zcol")
    n = snap.N
    full = zk.zcol_pair_force(*args)
    summed, shares = torch.zeros_like(full[0]), [0.0, 0.0]
    for r0, r1 in ((0, 300), (300, 301), (301, n)):
        before = dict(_cuda.launches)
        out_k = zk.zcol_pair_force(*args, rows=(r0, r1 - r0))
        torch.cuda.synchronize()
        assert _cuda.launches["zcol_pair_rows"] == before.get(
            "zcol_pair_rows", 0) + 1
        assert _cuda.launches["zcol_pair"] == before.get("zcol_pair", 0)
        out_p = zk.zcol_pair_force_plain(*args, rows=(r0, r1 - r0))
        for k, p in zip(out_k[:3], out_p[:3]):
            assert _close(k, p, TOL[dtype])
        assert torch.equal(out_k[3], full[3])
        outside = torch.ones(n, dtype=torch.bool, device=cuda)
        outside[r0:r1] = False
        assert bool((out_k[0][..., outside, :] == 0).all())
        summed = summed + out_k[0]
        shares = [shares[0] + out_k[1], shares[1] + out_k[2]]
    assert torch.equal(summed, full[0])
    for got, want in zip(shares, full[1:3]):
        assert _close(got, want, TOL[dtype])


def test_zcol_wrapper_issues_few_device_operations(cuda):
    """On a CUDA tensor zcol_pair_force issues at most 6 device operations
    a call (zero the forces, the hull kernel, the pair kernel, the energy
    sum, the flag) and reads nothing back (sync debug mode "error"). The
    profiler may drop some of a trace's device operations, so only a
    complete trace counts: one that holds each kernel of the wrapper
    exactly once a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cavmd_tpu_torch.ops import zcol_kernels as zk

    snap, ff = _zcol_scene(torch.float32, cuda)
    clist = ff.build_cells(snap.position, snap.box_L)
    args = _zcol_args(ff, snap, clist, snap.position, ff.zcol_W)
    zk.zcol_pair_force(*args)
    torch.cuda.synchronize()
    reps = 3
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(reps):
                    zk.zcol_pair_force(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        complete = all(sum(k in name for name in names) == reps
                       for k in ("zcol_hull_kernel", "zcol_pair_kernel"))
        if complete:
            break
    assert complete, f"no complete trace: {names}"
    assert len(names) <= 6 * reps


# K4 grids of one block (N = 3, 1023), two (1025) and the full card
# (100,001: molecules plus the photon)
PRE_FORCE_SIZES = (1, 511, 512, 50_000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_mol", PRE_FORCE_SIZES)
def test_pre_force_kernel_matches_twin_at_every_grid_size(cuda, n_mol, dtype):
    """K4's cooperative grid against its twin: image flags equal, the
    other outputs within TOL (the reservoir delta against the molecules'
    kinetic energy, as in test_fused_integrator_kernels_match_twins)."""
    from cavmd_tpu_torch.core.system import reference_box_for

    pre, _ = _integrator_inputs(dtype, cuda, n_mol=n_mol,
                                box_L=reference_box_for(n_mol))
    assert pre[1].shape[0] == 2 * n_mol + 1
    before = _cuda.launches["fused_pre_force"]
    k = fi.pre_force_apply(*pre)
    p = fi.pre_force_apply_plain(*pre)
    torch.cuda.synchronize()
    assert _cuda.launches["fused_pre_force"] == before + 1
    assert torch.equal(k[1], p[1]) and not torch.equal(k[1], pre[2])
    assert _close(k[0], p[0], TOL[dtype]) and _close(k[2], p[2], TOL[dtype])
    vel, mass, mol = pre[3], pre[5], pre[6]
    ke_mol = float(0.5 * (mass[:, None] * vel * vel)[mol].sum())
    assert float((k[3] - p[3]).abs()) <= TOL[dtype] * max(float(p[3].abs()),
                                                          ke_mol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("photon", ["cavity", "none", "block_edge"])
@pytest.mark.parametrize("n_mol", PRE_FORCE_SIZES)
def test_post_force_kernel_matches_twin_at_every_grid_size(cuda, n_mol,
                                                           photon, dtype):
    """K5's cooperative grid against its twin at K4's grid sizes: with the
    photon's OU row (the last row), with no Langevin row
    (``plan.photon = -1``), and with the OU row on the first row of the
    grid's second block (row 0 at N = 3). Velocities bit-equal; the sums
    within TOL (the reservoir delta against the photon's KE before its
    step)."""
    from cavmd_tpu_torch.core.system import reference_box_for

    _, post = _integrator_inputs(dtype, cuda, n_mol=n_mol,
                                 box_L=reference_box_for(n_mol))
    plan, n = post[0], post[1].shape[0]
    if photon == "none":
        plan.photon = -1
    elif photon == "block_edge":
        plan.photon = fi.GRID_THREADS if n > fi.GRID_THREADS else 0
    before = _cuda.launches["fused_post_force"]
    k = fi.post_force_apply(*post)
    p = fi.post_force_apply_plain(*post)
    torch.cuda.synchronize()
    assert _cuda.launches["fused_post_force"] == before + 1
    assert torch.equal(k[0], p[0])
    assert _close(k[1], p[1], TOL[dtype]) and _close(k[2], p[2], TOL[dtype])
    if photon == "none":
        assert float(k[3]) == 0.0 == float(p[3])
    else:
        ke_photon = float(p[2].abs() + p[3].abs())
        assert float((k[3] - p[3]).abs()) <= TOL[dtype] * max(
            float(p[3].abs()), ke_photon)
        assert not torch.equal(k[0][plan.photon], post[1][plan.photon])
    if n > fi.GRID_THREADS:
        assert fi.grid_blocks("post_force", n, dtype) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_kernel_on_a_compressed_scene(cuda, dtype):
    """60 diatomics + photon squeezed into the central cell of a 3^3 grid
    (r_cut 12): most candidates lie inside the cutoff, so the per-warp
    queue fills to 32 again and again within a row."""
    args = _cell_inputs(dtype, cuda, 60, 40.0, 12.0, squeeze=0.3,
                        cell_cap=128)
    pos, box, clist = args[:3]
    n = pos.shape[0]
    occ = (clist.bucket_idx < n).sum(dim=1)
    window = torch.cat([occ, occ.new_zeros(1)])[
        clist.neighbor_cells.long()].sum(dim=1)
    candidates = int((occ * window).sum())
    d = pos[:, None, :] - pos[None, :, :]
    d = d - box * torch.round(d / box)
    inside = int(((d * d).sum(-1) < args[3].r_cut ** 2).sum())
    assert candidates == n * n and inside > 0.5 * candidates
    _hold_cell_kernel(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cell_kernel_at_the_retry_grown_cap(cuda, dtype):
    """The 3^3 grid at the capacity of the overflow retry's third growth
    (max(cap + 4, 2 cap) three times): staged rows past the default 48 KB
    of shared memory."""
    cap = _cell_inputs(dtype, cuda, 60, 40.0, 12.0)[3].cap
    for _ in range(3):
        cap = max(cap + 4, 2 * cap)
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert 27 * cap * (4 * itemsize + 8) > 48 * 1024
    args = _cell_inputs(dtype, cuda, 60, 40.0, 12.0, cell_cap=cap)
    assert args[3].cap == cap
    _hold_cell_kernel(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_small_grid_splits_rows(cuda, dtype):
    """The N = 501 reference scene in cell mode (2^3 cells, K8's grid):
    each cell's rows are split over several blocks, and the result holds
    against the twin."""
    args = _cell_inputs(dtype, cuda, 250, 46.0, 15.0, seed=0)
    cfg = args[3]
    assert min(cfg.ncells) < 3
    assert ck.launch_blocks(cfg.total_cells, cfg.cap, cuda) > 2 * \
        cfg.total_cells
    _hold_cell_kernel(args, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["cell_3cells", "cell_2cells",
                                    "pre_force", "post_force", "dense_pair",
                                    "interpolate", "zcol"])
def test_two_calls_give_the_same_bits(cuda, kernel, dtype):
    """The cell kernel, K1, K3, K4, K5 and the zcol kernels sum in fixed
    orders (no atomics), so two calls on the same inputs are bit-equal."""
    if kernel == "zcol":
        from cavmd_tpu_torch.ops import zcol_kernels as zk

        snap, ff, clist, position = _zcol_drifted(dtype, cuda)
        args = _zcol_args(ff, snap, clist, position, ff.zcol_W)
        first, second = zk.zcol_pair_force(*args), zk.zcol_pair_force(*args)
    elif kernel == "dense_pair":
        args = _dense_inputs(dtype, cuda, 2000)
        first = pk.dense_pair_force(*args)
        second = pk.dense_pair_force(*args)
    elif kernel == "interpolate":
        pos, q, box = _spread_inputs(dtype, cuda, n_mol=2000)
        g = torch.Generator(device="cpu")
        g.manual_seed(4)
        ct = torch.randn((32, 32, 32), generator=g, dtype=dtype).to(cuda)
        first = (sk.interpolate_grad(ct, pos, q, box, 6, (32, 32, 32)),)
        second = (sk.interpolate_grad(ct, pos, q, box, 6, (32, 32, 32)),)
    elif kernel in ("pre_force", "post_force"):
        from cavmd_tpu_torch.core.system import reference_box_for

        pre, post = _integrator_inputs(dtype, cuda, n_mol=2000,
                                       box_L=reference_box_for(2000))
        if kernel == "pre_force":
            first, second = fi.pre_force_apply(*pre), fi.pre_force_apply(*pre)
        else:
            first = fi.post_force_apply(*post)
            second = fi.post_force_apply(*post)
    else:
        n_mol, box_L, r_cut = CELL_GRIDS[
            "k6_3cells" if kernel == "cell_3cells" else "k8_2cells"]
        args = _cell_inputs(dtype, cuda, n_mol, box_L, r_cut)
        first = ck.cell_pair_force_fused(*args)
        second = ck.cell_pair_force_fused(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# ------------------------------------------------------- replica batches
# K1-K5 with a leading replica axis (parallel/replicas.py): one launch for
# B replicas of the N = 501 reference scene, each replica's positions and
# velocities jittered apart
REPLICA_BATCHES = (1, 3, 8)


def _jitter(x, B, scale, seed):
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    return (x[None] + scale * torch.randn((B,) + tuple(x.shape), generator=g,
                                          dtype=x.dtype, device=x.device)
            ).contiguous()


def _hold_replicas(batched, one_call, B, tol, bits=False):
    """Each replica's outputs of the batched launch against the one-replica
    launch on its rows: bit-equal, or within ``tol`` of the largest."""
    for r in range(B):
        for got, want in zip(batched, one_call(r)):
            if bits:
                assert torch.equal(got[r], want), r
            else:
                assert _close(got[r], want, tol), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", REPLICA_BATCHES)
def test_batched_pair_kernel(cuda, B, dtype):
    """K1 over B replicas in one launch: against its twin on the batch,
    against the one-replica launch on each replica (within TOL: a batch
    runs more rows a block, so a row's j slices are summed in another
    order), two calls bit-equal."""
    args = _dense_inputs(dtype, cuda, 250)
    P = _jitter(args[0], B, 0.3, 1)
    bargs = (P,) + args[1:]
    before = _cuda.launches["dense_pair"]
    out_k = pk.dense_pair_force(*bargs)
    again = pk.dense_pair_force(*bargs)
    torch.cuda.synchronize()
    assert _cuda.launches["dense_pair"] == before + 2
    assert out_k[0].shape == (B, 501, 3) and out_k[1].shape == (B,)
    out_p = pk.dense_pair_force_plain(*bargs)
    for k, p in zip(out_k, out_p):
        assert bool(torch.isfinite(k).all()) and _close(k, p, TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    _hold_replicas(out_k, lambda r: pk.dense_pair_force(P[r], *args[1:]),
                   B, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", REPLICA_BATCHES)
def test_batched_spread_and_interpolation_kernels(cuda, B, dtype):
    """K2 (its global path) and K3 over B replicas: against their twins on
    the batch and against one-replica launches (K2 within TOL, its float
    atomics; K3 bit-equal), K3's two calls bit-equal; a batched tile
    request raises."""
    pos, q, box = _spread_inputs(dtype, cuda)
    mesh, order = (32, 32, 32), 6
    P = _jitter(pos, B, 0.3, 2)
    before = dict(_cuda.launches)
    g_k = sk.spread_grid(P, q, box, order, mesh)
    torch.cuda.synchronize()
    assert _cuda.launches["pppm_spread"] == before.get("pppm_spread", 0) + 1
    assert g_k.shape == (B,) + mesh
    assert _close(g_k, sk.spread_grid_plain(P, q, box, order, mesh),
                  TOL[dtype])
    _hold_replicas((g_k,), lambda r: (sk.spread_grid(P[r], q, box, order,
                                                     mesh),), B, TOL[dtype])
    params, _ = PPPMParams.create(box.cpu().numpy(), mesh=mesh, order=order,
                                  kappa=0.2, dtype=dtype, device=cuda)
    grid = g_k.detach().requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, params).sum(), grid)
    ct = ct.contiguous()
    d_k = sk.interpolate_grad(ct, P, q, box, order, mesh)
    d_again = sk.interpolate_grad(ct, P, q, box, order, mesh)
    torch.cuda.synchronize()
    assert torch.equal(d_k, d_again)
    assert _close(d_k, sk.interpolate_grad_plain(ct, P, q, box, order, mesh),
                  TOL[dtype])
    _hold_replicas((d_k,), lambda r: (sk.interpolate_grad(
        ct[r].contiguous(), P[r], q, box, order, mesh),), B, TOL[dtype],
        bits=True)
    if B > 1:
        with pytest.raises(ValueError, match="tile"):
            sk.spread_grid_cuda(P, q, box, order, mesh, path="tile")


def _batched_integrator_inputs(dtype, device, B):
    """K4/K5 inputs of ``_integrator_inputs`` for B replicas: positions
    and velocities jittered apart, each replica its own dt and draws."""
    pre, post = _integrator_inputs(dtype, device, n_mol=250, box_L=46.0)
    g = torch.Generator(device=device)
    g.manual_seed(4)

    def per(x, lo=0.9, hi=1.1):
        return x * (lo + (hi - lo) * torch.rand(B, generator=g, dtype=dtype,
                                                device=device))

    plan, pos, img, vel, frc, mass, mol, box, dt, c, kT, r1, rg = pre
    P, V = _jitter(pos, B, 1e-4, 5), _jitter(vel, B, 1e-4, 6)
    Fb = _jitter(frc, B, 1e-4, 7)
    Ib = img[None].expand(B, -1, -1).contiguous()
    dts = per(dt)
    bpre = (plan, P, Ib, V, Fb, mass, mol, box, dts,
            torch.exp(-dts / plan.bussi.tau), kT,
            torch.randn(B, generator=g, dtype=dtype, device=device),
            per(rg))
    c_ou = torch.exp(-plan.langevin.gamma * dts)
    sig = torch.sqrt((1.0 - c_ou * c_ou) * kT / mass[plan.photon])
    bpost = (plan, V, Fb, mass, mol, dts, c_ou, sig,
             torch.randn((B, 1, 3), generator=g, dtype=dtype, device=device))
    return bpre, bpost


def _one(args, r, batched_idx):
    return tuple(a[r].contiguous() if i in batched_idx else a
                 for i, a in enumerate(args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", REPLICA_BATCHES)
def test_batched_fused_integrator_kernels(cuda, B, dtype):
    """K4 and K5 over B replicas in one cooperative launch each: against
    their twins on the batch (K4's image flags and K5's velocities equal,
    the rest within TOL, the reservoir deltas against the energies they
    come from), against the one-replica launches (bit-equal: each
    replica's partials are summed in one fixed order), two calls
    bit-equal."""
    pre, post = _batched_integrator_inputs(dtype, cuda, B)
    before = dict(_cuda.launches)
    k4 = fi.pre_force_apply(*pre)
    k4_again = fi.pre_force_apply(*pre)
    k5 = fi.post_force_apply(*post)
    k5_again = fi.post_force_apply(*post)
    torch.cuda.synchronize()
    for name in ("fused_pre_force", "fused_post_force"):
        assert _cuda.launches[name] == before.get(name, 0) + 2
    assert all(torch.equal(a, b) for a, b in zip(k4, k4_again))
    assert all(torch.equal(a, b) for a, b in zip(k5, k5_again))
    p4 = fi.pre_force_apply_plain(*pre)
    p5 = fi.post_force_apply_plain(*post)
    assert k4[3].shape == k5[1].shape == k5[3].shape == (B,)
    assert torch.equal(k4[1], p4[1]) and torch.equal(k5[0], p5[0])
    for a, b in ((k4[0], p4[0]), (k4[2], p4[2]), (k5[1], p5[1]),
                 (k5[2], p5[2])):
        assert _close(a, b, TOL[dtype])
    vel, mass, mol = pre[3], pre[5], pre[6]
    ke_mol = (0.5 * (mass[:, None] * vel * vel)[:, mol].sum(dim=(1, 2)))
    ke_photon = p5[2].abs() + p5[3].abs()
    for a, b, scale in ((k4[3], p4[3], ke_mol), (k5[3], p5[3], ke_photon)):
        assert bool(((a - b).abs() <= TOL[dtype] * torch.maximum(
            b.abs(), scale)).all())
    _hold_replicas(k4, lambda r: fi.pre_force_apply(
        *_one(pre, r, (1, 2, 3, 4, 8, 9, 11, 12))), B, 0, bits=True)
    _hold_replicas(k5, lambda r: fi.post_force_apply(
        *_one(post, r, (1, 2, 5, 6, 7, 8))), B, 0, bits=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_fused_integrator_launches_at_64_replicas(cuda, dtype):
    """B = 64 replicas fit one cooperative grid each for K4 and K5 (the
    card's resident blocks shared over the batch) and match the twins."""
    B = 64
    pre, post = _batched_integrator_inputs(dtype, cuda, B)
    for kname in ("pre_force", "post_force"):
        g = fi.grid_blocks(kname, 501, dtype, replicas=B)
        assert g >= 1 and g * B <= fi.grid_blocks(kname, 10**8, dtype)
    k4 = fi.pre_force_apply(*pre)
    k5 = fi.post_force_apply(*post)
    torch.cuda.synchronize()
    p4 = fi.pre_force_apply_plain(*pre)
    p5 = fi.post_force_apply_plain(*post)
    assert torch.equal(k4[1], p4[1]) and torch.equal(k5[0], p5[0])
    assert _close(k4[2], p4[2], TOL[dtype]) and _close(k5[1], p5[1],
                                                       TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_step_on_cuda_matches_one_replica_steps(cuda, dtype):
    """The batched step on the card (K1-K3, and in float32 K4/K5) against
    one-replica steps with the same draws: each kernel launched once a
    step for the batch."""
    from cavmd_tpu_torch.parallel import init_replica_states
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(250, box_L=46.0, temperature_K=100.0,
                                seed=0, device=cuda),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    snap = snap.astype(dtype)
    ff = pt.ForceField.create(snap, coupling=1e-3)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    B, steps = 3, 10
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(0.25), seed=5,
                                kT=kT)
    draws = {}

    class Noise:
        """Draws made once on the card, by (stream, step); a replica's run
        takes its row."""

        def __init__(self, replica=None):
            self.replica = replica

        def _get(self, key, shape, state):
            if key not in draws:
                g = torch.Generator(device=cuda)
                g.manual_seed(2 * key[1] + (key[0] == "langevin"))
                draws[key] = torch.randn((B,) + shape, generator=g,
                                         dtype=dtype, device=cuda)
            x = draws[key]
            return x if self.replica is None else x[self.replica]

        def bussi(self, state, i, m):
            x = self._get(("bussi", state.step), (2,), state)
            return x[..., 0], m.dof - 1.0 + 10.0 * x[..., 1]

        def langevin(self, state, i, m, shape):
            return self._get(("langevin", state.step), (1, 3), state)

    _cuda.reset_launches()
    final, obs = pt.run_steps(pt.make_step_fn(ff, methods, noise=Noise()),
                              batch, steps)
    torch.cuda.synchronize()
    kernels = ["dense_pair", "pppm_spread", "pppm_interpolate"]
    if dtype == torch.float32:
        kernels += ["fused_pre_force", "fused_post_force"]
    assert {k: _cuda.launches[k] for k in kernels} == dict.fromkeys(
        kernels, steps)
    tol = TOL[dtype] * 10
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA})
        fr, _ = pt.run_steps(pt.make_step_fn(ff, methods,
                                             noise=Noise(replica=r)),
                             one, steps)
        assert torch.equal(final.image[r], fr.image)
        assert _close(final.position[r], fr.position, tol)
        assert _close(final.velocity[r], fr.velocity, tol)


# ------------------------------------- replica batches in cell/zcol mode
# The cell kernel (K6/K8) and K9 with its hull over a replica axis: one
# launch for B replicas, each with its own positions (jittered apart) and
# its own list of the batched build (ops/neighbor.py)
def _batched_pair_inputs(dtype, device, B, mode, grid=None):
    """(force field, scene, batched positions, batched list, the pair
    call's arguments) for B replicas of a cell grid of CELL_GRIDS or of
    the 500-molecule zcol scene."""
    if mode == "cell":
        n_mol, box_L, r_cut = CELL_GRIDS[grid]
        snap = pt.add_cavity_particle(
            pt.make_diatomic_system(n_mol, box_L=box_L, temperature_K=100.0,
                                    seed=3, device="cpu"),
            coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=4)
        snap = snap.astype(dtype).to(device)
        ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=r_cut,
                                  pppm_mesh=(8, 8, 8), pair_mode="cell")
    else:
        snap, ff = _zcol_scene(dtype, device)
    P = wrap_positions(_jitter(snap.position, B, 0.3, 7), snap.box_L)[0]
    clist = ff.build_cells(P, snap.box_L)
    assert clist.overflow.shape == (B,) and not bool(clist.overflow.any())
    args = (P, snap.box_L, clist, ff.cell_cfg, snap.typeid, snap.charge,
            ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value)
    if mode == "zcol":
        args = args + (ff.zcol_W,)
    return ff, snap, P, clist, args


def _replica_args(args, r):
    """Replica r's one-replica call of a batched pair call's arguments."""
    return (args[0][r].contiguous(), args[1],
            replica_list(args[2], r)) + args[3:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", REPLICA_BATCHES)
@pytest.mark.parametrize("grid", sorted(CELL_GRIDS))
def test_batched_cell_kernel(cuda, grid, B, dtype):
    """The cell kernel over B replicas in one launch (3^3 cells: K6's
    grid; 2^3: K8's, rows split over blocks reckoned from B C): against
    its twin on the batch, forces bit-equal to the one-replica launch on
    each replica (a row's force is one warp's sum either way) and energies
    within TOL (the row split moves rows between warps), two calls
    bit-equal."""
    _, _, P, clist, args = _batched_pair_inputs(dtype, cuda, B, "cell", grid)
    name = ck.kernel_name(args[3])
    before = _cuda.launches[name]
    out_k = ck.cell_pair_force_fused(*args)
    again = ck.cell_pair_force_fused(*args)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == before + 2
    assert out_k[0].shape == P.shape and out_k[1].shape == (B,)
    out_p = ck.cell_pair_force_fused_plain(*args)
    for k, p in zip(out_k, out_p):
        assert bool(torch.isfinite(k).all()) and _close(k, p, TOL[dtype])
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    for r in range(B):
        one = ck.cell_pair_force_fused(*_replica_args(args, r))
        assert torch.equal(out_k[0][r], one[0]), r
        for a, b in zip(out_k[1:], one[1:]):
            assert _close(a[r], b, TOL[dtype]), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", REPLICA_BATCHES)
def test_batched_zcol_kernels(cuda, B, dtype):
    """K9 and its hull over B replicas of the 500-molecule scene, one
    launch each: the hull kernel's hull, flags and (N, 4) table bit-equal
    to the one-replica launch on each replica; the wrapper against its
    twin on the batch, its forces bit-equal to the one-replica wrapper's
    and its energies within TOL; two calls bit-equal, each one launch of
    each kernel."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    ff, snap, P, clist, args = _batched_pair_inputs(dtype, cuda, B, "zcol")
    hull, flags, loc, W = zk._launch_hull(P, snap.box_L, clist, ff.cell_cfg,
                                          snap.charge, ff.zcol_W)
    assert hull.shape[0] == flags.shape[0] == loc.shape[0] == B
    slotted = clist.bucket_idx < snap.N
    for r in range(B):
        h1, f1, l1, W1 = zk._launch_hull(P[r].contiguous(), snap.box_L,
                                         replica_list(clist, r),
                                         ff.cell_cfg, snap.charge, ff.zcol_W)
        assert torch.equal(hull[r], h1) and torch.equal(flags[r], f1)
        ids = clist.bucket_idx[r][slotted[r]].long()
        assert torch.equal(loc[r][ids], l1[ids]) and W == W1
    before = dict(_cuda.launches)
    out_k = zk.zcol_pair_force(*args)
    again = zk.zcol_pair_force(*args)
    torch.cuda.synchronize()
    for name in ("zcol_hull", "zcol_pair"):
        assert _cuda.launches[name] == before.get(name, 0) + 2
    assert out_k[0].shape == P.shape and out_k[3].shape == (B,)
    out_p = zk.zcol_pair_force_plain(*args)
    for k, p in zip(out_k[:3], out_p[:3]):
        assert bool(torch.isfinite(k).all()) and _close(k, p, TOL[dtype])
    assert torch.equal(out_k[3], out_p[3]) and not bool(out_k[3].any())
    assert all(torch.equal(a, b) for a, b in zip(out_k, again))
    for r in range(B):
        one = zk.zcol_pair_force(*_replica_args(args, r))
        assert torch.equal(out_k[0][r], one[0]), r
        for a, b in zip(out_k[1:3], one[1:3]):
            assert _close(a[r], b, TOL[dtype]), r


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["cell", "zcol"])
def test_batched_cell_step_on_cuda_matches_one_replica_steps(cuda, mode,
                                                             dtype):
    """20 batched Bussi + Langevin steps in cell and zcol mode on the card
    (1 fs; r_cut a tenth of a bohr under a quarter of the box, so a
    0.1-bohr skin and the carried lists rebuilt inside the window) against
    one-replica steps with the same draws: each pair kernel launched once
    a step for the batch, positions within 10 TOL."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.parallel import init_replica_states
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    box_L = reference_box_for(500)
    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(500, box_L=box_L, temperature_K=100.0,
                                seed=3, device=cuda),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=4)
    snap = snap.astype(dtype)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=box_L / 4 - 0.1,
                              pppm_mesh=(16, 16, 16), pair_mode=mode,
                              cell_skin=0.05)
    assert ff.cell_cfg.skin < 0.11
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, (
        pt.MethodSpec("bussi", "molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec("langevin", "cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    B, steps = 3, 20
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(1.0), seed=5, kT=kT)
    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    bussi = torch.randn((steps, B, 2), generator=g, dtype=dtype, device=cuda)
    xi = torch.randn((steps, B, 1, 3), generator=g, dtype=dtype, device=cuda)

    class Noise:
        def __init__(self, replica=None):
            self.pick = (slice(None) if replica is None else replica)

        def bussi(self, state, i, m):
            x = bussi[state.step][self.pick]
            return x[..., 0], m.dof - 1.0 + 10.0 * x[..., 1]

        def langevin(self, state, i, m, shape):
            return xi[state.step][self.pick]

    _cuda.reset_launches()
    final, obs = pt.run_steps(pt.make_step_fn(ff, methods, noise=Noise()),
                              batch, steps)
    torch.cuda.synchronize()
    kernels = (["cell_pair"] if mode == "cell"
               else ["zcol_hull", "zcol_pair"])
    assert {k: _cuda.launches[k] for k in kernels} == dict.fromkeys(
        kernels, steps)
    assert not obs["cell_overflow"].any()
    moved = (final.cell_anchor != batch.cell_anchor).flatten(1).any(dim=1)
    assert bool(moved.all()), "a replica's list was never rebuilt"
    tol = TOL[dtype] * 10
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA},
                            cell_list=replica_list(batch.cell_list, r),
                            cell_anchor=batch.cell_anchor[r])
        fr, _ = pt.run_steps(pt.make_step_fn(ff, methods,
                                             noise=Noise(replica=r)),
                             one, steps)
        assert torch.equal(final.image[r], fr.image)
        assert _close(final.position[r], fr.position, tol)
        assert _close(final.velocity[r], fr.velocity, tol)
