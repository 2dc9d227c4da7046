"""The CUDA kernels of cavmd_tpu_torch against their plain twins on the
card. Marked ``cuda``; each test skips when no CUDA device is present (run
them on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m
cuda``)."""

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


def _zcol_scene(dtype, device):
    """500 diatomics + photon at the reference density, r_cut 12: 4 x 4
    columns of capacity 128, hulls of up to 5 of the 9 j-blocks, some of
    them in two runs across the z seam."""
    from cavmd_tpu_torch.core.system import reference_box_for

    snap = pt.add_cavity_particle(
        pt.make_diatomic_system(500, box_L=reference_box_for(500),
                                temperature_K=100.0, seed=3, device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=4)
    snap = snap.astype(dtype).to(device)
    ff = pt.ForceField.create(snap, coupling=1e-3, r_cut=12.0,
                              pppm_mesh=(8, 8, 8), pair_mode="zcol")
    return snap, ff


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
    args = (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
            snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value, W)
    before = _cuda.launches["zcol_pair"]
    out_k = zk.zcol_pair_force(*args)
    torch.cuda.synchronize()
    assert _cuda.launches["zcol_pair"] == before + 1
    out_p = zk.zcol_pair_force_plain(*args)
    assert bool(out_k[3]) == bool(out_p[3]) == (window == "one")
    for k, p in zip(out_k[:3], out_p[:3]):
        assert _close(k, p, TOL[dtype])


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
                                    "pre_force"])
def test_two_calls_give_the_same_bits(cuda, kernel, dtype):
    """The cell kernel and K4 sum in fixed orders (no atomics), so two
    calls on the same inputs are bit-equal."""
    if kernel == "pre_force":
        from cavmd_tpu_torch.core.system import reference_box_for

        pre, _ = _integrator_inputs(dtype, cuda, n_mol=2000,
                                    box_L=reference_box_for(2000))
        first, second = fi.pre_force_apply(*pre), fi.pre_force_apply(*pre)
    else:
        n_mol, box_L, r_cut = CELL_GRIDS[
            "k6_3cells" if kernel == "cell_3cells" else "k8_2cells"]
        args = _cell_inputs(dtype, cuda, n_mol, box_L, r_cut)
        first = ck.cell_pair_force_fused(*args)
        second = ck.cell_pair_force_fused(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
