"""The cell kernel's plain twin (ops/cell_kernels.py, the tile path of
ops/neighbor.py) against the JAX cell pass: the XLA tile path
cell_pair_force in float64, and the TPU kernels fused_cell_cols_pallas (K6)
and fused_cell_pallas (K8) in interpret mode in float32; the cell-mode
ForceField against dense mode and the JAX cell mode; the wrapper's device
dispatch.

Two scenes: 60 diatomics + photon in a 40-bohr box at r_cut 12 (3^3
cells, the K6 grid; tests/test_pallas.py:98) and 60 diatomics + photon in
a 34-bohr box at r_cut 15 (2^3 cells, the K8 grid with the deduplicated
neighbour table; tests/test_neighbor.py:157).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.ops import neighbor as jn
from cavmd_tpu.ops.pallas_kernels import fused_cell_cols_pallas, fused_cell_pallas
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.integrate import ForceField
from cavmd_tpu_torch.interop import forcefield_from_numpy
from cavmd_tpu_torch.ops import cell_kernels as ck
from cavmd_tpu_torch.ops import neighbor as pn

from test_torch_ops import assert_energy, assert_forces, scene

# (n_mol, box_L, seed, r_cut): the K6 (3^3) and K8 (2^3) grids
GRIDS = {"k6_3cells": (60, 40.0, 3, 12.0), "k8_2cells": (60, 34.0, 123, 15.0)}


def port_cell_forcefield(jff, js, dtype=torch.float64):
    """The port's cell-mode ForceField from the JAX cell-mode leaves."""
    return forcefield_from_numpy(
        lj_eps=np.asarray(jff.lj_eps), lj_sigma=np.asarray(jff.lj_sigma),
        lj_rcut=np.asarray(jff.lj_rcut), cell_cfg=jff.cell_cfg,
        cell_exclusions=np.asarray(jff.cell_exclusions),
        cell_neighbors=np.asarray(jff.cell_neighbors),
        pair_inert=np.asarray(jff.pair_inert),
        kappa=np.asarray(jff.kappa), influence=np.asarray(jff.pppm.influence),
        volume=np.asarray(jff.pppm.volume),
        omegac=np.asarray(jff.cavity.omegac),
        couplstr=np.asarray(jff.cavity.couplstr),
        phmass=np.asarray(jff.cavity.phmass),
        bond_k=np.asarray(jff.bond_k), bond_r0=np.asarray(jff.bond_r0),
        bond_group=np.asarray(js.bond_group),
        bond_typeid=np.asarray(js.bond_typeid),
        l_typeid=jff.l_typeid, coulomb_rcut=jff.coulomb_rcut,
        pppm_order=jff.pppm_order, pppm_mesh=jff.pppm_mesh,
        enable_cavity=jff.enable_cavity, enable_coulomb=jff.enable_coulomb,
        enable_lj=jff.enable_lj, enable_bonds=jff.enable_bonds,
        dtype=dtype, device="cpu")


def _cell_scene(grid, dtype=torch.float64, jitter=0.05):
    n_mol, box_L, seed, r_cut = GRIDS[grid]
    js, ts = scene(n_mol=n_mol, box_L=box_L, seed=seed, jitter=jitter)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    js, ts = js.astype(jdt), ts.astype(dtype)
    jff = JForceField.create(js, coupling=1e-3, pair_mode="cell", r_cut=r_cut,
                             pppm_mesh=(8, 8, 8), dtype=jdt)
    return js, ts, jff, port_cell_forcefield(jff, js, dtype)


def _pair_args(ff, ts, clist):
    return (ts.position, ts.box_L, clist, ff.cell_cfg, ts.typeid, ts.charge,
            ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value)


@pytest.mark.parametrize("terms", ["fused", "lj", "ewald"])
@pytest.mark.parametrize("grid,block", [("k6_3cells", None),
                                        ("k6_3cells", 9),
                                        ("k8_2cells", None),
                                        ("k8_2cells", 2)])
def test_plain_twin_matches_xla_tile_path_f64(grid, block, terms):
    """f64, forces to 1e-10 max|F| and energies to 1e-10 relative: the
    same pairs and the same math, summed in another order. ``block`` None
    goes through the wrapper (the twin picks its own block); ``block`` < C
    runs the port's tile loop in that many cells per block, as JAX's
    lax.map does."""
    js, ts, jff, tff = _cell_scene(grid)
    cfg = jn.CellListConfig(*jff.cell_cfg)
    assert cfg.total_cells % (block or 1) == 0
    jl = jn.build_cell_list(js.position, js.box_L, cfg, jff.cell_neighbors)
    if terms == "fused":
        kern = jn.make_fused_cell_kernel(jff.lj_eps, jff.lj_sigma,
                                         jff.lj_rcut, jff.kappa, jff.n_types,
                                         uniform_rcut=jff.uniform_rcut)
    elif terms == "lj":
        kern = jn.make_lj_cell_kernel(jff.lj_eps, jff.lj_sigma, jff.lj_rcut,
                                      jff.n_types)
    else:
        kern = jn.make_ewald_cell_kernel(jff.kappa, jff.n_types)
    f_ref, e_ref = jn.cell_pair_force(
        js.position, js.box_L, jl, cfg, kern, features=jff.cell_features,
        exclusions=jff.cell_exclusions, cell_block=block)
    e_ref = e_ref if terms == "fused" else (
        (e_ref, 0.0) if terms == "lj" else (0.0, e_ref))

    clist = tff.build_cells(ts.position, ts.box_L)
    if block is None:
        f, e_lj, e_ew = ck.cell_pair_force_fused(
            *_pair_args(tff, ts, clist), lj_on=terms != "ewald",
            coul_on=terms != "lj")
    else:
        tables = (tff.lj_eps, tff.lj_sig2, tff.lj_rcut2, tff.lj_vshift)
        T = tff.lj_eps.shape[0]
        if terms == "fused":
            tkern = pn.make_fused_cell_kernel(*tables, tff.kappa_value, T)
        elif terms == "lj":
            tkern = pn.make_lj_cell_kernel(*tables, T)
        else:
            tkern = pn.make_ewald_cell_kernel(tff.kappa_value, T)
        f, e = pn.cell_pair_force(
            ts.position, ts.box_L, clist, tff.cell_cfg, tkern,
            features=pn.make_particle_features(ts.typeid, ts.charge, T),
            exclusions=tff.cell_exclusions, cell_block=block)
        e_lj, e_ew = e if terms == "fused" else (
            (e, 0.0) if terms == "lj" else (0.0, e))
    assert_forces(f, f_ref)
    for got, want in zip((e_lj, e_ew), e_ref):
        assert_energy(got, want, scale=max(abs(float(want)), 1e-12))


@pytest.mark.parametrize("grid,pallas", [("k6_3cells", "cols"),
                                         ("k8_2cells", "gathered")])
def test_plain_twin_matches_pallas_kernel_f32(grid, pallas):
    """Against the TPU kernels themselves (interpret mode, f32), with the
    bounds of tests/test_pallas.py: forces to 2e-5 max|F|; the Pallas
    bodies use the A&S erfc (1.5e-7 absolute), so the Ewald energy gets
    1e-3 relative."""
    js, ts, jff, tff = _cell_scene(grid, torch.float32, jitter=0.0)
    cfg = jn.CellListConfig(*jff.cell_cfg)
    assert (min(cfg.ncells) >= 3) == (pallas == "cols")
    jl = jn.build_cell_list(js.position, js.box_L, cfg, jff.cell_neighbors)
    run = fused_cell_cols_pallas if pallas == "cols" else fused_cell_pallas
    f_ref, elj_ref, eew_ref = run(js.position, js.box_L, jl, cfg,
                                  jff.cell_pallas_pack, jff.kappa,
                                  interpret=True)
    clist = tff.build_cells(ts.position, ts.box_L)
    f, e_lj, e_ew = ck.cell_pair_force_fused(*_pair_args(tff, ts, clist))
    assert f.dtype == torch.float32
    assert_forces(f, f_ref, rtol=2e-5)
    assert float(e_lj) == pytest.approx(float(elj_ref), rel=1e-5)
    assert float(e_ew) == pytest.approx(float(eew_ref), rel=1e-3, abs=1e-9)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_forcefield_cell_mode_matches_dense_and_jax(grid):
    """The port's cell mode against the port's dense mode and the JAX
    package's cell mode, f64, every energy key and the forces to 1e-10
    (the tests/test_neighbor.py:136 analogue; the 2^3 grid is the
    no-double-count case)."""
    n_mol, box_L, seed, r_cut = GRIDS[grid]
    js, ts, jff, tff = _cell_scene(grid)
    kw = dict(coupling=1e-3, r_cut=r_cut, pppm_mesh=(8, 8, 8))
    made = ForceField.create(ts, pair_mode="cell", **kw)
    dense = ForceField.create(ts, pair_mode="dense", **kw)
    assert made.cell_cfg == tff.cell_cfg
    f_j, e_j = jff.compute(js.position, js.image, js.box_L, js.charge,
                           js.typeid, js.bond_group, js.bond_typeid)
    targs = (ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
    f_d, e_d = dense(*targs)
    for ff in (tff, made):
        f, e = ff(*targs)
        assert set(e) == set(e_j) == set(e_d) | {"cell_overflow"}
        assert float(e["cell_overflow"]) == 0.0
        assert_forces(f, f_j)
        assert_forces(f, f_d.numpy())
        for k in e_d:
            assert_energy(e[k], e_j[k])
            assert_energy(e[k], e_d[k])


def test_create_picks_cell_mode_above_4096_without_dense_tensors():
    """N = 4201 picks cell mode, as ForceField.create does in the JAX
    package, and no buffer holds anything near N^2 entries; a small scene
    stays dense."""
    from cavmd_tpu_torch.core.system import reference_box_for

    snap = add_cavity_particle(
        make_diatomic_system(2100, box_L=reference_box_for(2100), seed=0,
                             device="cpu"),
        coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3)
    assert snap.N == 4201 and ff.pair_mode == "cell"
    assert ff.cell_cfg.ncells == (6, 6, 6)
    assert max(b.numel() for b in ff.buffers()) < snap.N * 10
    assert not hasattr(ff, "lj_active")
    small = make_diatomic_system(20, box_L=24.0, seed=0, device="cpu")
    assert ForceField.create(small, coupling=1e-3,
                             pppm_mesh=(8, 8, 8)).pair_mode == "dense"


def test_overflow_drops_pairs_and_flags():
    """A cap below the occupancy: the flag is set in the energies, and a
    particle left without a slot gets zero pair force."""
    _, ts, _, tff = _cell_scene("k6_3cells")
    small = tff.with_cell_capacity(4)
    # the copy's buffers are its own: moving it leaves the original
    assert small.cell_cfg.cap == 4 and tff.cell_cfg.cap > 4
    assert small.to("meta").cell_exclusions.is_meta
    assert not tff.cell_exclusions.is_meta
    small = tff.with_cell_capacity(4)
    clist = small.build_cells(ts.position, ts.box_L)
    assert bool(clist.overflow)
    f, e = small(ts.position, ts.image, ts.box_L, ts.charge, ts.typeid)
    assert float(e["cell_overflow"]) == 1.0
    dropped = clist.slot_of == clist.bucket_idx.numel()
    assert bool(dropped.any())
    f_pair, _, _ = ck.cell_pair_force_fused(*_pair_args(small, ts, clist))
    assert not f_pair[dropped].any()


def test_wrapper_rejects_non_cpu_non_cuda_tensors():
    _, ts, _, tff = _cell_scene("k8_2cells")
    clist = tff.build_cells(ts.position, ts.box_L)
    args = list(_pair_args(tff, ts, clist))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.cell_pair_force_fused(*args)


@pytest.mark.parametrize("n_cells,cap,split", [
    (4913, 45, 1),   # N = 100,001: 17^3 cells fill the card
    (264, 45, 1),    # two blocks per SM already
    (27, 16, 2),     # a 3^3 grid: capped at one row per warp (16 / 8)
    (27, 136, 10),   # the same at a grown cap: ceil(264 / 27)
    (8, 121, 16),    # N = 501 in cell mode (K8's grid): ceil(121 / 8)
])
def test_row_split_fills_the_card_on_small_grids(n_cells, cap, split):
    """Blocks per cell for a launch on a card of 132 SMs: one when the
    cells alone give two blocks an SM, else enough blocks to reach that,
    and never more than one i row per warp of a full bucket."""
    assert ck.row_split(n_cells, cap, 132) == split
