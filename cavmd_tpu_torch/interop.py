"""Build port objects from the JAX package's arrays, as NumPy.

The tests use these so that both packages run the same tables and the same
state: the caller turns the JAX ``ForceField`` / ``MDState`` leaves into
NumPy arrays (``np.asarray``) and hands them in here. Nothing here imports
JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.integrate.forcefield import ForceField
from cavmd_tpu_torch.integrate.integrator import MDState, carries_cell_list
from cavmd_tpu_torch.ops.lj import lj_kernel_tables


def _type_table(rows, typeid, ntypes):
    """(T, T) table from (N, T) row gathers ``rows[i] = table[typeid[i]]``;
    rows of types with no particle stay zero (they are never read)."""
    table = np.zeros((ntypes, rows.shape[1]), rows.dtype)
    for t in range(ntypes):
        members = np.nonzero(typeid == t)[0]
        if len(members):
            table[t] = rows[members[0]]
    return table


def forcefield_from_numpy(*, kappa, influence, volume, omegac, couplstr,
                          phmass, bond_k, bond_r0, bond_group, bond_typeid,
                          l_typeid, coulomb_rcut, pppm_order, pppm_mesh,
                          rows_eps=None, rows_sig2=None, rows_rcut2=None,
                          rows_vshift=None, oh=None, active=None,
                          coulomb_active=None, lj_eps=None, lj_sigma=None,
                          lj_rcut=None, pair_mode=None, cell_cfg=None,
                          cell_exclusions=None, cell_neighbors=None,
                          pair_inert=None, zcol_W=None, enable_cavity=True,
                          enable_coulomb=True, enable_lj=True,
                          enable_bonds=True, custom_forces=(),
                          ghost_typeid=-1, dtype=torch.float64,
                          device=None) -> ForceField:
    """A port ``ForceField`` from the JAX ForceField's leaves.

    Dense mode: ``rows_*``/``oh``/``active`` are ``ff.lj_pair``'s fields
    and ``coulomb_active`` the (N, N) mask. Cell mode (``cell_cfg`` given,
    ``tuple(ff.cell_cfg)``): ``lj_eps``/``lj_sigma``/``lj_rcut`` are the
    (T, T) tables and ``cell_exclusions``/``cell_neighbors``/``pair_inert``
    the cell fields of the same names. Zcol mode (``pair_mode='zcol'``,
    ``ff.pair_mode``) takes the same without ``cell_neighbors``, and
    ``zcol_W`` (``ff.zcol_W``). All modes:
    ``influence``/``volume`` come from ``ff.pppm``; ``omegac``/
    ``couplstr``/``phmass`` from ``ff.cavity``; ``bond_k``/``bond_r0`` are
    the per-type bond tables and ``bond_group``/``bond_typeid`` the
    snapshot's bond table. ``custom_forces`` are the port-side callables
    (torch functions of the JAX ForceField's ``custom_forces``; a JAX
    callable cannot be carried across). ``ghost_typeid`` is
    ``ff.ghost_typeid`` (ghost padding). ``device=None`` is the CUDA
    device.
    """
    device = resolve_device(device)
    if cell_cfg is None:
        oh = np.asarray(oh)
        typeid = np.argmax(oh, axis=1)
        ntypes = oh.shape[1]
        tables = [_type_table(np.asarray(r), typeid, ntypes)
                  for r in (rows_eps, rows_sig2, rows_rcut2, rows_vshift)]
        pair_data = dict(lj_active=np.asarray(active),
                         coulomb_active=np.asarray(coulomb_active))
    else:
        tables = lj_kernel_tables(*(np.asarray(x) for x in (
            lj_eps, lj_sigma, lj_rcut)))
        pair_data = dict(pair_mode=pair_mode, cell_cfg=cell_cfg,
                         cell_exclusions=np.asarray(cell_exclusions),
                         pair_inert=np.asarray(pair_inert), zcol_W=zcol_W)
        if pair_mode != "zcol":
            pair_data["cell_neighbors"] = np.asarray(cell_neighbors)
    bond_k = np.asarray(bond_k)
    bond_r0 = np.asarray(bond_r0)
    btid = np.asarray(bond_typeid)
    return ForceField(
        bond_k=bond_k, bond_r0=bond_r0,
        bond_k_per=bond_k[btid], bond_r0_per=bond_r0[btid],
        bond_group=np.asarray(bond_group), bond_typeid=btid,
        lj_eps=tables[0], lj_sig2=tables[1], lj_rcut2=tables[2],
        lj_vshift=tables[3], **pair_data,
        kappa=np.asarray(kappa), influence=np.asarray(influence),
        volume=np.asarray(volume), omegac=np.asarray(omegac),
        couplstr=np.asarray(couplstr), phmass=np.asarray(phmass),
        l_typeid=l_typeid, coulomb_rcut=coulomb_rcut,
        pppm_order=pppm_order, pppm_mesh=pppm_mesh,
        enable_cavity=enable_cavity, enable_coulomb=enable_coulomb,
        enable_lj=enable_lj, enable_bonds=enable_bonds,
        custom_forces=custom_forces, ghost_typeid=ghost_typeid,
        dtype=dtype, device=device,
    )


def state_from_numpy(*, position, image, velocity, mass, charge, typeid,
                     box_L, forces, dt, time_au, time_comp, timestep,
                     bussi_reservoir, bussi_instantaneous, langevin_reservoir,
                     mttk_xi=None, mttk_eta=None,
                     error_tolerance=0.0, seed=0, forcefield=None,
                     dtype=torch.float64, device=None) -> MDState:
    """A port ``MDState`` from the JAX ``MDState`` leaves (the JAX RNG key
    has no counterpart; ``seed`` seeds the port's generators).
    ``mttk_xi`` and ``mttk_eta`` are the JAX state's ``mttk.xi`` and
    ``mttk.eta``, (2,) or (B, 2) (None: zero, as ``init_state`` starts
    them), so a mid-run MTTK state carries across.
    ``device=None`` is the CUDA device. With a cell- or zcol-mode
    ``forcefield`` that carries its list, the list is built from
    ``position``, as the
    JAX package's ``init_state`` does (pass the initial state's leaves).

    The stacked leaves of a JAX replica batch (``init_replica_states``,
    positions (B, N, 3)) give the port's batched state: mass, charge,
    typeid and box, stacked B times there, are shared here (they must
    agree across replicas), and so is the step counter. With a cell- or
    zcol-mode ``forcefield`` the batched list is built from the (B, N, 3)
    positions, each replica's as the JAX package's ``init_state`` built
    it, so the stacked JAX batch's carried lists have their counterpart."""
    device = resolve_device(device)
    batched = np.ndim(position) == 3

    def shared(name, x, rank):
        x = np.asarray(x)
        if batched and x.ndim == rank + 1:
            if not (x == x[:1]).all():
                raise ValueError(f"state_from_numpy: {name} differs across "
                                 "replicas; a replica batch shares it")
            x = x[0]
        return x

    mass, charge = shared("mass", mass, 1), shared("charge", charge, 1)
    typeid, box_L = shared("typeid", typeid, 1), shared("box_L", box_L, 1)
    steps = np.unique(np.asarray(timestep))
    if steps.size != 1:
        raise ValueError(f"state_from_numpy: replicas at timesteps {steps}")
    error_tolerance = np.broadcast_to(error_tolerance, np.shape(dt))
    zero = np.zeros(np.shape(bussi_reservoir))

    def f(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def i32(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    pos = f(position)
    clist = None
    if forcefield is not None and carries_cell_list(forcefield):
        clist = forcefield.build_cells(pos, f(box_L))
    return MDState(
        position=pos, image=i32(image), velocity=f(velocity),
        mass=f(mass), charge=f(charge), typeid=i32(typeid), box_L=f(box_L),
        forces=f(forces), dt=f(dt), time_au=f(time_au),
        time_comp=f(time_comp), timestep=i32(timestep),
        bussi_reservoir=f(bussi_reservoir),
        bussi_instantaneous=f(bussi_instantaneous),
        langevin_reservoir=f(langevin_reservoir),
        mttk_xi=f(zero if mttk_xi is None else mttk_xi),
        mttk_eta=f(zero if mttk_eta is None else mttk_eta),
        error_tolerance=f(error_tolerance), step=int(steps[0]),
        seed=seed, cell_list=clist,
        cell_anchor=pos if clist is not None else None,
    )
