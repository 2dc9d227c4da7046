"""ForceField: every force of the reference workflow in one module.

Port of ``cavmd_tpu/integrate/forcefield.py`` for its pair modes: dense
all-pairs (the JAX package's choice for N <= 4096, which covers the
N = 501 reference scene), cell lists (above 4096) and the opt-in z-sorted
columns ('zcol'); the TPU-only 'pallas' mode is not ported. ``ForceField``
is an ``nn.Module`` whose tables are buffers, so ``.to(device)`` moves it;
``forward`` evaluates cavity + bonds + LJ + Ewald short + PPPM long and
returns the forces and a dict of energy components with the JAX package's
keys (in cell and zcol mode also ``cell_overflow``, a 0/1 flag, not an
energy; in zcol mode it also carries the visit-window overflow).

``forward`` also takes a replica batch, positions (B, N, 3) of one
topology in one box, in every pair mode: every term then runs once for the
whole batch (each kernel one launch; in cell and zcol mode over a batched
list, ``build_cells``) and the energies are (B,) tensors, ``cell_overflow``
one flag a replica. A batch over slabs runs on the slab pipeline instead
(``parallel/domain.py:make_domain_runner``), whose step calls the pair and
PPPM kernels itself.

User custom forces (``custom_forces``, the ``hoomd.md.force.Custom``
counterpart) are callables ``(position, image, box_L, charge, typeid) ->
(forces (N, 3), energy 0-d)`` on tensors, added after the PPPM block and
before the cavity, as the JAX package adds them; energy i goes under
``custom_<i>``. A replica batch calls each one through ``torch.func.vmap``
with one replica's (N, 3) position and image and the shared box, charges
and types, as ``jax.vmap`` calls the JAX step's. The steps run under
``torch.no_grad()``, so a callable that derives its forces from an energy
takes them with ``torch.func.grad``. The callables are held in a plain
tuple: their own tensors do not move with ``ForceField.to``.

Ghost rows (``parallel.pad_snapshot_to``: type ``'__ghost__'``, zero
charge, mass 1e30, appended after every real row) are pair-inert: their
type has no LJ pair and they carry no charge, so every term gives them
zero force. ``ghost_typeid`` is their type (-1 without ghosts); the step's
groups and DOF leave them out.

Atom sharding by rows (``bind_rows(comm)``, ``parallel/shard.py``): a
bound copy computes the pair pass and the PPPM spread and interpolation
on its rank's row block ``[r N/S, (r + 1) N/S)`` only, sums the partial
PPPM meshes over the S ranks before the FFT and all-gathers the rows'
forces with the pair-energy shares in the same message; every other term
(bonds, the exclusion correction, the self energy, custom forces, the
cavity) runs replicated on every rank and counts its energy once. In cell
and zcol mode the list (in zcol mode also the hull and its window flag) is
built replicated, so every rank reads the same overflow flag and the
overflow retry grows the plan on all ranks alike.

On CUDA tensors the pair pass (dense: ``ops/pair_kernels.py``; cell:
``ops/cell_kernels.py``; zcol: ``ops/zcol_kernels.py``) and the PPPM
spread/interpolation (``ops/pppm_kernels.py``) run in the hand-written
kernels; on CPU tensors in their plain twins. Cell and zcol mode build no
(N, N) tensor.
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import torch
from torch import nn

from cavmd_tpu_torch.core.snapshot import Snapshot, ghost_typeid_of
from cavmd_tpu_torch.ops.bonds import (
    bonds_are_consecutive,
    harmonic_bond_force,
    harmonic_bond_force_strided,
)
from cavmd_tpu_torch.ops.cavity import CavityParams, cavity_force
from cavmd_tpu_torch.ops.ewald import (
    auto_kappa,
    auto_kappa_error_estimate,
    ewald_exclusion_correction,
    ewald_exclusion_correction_strided,
    ewald_self_energy,
)
from cavmd_tpu_torch.ops.lj import (
    bond_exclusion_mask,
    lj_active_mask,
    lj_kernel_tables,
    lj_pair_tables,
)
from cavmd_tpu_torch.ops.cell_kernels import cell_pair_force_fused
from cavmd_tpu_torch.ops.neighbor import (
    CellListConfig,
    build_cell_list,
    build_zcol_list,
    exclusion_table,
    neighbor_cell_table,
    plan_cells,
    plan_zcolumns,
    xy_neighbor_table,
)
from cavmd_tpu_torch.ops.pair_kernels import dense_pair_force
from cavmd_tpu_torch.ops.pppm import (
    PPPMParams,
    pppm_force_and_energy,
    pppm_force_and_energy_rows,
)
from cavmd_tpu_torch.ops.zcol_kernels import plan_zcol_window, zcol_pair_force

ENERGY_KEYS = (
    "harmonic", "lj", "ewald_short", "ewald_long",
    "cavity_harmonic", "cavity_coupling", "cavity_dipole_self",
)
DENSE_MAX_N = 4096


def gather_rows(comm, forces, row_f, e_lj, e_ew):
    """The second collective of a row split: every rank's row forces
    ``row_f`` (..., N/S, 3) and its pair-energy shares, packed in one
    message and all-gathered; returns ``forces`` plus the rows in rank
    order (..., N, 3) and the two energies summed over the ranks in rank
    order (the same bits on every rank)."""
    batch = tuple(row_f.shape[:-2])
    n_f = row_f.numel()
    msg = torch.cat([row_f.reshape(-1), e_lj.reshape(-1).to(row_f.dtype),
                     e_ew.reshape(-1).to(row_f.dtype)])
    parts = comm.all_gather(msg[None])  # (S, n_f + 2 B)
    rows = parts[:, :n_f].reshape((comm.world_size,) + tuple(row_f.shape))
    rows = torch.movedim(rows, 0, -3).reshape(forces.shape)
    shares = parts[:, n_f:].reshape((comm.world_size, 2) + batch)
    e = shares[0]
    for k in range(1, comm.world_size):  # in rank order
        e = e + shares[k]
    return forces + rows, e[0], e[1]


class ForceField(nn.Module):
    """All force parameters as buffers plus static switches.

    Build it with :meth:`create` from a snapshot, or from the JAX package's
    leaves with ``cavmd_tpu_torch.interop.forcefield_from_numpy``. Array
    arguments may be NumPy arrays or tensors.

    ``pair_mode`` is 'dense', 'cell' or 'zcol' (None: 'cell' when
    ``cell_cfg`` is given, else 'dense'). Dense mode takes the two static
    (N, N) masks ``lj_active`` / ``coulomb_active``. Cell mode takes
    ``cell_cfg`` (a ``CellListConfig``), the (N+1, max_excl)
    ``cell_exclusions`` table, the (C, 27) ``cell_neighbors`` table, the
    (N,) ``pair_inert`` flags (particles with no LJ type pair and no
    charge, which the carried cell list ignores when it decides to
    rebuild). Zcol mode takes the same but ``cell_neighbors`` (its
    ``cell_cfg`` is the column plan of ``plan_zcolumns``; the (XY, 9)
    neighbour-column table is made here) and the visit window ``zcol_W``;
    it needs LJ and Coulomb both on.
    """

    def __init__(self, *, bond_k, bond_r0, bond_k_per, bond_r0_per,
                 bond_group, bond_typeid, lj_eps, lj_sig2, lj_rcut2,
                 lj_vshift, kappa, influence, volume, omegac, couplstr,
                 phmass, l_typeid: int, coulomb_rcut: float, pppm_order: int,
                 pppm_mesh, lj_active=None, coulomb_active=None,
                 pair_mode=None, cell_cfg=None, cell_exclusions=None,
                 cell_neighbors=None, pair_inert=None, zcol_W=None,
                 enable_cavity=True, enable_coulomb=True, enable_lj=True,
                 enable_bonds=True, custom_forces=(), ghost_typeid=-1,
                 dtype=torch.float64, device=None):
        super().__init__()

        def buf(name, x, dt=dtype):
            x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            self.register_buffer(name, torch.tensor(x, dtype=dt,
                                                    device=device))

        n_bonds = int(np.asarray(bond_group).shape[0])
        self.bonds_strided = bonds_are_consecutive(np.asarray(bond_group))
        self.n_bonds = n_bonds
        for name, x in (("bond_k", bond_k), ("bond_r0", bond_r0),
                        ("bond_k_per", bond_k_per),
                        ("bond_r0_per", bond_r0_per),
                        ("lj_eps", lj_eps), ("lj_sig2", lj_sig2),
                        ("lj_rcut2", lj_rcut2), ("lj_vshift", lj_vshift),
                        ("kappa", kappa), ("influence", influence),
                        ("volume", volume), ("omegac", omegac),
                        ("couplstr", couplstr), ("phmass", phmass)):
            buf(name, x)
        buf("bond_group", np.asarray(bond_group).reshape(-1, 2), torch.int32)
        buf("bond_typeid", bond_typeid, torch.int32)
        self.cell_cfg = (None if cell_cfg is None
                         else CellListConfig(*cell_cfg))
        if pair_mode is None:
            pair_mode = "dense" if cell_cfg is None else "cell"
        if pair_mode not in ("dense", "cell", "zcol"):
            raise ValueError(f"unknown pair_mode {pair_mode!r}")
        self.pair_mode = pair_mode
        self.zcol_W = None if zcol_W is None else int(zcol_W)
        if pair_mode == "zcol" and not (enable_lj and enable_coulomb
                                        and self.zcol_W):
            raise ValueError("pair_mode='zcol' needs LJ and Coulomb both on "
                             "and a visit window zcol_W")
        if self.pair_mode == "dense":
            # static (N, N) masks, 1 byte per pair; a disabled interaction
            # is an all-zero mask, which contributes exactly zero
            lj_on = np.asarray(lj_active, bool) & bool(enable_lj)
            coul_on = np.asarray(coulomb_active, bool) & bool(enable_coulomb)
            buf("lj_active", lj_on, torch.uint8)
            buf("coulomb_active", coul_on, torch.uint8)
        else:
            buf("cell_exclusions", cell_exclusions, torch.int32)
            buf("pair_inert", pair_inert, torch.bool)
            if self.pair_mode == "cell":
                buf("cell_neighbors", cell_neighbors, torch.int32)
            else:  # zcol merges the 9 xy-neighbour columns instead
                self.register_buffer("cell_neighbors", None)
                cx, cy, _ = self.cell_cfg.ncells
                buf("zcol_neighbors", xy_neighbor_table(cx, cy),
                    torch.int32)
        # host copy of kappa at the working precision: the kernel launch
        # takes it by value, so the step never reads it back from the device
        self.kappa_value = float(self.kappa)
        self.l_typeid = int(l_typeid)
        self.coulomb_rcut = float(coulomb_rcut)
        self.pppm_order = int(pppm_order)
        self.pppm_mesh = tuple(int(k) for k in pppm_mesh)
        self.enable_cavity = bool(enable_cavity) and self.l_typeid >= 0
        self.enable_coulomb = bool(enable_coulomb)
        self.enable_lj = bool(enable_lj)
        self.enable_bonds = bool(enable_bonds)
        self.custom_forces = tuple(custom_forces)
        self.ghost_typeid = int(ghost_typeid)
        self.row_comm = None  # bind_rows: the atom group of a row split

    @property
    def pppm(self) -> PPPMParams:
        return PPPMParams(self.influence, self.kappa, self.volume)

    @property
    def cavity(self) -> CavityParams:
        return CavityParams(self.omegac, self.couplstr, self.phmass)

    @property
    def n_types(self) -> int:
        """The number of particle types (the LJ tables are (T, T))."""
        return int(self.lj_eps.shape[0])

    def build_cells(self, position, box_L):
        """Bin the particles into the cell buckets (cell mode) or the
        z-sorted columns (zcol mode); the integrator carries the list and
        rebuilds it on displacement. Positions (B, N, 3) give a replica
        batch's list (``ops/neighbor.py``), each replica's equal to its
        one-replica build."""
        if self.pair_mode == "zcol":
            return build_zcol_list(position, box_L, self.cell_cfg,
                                   self.zcol_neighbors)
        return build_cell_list(position, box_L, self.cell_cfg,
                               self.cell_neighbors)

    def with_cell_capacity(self, cap: int) -> "ForceField":
        """A copy planned for bucket capacity ``cap`` (the overflow retry),
        with buffers of its own. In zcol mode the capacity is rounded up to
        a multiple of 128 and the visit window grows by 2 blocks, as the
        JAX package's retry grows it: a hull wider than the window is not
        fixed by more slots alone. The custom-force callables are the same
        objects, not copies."""
        ff = copy.deepcopy(self, {id(self.custom_forces): self.custom_forces,
                                  id(self.row_comm): self.row_comm})
        cap = int(cap)
        if self.pair_mode == "zcol":
            cap = -(-cap // 128) * 128
            ff.zcol_W = self.zcol_W + 2
        ff.cell_cfg = self.cell_cfg._replace(cap=cap)
        return ff

    def bind_rows(self, comm) -> "ForceField":
        """A copy of this force field, its buffers shared, whose
        ``forward`` splits the costly terms by rows over ``comm``'s ranks
        (the module note); ``comm=None`` gives the unsplit force field
        back."""
        if comm is self.row_comm:
            return self
        ff = copy.copy(self)
        ff.__dict__["_buffers"] = dict(self._buffers)
        ff.row_comm = comm
        return ff

    def _custom(self, i, fn, position, image, box_L, charge, typeid):
        """Custom force ``i``: one call, or for a replica batch one
        ``torch.func.vmap`` call over the replica axis of position and
        image (box, charges and types shared)."""
        if position.dim() == 2:
            return fn(position, image, box_L, charge, typeid)
        try:
            return torch.func.vmap(fn, in_dims=(0, 0, None, None, None))(
                position, image, box_L, charge, typeid)
        except RuntimeError as e:
            name = getattr(fn, "__qualname__", None) or repr(fn)
            raise ValueError(
                f"custom force {i} ({name}) cannot be batched over the "
                f"replica axis with torch.func.vmap (no in-place writes, "
                f".item() or data-dependent Python branches): {e}") from e

    def forward(self, position, image, box_L, charge, typeid, clist=None):
        """Total forces (N, 3) and the energy components (dict of 0-d
        tensors, keys ``ENERGY_KEYS``, plus ``cell_overflow`` in cell and
        zcol mode and ``custom_<i>`` for each custom force). ``position``
        and ``image`` may be a replica batch (B, N, 3); forces are then
        (B, N, 3) and every energy (B,).

        ``clist``: in cell and zcol mode, a carried ``CellList`` (batched
        for a batch); None builds one from ``position``."""
        forces = torch.zeros_like(position)
        zero = position.new_zeros(position.shape[:-2])
        energies = {k: zero for k in ENERGY_KEYS}
        comm = self.row_comm
        rows = own = None  # a row split: this rank's (row0, n) and slice
        if comm is not None:
            n = position.shape[-2]
            if n % comm.world_size:
                raise ValueError(
                    f"N={n} not divisible by {comm.world_size} row shards; "
                    "pad the snapshot first "
                    "(cavmd_tpu_torch.parallel.pad_snapshot_to)")
            n_rows = n // comm.world_size
            rows = (comm.rank * n_rows, n_rows)
            own = slice(rows[0], rows[0] + n_rows)
            row_f = position.new_zeros(position.shape[:-2] + (n_rows, 3))

        if self.enable_bonds and self.n_bonds > 0:
            if self.bonds_strided:
                f, e = harmonic_bond_force_strided(
                    position, box_L, self.n_bonds, self.bond_k_per,
                    self.bond_r0_per)
            else:
                f, e = harmonic_bond_force(
                    position, box_L, self.bond_group, self.bond_typeid,
                    self.bond_k, self.bond_r0)
            forces = forces + f
            energies["harmonic"] = e

        if self.pair_mode in ("cell", "zcol") and (self.enable_lj
                                                   or self.enable_coulomb):
            if clist is None:
                clist = self.build_cells(position, box_L)
            # a bucket overflow drops pairs: the flag rides the
            # observables so Simulation.run can grow the cap and retry
            energies["cell_overflow"] = clist.overflow.to(position.dtype)
            tables = (typeid, charge, self.lj_eps, self.lj_sig2,
                      self.lj_rcut2, self.lj_vshift, self.cell_exclusions,
                      self.kappa_value)
            if self.pair_mode == "zcol":
                f, e_lj, e_ew, win = zcol_pair_force(
                    position, box_L, clist, self.cell_cfg, *tables,
                    self.zcol_W, rows=rows)
                # a hull wider than the visit window drops pair blocks:
                # the same failure, the same channel
                energies["cell_overflow"] = torch.maximum(
                    energies["cell_overflow"], win.to(position.dtype))
            else:
                f, e_lj, e_ew = cell_pair_force_fused(
                    position, box_L, clist, self.cell_cfg, *tables,
                    lj_on=self.enable_lj, coul_on=self.enable_coulomb,
                    rows=rows)
            if own is None:
                forces = forces + f
            else:  # the rank's rows; the pass gives zeros elsewhere
                row_f = row_f + f[..., own, :]
            energies["lj"] = e_lj
            energies["ewald_short"] = e_ew
        elif self.enable_lj or self.enable_coulomb:
            f, e_lj, e_ew = dense_pair_force(
                position, box_L, typeid, self.lj_eps, self.lj_sig2,
                self.lj_rcut2, self.lj_vshift, charge, self.lj_active,
                self.coulomb_active, self.kappa_value,
                self.coulomb_rcut * self.coulomb_rcut, rows=rows)
            if own is None:
                forces = forces + f
            else:
                row_f = row_f + f
            energies["lj"] = e_lj
            energies["ewald_short"] = e_ew

        if self.enable_coulomb:
            if own is None:
                f_rec, e_rec = pppm_force_and_energy(
                    position, charge, box_L, self.pppm, self.pppm_order,
                    self.pppm_mesh)
            else:
                f_own, e_rec = pppm_force_and_energy_rows(
                    position, charge, box_L, self.pppm, self.pppm_order,
                    self.pppm_mesh, own, comm.sum)
                row_f = row_f + f_own
                f_rec = 0.0
            if self.bonds_strided:
                f_corr, e_corr = ewald_exclusion_correction_strided(
                    position, box_L, charge, self.kappa, self.n_bonds)
            else:
                f_corr, e_corr = ewald_exclusion_correction(
                    position, box_L, charge, self.kappa, self.bond_group)
            e_self = ewald_self_energy(charge, self.kappa)
            forces = forces + f_rec - f_corr
            energies["ewald_long"] = e_rec - e_self - e_corr

        if comm is not None:
            forces, energies["lj"], energies["ewald_short"] = gather_rows(
                comm, forces, row_f, energies["lj"], energies["ewald_short"])

        for i, fn in enumerate(self.custom_forces):
            f, e = self._custom(i, fn, position, image, box_L, charge, typeid)
            forces = forces + f
            energies[f"custom_{i}"] = e

        if self.enable_cavity:
            f, e = cavity_force(position, image, box_L, charge, typeid,
                                self.l_typeid, self.cavity)
            forces = forces + f
            energies["cavity_harmonic"] = e["harmonic"]
            energies["cavity_coupling"] = e["coupling"]
            energies["cavity_dipole_self"] = e["dipole_self"]

        return forces, energies

    @staticmethod
    def create(
        snapshot: Snapshot,
        *,
        coupling: float = 1e-3,
        freq_cm1: float = 2000.0,
        phmass: float = 1.0,
        enable_cavity: bool = True,
        enable_coulomb: bool = True,
        enable_lj: bool = True,
        enable_bonds: bool = True,
        lj_params: dict | None = None,
        bond_params: dict | None = None,
        r_cut: float = 15.0,
        pppm_mesh: Tuple[int, int, int] = (32, 32, 32),
        pppm_order: int = 6,
        kappa: float | None = None,
        ewald_accuracy: float = 1e-6,
        kappa_mode: str = "erfc",
        pair_mode: str | None = None,
        cell_skin: float = 0.5,
        cell_cap: int | None = None,
        custom_forces: tuple = (),
        dtype=None,
        device=None,
    ) -> "ForceField":
        """The reference workflow's force mix for a snapshot
        (``examples/05_advanced_run.py:556-608``): cavity, O-O/N-N harmonic
        bonds, shifted LJ with r_cut 15 and inert photon rows, PPPM 32^3
        order 6.

        ``pair_mode``: 'dense' (all pairs, two (N, N) masks), 'cell' (cell
        lists) or 'zcol' (z-sorted xy columns, opt-in); None picks dense
        for N <= 4096 and cell above, as the JAX package does.
        ``custom_forces``: user force callables (the module note).
        ``cell_skin`` is the requested minimum Verlet skin (snapped up to
        the free slack of the cell or column grid; 0 rebuilds the list
        every step) and ``cell_cap`` the bucket capacity (None plans it
        from the density; zcol rounds it up to a multiple of 128). The
        Ewald splitting
        parameter is ``kappa`` when given; else ``kappa_mode`` picks it:
        'erfc' (erfc(kappa r_cut) = ``ewald_accuracy``) or 'kolafa-perram'
        (the Kolafa-Perram error estimate on the snapshot's charges and
        box, HOOMD's alpha = 0 choice). Zcol mode needs one cutoff
        for every LJ type pair, LJ and Coulomb both on, and at least 3
        columns along x and y; its visit window is planned here.
        """
        from cavmd_tpu_torch.core.system import BOND_PARAMS, LJ_PARAMS
        from cavmd_tpu_torch.core.units import PhysicalConstants

        n = snapshot.N
        if pair_mode is None:
            pair_mode = "dense" if n <= DENSE_MAX_N else "cell"
        if pair_mode not in ("dense", "cell", "zcol"):
            raise NotImplementedError(
                f"pair_mode={pair_mode!r}: cavmd_tpu_torch ports the dense, "
                "cell and zcol pair modes")
        dtype = dtype or snapshot.position.dtype
        device = device if device is not None else snapshot.device
        lj_params = lj_params if lj_params is not None else LJ_PARAMS
        bond_params = bond_params if bond_params is not None else BOND_PARAMS

        def host(x, dt=None):
            x = x.detach().cpu()
            return x.to(dt).numpy() if dt is not None else x.numpy()

        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        bond_types = snapshot.bond_types or tuple(bond_params.keys())
        bond_k = np.asarray([bond_params[t]["k"] for t in bond_types],
                            np_dtype)
        bond_r0 = np.asarray([bond_params[t]["r0"] for t in bond_types],
                             np_dtype)
        btid = host(snapshot.bond_typeid)

        types = list(snapshot.types)
        eps, sig, rcut_t = lj_pair_tables(
            types,
            {k: {**v, "r_cut": v.get("r_cut", r_cut)}
             for k, v in lj_params.items()},
            dtype=dtype,
        )
        eps_t, sig2_t, rcut2_t, vshift_t = lj_kernel_tables(eps, sig, rcut_t)
        typeid = host(snapshot.typeid)
        charge = host(snapshot.charge, dtype)
        bond_group = host(snapshot.bond_group)
        if pair_mode == "dense":
            excl = bond_exclusion_mask(n, bond_group)
            qq = charge[:, None] * charge[None, :]
            pair_data = dict(
                lj_active=lj_active_mask(typeid, eps_t, rcut2_t, excl),
                coulomb_active=(~np.eye(n, dtype=bool)) & (qq != 0) & ~excl)
        else:
            box = host(snapshot.box_L, torch.float64)
            lj_type = np.any(eps_t != 0, axis=1)
            pair_data = dict(
                pair_mode=pair_mode,
                cell_exclusions=exclusion_table(n, bond_group),
                pair_inert=~lj_type[typeid] & (charge == 0))
            if pair_mode == "cell":
                cfg = plan_cells(box, r_cut, skin=cell_skin, n=n,
                                 cap=cell_cap)
                pair_data["cell_neighbors"] = neighbor_cell_table(cfg.ncells)
            else:
                rc_enabled = np.unique(rcut_t.numpy()[eps.numpy() != 0])
                if len(rc_enabled) != 1 or not (enable_lj and enable_coulomb):
                    raise ValueError(
                        "pair_mode='zcol' needs a uniform cutoff with both "
                        "LJ and Coulomb enabled (the fused kernel's "
                        "contract); use pair_mode='cell'")
                cfg = plan_zcolumns(box, r_cut, skin=cell_skin, n=n)
                if min(cfg.ncells[:2]) < 3:
                    raise ValueError(
                        "pair_mode='zcol' needs >=3 columns per xy axis "
                        f"(got {cfg.ncells[:2]}); use pair_mode='cell'")
                if cell_cap is not None:
                    # the column capacity stays a multiple of the j-block
                    cfg = cfg._replace(cap=((cell_cap + 127) // 128) * 128)
                pair_data["zcol_W"] = plan_zcol_window(
                    n, cfg.ncells[0] * cfg.ncells[1], cfg.ncells[:2])
            pair_data["cell_cfg"] = cfg

        if kappa is not None:
            kappa_val = kappa
        elif kappa_mode == "kolafa-perram":
            kappa_val = auto_kappa_error_estimate(
                host(snapshot.charge, torch.float64),
                host(snapshot.box_L, torch.float64), r_cut)
        elif kappa_mode == "erfc":
            kappa_val = auto_kappa(r_cut, ewald_accuracy)
        else:
            raise ValueError(f"kappa_mode={kappa_mode!r}: 'erfc' or "
                             "'kolafa-perram'")
        pppm, _ = PPPMParams.create(host(snapshot.box_L, torch.float64),
                                    mesh=pppm_mesh, order=pppm_order,
                                    kappa=kappa_val, dtype=dtype)
        omegac = PhysicalConstants.omega_from_cm1(freq_cm1)
        return ForceField(
            bond_k=bond_k, bond_r0=bond_r0,
            bond_k_per=bond_k[btid], bond_r0_per=bond_r0[btid],
            bond_group=bond_group,
            bond_typeid=btid,
            lj_eps=eps_t, lj_sig2=sig2_t, lj_rcut2=rcut2_t,
            lj_vshift=vshift_t, **pair_data,
            kappa=pppm.kappa, influence=pppm.influence, volume=pppm.volume,
            omegac=omegac, couplstr=coupling, phmass=phmass,
            l_typeid=types.index("L") if "L" in types else -1,
            coulomb_rcut=r_cut, pppm_order=pppm_order, pppm_mesh=pppm_mesh,
            enable_cavity=enable_cavity, enable_coulomb=enable_coulomb,
            enable_lj=enable_lj, enable_bonds=enable_bonds,
            custom_forces=custom_forces,
            ghost_typeid=ghost_typeid_of(types),
            dtype=dtype, device=device,
        )
