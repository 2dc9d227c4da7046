"""The MD integrator: one step function and a chunked runner.

Port of ``cavmd_tpu/integrate/integrator.py`` (methods nve / bussi /
langevin / brownian / mttk / berendsen). Per step, in this order:

1. thermostat half 1: Bussi on its group (reservoir += KE (1 - alpha^2)),
   the MTTK factor exp(-xi dt/2), the Berendsen factor lambda from the
   group's current temperature;
2. velocity-Verlet kick v += dt/2 a(t), drift x += dt v (Brownian groups:
   an overdamped Euler-Maruyama move and Maxwell-resampled velocities
   instead), re-wrap;
3. all forces (``ForceField.forward``);
4. second kick v += dt/2 a(t + dt) (not on Brownian groups);
5. thermostat half 2: the MTTK factor again, then (xi, eta) advanced from
   the rescaled kinetic energy; exact-OU Langevin on its group (reservoir
   += KE loss);
6. the energy audit: every column of the reference EnergyTracker, plus
   the optional ``extra_obs`` columns (dipole, rho(k)).

For the production pattern (Bussi on the molecules, Langevin on the one
photon) steps 1-2 and 4-6 can instead run as the two fused kernels of
``ops/fused_integrator.py`` (K4 before the forces, K5 after), drawing the
same random numbers; see ``make_step_fn``. MTTK and Berendsen baths run
the unfused tail, as in the JAX package.

Group membership is by particle type (molecular = not 'L', cavity = 'L'),
so masks and DOF are static. ``run_steps`` runs a chunk of steps with no
host synchronisation inside it: each step writes its observables into one
preallocated ``(n_steps, n_cols)`` device buffer, which is copied to the
host once at the end of the chunk.

One step function also advances a replica batch (``parallel/replicas.py``):
an ``MDState`` whose per-replica leaves carry a leading axis B (positions,
images, velocities and forces (B, N, 3); dt, the clocks, the timestep and
the tolerance (B,); the reservoirs and the MTTK (xi, eta) (B, 2); in cell
and zcol mode the carried list and its anchor, one a replica) while mass,
charge, typeid and the box stay shared. Every operation of the step is
written over the last two axes, so the batch runs the same code as one
replica, each kernel launched once for all B, and each random stream is
drawn once a step for the whole batch. The observables then have a replica axis: (steps, B)
columns and (steps, B, d) vectors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cavmd_tpu_torch.core.box import minimum_image, rewrap
from cavmd_tpu_torch.core.snapshot import (
    Snapshot,
    ghost_typeid_of,
    real_rows,
)
from cavmd_tpu_torch.integrate.forcefield import ENERGY_KEYS, ForceField
from cavmd_tpu_torch.integrate.rng import (
    STREAM_BROWNIAN,
    STREAM_BUSSI,
    STREAM_LANGEVIN,
    STREAM_THERMALIZE,
    make_generator,
)
from cavmd_tpu_torch.integrate.thermostats import (
    MTTKState,
    berendsen_factor,
    brownian_apply,
    bussi_apply,
    bussi_noise,
    kinetic_energy,
    langevin_ou_apply,
    mttk_advance,
    mttk_rescale_factor,
    thermalize_velocities,
)

# group slots for reservoir bookkeeping (index into the (2,) accumulators)
MOLECULAR, CAVITY = 0, 1
SUPPORTED_METHODS = ("nve", "bussi", "langevin", "brownian", "mttk",
                     "berendsen")

OBS_KEYS = ENERGY_KEYS + (
    "kinetic_molecular", "kinetic_cavity",
    "bussi_reservoir_molecular", "bussi_reservoir_cavity",
    "langevin_reservoir_molecular", "langevin_reservoir_cavity",
    "dt", "time_au", "timestep",
)


class MethodSpec(NamedTuple):
    """Static description of one integration method (HOOMD ``methods``
    entry): ``kind`` in nve | bussi | langevin | brownian | mttk |
    berendsen, ``group`` in molecular | cavity | all; ``tau`` and
    ``gamma`` in atomic units."""

    kind: str
    group: str
    kT: float = 0.0
    tau: float = 0.0
    gamma: float = 0.0
    dof: float = 0.0
    indices: tuple | None = None


@dataclasses.dataclass(frozen=True)
class MDState:
    """Full dynamic state of the simulation.

    ``generators`` maps (stream, method index) to the state's
    ``torch.Generator`` for that stream; they advance as the run draws.
    ``step`` is the host's copy of ``timestep``: host-side decisions (the
    adaptive-dt period, the runner's timestep column) read it instead of
    the device counter, so they cost no host sync. In cell mode with a
    skin, ``cell_list`` is the carried ``CellList`` and ``cell_anchor`` the
    positions it was built from (None otherwise). A replica batch carries
    a leading axis on its per-replica leaves (the module note); its
    replicas step together, so one host ``step`` serves them all.
    """

    position: torch.Tensor
    image: torch.Tensor
    velocity: torch.Tensor
    mass: torch.Tensor
    charge: torch.Tensor
    typeid: torch.Tensor
    box_L: torch.Tensor
    forces: torch.Tensor
    dt: torch.Tensor
    time_au: torch.Tensor
    time_comp: torch.Tensor  # Kahan compensation of time_au
    timestep: torch.Tensor  # int32
    bussi_reservoir: torch.Tensor  # (2,) [molecular, cavity]
    bussi_instantaneous: torch.Tensor  # (2,) last-step delta
    langevin_reservoir: torch.Tensor  # (2,)
    mttk_xi: torch.Tensor  # (2,) MTTK xi [molecular, cavity]
    mttk_eta: torch.Tensor  # (2,) MTTK eta
    error_tolerance: torch.Tensor  # current adaptive tolerance (0: fixed dt)
    step: int = 0
    seed: int = 0
    generators: dict = dataclasses.field(default_factory=dict)
    cell_list: object = None
    cell_anchor: torch.Tensor | None = None

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self):
        return self.position.device

    @property
    def batch_shape(self) -> tuple:
        """() for one replica, (B,) for a replica batch."""
        return tuple(self.position.shape[:-2])

    def generator(self, stream: int, instance: int = 0) -> torch.Generator:
        """The generator of (stream, instance), created on first use from
        (seed, stream, instance) on the state's device."""
        key = (stream, instance)
        if key not in self.generators:
            self.generators[key] = make_generator(self.seed, stream,
                                                  instance, self.device)
        return self.generators[key]


def group_mask(typeid, l_typeid: int, group: str, ghost_typeid: int = -1):
    """The rows of a typed group; ghost rows (``ghost_typeid``, the
    padding of ``parallel.pad_snapshot_to``) belong to no group: counted
    into a thermostat group they would inflate its DOF and skew its
    target temperature."""
    if group == "molecular":
        mask = typeid != l_typeid
    elif group == "cavity":
        return typeid == l_typeid
    elif group == "all":
        mask = torch.ones_like(typeid, dtype=torch.bool)
    else:
        raise ValueError(f"unknown group '{group}'")
    return mask & (typeid != ghost_typeid) if ghost_typeid >= 0 else mask


def group_slot(group: str) -> int:
    return CAVITY if group == "cavity" else MOLECULAR


def resolve_methods(snapshot: Snapshot, methods: Tuple[MethodSpec, ...],
                    l_typeid: int) -> Tuple[MethodSpec, ...]:
    """Fill in static group DOF counts (3 N_group) and, for groups of at
    most 8 particles, the member indices. Ghost rows join no group."""
    typeid = snapshot.typeid.cpu().numpy()
    ghost = ghost_typeid_of(snapshot.types)
    real = typeid != ghost if ghost >= 0 else np.ones(len(typeid), bool)
    out = []
    for m in methods:
        if m.group == "molecular":
            members = np.where((typeid != l_typeid) & real)[0]
        elif m.group == "cavity":
            members = np.where(typeid == l_typeid)[0]
        else:
            members = np.where(real)[0]
        n = len(members)
        indices = tuple(int(i) for i in members) if n <= 8 else None
        out.append(m._replace(dof=3.0 * n, indices=indices))
    return tuple(out)


def thermal_velocities(mass, typeid, l_typeid: int, kT, seed: int, *,
                       molecular_only: bool = True, photon_kT=None,
                       ghost_typeid: int = -1):
    """Maxwell-Boltzmann velocities from the thermalize streams of
    ``seed``: the molecular group (every particle unless
    ``molecular_only``) with its drift removed, and with ``molecular_only``
    the photon drawn apart at ``photon_kT`` (None: ``kT``). Ghost rows
    (``ghost_typeid``, a tail after every real row) stay at rest and take
    no draw: the real rows get the velocities of the unpadded scene."""
    if ghost_typeid >= 0:
        n_real = real_rows(typeid, ghost_typeid)
        v = thermal_velocities(mass[:n_real], typeid[:n_real], l_typeid, kT,
                               seed, molecular_only=molecular_only,
                               photon_kT=photon_kT)
        return torch.cat([v, v.new_zeros((mass.shape[0] - n_real, 3))])
    dev, dtype = mass.device, mass.dtype
    group = "molecular" if molecular_only else "all"
    v = thermalize_velocities(
        make_generator(seed, STREAM_THERMALIZE, 0, dev), mass,
        group_mask(typeid, l_typeid, group),
        torch.as_tensor(kT, dtype=dtype, device=dev))
    if molecular_only and l_typeid >= 0:
        pk = photon_kT if photon_kT is not None else kT
        v = v + thermalize_velocities(
            make_generator(seed, STREAM_THERMALIZE, 1, dev), mass,
            typeid == l_typeid, torch.as_tensor(pk, dtype=dtype, device=dev),
            remove_drift=False)
    return v


def carries_cell_list(ff: ForceField) -> bool:
    """Cell or zcol mode with a skin: the state carries the list between
    steps."""
    return ff.pair_mode in ("cell", "zcol") and ff.cell_cfg.skin > 0


def init_state(snapshot: Snapshot, ff: ForceField, *, dt: float,
               seed: int = 0, error_tolerance: float = 0.0) -> MDState:
    """The initial MDState on the snapshot's device (computes the initial
    forces once; in cell mode with a skin also builds the carried cell
    list)."""
    dtype = snapshot.position.dtype
    dev = snapshot.device
    clist = anchor = None
    with torch.no_grad():
        if carries_cell_list(ff):
            clist = ff.build_cells(snapshot.position, snapshot.box_L)
            anchor = snapshot.position
        forces, _ = ff(snapshot.position, snapshot.image, snapshot.box_L,
                       snapshot.charge, snapshot.typeid, clist=clist)
    z2 = torch.zeros(2, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return MDState(
        position=snapshot.position,
        image=snapshot.image,
        velocity=snapshot.velocity,
        mass=snapshot.mass,
        charge=snapshot.charge,
        typeid=snapshot.typeid,
        box_L=snapshot.box_L,
        forces=forces,
        dt=torch.as_tensor(dt, dtype=dtype, device=dev),
        time_au=zero,
        time_comp=zero.clone(),
        timestep=torch.zeros((), dtype=torch.int32, device=dev),
        bussi_reservoir=z2,
        bussi_instantaneous=z2.clone(),
        langevin_reservoir=z2.clone(),
        mttk_xi=z2.clone(),
        mttk_eta=z2.clone(),
        error_tolerance=torch.as_tensor(error_tolerance, dtype=dtype,
                                        device=dev),
        seed=seed,
        cell_list=clist,
        cell_anchor=anchor,
    )


class StreamNoise:
    """The default noise source: draws from the state's per-stream
    generators. A replacement (for example one that hands in another
    package's draws) implements the same three methods.

    With ``full_batch`` and ``rows`` it gives the draws of rows ``rows``
    (a slice) of a batch of ``full_batch`` replicas to a state that holds
    only those rows (replicas over ranks: ``--shard-replicas`` and
    ``make_domain_runner(n_replicas=)``): each stream is drawn at the full
    batch's shape from the state's generators (the full batch's, seeded
    alike) and the slice's rows are kept, so a slice steps with the noise
    the full batch gives those replicas. A one-replica state (batch shape
    ()) takes a one-row slice squeezed (the slab runner's replica). Cost:
    every rank draws the whole batch. A Bussi draw is (2, B), the exact
    chi-square below a shape of 30 (B, dof - 1), the photon's Langevin
    (B, 1, 3): small beside a step. A molecular Langevin or Brownian bath
    draws (B, N, 3) a stream on every rank, R times the work of the
    slice's own draws.
    """

    def __init__(self, full_batch: int | None = None,
                 rows: slice | None = None):
        if (full_batch is None) != (rows is None):
            raise ValueError("give full_batch and rows together")
        if rows is not None:
            start, stop, step = rows.indices(full_batch)
            if step != 1 or stop <= start:
                raise ValueError(f"rows {rows} is not a slice of a "
                                 f"{full_batch}-replica batch")
            rows = slice(start, stop)
        self.full_batch = full_batch
        self.rows = rows

    def _batch(self, state: MDState) -> tuple:
        """The leading shape of a draw: the state's batch shape, or the
        full batch's."""
        if self.rows is None:
            return state.batch_shape
        return (self.full_batch,)

    def _keep(self, state: MDState, x):
        """The state's rows of the draw ``x``, shaped as its batch."""
        if self.rows is None:
            return x
        batch = state.batch_shape
        want = self.rows.stop - self.rows.start
        if (batch[0] if batch else 1) != want:
            raise ValueError(f"a state of batch shape {batch} for the "
                             f"{want} rows {self.rows}")
        return x[self.rows].reshape(batch + x.shape[1:])

    def _randn(self, state: MDState, gen, shape):
        """Standard-normal draws of ``shape`` (the state's batch shape
        leading), drawn at the leading shape of ``_batch``."""
        shape = self._batch(state) + tuple(shape)[len(state.batch_shape):]
        return self._keep(state, torch.randn(
            shape, generator=gen, dtype=state.position.dtype,
            device=state.device))

    def bussi(self, state: MDState, i: int, m: MethodSpec):
        """(r1, r_gamma) for Bussi method ``i``, each of the state's batch
        shape (one draw call for every replica)."""
        r1, r_gamma = bussi_noise(state.generator(STREAM_BUSSI, i), m.dof,
                                  state.position.dtype, state.device,
                                  self._batch(state))
        return self._keep(state, r1), self._keep(state, r_gamma)

    def langevin(self, state: MDState, i: int, m: MethodSpec, shape):
        """Standard-normal draws of ``shape`` (the batch shape leading) for
        Langevin method ``i``."""
        return self._randn(state, state.generator(STREAM_LANGEVIN, i), shape)

    def brownian(self, state: MDState, i: int, m: MethodSpec):
        """Two (..., N, 3) standard-normal draws for Brownian method ``i``:
        the position noise, then the velocity resample."""
        gen = state.generator(STREAM_BROWNIAN, i)
        return tuple(self._randn(state, gen, state.position.shape)
                     for _ in range(2))


def _set_at(x, slot: int, value, add: bool):
    """A copy of the (..., 2) reservoir ``x`` with its ``slot`` column
    set to (or increased by) ``value``."""
    out = x.clone()
    if add:
        out[..., slot] += value
    else:
        out[..., slot] = value
    return out


def make_step_fn(ff: ForceField, methods: Tuple[MethodSpec, ...],
                 extra_obs=None, fuse_integrator: bool | None = None,
                 noise=None):
    """Build ``step(state) -> (new_state, obs)``.

    ``obs`` is a dict of tensors with keys ``OBS_KEYS`` (0-d) plus those of
    ``extra_obs(new_state)`` (a dict of 0-d or 1-d tensors, for example
    ``observe.make_extra_obs``); for a replica batch each gains the leading
    replica axis. The step reads nothing back from the device. ``noise``
    supplies the random draws (default
    :class:`StreamNoise`, which advances the state's generators in place;
    every tensor of ``state`` itself is left unmodified — the new state
    holds new tensors).

    ``fuse_integrator`` selects the fused tail (``ops/fused_integrator.py``:
    K4 before the forces, K5 after; same draws, in the same order, as the
    unfused path). ``None`` turns it on when the state is float32 on a
    CUDA device and the methods fit its pattern, and silently off
    otherwise; ``True`` turns it on for any float32 state (a float64 state
    runs unfused, as in the JAX package) and raises ``ValueError`` if the
    methods do not fit (an MTTK or Berendsen bath never does: K4/K5 take
    Bussi and Langevin only, as the JAX kernels do); ``False`` turns it
    off. The
    JAX package keeps ``None`` off because two kernel launches cost more
    than the XLA tail on its TPU; on the GPU the eager unfused tail is
    dozens of launches.
    """
    for m in methods:
        if m.kind not in SUPPORTED_METHODS:
            raise NotImplementedError(
                f"method kind {m.kind!r}: cavmd_tpu_torch ports "
                f"{SUPPORTED_METHODS}")
    noise_given = noise
    noise = noise if noise is not None else StreamNoise()
    l_typeid = ff.l_typeid
    ghost = ff.ghost_typeid
    index_cache = {}
    plan_cache = {}
    mask_cache = {}

    def _indices(i, m, device):
        if m.indices is None:
            return None
        key = (i, device)
        if key not in index_cache:
            index_cache[key] = torch.as_tensor(m.indices, dtype=torch.long,
                                               device=device)
        return index_cache[key]

    def _mol_mask(state):
        key = state.device
        if key not in mask_cache:
            mask_cache[key] = group_mask(state.typeid, l_typeid, "molecular",
                                         ghost)
        return mask_cache[key]

    def _fused_plan(state):
        dtype = state.position.dtype
        if fuse_integrator is False or dtype != torch.float32:
            return None
        if fuse_integrator is None and state.device.type != "cuda":
            return None
        key = (tuple(state.position.shape[:-1]), dtype)  # (B,) N, dtype
        if key not in plan_cache:
            from cavmd_tpu_torch.ops.fused_integrator import (
                FusedIntegratorPlan,
            )

            try:
                plan_cache[key] = FusedIntegratorPlan(ff, methods,
                                                      key[0][-1], dtype)
            except ValueError:
                if fuse_integrator:  # explicitly requested: surface it
                    raise
                plan_cache[key] = None
        return plan_cache[key]

    def _cond_rebuild(state, pos):
        """The carried cell list for the new positions: rebuilt when some
        pair-active particle has moved more than skin/2 since the anchor
        (the HOOMD buffer policy; the photon is pair-inert and ignored).
        The JAX package skips the rebuild with ``lax.cond``; a host branch
        here would read the flag back every step, so the rebuild always
        runs and ``torch.where`` picks the new or the carried list, anchor
        included, on the device. A zcol list also swaps its anchors and
        merged halo with it: a new anchor against stale local coordinates
        would break the window pruning. A replica batch decides per
        replica, as ``lax.cond`` under ``jax.vmap`` does: ``need`` is (B,),
        broadcast over each replica's list fields and anchor."""
        if state.cell_list is None:
            return None, None
        half_skin = 0.5 * ff.cell_cfg.skin
        disp = minimum_image(pos - state.cell_anchor, state.box_L)
        disp2 = torch.where(ff.pair_inert, 0.0,
                            torch.sum(disp * disp, dim=-1))
        need = torch.amax(disp2, dim=-1) > half_skin * half_skin
        new = ff.build_cells(pos, state.box_L)
        old = state.cell_list
        fields = ["bucket_idx", "overflow", "slot_of"]
        if old.halo_idx is not None:
            fields += ["anchor", "local_anchor", "halo_idx"]

        def pick(a, b):  # need over a's replica axis (a view)
            return torch.where(need.view(need.shape + (1,) * (
                a.dim() - need.dim())), a, b)

        clist = old._replace(**{k: pick(getattr(new, k), getattr(old, k))
                                for k in fields})
        return clist, pick(pos, state.cell_anchor)

    def _finish(state, pos, image, v, forces, energies, bussi_res,
                bussi_inst, langevin_res, ke_mol, ke_cav, clist, anchor,
                mttk):
        """Shared step tail: Kahan time, state replace, obs dict.
        ``mttk``: the new MTTK (xi, eta)."""
        dt = state.dt
        y = dt - state.time_comp
        t_new = state.time_au + y
        comp_new = (t_new - state.time_au) - y
        new_state = state.replace(
            position=pos, image=image, velocity=v, forces=forces,
            time_au=t_new, time_comp=comp_new,
            timestep=state.timestep + 1, step=state.step + 1,
            bussi_reservoir=bussi_res,
            bussi_instantaneous=bussi_inst,
            langevin_reservoir=langevin_res, mttk_xi=mttk[0],
            mttk_eta=mttk[1], cell_list=clist, cell_anchor=anchor,
        )
        obs = dict(energies)
        obs["kinetic_molecular"] = ke_mol
        obs["kinetic_cavity"] = ke_cav
        obs["bussi_reservoir_molecular"] = bussi_res[..., MOLECULAR]
        obs["bussi_reservoir_cavity"] = bussi_res[..., CAVITY]
        obs["langevin_reservoir_molecular"] = langevin_res[..., MOLECULAR]
        obs["langevin_reservoir_cavity"] = langevin_res[..., CAVITY]
        obs["dt"] = dt
        obs["time_au"] = t_new
        obs["timestep"] = new_state.timestep
        if extra_obs is not None:
            obs.update(extra_obs(new_state))
        return new_state, obs

    def _fused_step(state: MDState, plan):
        """K4 + forces + K5: the same draws and update sequence as the
        unfused path below; differs only in reduction order."""
        from cavmd_tpu_torch.ops.fused_integrator import (
            post_force_apply,
            pre_force_apply,
        )

        dt = state.dt
        mol = _mol_mask(state)
        mb = plan.bussi
        # the kernels take contiguous rows (an injected draw may be a view)
        r1, r_gamma = (x.contiguous()
                       for x in noise.bussi(state, plan.i_bussi, mb))
        c = (torch.exp(-dt / mb.tau) if mb.tau != 0.0
             else torch.zeros_like(dt))
        pos, image, v, dres_b = pre_force_apply(
            plan, state.position, state.image, state.velocity, state.forces,
            state.mass, mol, state.box_L, dt, c, mb.kT, r1, r_gamma)
        bussi_res = _set_at(state.bussi_reservoir, MOLECULAR, dres_b,
                            add=True)
        bussi_inst = _set_at(state.bussi_instantaneous, MOLECULAR, dres_b,
                             add=False)

        clist, anchor = _cond_rebuild(state, pos)
        forces, energies = ff(pos, image, state.box_L, state.charge,
                              state.typeid, clist=clist)

        langevin_res = state.langevin_reservoir
        if plan.langevin is not None:
            ml = plan.langevin
            xi = noise.langevin(state, plan.i_langevin, ml,
                                state.batch_shape + (1, 3)).contiguous()
            c_ou = torch.exp(-ml.gamma * dt)
            sig = torch.sqrt((1.0 - c_ou * c_ou) * ml.kT
                             / state.mass[plan.photon])
            v, ke_mol, ke_cav, dres_l = post_force_apply(
                plan, v, forces, state.mass, mol, dt, c_ou, sig, xi)
            langevin_res = _set_at(langevin_res, CAVITY, dres_l, add=True)
        else:
            v, ke_mol, ke_cav, _ = post_force_apply(
                plan, v, forces, state.mass, mol, dt, None, None, None)
        return _finish(state, pos, image, v, forces, energies, bussi_res,
                       bussi_inst, langevin_res, ke_mol, ke_cav, clist,
                       anchor, (state.mttk_xi, state.mttk_eta))

    def step(state: MDState):
        plan = _fused_plan(state)
        if plan is not None:
            return _fused_step(state, plan)

        dev = state.device
        dt = state.dt
        dt_v = dt[..., None, None]  # per replica, over (N, 3)
        v = state.velocity
        bussi_res = state.bussi_reservoir
        bussi_inst = state.bussi_instantaneous
        langevin_res = state.langevin_reservoir
        xi, eta = state.mttk_xi, state.mttk_eta

        # ---- thermostat half 1 ----
        for i, m in enumerate(methods):
            if m.kind not in ("bussi", "mttk", "berendsen"):
                continue
            mask = group_mask(state.typeid, l_typeid, m.group, ghost)
            slot = group_slot(m.group)
            if m.kind == "bussi":
                r1, r_gamma = noise.bussi(state, i, m)
                v, dres = bussi_apply(v, state.mass, mask, m.dof, dt, m.tau,
                                      m.kT, r1, r_gamma)
                bussi_res = _set_at(bussi_res, slot, dres, add=True)
                bussi_inst = _set_at(bussi_inst, slot, dres, add=False)
            elif m.kind == "mttk":
                alpha = mttk_rescale_factor(
                    MTTKState(xi[..., slot], eta[..., slot]), dt)
                v = torch.where(mask[:, None], alpha[..., None, None] * v, v)
            elif m.kind == "berendsen":
                cur_T = 2.0 * kinetic_energy(v, state.mass, mask) / m.dof
                lam = berendsen_factor(cur_T, m.kT, dt, m.tau)
                v = torch.where(mask[:, None], lam[..., None, None] * v, v)

        # ---- velocity Verlet ----
        inv_m = 1.0 / state.mass[:, None]
        v = v + 0.5 * dt_v * state.forces * inv_m
        pos = state.position + dt_v * v
        # Brownian groups: the overdamped move replaces the VV drift; their
        # velocities are Maxwell-resampled and skip the second kick
        brownian_mask = None
        for i, m in enumerate(methods):
            if m.kind == "brownian":
                mask = group_mask(state.typeid, l_typeid, m.group, ghost)
                slot = group_slot(m.group)
                xi_pos, xi_vel = noise.brownian(state, i, m)
                bpos, bv, dres = brownian_apply(
                    state.position, state.velocity, state.forces,
                    state.mass, mask, m.gamma, m.kT, dt, xi_pos, xi_vel)
                pos = torch.where(mask[:, None], bpos, pos)
                v = torch.where(mask[:, None], bv, v)
                langevin_res = _set_at(langevin_res, slot, dres, add=True)
                brownian_mask = (mask if brownian_mask is None
                                 else brownian_mask | mask)
        pos, image = rewrap(pos, state.image, state.box_L)

        clist, anchor = _cond_rebuild(state, pos)
        forces, energies = ff(pos, image, state.box_L, state.charge,
                              state.typeid, clist=clist)
        kick2 = 0.5 * dt_v * forces * inv_m
        if brownian_mask is not None:
            kick2 = torch.where(brownian_mask[:, None], 0.0, kick2)
        v = v + kick2

        # ---- thermostat half 2 (MTTK) + Langevin O-step ----
        for i, m in enumerate(methods):
            if m.kind not in ("mttk", "langevin"):
                continue
            mask = group_mask(state.typeid, l_typeid, m.group, ghost)
            slot = group_slot(m.group)
            if m.kind == "mttk":
                st = MTTKState(xi[..., slot], eta[..., slot])
                alpha = mttk_rescale_factor(st, dt)
                v = torch.where(mask[:, None], alpha[..., None, None] * v, v)
                cur_T = 2.0 * kinetic_energy(v, state.mass, mask) / m.dof
                st = mttk_advance(st, cur_T, m.kT, m.dof, dt, m.tau)
                xi = _set_at(xi, slot, st.xi, add=False)
                eta = _set_at(eta, slot, st.eta, add=False)
            elif m.kind == "langevin":
                idx = _indices(i, m, dev)
                shape = state.batch_shape + (
                    (len(m.indices), 3) if idx is not None else v.shape[-2:])
                draw = noise.langevin(state, i, m, shape)
                v, dres = langevin_ou_apply(v, state.mass, mask, m.gamma,
                                            m.kT, dt, draw, indices=idx)
                langevin_res = _set_at(langevin_res, slot, dres, add=True)

        # ---- bookkeeping + observables ----
        mol_mask = group_mask(state.typeid, l_typeid, "molecular", ghost)
        ke_mol = kinetic_energy(v, state.mass, mol_mask)
        ke_cav = kinetic_energy(v, state.mass, ~mol_mask)
        return _finish(state, pos, image, v, forces, energies, bussi_res,
                       bussi_inst, langevin_res, ke_mol, ke_cav, clist,
                       anchor, (xi, eta))

    def rebind(ff=ff, noise=noise_given):
        """This step for another force field (a row-split one,
        ``parallel/shard.py``) or another noise source."""
        return make_step_fn(ff, methods, extra_obs=extra_obs,
                            fuse_integrator=fuse_integrator, noise=noise)

    step.force_field = ff
    step.noise = noise
    step.rebind = rebind
    return step


class ObsBuffer:
    """The observables of ``n_steps`` steps in one preallocated
    ``(n_steps, n_cols)`` device buffer: each step's dict is concatenated
    into its row (no host sync); ``to_numpy`` copies the buffer to the
    host once and splits it into NumPy columns."""

    def __init__(self, n_steps: int):
        self.n_steps = n_steps
        self.buf = self.keys = self.shapes = None
        self.row = 0

    def add(self, obs: dict):
        if self.buf is None:
            self.keys = [k for k in obs if k != "timestep"]
            self.shapes = [tuple(obs[k].shape) for k in self.keys]
            width = sum(int(np.prod(sh)) for sh in self.shapes)
            first = obs[self.keys[0]]
            self.buf = torch.empty((self.n_steps, width), dtype=first.dtype,
                                   device=first.device)
        self.buf[self.row] = torch.cat([obs[k].reshape(-1)
                                        for k in self.keys])
        self.row += 1

    def to_numpy(self) -> dict:
        """Each observable as a NumPy array of shape (n_steps,) + its
        per-step shape: (n_steps,) and (n_steps, d) for one replica,
        (n_steps, B) and (n_steps, B, d) for a replica batch."""
        host = self.buf.cpu().numpy()
        out, col = {}, 0
        for k, sh in zip(self.keys, self.shapes):
            w = int(np.prod(sh))
            out[k] = (host[:, col] if sh == ()
                      else host[:, col:col + w].reshape((-1,) + sh))
            col += w
        return out


def run_steps(step_fn, state: MDState, n_steps: int):
    """Run ``n_steps`` steps; returns (final_state, obs) where obs maps each
    observable key to a NumPy array of length ``n_steps`` (scalars) or of
    shape ``(n_steps, d)`` (the vector columns of ``extra_obs``); for a
    replica batch ``(n_steps, B)`` and ``(n_steps, B, d)``.

    Every per-step observable goes into one ``ObsBuffer`` (one
    concatenate-and-copy per step, no host sync); the buffer crosses to
    the host once, after the last step. The integer timestep column is
    rebuilt on the host from the state's host step counter, so it stays
    exact whatever the float precision.
    """
    if n_steps < 1:
        return state, {}
    buf = ObsBuffer(n_steps)
    with torch.no_grad():
        for _ in range(n_steps):
            state, obs = step_fn(state)
            buf.add(obs)
    out = buf.to_numpy()
    ts = np.arange(state.step - n_steps + 1, state.step + 1, dtype=np.int64)
    batch = state.batch_shape
    out["timestep"] = (np.broadcast_to(ts[:, None], (n_steps,) + batch).copy()
                       if batch else ts)
    return state, out


def potential_energy(energies):
    """Total PE = molecular + cavity components + every ``custom_<i>``
    energy of the custom forces (the ``cell_overflow`` flag of cell mode
    is not an energy and is left out)."""
    total = (energies["harmonic"] + energies["lj"] + energies["ewald_short"]
             + energies["ewald_long"] + energies["cavity_harmonic"]
             + energies["cavity_coupling"] + energies["cavity_dipole_self"])
    for key in energies:
        if key.startswith("custom_"):
            total = total + energies[key]
    return total


def universe_energy(obs):
    """The conserved quantity: system (KE + PE) + all reservoir energies."""
    return (potential_energy(obs)
            + obs["kinetic_molecular"] + obs["kinetic_cavity"]
            + obs["bussi_reservoir_molecular"]
            + obs["bussi_reservoir_cavity"]
            + obs["langevin_reservoir_molecular"]
            + obs["langevin_reservoir_cavity"])
