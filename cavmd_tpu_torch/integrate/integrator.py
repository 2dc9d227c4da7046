"""The MD integrator: one step function and a chunked runner.

Port of ``cavmd_tpu/integrate/integrator.py`` (the unfused path, methods
nve / bussi / langevin). Per step, in this order:

1. Bussi half-step on its group (reservoir += KE (1 - alpha^2));
2. velocity-Verlet kick v += dt/2 a(t), drift x += dt v, re-wrap;
3. all forces (``ForceField.forward``);
4. second kick v += dt/2 a(t + dt);
5. exact-OU Langevin on its group (reservoir += KE loss);
6. the energy audit: every column of the reference EnergyTracker.

Group membership is by particle type (molecular = not 'L', cavity = 'L'),
so masks and DOF are static. ``run_steps`` runs a chunk of steps with no
host synchronisation inside it: each step writes its observables into one
preallocated ``(n_steps, n_obs)`` device buffer, which is copied to the
host once at the end of the chunk.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cavmd_tpu_torch.core.box import rewrap
from cavmd_tpu_torch.core.snapshot import Snapshot
from cavmd_tpu_torch.integrate.forcefield import ENERGY_KEYS, ForceField
from cavmd_tpu_torch.integrate.rng import (
    STREAM_BUSSI,
    STREAM_LANGEVIN,
    make_generator,
)
from cavmd_tpu_torch.integrate.thermostats import (
    bussi_apply,
    bussi_noise,
    kinetic_energy,
    langevin_ou_apply,
)

# group slots for reservoir bookkeeping (index into the (2,) accumulators)
MOLECULAR, CAVITY = 0, 1
SUPPORTED_METHODS = ("nve", "bussi", "langevin")

OBS_KEYS = ENERGY_KEYS + (
    "kinetic_molecular", "kinetic_cavity",
    "bussi_reservoir_molecular", "bussi_reservoir_cavity",
    "langevin_reservoir_molecular", "langevin_reservoir_cavity",
    "dt", "time_au", "timestep",
)


class MethodSpec(NamedTuple):
    """Static description of one integration method (HOOMD ``methods``
    entry): ``kind`` in nve | bussi | langevin, ``group`` in molecular |
    cavity | all; ``tau`` and ``gamma`` in atomic units."""

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
    seed: int = 0
    generators: dict = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)

    @property
    def device(self):
        return self.position.device

    def generator(self, stream: int, instance: int = 0) -> torch.Generator:
        """The generator of (stream, instance), created on first use from
        (seed, stream, instance) on the state's device."""
        key = (stream, instance)
        if key not in self.generators:
            self.generators[key] = make_generator(self.seed, stream,
                                                  instance, self.device)
        return self.generators[key]


def group_mask(typeid, l_typeid: int, group: str):
    if group == "molecular":
        return typeid != l_typeid
    if group == "cavity":
        return typeid == l_typeid
    if group == "all":
        return torch.ones_like(typeid, dtype=torch.bool)
    raise ValueError(f"unknown group '{group}'")


def group_slot(group: str) -> int:
    return CAVITY if group == "cavity" else MOLECULAR


def resolve_methods(snapshot: Snapshot, methods: Tuple[MethodSpec, ...],
                    l_typeid: int) -> Tuple[MethodSpec, ...]:
    """Fill in static group DOF counts (3 N_group) and, for groups of at
    most 8 particles, the member indices."""
    typeid = snapshot.typeid.cpu().numpy()
    out = []
    for m in methods:
        if m.group == "molecular":
            members = np.where(typeid != l_typeid)[0]
        elif m.group == "cavity":
            members = np.where(typeid == l_typeid)[0]
        else:
            members = np.arange(len(typeid))
        n = len(members)
        indices = tuple(int(i) for i in members) if n <= 8 else None
        out.append(m._replace(dof=3.0 * n, indices=indices))
    return tuple(out)


def init_state(snapshot: Snapshot, ff: ForceField, *, dt: float,
               seed: int = 0) -> MDState:
    """The initial MDState on the snapshot's device (computes the initial
    forces once)."""
    dtype = snapshot.position.dtype
    dev = snapshot.device
    with torch.no_grad():
        forces, _ = ff(snapshot.position, snapshot.image, snapshot.box_L,
                       snapshot.charge, snapshot.typeid)
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
        seed=seed,
    )


class StreamNoise:
    """The default noise source: draws from the state's per-stream
    generators. A replacement (for example one that hands in another
    package's draws) implements the same two methods."""

    def bussi(self, state: MDState, i: int, m: MethodSpec):
        """(r1, r_gamma) for Bussi method ``i``."""
        return bussi_noise(state.generator(STREAM_BUSSI, i), m.dof,
                           state.position.dtype, state.device)

    def langevin(self, state: MDState, i: int, m: MethodSpec, shape):
        """Standard-normal draws of ``shape`` for Langevin method ``i``."""
        return torch.randn(shape, generator=state.generator(
            STREAM_LANGEVIN, i), dtype=state.position.dtype,
            device=state.device)


def _set_at(x, slot: int, value, add: bool):
    out = x.clone()
    if add:
        out[slot] += value
    else:
        out[slot] = value
    return out


def make_step_fn(ff: ForceField, methods: Tuple[MethodSpec, ...],
                 noise=None):
    """Build ``step(state) -> (new_state, obs)``.

    ``obs`` is a dict of 0-d tensors with keys ``OBS_KEYS``. The step reads
    nothing back from the device. ``noise`` supplies the random draws
    (default :class:`StreamNoise`, which advances the state's generators in
    place; every tensor of ``state`` itself is left unmodified — the new
    state holds new tensors).
    """
    for m in methods:
        if m.kind not in SUPPORTED_METHODS:
            raise NotImplementedError(
                f"method kind {m.kind!r}: cavmd_tpu_torch ports "
                f"{SUPPORTED_METHODS}")
    noise = noise if noise is not None else StreamNoise()
    l_typeid = ff.l_typeid
    index_cache = {}

    def _indices(i, m, device):
        if m.indices is None:
            return None
        key = (i, device)
        if key not in index_cache:
            index_cache[key] = torch.as_tensor(m.indices, dtype=torch.long,
                                               device=device)
        return index_cache[key]

    def step(state: MDState):
        dev = state.device
        dt = state.dt
        v = state.velocity
        bussi_res = state.bussi_reservoir
        bussi_inst = state.bussi_instantaneous
        langevin_res = state.langevin_reservoir

        # ---- thermostat half 1 ----
        for i, m in enumerate(methods):
            if m.kind == "bussi":
                mask = group_mask(state.typeid, l_typeid, m.group)
                slot = group_slot(m.group)
                r1, r_gamma = noise.bussi(state, i, m)
                v, dres = bussi_apply(v, state.mass, mask, m.dof, dt, m.tau,
                                      m.kT, r1, r_gamma)
                bussi_res = _set_at(bussi_res, slot, dres, add=True)
                bussi_inst = _set_at(bussi_inst, slot, dres, add=False)

        # ---- velocity Verlet ----
        inv_m = 1.0 / state.mass[:, None]
        v = v + 0.5 * dt * state.forces * inv_m
        pos = state.position + dt * v
        pos, image = rewrap(pos, state.image, state.box_L)

        forces, energies = ff(pos, image, state.box_L, state.charge,
                              state.typeid)
        v = v + 0.5 * dt * forces * inv_m

        # ---- Langevin O-step ----
        for i, m in enumerate(methods):
            if m.kind == "langevin":
                mask = group_mask(state.typeid, l_typeid, m.group)
                slot = group_slot(m.group)
                idx = _indices(i, m, dev)
                shape = (len(m.indices), 3) if idx is not None else v.shape
                xi = noise.langevin(state, i, m, shape)
                v, dres = langevin_ou_apply(v, state.mass, mask, m.gamma,
                                            m.kT, dt, xi, indices=idx)
                langevin_res = _set_at(langevin_res, slot, dres, add=True)

        # ---- bookkeeping + observables ----
        mol_mask = group_mask(state.typeid, l_typeid, "molecular")
        ke_mol = kinetic_energy(v, state.mass, mol_mask)
        ke_cav = kinetic_energy(v, state.mass, ~mol_mask)

        y = dt - state.time_comp
        t_new = state.time_au + y
        comp_new = (t_new - state.time_au) - y
        new_state = state.replace(
            position=pos, image=image, velocity=v, forces=forces,
            time_au=t_new, time_comp=comp_new,
            timestep=state.timestep + 1,
            bussi_reservoir=bussi_res,
            bussi_instantaneous=bussi_inst,
            langevin_reservoir=langevin_res,
        )
        obs = dict(energies)
        obs["kinetic_molecular"] = ke_mol
        obs["kinetic_cavity"] = ke_cav
        obs["bussi_reservoir_molecular"] = bussi_res[MOLECULAR]
        obs["bussi_reservoir_cavity"] = bussi_res[CAVITY]
        obs["langevin_reservoir_molecular"] = langevin_res[MOLECULAR]
        obs["langevin_reservoir_cavity"] = langevin_res[CAVITY]
        obs["dt"] = dt
        obs["time_au"] = t_new
        obs["timestep"] = new_state.timestep
        return new_state, obs

    return step


def run_steps(step_fn, state: MDState, n_steps: int):
    """Run ``n_steps`` steps; returns (final_state, obs) where obs maps each
    key of ``OBS_KEYS`` to a NumPy array of length ``n_steps``.

    The per-step observables go into one preallocated (n_steps, n_obs)
    device buffer (one stack-and-copy per step, no host sync); the buffer
    crosses to the host once, after the last step. The integer timestep
    column is rebuilt on the host from the final state's counter, so it
    stays exact whatever the float precision.
    """
    dtype = state.position.dtype
    keys = [k for k in OBS_KEYS if k != "timestep"]
    buf = torch.empty((n_steps, len(keys)), dtype=dtype, device=state.device)
    with torch.no_grad():
        for s in range(n_steps):
            state, obs = step_fn(state)
            buf[s] = torch.stack([obs[k] for k in keys])
    host = buf.cpu().numpy()
    out = {k: host[:, c] for c, k in enumerate(keys)}
    last = int(state.timestep)
    out["timestep"] = np.arange(last - n_steps + 1, last + 1, dtype=np.int64)
    return state, out


def potential_energy(energies):
    """Total PE = molecular + cavity components."""
    return (energies["harmonic"] + energies["lj"] + energies["ewald_short"]
            + energies["ewald_long"] + energies["cavity_harmonic"]
            + energies["cavity_coupling"] + energies["cavity_dipole_self"])


def universe_energy(obs):
    """The conserved quantity: system (KE + PE) + all reservoir energies."""
    return (potential_energy(obs)
            + obs["kinetic_molecular"] + obs["kinetic_cavity"]
            + obs["bussi_reservoir_molecular"]
            + obs["bussi_reservoir_cavity"]
            + obs["langevin_reservoir_molecular"]
            + obs["langevin_reservoir_cavity"])
