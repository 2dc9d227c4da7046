"""Group thermodynamic quantities + thermostat reservoir introspection.

Port of ``cavmd_tpu/observe/thermo.py``: ``ThermodynamicQuantities`` of a
typed group, and the Bussi / Langevin reservoir views of a Simulation.
Every property reads the state back to the host: they are for logging and
inspection between chunks, not for the step.
"""

from __future__ import annotations

import numpy as np

from cavmd_tpu_torch.core.units import PhysicalConstants


def _np(x):
    return x.detach().cpu().numpy()


class ThermodynamicQuantities:
    """Kinetic energy / temperature / DOF of a typed particle group,
    evaluated from a Simulation's current state."""

    def __init__(self, simulation, group: str):
        self.sim = simulation
        self.group = group

    def _mask(self):
        """The group's rows; ghost rows (sharding padding) are in none."""
        typeid = _np(self.sim.state.typeid)
        l_typeid = self.sim.ff.l_typeid
        ghost = self.sim.ff.ghost_typeid
        real = typeid != ghost if ghost >= 0 else np.ones_like(typeid, bool)
        if self.group == "molecular":
            return (typeid != l_typeid) & real
        if self.group == "cavity":
            return typeid == l_typeid
        return real

    @property
    def num_particles(self) -> int:
        return int(self._mask().sum())

    @property
    def translational_degrees_of_freedom(self) -> float:
        return 3.0 * self.num_particles

    @property
    def rotational_degrees_of_freedom(self) -> float:
        return 0.0  # point particles

    @property
    def kinetic_energy(self) -> float:
        mask = self._mask()
        v = _np(self.sim.state.velocity)[mask]
        m = _np(self.sim.state.mass)[mask]
        return float(0.5 * np.sum(m[:, None] * v * v))

    translational_kinetic_energy = kinetic_energy

    @property
    def rotational_kinetic_energy(self) -> float:
        return 0.0

    @property
    def kinetic_temperature(self) -> float:
        dof = self.translational_degrees_of_freedom
        if dof == 0:
            return 0.0
        return 2.0 * self.kinetic_energy / (
            dof * PhysicalConstants.KB_HARTREE_PER_K)


class BussiReservoirView:
    """The BussiReservoir thermostat's logged-property surface for one
    group slot. Point particles have no rotational DOF, so rotational
    entries are zero but present."""

    def __init__(self, simulation, group: str):
        from cavmd_tpu_torch.integrate.integrator import group_slot

        self.sim = simulation
        self.slot = group_slot(group)

    @property
    def reservoir_energy_translational(self) -> float:
        return float(self.sim.state.bussi_reservoir[self.slot])

    @property
    def reservoir_energy_rotational(self) -> float:
        return 0.0

    @property
    def total_reservoir_energy(self) -> float:
        return (self.reservoir_energy_translational
                + self.reservoir_energy_rotational)

    @property
    def instantaneous_reservoir_translational(self) -> float:
        return float(self.sim.state.bussi_instantaneous[self.slot])

    @property
    def instantaneous_reservoir_rotational(self) -> float:
        return 0.0

    @property
    def instantaneous_reservoir_total(self) -> float:
        return self.instantaneous_reservoir_translational

    def reset_reservoir_energy(self):
        s = self.sim.state
        res, inst = s.bussi_reservoir.clone(), s.bussi_instantaneous.clone()
        res[self.slot] = 0.0
        inst[self.slot] = 0.0
        self.sim.state = s.replace(bussi_reservoir=res,
                                   bussi_instantaneous=inst)


class LangevinReservoirView:
    """Langevin ``reservoir_energy`` property (HOOMD's Langevin with the
    tally enabled)."""

    def __init__(self, simulation, group: str):
        from cavmd_tpu_torch.integrate.integrator import group_slot

        self.sim = simulation
        self.slot = group_slot(group)

    @property
    def reservoir_energy(self) -> float:
        return float(self.sim.state.langevin_reservoir[self.slot])
