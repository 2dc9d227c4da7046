"""Simulation facade: state, forces and methods run in chunks.

Port of ``cavmd_tpu/simulation.py`` (the ``hoomd.Simulation`` analog) for
the main path: create from a snapshot, thermalize momenta, ``run``. The
device runs ``chunk_size`` steps per chunk with no host sync inside it; the
observables of the latest chunk arrive on the host as NumPy arrays in
``last_obs``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from cavmd_tpu_torch.core.snapshot import Snapshot
from cavmd_tpu_torch.integrate.forcefield import ForceField
from cavmd_tpu_torch.integrate.integrator import (
    MDState,
    MethodSpec,
    group_mask,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.integrate.rng import STREAM_THERMALIZE, make_generator
from cavmd_tpu_torch.integrate.thermostats import thermalize_velocities


class Simulation:
    """A single MD simulation on the snapshot's device."""

    def __init__(self, snapshot: Snapshot, forcefield: ForceField,
                 methods: Sequence[MethodSpec], *, dt: float, seed: int = 0,
                 chunk_size: int = 1000):
        self.snapshot = snapshot
        self.ff = forcefield
        self.methods = resolve_methods(snapshot, tuple(methods),
                                       forcefield.l_typeid)
        self.seed = seed
        self.chunk_size = chunk_size
        self.state: MDState = init_state(snapshot, forcefield, dt=dt,
                                         seed=seed)
        self._step = make_step_fn(forcefield, self.methods)
        self.last_obs = None

    def thermalize(self, kT, *, molecular_only=True, photon_kT=None,
                   seed=None):
        """Maxwell-Boltzmann momenta: the molecular group with its drift
        removed, and the photon drawn N(0, sqrt(kT/m)) separately."""
        seed = self.seed if seed is None else seed
        st = self.state
        dev = st.device
        l_typeid = self.ff.l_typeid
        kT_t = torch.as_tensor(kT, dtype=st.mass.dtype, device=dev)
        mol_mask = group_mask(st.typeid, l_typeid,
                              "molecular" if molecular_only else "all")
        v = thermalize_velocities(
            make_generator(seed, STREAM_THERMALIZE, 0, dev), st.mass,
            mol_mask, kT_t)
        if molecular_only and l_typeid >= 0:
            pk = photon_kT if photon_kT is not None else kT
            v = v + thermalize_velocities(
                make_generator(seed, STREAM_THERMALIZE, 1, dev), st.mass,
                st.typeid == l_typeid,
                torch.as_tensor(pk, dtype=st.mass.dtype, device=dev),
                remove_drift=False)
        self.state = st.replace(velocity=v)

    def run(self, *, n_steps: int) -> int:
        """Run ``n_steps`` steps in chunks of ``chunk_size``; returns the
        number of steps run."""
        done = 0
        while done < n_steps:
            chunk = min(self.chunk_size, n_steps - done)
            self.state, self.last_obs = run_steps(self._step, self.state,
                                                  chunk)
            done += chunk
        return done

    @property
    def timestep(self) -> int:
        return int(self.state.timestep)
