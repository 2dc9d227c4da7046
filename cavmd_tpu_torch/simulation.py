"""Simulation facade: state, forces, methods, trackers and writers run in
chunks.

Port of ``cavmd_tpu/simulation.py`` (the ``hoomd.Simulation`` analog) on one
device: create from a snapshot, thermalize momenta, bootstrap an adaptive
dt, ``run``. The device runs ``chunk_size`` steps per chunk with no host
sync inside it; between chunks the host hands the chunk's observables (one
NumPy dict) to every tracker and writer, and keeps them in ``last_obs``.
In cell mode a chunk whose cell list overflowed is run again from its
start with a larger bucket capacity (``_grow_cell_capacity``).
"""

from __future__ import annotations

import logging
from typing import Callable, Sequence

import numpy as np
import torch

from cavmd_tpu_torch.core.snapshot import Snapshot
from cavmd_tpu_torch.core.units import PhysicalConstants
from cavmd_tpu_torch.integrate.adaptive import (
    compute_optimal_dt,
    make_adaptive_step,
)
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
                 error_tolerance: float = 0.0,
                 adaptive_initial_fraction: float = 1e-3,
                 adaptive_time_constant_ps: float = 50.0,
                 adaptive_period: int = 1,
                 extra_obs: Callable | None = None,
                 fuse_integrator: bool | None = None,
                 chunk_size: int = 1000):
        self.snapshot = snapshot
        self.ff = forcefield
        self.methods = resolve_methods(snapshot, tuple(methods),
                                       forcefield.l_typeid)
        self.seed = seed
        self.chunk_size = chunk_size
        self.trackers: list = []
        self.writers: list = []
        self.error_tolerance = error_tolerance
        self.state: MDState = init_state(snapshot, forcefield, dt=dt,
                                         seed=seed,
                                         error_tolerance=error_tolerance)
        self._step_kwargs = dict(extra_obs=extra_obs,
                                 fuse_integrator=fuse_integrator)
        self._adaptive_kwargs = dict(
            error_tolerance=error_tolerance,
            initial_fraction=adaptive_initial_fraction,
            time_constant_ps=adaptive_time_constant_ps,
            period=adaptive_period)
        self._build_step()
        self.last_obs = None

    def _build_step(self):
        """(Re)build the step function from the current ForceField: at
        init and after the overflow retry re-plans the cell list."""
        step = make_step_fn(self.ff, self.methods, **self._step_kwargs)
        if self.error_tolerance > 0:
            step = make_adaptive_step(step, **self._adaptive_kwargs)
        self._step = step

    def _grow_cell_capacity(self) -> int:
        """Re-plan the cell list with capacity max(cap + 4, 2 cap), as the
        JAX package does; returns the new capacity."""
        cap = self.ff.cell_cfg.cap
        self.ff = self.ff.with_cell_capacity(max(cap + 4, 2 * cap))
        self._build_step()
        return self.ff.cell_cfg.cap

    def _retry_state(self, start: MDState, rng_states: dict) -> MDState:
        """The chunk's start state for a retry under the re-planned cell
        list: the random streams go back to where they stood (a stream first
        drawn in the failed chunk starts afresh), the carried list is
        rebuilt, and so are the start forces (an overflowing list may have
        dropped pairs from them)."""
        gens = start.generators
        for key in list(gens):
            if key in rng_states:
                gens[key].set_state(rng_states[key])
            else:
                del gens[key]
        clist = anchor = None
        if start.cell_list is not None:
            clist = self.ff.build_cells(start.position, start.box_L)
            anchor = start.position
        with torch.no_grad():
            forces, _ = self.ff(start.position, start.image, start.box_L,
                                start.charge, start.typeid, clist=clist)
        return start.replace(forces=forces, cell_list=clist,
                             cell_anchor=anchor)

    # ------------------------------------------------------------------ setup
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

    def set_optimal_timestep(self, tolerance: float) -> float:
        """Bootstrap dt from the current forces; returns it (one read-back)."""
        new_dt = compute_optimal_dt(self.state.forces, self.state.mass,
                                    tolerance)
        self.state = self.state.replace(dt=new_dt)
        return float(new_dt)

    # -------------------------------------------------------------------- run
    def run(self, *, n_steps: int | None = None,
            runtime_ps: float | None = None) -> int:
        """Run ``n_steps`` steps, or until the simulated time reaches
        ``runtime_ps``, in chunks of at most ``chunk_size``; returns the
        number of steps run.

        With ``runtime_ps`` the chunk length is estimated from the current
        dt (read back once per chunk, with the time), so the run stops
        within about one step of ``runtime_ps``; with adaptive dt the
        estimate is refreshed every chunk and a short follow-up chunk
        cleans up any residual.
        """
        if n_steps is None and runtime_ps is None:
            raise ValueError("give n_steps or runtime_ps")
        to_ps = PhysicalConstants.TIME_PS_CONVERSION
        done = 0
        while True:
            if n_steps is not None:
                if done >= n_steps:
                    break
                chunk = min(self.chunk_size, n_steps - done)
            else:
                remaining_ps = runtime_ps - float(self.state.time_au) * to_ps
                if remaining_ps <= 0:
                    break
                dt_ps = float(self.state.dt) * to_ps
                est = int(np.ceil(remaining_ps / max(dt_ps, 1e-30)))
                chunk = min(self.chunk_size, max(1, est))
            start = self.state
            rng_states = {k: g.get_state()
                          for k, g in start.generators.items()}
            retries = 0
            while True:
                self.state, obs = run_steps(self._step, self.state, chunk)
                if not ("cell_overflow" in obs
                        and obs["cell_overflow"].any()):
                    break
                # the chunk dropped pairs: grow the buckets and run it again
                # from its start (at most 4 times, 16x the capacity)
                retries += 1
                if retries > 4:
                    raise RuntimeError(
                        "cell-list bucket overflow persists after 4 "
                        "capacity doublings: the system's density is "
                        "collapsing or the configuration is pathological")
                cap = self._grow_cell_capacity()
                logging.getLogger(__name__).warning(
                    "cell-list overflow: re-planned with cap=%d, retrying "
                    "the chunk", cap)
                self.state = self._retry_state(start, rng_states)
            self.last_obs = obs
            for tracker in self.trackers:
                tracker.consume(obs)
            for writer in self.writers:
                writer.consume(obs, self)
            done += chunk
            if runtime_ps is not None and (
                    float(obs["time_au"][-1]) * to_ps >= runtime_ps):
                break
        return done

    # ------------------------------------------------------------------ state
    @property
    def timestep(self) -> int:
        return self.state.step

    @property
    def elapsed_ps(self) -> float:
        return (float(self.state.time_au)
                * PhysicalConstants.TIME_PS_CONVERSION)

    def get_snapshot(self) -> Snapshot:
        """The current state as a Snapshot (GSD-compatible)."""
        s = self.state
        return self.snapshot.replace(position=s.position, image=s.image,
                                     velocity=s.velocity)
