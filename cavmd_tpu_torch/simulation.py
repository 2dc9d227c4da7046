"""Simulation facade: state, forces, methods, trackers and writers run in
chunks.

Port of ``cavmd_tpu/simulation.py`` (the ``hoomd.Simulation`` analog) on one
device: create from a snapshot, thermalize momenta, bootstrap an adaptive
dt, ``run``. The device runs ``chunk_size`` steps per chunk with no host
sync inside it; between chunks the host hands the chunk's observables (one
NumPy dict) to every tracker and writer, and keeps them in ``last_obs``.
In cell and zcol mode a chunk whose cell list overflowed (in zcol mode also:
whose hull outgrew the visit window) is run again from its start with a
larger bucket capacity and window (``_grow_cell_capacity``): the whole
start state comes back, reservoirs and MTTK (xi, eta) included. The methods
are those of ``make_step_fn`` (NVE, Bussi, Langevin, Brownian, MTTK,
Berendsen; MTTK and Berendsen run the unfused tail); ``state`` is the
whole ``MDState``, which ``io.save_checkpoint`` writes for an exact resume.

With ``shard_atoms=S`` the chunks run over S processes, this one being
one rank: every rank builds the same Simulation, the state is replicated
between chunks, and trackers and writers see the same observables on
every rank. The route is the JAX facade's: the slab domain pipeline
(``parallel/domain.py``) where its plan takes the run; otherwise, with a
logged warning, atom sharding by rows (``parallel/shard.py``, the
counterpart of the JAX package's GSPMD fallback: dense and zcol mode,
custom forces, an opaque ``extra_obs``, the methods the slab step
refuses, a box too narrow for S slabs), which needs N divisible by S
(``parallel.pad_snapshot_to``). ``shard_atoms=1`` runs the slab pipeline
in this process alone, with no process group, where it takes the run (the
single-device cost of the slab layout), and unsharded otherwise, as the
JAX facade treats 1.
"""

from __future__ import annotations

import logging
from typing import Callable, Sequence

import numpy as np
import torch

from cavmd_tpu_torch.core.snapshot import Snapshot, real_rows
from cavmd_tpu_torch.core.units import PhysicalConstants
from cavmd_tpu_torch.integrate.adaptive import (
    compute_optimal_dt,
    make_adaptive_step,
)
from cavmd_tpu_torch.integrate.forcefield import ForceField
from cavmd_tpu_torch.integrate.integrator import (
    MDState,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
    thermal_velocities,
)

# Default residency-rebuild cadence (steps) of the slab domain pipeline, as
# in the JAX package; a coverage violation halves it for the retry.
DOMAIN_REBUILD_EVERY = 20


def retry_state(ff: ForceField, start: MDState,
                rng_states: dict) -> MDState:
    """A chunk's start state for a retry under the re-planned force field
    ``ff`` (one replica or a replica batch): the random streams go back to
    ``rng_states`` (a stream first drawn in the failed chunk starts
    afresh), the carried list is rebuilt from the start positions, and so
    are the start forces (an overflowing list may have dropped pairs from
    them; the JAX package keeps them)."""
    gens = start.generators
    for key in list(gens):
        if key in rng_states:
            gens[key].set_state(rng_states[key])
        else:
            del gens[key]
    clist = anchor = None
    if start.cell_list is not None:
        clist = ff.build_cells(start.position, start.box_L)
        anchor = start.position
    with torch.no_grad():
        forces, _ = ff(start.position, start.image, start.box_L,
                       start.charge, start.typeid, clist=clist)
    return start.replace(forces=forces, cell_list=clist, cell_anchor=anchor)


def slab_refusal(snapshot, ff: ForceField, methods, shard_atoms: int,
                 extra_obs=None):
    """(None, the slab plan) when the slab domain pipeline takes the run
    over ``shard_atoms`` slabs, else (why not, None), in the JAX facade's
    order of checks: the pair mode, an opaque ``extra_obs``, the methods
    (resolved), then the plan (custom forces, the molecules, the
    cutoffs, the box)."""
    from cavmd_tpu_torch.parallel.domain import (
        _validate_methods,
        plan_domain,
    )

    if ff.pair_mode != "cell":
        return (f"domain decomposition needs pair_mode='cell' (got "
                f"{ff.pair_mode!r})"), None
    if extra_obs is not None and not (hasattr(extra_obs, "dipole")
                                      and hasattr(extra_obs, "wavevectors")):
        return ("extra_obs is an opaque state-based callable (build it "
                "with observe.make_extra_obs to keep the domain "
                "pipeline)"), None
    try:
        _validate_methods(methods)
        return None, plan_domain(snapshot, ff, shard_atoms)
    except ValueError as e:
        return f"domain decomposition unavailable ({e})", None


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
                 chunk_size: int = 1000, shard_atoms: int = 0, comm=None):
        self.snapshot = snapshot
        self.ff = forcefield
        self.methods = resolve_methods(snapshot, tuple(methods),
                                       forcefield.l_typeid)
        self.seed = seed
        self.chunk_size = chunk_size
        self.trackers: list = []
        self.writers: list = []
        self.error_tolerance = error_tolerance
        self._domain_plan = None
        self._domain_rebuild_every = DOMAIN_REBUILD_EVERY
        self._comm = None
        if shard_atoms >= 1:
            self._route_shards(snapshot, forcefield, shard_atoms, extra_obs,
                               comm)
        self.state: MDState = init_state(snapshot, self.ff, dt=dt,
                                         seed=seed,
                                         error_tolerance=error_tolerance)
        if self._domain_plan is not None:
            # the slab path bins each chunk itself; the start forces are
            # made replicated
            self.state = self.state.replace(
                forces=self._comm.broadcast(self.state.forces),
                cell_list=None, cell_anchor=None)
        self._step_kwargs = dict(extra_obs=extra_obs,
                                 fuse_integrator=fuse_integrator)
        self._adaptive_kwargs = dict(
            error_tolerance=error_tolerance,
            initial_fraction=adaptive_initial_fraction,
            time_constant_ps=adaptive_time_constant_ps,
            period=adaptive_period)
        self._build_step()
        self.last_obs = None

    def _route_shards(self, snapshot, ff, shard_atoms, extra_obs, comm):
        """Take the slab path where its plan takes the run; else, at S > 1,
        bind the force field to rows over the atom group (at S = 1 run
        unsharded). The communicator: ``comm``, else at one slab the local
        one and otherwise the default process group."""
        from cavmd_tpu_torch.parallel.comm import Communicator

        log = logging.getLogger(__name__)
        reason, self._domain_plan = slab_refusal(
            snapshot, ff, self.methods, shard_atoms, extra_obs)
        if reason is not None and shard_atoms == 1:
            log.warning("shard_atoms=1: %s; running unsharded", reason)
            return
        if reason is not None:
            log.warning("shard_atoms=%d: %s; falling back to atom sharding "
                        "by rows (parallel/shard.py)", shard_atoms, reason)
            if snapshot.N % shard_atoms:
                raise ValueError(
                    f"N={snapshot.N} not divisible by shard_atoms="
                    f"{shard_atoms}; pad the snapshot first "
                    "(cavmd_tpu_torch.parallel.pad_snapshot_to)")
        if comm is None:
            comm = (Communicator() if shard_atoms == 1
                    else Communicator.from_process_group())
        if comm.world_size != shard_atoms:
            raise ValueError(
                f"shard_atoms={shard_atoms} but the process group has "
                f"{comm.world_size} ranks")
        self._comm = comm
        if reason is not None:
            self.ff = ff.bind_rows(comm)

    def _build_step(self):
        """(Re)build the chunk runner from the current ForceField (or
        domain plan): at init and after the overflow retry re-plans."""
        adaptive = self.error_tolerance > 0
        if self._domain_plan is not None:
            from cavmd_tpu_torch.parallel.domain import make_domain_runner

            extra = self._step_kwargs["extra_obs"]
            self._run_chunk = make_domain_runner(
                self.ff, self.methods, self._domain_plan, self._comm,
                rebuild_every=self._domain_rebuild_every,
                adaptive=self._adaptive_kwargs if adaptive else None,
                obs_spec=(None if extra is None
                          else (bool(extra.dipole), extra.wavevectors)))
            return
        step = make_step_fn(self.ff, self.methods, **self._step_kwargs)
        if adaptive:
            step = make_adaptive_step(step, **self._adaptive_kwargs)
        self._run_chunk = lambda state, n: run_steps(step, state, n)

    def _grow_cell_capacity(self, *,
                            domain_capacity_overflow: bool = False) -> int:
        """Re-plan after an overflow, as the JAX package does, and return
        the bucket capacity now planned. Unsharded: the cell list's
        capacity becomes max(cap + 4, 2 cap), and in zcol mode the visit
        window grows by 2 blocks with it. On the slab path only the
        lever of the failure that fired moves: a capacity overflow at the
        rebuild grows the plan (``DomainPlan.grow_cap``); otherwise the
        coverage invariant fired, and the rebuild cadence halves."""
        if self._domain_plan is not None:
            if domain_capacity_overflow:
                self._domain_plan = self._domain_plan.grow_cap()
            else:
                self._domain_rebuild_every = max(
                    1, self._domain_rebuild_every // 2)
            self._build_step()
            return self._domain_plan.cap
        cap = self.ff.cell_cfg.cap
        self.ff = self.ff.with_cell_capacity(max(cap + 4, 2 * cap))
        self._build_step()
        return self.ff.cell_cfg.cap

    def _plan_text(self) -> str:
        p = self._domain_plan
        if p is None:
            window = ("" if self.ff.zcol_W is None
                      else f", zcol window W={self.ff.zcol_W}")
            return f"cap={self.ff.cell_cfg.cap}{window}"
        return (f"slab cap nb_cap={p.nb_cap}, bucket cap={p.cap}, "
                f"rebuild_every={self._domain_rebuild_every}")

    # ------------------------------------------------------------------ setup
    def thermalize(self, kT, *, molecular_only=True, photon_kT=None,
                   seed=None):
        """Maxwell-Boltzmann momenta: the molecular group with its drift
        removed, and the photon drawn N(0, sqrt(kT/m)) separately."""
        seed = self.seed if seed is None else seed
        st = self.state
        self.state = st.replace(velocity=thermal_velocities(
            st.mass, st.typeid, self.ff.l_typeid, kT, seed,
            molecular_only=molecular_only, photon_kT=photon_kT,
            ghost_typeid=self.ff.ghost_typeid))

    def set_optimal_timestep(self, tolerance: float) -> float:
        """Bootstrap dt from the current forces; returns it (one read-back)."""
        new_dt = compute_optimal_dt(self.state.forces, self.state.mass,
                                    tolerance)
        self.state = self.state.replace(dt=new_dt)
        return float(new_dt)

    # -------------------------------------------------------------------- run
    def run(self, *, n_steps: int | None = None,
            runtime_ps: float | None = None,
            profile_dir: str | None = None) -> int:
        """Run ``n_steps`` steps, or until the simulated time reaches
        ``runtime_ps``, in chunks of at most ``chunk_size``; returns the
        number of steps run.

        With ``runtime_ps`` the chunk length is estimated from the current
        dt (read back once per chunk, with the time), so the run stops
        within about one step of ``runtime_ps``; with adaptive dt the
        estimate is refreshed every chunk and a short follow-up chunk
        cleans up any residual.

        ``profile_dir``: run under ``torch.profiler`` (host operations, and
        on a CUDA state the device's too) and write the trace into that
        directory (``tensorboard_trace_handler``; view it with TensorBoard
        or Perfetto). The trajectory is the same as without it. The trace
        is for viewing: a profiler may drop device records, so do not
        count launches from it.
        """
        if n_steps is None and runtime_ps is None:
            raise ValueError("give n_steps or runtime_ps")
        if profile_dir is not None:
            from torch.profiler import (
                ProfilerActivity,
                profile,
                tensorboard_trace_handler,
            )

            activities = [ProfilerActivity.CPU]
            if self.state.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities, on_trace_ready=(
                    tensorboard_trace_handler(str(profile_dir)))):
                return self.run(n_steps=n_steps, runtime_ps=runtime_ps)
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
                self.state, obs = self._run_chunk(self.state, chunk)
                if not ("cell_overflow" in obs
                        and obs["cell_overflow"].any()):
                    break
                # the chunk dropped pairs: re-plan and run it again from its
                # start (at most 4 times, 16x the capacity)
                retries += 1
                if retries > 4:
                    raise RuntimeError(
                        "cell-list bucket overflow persists after 4 "
                        "re-plans (the last: " + self._plan_text() + "): "
                        "the system's density is collapsing or the "
                        "configuration is pathological")
                cap_flag = obs.get("domain_capacity_overflow")
                self._grow_cell_capacity(domain_capacity_overflow=bool(
                    cap_flag is not None and cap_flag.any()))
                logging.getLogger(__name__).warning(
                    "cell-list overflow: re-planned (%s), retrying the "
                    "chunk", self._plan_text())
                self.state = retry_state(self.ff, start, rng_states)
                if self._domain_plan is not None:  # replicated start forces
                    self.state = self.state.replace(
                        forces=self._comm.broadcast(self.state.forces))
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

    def get_snapshot(self, *, strip_ghosts: bool = True) -> Snapshot:
        """The current state as a Snapshot (GSD-compatible). Ghost rows
        (sharding padding, a tail after every real row) are left out
        unless ``strip_ghosts`` is False, so trajectory files hold the
        physical particles only."""
        s = self.state
        snap = self.snapshot.replace(position=s.position, image=s.image,
                                     velocity=s.velocity)
        gid = self.ff.ghost_typeid
        if strip_ghosts and gid >= 0:
            snap = snap.strip_tail(real_rows(snap.typeid, gid))
        return snap
