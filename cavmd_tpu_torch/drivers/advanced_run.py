"""Advanced cavity-MD experiment runner on PyTorch.

Port of ``cavmd_tpu/drivers/advanced_run.py`` (the rebuild of the
reference's ``examples/05_advanced_run.py``): the sequential 7-phase
workflow, the CLI flags, SLURM array-task replicas, the
``cavity_coupling_{g}`` / ``no_cavity`` directory layout and the same
output files (energy tracker, cavity mode, F(k,t) references, dipole
autocorrelation, GSD trajectory, console table); and with
``--vmap-replicas`` the replica batch (``run_vmapped_replicas``), every
replica of ``--replicas`` in one batched state on one device.

Differences from the JAX driver:

- ``--device`` is ``GPU`` (the default: the CUDA device, an error when
  there is none) or ``CPU``; ``--precision auto`` is f32 on the GPU and
  f64 on the CPU.
- ``--shard-atoms S`` (S > 1) runs on S processes started by
  ``python -m torch.distributed.run --nproc-per-node S`` (gloo with
  ``--device CPU``, NCCL with one card per rank), or in an already
  initialised process group. The force field is in cell mode whatever N,
  and the run takes the slab domain pipeline (``parallel/domain.py``)
  where its plan takes it. Where it does not (a method the slab step
  refuses, a box too narrow for S slabs), the run takes atom sharding by
  rows (``parallel/shard.py``, the JAX driver's GSPMD fallback) with the
  JAX driver's force field (dense up to N = 4096) and N ghost-padded to a
  multiple of S (and of ``--pad-atoms`` K: the scene is padded once, so
  its ghosts are one type). Every rank runs the
  simulation; rank 0 alone writes the input GSD, the trackers, the
  trajectory and the console table.
- ``--pad-atoms K`` pads N to a multiple of K with inert ghost rows and
  runs unsharded (the JAX driver's single-device comparator of a sharded
  run): the trackers count the real molecules and the GSD frames hold the
  real rows. The ghosts take no thermalisation draw, so in float64 the
  padded run follows the unpadded one.
- ``--vmap-replicas`` runs the dense force field up to N = 4096 and cell
  mode above, each kernel once a step for the whole batch. Its overflow
  retry recomputes the chunk's start forces, which the JAX driver keeps.
- ``--shard-replicas R`` (implies ``--vmap-replicas``) splits the batch
  over R processes (``run_sharded_replicas``), each writing its own
  replicas' files, in lockstep once a chunk; R ranks may share one card.
- ``--vmap-replicas --shard-atoms S`` runs the batch over slabs on S
  processes, each holding slab s of every replica (the slab pipeline with
  a replica axis, cell mode); ``--shard-replicas R --shard-atoms S`` on
  R x S processes, rank (r, s) holding slab s of the r-th slice of the
  batch, rank (r, 0) writing that slice's files; where the slab plan
  refuses the batch, it runs split by rows instead, padded as above. The
  JAX driver runs both in one process over a GSPMD mesh; here the shards
  are processes (``python -m torch.distributed.run``).
- A ``--rng-impl`` other than ``auto`` (JAX PRNG backends) exits with an
  error naming ``ROADMAP.md``; nothing else runs in its place.

Usage:
    python -m cavmd_tpu_torch.drivers.advanced_run --device CPU \\
        --n-molecules 20 --runtime 0.02 --enable-energy-tracker
    python -m cavmd_tpu_torch.drivers.advanced_run --device CPU \\
        --vmap-replicas --replicas 1-3 --n-molecules 20 --runtime 0.01
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m cavmd_tpu_torch.drivers.advanced_run --device CPU \\
        --shard-atoms 2 --n-molecules 40 --box-L 64 --runtime 0.02
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m cavmd_tpu_torch.drivers.advanced_run --device CPU \\
        --shard-replicas 2 --replicas 1-4 --n-molecules 20 --runtime 0.01
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m cavmd_tpu_torch.drivers.advanced_run --device CPU \\
        --shard-replicas 2 --shard-atoms 2 --replicas 1-4 \\
        --n-molecules 40 --box-L 64 --runtime 0.003
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch


def setup_device(device: str) -> torch.device:
    """'CPU' -> the CPU; 'GPU' -> the CUDA device, raising when there is
    none (the port never falls back to the CPU)."""
    from cavmd_tpu_torch.core.device import resolve_device

    if device.upper() == "CPU":
        return torch.device("cpu")
    if device.upper() == "GPU":
        return resolve_device(None)
    raise ValueError(f"unknown device {device!r}: CPU or GPU")


class CavityMDSimulation:
    """Setup and execution of one cavity MD experiment (parity: the
    reference ``CavityMDSimulation``, 05_advanced_run.py:145-1324)."""

    def __init__(
        self, job_dir, replica, freq, couplstr, incavity, runtime_ps=500.0,
        input_gsd="molecular-0.gsd", frame=-1, name="prod",
        error_tolerance=0.01, temperature=100.0,
        molecular_thermostat="bussi", cavity_thermostat="langevin",
        cavity_damping_factor=1.0, add_cavity_particle=True, finite_q=False,
        molecular_thermostat_tau=5.0, cavity_thermostat_tau=5.0,
        log_level="INFO", enable_fkt=True, fkt_kmag=1.0,
        fkt_num_wavevectors=50, fkt_reference_interval_ps=1.0,
        fkt_max_references=10, max_energy_output_time_ps=None,
        enable_energy_tracking=False, dt_fs=None, device="GPU",
        energy_output_period_ps=0.1, fkt_output_period_ps=1.0,
        gsd_output_period_ps=50.0, console_output_period_ps=1.0,
        truncate_gsd=False, seed=None, n_molecules=250, box_L=46.0,
        chunk_size=500, precision="auto", pppm_resolution=32,
        shard_atoms=0, pad_atoms=0,
    ):
        self.job_dir = job_dir
        self.replica = replica
        self.freq = freq
        self.couplstr = couplstr
        self.incavity = incavity
        self.runtime_ps = runtime_ps
        self.input_gsd = input_gsd
        self.frame = frame
        self.name = name
        self.error_tolerance = error_tolerance
        self.temperature = temperature
        self.molecular_thermostat = molecular_thermostat
        self.cavity_thermostat = cavity_thermostat
        self.cavity_damping_factor = cavity_damping_factor
        self.add_cavity_particle = add_cavity_particle
        self.finite_q = finite_q
        self.molecular_thermostat_tau = molecular_thermostat_tau
        self.cavity_thermostat_tau = cavity_thermostat_tau
        self.log_level = log_level
        self.enable_fkt = enable_fkt
        self.fkt_kmag = fkt_kmag
        self.fkt_num_wavevectors = fkt_num_wavevectors
        self.fkt_reference_interval_ps = fkt_reference_interval_ps
        self.fkt_max_references = fkt_max_references
        self.max_energy_output_time_ps = max_energy_output_time_ps
        self.enable_energy_tracking = enable_energy_tracking
        self.dt_fs = dt_fs
        self.device = device
        self.energy_output_period_ps = energy_output_period_ps
        self.fkt_output_period_ps = fkt_output_period_ps
        self.gsd_output_period_ps = gsd_output_period_ps
        self.console_output_period_ps = console_output_period_ps
        self.truncate_gsd = truncate_gsd
        self.seed = seed if seed is not None else np.random.randint(10**4)
        self.n_molecules = n_molecules
        self.box_L = box_L
        self.chunk_size = chunk_size
        self.precision = precision
        self.pppm_resolution = pppm_resolution
        self.shard_atoms = shard_atoms
        self.pad_atoms = pad_atoms
        self.comm = None
        if shard_atoms > 1:
            from cavmd_tpu_torch.parallel import Communicator

            self.comm = Communicator.from_process_group()
        self.writes = self.comm is None or self.comm.rank == 0
        self.logger = None
        self.sim = None

    # ------------------------------------------------------------- logging
    def setup_logging(self):
        logger_name = f"CavityMD_{self.name}_{self.replica}"
        self.logger = logging.getLogger(logger_name)
        # ranks other than 0 report errors only
        self.logger.setLevel(getattr(logging, self.log_level.upper())
                             if self.writes else logging.ERROR)
        self.logger.handlers.clear()
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(
            logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                              datefmt="%Y-%m-%d %H:%M:%S")
        )
        self.logger.addHandler(h)
        self.log_info("=" * 60)
        self.log_info("CAVITY MD SIMULATION STARTED (cavmd_tpu_torch)")
        self.log_info("=" * 60)
        self.log_info(f"Simulation: {self.name}-{self.replica}")
        self.log_info(f"Device: {self.device}")
        self.log_info(f"Runtime: {self.runtime_ps} ps")
        self.log_info(f"Temperature: {self.temperature} K")
        self.log_info(
            f"Cavity coupling: {'Enabled' if self.incavity else 'Disabled'}"
        )
        if self.incavity:
            self.log_info(f"  Frequency: {self.freq} cm^-1")
            self.log_info(f"  Coupling strength: {self.couplstr}")
            self.log_info(f"  Finite-q mode: {self.finite_q}")

    def log_info(self, msg):
        (self.logger.info if self.logger else print)(msg)

    def log_error(self, msg):
        (self.logger.error if self.logger else print)(msg)

    # ---------------------------------------------------------------- phases
    def run(self):
        """Orchestrate the full 7-phase workflow; returns 0 on success and
        1 on any exception."""
        try:
            self.setup_logging()
            self.log_info("=== Phase 1: Setting up simulation ===")
            self._setup_state()
            self.log_info("=== Phase 2: Configuring forces and thermostats ===")
            self._setup_forces_and_methods()
            self.log_info("=== Phase 3: Integrator + thermalization ===")
            self._setup_simulation()
            self.log_info("=== Phase 3.5: Computing optimal timestep ===")
            self._set_timestep()
            if self.writes:
                self.log_info("=== Phase 4: Trackers and loggers ===")
                self._setup_trackers()
                self.log_info("=== Phase 5: Output writers ===")
                self._setup_writers()
            self.log_info("=== Phase 6: Running simulation ===")
            t0 = time.time()
            steps = self.sim.run(runtime_ps=self.runtime_ps)
            if self.torch_device.type == "cuda":
                torch.cuda.synchronize(self.torch_device)
            wall = time.time() - t0
            self.log_info(
                f"Completed {steps} steps, {self.sim.elapsed_ps:.6f} ps in "
                f"{wall:.3f} s ({steps / max(wall, 1e-9):.1f} steps/s)"
            )
            self.log_info("=== Phase 7: Cleanup ===")
            self._cleanup()
            self.log_info("=== SIMULATION COMPLETED SUCCESSFULLY ===")
            return 0
        except Exception as e:  # noqa: BLE001 — parity with reference
            self.log_error(f"CRITICAL ERROR in simulation: {e}")
            import traceback

            for line in traceback.format_exc().split("\n"):
                if line.strip():
                    self.log_error(line)
            return 1
        finally:
            # a failed replica must not strand later ones in its job_dir
            if hasattr(self, "original_cwd"):
                os.chdir(self.original_cwd)

    def _setup_state(self):
        self.torch_device = setup_device(self.device)
        if self.precision == "auto":
            self.precision = ("f64" if self.torch_device.type == "cpu"
                              else "f32")
        self.dtype = (torch.float64 if self.precision == "f64"
                      else torch.float32)
        np_dtype = np.float64 if self.precision == "f64" else np.float32

        from cavmd_tpu_torch.core.snapshot import add_cavity_particle as inject
        from cavmd_tpu_torch.core.system import make_diatomic_system
        from cavmd_tpu_torch.io import open_gsd

        self.original_cwd = os.getcwd()
        os.makedirs(self.job_dir, exist_ok=True)
        os.chdir(self.job_dir)

        exists = os.path.exists(self.input_gsd)
        if self.comm is not None:  # every rank has looked before rank 0
            self.comm.barrier()    # writes a generated input
        if exists:
            with open_gsd(self.input_gsd) as t:
                frame = (self.frame if self.frame >= 0
                         else max(len(t) + self.frame, 0))
                if frame >= len(t):
                    # the replica number doubles as the frame index
                    # (reference 05_advanced_run.py:1571); clamp for short
                    # input files
                    self.log_info(
                        f"Frame {frame} beyond {len(t)}-frame input; using "
                        "last")
                    frame = len(t) - 1
                snap = t.read_frame(frame, dtype=self.dtype,
                                    device=self.torch_device)
            self.log_info(
                f"State read from {self.input_gsd} frame {frame} "
                f"(N={snap.N})")
        else:
            self.log_info(
                f"Input GSD {self.input_gsd} not found — generating "
                f"equivalent O2/N2 system ({self.n_molecules} molecules) "
                "and minimizing"
            )
            snap = make_diatomic_system(
                self.n_molecules, box_L=self.box_L, seed=self.seed,
                dtype=self.dtype, device=self.torch_device,
            )
            from cavmd_tpu_torch.integrate import ForceField
            from cavmd_tpu_torch.io import HOOMDTrajectory
            from cavmd_tpu_torch.utils import fire_minimize

            ff0 = ForceField.create(snap, enable_cavity=False)
            snap = fire_minimize(snap, ff0, n_steps=300)
            if self.comm is not None:  # rank 0's minimum on every rank
                snap = snap.replace(
                    position=self.comm.broadcast(snap.position),
                    image=self.comm.broadcast(snap.image))
            if self.writes:
                with HOOMDTrajectory(self.input_gsd, "w") as t:
                    t.append(snap, step=0, dtype=np_dtype)

        if self.incavity and self.add_cavity_particle and "L" not in snap.types:
            snap = inject(
                snap, coupling=self.couplstr, freq_cm1=self.freq,
                temperature_K=self.temperature, finite_q=self.finite_q,
                seed=self.seed + 1,
            )
            self.log_info("Cavity particle added to system")
        elif self.incavity and "L" in snap.types:
            tid = snap.typeid.cpu().numpy()
            n_cav = int(np.sum(tid == snap.types.index("L")))
            if n_cav != 1:
                raise ValueError(
                    f"Expected exactly 1 cavity particle but found {n_cav}"
                )
        # ghost-padded in phase 2, once, where the route is known
        self.snapshot = snap

    def _setup_forces_and_methods(self):
        from cavmd_tpu_torch.core.units import PhysicalConstants as PC
        from cavmd_tpu_torch.integrate import ForceField, resolve_methods
        from cavmd_tpu_torch.simulation import slab_refusal

        def create(snap, pair_mode):
            """The force field; ``pair_mode`` None: picked by N."""
            return ForceField.create(
                snap, coupling=self.couplstr, freq_cm1=self.freq,
                enable_cavity=self.incavity,
                pppm_mesh=(self.pppm_resolution,) * 3,
                **({} if pair_mode is None else {"pair_mode": pair_mode}))

        self.kT = PC.kT_from_kelvin(self.temperature)
        self.methods = []
        for m, text in bath_methods(
                self.molecular_thermostat,
                self.cavity_thermostat if self.incavity else None, self.kT,
                self.molecular_thermostat_tau, self.cavity_thermostat_tau,
                self.cavity_damping_factor):
            self.methods.append(m)
            self.log_info(text)
        # --pad-atoms K pads without sharding (the single-device comparator
        # of a sharded run). Under ranks: the slab path where its plan
        # takes the run (cell mode; it takes ghost rows), else the row
        # path on the JAX driver's force field, with N a multiple of S as
        # well. The scene is padded once, so its ghosts are one type.
        multiple, pair_mode = max(1, self.pad_atoms), None
        if self.comm is not None:
            self.ff = create(self.snapshot, "cell")
            reason, _ = slab_refusal(
                self.snapshot, self.ff, resolve_methods(
                    self.snapshot, tuple(self.methods), self.ff.l_typeid),
                self.shard_atoms)
            if reason is None:
                pair_mode = "cell"
            else:
                self.log_info(f"Slab path refused ({reason}): atom "
                              f"sharding by rows over {self.shard_atoms} "
                              "ranks")
                multiple = math.lcm(multiple, self.shard_atoms)
        if self.snapshot.N % multiple:
            from cavmd_tpu_torch.parallel import pad_snapshot_to

            self.snapshot, pad = pad_snapshot_to(self.snapshot, multiple)
            self.log_info(f"Padded {pad} ghost particles (N="
                          f"{self.snapshot.N}) for {multiple}-way atom "
                          "sharding")
        self.ff = create(self.snapshot, pair_mode)

    def _setup_simulation(self):
        from cavmd_tpu_torch.core.units import PhysicalConstants as PC
        from cavmd_tpu_torch.observe import (
            generate_fibonacci_sphere,
            make_extra_obs,
        )
        from cavmd_tpu_torch.simulation import Simulation

        extra = None
        if self.enable_fkt:
            wv = (generate_fibonacci_sphere(self.fkt_num_wavevectors)
                  * self.fkt_kmag)
            extra = make_extra_obs(dipole=True, wavevectors=wv)

        dt0 = PC.fs_to_atomic_units(self.dt_fs if self.dt_fs else 0.1)
        # adaptive updates fire on the energy period (the reference
        # attaches its updater with trigger Periodic(energy_period),
        # 05_advanced_run.py:851-855), not every step
        adaptive_period = max(1, int(self.energy_output_period_ps / 0.0001))
        self.sim = Simulation(
            self.snapshot, self.ff, self.methods,
            dt=dt0, seed=self.seed,
            error_tolerance=self.error_tolerance,
            adaptive_period=min(adaptive_period, self.chunk_size),
            chunk_size=self.chunk_size,
            extra_obs=extra,
            shard_atoms=self.shard_atoms,
            comm=self.comm,
        )
        if self.sim._domain_plan is not None and self.comm is not None:
            self.log_info(f"Slab domain pipeline: {self.shard_atoms} ranks, "
                          f"grid {self.sim._domain_plan.ncells}")
        self.sim.thermalize(self.kT)
        self.log_info("Thermalized molecular momenta (+ photon velocity)")

    def _set_timestep(self):
        from cavmd_tpu_torch.core.units import PhysicalConstants as PC

        if self.error_tolerance <= 0:
            if self.dt_fs is not None:
                self.log_info(f"Fixed timestep: {self.dt_fs} fs")
            return
        dt = self.sim.set_optimal_timestep(self.error_tolerance * 1e-3)
        self.log_info(
            f"Optimal initial dt = {dt:.6f} a.u. "
            f"({PC.atomic_units_to_ps(dt) * 1000:.4f} fs)"
        )

    def _setup_trackers(self):
        from cavmd_tpu_torch.observe import (
            CavityModeTracker,
            DipoleAutocorrelation,
            ElapsedTimeTracker,
            EnergyTracker,
            FieldAutocorrelationTracker,
            PerformanceTracker,
            TimestepFormatter,
        )

        prefix = f"{self.name}-{self.replica}"
        self.time_tracker = ElapsedTimeTracker(self.runtime_ps)
        self.perf_tracker = PerformanceTracker(self.runtime_ps)
        self.dt_formatter = TimestepFormatter()
        self.sim.trackers += [self.time_tracker, self.perf_tracker,
                              self.dt_formatter]

        # step-period throttles from the nominal dt (parity:
        # calculate_physical_parameters, 05_advanced_run.py:339-386)
        dt_ps_nominal = 0.0001 if self.error_tolerance > 0 else (
            (self.dt_fs or 1.0) / 1000.0
        )
        energy_period = max(1, int(self.energy_output_period_ps
                                   / dt_ps_nominal))
        fkt_period = max(1, int(self.fkt_output_period_ps / dt_ps_nominal))

        if self.enable_energy_tracking:
            n_dof = molecular_dof(self.snapshot, self.ff)
            self.sim.trackers.append(EnergyTracker(
                output_prefix=prefix,
                output_period_steps=energy_period,
                max_time_ps=self.max_energy_output_time_ps,
                n_molecular_dof=n_dof,
            ))
            if self.incavity:
                self.sim.trackers.append(CavityModeTracker(
                    output_prefix=prefix, output_period_steps=energy_period,
                ))
            self.log_info("Energy tracking enabled")
        if self.enable_fkt:
            self.sim.trackers.append(FieldAutocorrelationTracker(
                output_prefix=prefix,
                output_period_steps=fkt_period,
                reference_interval_ps=self.fkt_reference_interval_ps,
                max_references=self.fkt_max_references,
            ))
            self.sim.trackers.append(
                DipoleAutocorrelation(output_period_steps=fkt_period)
            )
            self.log_info(
                f"F(k,t) enabled: k={self.fkt_kmag}, "
                f"{self.fkt_num_wavevectors} wavevectors"
            )

    def _setup_writers(self):
        from cavmd_tpu_torch.io import GSDWriter, TableWriter

        prefix = f"{self.name}-{self.replica}"
        self.gsd_writer = GSDWriter(
            f"{prefix}.gsd", output_period_ps=self.gsd_output_period_ps,
            truncate=self.truncate_gsd,
        )
        self.gsd_writer.write_now(self.sim)  # initial frame
        self.sim.writers.append(self.gsd_writer)
        self.sim.writers.append(
            TableWriter(self.perf_tracker,
                        output_period_ps=self.console_output_period_ps)
        )
        self.log_info(f"GSD writer: {prefix}.gsd "
                      f"(every {self.gsd_output_period_ps} ps)")

    def _cleanup(self):
        if hasattr(self, "gsd_writer"):
            self.gsd_writer.close()


def molecular_dof(snap, ff) -> int:
    """3 x the real molecular rows: neither the photon nor ghost rows."""
    from cavmd_tpu_torch.integrate.integrator import group_mask

    return 3 * int(group_mask(snap.typeid, ff.l_typeid, "molecular",
                              ff.ghost_typeid).sum())


def bath_methods(molecular, cavity, kT, molecular_tau_ps, cavity_tau_ps,
                 cavity_damping=1.0):
    """[(MethodSpec, what it is)] of the two baths: ``molecular`` (bussi,
    langevin, brownian or none) on the molecules and ``cavity`` (the same
    choices, None without a cavity) on the photon, with their time
    constants in ps; the cavity's friction scaled by ``cavity_damping``."""
    from cavmd_tpu_torch.core.units import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import MethodSpec

    out = []
    mt = molecular.lower()
    mol_gamma = PC.gamma_from_tau_ps(molecular_tau_ps)
    if mt == "bussi":
        out.append((MethodSpec(kind="bussi", group="molecular", kT=kT,
                               tau=PC.ps_to_atomic_units(molecular_tau_ps)),
                    "Molecular bath: Bussi (NVT)"))
    elif mt == "langevin":
        out.append((MethodSpec(kind="langevin", group="molecular", kT=kT,
                               gamma=mol_gamma),
                    "Molecular bath: Langevin (NVT)"))
    elif mt == "brownian":
        out.append((MethodSpec(kind="brownian", group="molecular", kT=kT,
                               gamma=mol_gamma),
                    "Molecular bath: Brownian (overdamped)"))
    elif mt == "none":
        out.append((MethodSpec(kind="nve", group="molecular"),
                    "Molecular bath: none (NVE)"))
    else:
        raise ValueError(f"Invalid molecular_thermostat: {mt}")
    if cavity is None:
        return out
    ct = cavity.lower()
    gamma = cavity_damping * PC.gamma_from_tau_ps(cavity_tau_ps)
    if ct == "langevin":
        out.append((MethodSpec(kind="langevin", group="cavity", kT=kT,
                               gamma=gamma), "Cavity bath: Langevin"))
    elif ct == "bussi":
        out.append((MethodSpec(kind="bussi", group="cavity", kT=kT,
                               tau=PC.ps_to_atomic_units(cavity_tau_ps)),
                    "Cavity bath: Bussi"))
    elif ct == "brownian":
        out.append((MethodSpec(kind="brownian", group="cavity", kT=kT,
                               gamma=gamma),
                    "Cavity bath: Brownian (overdamped)"))
    elif ct == "none":
        out.append((MethodSpec(kind="nve", group="cavity"),
                    "Cavity bath: none (NVE)"))
    else:
        raise ValueError(f"Invalid cavity_thermostat: {ct}")
    return out


# ---------------------------------------------------------------- replicas
def get_slurm_info():
    """SLURM array-task detection (parity: 05_advanced_run.py:1326-1334)."""
    task_id = os.environ.get("SLURM_ARRAY_TASK_ID")
    job_id = os.environ.get("SLURM_JOB_ID", "unknown")
    return (int(task_id) if task_id is not None else None), job_id


def parse_replicas(replicas_str):
    """Parse '1-5' / '1,3,5' specs (parity: 05_advanced_run.py:1336-1351)."""
    if not replicas_str:
        return [1]
    replicas = []
    for part in replicas_str.split(","):
        part = part.strip()
        if "-" in part:
            start, end = part.split("-", 1)
            replicas.extend(range(int(start), int(end) + 1))
        else:
            replicas.append(int(part))
    return sorted(set(replicas))


def resolved_box(args) -> float:
    """--box-L, or the reference box scaled at constant density
    (core/system.py:reference_box_for)."""
    if getattr(args, "box_L", None):
        return float(args.box_L)
    from cavmd_tpu_torch.core.system import reference_box_for

    return reference_box_for(args.n_molecules)


def run_single_experiment(args, replica, frame):
    """One experiment in its coupling-named directory
    (parity: 05_advanced_run.py:1353-1439)."""
    incavity = not args.no_cavity
    exp_dir = coupling_dir(args)
    exp_dir.mkdir(exist_ok=True)

    error_tolerance = 0.0 if args.fixed_timestep else 1.0
    sim = CavityMDSimulation(
        job_dir=str(exp_dir),
        replica=replica,
        freq=args.frequency,
        couplstr=args.coupling,
        incavity=incavity,
        runtime_ps=args.runtime,
        input_gsd=args.input_gsd,
        frame=frame,
        name="prod",
        error_tolerance=error_tolerance,
        temperature=args.temperature,
        molecular_thermostat=args.molecular_bath,
        cavity_thermostat=args.cavity_bath if incavity else "none",
        finite_q=args.finite_q,
        molecular_thermostat_tau=args.molecular_tau,
        cavity_thermostat_tau=args.cavity_tau,
        enable_fkt=args.enable_fkt,
        fkt_kmag=args.fkt_kmag,
        fkt_num_wavevectors=args.fkt_wavevectors,
        fkt_reference_interval_ps=args.fkt_ref_interval,
        fkt_max_references=args.fkt_max_refs,
        max_energy_output_time_ps=args.max_energy_output_time,
        enable_energy_tracking=args.enable_energy_tracker,
        dt_fs=args.timestep if args.fixed_timestep else None,
        device=args.device,
        energy_output_period_ps=args.energy_output_period_ps,
        fkt_output_period_ps=args.fkt_output_period_ps,
        gsd_output_period_ps=args.gsd_output_period_ps,
        console_output_period_ps=args.console_output_period_ps,
        truncate_gsd=args.truncate_gsd,
        seed=args.seed + replica if args.seed is not None else None,
        n_molecules=args.n_molecules,
        box_L=resolved_box(args),
        precision=args.precision,
        pppm_resolution=args.pppm_resolution,
        shard_atoms=args.shard_atoms if args.shard_atoms > 1 else 0,
        pad_atoms=args.pad_atoms,
    )
    return sim.run() == 0


def coupling_dir(args) -> Path:
    """The experiment directory: ``cavity_coupling_{g}`` or ``no_cavity``."""
    if args.no_cavity:
        return Path("no_cavity")
    coupling_str = (f"{args.coupling:.0e}".replace("-", "neg")
                    .replace("+", "pos"))
    return Path(f"cavity_coupling_{coupling_str}")


def run_vmapped_replicas(args, replica_list, comm=None,
                         slab_comm=None) -> bool:
    """Every replica of ``replica_list`` in one batched state on one device
    (port of the JAX driver's ``run_vmapped_replicas``; the batched form
    of the reference's SLURM-array replicas). Its per-replica workflow is
    the sequential path's: one frame a replica from ``--input-gsd`` (the
    replica number is the frame index, clamped), else one FIRE-minimised
    scene for all; the photon injected per replica (seed + replica + 1);
    each replica's optimal dt from its own initial forces; per replica the
    energy, cavity-mode, F(k,t) and dipole trackers (``prod-{r}_...``) and
    a GSD trajectory with its ``log/*`` chunks; a replica that reaches
    ``--runtime`` writes its last frame, drops its rows past the crossing
    and goes quiet while the batch runs the slower clocks; chunks are
    trimmed to the slowest unfinished clock and to the next GSD frame.
    Every step runs each kernel once for the whole batch, in dense mode
    (N <= 4096) or, above, in cell mode with a carried list a replica. A
    chunk in which any replica's cell list overflowed is run again from
    its start (at most 4 times), as the JAX driver does: the force field
    re-planned with capacity max(cap + 4, 2 cap) (zcol: rounded up to 128,
    the window 2 blocks wider), the step rebuilt, the random streams set
    back, and the start state's lists and forces rebuilt from its
    positions (the JAX driver keeps the overflowed start forces; ROADMAP.md
    Queue 3).

    ``comm``: the replica communicator of ``--shard-replicas`` R (R
    ranks, gloo). Rank k then holds replicas ``[k B/R, (k+1) B/R)`` of the
    batch of B: thermalized as the one-rank batch's rows
    (``init_replica_states(first_replica=k B/R)``), stepped with those
    rows of the batch's noise (``StreamNoise(B, rows)``), with only their
    files written here; on the GPU a rank takes card (world rank) %
    device_count. Rank 0 alone minimises the generated scene (FIRE) and
    broadcasts it once every rank has reported its setup sound. Once a
    chunk the ranks gather every replica's clock, dt and last frame time
    (and whether each rank is still sound), so every rank trims the
    chunk as the one-rank batch does and they loop in lockstep until the
    whole batch is done; an overflow retry stays on its rank (it is
    exact).

    ``slab_comm``: the slab communicator of ``--shard-atoms`` S (a batch
    over slabs). The force field is then in cell mode and the batch runs
    on the slab pipeline (``parallel/domain.py:make_domain_runner``): each
    of the S ranks holds slab s of this rank's replicas and every kernel
    runs once a step for them. The S ranks of a replica row compute alike
    and slab 0 alone writes the files. The start forces are made
    replicated over the slabs, and an overflow retry re-plans as
    ``Simulation`` does on the slab path (a capacity overflow grows the
    plan, a coverage violation halves the rebuild cadence) on every slab
    rank alike.

    Returns True when the batch ran to its end on every rank; a failure
    on any rank, in its setup or later, is reported with its traceback
    and ends the run on every rank at the next of these gathers (the
    ranks always meet in the same collectives)."""
    from cavmd_tpu_torch.core.snapshot import add_cavity_particle as inject
    from cavmd_tpu_torch.core.snapshot import real_rows
    from cavmd_tpu_torch.core.system import make_diatomic_system
    from cavmd_tpu_torch.core.units import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import (
        ForceField,
        StreamNoise,
        make_step_fn,
        resolve_methods,
    )
    from cavmd_tpu_torch.integrate.adaptive import (
        compute_optimal_dt,
        make_adaptive_step,
    )
    from cavmd_tpu_torch.io import HOOMDTrajectory, open_gsd
    from cavmd_tpu_torch.io.gsd import gather_tracker_log
    from cavmd_tpu_torch.observe import (
        CavityModeTracker,
        DipoleAutocorrelation,
        EnergyTracker,
        FieldAutocorrelationTracker,
        generate_fibonacci_sphere,
        make_extra_obs,
    )
    from cavmd_tpu_torch.parallel import pad_snapshot_to
    from cavmd_tpu_torch.parallel.domain import make_domain_runner
    from cavmd_tpu_torch.parallel.replicas import (
        init_replica_states,
        run_replica_steps,
        split_replica_obs,
    )
    from cavmd_tpu_torch.simulation import (
        DOMAIN_REBUILD_EVERY,
        retry_state,
        slab_refusal,
    )
    from cavmd_tpu_torch.utils import fire_minimize

    n_all = len(replica_list)
    R, rank = (comm.world_size, comm.rank) if comm is not None else (1, 0)
    slabs = slab_comm is not None
    writes = not slabs or slab_comm.rank == 0
    n_rep = n_all // R
    first = rank * n_rep
    mine = replica_list[first:first + n_rep]
    noise = (StreamNoise(n_all, slice(first, first + n_rep))
             if comm is not None else None)
    to_ps = PC.TIME_PS_CONVERSION
    cwd = os.getcwd()
    gsd_files = []
    ok = True
    from_input = True
    try:
        dev = setup_device(args.device)
        if (comm is not None or slabs) and dev.type == "cuda":
            import torch.distributed as dist

            dev = torch.device("cuda",
                               dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        precision = args.precision
        if precision == "auto":
            precision = "f64" if dev.type == "cpu" else "f32"
        dtype = torch.float64 if precision == "f64" else torch.float32
        incavity = not args.no_cavity
        exp_dir = coupling_dir(args)
        exp_dir.mkdir(exist_ok=True)
        os.chdir(exp_dir)
        # per-replica initial frames: the replica number is the frame index
        # (reference 05_advanced_run.py:1571), clamped for short files
        from_input = os.path.exists(args.input_gsd)
        if from_input:
            with open_gsd(args.input_gsd) as t:
                nf = len(t)
                snaps = [t.read_frame(r if 0 <= r < nf else nf - 1,
                                      dtype=dtype, device=dev)
                         for r in mine]
            print(f"Replica frames seeded from {args.input_gsd} "
                  f"({nf} frames, N={snaps[0].N})")
        else:
            snap0 = make_diatomic_system(
                args.n_molecules, box_L=resolved_box(args), seed=args.seed,
                dtype=dtype, device=dev)
            if rank == 0 and writes:  # the others take rank 0's minimum
                ff0 = ForceField.create(snap0, enable_cavity=False)
                snap0 = fire_minimize(snap0, ff0, n_steps=300)
            snaps = [snap0] * n_rep
    except Exception:  # noqa: BLE001 — reported, and every rank stops
        ok = _report_failure(rank)
    # every rank sound before the scene's broadcast: a rank that failed
    # above must not leave the others waiting in a collective
    ok = bool(_gather_rows([float(ok)], comm, slab_comm)[:, 0].all())
    if ok and not from_input:  # rank 0's minimum on every rank: over the
        # replica axis from rank (0, s), then over the slabs from (r, 0)
        for k in ("position", "image"):
            t = getattr(snaps[0], k)
            if comm is not None:
                t = comm.broadcast(t.cpu()).to(dev)
            if slabs:
                t = slab_comm.broadcast(t)
            snaps = [snaps[0].replace(**{k: t})] * n_rep
    if ok:
        try:
            if incavity:
                snaps = [
                    inject(s, coupling=args.coupling,
                           freq_cm1=args.frequency,
                           temperature_K=args.temperature,
                           finite_q=args.finite_q, seed=args.seed + r + 1)
                    if "L" not in s.types else s
                    for r, s in zip(mine, snaps)]
            # --pad-atoms pads without sharding (the single-device
            # comparator of a sharded run); the row path pads the unpadded
            # scene again, once, to a multiple of S as well
            base = snaps
            snaps = [pad_snapshot_to(s, max(1, args.pad_atoms))[0]
                     for s in base]
            snap = snaps[0]

            def create(snap, pair_mode):
                """The force field; ``pair_mode`` None: picked by N."""
                return ForceField.create(
                    snap, coupling=args.coupling, freq_cm1=args.frequency,
                    enable_cavity=incavity,
                    pppm_mesh=(args.pppm_resolution,) * 3,
                    **({} if pair_mode is None else {"pair_mode": pair_mode}))

            kT = PC.kT_from_kelvin(args.temperature)
            specs = tuple(m for m, _ in bath_methods(
                args.molecular_bath, args.cavity_bath if incavity else None,
                kT, args.molecular_tau, args.cavity_tau))
            # the slab path needs cell lists; the batch alone (and the row
            # path, where the slab plan refuses the batch: ghost-padded to
            # a multiple of S) picks its mode by N
            ff = create(snap, "cell" if slabs else None)
            methods = resolve_methods(snap, specs, ff.l_typeid)
            plan = None
            if slabs:
                refusal, plan = slab_refusal(snap, ff, methods,
                                             slab_comm.world_size)
                if refusal is not None:
                    print(f"Slab path refused ({refusal}): the batch split "
                          f"by rows over {slab_comm.world_size} ranks")
                    multiple = math.lcm(max(1, args.pad_atoms),
                                        slab_comm.world_size)
                    snaps = [pad_snapshot_to(s, multiple)[0] for s in base]
                    snap = snaps[0]
                    ff = create(snap, None).bind_rows(slab_comm)
                    methods = resolve_methods(snap, specs, ff.l_typeid)
            on_slabs = plan is not None

            extra = None
            if args.enable_fkt:
                wv = (generate_fibonacci_sphere(args.fkt_wavevectors)
                      * args.fkt_kmag)
                extra = make_extra_obs(dipole=True, wavevectors=wv)

            # adaptive dt inside the batch (each replica carries its own dt
            # and tolerance ramp), as in the sequential path
            error_tolerance = 0.0 if args.fixed_timestep else 1.0
            dt_ps_nominal = (0.0001 if error_tolerance > 0
                             else args.timestep / 1000.0)
            chunk = 500
            adaptive_period = min(max(1, int(args.energy_output_period_ps
                                             / dt_ps_nominal)), chunk)
            cadence = DOMAIN_REBUILD_EVERY

            def build_runner():
                """The chunk runner ``(state, n) -> (state, obs)`` of the
                current force field (or slab plan and cadence)."""
                if on_slabs:
                    return make_domain_runner(
                        ff, methods, plan, slab_comm, rebuild_every=cadence,
                        adaptive=(dict(error_tolerance=error_tolerance,
                                       period=adaptive_period)
                                  if error_tolerance > 0 else None),
                        obs_spec=(None if extra is None else
                                  (bool(extra.dipole), extra.wavevectors)),
                        noise=noise)
                s_ = make_step_fn(ff, methods, extra_obs=extra, noise=noise)
                if error_tolerance > 0:
                    s_ = make_adaptive_step(
                        s_, error_tolerance=error_tolerance,
                        period=adaptive_period)
                return lambda state, n: run_replica_steps(s_, state, n)

            def layout():
                """The capacities an overflow retry re-plans, as text."""
                return (f"slab bucket cap={plan.cap}, nb_cap={plan.nb_cap}, "
                        f"rebuild_every={cadence}" if on_slabs else
                        f"cap={ff.cell_cfg.cap}, zcol window {ff.zcol_W}")

            run_chunk = build_runner()

            def replicated(state):
                """The slab ranks' start state: no carried list, and slab
                0's forces (a card's atomics may round another way); on the
                row path the carried list stays."""
                if not slabs:
                    return state
                state = state.replace(
                    forces=slab_comm.broadcast(state.forces))
                if not on_slabs:
                    return state
                return state.replace(cell_list=None, cell_anchor=None)

            dt = PC.fs_to_atomic_units(args.timestep if args.fixed_timestep
                                       else 0.1)
            batched = replicated(init_replica_states(
                snaps, ff, dt=dt, seed=args.seed, kT=kT,
                error_tolerance=error_tolerance, first_replica=first))
            if error_tolerance > 0:
                # per-replica optimal-dt bootstrap (reference Phase 3.5,
                # 05_advanced_run.py:756-819) from each replica's forces
                dts = compute_optimal_dt(batched.forces, batched.mass,
                                         error_tolerance * 1e-3)
                batched = batched.replace(dt=dts.to(dtype))

            n_dof = molecular_dof(snap, ff)
            n_real = real_rows(snap.typeid, ff.ghost_typeid)
            energy_period = max(1, int(args.energy_output_period_ps
                                       / dt_ps_nominal))
            fkt_period = max(1, int(args.fkt_output_period_ps / dt_ps_nominal))
            trackers = []  # per replica: its tracker list (none off slab 0)
            for r in mine:
                if not writes:
                    trackers.append([])
                    continue
                per_rep = [EnergyTracker(
                    output_prefix=f"prod-{r}",
                    output_period_steps=energy_period, n_molecular_dof=n_dof)]
                if incavity:
                    per_rep.append(CavityModeTracker(
                        output_prefix=f"prod-{r}",
                        output_period_steps=energy_period))
                if args.enable_fkt:
                    per_rep.append(FieldAutocorrelationTracker(
                        output_prefix=f"prod-{r}",
                        output_period_steps=fkt_period,
                        reference_interval_ps=args.fkt_ref_interval,
                        max_references=args.fkt_max_refs))
                    per_rep.append(DipoleAutocorrelation(
                        output_prefix=f"prod-{r}_dipole_autocorr",
                        output_period_steps=fkt_period))
                trackers.append(per_rep)

            # per-replica periodic trajectories with log/* chunks a frame; a
            # replica past --runtime writes its final frame at the crossing
            # chunk's end and goes quiet
            if writes:
                gsd_files = [HOOMDTrajectory(f"prod-{r}.gsd", "w")
                             for r in mine]
            last_gsd_ps = np.full(n_rep, -1e30)
            finished = np.zeros(n_rep, dtype=bool)

            def write_frames(state):
                pos, img, vel = (state.position.cpu(), state.image.cpu(),
                                 state.velocity.cpu())
                ts = state.timestep.cpu().numpy()
                dts = state.dt.cpu().numpy()
                el = state.time_au.cpu().numpy() * to_ps
                for k in range(n_rep):
                    if finished[k]:
                        continue
                    crossing = el[k] >= args.runtime and ts[k] > 0
                    if crossing or (el[k] - last_gsd_ps[k]
                                    >= args.gsd_output_period_ps):
                        if writes:  # without the ghost rows
                            gsd_files[k].append(
                                snaps[k].replace(
                                    position=pos[k], image=img[k],
                                    velocity=vel[k]).strip_tail(n_real),
                                step=int(ts[k]),
                                log_data=gather_tracker_log(
                                    trackers[k], el[k], dts[k]))
                        last_gsd_ps[k] = el[k]
                    if crossing:
                        finished[k] = True

            write_frames(batched)  # initial frames
        except Exception:  # noqa: BLE001 — reported, and every rank stops
            ok = _report_failure(rank)

    def batch_clocks():
        """(all sound, every replica's time_au, dt and last frame time):
        this rank's replicas, or with ``comm`` the whole batch's in
        replica order, gathered once in one float64 vector (the clocks
        come back to the state's dtype exactly)."""
        if ok:
            own = np.concatenate([[1.0], batched.time_au.cpu().numpy(),
                                  batched.dt.cpu().numpy(), last_gsd_ps])
        else:
            own = np.zeros(1 + 3 * n_rep)
        rows = _gather_rows(own, comm, slab_comm)
        if not rows[:, 0].all():
            return False, None, None, None
        cols = rows[:, 1:].reshape(-1, 3, n_rep).transpose(1, 0, 2)
        cols = cols.reshape(3, -1)
        clock_dtype = batched.time_au.cpu().numpy().dtype
        return (True, cols[0].astype(clock_dtype),
                cols[1].astype(clock_dtype), cols[2])

    t0 = time.time()
    while True:
        sound, time_au, dt_au, last_all = batch_clocks()
        if not sound:
            ok = False
            break
        elapsed = time_au * to_ps
        remaining = args.runtime - elapsed
        if (remaining <= 0).all():
            break
        try:
            # trim the chunk to the slowest unfinished clock (no replica
            # overshoots --runtime by more than ~1 step) and to the next
            # GSD frame (frames are written at chunk ends)
            dt_ps = dt_au * to_ps
            live = remaining > 0
            safe_dt = np.maximum(dt_ps[live], 1e-30)
            est = int(np.ceil((remaining[live] / safe_dt).min()))
            till_gsd = np.maximum(
                (last_all + args.gsd_output_period_ps - elapsed)[live], 0.0)
            est_gsd = int(np.ceil((till_gsd / safe_dt).min()))
            n_next = min(chunk, max(1, est), max(1, est_gsd))
            pre_chunk = batched
            rng_states = {k: g.get_state()
                          for k, g in pre_chunk.generators.items()}
            retries = 0
            while True:
                batched, obs = run_chunk(pre_chunk, n_next)
                if not ("cell_overflow" in obs
                        and obs["cell_overflow"].any()):
                    break
                # some replica's list overflowed and dropped pairs: re-plan
                # the whole batch and run the chunk again from its start
                retries += 1
                if retries > 4:
                    raise RuntimeError(
                        "cell-list bucket overflow in the replica batch "
                        f"persists after 4 re-plans (the last: {layout()})")
                if not on_slabs:
                    cap = ff.cell_cfg.cap
                    ff = ff.with_cell_capacity(max(cap + 4, 2 * cap))
                elif obs["domain_capacity_overflow"].any():
                    plan = plan.grow_cap()
                else:  # the coverage invariant fired
                    cadence = max(1, cadence // 2)
                logging.getLogger(__name__).warning(
                    "cell-list overflow in replica batch: re-planned with "
                    "%s, retrying chunk", layout())
                run_chunk = build_runner()
                pre_chunk = replicated(retry_state(ff, pre_chunk,
                                                   rng_states))
            for k, (per_rep, o) in enumerate(zip(
                    trackers, split_replica_obs(obs, n_rep))):
                if finished[k]:
                    continue
                # drop rows past this replica's crossing (the crossing row
                # stays, as in the sequential path's last chunk)
                tp = o["time_au"] * to_ps
                n_keep = min(len(tp),
                             int(np.searchsorted(tp, args.runtime)) + 1)
                if n_keep < len(tp):
                    o = {kk: vv[:n_keep] for kk, vv in o.items()}
                for tr in per_rep:
                    tr.consume(o)
            write_frames(batched)
        except Exception:  # noqa: BLE001 — reported at the next gather
            ok = _report_failure(rank)
    try:
        if ok:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.time() - t0
            steps = int(batched.step)
            write_frames(batched)  # final frames of replicas not yet closed
        for f in gsd_files:
            f.close()
    except Exception:  # noqa: BLE001
        ok = _report_failure(rank)
    finally:
        os.chdir(cwd)
    # one gather at the end: every rank's soundness and wall time
    end = _gather_rows([float(ok), wall if ok else 0.0], comm, slab_comm)
    if not end[:, 0].all():
        return False
    wall = float(end[:, 1].max())
    S = slab_comm.world_size if slabs else 1
    on = f" on {R * S} ranks" if R * S > 1 else ""
    print(f"vmapped {n_all} replicas x {steps} steps in {wall:.1f}s "
          f"({n_all * steps / max(wall, 1e-9):.0f} aggregate steps/s){on}")
    return True


def _gather_rows(own, comm, slab_comm) -> np.ndarray:
    """Every replica rank's float64 vector ``own`` as the rows of a NumPy
    array (one row without ``comm``). Slot 0 is the rank's health (1.0
    when sound); with ``slab_comm`` it is summed over the slab ranks of
    this replica row first and reads 1.0 only when each of them is sound
    (the other slots are alike on those ranks). Every rank calls it at
    the same points, so the ranks always meet in the same collectives."""
    own = torch.as_tensor(np.asarray(own, dtype=np.float64))
    if slab_comm is not None:
        healthy = slab_comm.sum(own[:1]) == slab_comm.world_size
        own = torch.cat([healthy.to(own.dtype), own[1:]])
    return (comm.stack(own) if comm is not None else own[None]).numpy()


def _report_failure(rank: int) -> bool:
    """Print the current exception's traceback (with the rank) to stderr;
    returns False (the rank is no longer sound)."""
    import traceback

    print(f"error on replica rank {rank}:\n{traceback.format_exc()}",
          file=sys.stderr)
    return False


def unported_flags(args) -> list:
    """The flags given whose paths the port does not have, each with its
    message."""
    out = []
    if args.rng_impl != "auto":
        out.append(f"--rng-impl {args.rng_impl}: the port draws from "
                   "torch.Generator streams only; JAX PRNG backends are "
                   'not ported to cavmd_tpu_torch (see ROADMAP.md, "Not '
                   'queued this round"); run the JAX package\'s driver, '
                   "cavmd_tpu.drivers.advanced_run, for it")
    return out


# the JAX driver runs its shards in one process over a GSPMD mesh; the
# port's shards are processes
ONE_PROCESS = ('the JAX driver\'s one-process GSPMD mesh: ROADMAP.md, "Not '
               'queued this round"')


def build_parser():
    parser = argparse.ArgumentParser(
        description="Advanced Cavity MD Experiment Runner (cavmd_tpu_torch)",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--molecular-bath", type=str, default="bussi",
                        choices=["bussi", "langevin", "brownian", "none"])
    parser.add_argument("--cavity-bath", type=str, default="langevin",
                        choices=["bussi", "langevin", "brownian", "none"])
    parser.add_argument("--finite-q", action="store_true")
    parser.add_argument("--coupling", type=float, default=1e-3)
    parser.add_argument("--temperature", type=float, default=100.0)
    parser.add_argument("--frequency", type=float, default=2000.0)
    parser.add_argument("--runtime", type=float, default=500.0)
    parser.add_argument("--no-cavity", action="store_true")
    parser.add_argument("--replicas", type=str)
    parser.add_argument("--molecular-tau", type=float, default=5.0)
    parser.add_argument("--cavity-tau", type=float, default=5.0)
    parser.add_argument("--fixed-timestep", action="store_true")
    parser.add_argument("--timestep", type=float, default=1.0,
                        help="Fixed timestep in fs")
    parser.add_argument("--enable-energy-tracker", action="store_true")
    parser.add_argument("--energy-output-period-ps", type=float, default=0.1)
    parser.add_argument("--fkt-output-period-ps", type=float, default=1.0)
    parser.add_argument("--gsd-output-period-ps", type=float, default=50.0)
    parser.add_argument("--console-output-period-ps", type=float, default=1.0)
    parser.add_argument("--enable-fkt", action="store_true")
    parser.add_argument("--fkt-kmag", type=float, default=1.0)
    parser.add_argument("--fkt-wavevectors", type=int, default=50)
    parser.add_argument("--fkt-ref-interval", type=float, default=1.0)
    parser.add_argument("--fkt-max-refs", type=int, default=10)
    parser.add_argument("--max-energy-output-time", type=float)
    parser.add_argument("--device", type=str, default="GPU",
                        choices=["CPU", "GPU"],
                        help="GPU (default) = the CUDA device, an error "
                             "when there is none; CPU = the CPU")
    parser.add_argument("--truncate-gsd", action="store_true")
    # the batch and its scale-out over ranks; --rng-impl is a flag of the
    # JAX driver whose path is not ported: kept so that a command line
    # written for it fails loudly instead of running something else
    parser.add_argument("--vmap-replicas", action="store_true",
                        help="run every replica of --replicas as one batch "
                             "on one device (dense force field up to "
                             "N = 4096, cell mode above)")
    parser.add_argument("--shard-replicas", type=int, default=0,
                        help="split the --replicas batch over this many "
                             "ranks (implies --vmap-replicas; one process "
                             "each, started by python -m "
                             "torch.distributed.run --nproc-per-node R; R "
                             "ranks may share one card)")
    parser.add_argument("--shard-atoms", type=int, default=0,
                        help="shard the atoms over this many ranks (one "
                             "process each, started by python -m "
                             "torch.distributed.run --nproc-per-node S): "
                             "the slab domain pipeline (cell mode) where "
                             "its plan takes the run, else split by rows "
                             "with N ghost-padded to a multiple of S. With "
                             "--vmap-replicas, the batch over S shards; "
                             "with --shard-replicas R, over R x S ranks")
    parser.add_argument("--rng-impl", choices=("auto", "threefry", "rbg"),
                        default="auto",
                        help="only auto (torch.Generator streams) is "
                             "ported (ROADMAP.md)")
    parser.add_argument("--pad-atoms", type=int, default=0,
                        help="ghost-pad N to a multiple without sharding "
                             "(the single-device comparator of "
                             "--shard-atoms runs)")
    parser.add_argument("--input-gsd", type=str, default="../init-0.gsd")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n-molecules", type=int, default=250,
                        help="molecules when generating a missing input GSD")
    parser.add_argument("--box-L", type=float, default=None,
                        help="cubic box edge (bohr) for the generated "
                             "system; default scales the reference box "
                             "(46.0 at 250 molecules) at constant density")
    parser.add_argument("--pppm-resolution", type=int, default=32,
                        help="PPPM mesh points per axis (reference default "
                             "32)")
    parser.add_argument("--precision", type=str, default="auto",
                        choices=["auto", "f32", "f64"],
                        help="auto = f64 on CPU, f32 on GPU")
    return parser


def init_ranks(args) -> bool:
    """With ``--shard-atoms S`` (S > 1): join the process group that
    ``torch.distributed.run`` describes in the environment (gloo for
    ``--device CPU``, NCCL with the card ``LOCAL_RANK`` for GPU), unless
    one is initialised already. Returns whether this call made it (and
    must destroy it). Raises when the world size is not S."""
    import torch.distributed as dist

    made = False
    if not dist.is_initialized():
        backend = "gloo" if args.device.upper() == "CPU" else "nccl"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        made = True
    if dist.get_world_size() != args.shard_atoms:
        raise RuntimeError(
            f"--shard-atoms {args.shard_atoms} in a process group of "
            f"{dist.get_world_size()} ranks")
    return made


def main(argv=None):
    """Parity: reference main() (05_advanced_run.py:1441-1632). Returns 0
    when every replica succeeded, 1 when one failed, 2 for a flag whose
    path is not ported or ranks that do not fit the flags (checked before
    any work)."""
    args = build_parser().parse_args(argv)
    unported = unported_flags(args)
    if unported:
        for msg in unported:
            print(f"error: {msg}", file=sys.stderr)
        return 2
    if args.shard_replicas > 1 or (args.vmap_replicas
                                   and args.shard_atoms > 1):
        return run_sharded_replicas(args)
    if args.shard_atoms <= 1:
        return run_replicas(args)
    import torch.distributed as dist

    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        print(f"error: --shard-atoms {args.shard_atoms} runs one process per "
              "shard: start it with python -m torch.distributed.run "
              f"--nproc-per-node {args.shard_atoms} (not {ONE_PROCESS})",
              file=sys.stderr)
        return 2
    made = init_ranks(args)
    try:
        if dist.get_rank() == 0:
            return run_replicas(args)
        with open(os.devnull, "w") as quiet:  # rank 0 alone reports
            with contextlib.redirect_stdout(quiet):
                return run_replicas(args)
    finally:
        if made:
            dist.destroy_process_group()


def replica_list_of(args) -> list:
    """The replicas of this run: the SLURM array task's, else
    ``--replicas``."""
    task_id, _ = get_slurm_info()
    return [task_id] if task_id is not None else parse_replicas(args.replicas)


def run_sharded_replicas(args) -> int:
    """The batch of ``--replicas`` over ranks: ``--shard-replicas R``
    cuts it into R slices, ``--shard-atoms S`` (with ``--vmap-replicas``
    or ``--shard-replicas``) each slice's atoms into S slabs, on R x S
    ranks (the JAX driver's (replica x atoms) mesh,
    ``cavmd_tpu/drivers/advanced_run.py:641-666``); every rank runs its
    part through ``run_vmapped_replicas``. The ranks come from ``python
    -m torch.distributed.run --nproc-per-node R*S``, an initialised
    process group, or ``parallel/launch.py:run_ranks``; the group made
    here is gloo, or NCCL with the card ``LOCAL_RANK`` for slabs on the
    GPU. The replica axis carries small host arrays over gloo, so R ranks
    may share one card; S slabs on the GPU need S cards (NCCL). Checked
    before any work: B divisible by R, and a world of R x S ranks (else
    2). Rank 0 alone prints; 1 when any rank failed."""
    import torch.distributed as dist

    from cavmd_tpu_torch.parallel import grid_communicators

    R = max(args.shard_replicas, 1)
    S = max(args.shard_atoms, 1)
    flags = " with ".join(
        ([f"--shard-replicas {R}"] if R > 1 else ["--vmap-replicas"])
        + ([f"--shard-atoms {S}"] if S > 1 else []))
    n_all = len(replica_list_of(args))
    if n_all % R:
        print(f"error: {n_all} replicas not divisible by --shard-replicas "
              f"{R}", file=sys.stderr)
        return 2
    if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
        what = ("process per slab and slice of the batch" if S > 1
                else "process per slice of the batch")
        gspmd = f" (not {ONE_PROCESS})" if S > 1 else ""
        print(f"error: {flags} runs one {what}: start it with python -m "
              f"torch.distributed.run --nproc-per-node {R * S}{gspmd}",
              file=sys.stderr)
        return 2
    made = not dist.is_initialized()
    if made:
        backend = ("nccl" if S > 1 and args.device.upper() == "GPU"
                   else "gloo")
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    try:
        if dist.get_world_size() != R * S:
            print(f"error: {flags} needs {R * S} ranks; the process group "
                  f"has {dist.get_world_size()}", file=sys.stderr)
            return 2
        replica_comm, slab_comm = grid_communicators(R, S)
        comms = (replica_comm if R > 1 else None,
                 slab_comm if S > 1 else None)
        if dist.get_rank() == 0:
            return run_replicas(args, *comms)
        with open(os.devnull, "w") as quiet:  # rank 0 alone reports
            with contextlib.redirect_stdout(quiet):
                return run_replicas(args, *comms)
    finally:
        if made:
            dist.destroy_process_group()


def run_replicas(args, comm=None, slab_comm=None):
    """Run every replica of ``args`` (one after another, or as one batch
    with ``--vmap-replicas``; with ``comm``, the ``--shard-replicas``
    communicator, as a batch over its ranks; with ``slab_comm``, the
    ``--shard-atoms`` communicator, as a batch over slabs); 0 when all
    succeeded, else 1."""
    print("Advanced Cavity MD Experiment Runner (cavmd_tpu_torch)")
    print("=" * 50)

    task_id, job_id = get_slurm_info()
    replica_list = replica_list_of(args)
    if task_id is not None:
        print(f"SLURM array job detected: Task {task_id} (Job {job_id})")
    else:
        print(f"Local execution: Replicas {replica_list}")
    if comm is not None:
        print(f"Sharded replicas: {comm.world_size} ranks, "
              f"{len(replica_list) // comm.world_size} replicas each")
    if slab_comm is not None:
        print(f"Replica batch over slabs: {slab_comm.world_size} slabs a "
              "replica (the slab domain pipeline where its plan takes the "
              "batch, else split by rows)")

    start = time.time()
    if args.vmap_replicas or comm is not None:
        success = run_vmapped_replicas(args, replica_list, comm, slab_comm)
        print(f"\nvmapped batch: {'SUCCESS' if success else 'FAILED'}")
        print(f"Wall time: {time.time() - start:.2f} seconds")
        return 0 if success else 1
    ok = fail = 0
    for replica in replica_list:
        frame = replica  # replica doubles as input frame (reference 1571)
        print(f"\nRunning replica {replica}...")
        if run_single_experiment(args, replica, frame):
            ok += 1
            print(f"SUCCESS: Replica {replica} completed successfully")
        else:
            fail += 1
            print(f"ERROR: Replica {replica} failed")

    print("\n" + "=" * 50)
    print(f"Total replicas: {len(replica_list)}  Successful: {ok}  "
          f"Failed: {fail}")
    print(f"Wall time: {time.time() - start:.2f} seconds")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
