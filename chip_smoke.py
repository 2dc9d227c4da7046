#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cavmd_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it builds the port's CUDA kernels
from ``cavmd_tpu_torch/csrc`` itself, and exits non-zero on any failure —
including when no CUDA device is present or the package is not next to it.

Phases:
  0. device: the card's name and power limit (nvidia-smi);
  1. build: compile every kernel source with nvcc (sm_90a), one nvcc per
     source, all started together before phase 0 (which runs while they
     compile); print the seconds from their start and, from ptxas, each
     kernel's registers, stack frame and spill bytes by name (K1, K2, K3,
     the cell kernel, K4, K5 and K9's hull and pair kernels must be found
     in float and double; K3 at order 6 and both zcol kernels with no
     stack frame and no spill);
  2. kernels against their plain PyTorch twins on the card, float32 and
     float64: at the N = 501 reference scene and at N = 4001 (reference
     density) in dense mode, the pair pass (K1), the 32^3 order-6 PPPM
     spread (K2) and interpolation (K3), and the fused integrator tail (K4
     pre-force, K5 post-force, with particles pushed across the box
     faces); at N = 100,001 in cell mode (17^3 cells) the cell kernel
     (K6's counterpart) and K2-K5; on the N = 501 scene in cell mode (2^3
     cells, K8's counterpart) the cell kernel; at N = 100,001 also K2 on
     the 64^3 and 128^3 meshes — max |diff|, K4's and K5's velocities
     bit-equal to the twins', for K1, K3, the cell kernel, K4 and K5 two
     calls on the same inputs bit-equal, K1's, K4's and K5's block counts,
     and the blocks of K2 that accumulated in their shared-memory tile;
     then K1's and K3's rows at N = 501 and 4001 side by side; in float32
     also the median device time of one call (``ms``, CUDA events with the
     host out of the way), the median host-bound time of one call
     (``host_call_ms``), the twin's times, and the bound from the call's
     bytes and operations (the cell kernel's counted cell by cell); the
     cell-list build's times beside them;
  3. ``Simulation.run`` on the reference scene (250 O2/N2 + photon, f32,
     dense ForceField, Bussi 100 K tau 5 ps on the molecules, Langevin
     tau 5 ps on the photon, dt 0.25 fs), twice: with the fused tail (the
     default on the card; one warm-up chunk, then 5 x 1000 steps) and
     without it (``fuse_integrator=False``; SHORT_RUN, a prefix of that,
     with its own drift bound): launch counts, finiteness, universe-energy
     drift, steps/s (median of the chunks);
  4. a float64 NVE trajectory of 20 steps on the card (kernels) against the
     same steps on the CPU (plain twins), N = 501 dense;
  5. the ``advanced_run`` CLI in this process (``main([...])``, default
     adaptive dt and baths, N = 501) in a temporary directory: exit code,
     output files and their header lines, the GSD read back, launches of
     K1-K5 per step, universe drift, steps/s and ns/day;
  6. the large-N main path of this slice: ``build_large_n`` through
     ``Simulation.run`` (one warm-up chunk, then 5 x 100 steps, as
     ``scripts/bench_large_n.py`` runs it) at N = 20,001 (the universe
     band held to 3x the JAX package's reading) and N = 100,001 (its band
     reported, and held to shrink as dt^2 against a second run at half
     the time step): no overflow, finite observables, the cell kernel and
     K2-K5 launched every step, ms per step; then the N = 501 scene in
     cell mode (the small grid) through ``Simulation.run`` on SHORT_RUN
     (its drift held to that prefix's bound);
  7. a float64 NVE trajectory of 20 steps in cell mode (N = 4001, 5^3
     cells) on the card against the CPU;
  8. the CLI at 10,000 molecules (N = 20,001, drift held) and at 50,000
     (N = 100,001): in float32 (the default on the card; drift reported)
     and in float64 (drift held): files, headers, the GSD frame, launches;
  9. the slab domain pipeline at one slab (``parallel/domain.py``, world
     size 1: the halo is a local copy, the sums the identity): its tile
     kernel (``cell_pair_slab``, K7's counterpart) against its plain twin
     on the first chunk's slab grid of ``build_large_n(50_000)`` (N =
     100,001, 19 x 17 x 17 extended cells), float32 and float64, with its
     times and bound as in phase 2; a float64 trajectory of 40 steps (two
     rebuilds) at N = 20,001 against the unsharded runner on the card,
     same draws; and the scene of ``build_large_n(50_000)`` through
     ``Simulation(shard_atoms=1)`` on phase 6's protocol: launches, ms per
     step beside phase 6's, and its universe band held to phase 6's band
     at N = 100,001;
 10. the z-sorted column mode (``pair_mode='zcol'``): its two kernels
     (``zcol_hull`` and ``zcol_pair``, K9's counterpart with its hull) on
     the first chunk's column list of ``build_large_n(50_000,
     pair_mode='zcol')`` (N = 100,001, 17 x 17 columns of cap 512), float32
     and float64: the hull kernel's hull and flag bit-equal to the plain
     twins' (at the build positions, at W = 1, after a drift of 0.49
     skin), the pair pass against its plain twin, two calls bit-equal; in
     float32 its times and bound as in phase 2, the pair and hull
     kernels' own times, the list build's device time, the candidates
     before and after the kernel's z-chunk pruning and the hull
     statistics;
     ``build_large_n(50_000, pair_mode='zcol')`` through ``Simulation.run``
     on phase 6's protocol (both kernels launched once a step and the cell
     kernel never, no overflow, ms per step beside phase 6's, the universe
     band held to DOMAIN_BAND_RATIO times phase 6's); and a float64
     trajectory of 40 steps at N = 20,001 in zcol mode against the cell
     mode on the card, same draws, across a rebuild of the column list.

11. replica batches (``parallel/replicas.py``) of the N = 501 scene: K1-K5
     each over REPLICA_B = 8 replicas in one launch against their plain
     twins on the batch, float32 and float64, and against the one-replica
     launch on each replica's rows (bit-equal but K2), two calls bit-equal
     (but K2), in float32 their times and bound as in phase 2 and the
     device time at 32 replicas; a float64 batch of 4 replicas, 20 steps on
     the card, against one-replica card runs with the same draws (1e-9
     bohr); the batched step through ``run_replica_steps`` at B = 1, 8 and
     32 (a prefix of phase 3's protocol, SHORT_RUN, at each; each of
     K1-K5 once a step, the same device operations a step at every B and
     within REPLICA_OPS_SLACK of the one-replica fused step's, each
     replica's universe drift under the prefix's bound, aggregate steps/s,
     device us a step and busy share from a profile); and the CLI with
     ``--vmap-replicas --replicas 1-8`` on phase 5's arguments (files and
     headers of every replica, GSD frames, K4/K5 once a step, each
     replica's drift under 3x the JAX batched CLI's reading, the
     aggregate steps/s of its own line);
 12. replica batches in cell and zcol mode: (a) the cell kernel at
     N = 20,001 (10^3 cells), the small grid on the N = 501 scene in cell
     mode (2^3 cells) and the zcol wrapper with its hull at N = 20,001,
     each over 8 replicas in one launch, float32 and float64, against
     their twins on the batch and against the one-replica launch on each
     replica (forces, hull, flags and table bit-equal), two calls
     bit-equal, in float32 their times and bound from the batch's own
     inputs; (b) float64 batches of 4 replicas at N = 20,001, 40 steps of
     1 fs in cell and in zcol mode across a rebuild of every replica's
     list, against one-replica card runs with the same draws (1e-9 bohr);
     (c) 8 replicas of ``build_large_n(50_000)`` (N = 100,001, cell mode,
     f32, fused tail, each replica thermalized apart) on phase 6's
     protocol: the cell kernel and K2-K5 once a step for the batch,
     device operations a step name by name within REPLICA_OPS_SLACK of one
     replica's, device us and busy share a step, aggregate steps/s beside
     phase 6's one replica, each replica's band within DOMAIN_BAND_RATIO of
     phase 6's, the list build's and K2's batched time beside one
     replica's; then 8 replicas of the N = 501 scene in cell mode (the
     small grid once a step) and 8 replicas of ``build_large_n(10_000,
     pair_mode='zcol')`` on phase 6's protocol (K9 and its hull once a
     step, each band under phase 6's N = 20,001 bound), both in chunks
     with the CLI's batch overflow retry; each of the three runs' pair
     call on its final state held as in (a); (d) the CLI with
     ``--vmap-replicas --replicas 1-8 --n-molecules 10000`` (cell mode,
     twice phase 8's runtime, each replica's drift under phase 8's bound).
     The ``_b8`` rows take their launches from the runs at their shapes:
     the cell kernel from (d), the small grid and K9 with its hull from
     (c)'s 8-replica runs.

 13. the MTTK and Berendsen baths (unfused: K4/K5 take Bussi and Langevin
     only, as in the JAX package) and the rest of the slice: (a) MTTK
     (100 K, tau 0.5 ps) on the molecules and Langevin on the photon
     through ``Simulation.run`` on phase 3's scene, 1000 steps from the
     start: K1-K3 once a step and K4/K5 never, steps/s, device
     operations, device us and busy share a step beside phase 11's
     profile of the fused Bussi step, the extended energy's drift (the
     universe plus the molecular MTTK energy) held to 3x the JAX
     package's CPU reading over the same chunk
     (``scripts/jax_bath_reference.py``); (b)
     Berendsen on the same scene, 1000 steps, the chunk's mean
     molecular T held within 3x the JAX reading's distance from 100 K;
     (c) MTTK at N = 100,001 (``build_large_n(50_000)``'s scene, cell
     mode), one warm-up chunk then 2 x 100 steps: no overflow, the cell
     kernel, K2 and K3 once a step, ms a step beside phase 6's default
     step, the device profile beside phase 12's one replica, the
     extended-energy band reported, and a checkpoint of the final state
     saved and loaded, timed; (d) exact resume on the card, f64: 50
     steps, a checkpoint, a fresh template, 50 more, against 100 steps
     in one run, in dense mode (N = 501) and cell mode (N = 4001, the
     carried list): positions within TRAJ_TOL_BOHR, the generators equal,
     (xi, eta) within 1e-12 relative; (e) the OCO triatomic scene at the
     reference density (167 molecules dense, 33,333 in cell mode): K1 and
     the cell kernel with two-partner exclusion rows against their twins
     in f32 and f64, two calls bit-equal; (f) 4 thermalized f64 replicas
     of N = 501, 20 MTTK + Langevin steps in one batch against
     one-replica runs (1e-9 bohr, each replica its own xi).
 14. replicas over ranks and the native host I/O library: one
     ``run_ranks`` spawn of SHARD_R gloo ranks sharing the card runs (a)
     phase 11d's CLI with ``--shard-replicas 2`` (each rank's K1-K5 about
     once a step, K4/K5 exactly, every replica's files and drift as in
     11d, the aggregate steps/s beside 11d's one rank) and a float64 run
     against the one-rank batch (the unrounded log/ values of every GSD
     frame to 1e-9 relative), and (b) ``make_domain_runner(n_replicas=2)``
     at one slab on phase 9's float64 scene (each replica within 1e-9
     bohr of ``run_replica_steps`` on the card; ``cell_pair_slab``, K2 and
     K3 once a step on each rank); (c) the native library loads, the N =
     501 CLI's energy file is the same with and without it,
     ``EnergyTracker.consume``'s host ms per 500-step chunk and a GSD
     frame's at N = 100,001 both ways.
 15. a replica batch over slabs (``parallel/domain.py`` with a replica
     axis): (a) the slab kernel over REPLICA_B replicas at N = 20,001 on
     one slab, each replica with its own slab tables (types, charges,
     exclusions, pair keys), in one launch, float32 and float64: against
     its twin on the batch and the one-replica launch on each replica's
     own call (forces bit-equal), two calls bit-equal; K2 and K3 with a
     charge row a replica against their twins and the one-replica
     launches; in float32 the batched launch's time beside one replica's
     and REPLICA_B one-replica launches', and K2's and K3's times beside
     their launches with one shared charge row; (b) a float64 batch of
     REPLICA_F64_B replicas at N = 20,001 through the batched slab runner,
     40 steps, against ``run_replica_steps`` on the card (1e-9 bohr; the
     slab kernel, K2 and K3 once a step for the batch); (c) REPLICA_B
     replicas of ``build_large_n(50_000)`` (N = 100,001, f32) through the
     batched slab runner on phase 6's protocol: the slab kernel, K2 and K3
     once a step for the batch, no overflow, each replica's band within
     phase 9's bound, aggregate steps/s beside phase 9's one replica and
     phase 12c's unsharded batch, and the slab step's device operations
     name by name at B = 1 and B = REPLICA_B (within REPLICA_OPS_SLACK),
     its device us, the rebuild's counted apart, and the busy share; on
     the run's final state the slab kernel against its twin and K2 and K3
     with a charge row a replica against theirs, with the kernel's time,
     its twin's and its bound from those inputs. The
     ``cell_pair_slab_b8`` row takes all its numbers from (c).
 16. the examples (``examples/0*_torch.py``) through their ``main`` on
     the card at cut depths (EXAMPLE_DEPTHS): 01 and 02 (float64, dense,
     the unfused tail: K4/K5 never), 03 (8 replicas, K1-K5 once a step
     for the batch), 04 (2 replicas x 1 slab on two gloo ranks sharing the
     card: the slab kernel, K2 and K3 once a step on each rank), 05 (the
     driver), 06 (the reference anchor at 0.5 ps: K1-K5 once a step, its
     universe drift and mean molecular T held to 3x the JAX package's
     reading of the same protocol), 07 (the polariton spectrum at 100
     periods, no pair kernel: its peaks within one bin of JAX's float64
     reading, the splitting beside the analytic one), 08 (the IR
     spectrum, its files in a temporary directory); every example's
     figures printed, and the launches of short runs of 03 and 06 and of
     04's run counted from complete profiler traces; and
     ``pppm_reciprocal_energy`` (kernel 2 once a call) against its plain
     twin, one scene and a batch, float32 and float64.
 17. user custom forces (``ForceField.create(custom_forces=...)``) with a
     harmonic trap on the unwrapped molecular positions (TRAP_K): (a)
     phase 3's scene, f32, dense, the fused tail, through
     ``Simulation.run`` on SHORT_RUN: ``custom_0`` among the observables,
     K1-K5 once a step by the wrappers' counts and in the traces of
     REPLICA_PROFILED_STEPS profiled steps, the step's device operations
     and us beside phase 11's profile of the same step without the trap,
     the universe drift (the trap's energy included) held to 3x the JAX
     package's CPU reading of the same protocol and callable
     (``scripts/jax_custom_force_reference.py``), steps/s; (b) a float64
     batch of REPLICA_F64_B replicas with the trap (called through
     ``torch.func.vmap``), REPLICA_F64_STEPS steps on the card, against
     one-replica card runs with the same draws (1e-9 bohr); (c)
     ``build_large_n(10_000)``'s scene in cell mode with the trap for one
     chunk: no overflow, the cell kernel once a step, finite energies; (d)
     ``Simulation.run(profile_dir=)`` writes a trace that names K1.
 18. atom sharding by rows (``parallel/shard.py``, for what the slab path
     does not take): (a) K1 with a row range (``dense_pair_rows``) on
     ROWS_S row blocks of the N = 501 scene and of REPLICA_B replicas of
     it in one launch, float32 and float64, against its twin on the same
     rows and the full launch's rows, the blocks' energy shares summed
     against the full launch's; (b) the cell kernel's row range
     (``cell_pair_rows``) at N = 2 HELD_N_MOL + 1 and on the small grid:
     each block against its twin, the blocks' forces summed equal to the
     full launch's bit for bit; in float32 the first block's time, its
     twin's and its bound; (c) ``Simulation(shard_atoms=2)`` on ROWS_S
     gloo ranks sharing the card (host-staged collectives) on the
     reference scene ghost-padded to 502, dense: float64 over
     ROWS_F64_STEPS steps within TRAJ_TOL_BOHR of the one-rank run,
     float32 on SHORT_RUN with its universe drift held to phase 3's
     DRIFT_BOUND_HA, each rank's K1 row range, K2 and K3 once a step and
     K4/K5 once a step in float32; (d) N = 2 HELD_N_MOL + 1 in cell mode
     (an opaque ``extra_obs``: the row path) for ROWS_CELL_STEPS steps,
     the cell kernel's row range once a step on each rank; (e) K9 with a
     row range (``zcol_pair_rows``) on ROWS_S row blocks at N = 100,001
     (17 x 17 columns, W = 8) and on REPLICA_B replicas of N = 20,001 in
     one launch, float32 and float64: each block against its twin with
     the same range, the blocks' forces summed equal to the full launch's
     bit for bit and their energy shares to its energies; in float32 the
     first block's time beside the full launch's, its twin's and its
     bound; and inside (c)'s spawn, (d)'s scene in zcol mode through
     ``Simulation(shard_atoms=2)``: ROWS_CELL_STEPS float32 steps with
     ``zcol_pair_rows``, ``zcol_hull``, K2 and K3 once a step on each
     rank, no overflow and no window flag, ms a step; and a float64 run
     within TRAJ_TOL_BOHR of the one-rank zcol run after
     ROWS_ZCOL_F64_STEPS steps. The ``dense_pair_rows``,
     ``cell_pair_rows`` and ``zcol_pair_rows`` rows take their launches
     from (c)'s float32 run, (d) and (e)'s float32 run.

Each path's launch counts are set to 0 just before it and read just after.
Each phase ends with a line of the seconds it took. The last four lines are
the summary (with the script's seconds and every phase's), a JSON object
of per-kernel results (the batched kernels as ``<name>_b8``), the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

# stated tolerances (see PERF.md):
# f32: reordered f32 sums over ~N pair terms / p^3 stencil terms / the
# kinetic-energy reductions, and nondeterministic f32 atomicAdd order in
# the spread -> 2e-5 of the scale. f64: same math in double -> 1e-11 of
# the scale. K4's image flags must match exactly. The scale is the twin's
# largest value, except for the two reservoir deltas, which are small
# differences of kinetic energies: their scale is that energy (K4: the
# molecules' KE; K5: the photon's KE before its OU step).
TOL = {"float32": 2e-5, "float64": 1e-11}
TRAJ_TOL_BOHR = 1e-9  # phase 4, f64 positions after 20 steps
# phase 3: max |U - U[0]| of the universe energy over the 5000-step
# (1.25 ps) window, f32. The freshly generated lattice relaxes (mean T of
# the molecules ~640 K over the window under the 100 K thermostat), so
# velocity-Verlet error is large here. The JAX package on the CPU, same
# scene, seed and protocol, gives 1.264e-3 Ha in f32 and 1.263e-3 Ha in
# f64; the bound is 3x the larger. Broken copies of the port's plain path
# run through the same protocol miss it: the Ewald short-range force
# without its Gaussian term drifts 2.0e-2 Ha, LJ repulsion at half strength
# 1.7e-1 Ha, a Bussi step without its reservoir tally 3.1e-1 Ha.
DRIFT_BOUND_HA = 3.8e-3
N_WARM, N_CHUNKS, CHUNK = 1000, 5, 1000
# phase 5: the CLI's default adaptive dt covers CLI_RUNTIME_PS in ~3650
# steps at N = 501 (energy rows every 1000 steps). The drift bound is 3x
# the JAX CLI's own reading on the same arguments with --device CPU
# --precision f32 (``python scripts/jax_cli_reference.py``): max |U - U[0]|
# of the universe_total_energy column over its 3 rows is 4.0e-6 Ha at seed
# 0 and 2.0e-6, 1.2e-5, 0 (one row), 1.0e-6 Ha at seeds 1-4 (the printed
# energies are rounded to 1e-6 Ha); the bound is 3x the largest. At the
# runtime before, 0.08 ps (~4900 steps), the readings were 4.0e-6 Ha and
# 2.0e-6, 1.2e-5, 3.0e-6, 7.0e-6 Ha, the same bound. The port's CLI on the
# CPU gave 3.0e-6 Ha at seed 0 there; a copy of the port whose Bussi step
# drops its reservoir tally gave 4.3e-3 Ha.
CLI_RUNTIME_PS = 0.06
CLI_DRIFT_BOUND_HA = 3.6e-5
CLI_ARGS = ["--device", "GPU", "--n-molecules", "250",
            "--enable-energy-tracker", "--enable-fkt", "--seed", "0",
            "--runtime", str(CLI_RUNTIME_PS)]
# phase 6: build_large_n through Simulation.run, the protocol of
# scripts/bench_large_n.py: one warm-up chunk, then LARGE_CHUNKS chunks of
# LARGE_CHUNK steps, f32, dt 0.25 fs; the metric is that script's band
# max(U) - min(U) of the universe energy over the window. The bound is 3x
# the JAX package's own reading on the CPU at N = 20,001
# (``python scripts/bench_large_n.py 10000`` with JAX_PLATFORMS=cpu):
# 1.96e-2 Ha over the 500 steps, 1.8e-2 to 1.9e-2 Ha in each chunk, so the
# band is the cavity dipole-self oscillation that the script's notes
# describe, not a drift. The JAX package on the CPU takes 0.553 s a step
# at N = 20,001 on that protocol, and cell mode's work grows as N, so its
# reading at N = 100,001 (~28 min for 600 steps) is not taken: the band
# there is reported. It is held to behave as velocity-Verlet error, which
# shrinks as dt^2: the same protocol at half the time step must give a
# band at least LARGE_DT2_RATIO times smaller (4 for pure dt^2; the JAX
# package's reading on a TPU v5e, in the notes of scripts/bench_large_n.py,
# is 1.4 Ha at 0.25 fs and 0.38 Ha at 0.125 fs, a ratio of 3.7). An error
# that grows with simulated time instead gives a ratio near 1 or 2.
LARGE_N_MOL, HELD_N_MOL = 50_000, 10_000
LARGE_CHUNK, LARGE_CHUNKS = 100, 5
LARGE_BAND_BOUND_HA = 5.9e-2
LARGE_DT_FS, LARGE_DT2_RATIO = 0.25, 2.5
# phase 8: the CLI at 10,000 molecules (held) and 50,000, with
# its default adaptive dt, for LARGE_CLI_RUNTIME_PS with energy rows every
# LARGE_CLI_ENERGY_PERIOD_STEPS steps. The bound is 3x the JAX CLI's own
# reading on the same arguments with --device CPU --precision f32 at
# 10,000 molecules: max |U - U[0]| of the universe column is 1.446e-3 Ha
# at seed 0 (232 steps, 4 rows), 1.441e-3 Ha at seed 1 (294 steps) and
# 2.76e-4 Ha at seed 2 (189 steps); the bound is 3x the largest. At 50,000
# molecules the float32 run is reported, not held: the adaptive dt
# (~0.0015 fs) moves a particle ~6e-6 bohr a step, under the float32
# spacing of coordinates past 64 bohr (7.6e-6 bohr, 1.5e-5 past 128), and
# its universe energy climbs ~2.5e-2 Ha over ~350 steps with the baths on
# or off, while the same command in float64 keeps it within 5e-6 Ha (H100,
# this phase). So the float64 run is held, to the 10,000-molecule float32
# bound.
LARGE_CLI_RUNTIME_PS = 0.0005
LARGE_CLI_ENERGY_PERIOD_STEPS = 50
LARGE_CLI_DRIFT_BOUND_HA = 4.4e-3
# phase 9: the domain runner at one slab, rebuilt every
# DOMAIN_REBUILD_EVERY = 20 steps (the Simulation default). The float64 trajectory runs
# DOMAIN_F64_STEPS steps at N = 2 * HELD_N_MOL + 1 and is held to phase 7's
# TRAJ_TOL_BOHR against the unsharded runner with the same draws. The
# float32 run at N = 100,001 takes phase 6's protocol (same scene, seed,
# time step and draws); its universe band is the same velocity-Verlet
# oscillation as phase 6's unsharded one, so it is held to
# DOMAIN_BAND_RATIO times that band from this run.
DOMAIN_F64_STEPS = 40
DOMAIN_BAND_RATIO = 1.1
# phase 10: the zcol float64 trajectory runs ZCOL_F64_STEPS steps at
# N = 2 * HELD_N_MOL + 1 with a 1 fs time step, so that some molecule
# moves past half the column skin (0.37 bohr) and the carried column list
# is rebuilt inside the window (at 0.25 fs none does in 40 steps); it is
# held to TRAJ_TOL_BOHR against cell mode with the same draws. The zcol
# run at N = 100,001 takes phase 6's protocol and is held to
# DOMAIN_BAND_RATIO times phase 6's band: the forces agree to f32
# rounding, so the band is the same dipole-self oscillation.
ZCOL_F64_STEPS, ZCOL_F64_DT_FS = 40, 1.0
# phase 11: replica batches of the N = 501 scene. REPLICA_B is the replica
# configuration of BASELINE.json ("--replicas 1-8 vmapped on one chip");
# the kernels are also timed at REPLICA_WIDE_B. The float64 batch of
# REPLICA_F64_B replicas runs REPLICA_F64_STEPS steps against as many
# one-replica runs with the same draws, held to TRAJ_TOL_BOHR. The batched
# step runs SHORT_RUN, a prefix of phase 3's protocol, at each of
# REPLICA_STEP_BATCHES, each replica's universe drift held to
# REPLICA_SHORT_DRIFT_BOUND_HA, then REPLICA_PROFILED_STEPS profiled steps;
# the CLI at REPLICA_B replicas is held to VMAP_CLI_DRIFT_BOUND_HA, 3x the
# JAX package's own batched CLI on the same arguments with --device CPU
# (``python scripts/jax_vmap_cli_reference.py --precision f32|f64``, at
# phase 5's CLI_RUNTIME_PS): per-replica max |U - U[0]| up to 9e-6 Ha in
# f64 and up to 1.7e-5 Ha in f32 over the replicas' rows that stayed
# finite (its f32 batch blew up in 3 of the 8 replicas, ROADMAP.md Queue
# 3); the bound is 3x the larger. At 0.08 ps, the runtime before, the
# readings were 9e-6 and 1.8e-5 Ha (bound 5.4e-5).
REPLICA_B, REPLICA_WIDE_B = 8, 32
VMAP_CLI_DRIFT_BOUND_HA = 5.1e-5
REPLICA_F64_B, REPLICA_F64_STEPS = 4, 20
REPLICA_STEP_BATCHES = (1, 8, 32)
# the steps of each profiled window (every profile of a step in phases
# 11-13, 15 and 17): a trace's device operations a step are counted name
# by name, so 20 steps give the same whole numbers as 50 at 2.5x less
# tracing
REPLICA_PROFILED_STEPS = 20
# the device operations of a batched step may differ from the unbatched
# fused step's by the draws' reshapes and a few views that became copies;
# across batch sizes the step is the same program and must issue the same
# whole number a step (``profiled_steps`` counts it past the profiler's
# dropped records)
REPLICA_OPS_SLACK = 4
BATCHED_KERNELS = ("dense_pair", "pppm_spread", "pppm_interpolate",
                   "fused_pre_force", "fused_post_force")
# the prefix of phase 3's protocol (warm-up steps, chunks, steps a chunk)
# that phase 3's unfused run and phase 11's batched steps run. Each bound
# is 3x the larger of the JAX package's f32 and f64 readings on the CPU
# over the same prefix (``python scripts/jax_bath_reference.py --protocol
# short``), max |U - U[0]| of the universe energy: for phase 3's state
# 8.743e-4 Ha (f32) and 8.778e-4 Ha (f64); for each replica of the
# thermalized batch of 32 (seed 7 + r; phase 11's batches are its first
# rows) up to 9.576e-4 Ha in f64 and 9.726e-4 Ha in f32 over the 23
# replicas that stayed finite (its f32 batch blew up in 9, ROADMAP.md
# Queue 3).
SHORT_RUN = (N_WARM // 4, 2, CHUNK // 2)
SHORT_DRIFT_BOUND_HA = 2.63e-3
REPLICA_SHORT_DRIFT_BOUND_HA = 2.91e-3
# phase 12: replica batches in cell and zcol mode. The batched kernels run
# at REPLICA_B replicas (the cell kernel and the zcol wrapper with its
# hull at N = 2 HELD_N_MOL + 1, the small grid at N = 501); the float64
# batches of REPLICA_F64_B replicas take phase 10's ZCOL_F64_STEPS steps of
# ZCOL_F64_DT_FS (every replica's list rebuilt) against one-replica runs,
# held to TRAJ_TOL_BOHR; REPLICA_B replicas of build_large_n(LARGE_N_MOL)
# take phase 6's protocol, each replica's band held to DOMAIN_BAND_RATIO
# times phase 6's, their device operations a step to REPLICA_OPS_SLACK of
# one replica's; REPLICA_B replicas of the N = 501 scene in cell mode take
# SMALL_GRID_BATCH_STEPS steps, each drift held to DRIFT_BOUND_HA;
# REPLICA_B replicas of build_large_n(HELD_N_MOL) in zcol mode take phase
# 6's protocol, each band held to LARGE_BAND_BOUND_HA (phase 6 at
# N = 20,001); the CLI
# at HELD_N_MOL molecules with --vmap-replicas to phase 8's
# LARGE_CLI_DRIFT_BOUND_HA.
SMALL_GRID_BATCH_STEPS = 500
# the batched CLI's adaptive dt starts from each replica's own optimal dt
# and covers LARGE_CLI_RUNTIME_PS in ~124 steps (2 energy rows); twice the
# runtime gives the drift check 4-5 rows, as phase 8's one-replica run has
VMAP_LARGE_CLI_RUNTIME_PS = 2 * LARGE_CLI_RUNTIME_PS
BATCHED_CELL_KERNELS = ("cell_pair", "cell_pair_small_grid", "zcol_pair",
                        "zcol_hull")


# phase 13: the baths' protocols (scripts/jax_bath_reference.py runs the
# JAX package on them on the CPU). 13a: MTTK at BATH_TAU_PS on phase 3's
# scene, BATH_CHUNKS chunks of CHUNK steps from the start; the bound is 3x
# the larger of the JAX package's f32 and f64 readings of the extended
# energy's drift over that one chunk. 13b: Berendsen,
# BERENDSEN_CHUNKS chunks; the
# bound on |T - 100 K| of the last chunk's mean molecular T is 3x the JAX
# reading's (the freshly generated lattice relaxes and heats the
# molecules, which a 0.5 ps Berendsen bath pulls back only slowly). The
# JAX readings (``python scripts/jax_bath_reference.py --protocol baths``,
# CPU): MTTK's extended drift over the first chunk from step 0 2.0505e-3
# Ha (f32) and 2.0486e-3 Ha (f64); Berendsen's first-chunk T 588.64 K
# (f32) and 588.77 K (f64), 488.77 K from 100 K at most. Before the
# windows were cut (a warm-up chunk for MTTK, two chunks of Berendsen) the
# readings were 9.044e-4 / 9.027e-4 Ha and 462.05 / 462.13 K.
BATH_TAU_PS = 0.5
BATH_CHUNKS, BERENDSEN_CHUNKS = 1, 1
MTTK_DRIFT_BOUND_HA = 6.15e-3
BERENDSEN_T_BOUND_K = 1466.0
BERENDSEN_JAX_T_K = 588.77
BATH_LARGE_CHUNKS = 2  # 13c, after one warm-up chunk of LARGE_CHUNK steps
RESUME_K = 50  # 13d: RESUME_K steps, a checkpoint, RESUME_K more
RESUME_MTTK_REL = 1e-12
TRI_N_MOL = (167, 33_333)  # 13e: dense (N = 501), cell mode (N = 99,999)
TRI_LJ = {("C", "C"): dict(epsilon=2.0e-4, sigma=5.2),
          ("O", "O"): dict(epsilon=1.6e-4, sigma=5.8),
          ("C", "O"): dict(epsilon=1.8e-4, sigma=5.5)}
# phase 14: replicas over ranks and the native host I/O library. 14a
# runs phase 11d's CLI (CLI_ARGS, --vmap-replicas --replicas 1-REPLICA_B,
# float32) on SHARD_R ranks that share the card, each replica's drift held
# to VMAP_CLI_DRIFT_BOUND_HA, and a float64 run of SHARD_F64_ARGS on
# SHARD_R ranks against the one-rank batch: the unrounded log/ values of
# every GSD frame to SHARD_F64_RTOL relative (K2's float64 atomics add
# the grid in another order on every run, ~1e-16 a step, and ~300 steps
# of MD amplify that to ~1e-13). 14b runs phase 9's float64 scene as
# SHARD_R replicas through make_domain_runner(n_replicas=SHARD_R) at one
# slab for DOMAIN_F64_STEPS steps, held to TRAJ_TOL_BOHR against
# run_replica_steps on the card. 14c: the N = 501 CLI for
# NATIVE_CLI_RUNTIME_PS with an energy row every step, its tracker
# twinned by one that formats in Python; NATIVE_REPS 500-row chunks a way;
# NATIVE_GSD_FRAMES frames at N = 100,001 a way.
SHARD_R = 2
SHARD_F64_ARGS = ["--precision", "f64", "--runtime", "0.005",
                  "--energy-output-period-ps", "0.0005",
                  "--gsd-output-period-ps", "0.0005"]
SHARD_F64_RTOL = 1e-9
NATIVE_CLI_RUNTIME_PS = 0.02
NATIVE_CHUNK, NATIVE_REPS, NATIVE_GSD_FRAMES = 500, 7, 5
# phase 16: the port's examples (examples/0*_torch.py) through their main
# on the card, each at a depth cut to keep the phase near a minute and a
# half (EXAMPLE_DEPTHS, keyword arguments of each main; 06's full 50 ps and
# 07's 800 periods run apart, PERF.md). The JAX readings of
# scripts/jax_examples_reference.py --protocol chip (CPU, 2026-10-18):
# 06 at 0.5 ps on the reference scene in float32, over the example's seeds
# and two variants, universe drift up to 1.0002e-4 Ha and mean molecular T
# within 5.16 K of 100 K (each held at 3x; at 1 ps, the depth before, the
# readings were 1.0020e-4 Ha and 2.66 K); 07 at 100 periods in float64
# (deterministic NVE): peaks 1508.38 and 1601.69 cm^-1 at g = 1e-3 and
# 1555.04 at g = 0, bin 15.55 cm^-1 (each peak held within one bin). The
# traced runs (EXAMPLE_TRACED) are short ones of 03 and 06 whose profiler
# traces hold each kernel's device records to its wrapper's count (04's
# run is traced whole, on each rank): traced whole, 03's and 06's runs
# at these depths take far longer than the two short runs (PERF.md §6).
EXAMPLE_TRACED = {"03": dict(n_steps=50, fire_steps=10),
                  "06": dict(runtime_ps=0.0125, fire_steps=10, chunk=50)}
EXAMPLE_DEPTHS = {
    "01": dict(n_steps=500),
    "02": dict(n_steps=500, t_window=250),
    "03": dict(n_steps=300, fire_steps=200),
    "04": dict(n_steps=100),
    "06": dict(runtime_ps=0.5, fire_steps=300),
    "07": dict(n_periods=100),
    "08": dict(n_chunks=2, chunk=500, reference_every=500),
}
EXAMPLE_05_ARGS = ["--n-molecules", "250", "--runtime", "0.01", "--seed",
                   "0", "--enable-energy-tracker"]
EX06_DRIFT_BOUND_HA = 3 * 1.0002e-4
EX06_T_BOUND_K = 3 * 5.16
EX07_JAX_PEAKS_CM1 = {"peaks_g0": [1555.0355457530832],
                      "peaks": [1508.3844793804908, 1601.6866121256758]}
# kernel symbol in a trace -> the wrapper counts its records must equal
TRACE_SYMBOLS = {"dense_pair_kernel": ("dense_pair",),
                 "spread_kernel": ("pppm_spread",),
                 "interpolate_kernel": ("pppm_interpolate",),
                 "pre_force_kernel": ("fused_pre_force",),
                 "post_force_kernel": ("fused_post_force",),
                 "cell_pair_kernel": ("cell_pair", "cell_pair_small_grid",
                                      "cell_pair_slab")}
# phase 17: user custom forces. The callable (``trap_force``) is a harmonic
# trap of stiffness TRAP_K on the unwrapped positions of the molecules (the
# photon left out), U = 1/2 k sum |r + image L|^2. (a) phase 3's scene
# (f32, dense, the fused tail) with the trap through Simulation.run on
# SHORT_RUN; the universe drift, the trap's energy included, is held to 3x
# the larger of the JAX package's f32 and f64 readings on the CPU of the
# same protocol and callable (``python
# scripts/jax_custom_force_reference.py``, 2026-10-18): max |U - U[0]|
# 8.7305e-4 Ha (f32) and 8.7832e-4 Ha (f64), the trap's energy spanning
# 2.18e-2 Ha of its 1.208 Ha over the window. (b)
# REPLICA_F64_B f64 replicas, REPLICA_F64_STEPS steps with the trap in one
# batch (the trap through torch.func.vmap) against one-replica card runs
# with the same draws, to TRAJ_TOL_BOHR. (c) build_large_n(HELD_N_MOL)'s
# scene in cell mode with the trap, one chunk of LARGE_CHUNK steps. (d)
# Simulation.run(profile_dir=) on phase 3's scene for PROFILE_DIR_STEPS
# steps writes a trace that names K1.
TRAP_K = 1e-5
CUSTOM_DRIFT_BOUND_HA = 2.63e-3
PROFILE_DIR_STEPS = 20


def large_cli_args(n_molecules, runtime_ps=LARGE_CLI_RUNTIME_PS):
    return ["--device", "GPU", "--n-molecules", str(n_molecules),
            "--enable-energy-tracker", "--enable-fkt", "--seed", "0",
            "--runtime", str(runtime_ps),
            "--energy-output-period-ps",
            str(LARGE_CLI_ENERGY_PERIOD_STEPS * 1e-4)]


# header lines of the JAX package's tracker files
# (cavmd_tpu/observe/trackers.py), as the CLI writes them with its
# default periods; None = a line whose value depends on the run
CLI_HEADERS = {
    "prod-1_energy_tracker.txt": [
        "# Energy tracking (cavmd_tpu)",
        "# Output period: 1000 steps",
        "# All energies in Hartree (atomic units)",
        "#   universe_total_energy: system + reservoir [CONSERVED]",
        "time(ps) timestep harmonic_energy lj_energy ewald_short_energy "
        "ewald_long_energy cavity_harmonic_energy cavity_coupling_energy "
        "cavity_dipole_self_energy cavity_total_potential_energy "
        "molecular_kinetic_energy cavity_kinetic_energy total_kinetic_energy "
        "total_potential_energy system_total_energy "
        "molecular_reservoir_energy cavity_reservoir_energy "
        "total_reservoir_energy universe_total_energy temperature"],
    "prod-1_cavity_mode.txt": [
        "# Cavity mode tracking",
        "# Output period: 1000 steps",
        "# timestep time(ps) cavity_kinetic_energy cavity_potential_energy "
        "cavity_total_energy cavity_temperature"],
    "prod-1_ref0.txt": [
        "# Density_correlation field autocorrelation", None,
        "# Output period: 10000 steps",
        "# timestep lag_time(ps) field_autocorr"],
    "dipole_autocorr_0.txt": [
        "# Dipole autocorrelation data", "# Reference number: 0",
        "# Output period: 10000 steps", "# timestep t(ps) C(t)"],
}
SOURCES = ("pair", "pppm_spread", "fused_integrator", "cell_pair",
           "zcol_pair")
KERNELS = {  # name -> (source file, the TPU kernel it replaces)
    "dense_pair": ("cavmd_tpu_torch/csrc/pair.cu",
                   "cavmd_tpu/ops/pallas_kernels.py:114"),
    "cell_pair": ("cavmd_tpu_torch/csrc/cell_pair.cu",
                  "cavmd_tpu/ops/pallas_kernels.py:617"),
    "cell_pair_small_grid": ("cavmd_tpu_torch/csrc/cell_pair.cu",
                             "cavmd_tpu/ops/pallas_kernels.py:529"),
    "cell_pair_slab": ("cavmd_tpu_torch/csrc/cell_pair.cu",
                       "cavmd_tpu/ops/pallas_kernels.py:1044"),
    "pppm_spread": ("cavmd_tpu_torch/csrc/pppm_spread.cu",
                    "cavmd_tpu/ops/pppm_pallas.py:272"),
    "pppm_interpolate": ("cavmd_tpu_torch/csrc/pppm_spread.cu",
                         "cavmd_tpu/ops/pppm_pallas.py:307"),
    "fused_pre_force": ("cavmd_tpu_torch/csrc/fused_integrator.cu",
                        "cavmd_tpu/ops/fused_integrator.py:71"),
    "fused_post_force": ("cavmd_tpu_torch/csrc/fused_integrator.cu",
                         "cavmd_tpu/ops/fused_integrator.py:113"),
    "zcol_pair": ("cavmd_tpu_torch/csrc/zcol_pair.cu",
                  "cavmd_tpu/ops/pallas_kernels.py:1263"),
    "zcol_hull": ("cavmd_tpu_torch/csrc/zcol_pair.cu",
                  "cavmd_tpu/ops/pallas_kernels.py:1430"),
}
PROFILE_TRIES = 5  # traces a profile takes before it uses the best one
# the share of a twin's device records a usable trace may miss (the
# profiler's drops; a trace missing more is a partial one, taken again)
PROFILE_DROP_SHARE = 0.01
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


# kernels whose registers, stack and spills phase 1 must find by name in a
# fresh build's ptxas report, in float and double
PTXAS_NAMED = {"cell_pair": ("cell_pair_kernel",),
               "fused_integrator": ("pre_force_kernel", "post_force_kernel"),
               "pair": ("dense_pair_kernel",),
               "pppm_spread": ("spread_kernel", "interpolate_kernel"),
               "zcol_pair": ("zcol_pair_kernel", "zcol_hull_kernel")}
# kernels that must build with no stack frame and no spill (K3 keeps every
# stencil row in registers, one instantiation an order; the zcol kernels
# keep their ring state and exclusion rows in registers)
PTXAS_NO_STACK = ("interpolate_kernel<float, 6>",
                  "interpolate_kernel<double, 6>") + tuple(
    f"{k}<{t}{b}>" for k in ("zcol_pair_kernel", "zcol_hull_kernel")
    for t in ("float", "double") for b in ("", ", batched"))
# the kernels the replica batches run (phase 11: K1 at both unrolls, K2
# and K3 at order 6, K4, K5; phase 12: the cell kernel, and the zcol
# kernels above), and the one-replica instantiations of those that have a
# batched one of their own, must build with no spill
PTXAS_NO_SPILL = tuple(
    f"{k}<{t}{u}{b}>" for t in ("float", "double")
    for k, u, bs in (("dense_pair_kernel", ", 2", ("", ", batched")),
                     ("dense_pair_kernel", ", 4", ("", ", batched")),
                     ("spread_kernel", ", 6", ("",)),
                     ("interpolate_kernel", ", 6", ("", ", batched")),
                     ("pre_force_kernel", "", ("",)),
                     ("post_force_kernel", "", ("", ", batched")),
                     ("cell_pair_kernel", "", ("", ", batched")))
    for b in bs)


def ptxas_report(log):
    """[(kernel, registers, stack frame bytes, spill store bytes, spill
    load bytes)] for each entry function of an ``nvcc -Xptxas -v`` log; a
    kernel template reads as ``name<float>`` or ``name<double>``, one with
    an order as ``name<float, 6>``."""
    out, entry, props, spill = [], None, None, (0, 0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([\w$]+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"Function properties for ([\w$]+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry is not None and props == entry:
            spill = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            k = re.search(r"([a-z][a-z_]*_kernel)I([fd])(?:Li(\d+)E)?"
                          r"(?:Lb([01])E)?E", entry)
            label = entry
            if k:
                t = "float" if k.group(2) == "f" else "double"
                order = f", {k.group(3)}" if k.group(3) else ""
                batch = ", batched" if k.group(4) == "1" else ""
                label = f"{k.group(1)}<{t}{order}{batch}>"
            out.append((label, int(m.group(1)), *spill))
            entry = None
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


class PhaseClock:
    """Wall seconds of each phase, printed as the phase ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def lap(self, phase: int) -> None:
        now = time.perf_counter()
        self.seconds[phase] = now - self.last
        self.last = now
        print(f"phase {phase}: took {self.seconds[phase]:.1f} s "
              f"({now - self.start:.1f} s into the script)", flush=True)

    def total(self) -> float:
        return time.perf_counter() - self.start


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _call_plan(torch, fn, reps, inner):
    """Warm ``fn`` up and size a sample to it: (reps, inner, seconds the
    host takes to issue one call). A call that takes the host more than
    20 ms (the plain twins at N = 100,001) gets fewer calls per sample and
    five samples, so one timing stays within seconds."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    inner = max(1, min(inner, int(0.1 / max(issue_s, 1e-6))))
    if issue_s > 0.02:
        reps = min(reps, 5)
    return reps, inner, issue_s


def host_call_ms(torch, fn, reps=15, inner=10):
    """Median over ``reps`` samples of the mean time of ``inner``
    back-to-back calls, from CUDA events (warmed up first). At these sizes
    the device waits on the host, so this is the cost of a call as the
    caller sees it: argument checks, allocation, launches and all."""
    reps, inner, _ = _call_plan(torch, fn, reps, inner)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def device_ms(torch, fn, reps=15, inner=10):
    """Median over ``reps`` samples of the device time of one call: CUDA
    events around ``inner`` back-to-back calls queued behind a spin kernel,
    so the device runs them without waiting on the host. The spin is sized
    to outlast the host's issuing of the calls; a sample counts only if the
    spin was still running when the end event was queued (the start event
    not yet reached), otherwise the spin is doubled. A call that
    synchronises with the host raises (sync debug mode "error")."""
    reps, inner, issue_s = _call_plan(torch, fn, reps, inner)
    # ~2e9 spin cycles a second at H100 clocks, with a 3x margin, and at
    # least 5 ms of spin (a sample whose spin ended early is taken again
    # with twice the spin)
    spin_cycles = max(10_000_000, int(6e9 * inner * issue_s))
    samples = []
    while len(samples) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(inner):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            samples.append(start.elapsed_time(end) / inner)
        else:
            spin_cycles *= 2
            check(spin_cycles < 40_000_000_000,
                  "device_ms: the host never got ahead of the device")
    return statistics.median(samples)


def profiled_device_ms(torch, fn, reps=5, match=None, ops=False, once=()):
    """Device time of one call as the sum of its device operations'
    durations in a ``torch.profiler`` trace of ``reps`` calls (one stream,
    so the sum is the busy time); with ``match``, the mean duration of the
    operations whose name contains it (a kernel each call launches once).
    For the plain twins, which issue hundreds to thousands of launches a
    call: queued behind a spin kernel they fill the launch queue, the host
    then waits on the device, and ``device_ms`` cannot keep the host out
    of the way. One call runs first under sync debug mode "error", so a
    call that synchronises with the host raises here too. With ``ops``,
    returns (ms, device operations a call).

    On the card's machine the profiler drops device records: now and then
    a trace's all or some, more often one or two (PR 10: 705, 646, 704,
    705, 704 operations in five traces of one twin), so a trace is taken
    again until it is complete, up to PROFILE_TRIES traces in all, and
    else the best usable one counts. With ``match`` or ``once`` (names of
    kernels each call launches once) a trace is complete when it holds
    each named kernel exactly ``reps`` times and usable when it misses at
    most one of each. With neither, the reference is the most operations
    a trace held with another trace within PROFILE_DROP_SHARE below it; a
    trace is usable when it holds at least 1 - PROFILE_DROP_SHARE of them
    and no more (five traces of one twin once held 399, 414, 399, 399,
    399 operations, one with records from outside the calls), complete
    when another holds as many; the best usable trace holds the most
    operations."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    def calls():
        for _ in range(reps):
            fn()

    marks = ((match,) if match is not None else ()) + tuple(once)
    taken = []  # (operations, counts of the marked kernels, records)
    for _, every in traces(torch, calls):
        dev = [e for e in every if match is None or match in e.name]
        counts = [named(every, k) for k in marks]
        taken.append((len(every), counts, dev))
        if marks:
            usable = [t for t in taken
                      if all(reps - 1 <= c <= reps for c in t[1])]
            complete = all(c == reps for c in counts)
        else:
            n_ops = [t[0] for t in taken]
            ref = max((n for n in n_ops if sum(
                (1 - PROFILE_DROP_SHARE) * n <= m <= n for m in n_ops) >= 2),
                default=0)
            usable = [t for t in taken if t[0] >= reps and
                      (1 - PROFILE_DROP_SHARE) * ref <= t[0] <= ref]
            complete = n_ops.count(ref) >= 2
        if complete:
            break
    check(bool(usable), f"profiled_device_ms: no usable trace of {reps} "
          f"calls in {PROFILE_TRIES} (device operations and counts of "
          f"{list(marks)}: {[t[:2] for t in taken]})")
    n, counts, dev = max(usable, key=lambda t: (sum(t[1]), t[0]))
    ms = sum(e.end - e.start for e in dev) / 1e3
    ms /= len(dev) if match is not None else reps
    return (ms, n / reps) if ops else ms


def bound_ms(n_bytes, n_ops):
    """(bound in ms, "bytes" or "operations"): the larger of the bytes the
    call must move over the HBM rate and its f32 operations over the f32
    peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reference_scene(pt, n_molecules, box_L, dtype, device):
    snap = pt.make_diatomic_system(n_molecules, box_L=box_L,
                                   temperature_K=100.0, seed=0,
                                   device=device)
    snap = pt.add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                                  temperature_K=100.0, seed=1)
    return snap.astype(dtype)


def main_methods(pt, kT):
    from cavmd_tpu_torch.core import PhysicalConstants as PC

    return (
        pt.MethodSpec(kind="bussi", group="molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec(kind="langevin", group="cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0)),
    )


def integrator_inputs(torch, pt, snap, ff):
    """Seeded K4/K5 inputs on the scene: thermal velocities, the scene's
    forces, eight particles pushed across the +x face and eight across the
    -y face (so the rewrap updates image flags), and the step's scalars as
    device tensors."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.ops import fused_integrator as fi

    dev, dtype = snap.device, snap.position.dtype
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    plan = fi.FusedIntegratorPlan(ff, methods, snap.N, dtype)
    forces, _ = ff(snap.position, snap.image, snap.box_L, snap.charge,
                   snap.typeid)
    L = float(snap.box_L[0])
    pos, vel = snap.position.clone(), snap.velocity.clone()
    pos[:8, 0], vel[:8, 0] = 0.5 * L - 1e-3, 5e-3
    pos[8:16, 1], vel[8:16, 1] = -0.5 * L + 1e-3, -5e-3
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    draws = torch.randn(5, generator=gen, dtype=dtype, device=dev)
    dt = torch.tensor(PC.fs_to_atomic_units(0.25), dtype=dtype, device=dev)
    mol = snap.typeid != ff.l_typeid
    mb, ml = methods
    r_gamma = torch.tensor(mb.dof - 1.0, dtype=dtype, device=dev)
    pre = (plan, pos, snap.image, vel, forces, snap.mass, mol, snap.box_L,
           dt, torch.exp(-dt / mb.tau), kT, draws[0], r_gamma)
    c_ou = torch.exp(-ml.gamma * dt)
    sig = torch.sqrt((1.0 - c_ou * c_ou) * kT / snap.mass[plan.photon])
    post = (plan, vel, forces, snap.mass, mol, dt, c_ou, sig,
            draws[2:].reshape(1, 3))
    return pre, post


def max_err(a, b):
    return float((a.double() - b.double()).abs().max()), float(
        b.double().abs().max())


def kernel_phase(torch, pt, n_molecules, box_L, dtype, timed,
                 pair_mode=None, pair_only=False):
    """Each kernel against its plain twin on the same CUDA tensors: the
    ForceField's pair kernel (dense K1, or the cell kernel in cell mode)
    and, unless ``pair_only``, K2-K5."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import fused_integrator as fi
    from cavmd_tpu_torch.ops import pair_kernels as pk
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.ops.pppm import mesh_energy

    dev = torch.device("cuda")
    snap = reference_scene(pt, n_molecules, box_L, dtype, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode=pair_mode)
    pos, box, q, tid = snap.position, snap.box_L, snap.charge, snap.typeid
    order, mesh = ff.pppm_order, ff.pppm_mesh
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    out = {}

    def hold(key, pairs, what, scales=()):
        """Each kernel output within ``tol`` of its twin's, relative to
        the twin's largest value, or to the given scale where the output
        is a difference of larger terms."""
        errs = [max_err(k, p) for k, p in pairs]
        for i, s in enumerate(scales):
            if s is not None:
                errs[i] = (errs[i][0], max(errs[i][1], s))
        for (err, scale), (k, _) in zip(errs, pairs):
            check(bool(torch.isfinite(k).all()),
                  f"{key} N={snap.N} {name}: non-finite {what}")
            check(err <= tol * max(scale, 1e-300),
                  f"{key} N={snap.N} {name}: max|d{what}| {err} > "
                  f"{tol}*{scale}")
        out[key] = dict(max_abs_err=errs[0][0], scale=errs[0][1])
        if len(errs) > 1:
            out[key]["max_abs_err_other_outputs"] = [e for e, _ in errs[1:]]

    def hold_bits(key, first, second):
        """Two calls of a kernel on the same inputs give the same bits."""
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{key} N={snap.N} {name}: two calls on the same inputs "
              "differ")
        out[key]["bit_equal_calls"] = True

    calls = {}
    cell_key = None
    if ff.pair_mode == "dense":
        pair_args = (pos, box, tid, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                     ff.lj_vshift, q, ff.lj_active, ff.coulomb_active,
                     ff.kappa_value, ff.coulomb_rcut ** 2)
        f_k, elj_k, eew_k = pk.dense_pair_force(*pair_args)
        f_p, elj_p, eew_p = pk.dense_pair_force_plain(*pair_args)
        again = pk.dense_pair_force(*pair_args)
        torch.cuda.synchronize()
        hold("dense_pair", [(f_k, f_p), (elj_k, elj_p), (eew_k, eew_p)],
             "F,E")
        hold_bits("dense_pair", (f_k, elj_k, eew_k), again)
        out["dense_pair"]["blocks"] = pk.launch_blocks(snap.N)
        calls["dense_pair"] = (lambda: pk.dense_pair_force(*pair_args),
                               lambda: pk.dense_pair_force_plain(*pair_args))
    else:
        clist = ff.build_cells(pos, box)
        check(not bool(clist.overflow), f"cell list N={snap.N} overflowed")
        cell_args = (pos, box, clist, ff.cell_cfg, tid, q, ff.lj_eps,
                     ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
                     ff.cell_exclusions, ff.kappa_value)
        cell_key = ck.kernel_name(ff.cell_cfg)
        f_k, elj_k, eew_k = ck.cell_pair_force_fused(*cell_args)
        again = ck.cell_pair_force_fused(*cell_args)
        f_p, elj_p, eew_p = ck.cell_pair_force_fused_plain(*cell_args)
        torch.cuda.synchronize()
        hold(cell_key, [(f_k, f_p), (elj_k, elj_p), (eew_k, eew_p)], "F,E")
        hold_bits(cell_key, (f_k, elj_k, eew_k), again)
        out[cell_key]["grid"] = dict(
            ncells=ff.cell_cfg.ncells, cap=ff.cell_cfg.cap,
            blocks=ck.launch_blocks(ff.cell_cfg.total_cells,
                                    ff.cell_cfg.cap, dev))
        calls[cell_key] = (
            lambda: ck.cell_pair_force_fused(*cell_args),
            lambda: ck.cell_pair_force_fused_plain(*cell_args))
        # the list build, on the main path once a step (no kernel of its
        # own: sort, running maximum and scatters in PyTorch)
        calls["cell_list_build"] = (lambda: ff.build_cells(pos, box), None)
        out["cell_list_build"] = {}

    pre, big_meshes = None, []
    if not pair_only:
        g_k = sk.spread_grid(pos, q, box, order, mesh)
        g_p = sk.spread_grid_plain(pos, q, box, order, mesh)
        tiled = torch.zeros(1, dtype=torch.int32, device=dev)
        sk.spread_grid_cuda(pos, q, box, order, mesh, tile_runs=tiled)
        torch.cuda.synchronize()
        hold("pppm_spread", [(g_k, g_p)], "grid")
        out["pppm_spread"]["tile_runs"] = int(tiled)
        # at N = 100,001 also the 64^3 and 128^3 meshes (the tile path's
        # rows per block grow with the mesh; past them a block adds to the
        # global mesh itself)
        if snap.N > 50_000:
            big_meshes = [(64, 64, 64), (128, 128, 128)]
        for big in big_meshes:
            key = f"pppm_spread_{big[0]}"
            tiled.zero_()
            g_big = sk.spread_grid_cuda(pos, q, box, order, big,
                                        tile_runs=tiled)
            g_big_p = sk.spread_grid_plain(pos, q, box, order, big)
            torch.cuda.synchronize()
            hold(key, [(g_big, g_big_p)], "grid")
            out[key]["tile_runs"] = int(tiled)
            calls[key] = (
                lambda m=big: sk.spread_grid(pos, q, box, order, m),
                lambda m=big: sk.spread_grid_plain(pos, q, box, order, m))

        grid = g_p.detach().requires_grad_(True)
        (ct,) = torch.autograd.grad(mesh_energy(grid, ff.pppm), grid)
        ct = ct.contiguous()
        d_k = sk.interpolate_grad(ct, pos, q, box, order, mesh)
        d_again = sk.interpolate_grad(ct, pos, q, box, order, mesh)
        d_p = sk.interpolate_grad_plain(ct, pos, q, box, order, mesh)
        torch.cuda.synchronize()
        hold("pppm_interpolate", [(d_k, d_p)], "dE/dr")
        hold_bits("pppm_interpolate", (d_k,), (d_again,))

        pre, post = integrator_inputs(torch, pt, snap, ff)
        k4 = fi.pre_force_apply(*pre)
        k4_again = fi.pre_force_apply(*pre)
        p4 = fi.pre_force_apply_plain(*pre)
        torch.cuda.synchronize()
        check(torch.equal(k4[1], p4[1]),
              f"fused_pre_force N={snap.N} {name}: image flags differ")
        check(int((k4[1] != pre[2]).sum()) >= 16,
              f"fused_pre_force N={snap.N} {name}: no particle crossed a "
              "face")
        # the reservoir deltas are differences of kinetic energies: K4's
        # KE (1 - alpha^2) with alpha from the molecules' KE, K5's the
        # photon's KE before its OU step less after; their rounding scales
        # with those energies, the group KE and the photon's KE before
        vel, mass, mol = pre[3], pre[5], pre[6]
        ke_mol = float(0.5 * (mass[:, None] * vel * vel)[mol].sum())
        hold("fused_pre_force", [(k4[0], p4[0]), (k4[2], p4[2]),
                                 (k4[3], p4[3])], "x,v,dE_res",
             scales=(None, None, ke_mol))
        hold_bits("fused_pre_force", k4, k4_again)
        k5 = fi.post_force_apply(*post)
        k5_again = fi.post_force_apply(*post)
        p5 = fi.post_force_apply_plain(*post)
        torch.cuda.synchronize()
        check(torch.equal(k5[0], p5[0]),
              f"fused_post_force N={snap.N} {name}: velocities differ from "
              "the twin's")
        ke_photon = float(p5[2].abs() + p5[3].abs())
        hold("fused_post_force", list(zip(k5, p5)), "v,KE,dE_res",
             scales=(None, None, None, ke_photon))
        hold_bits("fused_post_force", k5, k5_again)
        for key, kname in (("fused_pre_force", "pre_force"),
                           ("fused_post_force", "post_force")):
            out[key]["blocks"] = fi.grid_blocks(kname, snap.N, dtype)
        calls.update({
            "pppm_spread": (
                lambda: sk.spread_grid(pos, q, box, order, mesh),
                lambda: sk.spread_grid_plain(pos, q, box, order, mesh)),
            "pppm_interpolate": (
                lambda: sk.interpolate_grad(ct, pos, q, box, order, mesh),
                lambda: sk.interpolate_grad_plain(ct, pos, q, box, order,
                                                  mesh)),
            "fused_pre_force": (lambda: fi.pre_force_apply(*pre),
                                lambda: fi.pre_force_apply_plain(*pre)),
            "fused_post_force": (lambda: fi.post_force_apply(*post),
                                 lambda: fi.post_force_apply_plain(*post)),
        })

    if timed:
        for key, (kern, plain) in calls.items():
            out[key]["ms"] = device_ms(torch, kern)
            out[key]["host_call_ms"] = host_call_ms(torch, kern)
            if plain is not None:
                out[key]["plain_ms"] = profiled_device_ms(torch, plain)
                out[key]["plain_host_call_ms"] = host_call_ms(torch, plain)
        counts = (work_counts(torch, snap, ff, pre) if pre is not None
                  else {})
        if cell_key is not None:
            counts[cell_key] = cell_work_counts(
                torch, *cell_args[:4], snap.typeid, snap.charge, ff,
                ff.cell_exclusions, out[cell_key]["grid"]["blocks"])
        for big in big_meshes:
            counts[f"pppm_spread_{big[0]}"] = spread_work(
                pos.element_size(), snap.N, int((q != 0).sum()), big, order)
        for key, (n_bytes, n_ops, *extra) in counts.items():
            out[key]["bound_ms"], out[key]["bound_by"] = bound_ms(n_bytes,
                                                                  n_ops)
            out[key]["bytes"], out[key]["ops"] = n_bytes, n_ops
            if extra:
                out[key]["pairs"] = extra[0]
    for key, r in out.items():
        print(f"phase 2: N={snap.N} {name} {key}: " + ", ".join(
            f"{k}={v!r}" for k, v in r.items()), flush=True)
    return out


def pair_counts(torch, tiles, n, exclusions, typeid, charge, ff, rc2,
                pair_key=None, rows=None):
    """Pair counts over a pair pass's candidate tiles ``(rows, idx_i,
    id_j, dxs, r2)``: (inside the cutoff with both slots real, counted
    (not self, not excluded), in the LJ range, charged). ``pair_key``
    (N,), when given, is the id the self and exclusion tests compare;
    ``rows`` = (row0, n_rows), when given, keeps the i rows of that
    range."""
    tid = torch.cat([typeid.long(), typeid.new_zeros(1).long()])
    q = torch.cat([charge, charge.new_zeros(1)])
    key = torch.arange(n + 1, device=charge.device)
    if pair_key is not None:
        key[:n] = pair_key.long()
    n_near = n_in = n_lj = n_ew = 0
    for _, idx_i, id_j, _, r2 in tiles:
        ki, kj = key[idx_i], key[id_j]
        excl = exclusions[idx_i].long()
        hit = (excl[:, :, None, :] == kj[:, None, :, None]).any(-1)
        real_i = idx_i < n
        if rows is not None:
            real_i = real_i & (idx_i >= rows[0]) & (idx_i < sum(rows))
        near = (real_i[:, :, None] & (id_j < n)[:, None, :]
                & (r2 < rc2))
        inside = near & (ki[:, :, None] != kj[:, None, :]) & ~hit
        ti, tj = tid[idx_i][:, :, None], tid[id_j][:, None, :]
        lj = inside & (ff.lj_eps[ti, tj] != 0) & (r2 < ff.lj_rcut2[ti, tj])
        ew = inside & ((q[idx_i][:, :, None] * q[id_j][:, None, :]) != 0)
        n_near += int(near.sum())
        n_in += int(inside.sum())
        n_lj += int(lj.sum())
        n_ew += int(ew.sum())
    return n_near, n_in, n_lj, n_ew


def cell_work_counts(torch, position, box_L, clist, cfg, typeid, charge, ff,
                     exclusions, n_blocks, pair_key=None, rows=None):
    """(bytes moved, operations, pair counts) of one cell-kernel call on
    this run's inputs, counted cell by cell from the plain twin's tiles
    (block by block; no (N, N) tensor). Bytes: positions, box, typeid,
    charge, the four (T, T) tables, the bucket, neighbour and exclusion
    tables (and the pair keys, when given) in; forces and the energy
    partials of the launch's ``n_blocks`` blocks out. Cells
    whose neighbour rows are all sentinels (a slab's halo cells) count
    nothing. Operations are
    what the pair sum over each cell's deduplicated 27-cell window needs,
    for the pairs these inputs hold: per staged neighbour row (an occupied
    slot of a neighbour cell of an occupied cell) its image shift (3); per
    candidate (both slots occupied) the displacement (3), r^2 (5) and the
    cutoff test (1), and on each axis with fewer than 3 cells, where one
    cell is the image of several offsets, a per-pair minimum image (4: a
    divide, a rint, a multiply and a subtraction); per pair inside the
    cutoff the self test and the exclusion compares (1 + E); per counted
    pair 6 to accumulate the force, 17 more in the LJ range, 20 more (sqrt,
    erfc and exp each counted as one) for a charged pair. ``rows`` =
    (row0, n_rows): a launch with that row range, which needs the work of
    its own i rows only (the cells that hold one stage their window) and
    writes their forces."""
    from cavmd_tpu_torch.ops.neighbor import cell_block_for, cell_tiles

    n, e = position.shape[0], position.element_size()
    C, cap = clist.bucket_idx.shape
    T = ff.lj_eps.shape[0]
    E = exclusions.shape[1]
    occ = (clist.bucket_idx < n).sum(dim=1)
    occ_x = torch.cat([occ, occ.new_zeros(1)])
    window = occ_x[clist.neighbor_cells.long()].sum(dim=1)
    own, n_out = occ, n
    if rows is not None:
        b = clist.bucket_idx
        own = ((b >= rows[0]) & (b < sum(rows)) & (b < n)).sum(dim=1)
        n_out = rows[1]
    n_cand = int((own * window).sum())
    n_staged = int(window[own > 0].sum())
    small_axes = sum(1 for k in cfg.ncells if k < 3)
    n_near, n_in, n_lj, n_ew = pair_counts(
        torch, cell_tiles(position, box_L, clist, cell_block_for(cfg, e)),
        n, exclusions, typeid, charge, ff, cfg.r_cut * cfg.r_cut, pair_key,
        rows)
    n_bytes = (e * (3 * n + 3 + n + 4 * T * T) + 4 * n
               + 4 * (C * cap + 27 * C + (n + 1) * E)
               + (4 * n if pair_key is not None else 0)
               + e * (3 * n_out + 2 * n_blocks))
    n_ops = (3 * n_staged + (9 + 4 * small_axes) * n_cand
             + (1 + E) * n_near + 6 * n_in + 17 * n_lj + 20 * n_ew)
    return n_bytes, n_ops, dict(candidates=n_cand, staged_rows=n_staged,
                                inside_cutoff=n_near, counted=n_in,
                                lj=n_lj, ewald=n_ew)


def stencil_ops(p):
    """Operations of one particle's three order-p stencils: u, floor and
    the Cox-de Boor recursion on each axis."""
    return 3 * (5 + 5 * (p * (p + 1) // 2 - 1))


def spread_work(e, n, n_q, mesh, p):
    """(bytes, operations) of one spread: pos, charge, box in, the mesh
    out; per charged particle its three stencils and p^3 (product, add)
    pairs."""
    n_mesh = mesh[0] * mesh[1] * mesh[2]
    return (e * (3 * n + n + 3 + n_mesh),
            n_q * (stencil_ops(p) + 2 * p ** 3 + p * p))


def work_counts(torch, snap, ff, pre, pair_blocks=None):
    """(bytes moved, operations) of one call of each kernel on this run's
    inputs: each input read once, each output written once; operations as
    the kernel sources do them (sqrt, erfc, exp, floor counted as one), and
    only for the pairs / particles these inputs make it do. The dense pair
    kernel only in dense mode (its count builds (N, N) tensors), with the
    energy partials of ``pair_blocks`` blocks (default: one replica's
    launch)."""
    from cavmd_tpu_torch.core.box import minimum_image
    from cavmd_tpu_torch.ops import pair_kernels as pk

    n, e = snap.N, snap.position.element_size()
    T = ff.lj_eps.shape[0]
    counts = {}
    if ff.pair_mode == "dense":
        pos = snap.position.double()
        dr = minimum_image(pos[:, None, :] - pos[None, :, :],
                           snap.box_L.double())
        r2 = (dr * dr).sum(-1)
        lj, cw = ff.lj_active.bool(), ff.coulomb_active.bool()
        tid = snap.typeid.long()
        rc2 = ff.lj_rcut2.double()[tid[:, None], tid[None, :]]
        in_lj = lj & (r2 < rc2)
        in_cw = cw & (r2 < ff.coulomb_rcut ** 2)
        n_masked = int((lj | cw).sum())
        n_in = int((in_lj | in_cw).sum())
        n_lj, n_cw = int(in_lj.sum()), int(in_cw.sum())
        blocks = pair_blocks or pk.launch_blocks(n)
        # pos, box, typeid, 4 (T, T) tables, charge, two (N, N) uint8
        # masks in; forces and the per-block energy partials out. Per
        # masked pair 18 ops (displacement, min image, r^2, cutoff test);
        # per pair inside a cutoff 6 to accumulate the force, +15 inside
        # the LJ cutoff, +18 inside the Coulomb cutoff
        counts["dense_pair"] = (
            e * (3 * n + 3 + 4 * T * T + n) + 4 * n + 2 * n * n
            + e * (3 * n + 2 * blocks),
            18 * n_masked + 6 * n_in + 15 * n_lj + 18 * n_cw)
    n_q = int((snap.charge != 0).sum())
    n_mesh = ff.pppm_mesh[0] * ff.pppm_mesh[1] * ff.pppm_mesh[2]
    p = ff.pppm_order
    stencil = stencil_ops(p)
    n_mol = int(pre[6].sum())
    return {
        **counts,
        "pppm_spread": spread_work(e, n, n_q, ff.pppm_mesh, p),
        # the mesh cotangent, pos, charge, box in; dE/dr out. Per charged
        # particle: stencils with derivatives and 9 ops per stencil cell
        "pppm_interpolate": (e * (n_mesh + 3 * n + n + 3 + 3 * n),
                             n_q * (2 * stencil + 9 * p ** 3 + 6)),
        # v, pos, f, image, mass, mask (1 B), box, 4 scalars in; v, pos,
        # image, the reservoir delta out. 9 ops per molecular KE term, 13
        # per coordinate update (rescale, kick, drift, rewrap)
        "fused_pre_force": (e * (3 * 3 * n + n + 3 + 4) + 4 * 3 * n + n
                            + e * (2 * 3 * n + 1) + 4 * 3 * n,
                            9 * n_mol + 39 * n + 20),
        # v, f, mass, mask (1 B), 6 scalars in; v and 3 sums out. 9 ops
        # per kick, 9 per KE term, ~30 for the photon's OU step
        "fused_post_force": (e * (2 * 3 * n + n + 6) + n
                             + e * (3 * n + 3),
                             18 * n + 30),
    }


def main_path(torch, pt, fuse, warm=N_WARM, chunks=N_CHUNKS, chunk=CHUNK,
              bound=DRIFT_BOUND_HA):
    """Simulation.run on the reference scene, ``warm`` steps then
    ``chunks`` chunks of ``chunk`` steps, the universe drift held to
    ``bound``; ``fuse`` is passed as ``fuse_integrator`` (None = the
    default: fused on the card)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    snap = reference_scene(pt, 250, 46.0, torch.float32, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    kT = PC.kT_from_kelvin(100.0)
    label = "fused" if fuse is None else "unfused"
    # every count from here on is this run's own: the Simulation's
    # initial force evaluation, the warm-up chunk and the measured window
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, main_methods(pt, kT),
                        dt=PC.fs_to_atomic_units(0.25), seed=7,
                        chunk_size=chunk, fuse_integrator=fuse)
    t0 = time.perf_counter()
    sim.run(n_steps=warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    outs, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(n_steps=chunk)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outs.append(sim.last_obs)
    launches = dict(_cuda.launches)
    n_steps = chunks * chunk
    total = warm + n_steps

    obs = {k: np.concatenate([c[k] for c in outs]) for k in OBS_KEYS}
    for k in OBS_KEYS:
        check(np.all(np.isfinite(obs[k])), f"{label} path: non-finite {k}")
    for name in ("position", "velocity", "forces"):
        t = getattr(sim.state, name)
        check(tuple(t.shape) == (snap.N, 3) and bool(torch.isfinite(t).all()),
              f"{label} path: bad final {name}")
    check(int(obs["timestep"][-1]) == total,
          f"{label} path: timestep {obs['timestep'][-1]}")
    expect = ["dense_pair", "pppm_spread", "pppm_interpolate"]
    if fuse is None:
        expect += ["fused_pre_force", "fused_post_force"]
    else:
        check(launches.get("fused_pre_force", 0) == 0,
              "unfused path launched the fused kernels")
    for kname in expect:
        check(launches.get(kname, 0) >= total,
              f"{label} path: kernel {kname} launched "
              f"{launches.get(kname, 0)} < {total} times")
    U = universe_energy(obs)
    drift = float(np.abs(U - U[0]).max())
    check(drift < bound,
          f"{label} path: universe drift {drift} >= {bound} Ha")
    T_mol = 2.0 * obs["kinetic_molecular"] / (3.0 * (snap.N - 1) * kT) * 100.0
    chunk_rates = [chunk / s for s in chunk_s]
    res = dict(steps=n_steps, seconds=sum(chunk_s),
               steps_per_s=statistics.median(chunk_rates),
               chunk_steps_per_s=chunk_rates, warmup_chunk_s=warm_s,
               universe_drift_ha=drift, universe_first_ha=float(U[0]),
               mean_T_molecular_K=float(T_mol.mean()), launches=launches)
    print(f"phase 3 ({label}): " + ", ".join(
        f"{k}={v!r}" for k, v in res.items()), flush=True)
    return res


def f64_trajectory(torch, pt, phase, n_molecules, box_L, pair_mode=None):
    """20 float64 NVE steps on the card (kernels) against the same steps
    on the CPU (plain twins): positions within TRAJ_TOL_BOHR, image flags
    equal."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import init_state, make_step_fn, run_steps

    out = {}
    for dev in ("cuda", "cpu"):
        snap = reference_scene(pt, n_molecules, box_L, torch.float64,
                               torch.device(dev))
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode=pair_mode)
        methods = pt.resolve_methods(
            snap, (pt.MethodSpec(kind="nve", group="all"),), ff.l_typeid)
        state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=0)
        final, obs = run_steps(make_step_fn(ff, methods), state, 20)
        if "cell_overflow" in obs:
            check(not obs["cell_overflow"].any(),
                  f"phase {phase}: the cell list overflowed")
        out[dev] = final
    err = float((out["cuda"].position.cpu() - out["cpu"].position).abs().max())
    img_ok = bool(torch.equal(out["cuda"].image.cpu(), out["cpu"].image))
    print(f"phase {phase}: f64 NVE 20 steps at N={snap.N} ({ff.pair_mode}"
          f" pair mode), CUDA kernels vs CPU plain: max|dx| = {err!r} bohr "
          f"(bound {TRAJ_TOL_BOHR}), images equal: {img_ok}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"phase {phase} f64 trajectory: max|dx| {err} bohr > "
          f"{TRAJ_TOL_BOHR} or images differ")
    return err


def large_n_path(torch, pt, n_mol, drift_bound, dt_fs=LARGE_DT_FS,
                 pair_mode="cell", phase=6):
    """The large-N main path: build_large_n(n_mol, pair_mode=pair_mode)
    through Simulation.run, one warm-up chunk then LARGE_CHUNKS chunks of
    LARGE_CHUNK steps (the protocol of scripts/bench_large_n.py) at time
    step ``dt_fs``. Checks: no overflow (and no retry), finite
    observables, every kernel of the path launched at least once a step
    (in zcol mode its hull and pair kernels exactly once a step, the
    initial forces included, and the cell kernel never); the
    universe-energy band max(U) - min(U) over the window is held to
    ``drift_bound`` when one is given, else reported."""
    import numpy as np

    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops.cell_kernels import kernel_name

    _cuda.reset_launches()
    t0 = time.perf_counter()
    sim, snap, ff = build_large_n(n_mol, dt_fs=dt_fs, pair_mode=pair_mode)
    cap = ff.cell_cfg.cap
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(n_steps=LARGE_CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunks, chunk_s = [], []
    for _ in range(LARGE_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=LARGE_CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        chunks.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = LARGE_CHUNK * (LARGE_CHUNKS + 1)
    label = f"large-N N={snap.N} dt={dt_fs} fs {pair_mode}"
    obs = {k: np.concatenate([c[k] for c in chunks])
           for k in OBS_KEYS + ("cell_overflow",)}
    check(not obs["cell_overflow"].any() and sim.ff.cell_cfg.cap == cap,
          f"{label}: the cell list overflowed")
    for k in OBS_KEYS:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    check(bool(torch.isfinite(sim.state.position).all()),
          f"{label}: non-finite positions")
    pair_kernel = ("zcol_pair" if pair_mode == "zcol"
                   else kernel_name(ff.cell_cfg))
    if pair_mode == "zcol":
        check(launches.get("zcol_pair", 0) == total + 1
              and launches.get("zcol_hull", 0) == total + 1
              and launches.get("cell_pair", 0) == 0,
              f"{label}: zcol_pair launched {launches.get('zcol_pair', 0)} "
              f"times, zcol_hull {launches.get('zcol_hull', 0)} (want "
              f"{total + 1} each), cell_pair "
              f"{launches.get('cell_pair', 0)}")
    kernels = [pair_kernel, "pppm_spread", "pppm_interpolate",
               "fused_pre_force", "fused_post_force"]
    if pair_mode == "zcol":
        kernels.append("zcol_hull")
    for kname in kernels:
        check(launches.get(kname, 0) >= total,
              f"{label}: kernel {kname} launched {launches.get(kname, 0)} "
              f"< {total} times")
    U = universe_energy(obs)
    band = float(U.max() - U.min())
    if drift_bound is not None:
        check(band < drift_bound,
              f"{label}: universe band {band} >= {drift_bound} Ha")
    ms = [s / LARGE_CHUNK * 1e3 for s in chunk_s]
    res = dict(n=snap.N, dt_fs=dt_fs, pair_mode=pair_mode,
               ncells=ff.cell_cfg.ncells, cap=cap, zcol_W=ff.zcol_W,
               steps=LARGE_CHUNK * LARGE_CHUNKS,
               ms_per_step=statistics.median(ms), chunk_ms_per_step=ms,
               setup_s=setup_s, warmup_chunk_s=warm_s,
               universe_band_ha=band, band_bound_ha=drift_bound,
               launches=launches)
    print(f"phase {phase} ({label}): " + ", ".join(
        f"{k}={v!r}" for k, v in res.items()), flush=True)
    return res


def small_grid_path(torch, pt):
    """The cell pass on a grid with < 3 cells per axis (the K8 grid): the
    N = 501 reference scene with pair_mode='cell' (2^3 cells, the
    deduplicated neighbour table) through Simulation.run on SHORT_RUN, the
    prefix of phase 3's protocol that phase 3's unfused run takes, its
    universe drift held to that prefix's bound SHORT_DRIFT_BOUND_HA (the
    JAX package's reading on the same scene, seed and steps)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda

    snap = reference_scene(pt, 250, 46.0, torch.float32,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    check(min(ff.cell_cfg.ncells) < 3, "small-grid path: not a small grid")
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, main_methods(pt, PC.kT_from_kelvin(100.0)),
                        dt=PC.fs_to_atomic_units(0.25), seed=7,
                        chunk_size=CHUNK)
    warm, n_chunks, chunk = SHORT_RUN
    sim.run(n_steps=warm)
    chunks, chunk_s = [], []
    for _ in range(n_chunks):
        t0 = time.perf_counter()
        sim.run(n_steps=chunk)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        chunks.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = warm + n_chunks * chunk
    obs = {k: np.concatenate([c[k] for c in chunks])
           for k in OBS_KEYS + ("cell_overflow",)}
    check(not obs["cell_overflow"].any(), "small-grid path: overflow")
    for k in OBS_KEYS:
        check(bool(np.all(np.isfinite(obs[k]))),
              f"small-grid path: non-finite {k}")
    for kname in ("cell_pair_small_grid", "pppm_spread", "fused_pre_force"):
        check(launches.get(kname, 0) >= total,
              f"small-grid path: kernel {kname} launched "
              f"{launches.get(kname, 0)} < {total} times")
    U = universe_energy(obs)
    drift = float(np.abs(U - U[0]).max())
    check(drift < SHORT_DRIFT_BOUND_HA,
          f"small-grid path: universe drift {drift} >= "
          f"{SHORT_DRIFT_BOUND_HA} Ha")
    res = dict(n=snap.N, ncells=ff.cell_cfg.ncells, cap=ff.cell_cfg.cap,
               steps=n_chunks * chunk,
               steps_per_s=statistics.median(chunk / t for t in chunk_s),
               universe_drift_ha=drift, launches=launches)
    print("phase 6 (small grid, N=501 cell mode): " + ", ".join(
        f"{k}={v!r}" for k, v in res.items()), flush=True)
    return res


def slab_kernel_phase(torch, pt, dtype, timed):
    """Phase 9: the slab tile kernel (``cell_pair_slab``) against its
    plain twin on the first chunk's extended grid of one slab at
    N = 100,001; in float32 also its device time, host-bound time, the
    twin's device time and the bound, counted on the extended grid."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import init_state
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.parallel import domain as dm

    snap = reference_scene(pt, LARGE_N_MOL, reference_box_for(LARGE_N_MOL),
                           dtype, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    plan = dm.plan_domain(snap, ff, 1)
    state = init_state(snap, ff, dt=1.0)
    args, cells, key = dm.tile_pass_inputs(ff, plan, state)
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    k = ck.cell_pair_force_slab(*args, cells, key)
    again = ck.cell_pair_force_slab(*args, cells, key)
    p = ck.cell_pair_force_fused_plain(*args, pair_key=key)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(k, again)),
          f"cell_pair_slab N={snap.N} {name}: two calls on the same inputs "
          "differ")
    errs = [max_err(a, b) for a, b in zip(k, p)]
    for (err, scale), a in zip(errs, k):
        check(bool(torch.isfinite(a).all()),
              f"cell_pair_slab N={snap.N} {name}: non-finite output")
        check(err <= tol * max(scale, 1e-300),
              f"cell_pair_slab N={snap.N} {name}: max|dF,E| {err} > "
              f"{tol}*{scale}")
    blocks = ck.launch_blocks(cells[1], plan.cap, snap.device)
    out = dict(max_abs_err=errs[0][0], scale=errs[0][1],
               max_abs_err_other_outputs=[e for e, _ in errs[1:]],
               bit_equal_calls=True,
               grid=dict(ncells=args[3].ncells, cap=plan.cap,
                         own_cells=cells, rows=plan.Mtot, blocks=blocks))
    if timed:
        out["ms"] = device_ms(torch, lambda: ck.cell_pair_force_slab(
            *args, cells, key))
        out["host_call_ms"] = host_call_ms(
            torch, lambda: ck.cell_pair_force_slab(*args, cells, key))
        out["plain_ms"] = profiled_device_ms(
            torch, lambda: ck.cell_pair_force_fused_plain(*args,
                                                          pair_key=key))
        n_bytes, n_ops, pairs = cell_work_counts(
            torch, *args[:6], ff, args[10], blocks, pair_key=key)
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
        out.update(bytes=n_bytes, ops=n_ops, pairs=pairs)
    print(f"phase 9: N={snap.N} {name} cell_pair_slab: " + ", ".join(
        f"{k}={v!r}" for k, v in out.items()), flush=True)
    return out


def domain_f64_trajectory(torch, pt):
    """Phase 9: DOMAIN_F64_STEPS float64 steps of the domain runner at one
    slab (the Simulation's cadence) against the unsharded runner,
    both on the card, Bussi + Langevin with the same draws (each state's
    own generators, seeded alike): positions within TRAJ_TOL_BOHR, image
    flags equal, no overflow, the slab kernel launched every step."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import init_state, make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import make_domain_runner, plan_domain
    from cavmd_tpu_torch.simulation import DOMAIN_REBUILD_EVERY

    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           torch.float64, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    methods = pt.resolve_methods(
        snap, main_methods(pt, PC.kT_from_kelvin(100.0)), ff.l_typeid)
    dt = PC.fs_to_atomic_units(LARGE_DT_FS)
    ref, _ = run_steps(make_step_fn(ff, methods),
                       init_state(snap, ff, dt=dt, seed=7), DOMAIN_F64_STEPS)
    run = make_domain_runner(ff, methods, plan_domain(snap, ff, 1),
                             rebuild_every=DOMAIN_REBUILD_EVERY)
    start = init_state(snap, ff, dt=dt, seed=7).replace(cell_list=None,
                                                         cell_anchor=None)
    _cuda.reset_launches()
    fin, obs = run(start, DOMAIN_F64_STEPS)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    err = float((fin.position - ref.position).abs().max())
    img_ok = bool(torch.equal(fin.image, ref.image))
    print(f"phase 9: f64 Bussi + Langevin {DOMAIN_F64_STEPS} steps at "
          f"N={snap.N}, domain (1 slab, rebuilt every "
          f"{DOMAIN_REBUILD_EVERY}) vs "
          f"unsharded on the card: max|dx| = {err!r} bohr (bound "
          f"{TRAJ_TOL_BOHR}), images equal: {img_ok}, launches {launches}",
          flush=True)
    check(not obs["cell_overflow"].any(), "phase 9 f64: overflow")
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"phase 9 f64 domain trajectory: max|dx| {err} bohr > "
          f"{TRAJ_TOL_BOHR} or images differ")
    for kname in ("cell_pair_slab", "pppm_spread", "pppm_interpolate"):
        check(launches.get(kname, 0) >= DOMAIN_F64_STEPS,
              f"phase 9 f64: kernel {kname} launched "
              f"{launches.get(kname, 0)} < {DOMAIN_F64_STEPS} times")
    return err


def domain_large_path(torch, pt, unsharded):
    """Phase 9: the scene of build_large_n(LARGE_N_MOL) through
    ``Simulation(shard_atoms=1)`` (the slab pipeline in this process,
    rebuilt every 20 steps) on phase 6's protocol (one warm-up
    chunk, then LARGE_CHUNKS chunks of LARGE_CHUNK steps): no overflow and
    no retry, finite observables, the slab kernel and K2/K3 launched every
    step, ms per step; the universe band held to DOMAIN_BAND_RATIO times
    phase 6's (``unsharded``)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.simulation import DOMAIN_REBUILD_EVERY

    _, snap, ff = build_large_n(LARGE_N_MOL)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    sim = pt.Simulation(snap, ff, main_methods(pt, PC.kT_from_kelvin(100.0)),
                        dt=PC.fs_to_atomic_units(LARGE_DT_FS), seed=7,
                        shard_atoms=1)
    plan = sim._domain_plan
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim.run(n_steps=LARGE_CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    chunks, chunk_s = [], []
    for _ in range(LARGE_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=LARGE_CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        chunks.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = LARGE_CHUNK * (LARGE_CHUNKS + 1)
    label = f"phase 9 domain N={snap.N}"
    obs = {k: np.concatenate([c[k] for c in chunks])
           for k in OBS_KEYS + ("cell_overflow",)}
    check(not obs["cell_overflow"].any() and sim._domain_plan == plan
          and sim._domain_rebuild_every == DOMAIN_REBUILD_EVERY,
          f"{label}: overflow or retry")
    for k in OBS_KEYS:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    check(bool(torch.isfinite(sim.state.position).all()),
          f"{label}: non-finite positions")
    for kname in ("cell_pair_slab", "pppm_spread", "pppm_interpolate"):
        check(launches.get(kname, 0) >= total,
              f"{label}: kernel {kname} launched {launches.get(kname, 0)} "
              f"< {total} times")
    U = universe_energy(obs)
    band = float(U.max() - U.min())
    bound = DOMAIN_BAND_RATIO * unsharded["universe_band_ha"]
    check(band < bound, f"{label}: universe band {band} >= {bound} Ha")
    ms = [t / LARGE_CHUNK * 1e3 for t in chunk_s]
    res = dict(n=snap.N, ncells=plan.ncells, cap=plan.cap, Mrow=plan.Mrow,
               rebuild_every=DOMAIN_REBUILD_EVERY,
               steps=LARGE_CHUNK * LARGE_CHUNKS,
               ms_per_step=statistics.median(ms), chunk_ms_per_step=ms,
               unsharded_ms_per_step=unsharded["ms_per_step"],
               setup_s=setup_s, warmup_chunk_s=warm_s,
               universe_band_ha=band, band_bound_ha=bound,
               launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def zcol_work_counts(torch, pos_loc, box_L, clist, cfg, hull, W, typeid,
                     charge, ff, rows=None):
    """(bytes moved, operations, pair counts) of one zcol-kernel call on
    this run's inputs. Bytes: positions, anchors and local anchors, box,
    typeid, charge, the four (T, T) tables, the bucket, halo and exclusion
    tables in; forces and the energy partials of one block per i-block
    out. Operations: the local coordinates (4 a coordinate) and the hull
    (2 per slot for the block bounds, 12 per i-block x j-block overlap
    test), then what the pair sum over each i-block's visited hull blocks
    needs, counted as ``cell_work_counts`` counts it: per staged row (a
    real slot of a visited block) its image shift (3); per candidate (a
    real i slot against a staged row) the displacement, r^2 and the cutoff
    test (9); per pair inside the cutoff the self and exclusion tests
    (1 + E); per counted pair 6, 17 more in the LJ range, 20 more for a
    charged pair (the pairs counted i-block by i-block from the plain
    twin's tiles). ``rows`` = (row0, n_rows): a launch with that row range
    (the hull as without one), which needs the pair work of its own i rows
    only (the i-blocks that hold one stage their visited blocks) and
    writes their forces."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    n, e = pos_loc.shape[0], pos_loc.element_size()
    XY, Kc = clist.bucket_idx.shape
    NB = clist.halo_idx.shape[1] // zk.J_BLOCK
    NIB = Kc // zk.I_BLOCK
    T = ff.lj_eps.shape[0]
    E = ff.cell_exclusions.shape[1]
    # staged rows of each i-block: the real slots of its visited blocks
    # (a halo row's real slots are its prefix)
    real = (clist.halo_idx < n).sum(dim=1)[:, None, None]
    t = torch.arange(W, device=pos_loc.device)
    s1, c1, s2, cnt = (h.long()[..., None] for h in hull.unbind(-1))
    jb = torch.where(t < c1, s1 + t, s2 + (t - c1))
    in_block = torch.clamp(real - jb * zk.J_BLOCK, 0, zk.J_BLOCK)
    staged = torch.where(t < cnt, in_block, 0).sum(dim=-1)
    b = clist.bucket_idx.view(XY, NIB, zk.I_BLOCK)
    r0, r_end, n_out = 0, n, n
    if rows is not None:
        r0, r_end, n_out = rows[0], rows[0] + rows[1], rows[1]
    real_i = ((b >= r0) & (b < r_end)).sum(dim=-1)
    n_staged = int(staged[real_i > 0].sum())
    n_cand = int((real_i * staged).sum())
    n_near, n_in, n_lj, n_ew = pair_counts(
        torch, zk.zcol_tiles(pos_loc, box_L, clist, hull, W,
                             zk.rows_per_block(W, e)),
        n, ff.cell_exclusions, typeid, charge, ff, cfg.r_cut * cfg.r_cut,
        rows=rows)
    n_bytes = (e * (9 * n + 3 + n + 4 * T * T) + 4 * n
               + 4 * (XY * Kc + 9 * XY * Kc + (n + 1) * E)
               + e * (3 * n_out + 2 * XY * NIB))
    n_ops = (12 * n + 2 * 10 * XY * Kc + 12 * XY * NIB * NB
             + 3 * n_staged + 9 * n_cand + (1 + E) * n_near + 6 * n_in
             + 17 * n_lj + 20 * n_ew)
    return n_bytes, n_ops, dict(candidates=n_cand, staged_rows=n_staged,
                                inside_cutoff=n_near, counted=n_in,
                                lj=n_lj, ewald=n_ew)


def zcol_hull_plain(torch, zk, position, box_L, clist, cfg, charge, W):
    """Plain version of the hull kernel's launch: the twins' hull, flag
    and window (``zcol_local_positions``, then ``zcol_hull``) and the
    (N, 4) table of local coordinates and charge."""
    pos_loc = zk.zcol_local_positions(position, box_L, clist)
    hull, flag, W = zk.zcol_hull(pos_loc, box_L, clist, cfg, W)
    return hull, flag, W, torch.cat([pos_loc, charge[:, None]], dim=1)


def zcol_hull_work_counts(torch, pos_loc, clist):
    """(bytes moved, operations) of one hull-kernel call: the positions,
    anchors, local anchors and charges, the bucket and halo tables in;
    the hull, the per-column flags and the (N, 4) table of local
    coordinates and charge out. Operations: the local coordinates (4 a
    coordinate), 2 per slot for the block bounds, 12 per i-block x
    j-block overlap test (as ``zcol_work_counts`` counts the hull)."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    n, e = pos_loc.shape[0], pos_loc.element_size()
    XY, Kc = clist.bucket_idx.shape
    NB = clist.halo_idx.shape[1] // zk.J_BLOCK
    NIB = Kc // zk.I_BLOCK
    n_bytes = (9 * e * n + e * n + 4 * 10 * XY * Kc
               + 16 * XY * NIB + XY + 4 * e * n)
    n_ops = 12 * n + 2 * 10 * XY * Kc + 12 * XY * NIB * NB
    return n_bytes, n_ops


def zcol_pruned_candidates(torch, pos_loc, box_L, clist, cfg, hull, W):
    """An estimate, in PyTorch, of the candidates the zcol kernel
    evaluates after its z-chunk pruning (the kernel counts nothing): for
    each real i slot, the staged rows of the chunks (32 rows of one visited
    block) whose periodic z distance to the row is within the chunk's
    half-length plus r_cut plus Lz / 4096, the kernel's rule, evaluated
    here in float64 from the same local coordinates; the kernel's own
    working-dtype compares may keep a chunk more or less at the edge."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    n = pos_loc.shape[0]
    XY, Kc = clist.bucket_idx.shape
    NB = clist.halo_idx.shape[1] // zk.J_BLOCK
    dev = pos_loc.device
    z = torch.cat([pos_loc[:, 2].double(), pos_loc.new_zeros(1).double()])
    t = torch.arange(W, device=dev)
    s1, c1, s2, cnt = (h.long()[..., None] for h in hull.unbind(-1))
    jb = torch.where(t < c1, s1 + t, s2 + (t - c1))
    jb = torch.where(t < cnt, jb, NB)  # NB: the all-empty block
    halo = torch.cat([clist.halo_idx.view(XY, NB, zk.J_BLOCK),
                      clist.halo_idx.new_full((XY, 1, zk.J_BLOCK), n)], 1)
    cols = torch.arange(XY, device=dev)[:, None, None]
    ids = halo[cols, jb].long().view(XY, Kc // zk.I_BLOCK, 4 * W, 32)
    real = ids < n
    zc = z[ids]
    zmin = torch.where(real, zc, float("inf")).amin(-1)
    zmax = torch.where(real, zc, float("-inf")).amax(-1)
    rows = real.sum(-1)
    Lz = float(box_L[2])
    reach = 0.5 * (zmax - zmin) + cfg.r_cut + Lz / 4096
    idx_i = clist.bucket_idx.view(XY, Kc // zk.I_BLOCK, zk.I_BLOCK).long()
    zi = z[idx_i]
    d = zi[..., :, None] - 0.5 * (zmin + zmax)[..., None, :]
    d = (d - Lz * torch.round(d / Lz)).abs()
    live = (d <= reach[..., None, :]) & (rows > 0)[..., None, :] \
        & (idx_i < n)[..., None]
    return int((live * rows[..., None, :]).sum())


def zcol_kernel_phase(torch, pt, dtype, timed):
    """Phase 10: the zcol kernels against their plain twins on the column
    list of build_large_n(50_000, pair_mode='zcol')'s scene at its start
    (the first chunk's list), N = 100,001: the hull kernel's hull and flag
    bit-equal to the twins' (at the build positions, at W = 1 where the
    flag is set, and after a drift of 0.49 skin with the list kept), the
    pair pass within TOL of its twin, two calls bit-equal; in float32 also
    the wrapper's device time, the pair and hull kernels' own device
    times, the host-bound time, the twins' device times, the bounds, the
    list build's device time, the candidate counts before and after the
    kernel's pruning, and the hull statistics."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    snap = reference_scene(pt, LARGE_N_MOL, reference_box_for(LARGE_N_MOL),
                           dtype, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="zcol")
    cfg = ff.cell_cfg
    pos, box = snap.position, snap.box_L
    clist = ff.build_cells(pos, box)
    check(not bool(clist.overflow), f"zcol list N={snap.N} overflowed")
    name = str(dtype).replace("torch.", "")
    g = torch.Generator(device="cpu")
    g.manual_seed(11)
    step = torch.rand((snap.N, 3), generator=g, dtype=torch.float64) * 2 - 1
    step = (0.49 * cfg.skin / step.abs().max() * step).to(pos)
    drifted = pos + step
    drifted = drifted - box * torch.round(drifted / box)
    hull_err = 0
    slotted = clist.bucket_idx[clist.bucket_idx < snap.N].long()
    for label, p_, W_ in (("build", pos, ff.zcol_W), ("W=1", pos, 1),
                          ("drift 0.49 skin", drifted, ff.zcol_W)):
        hk, flags, loc, Wk = zk._launch_hull(p_, box, clist, cfg,
                                             snap.charge, W_)
        fk = flags.any()
        ht, ft, Wt, loc_t = zcol_hull_plain(torch, zk, p_, box, clist, cfg,
                                            snap.charge, W_)
        same_loc = bool(torch.equal(loc[slotted], loc_t[slotted]))
        same = bool(torch.equal(hk, ht)) and bool(fk) == bool(ft) \
            and Wk == Wt and same_loc
        hull_err = max(hull_err, int((hk - ht).abs().max()))
        print(f"phase 10: N={snap.N} {name} zcol_hull ({label}): hull, "
              f"flag and table bit-equal to the twins': {same}, flag "
              f"{bool(fk)}, hulls differing "
              f"{int((hk != ht).any(-1).sum())}, table rows differing "
              f"{int((loc[slotted] != loc_t[slotted]).any(-1).sum())} of "
              f"{slotted.numel()}", flush=True)
        check(same, f"zcol_hull N={snap.N} {name} {label}: the hull kernel "
              f"differs from the twins")
        check(W_ != 1 or bool(fk), f"zcol_hull N={snap.N} {name} {label}: "
              f"the window flag is not set")
    args = (pos, box, clist, cfg, snap.typeid, snap.charge, ff.lj_eps,
            ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift, ff.cell_exclusions,
            ff.kappa_value, ff.zcol_W)
    tol = TOL[name]
    k = zk.zcol_pair_force(*args)
    again = zk.zcol_pair_force(*args)
    p = zk.zcol_pair_force_plain(*args)
    torch.cuda.synchronize()
    check(not bool(k[3]) and not bool(p[3]),
          f"zcol_pair N={snap.N} {name}: the window overflowed")
    check(all(bool(torch.equal(a, b)) for a, b in zip(k, again)),
          f"zcol_pair N={snap.N} {name}: two calls differ")
    errs = [max_err(a, b) for a, b in zip(k[:3], p[:3])]
    for (err, scale), a in zip(errs, k[:3]):
        check(bool(torch.isfinite(a).all()),
              f"zcol_pair N={snap.N} {name}: non-finite output")
        check(err <= tol * max(scale, 1e-300),
              f"zcol_pair N={snap.N} {name}: max|dF,E| {err} > "
              f"{tol}*{scale}")
    pos_loc = zk.zcol_local_positions(pos, box, clist)
    hull, _, W = zk.zcol_hull(pos_loc, box, clist, cfg, ff.zcol_W)
    live = hull[..., 1] > 0
    cnt = hull[..., 3][live].double()
    occ = (clist.bucket_idx < snap.N).sum(dim=1).double()
    out = dict(max_abs_err=errs[0][0], scale=errs[0][1],
               max_abs_err_other_outputs=[e for e, _ in errs[1:]],
               bit_equal_calls=True, hull_max_abs_err=hull_err,
               grid=dict(columns=cfg.ncells[:2], cap=cfg.cap, W=W,
                         occupancy_mean=float(occ.mean()),
                         occupancy_max=int(occ.max()),
                         iblocks=int(hull.shape[0] * hull.shape[1]),
                         iblocks_live=int(live.sum()),
                         count_mean=float(cnt.mean()),
                         count_max=int(cnt.max()),
                         two_run_iblocks=int((hull[..., 2] < 9 * cfg.cap
                                              // zk.J_BLOCK).sum())))
    if timed:
        # the twins and the list build each issue tens of launches a call:
        # one call per sample keeps them inside the launch queue behind the
        # spin (ten would fill it, and the host would wait)
        one = dict(inner=1)
        # the whole wrapper (both kernels and its three PyTorch
        # operations), then each kernel's own time in the wrapper's trace
        out["ms"] = device_ms(torch, lambda: zk.zcol_pair_force(*args))
        out["kernel_only_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force(*args),
            match="zcol_pair_kernel")
        out["hull_kernel_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force(*args),
            match="zcol_hull_kernel")
        out["host_call_ms"] = host_call_ms(
            torch, lambda: zk.zcol_pair_force(*args))
        out["plain_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force_plain(*args))
        # the wrapper's hull launch alone (one kernel), and its plain
        # version: the twins' hull, which the parent's wrapper ran, and
        # the table
        out["hull_ms"] = device_ms(torch, lambda: zk._launch_hull(
            pos, box, clist, cfg, snap.charge, ff.zcol_W))
        out["hull_plain_ms"] = device_ms(torch, lambda: zcol_hull_plain(
            torch, zk, pos, box, clist, cfg, snap.charge, ff.zcol_W), **one)
        out["list_build_ms"] = device_ms(
            torch, lambda: ff.build_cells(pos, box), **one)
        n_bytes, n_ops, pairs = zcol_work_counts(
            torch, pos_loc, box, clist, cfg, hull, W, snap.typeid,
            snap.charge, ff)
        pairs["candidates_after_pruning_est"] = zcol_pruned_candidates(
            torch, pos_loc, box, clist, cfg, hull, W)
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
        out.update(bytes=n_bytes, ops=n_ops, pairs=pairs)
        h_bytes, h_ops = zcol_hull_work_counts(torch, pos_loc, clist)
        out["hull_bound_ms"], out["hull_bound_by"] = bound_ms(h_bytes, h_ops)
        out.update(hull_bytes=h_bytes, hull_ops=h_ops)
    print(f"phase 10: N={snap.N} {name} zcol_pair: " + ", ".join(
        f"{k}={v!r}" for k, v in out.items()), flush=True)
    return out


def zcol_f64_trajectory(torch, pt):
    """Phase 10: ZCOL_F64_STEPS float64 Bussi + Langevin steps in zcol mode
    against cell mode, both on the card, same draws (each state's own
    generators, seeded alike), at N = 20,001: positions within
    TRAJ_TOL_BOHR, image flags equal, no overflow, the zcol kernel
    launched every step, and the carried column list rebuilt (its anchor
    moved)."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import init_state, make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda

    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           torch.float64, torch.device("cuda"))
    dt = PC.fs_to_atomic_units(ZCOL_F64_DT_FS)
    finals, launches = {}, {}
    for mode in ("cell", "zcol"):
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode=mode)
        methods = pt.resolve_methods(
            snap, main_methods(pt, PC.kT_from_kelvin(100.0)), ff.l_typeid)
        start = init_state(snap, ff, dt=dt, seed=7)
        _cuda.reset_launches()
        final, obs = run_steps(make_step_fn(ff, methods), start,
                               ZCOL_F64_STEPS)
        torch.cuda.synchronize()
        launches[mode] = dict(_cuda.launches)
        check(not obs["cell_overflow"].any(), f"phase 10 f64 {mode}: overflow")
        finals[mode] = final
    z = finals["zcol"]
    rebuilt = not bool(torch.equal(z.cell_anchor, snap.position))
    err = float((z.position - finals["cell"].position).abs().max())
    img_ok = bool(torch.equal(z.image, finals["cell"].image))
    print(f"phase 10: f64 Bussi + Langevin {ZCOL_F64_STEPS} steps of "
          f"{ZCOL_F64_DT_FS} fs at N={snap.N}, zcol vs cell mode on the "
          f"card: max|dx| = {err!r} bohr (bound {TRAJ_TOL_BOHR}), images "
          f"equal: {img_ok}, column list rebuilt: {rebuilt}, launches "
          f"{launches['zcol']}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"phase 10 f64 zcol trajectory: max|dx| {err} bohr > "
          f"{TRAJ_TOL_BOHR} or images differ")
    check(rebuilt, "phase 10 f64: the column list was never rebuilt")
    check(launches["zcol"].get("zcol_pair", 0) == ZCOL_F64_STEPS
          and launches["zcol"].get("cell_pair", 0) == 0,
          f"phase 10 f64: launches {launches['zcol']}")
    return err


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cli_phase(torch, pt, phase, args, n_particles, energy_period_steps,
              kernels, drift_bound):
    """The advanced_run CLI in this process, in a temporary directory:
    exit code, output files and their header lines, the last GSD frame
    (``n_particles``, finite), launches of ``kernels`` per step, and the
    universe column's max |U - U0|, held to ``drift_bound`` when one is
    given, else reported."""
    import numpy as np

    from cavmd_tpu_torch.drivers import advanced_run
    from cavmd_tpu_torch.io import open_gsd
    from cavmd_tpu_torch.ops import _cuda

    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="cavmd_cli_")
    tee = _Tee(sys.stdout)
    label = f"phase {phase} CLI N={n_particles}"
    try:
        os.chdir(work)
        _cuda.reset_launches()
        with contextlib.redirect_stdout(tee):
            rc = advanced_run.main(args)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        check(rc == 0, f"{label}: exited with {rc}")
        log = tee.buf.getvalue()
        m = re.search(r"Completed (\d+) steps, ([0-9.]+) ps in ([0-9.]+) s",
                      log)
        check(m is not None, f"{label}: no 'Completed ... steps' line")
        steps, sim_ps, wall = int(m.group(1)), float(m.group(2)), float(
            m.group(3))
        out_dir = os.path.join(work, "cavity_coupling_1eneg03")
        headers = dict(CLI_HEADERS)
        headers["prod-1_energy_tracker.txt"] = [
            f"# Output period: {energy_period_steps} steps" if k == 1 else h
            for k, h in enumerate(CLI_HEADERS["prod-1_energy_tracker.txt"])]
        headers["prod-1_cavity_mode.txt"] = [
            f"# Output period: {energy_period_steps} steps" if k == 1 else h
            for k, h in enumerate(CLI_HEADERS["prod-1_cavity_mode.txt"])]
        for fname, header in headers.items():
            path = os.path.join(out_dir, fname)
            check(os.path.isfile(path), f"{label}: {fname} missing")
            with open(path) as f:
                lines = f.read().splitlines()
            for k, want in enumerate(header):
                got = lines[k] if k < len(lines) else "<missing>"
                ok = (got.startswith("# Reference 0 at t=") if want is None
                      else got == want)
                check(ok, f"{label}: {fname} header line {k}: {got!r}")
        gsd = os.path.join(out_dir, "prod-1.gsd")
        check(os.path.isfile(gsd), f"{label}: prod-1.gsd missing")
        with open_gsd(gsd) as t:
            frame = t.read_frame(len(t) - 1, device="cuda")
            check(frame.N == n_particles and bool(
                torch.isfinite(frame.position).all()),
                  f"{label}: GSD frame has N={frame.N}")
            n_frames = len(t)
        for kname in kernels:
            check(launches.get(kname, 0) >= steps,
                  f"{label}: kernel {kname} launched "
                  f"{launches.get(kname, 0)} < {steps} times")
        rows = np.loadtxt(os.path.join(out_dir, "prod-1_energy_tracker.txt"),
                          comments=("#", "time"), ndmin=2)
        check(rows.shape[0] >= 3 and rows.shape[1] == 20,
              f"{label}: energy tracker rows {rows.shape}")
        check(bool(np.isfinite(rows).all()), f"{label}: non-finite rows")
        uni = rows[:, 18]
        drift = float(np.abs(uni - uni[0]).max())
        if drift_bound is not None:
            check(drift < drift_bound,
                  f"{label}: universe drift {drift} >= {drift_bound} Ha")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    res = dict(steps=steps, simulated_ps=sim_ps, run_seconds=wall,
               steps_per_s=steps / wall,
               ns_per_day=sim_ps / 1000.0 / wall * 86400.0,
               universe_drift_ha=drift, drift_bound_ha=drift_bound,
               universe_ha=uni.tolist(), energy_rows=int(rows.shape[0]),
               gsd_frames=n_frames, launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


# --------------------------------------------------------------- phase 11
# which arguments of each batched kernel's call carry the replica axis
REPLICA_ARGS = {"dense_pair": (0,), "pppm_spread": (0,),
                "pppm_interpolate": (0, 1),
                "fused_pre_force": (1, 2, 3, 4, 8, 9, 11, 12),
                "fused_post_force": (1, 2, 5, 6, 7, 8)}


def jitter_rows(torch, x, B, scale, seed):
    """B copies of ``x`` with seeded normal jitter of ``scale``, (B, ...)."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    return (x[None] + scale * torch.randn(
        (B,) + tuple(x.shape), generator=g, dtype=x.dtype, device=x.device)
    ).contiguous()


def replica_row(args, r, key):
    """The one-replica call of kernel ``key`` on replica r's rows."""
    return tuple(a[r].contiguous() if i in REPLICA_ARGS[key] else a
                 for i, a in enumerate(args))


def replica_inputs(torch, pt, B, dtype):
    """Phase 11's batched kernel inputs on the N = 501 scene: B replicas'
    positions jittered 0.3 bohr apart with K1's tables and masks and K2's
    mesh; K3's cotangent, the gradient of the B mesh energies at the
    twin's grids; K4's and K5's inputs of ``integrator_inputs`` with each
    replica's positions, velocities and forces jittered and its own dt and
    draws. Returns (scene, ForceField, {kernel: its call's arguments})."""
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.ops.pppm import mesh_energy

    dev = torch.device("cuda")
    snap = reference_scene(pt, 250, 46.0, dtype, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    P = jitter_rows(torch, snap.position, B, 0.3, 1)
    spread = (P, snap.charge, snap.box_L, ff.pppm_order, ff.pppm_mesh)
    grid = sk.spread_grid_plain(*spread).detach().requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, ff.pppm).sum(), grid)
    pre, _ = integrator_inputs(torch, pt, snap, ff)
    plan, kT, mass, mol = pre[0], pre[10], pre[5], pre[6]
    g = torch.Generator(device=dev)
    g.manual_seed(12)

    def per(x):
        return x * (0.9 + 0.2 * torch.rand(B, generator=g, dtype=dtype,
                                           device=dev))

    dts = per(pre[8])
    V = jitter_rows(torch, pre[3], B, 1e-4, 2)
    F = jitter_rows(torch, pre[4], B, 1e-4, 3)
    c_ou = torch.exp(-plan.langevin.gamma * dts)
    return snap, ff, {
        "dense_pair": (P, snap.box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
                       ff.lj_rcut2, ff.lj_vshift, snap.charge, ff.lj_active,
                       ff.coulomb_active, ff.kappa_value,
                       ff.coulomb_rcut ** 2),
        "pppm_spread": spread,
        "pppm_interpolate": (ct.contiguous(),) + spread,
        "fused_pre_force": (
            plan, jitter_rows(torch, pre[1], B, 1e-5, 4),
            pre[2][None].expand(B, -1, -1).contiguous(), V, F, mass, mol,
            pre[7], dts, torch.exp(-dts / plan.bussi.tau), kT,
            torch.randn(B, generator=g, dtype=dtype, device=dev),
            per(pre[12])),
        "fused_post_force": (
            plan, V, F, mass, mol, dts, c_ou,
            torch.sqrt((1.0 - c_ou * c_ou) * kT / mass[plan.photon]),
            torch.randn((B, 1, 3), generator=g, dtype=dtype, device=dev)),
    }


def replica_calls():
    """{kernel: (wrapper, plain twin)} of the five batched kernels."""
    from cavmd_tpu_torch.ops import fused_integrator as fi
    from cavmd_tpu_torch.ops import pair_kernels as pk
    from cavmd_tpu_torch.ops import pppm_kernels as sk

    return {"dense_pair": (pk.dense_pair_force, pk.dense_pair_force_plain),
            "pppm_spread": (sk.spread_grid, sk.spread_grid_plain),
            "pppm_interpolate": (sk.interpolate_grad,
                                 sk.interpolate_grad_plain),
            "fused_pre_force": (fi.pre_force_apply,
                                fi.pre_force_apply_plain),
            "fused_post_force": (fi.post_force_apply,
                                 fi.post_force_apply_plain)}


def replica_work_counts(torch, snap, ff, inputs, B):
    """(bytes, operations) of each batched call: the one-replica counts of
    ``work_counts`` on each replica's positions, summed, with the inputs
    the replicas share (tables, masks, charges, masses, the box) counted
    once."""
    from cavmd_tpu_torch.ops import pair_kernels as pk

    n, e = snap.N, snap.position.element_size()
    T = ff.lj_eps.shape[0]
    shared = {"dense_pair": e * (3 + 4 * T * T + n) + 4 * n + 2 * n * n,
              "pppm_spread": e * (n + 3), "pppm_interpolate": e * (n + 3),
              "fused_pre_force": e * (n + 3) + n,
              "fused_post_force": e * n + n}
    P = inputs["dense_pair"][0]
    total = {}
    for r in range(B):
        one = work_counts(torch, snap.replace(position=P[r]), ff,
                          inputs["fused_pre_force"],
                          pair_blocks=pk.launch_blocks(n, B))
        for k, (nb, no) in one.items():
            tb, to = total.get(k, (0, 0))
            total[k] = (tb + nb, to + no)
    return {k: (nb - (B - 1) * shared[k], no)
            for k, (nb, no) in total.items()}


def replica_kernel_phase(torch, pt, dtype, timed):
    """Phase 11a: each batched kernel (REPLICA_B replicas of N = 501 in one
    launch) against its plain twin on the batch, against the one-replica
    launch on each replica's rows (bit-equal but K2, whose float atomics
    reorder), and two calls bit-equal (but K2); K4's image flags and K5's
    velocities equal to the twins'. In float32 also the times and bound
    as in phase 2, and the device time of the same call at
    REPLICA_WIDE_B replicas. K1 runs more rows a block in a batch than
    alone, so it is held to its one-replica launches within the
    tolerance."""
    B = REPLICA_B
    snap, ff, inputs = replica_inputs(torch, pt, B, dtype)
    calls = replica_calls()
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    out = {}
    for key, args in inputs.items():
        kern, plain = calls[key]

        def outs(x):
            return x if isinstance(x, tuple) else (x,)

        k, again, p = outs(kern(*args)), outs(kern(*args)), outs(plain(*args))
        torch.cuda.synchronize()
        scales = [None] * len(k)
        if key == "fused_pre_force":
            vel, mass, mol = args[3], args[5], args[6]
            check(torch.equal(k[1], p[1]), f"phase 11 {key} {name}: image "
                  "flags differ from the twin's")
            scales[3] = float((0.5 * mass[:, None] * vel * vel)[:, mol]
                              .sum(dim=(1, 2)).max())
        if key == "fused_post_force":
            check(torch.equal(k[0], p[0]), f"phase 11 {key} {name}: "
                  "velocities differ from the twin's")
            scales[3] = float((p[2].abs() + p[3].abs()).max())
        errs = []
        for a, b, s in zip(k, p, scales):
            check(bool(torch.isfinite(a).all()),
                  f"phase 11 {key} B={B} {name}: non-finite output")
            err, scale = max_err(a, b)
            scale = max(scale, s or 0.0)
            check(err <= tol * max(scale, 1e-300),
                  f"phase 11 {key} B={B} {name}: max|d| {err} > "
                  f"{tol}*{scale}")
            errs.append((err, scale))
        bits = key != "pppm_spread"
        if bits:
            check(all(torch.equal(a, b) for a, b in zip(k, again)),
                  f"phase 11 {key} B={B} {name}: two calls differ")
        same = bits and key != "dense_pair"
        worst = 0.0
        for r in range(B):
            one = outs(kern(*replica_row(args, r, key)))
            for a, b in zip(k, one):
                if same:
                    check(torch.equal(a[r], b), f"phase 11 {key} {name}: "
                          f"replica {r} differs from its one-replica launch")
                else:
                    err, scale = max_err(a[r], b)
                    check(err <= tol * scale, f"phase 11 {key} {name}: "
                          f"replica {r} off its one-replica launch by {err}")
                    worst = max(worst, err)
        out[key] = dict(replicas=B, max_abs_err=errs[0][0],
                        scale=errs[0][1],
                        max_abs_err_other_outputs=[e for e, _ in errs[1:]],
                        bit_equal_calls=bits,
                        replicas_bit_equal_to_one_replica_launches=same,
                        max_abs_err_to_one_replica_launches=worst)
    if timed:
        counts = replica_work_counts(torch, snap, ff, inputs, B)
        for key, args in inputs.items():
            kern, plain = calls[key]
            r = out[key]
            r["ms"] = device_ms(torch, lambda: kern(*args))
            r["host_call_ms"] = host_call_ms(torch, lambda: kern(*args))
            r["plain_ms"] = profiled_device_ms(torch, lambda: plain(*args))
            r["bound_ms"], r["bound_by"] = bound_ms(*counts[key])
            r["bytes"], r["ops"] = counts[key]
        wide_snap, wide_ff, wide = replica_inputs(torch, pt, REPLICA_WIDE_B,
                                                  dtype)
        wide_counts = replica_work_counts(torch, wide_snap, wide_ff, wide,
                                          REPLICA_WIDE_B)
        for key, args in wide.items():
            kern = calls[key][0]
            out[key][f"ms_b{REPLICA_WIDE_B}"] = device_ms(
                torch, lambda: kern(*args))
            out[key][f"bound_ms_b{REPLICA_WIDE_B}"] = bound_ms(
                *wide_counts[key])[0]
    for key, r in out.items():
        print(f"phase 11: N={snap.N} B={B} {name} {key}: " + ", ".join(
            f"{k}={v!r}" for k, v in r.items()), flush=True)
    return out


class CardDraws:
    """Injected draws for a batch of ``B`` replicas, made once on the card
    by (stream, step) from fixed seeds; ``replica(r)`` hands one replica's
    rows to a one-replica run, so both see the same numbers."""

    def __init__(self, torch, B, dtype, replica=None, table=None):
        self.torch, self.B, self.dtype = torch, B, dtype
        self.row = replica
        self.table = {} if table is None else table

    def replica(self, r):
        return CardDraws(self.torch, self.B, self.dtype, r, self.table)

    def _get(self, stream, state, shape):
        key = (stream, state.step)
        if key not in self.table:
            g = self.torch.Generator(device=state.device)
            g.manual_seed(2 * state.step + stream)
            self.table[key] = self.torch.randn(
                (self.B,) + shape, generator=g, dtype=self.dtype,
                device=state.device)
        x = self.table[key]
        return x if self.row is None else x[self.row]

    def bussi(self, state, i, m):
        x = self._get(0, state, (2,))
        return x[..., 0], (m.dof - 1.0) + 10.0 * x[..., 1]

    def langevin(self, state, i, m, shape):
        return self._get(1, state, (1, 3))


def replica_f64_trajectory(torch, pt):
    """Phase 11b: REPLICA_F64_B float64 replicas, REPLICA_F64_STEPS Bussi +
    Langevin steps on the card in one batch, against one-replica card runs
    of each replica with the same draws: positions within TRAJ_TOL_BOHR,
    image flags equal, K1-K3 launched once a step for the batch."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    B, steps = REPLICA_F64_B, REPLICA_F64_STEPS
    snap = reference_scene(pt, 250, 46.0, torch.float64,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(0.25), seed=7,
                                kT=kT)
    draws = CardDraws(torch, B, torch.float64)
    _cuda.reset_launches()
    final, _ = run_replica_steps(make_step_fn(ff, methods, noise=draws),
                                 batch, steps)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    err, img_ok = 0.0, True
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA})
        fr, _ = run_steps(make_step_fn(ff, methods, noise=draws.replica(r)),
                          one, steps)
        err = max(err, float((final.position[r] - fr.position).abs().max()))
        img_ok &= bool(torch.equal(final.image[r], fr.image))
    print(f"phase 11: f64 Bussi + Langevin {steps} steps of {B} replicas at "
          f"N={snap.N} in one batch vs one-replica runs, same draws, on the "
          f"card: max|dx| = {err!r} bohr (bound {TRAJ_TOL_BOHR}), images "
          f"equal: {img_ok}, batch launches {launches}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"phase 11 f64 batch: max|dx| {err} bohr > {TRAJ_TOL_BOHR} or "
          "images differ")
    for kname in BATCHED_KERNELS[:3]:
        check(launches.get(kname, 0) == steps,
              f"phase 11 f64 batch: {kname} launched "
              f"{launches.get(kname, 0)} times in {steps} steps")
    return err


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class DeviceRecord(NamedTuple):
    """One device record of a trace: the kernel's (or copy's) name and
    its start and end in us."""
    name: str
    start: float
    end: float


def traces(torch, fn):
    """``fn()`` under ``torch.profiler``, up to PROFILE_TRIES times: yields
    (its result, the trace's device records as ``DeviceRecord``s) for each
    try; the caller stops when a trace is complete enough (the profiler on
    the card's machine drops device records, PERF.md §7). The records are
    read from the profiler's raw results: the same names and counts as
    its parsed ``events()``, which take ~20x longer to build (1.3-2.1 s
    against 0.06-0.09 s for 50 steps at N = 501 on the card's host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        yield out, [DeviceRecord(e.name(), e.start_ns() / 1e3,
                                 e.end_ns() / 1e3)
                    for e in prof.profiler.kineto_results.events()
                    if e.device_type() == DeviceType.CUDA]


def named(dev, mark):
    """Records of ``dev`` whose kernel name holds ``mark``."""
    return sum(mark in e.name for e in dev)


DENSE_STEP_MARKS = ("dense_pair_kernel", "spread_kernel", "interpolate_kernel",
                    "pre_force_kernel", "post_force_kernel")


def profiled_steps(torch, run, steps, marks=DENSE_STEP_MARKS):
    """The device side of ``run(steps)`` in ``torch.profiler`` traces, as a
    dict: ``ops`` (device operations a step), ``records`` (device records
    a step), ``us`` (device us a step, the union of their intervals),
    ``summed`` (summed us a step), ``dropped`` (records of ``marks`` the
    trace missed) and ``top_us`` (the largest device items, us a step by
    name).

    On the card's machine the profiler drops device records, more of them
    the longer the process has run (PERF.md, open questions: up to 41 of
    ~10,000 in one 50-step trace, none to a few in others), so the raw
    count of records a step is not the program's. The program issues each
    device operation a whole number of times a step (and the call's
    observables copy once), so the count a step is taken name by name: the
    most records of that name in any usable trace over ``steps``, rounded
    to the nearest whole number, summed over the names. A record dropped
    moves it only if half a name's records a trace go. A trace is usable
    when it holds each kernel of ``marks`` (kernels the step launches once)
    ``steps`` or ``steps - 1`` times (a trace may miss the same
    cooperative-launch record every try); at least two usable traces are
    taken, up to PROFILE_TRIES in all. The times and the dropped count are
    those of the usable trace that misses the fewest marked records (each
    miss costs the step's device time one kernel call over ``steps``,
    ~0.1 us at 50 steps)."""
    from collections import Counter, defaultdict

    seen, best, usable, per_name = [], None, 0, Counter()
    for _, dev in traces(torch, lambda: run(steps)):
        counts = [named(dev, m) for m in marks]
        seen.append((len(dev), counts))
        missing = sum(steps - c for c in counts)
        if all(steps - 1 <= c <= steps for c in counts):
            usable += 1
            for name, c in Counter(e.name for e in dev).items():
                per_name[name] = max(per_name[name], c)
            if best is None or missing < best[0]:
                best = (missing, dev)
        if usable >= 2 and best[0] == 0:
            break
    check(best is not None, f"profiled_steps: no trace of {steps} steps with "
          f"each of {marks} at least {steps - 1} times in {PROFILE_TRIES} "
          f"(device operations and counts: {seen})")
    missing, dev = best
    iv = [(e.start, e.end) for e in dev]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:60]] += (e.end - e.start) / steps
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12])
    return dict(ops=sum(round(c / steps) for c in per_name.values()),
                records=len(dev) / steps, us=union_us(iv) / steps,
                summed=sum(b - a for a, b in iv) / steps, dropped=missing,
                top_us=top)


def replica_step_path(torch, pt, B, warm=N_WARM, chunks=N_CHUNKS,
                      chunk=CHUNK, bound=DRIFT_BOUND_HA):
    """Phase 11c: the batched step of B thermalized replicas of the N = 501
    scene (f32, fused tail, seed 7 + r) through ``run_replica_steps`` on
    phase 3's protocol (``warm`` steps, then ``chunks`` chunks of
    ``chunk`` steps; a prefix of it at the batch sizes but REPLICA_B):
    each batched kernel launched once a step, finite observables, each
    replica's universe drift under ``bound``, the median chunk rate
    (aggregate: B times it); then REPLICA_PROFILED_STEPS profiled steps:
    device operations, device us and busy share a step. ``B=None``
    profiles the one-replica fused step alone (the comparison for the
    operation count)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import (
        init_state,
        make_step_fn,
        run_steps,
        universe_energy,
    )
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )

    dev = torch.device("cuda")
    snap = reference_scene(pt, 250, 46.0, torch.float32, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    dt = PC.fs_to_atomic_units(0.25)
    step = make_step_fn(ff, methods)
    state = {}
    if B is None:
        state["s"] = init_state(snap, ff, dt=dt, seed=7)

        def run(n):
            state["s"], obs = run_steps(step, state["s"], n)
            return obs

        run(N_WARM // 4)
        prof = profiled_steps(torch, run, REPLICA_PROFILED_STEPS)
        res = dict(replicas=None, device_ops_per_step=prof["ops"],
                   device_records_per_step=prof["records"],
                   device_us_per_step=prof["us"],
                   device_us_per_step_summed=prof["summed"],
                   profile_records_dropped=prof["dropped"])
        print("phase 11 (one-replica fused step, profile): " + ", ".join(
            f"{k}={v!r}" for k, v in res.items()), flush=True)
        return res

    state["s"] = init_replica_states(snap, ff, n_replicas=B, dt=dt, seed=7,
                                     kT=kT)

    def run(n):
        state["s"], obs = run_replica_steps(step, state["s"], n)
        return obs

    _cuda.reset_launches()
    t0 = time.perf_counter()
    run(warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    outs, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        outs.append(run(chunk))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = dict(_cuda.launches)
    total = warm + chunks * chunk
    label = f"phase 11 batched step B={B}"
    for kname in BATCHED_KERNELS:
        check(launches.get(kname, 0) == total,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{total} steps")
    obs = {k: np.concatenate([c[k] for c in outs]) for k in OBS_KEYS}
    for k in OBS_KEYS:
        check(obs[k].shape == (chunks * chunk, B)
              and bool(np.all(np.isfinite(obs[k]))),
              f"{label}: bad observable {k} {obs[k].shape}")
    final = state["s"]
    for name in ("position", "velocity", "forces"):
        t = getattr(final, name)
        check(tuple(t.shape) == (B, snap.N, 3)
              and bool(torch.isfinite(t).all()), f"{label}: bad {name}")
    U = universe_energy(obs)
    drifts = np.abs(U - U[0]).max(axis=0)
    check(bool((drifts < bound).all()),
          f"{label}: universe drifts {drifts.tolist()} >= {bound}")
    rate = statistics.median(chunk / t for t in chunk_s)
    wall_ms = 1e3 / rate
    prof = profiled_steps(torch, run, REPLICA_PROFILED_STEPS)
    res = dict(replicas=B, n=snap.N, steps=chunks * chunk,
               steps_per_s=rate, aggregate_steps_per_s=B * rate,
               chunk_steps_per_s=[chunk / t for t in chunk_s],
               warmup_chunk_s=warm_s, wall_ms_per_step=wall_ms,
               device_ops_per_step=prof["ops"],
               device_records_per_step=prof["records"],
               device_us_per_step=prof["us"],
               device_us_per_step_summed=prof["summed"],
               busy_share=prof["us"] / (wall_ms * 1e3),
               profile_records_dropped=prof["dropped"],
               launches_per_step={k: launches.get(k, 0) / total
                                  for k in BATCHED_KERNELS},
               universe_drift_ha=drifts.tolist())
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def vmapped_line(label, text):
    """(replicas, steps, seconds, aggregate steps/s) of the batched CLI's
    'vmapped ...' line in ``text``."""
    m = re.search(r"vmapped (\d+) replicas x (\d+) steps in ([0-9.]+)s "
                  r"\((\d+) aggregate steps/s\)", text)
    check(m is not None, f"{label}: no 'vmapped ... steps' line")
    return (int(m.group(1)), int(m.group(2)), float(m.group(3)),
            int(m.group(4)))


def replica_files(torch, label, out_dir, replicas, n_particles,
                  energy_period_steps):
    """Each replica's files of a batched CLI run in ``out_dir``: the
    header lines (energy rows every ``energy_period_steps`` steps), the
    last GSD frame (``n_particles``, finite), at least 3 finite energy
    rows of 20 columns. Returns each replica's universe drift
    max |U - U0| and GSD frame count."""
    import numpy as np

    from cavmd_tpu_torch.io import open_gsd

    period = f"# Output period: {energy_period_steps} steps"
    energy_header = [period if k == 1 else h for k, h in enumerate(
        CLI_HEADERS["prod-1_energy_tracker.txt"])]
    mode_header = [period if k == 1 else h for k, h in enumerate(
        CLI_HEADERS["prod-1_cavity_mode.txt"])]
    drifts, frames = [], []
    for r in replicas:
        headers = {
            f"prod-{r}_energy_tracker.txt": energy_header,
            f"prod-{r}_cavity_mode.txt": mode_header,
            f"prod-{r}_ref0.txt": CLI_HEADERS["prod-1_ref0.txt"],
            f"prod-{r}_dipole_autocorr_0.txt":
                CLI_HEADERS["dipole_autocorr_0.txt"]}
        for fname, header in headers.items():
            path = os.path.join(out_dir, fname)
            check(os.path.isfile(path), f"{label}: {fname} missing")
            with open(path) as f:
                lines = f.read().splitlines()
            for k, want in enumerate(header):
                got = lines[k] if k < len(lines) else "<missing>"
                ok = (got.startswith("# Reference 0 at t=")
                      if want is None else got == want)
                check(ok, f"{label}: {fname} header line {k}: {got!r}")
        with open_gsd(os.path.join(out_dir, f"prod-{r}.gsd")) as t:
            frame = t.read_frame(len(t) - 1, device="cuda")
            check(frame.N == n_particles and bool(
                torch.isfinite(frame.position).all()),
                f"{label}: replica {r}'s GSD frame has N={frame.N}")
            frames.append(len(t))
        rows = np.loadtxt(os.path.join(out_dir,
                                       f"prod-{r}_energy_tracker.txt"),
                          comments=("#", "time"), ndmin=2)
        check(rows.shape[0] >= 3 and rows.shape[1] == 20
              and bool(np.isfinite(rows).all()),
              f"{label}: replica {r}'s energy rows {rows.shape}")
        drifts.append(float(np.abs(rows[:, 18] - rows[0, 18]).max()))
    return drifts, frames


def vmap_cli_phase(torch, pt, phase, cli_args, energy_period_steps,
                   kernels, drift_bound):
    """Phase 11d (phase 5's arguments, ``kernels`` K1-K5) and 12d (phase
    8's at 10,000 molecules, the cell kernel in K1's place):
    ``advanced_run`` with ``cli_args`` and ``--vmap-replicas --replicas
    1-REPLICA_B`` in a temporary directory: exit 0, each replica's files
    and header lines (energy rows every ``energy_period_steps`` steps), its
    GSD frames read back, K4/K5 launched once a step for the batch (the
    pair kernel, K2 and K3 once a step and in the setup: FIRE, the initial
    forces), each replica's universe drift under ``drift_bound``, the
    aggregate steps/s of the CLI's own line."""
    from cavmd_tpu_torch.drivers import advanced_run
    from cavmd_tpu_torch.ops import _cuda

    B = REPLICA_B
    args = cli_args + ["--vmap-replicas", "--replicas", f"1-{B}"]
    n_particles = 2 * int(args[args.index("--n-molecules") + 1]) + 1
    cwd = os.getcwd()
    work = tempfile.mkdtemp(prefix="cavmd_vmap_cli_")
    tee = _Tee(sys.stdout)
    label = f"phase {phase} CLI --vmap-replicas B={B} N={n_particles}"
    try:
        os.chdir(work)
        _cuda.reset_launches()
        with contextlib.redirect_stdout(tee):
            rc = advanced_run.main(args)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        check(rc == 0, f"{label}: exited with {rc}")
        n_rep, steps, wall, agg = vmapped_line(label, tee.buf.getvalue())
        check(n_rep == B, f"{label}: {n_rep} replicas")
        drifts, frames = replica_files(
            torch, label, os.path.join(work, "cavity_coupling_1eneg03"),
            range(1, B + 1), n_particles, energy_period_steps)
        for kname in kernels:
            n = launches.get(kname, 0)
            check(n == steps if kname.startswith("fused") else n >= steps,
                  f"{label}: kernel {kname} launched {n} times in {steps} "
                  "steps")
        check(max(drifts) < drift_bound,
              f"{label}: universe drifts {drifts} >= {drift_bound}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    res = dict(replicas=B, n=n_particles, steps=steps, run_seconds=wall,
               aggregate_steps_per_s=agg, universe_drift_ha=drifts,
               drift_bound_ha=drift_bound, gsd_frames=frames,
               launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


# --------------------------------------------------------------- phase 12
def wrap_rows(torch, P, box_L):
    """Positions re-wrapped into the primary box."""
    return (P - box_L * torch.round(P / box_L)).contiguous()


def cell_replica_inputs(torch, pt, kind, B, dtype):
    """Phase 12a's batched pair-kernel inputs: B replicas, positions
    jittered 0.3 bohr apart and re-wrapped, their batched list, and the
    call's arguments. ``kind``: 'cell_pair' (N = 2 HELD_N_MOL + 1, 10^3
    cells), 'cell_pair_small_grid' (the N = 501 scene in cell mode, 2^3
    cells) or 'zcol_pair' (N = 2 HELD_N_MOL + 1 in zcol mode)."""
    from cavmd_tpu_torch.core.system import reference_box_for

    dev = torch.device("cuda")
    if kind == "cell_pair_small_grid":
        snap = reference_scene(pt, 250, 46.0, dtype, dev)
    else:
        snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                               dtype, dev)
    mode = "zcol" if kind == "zcol_pair" else "cell"
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode=mode)
    P = wrap_rows(torch, jitter_rows(torch, snap.position, B, 0.3, 5),
                  snap.box_L)
    clist = ff.build_cells(P, snap.box_L)
    check(clist.overflow.shape == (B,) and not bool(clist.overflow.any()),
          f"phase 12 {kind}: the batched list overflowed")
    args = (P, snap.box_L, clist, ff.cell_cfg, snap.typeid, snap.charge,
            ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value)
    if mode == "zcol":
        args = args + (ff.zcol_W,)
    return snap, ff, args


def one_replica_args(args, r):
    """Replica r's one-replica pair call of a batched call's arguments."""
    from cavmd_tpu_torch.ops.neighbor import replica_list

    return (args[0][r].contiguous(), args[1],
            replica_list(args[2], r)) + args[3:]


def cell_replica_work_counts(torch, snap, ff, args, kind, B):
    """(bytes, operations) of one batched call of ``kind`` (and, for the
    zcol wrapper, of its hull launch): the one-replica counts of
    ``cell_work_counts`` / ``zcol_work_counts`` on each replica's inputs,
    summed, with what the replicas share (box, typeid, charge, the type
    tables, the neighbour and exclusion tables) counted once."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    n, e = snap.N, snap.position.element_size()
    T = ff.lj_eps.shape[0]
    E = ff.cell_exclusions.shape[1]
    tot, hull_tot = [0, 0], [0, 0]
    for r in range(B):
        a = one_replica_args(args, r)
        if kind == "zcol_pair":
            pos_loc = zk.zcol_local_positions(a[0], a[1], a[2])
            hull, _, W = zk.zcol_hull(pos_loc, a[1], a[2], a[3], a[12])
            nb, no, _ = zcol_work_counts(torch, pos_loc, a[1], a[2], a[3],
                                         hull, W, snap.typeid, snap.charge,
                                         ff)
            hb, ho = zcol_hull_work_counts(torch, pos_loc, a[2])
            hull_tot = [hull_tot[0] + hb, hull_tot[1] + ho]
        else:
            C, cap = a[2].bucket_idx.shape
            blocks = ck.launch_blocks(C, cap, snap.position.device, B)
            nb, no, _ = cell_work_counts(torch, a[0], a[1], a[2], a[3],
                                         snap.typeid, snap.charge, ff,
                                         ff.cell_exclusions, blocks)
        tot = [tot[0] + nb, tot[1] + no]
    shared = e * (3 + n + 4 * T * T) + 4 * n + 4 * (n + 1) * E
    if kind != "zcol_pair":
        shared += 4 * 27 * ff.cell_cfg.total_cells
    out = (tot[0] - (B - 1) * shared, tot[1])
    hull = (hull_tot[0] - (B - 1) * e * n, hull_tot[1])
    return out, hull


def hold_batched_pair(torch, kind, args, label, tol):
    """The batched pair call of ``kind`` ('zcol_pair', or a cell kernel's
    name) on ``args`` against its plain twin on the whole batch (each
    output within ``tol`` of its scale; the zcol window flags equal) and
    against the one-replica launch on each replica's rows (forces
    bit-equal: a row's force is one warp's sum either way; the energies
    summed in another order where the row split or the partials' shape
    moves them, within ``tol``); two calls bit-equal. Returns what was
    held, as result fields."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    zcol = kind == "zcol_pair"
    kern = zk.zcol_pair_force if zcol else ck.cell_pair_force_fused
    plain = (zk.zcol_pair_force_plain if zcol
             else ck.cell_pair_force_fused_plain)
    k, again, p = kern(*args), kern(*args), plain(*args)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(k, again)),
          f"{label}: two calls differ")
    errs = []
    for a, b in zip(k[:3], p[:3]):
        err, scale = max_err(a, b)
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
        check(err <= tol * max(scale, 1e-300),
              f"{label}: max|d| {err} > {tol}*{scale}")
        errs.append((err, scale))
    if zcol:  # a replica's hull may outgrow the planned window
        check(torch.equal(k[3], p[3]), f"{label}: window flags "
              f"{k[3].tolist()} vs the twin's {p[3].tolist()}")
    worst, energy_bits = 0.0, True
    for r in range(args[0].shape[0]):
        one = kern(*one_replica_args(args, r))
        check(torch.equal(k[0][r], one[0]),
              f"{label}: replica {r}'s forces differ from its "
              "one-replica launch")
        for a, b in zip(k[1:3], one[1:3]):
            energy_bits &= bool(torch.equal(a[r], b))
            err, scale = max_err(a[r], b)
            check(err <= tol * scale, f"{label}: replica {r}'s energy "
                  f"off its one-replica launch by {err}")
            worst = max(worst, err)
    return dict(max_abs_err=errs[0][0],
                window_flags=k[3].tolist() if zcol else None,
                scale=errs[0][1],
                max_abs_err_other_outputs=[e for e, _ in errs[1:]],
                bit_equal_calls=True,
                forces_bit_equal_to_one_replica_launches=True,
                energies_bit_equal_to_one_replica_launches=energy_bits,
                max_abs_err_energy_to_one_replica_launches=worst)


def hold_batched_hull(torch, args, label):
    """The zcol wrapper's hull launch on the batched zcol call ``args``:
    its hull, flags and the slotted rows of its (N, 4) table bit-equal to
    each replica's one-replica launch and to the twins'
    (``zcol_hull_plain``)."""
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    P, box, clist, cfg = args[:4]
    charge, W = args[5], args[12]
    hk, flags, loc, Wk = zk._launch_hull(P, box, clist, cfg, charge, W)
    slotted = clist.bucket_idx < P.shape[-2]
    same = True
    for r in range(P.shape[0]):
        a = one_replica_args(args, r)
        h1, f1, l1, W1 = zk._launch_hull(a[0], box, a[2], cfg, charge, W)
        ht, ft, _, lt = zcol_hull_plain(torch, zk, a[0], box, a[2], cfg,
                                        charge, W)
        ids = clist.bucket_idx[r][slotted[r]].long()
        same &= (bool(torch.equal(hk[r], h1))
                 and bool(torch.equal(flags[r], f1))
                 and bool(torch.equal(loc[r][ids], l1[ids]))
                 and bool(torch.equal(hk[r], ht))
                 and bool(torch.equal(loc[r][ids], lt[ids]))
                 and bool(flags[r].any()) == bool(ft) and Wk == W1)
    check(same, f"{label}: the batched hull launch differs from the "
          "one-replica launches or the twins")
    return dict(max_abs_err=0.0, bit_equal_to_one_replica_launches=True,
                bit_equal_to_twins=True)


def state_pair_args(state, ff):
    """The pair call ``ForceField.forward`` makes on a batched state's
    positions with its carried list."""
    args = (state.position, state.box_L, state.cell_list, ff.cell_cfg,
            state.typeid, state.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
            ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
    return args + ((ff.zcol_W,) if ff.pair_mode == "zcol" else ())


def cell_replica_kernel_phase(torch, pt, dtype, timed):
    """Phase 12a: the cell kernel (10^3 cells and the 2^3 small grid) and
    the zcol wrapper with its hull, each over REPLICA_B replicas in one
    launch, held by ``hold_batched_pair`` and ``hold_batched_hull``. In
    float32 also the device time, the host-bound time, the twins' time,
    the bound from the batch's own inputs, and the one-replica launch's
    device time."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    B = REPLICA_B
    name = str(dtype).replace("torch.", "")
    out = {}
    for kind in ("cell_pair", "cell_pair_small_grid", "zcol_pair"):
        snap, ff, args = cell_replica_inputs(torch, pt, kind, B, dtype)
        label = f"phase 12 {kind} B={B} N={snap.N} {name}"
        zcol = kind == "zcol_pair"
        if not zcol:
            check(ck.kernel_name(ff.cell_cfg) == kind,
                  f"{label}: the grid {ff.cell_cfg.ncells} runs "
                  f"{ck.kernel_name(ff.cell_cfg)}")
        kern = zk.zcol_pair_force if zcol else ck.cell_pair_force_fused
        plain = (zk.zcol_pair_force_plain if zcol
                 else ck.cell_pair_force_fused_plain)
        res = dict(replicas=B, n=snap.N, ncells=ff.cell_cfg.ncells,
                   cap=ff.cell_cfg.cap)
        res.update(hold_batched_pair(torch, kind, args, label, TOL[name]))
        hull_res = None
        if zcol:
            hull_res = dict(replicas=B, n=snap.N)
            hull_res.update(hold_batched_hull(torch, args, label))
        if timed:
            (n_bytes, n_ops), (h_bytes, h_ops) = cell_replica_work_counts(
                torch, snap, ff, args, kind, B)
            res["ms"] = device_ms(torch, lambda: kern(*args))
            res["host_call_ms"] = host_call_ms(torch, lambda: kern(*args))
            res["plain_ms"] = profiled_device_ms(torch, lambda: plain(*args))
            one_args = one_replica_args(args, 0)
            res["one_replica_ms"] = device_ms(torch, lambda: kern(*one_args))
            res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, n_ops)
            res.update(bytes=n_bytes, ops=n_ops)
            if zcol:
                P, box, clist, cfg = args[:4]
                res["kernel_only_ms"] = profiled_device_ms(
                    torch, lambda: kern(*args), match="zcol_pair_kernel")
                hull_res["ms"] = device_ms(torch, lambda: zk._launch_hull(
                    P, box, clist, cfg, snap.charge, ff.zcol_W))
                hull_res["host_call_ms"] = host_call_ms(
                    torch, lambda: zk._launch_hull(
                        P, box, clist, cfg, snap.charge, ff.zcol_W))
                hull_res["one_replica_ms"] = device_ms(
                    torch, lambda: zk._launch_hull(
                        one_args[0], box, one_args[2], cfg, snap.charge,
                        ff.zcol_W))
                # the twins' hull and table of every replica, one call a
                # sample (tens of launches a replica)
                hull_res["plain_ms"] = device_ms(torch, lambda: [
                    zcol_hull_plain(torch, zk, *one_replica_args(
                        args, r)[:4], snap.charge, ff.zcol_W)
                    for r in range(B)], inner=1)
                hull_res["bound_ms"], hull_res["bound_by"] = bound_ms(
                    h_bytes, h_ops)
                hull_res.update(bytes=h_bytes, ops=h_ops)
        out[kind] = res
        if hull_res is not None:
            out["zcol_hull"] = hull_res
        for key, r in ((kind, res), ("zcol_hull", hull_res)):
            if r is not None:
                print(f"phase 12: B={B} {name} {key}: " + ", ".join(
                    f"{a}={v!r}" for a, v in r.items()), flush=True)
        del snap, ff, args
        torch.cuda.empty_cache()
    return out


def cell_replica_f64_trajectory(torch, pt, mode):
    """Phase 12b: REPLICA_F64_B thermalized float64 replicas of the
    N = 2 HELD_N_MOL + 1 scene in ``mode`` ('cell' or 'zcol'),
    ZCOL_F64_STEPS Bussi + Langevin steps of ZCOL_F64_DT_FS in one batch on
    the card (every replica's carried list rebuilt inside the window),
    against one-replica card runs of each replica with the same draws:
    positions within TRAJ_TOL_BOHR, image flags equal, the pair kernels,
    K2 and K3 launched once a step for the batch."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops.cell_kernels import kernel_name
    from cavmd_tpu_torch.ops.neighbor import replica_list
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    B, steps = REPLICA_F64_B, ZCOL_F64_STEPS
    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           torch.float64, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode=mode)
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(ZCOL_F64_DT_FS),
                                seed=7, kT=kT)
    draws = CardDraws(torch, B, torch.float64)
    _cuda.reset_launches()
    final, obs = run_replica_steps(make_step_fn(ff, methods, noise=draws),
                                   batch, steps)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    label = f"phase 12 f64 {mode} batch"
    check(not obs["cell_overflow"].any(), f"{label}: overflow")
    rebuilt = [bool((final.cell_anchor[r] != batch.cell_anchor[r]).any())
               for r in range(B)]
    err, img_ok = 0.0, True
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA},
                            cell_list=replica_list(batch.cell_list, r),
                            cell_anchor=batch.cell_anchor[r])
        fr, _ = run_steps(make_step_fn(ff, methods, noise=draws.replica(r)),
                          one, steps)
        err = max(err, float((final.position[r] - fr.position).abs().max()))
        img_ok &= bool(torch.equal(final.image[r], fr.image))
    print(f"{label}: Bussi + Langevin {steps} steps of {ZCOL_F64_DT_FS} fs, "
          f"{B} replicas at N={snap.N} in one batch vs one-replica runs, "
          f"same draws, on the card: max|dx| = {err!r} bohr (bound "
          f"{TRAJ_TOL_BOHR}), images equal: {img_ok}, lists rebuilt "
          f"{rebuilt}, batch launches {launches}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"{label}: max|dx| {err} bohr > {TRAJ_TOL_BOHR} or images differ")
    check(all(rebuilt), f"{label}: lists rebuilt {rebuilt}")
    kernels = (["zcol_pair", "zcol_hull"] if mode == "zcol"
               else [kernel_name(ff.cell_cfg)])
    for kname in kernels + ["pppm_spread", "pppm_interpolate"]:
        check(launches.get(kname, 0) == steps,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{steps} steps")
    return dict(max_dx_bohr=err, launches=launches)


CELL_STEP_MARKS = ("cell_pair_kernel", "spread_kernel", "interpolate_kernel",
                   "pre_force_kernel", "post_force_kernel")


def cell_replica_step_path(torch, pt, band_ref, one_ms):
    """Phase 12c: REPLICA_B replicas of ``build_large_n(LARGE_N_MOL)``'s
    start (N = 100,001, cell mode, f32, fused tail, Bussi + Langevin,
    LARGE_DT_FS; replica r thermalized at seed 7 + r) through
    ``run_replica_steps`` on phase 6's protocol: the cell kernel and K2-K5
    launched once a step, no overflow, finite observables, each replica's
    universe band under DOMAIN_BAND_RATIO times phase 6's one-replica band
    ``band_ref``; the batched cell kernel on the final state and its
    carried list held by ``hold_batched_pair``; wall ms a step and
    aggregate steps/s beside phase 6's ``one_ms``; then
    REPLICA_PROFILED_STEPS profiled
    steps of the batch and of one replica: device operations a step name
    by name (within REPLICA_OPS_SLACK of one replica's), device us, busy
    share, the largest device items; the list build's and K2's device time
    on the batch beside one replica's."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import (
        make_step_fn,
        run_steps,
        universe_energy,
    )
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )

    B = REPLICA_B
    sim, snap, ff = build_large_n(LARGE_N_MOL, dt_fs=LARGE_DT_FS)
    step = make_step_fn(ff, sim.methods)
    label = f"phase 12 batched cell step B={B} N={snap.N}"
    state = {"one": sim.state}

    def run_one(n):
        state["one"], obs = run_steps(step, state["one"], n)
        return obs

    run_one(20)
    one_prof = profiled_steps(torch, run_one, REPLICA_PROFILED_STEPS,
                              CELL_STEP_MARKS)
    state["b"] = init_replica_states(snap, ff, n_replicas=B,
                                     dt=float(sim.state.dt), seed=7,
                                     kT=PC.kT_from_kelvin(100.0))

    def run(n):
        state["b"], obs = run_replica_steps(step, state["b"], n)
        return obs

    _cuda.reset_launches()
    t0 = time.perf_counter()
    run(LARGE_CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    outs, chunk_s = [], []
    for _ in range(LARGE_CHUNKS):
        t0 = time.perf_counter()
        outs.append(run(LARGE_CHUNK))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = dict(_cuda.launches)
    total = LARGE_CHUNK * (LARGE_CHUNKS + 1)
    for kname in ("cell_pair",) + BATCHED_KERNELS[1:]:
        check(launches.get(kname, 0) == total,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{total} steps")
    obs = {k: np.concatenate([c[k] for c in outs])
           for k in OBS_KEYS + ("cell_overflow",)}
    check(not obs["cell_overflow"].any(), f"{label}: overflow")
    for k in OBS_KEYS:
        check(obs[k].shape == (LARGE_CHUNKS * LARGE_CHUNK, B)
              and bool(np.all(np.isfinite(obs[k]))),
              f"{label}: bad observable {k} {obs[k].shape}")
    check(bool(torch.isfinite(state["b"].position).all()),
          f"{label}: non-finite positions")
    U = universe_energy(obs)
    bands = (U.max(axis=0) - U.min(axis=0)).tolist()
    bound = DOMAIN_BAND_RATIO * band_ref
    check(max(bands) < bound,
          f"{label}: universe bands {bands} >= {bound} Ha")
    wall_ms = statistics.median(s / LARGE_CHUNK * 1e3 for s in chunk_s)
    prof = profiled_steps(torch, run, REPLICA_PROFILED_STEPS,
                          CELL_STEP_MARKS)
    check(abs(prof["ops"] - one_prof["ops"]) <= REPLICA_OPS_SLACK,
          f"{label}: {prof['ops']} device operations a step vs one "
          f"replica's {one_prof['ops']}")
    b = state["b"]
    held = hold_batched_pair(torch, "cell_pair", state_pair_args(b, ff),
                             f"{label} (final state)", TOL["float32"])
    pos, box = b.position, b.box_L
    one_pos = state["one"].position
    build_ms = device_ms(torch, lambda: ff.build_cells(pos, box), inner=1)
    one_build_ms = device_ms(torch, lambda: ff.build_cells(one_pos, box),
                             inner=1)
    spread = (pos, b.charge, box, ff.pppm_order, ff.pppm_mesh)
    k2_ms = device_ms(torch, lambda: sk.spread_grid(*spread))
    k2_one_ms = device_ms(torch, lambda: sk.spread_grid(
        one_pos, b.charge, box, ff.pppm_order, ff.pppm_mesh))
    res = dict(replicas=B, n=snap.N, steps=LARGE_CHUNKS * LARGE_CHUNK,
               wall_ms_per_step=wall_ms,
               chunk_ms_per_step=[s / LARGE_CHUNK * 1e3 for s in chunk_s],
               warmup_chunk_s=warm_s, aggregate_steps_per_s=B * 1e3 / wall_ms,
               one_replica_ms_per_step=one_ms,
               one_replica_steps_per_s=1e3 / one_ms,
               device_ops_per_step=prof["ops"],
               device_records_per_step=prof["records"],
               device_us_per_step=prof["us"],
               device_us_per_step_summed=prof["summed"],
               busy_share=prof["us"] / (wall_ms * 1e3),
               profile_records_dropped=prof["dropped"],
               top_device_us_per_step=prof["top_us"],
               one_replica_device_ops_per_step=one_prof["ops"],
               one_replica_device_us_per_step=one_prof["us"],
               one_replica_top_device_us_per_step=one_prof["top_us"],
               list_build_ms=build_ms, one_replica_list_build_ms=one_build_ms,
               k2_batch_global_ms=k2_ms, k2_one_replica_ms=k2_one_ms,
               universe_band_ha=bands, band_bound_ha=bound,
               launches=launches, final_state_kernel=held)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def replica_batch_path(torch, pt, kind):
    """Phase 12c': REPLICA_B replicas, replica r thermalized at seed 7 + r,
    of the path that runs ``kind``, f32, fused tail, Bussi + Langevin at
    0.25 fs, through ``run_replica_steps`` in chunks with the CLI's batch
    overflow retry (``drivers/advanced_run.py:run_vmapped_replicas``:
    re-plan with ``with_cell_capacity``, rebuild the step and the chunk's
    start, at most 4 times). 'cell_pair_small_grid': the N = 501 scene in
    cell mode (2^3 cells), SMALL_GRID_BATCH_STEPS steps, each replica's
    drift max |U - U[0]| under phase 3's DRIFT_BOUND_HA (the window is a
    prefix of phase 3's protocol). 'zcol_pair':
    ``build_large_n(HELD_N_MOL, pair_mode='zcol')``'s start (N = 20,001)
    on phase 6's protocol, each replica's band under phase 6's N = 20,001
    LARGE_BAND_BOUND_HA. The pair kernels (in zcol mode K9 and its hull,
    and never the cell kernel) and K2-K5 launched once a step run (K2, K3
    and the pair kernels also once for each retry's start forces), no
    overflow left, finite observables; then the batched pair call on the
    final state and its carried list held by ``hold_batched_pair`` (and
    ``hold_batched_hull``)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import make_step_fn, universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )
    from cavmd_tpu_torch.simulation import retry_state

    B = REPLICA_B
    kT = PC.kT_from_kelvin(100.0)
    zcol = kind == "zcol_pair"
    if zcol:
        sim, snap, ff = build_large_n(HELD_N_MOL, pair_mode="zcol")
        methods = sim.methods
        chunks = [LARGE_CHUNK] * (LARGE_CHUNKS + 1)  # the first is warm-up
    else:
        snap = reference_scene(pt, 250, 46.0, torch.float32,
                               torch.device("cuda"))
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode="cell")
        methods = pt.resolve_methods(snap, main_methods(pt, kT),
                                     ff.l_typeid)
        chunks = [0, SMALL_GRID_BATCH_STEPS]
    label = f"phase 12 batched {kind} B={B} N={snap.N}"
    step = make_step_fn(ff, methods)
    state = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(0.25), seed=7,
                                kT=kT)
    _cuda.reset_launches()
    ran, retries, outs = 0, [], []
    t0 = time.perf_counter()
    for n in chunks:
        if not n:
            continue
        start = state
        rng_states = {k: g.get_state() for k, g in start.generators.items()}
        while True:
            state, obs = run_replica_steps(step, start, n)
            ran += n
            if not obs["cell_overflow"].any():
                break
            check(len(retries) < 4, f"{label}: overflow after 4 re-plans")
            cap = ff.cell_cfg.cap
            ff = ff.with_cell_capacity(max(cap + 4, 2 * cap))
            retries.append(dict(after_steps=ran, cap=ff.cell_cfg.cap,
                                zcol_W=ff.zcol_W))
            step = make_step_fn(ff, methods)
            start = retry_state(ff, start, rng_states)
        outs.append(obs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    steps = chunks[-1] * (len(chunks) - 1)
    kernels = ("zcol_pair", "zcol_hull") if zcol else (kind,)
    for kname in kernels + BATCHED_KERNELS[1:]:
        want = ran + (len(retries) if kname not in BATCHED_KERNELS[3:]
                      else 0)
        check(launches.get(kname, 0) == want,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{ran} steps run and {len(retries)} retries")
    check(not zcol or launches.get("cell_pair", 0) == 0,
          f"{label}: the cell kernel ran in zcol mode")
    obs = {k: np.concatenate([c[k] for c in outs[-(len(chunks) - 1):]])
           for k in OBS_KEYS}
    for k in OBS_KEYS:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    U = universe_energy(obs)
    if zcol:  # the band max(U) - min(U), as phase 6 holds it
        metric, bound = "universe_band_ha", LARGE_BAND_BOUND_HA
        drifts = (U.max(axis=0) - U.min(axis=0)).tolist()
    else:
        metric, bound = "universe_drift_ha", DRIFT_BOUND_HA
        drifts = np.abs(U - U[0]).max(axis=0).tolist()
    check(max(drifts) < bound, f"{label}: {metric} {drifts} >= {bound}")
    args = state_pair_args(state, ff)
    held = hold_batched_pair(torch, kind, args, f"{label} (final state)",
                             TOL["float32"])
    if zcol:
        held["hull"] = hold_batched_hull(torch, args,
                                         f"{label} (final state)")
    res = dict(replicas=B, n=snap.N, ncells=ff.cell_cfg.ncells,
               cap=ff.cell_cfg.cap, zcol_W=ff.zcol_W, steps=steps,
               steps_run=ran, retries=retries,
               aggregate_steps_per_s=B * ran / wall,
               **{metric: drifts}, bound_ha=bound, launches=launches,
               final_state_kernel=held)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


# ------------------------------------------------------------- phase 13
def bath_methods(pt, kind):
    """``kind`` (mttk or berendsen) at 100 K, tau BATH_TAU_PS, on the
    molecules; exact-OU Langevin (tau 5 ps, 100 K) on the photon."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC

    kT = PC.kT_from_kelvin(100.0)
    return (pt.MethodSpec(kind=kind, group="molecular", kT=kT,
                          tau=PC.ps_to_atomic_units(BATH_TAU_PS)),
            pt.MethodSpec(kind="langevin", group="cavity", kT=kT,
                          gamma=PC.gamma_from_tau_ps(5.0)))


def mttk_obs(state):
    """The molecular slot's MTTK (xi, eta) as per-step observables: the
    extended energy needs them every step."""
    return {"mttk_xi": state.mttk_xi[..., 0],
            "mttk_eta": state.mttk_eta[..., 0]}


def extended_energy(obs, method):
    """The quantity an MTTK run conserves: the universe energy plus the
    molecular bath's energy (``thermostats.mttk_energy``), per step."""
    from cavmd_tpu_torch.integrate import MTTKState, mttk_energy
    from cavmd_tpu_torch.integrate import universe_energy

    return universe_energy(obs) + mttk_energy(
        MTTKState(obs["mttk_xi"], obs["mttk_eta"]), method.dof, method.kT,
        method.tau)


def bath_path(torch, pt, kind, warm, chunks, fused_step):
    """Phase 13a/13b: ``Simulation.run`` on phase 3's scene (f32, dense)
    with the ``kind`` bath on the molecules and Langevin on the photon,
    ``warm`` warm-up chunks then ``chunks`` chunks of CHUNK steps: K1-K3
    once a step (and once for the initial forces), K4/K5 never, finite
    observables. MTTK: the extended energy's drift max |E - E[0]| over the
    measured chunks held to MTTK_DRIFT_BOUND_HA, then REPLICA_PROFILED_STEPS
    profiled steps (device operations, device us and busy share a step,
    beside phase 11's profile of the fused Bussi step ``fused_step``).
    Berendsen: the mean molecular T of the last chunk held within
    BERENDSEN_T_BOUND_K of 100 K."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda

    snap = reference_scene(pt, 250, 46.0, torch.float32,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    methods = pt.resolve_methods(snap, bath_methods(pt, kind), ff.l_typeid)
    label = f"phase 13 ({kind}, N={snap.N})"
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, methods, dt=PC.fs_to_atomic_units(0.25),
                        seed=7, chunk_size=CHUNK, extra_obs=mttk_obs)
    sim.run(n_steps=warm * CHUNK)
    chunk_s, outs = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(n_steps=CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outs.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = (warm + chunks) * CHUNK
    for kname in ("dense_pair", "pppm_spread", "pppm_interpolate"):
        check(launches.get(kname, 0) == total + 1,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{total} steps (want {total + 1}, the initial forces too)")
    for kname in ("fused_pre_force", "fused_post_force"):
        check(launches.get(kname, 0) == 0,
              f"{label}: {kname} launched: the baths run unfused")
    obs = {k: np.concatenate([o[k] for o in outs])
           for k in OBS_KEYS + ("mttk_xi", "mttk_eta")}
    for k in obs:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    check(int(obs["timestep"][-1]) == total, f"{label}: timestep "
          f"{obs['timestep'][-1]}")
    rate = statistics.median(CHUNK / s for s in chunk_s)
    m = methods[0]
    T = 2.0 * obs["kinetic_molecular"] / (m.dof * PC.KB_HARTREE_PER_K)
    res = dict(n=snap.N, steps=chunks * CHUNK, steps_per_s=rate,
               chunk_steps_per_s=[CHUNK / s for s in chunk_s],
               mean_T_last_chunk_K=float(T[-CHUNK:].mean()),
               launches=launches)
    if kind == "mttk":
        E = extended_energy(obs, m)
        res["extended_drift_ha"] = float(np.abs(E - E[0]).max())
        res["final_xi"] = float(obs["mttk_xi"][-1])
        check(res["final_xi"] != 0.0, f"{label}: xi never moved")
        check(res["extended_drift_ha"] < MTTK_DRIFT_BOUND_HA,
              f"{label}: extended-energy drift {res['extended_drift_ha']} "
              f">= {MTTK_DRIFT_BOUND_HA} Ha")
        prof = profiled_steps(torch, lambda n: sim.run(n_steps=n),
                              REPLICA_PROFILED_STEPS, DENSE_STEP_MARKS[:3])
        res.update(device_ops_per_step=prof["ops"],
                   device_us_per_step=prof["us"],
                   busy_share=prof["us"] / (1e6 / rate),
                   profile_records_dropped=prof["dropped"],
                   top_device_us_per_step=prof["top_us"],
                   fused_device_ops_per_step=fused_step["device_ops_per_step"],
                   fused_device_us_per_step=fused_step["device_us_per_step"])
    else:
        dev_K = abs(res["mean_T_last_chunk_K"] - 100.0)
        res["T_deviation_K"] = dev_K
        check(dev_K < BERENDSEN_T_BOUND_K,
              f"{label}: mean T of the last chunk "
              f"{res['mean_T_last_chunk_K']} K, {dev_K} K from 100 K >= "
              f"{BERENDSEN_T_BOUND_K} K")
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def bath_large_path(torch, pt, default_ms, default_prof):
    """Phase 13c: ``build_large_n(50_000)``'s scene and force field (N =
    100,001, cell mode, f32) through ``Simulation.run`` with MTTK on the
    molecules and Langevin on the photon: one warm-up chunk, then
    BATH_LARGE_CHUNKS chunks of LARGE_CHUNK steps. No overflow; the cell
    kernel, K2 and K3 once a step (and for the initial forces), K4/K5
    never; ms a step beside phase 6's default step (``default_ms``); the
    extended-energy band reported; REPLICA_PROFILED_STEPS profiled steps
    beside phase 12's one-replica profile (``default_prof``). Then one
    checkpoint of the final state saved and loaded, timed."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops.cell_kernels import kernel_name

    _, snap, ff = build_large_n(LARGE_N_MOL)
    methods = pt.resolve_methods(snap, bath_methods(pt, "mttk"),
                                 ff.l_typeid)
    cap = ff.cell_cfg.cap
    label = f"phase 13 (mttk, N={snap.N}, cell)"
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, methods,
                        dt=PC.fs_to_atomic_units(LARGE_DT_FS), seed=7,
                        extra_obs=mttk_obs)
    sim.run(n_steps=LARGE_CHUNK)
    chunk_s, outs = [], []
    for _ in range(BATH_LARGE_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=LARGE_CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outs.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = LARGE_CHUNK * (BATH_LARGE_CHUNKS + 1)
    obs = {k: np.concatenate([o[k] for o in outs])
           for k in OBS_KEYS + ("cell_overflow", "mttk_xi", "mttk_eta")}
    check(not obs["cell_overflow"].any() and sim.ff.cell_cfg.cap == cap,
          f"{label}: the cell list overflowed")
    for k in obs:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    for kname in (kernel_name(ff.cell_cfg), "pppm_spread",
                  "pppm_interpolate"):
        check(launches.get(kname, 0) == total + 1,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{total} steps (want {total + 1})")
    for kname in ("fused_pre_force", "fused_post_force"):
        check(launches.get(kname, 0) == 0, f"{label}: {kname} launched")
    E = extended_energy(obs, methods[0])
    ms = statistics.median(s / LARGE_CHUNK * 1e3 for s in chunk_s)
    prof = profiled_steps(torch, lambda n: sim.run(n_steps=n),
                          REPLICA_PROFILED_STEPS, CELL_STEP_MARKS[:3])
    from cavmd_tpu_torch.io import load_checkpoint, save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path, sim.state)
        save_ms = (time.perf_counter() - t0) * 1e3
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        back = load_checkpoint(path, sim.state)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(back.position, sim.state.position)
          and torch.equal(back.cell_list.bucket_idx,
                          sim.state.cell_list.bucket_idx),
          f"{label}: the checkpoint did not read back")
    res = dict(n=snap.N, ncells=ff.cell_cfg.ncells, cap=cap,
               steps=BATH_LARGE_CHUNKS * LARGE_CHUNK, ms_per_step=ms,
               default_ms_per_step=default_ms,
               extended_band_ha=float(E.max() - E.min()),
               final_xi=float(obs["mttk_xi"][-1]),
               device_ops_per_step=prof["ops"],
               device_us_per_step=prof["us"],
               busy_share=prof["us"] / (ms * 1e3),
               profile_records_dropped=prof["dropped"],
               default_device_ops_per_step=default_prof[0],
               default_device_us_per_step=default_prof[1],
               checkpoint_save_ms=save_ms, checkpoint_load_ms=load_ms,
               checkpoint_mb=size_mb, launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def resume_path(torch, pt, mode):
    """Phase 13d: an exact resume on the card, f64, MTTK + Langevin:
    2 RESUME_K steps in one run against RESUME_K steps, a checkpoint
    saved and loaded into a fresh ``init_state`` template, and RESUME_K
    more. Dense mode on the N = 501 scene, cell mode (the carried list)
    at N = 4001: positions within TRAJ_TOL_BOHR (K2 adds with float
    atomics, so the two runs need not agree bit for bit), the generators'
    states equal, (xi, eta) within RESUME_MTTK_REL."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import init_state, make_step_fn, run_steps
    from cavmd_tpu_torch.io import load_checkpoint, save_checkpoint

    n_mol = 250 if mode == "dense" else 2000
    snap = reference_scene(pt, n_mol, 46.0 if mode == "dense"
                           else reference_box_for(n_mol), torch.float64,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode=mode)
    step = make_step_fn(ff, pt.resolve_methods(
        snap, bath_methods(pt, "mttk"), ff.l_typeid))

    def fresh():
        return init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=7)

    whole, _ = run_steps(step, fresh(), 2 * RESUME_K)
    half, _ = run_steps(step, fresh(), RESUME_K)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        save_checkpoint(path, half)
        resumed = load_checkpoint(path, fresh())
    final, _ = run_steps(step, resumed, RESUME_K)
    label = f"phase 13 (resume, {mode}, N={snap.N}, f64)"
    dx = float((final.position - whole.position).abs().max())
    gens = (set(final.generators) == set(whole.generators) and all(
        torch.equal(g.get_state(), whole.generators[k].get_state())
        for k, g in final.generators.items()))
    rel = max(float((getattr(final, k) - getattr(whole, k)).abs().max())
              / float(getattr(whole, k).abs().max())
              for k in ("mttk_xi", "mttk_eta"))
    carried = (final.cell_list is not None) == (mode == "cell")
    print(f"{label}: {RESUME_K} + {RESUME_K} steps through a checkpoint vs "
          f"{2 * RESUME_K} in one run: max|dx| = {dx!r} bohr (bound "
          f"{TRAJ_TOL_BOHR}), generators equal: {gens}, (xi, eta) rel "
          f"{rel!r} (bound {RESUME_MTTK_REL}), carried list: "
          f"{final.cell_list is not None}", flush=True)
    check(dx <= TRAJ_TOL_BOHR and gens and rel <= RESUME_MTTK_REL
          and carried, f"{label}: the resumed run left the uninterrupted "
          "one")
    return dict(n=snap.N, max_dx_bohr=dx, mttk_rel=rel)


def triatomic_snapshot(pt, n_mol, box_L, dtype, device):
    """The OCO triatomic liquid of tests/test_polyatomic.py:42 built with
    NumPy: a cubic lattice of linear molecules (C=O 2.2 bohr) with random
    orientations, strained by 0.08-bohr noise; bonds [[3m, 3m+1],
    [3m, 3m+2]], so each carbon's exclusion row holds two partners."""
    import numpy as np

    from cavmd_tpu_torch.core.snapshot import Snapshot

    rng = np.random.default_rng(0)
    n_side = int(np.ceil(n_mol ** (1 / 3)))
    spacing = box_L / n_side
    grid = np.arange(n_side) * spacing - box_L / 2 + spacing / 2
    centers = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"),
                       axis=-1).reshape(-1, 3)[:n_mol]
    u = rng.normal(size=(n_mol, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.empty((3 * n_mol, 3))
    pos[0::3] = centers
    pos[1::3] = centers + 2.2 * u
    pos[2::3] = centers - 2.2 * u
    pos += rng.normal(scale=0.08, size=pos.shape)
    base = 3 * np.arange(n_mol)
    bonds = np.stack([np.repeat(base, 2),
                      np.stack([base + 1, base + 2], 1).reshape(-1)], axis=1)
    return Snapshot.create(
        pos, [box_L] * 3, typeid=np.tile([0, 1, 1], n_mol),
        charge=np.tile([0.4, -0.2, -0.2], n_mol),
        mass=np.tile([21894.0, 29164.0, 29164.0], n_mol), types=("C", "O"),
        bond_group=bonds, bond_typeid=np.zeros(len(bonds), np.int64),
        bond_types=("C-O",), dtype=dtype, device=device)


def triatomic_phase(torch, pt):
    """Phase 13e: K1 (dense, TRI_N_MOL[0] molecules) and the cell kernel
    (cell mode, TRI_N_MOL[1] molecules, 17^3 cells) on the triatomic
    scene at the reference density, f32 and f64, against their twins
    under phase 2's tolerances; two calls bit-equal."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import pair_kernels as pk

    out = {}
    for n_mol, mode in zip(TRI_N_MOL, ("dense", "cell")):
        box = reference_box_for(3 * n_mol / 2)
        for dtype in (torch.float32, torch.float64):
            snap = triatomic_snapshot(pt, n_mol, box, dtype,
                                      torch.device("cuda"))
            ff = pt.ForceField.create(
                snap, enable_cavity=False, lj_params=TRI_LJ,
                bond_params={"C-O": dict(k=0.8, r0=2.2)}, pair_mode=mode)
            name = str(dtype).replace("torch.", "")
            label = f"phase 13 (triatomic, {mode}, N={snap.N}, {name})"
            check(not ff.bonds_strided, f"{label}: strided bonds")
            if mode == "dense":
                args = (snap.position, snap.box_L, snap.typeid, ff.lj_eps,
                        ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift, snap.charge,
                        ff.lj_active, ff.coulomb_active, ff.kappa_value,
                        ff.coulomb_rcut ** 2)
                kern, plain = pk.dense_pair_force, pk.dense_pair_force_plain
            else:
                check(ff.cell_exclusions.shape[1] == 2,
                      f"{label}: exclusion rows {ff.cell_exclusions.shape}")
                clist = ff.build_cells(snap.position, snap.box_L)
                check(not bool(clist.overflow), f"{label}: overflow")
                args = (snap.position, snap.box_L, clist, ff.cell_cfg,
                        snap.typeid, snap.charge, ff.lj_eps, ff.lj_sig2,
                        ff.lj_rcut2, ff.lj_vshift, ff.cell_exclusions,
                        ff.kappa_value)
                kern = ck.cell_pair_force_fused
                plain = ck.cell_pair_force_fused_plain
            first, second = kern(*args), kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            errs = [max_err(a, b) for a, b in zip(first, ref)]
            same = all(torch.equal(a, b) for a, b in zip(first, second))
            print(f"{label}: max|diff| vs twin (forces, LJ, Ewald) "
                  f"{[e for e, _ in errs]!r} of scales "
                  f"{[s for _, s in errs]!r} (tol {TOL[name]} of the "
                  f"scale), two calls bit-equal: {same}", flush=True)
            check(all(e <= TOL[name] * s for e, s in errs) and same,
                  f"{label}: the kernel left its twin or two calls differ")
            out[(mode, name)] = errs[0][0]
    return out


def bath_replica_trajectory(torch, pt):
    """Phase 13f: REPLICA_F64_B thermalized float64 replicas of the N = 501
    scene, REPLICA_F64_STEPS MTTK + Langevin steps in one batch on the
    card, against one-replica card runs with the same draws: positions
    within TRAJ_TOL_BOHR, each replica's own (xi, eta), K1-K3 once a step
    for the batch."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    B, steps = REPLICA_F64_B, REPLICA_F64_STEPS
    snap = reference_scene(pt, 250, 46.0, torch.float64,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    methods = pt.resolve_methods(snap, bath_methods(pt, "mttk"), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(0.25), seed=7,
                                kT=PC.kT_from_kelvin(100.0))
    draws = CardDraws(torch, B, torch.float64)
    _cuda.reset_launches()
    final, _ = run_replica_steps(make_step_fn(ff, methods, noise=draws),
                                 batch, steps)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    err, xi_rel = 0.0, 0.0
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA})
        fr, _ = run_steps(make_step_fn(ff, methods, noise=draws.replica(r)),
                          one, steps)
        err = max(err, float((final.position[r] - fr.position).abs().max()))
        xi_rel = max(xi_rel, abs(float(final.mttk_xi[r, 0] - fr.mttk_xi[0]))
                     / abs(float(fr.mttk_xi[0])))
    distinct = len(set(final.mttk_xi[:, 0].tolist())) == B
    print(f"phase 13: f64 MTTK + Langevin {steps} steps of {B} replicas at "
          f"N={snap.N} in one batch vs one-replica runs, same draws, on the "
          f"card: max|dx| = {err!r} bohr (bound {TRAJ_TOL_BOHR}), xi rel "
          f"{xi_rel!r}, each replica its own xi: {distinct}, batch launches "
          f"{launches}", flush=True)
    check(err <= TRAJ_TOL_BOHR and xi_rel <= RESUME_MTTK_REL and distinct,
          f"phase 13 f64 MTTK batch: max|dx| {err} bohr > {TRAJ_TOL_BOHR}, "
          f"xi rel {xi_rel} or replicas sharing one xi")
    for kname in BATCHED_KERNELS[:3]:
        check(launches.get(kname, 0) == steps,
              f"phase 13 f64 MTTK batch: {kname} launched "
              f"{launches.get(kname, 0)} times in {steps} steps")
    return err


# --------------------------------------------------------------- phase 14
def rank_cli_job(args, workdir):
    """A ``run_ranks`` job: ``advanced_run.main(args)`` on this rank, in
    ``workdir``, its stdout kept. Returns the exit code, the text, this
    rank's kernel launches and the CUDA device it ran on."""
    import torch

    from cavmd_tpu_torch.drivers import advanced_run
    from cavmd_tpu_torch.ops import _cuda

    os.chdir(workdir)
    buf = io.StringIO()
    _cuda.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = advanced_run.main(args)
    torch.cuda.synchronize()
    return dict(rc=rc, out=buf.getvalue(), launches=dict(_cuda.launches),
                device=torch.cuda.current_device(),
                cuda=torch.cuda.is_initialized())


def shard_batch(torch, pt):
    """14b's batch: SHARD_R replicas of phase 9's float64 scene (N =
    20,001, cell mode, Bussi + Langevin), thermalized at seed 7 + r, on
    the card: (ff, methods, plan at one slab, batch)."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.parallel import init_replica_states, plan_domain

    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           torch.float64, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=SHARD_R,
                                dt=PC.fs_to_atomic_units(LARGE_DT_FS),
                                seed=7, kT=kT)
    return ff, methods, plan_domain(snap, ff, 1), batch


def rank_domain_job():
    """A ``run_ranks`` job (14b): ``make_domain_runner(n_replicas=R)`` at
    one slab on R ranks, DOMAIN_F64_STEPS steps rebuilt every 20. Returns
    the stacked final batch, the overflow flag, this rank's launches and
    its CUDA device."""
    import torch

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import make_domain_runner
    from cavmd_tpu_torch.simulation import DOMAIN_REBUILD_EVERY

    ff, methods, plan, batch = shard_batch(torch, pt)
    run = make_domain_runner(ff, methods, plan, n_replicas=SHARD_R,
                             rebuild_every=DOMAIN_REBUILD_EVERY)
    _cuda.reset_launches()
    fin, obs = run(batch, DOMAIN_F64_STEPS)
    torch.cuda.synchronize()
    return dict(position=fin.position.cpu().numpy(),
                image=fin.image.cpu().numpy(),
                overflow=bool(obs["cell_overflow"].any()),
                launches=dict(_cuda.launches),
                device=torch.cuda.current_device(),
                on_card=fin.position.is_cuda)


def gsd_logs(path):
    """{(frame, name): values} of every ``log/`` chunk of a GSD file."""
    from cavmd_tpu_torch.io.gsd import GSDFile

    f = GSDFile(path)
    try:
        return {(k, n): f.read_chunk(k, n) for k in range(f.nframes)
                for n in f._names if n.startswith("log/")
                and f.chunk_exists(k, n)}
    finally:
        f.close()


def shard_f64_match(label, got_dir, want_dir, replicas):
    """14a's float64 check: each replica's energy rows of the R-rank run
    against the one-rank batch's, and the unrounded ``log/`` chunks of
    every GSD frame, each quantity to SHARD_F64_RTOL of its largest
    magnitude over the frames (a reservoir total of ~1e-7 Ha is a
    difference of terms a thousand times larger). Returns the largest
    such relative difference and the row count."""
    import numpy as np

    worst, n_rows = 0.0, 0
    for r in replicas:
        name = f"prod-{r}_energy_tracker.txt"
        rows = [np.loadtxt(os.path.join(d, name), comments=("#", "time"),
                           ndmin=2) for d in (got_dir, want_dir)]
        check(rows[0].shape == rows[1].shape and rows[1].shape[0] >= 5,
              f"{label}: {name} rows {rows[0].shape} vs {rows[1].shape}")
        # the rows carry 6 decimals: a value within SHARD_F64_RTOL may
        # still print one unit apart in the last place
        check(np.allclose(rows[0], rows[1], rtol=SHARD_F64_RTOL,
                          atol=1.0000001e-6),
              f"{label}: {name} differs from the one-rank batch's")
        n_rows += rows[1].shape[0]
        logs = [gsd_logs(os.path.join(d, f"prod-{r}.gsd"))
                for d in (got_dir, want_dir)]
        check(sorted(logs[0]) == sorted(logs[1]) and len(logs[1]) > 10,
              f"{label}: replica {r}'s GSD log chunks differ")
        for key in sorted({n for _, n in logs[1]}):
            got, want = (np.concatenate([np.ravel(lg[k]) for k in sorted(lg)
                                         if k[1] == key]) for lg in logs)
            scale = max(float(np.abs(want).max()), 1e-300)
            rel = float(np.abs(got - want).max()) / scale
            check(rel <= SHARD_F64_RTOL,
                  f"{label}: replica {r} {key}: relative {rel} > "
                  f"{SHARD_F64_RTOL}")
            worst = max(worst, rel)
    return worst, n_rows


def shard_replicas_phase(torch, pt, one_rank_cli):
    """Phase 14a and 14b: one ``run_ranks`` spawn of SHARD_R ranks on the
    one card (gloo, file rendezvous) runs 14a's ``--shard-replicas`` CLI
    in float32 and in float64 and 14b's replicas x slabs runner; this
    process runs their one-rank references. ``one_rank_cli`` is phase
    11d's result (the same arguments in one process)."""
    import numpy as np

    from cavmd_tpu_torch.drivers import advanced_run
    from cavmd_tpu_torch.integrate import make_step_fn
    from cavmd_tpu_torch.parallel import run_replica_steps
    from cavmd_tpu_torch.parallel.launch import run_ranks

    B = REPLICA_B
    f32_args = CLI_ARGS + ["--vmap-replicas", "--replicas", f"1-{B}",
                           "--shard-replicas", str(SHARD_R)]
    f64_args = CLI_ARGS + SHARD_F64_ARGS + ["--replicas", f"1-{B}"]
    work = tempfile.mkdtemp(prefix="cavmd_shard_")
    dirs = {k: os.path.join(work, k) for k in ("f32", "f64", "f64_one")}
    for d in dirs.values():
        os.mkdir(d)
    cwd = os.getcwd()
    label = f"phase 14a CLI --shard-replicas {SHARD_R} B={B} N=501"
    try:
        t0 = time.perf_counter()
        f32, f64, dom = run_ranks([
            (rank_cli_job, (f32_args, dirs["f32"])),
            (rank_cli_job, (f64_args + ["--shard-replicas", str(SHARD_R)],
                            dirs["f64"])),
            (rank_domain_job, ())], SHARD_R, timeout=600)
        spawn_s = time.perf_counter() - t0
        # --- 14a, float32: phase 11d's checks on the R ranks' files
        for k, r in enumerate(f32):
            check(r["rc"] == 0 and r["cuda"],
                  f"{label}: rank {k} exited {r['rc']}: {r['out'][-2000:]}")
        n_rep, steps, wall, agg = vmapped_line(label, f32[0]["out"])
        check(n_rep == B and f"on {SHARD_R} ranks" in f32[0]["out"],
              f"{label}: {n_rep} replicas")
        out_dir = os.path.join(dirs["f32"], "cavity_coupling_1eneg03")
        drifts, frames = replica_files(torch, label, out_dir,
                                       range(1, B + 1), 501, 1000)
        check(max(drifts) < VMAP_CLI_DRIFT_BOUND_HA,
              f"{label}: universe drifts {drifts} >= "
              f"{VMAP_CLI_DRIFT_BOUND_HA}")
        for k, r in enumerate(f32):
            for kname in BATCHED_KERNELS:
                n = r["launches"].get(kname, 0)
                check(n == steps if kname.startswith("fused")
                      else n >= steps,
                      f"{label}: rank {k} launched {kname} {n} times in "
                      f"{steps} steps")
        devices = sorted({r["device"] for r in f32 + f64 + dom})
        print(f"{label}: exit 0 on {SHARD_R} ranks on cuda device(s) "
              f"{devices} of {torch.cuda.device_count()}; {steps} steps in "
              f"{wall!r} s, {agg} aggregate steps/s (one rank, phase 11d: "
              f"{one_rank_cli['aggregate_steps_per_s']}, "
              f"{one_rank_cli['steps']} steps in "
              f"{one_rank_cli['run_seconds']!r} s); universe drifts "
              f"{drifts} (bound {VMAP_CLI_DRIFT_BOUND_HA}); GSD frames "
              f"{frames}; launches per rank "
              f"{[r['launches'] for r in f32]}", flush=True)
        # --- 14a, float64: the R ranks against the one-rank batch
        label64 = f"phase 14a CLI f64 --shard-replicas {SHARD_R} B={B}"
        for k, r in enumerate(f64):
            check(r["rc"] == 0, f"{label64}: rank {k} exited {r['rc']}: "
                  f"{r['out'][-2000:]}")
        os.chdir(dirs["f64_one"])
        with contextlib.redirect_stdout(io.StringIO()):
            rc = advanced_run.main(f64_args + ["--vmap-replicas"])
        check(rc == 0, f"{label64}: the one-rank batch exited {rc}")
        os.chdir(cwd)
        rel, n_rows = shard_f64_match(
            label64, *(os.path.join(dirs[k], "cavity_coupling_1eneg03")
                       for k in ("f64", "f64_one")), range(1, B + 1))
        print(f"{label64}: {n_rows} energy rows of {B} replicas and every "
              f"GSD frame's log/ chunks against the one-rank batch: "
              f"largest relative difference of the unrounded values "
              f"{rel!r} (tolerance {SHARD_F64_RTOL}: K2's atomics sum the "
              "grid in another order on every run)", flush=True)
        # --- 14b: the replicas x slabs runner against run_replica_steps
        label_b = (f"phase 14b make_domain_runner(n_replicas={SHARD_R}) "
                   "at 1 slab")
        ff, methods, _, batch = shard_batch(torch, pt)
        ref, _ = run_replica_steps(make_step_fn(ff, methods), batch,
                                   DOMAIN_F64_STEPS)
        want = ref.position.cpu().numpy()
        errs = []
        for k, r in enumerate(dom):
            check(r["on_card"] and not r["overflow"],
                  f"{label_b}: rank {k} on the card {r['on_card']}, "
                  f"overflow {r['overflow']}")
            errs.append(float(np.abs(r["position"] - want).max()))
            check(np.array_equal(r["image"], ref.image.cpu().numpy()),
                  f"{label_b}: rank {k}'s image flags differ")
            for kname in ("cell_pair_slab", "pppm_spread",
                          "pppm_interpolate"):
                n = r["launches"].get(kname, 0)
                check(n >= DOMAIN_F64_STEPS,
                      f"{label_b}: rank {k} launched {kname} {n} < "
                      f"{DOMAIN_F64_STEPS} times")
        check(max(errs) <= TRAJ_TOL_BOHR,
              f"{label_b}: max|dx| {errs} bohr > {TRAJ_TOL_BOHR}")
        check(not np.allclose(want[0], want[1]),
              f"{label_b}: the replicas did not decorrelate")
        print(f"{label_b}: N={want.shape[1]} f64, {DOMAIN_F64_STEPS} steps "
              f"on {SHARD_R} ranks, each replica vs run_replica_steps on "
              f"the card: max|dx| {errs} bohr (bound {TRAJ_TOL_BOHR}); "
              f"launches per rank {[r['launches'] for r in dom]}; the "
              f"spawn with 14a took {spawn_s:.1f} s", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return dict(aggregate_steps_per_s=agg, steps=steps, run_seconds=wall,
                drifts=drifts, f64_rel=rel, domain_dx=max(errs),
                spawn_seconds=spawn_s)


def native_io_phase(torch, pt):
    """Phase 14c: the native host I/O library loads; the N = 501 CLI's
    energy file with every EnergyTracker twinned by one that formats in
    Python (the same bytes), with each consume's host ms both ways; a
    500-row chunk with every row written and one at the CLI's period of
    1000 steps, both ways; a GSD frame at N = 100,001, both ways."""
    import numpy as np

    import cavmd_tpu_torch.observe as observe
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.drivers import advanced_run
    from cavmd_tpu_torch.io import HOOMDTrajectory, native

    label = "phase 14c native I/O"
    check(native.load() is not None,
          f"{label}: the native library did not load")
    real_load = native.load

    @contextlib.contextmanager
    def python_only():
        native.load = lambda: None
        try:
            yield
        finally:
            native.load = real_load

    Real = observe.EnergyTracker
    ms = {"native": [], "python": []}

    class Twinned(Real):
        """The CLI's tracker, fed to a twin that formats in Python."""

        def __init__(self, **kw):
            super().__init__(**kw)
            with python_only():
                self.twin = Real(**dict(
                    kw, output_prefix=kw["output_prefix"] + "_python"))

        def consume(self, obs):
            t0 = time.perf_counter()
            super().consume(obs)
            t1 = time.perf_counter()
            with python_only():
                self.twin.consume(obs)
            t2 = time.perf_counter()
            ms["native"].append(1e3 * (t1 - t0))
            ms["python"].append(1e3 * (t2 - t1))

    work = tempfile.mkdtemp(prefix="cavmd_native_")
    cwd = os.getcwd()
    try:
        os.chdir(work)
        observe.EnergyTracker = Twinned
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = advanced_run.main(CLI_ARGS + [
                    "--runtime", str(NATIVE_CLI_RUNTIME_PS),
                    "--energy-output-period-ps", "0.0001"])
        finally:
            observe.EnergyTracker = Real
        check(rc == 0, f"{label}: the CLI exited {rc}")
        out = os.path.join(work, "cavity_coupling_1eneg03")
        a, b = (Path(out, f).read_bytes() for f in (
            "prod-1_energy_tracker.txt", "prod-1_python_energy_tracker.txt"))
        n_rows = sum(1 for line in a.splitlines() if line[:1].isdigit())
        check(a == b, f"{label}: the energy file with the library "
              f"({len(a)} B) differs from the Python one ({len(b)} B)")
        check(n_rows > NATIVE_CHUNK, f"{label}: {n_rows} energy rows")
        cli_ms = {k: statistics.median(v) for k, v in ms.items()}

        # a 500-row chunk of the run's own columns, both ways
        rng = np.random.default_rng(0)
        obs = {k: rng.normal(size=NATIVE_CHUNK) for k in (
            "harmonic", "lj", "ewald_short", "ewald_long", "cavity_harmonic",
            "cavity_coupling", "cavity_dipole_self", "kinetic_molecular",
            "kinetic_cavity", "bussi_reservoir_molecular",
            "bussi_reservoir_cavity", "langevin_reservoir_molecular",
            "langevin_reservoir_cavity")}
        obs["time_au"] = np.arange(NATIVE_CHUNK) * 0.65
        chunk_ms = {}
        for period in (1, 1000):
            for way in ("native", "python"):
                times = []
                for k in range(NATIVE_REPS):
                    o = dict(obs, timestep=np.arange(
                        k * NATIVE_CHUNK + 1, (k + 1) * NATIVE_CHUNK + 1))
                    ctx = (python_only() if way == "python"
                           else contextlib.nullcontext())
                    with ctx:
                        if k == 0:
                            tr = Real(output_prefix=f"c{period}{way}",
                                      output_period_steps=period,
                                      n_molecular_dof=1500)
                        t0 = time.perf_counter()
                        tr.consume(o)
                        times.append(1e3 * (time.perf_counter() - t0))
                chunk_ms[(period, way)] = statistics.median(times)

        # a GSD frame at N = 100,001 (f32 frame, log chunks), both ways
        snap = reference_scene(pt, LARGE_N_MOL,
                               reference_box_for(LARGE_N_MOL),
                               torch.float32, torch.device("cuda"))
        log = {f"EnergyTracker/x{k}": float(k) for k in range(20)}
        gsd_ms = {}
        for way, prefer in (("native", True), ("python", False)):
            times = []
            with HOOMDTrajectory(f"{way}.gsd", "w",
                                 prefer_native=prefer) as t:
                check(isinstance(t.file, native.NativeGSDWriter) == prefer,
                      f"{label}: the {way} GSD writer is "
                      f"{type(t.file).__name__}")
                for k in range(NATIVE_GSD_FRAMES):
                    t0 = time.perf_counter()
                    t.append(snap, step=k, log_data=log)
                    times.append(1e3 * (time.perf_counter() - t0))
            gsd_ms[way] = statistics.median(times)
        check(Path("native.gsd").read_bytes()
              == Path("python.gsd").read_bytes(),
              f"{label}: the two GSD files differ")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    res = dict(library=str(native.library_path().name),
               cli_rows=n_rows, cli_consume_ms=cli_ms,
               cli_chunks=len(ms["native"]),
               chunk500_all_rows_ms={w: chunk_ms[(1, w)]
                                     for w in ("native", "python")},
               chunk500_period1000_ms={w: chunk_ms[(1000, w)]
                                       for w in ("native", "python")},
               gsd_frame_n100001_ms=gsd_ms)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def slab_batch_inputs(torch, pt, dtype, B=REPLICA_B):
    """Phase 15a's inputs: B replicas of the N = 2 HELD_N_MOL + 1 scene
    (cell mode, one slab), positions jittered 0.3 bohr apart and
    re-wrapped: (force field, plan, batch)."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.parallel import domain as dm
    from cavmd_tpu_torch.parallel import init_replica_states

    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           dtype, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    plan = dm.plan_domain(snap, ff, 1)
    batch = init_replica_states(snap, ff, n_replicas=B, dt=1.0)
    batch = batch.replace(position=wrap_rows(torch, jitter_rows(
        torch, snap.position, B, 0.3, 5), snap.box_L), cell_list=None,
        cell_anchor=None)
    return ff, plan, batch


def hold_slab_batch(torch, ff, plan, batch, label, tol, timed):
    """The slab kernel (``cell_pair_slab``) over the batch's slab 0, each
    replica with its own slab tables (types, charges, exclusions, pair
    keys), in one launch, against its plain twin (within ``tol`` of the
    largest value), two calls bit-equal; K2 and K3 on the position tables
    (residents and halo copies) with their charge row a replica, against
    their twins. With ``timed`` also the kernel's device and host-bound
    ms, the twin's ms and the bound from these inputs
    (``cell_work_counts`` of each replica, the shared inputs counted
    once). Returns
    (results, (the call's args, cells and pair keys, the kernel's
    outputs, K2's grid, K3's grid input and output))."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.ops.neighbor import replica_list
    from cavmd_tpu_torch.parallel import domain as dm

    t_in = time.perf_counter()
    args, cells, key = dm.tile_pass_inputs(ff, plan, batch)
    B = args[0].shape[0]
    kern = ck.cell_pair_force_slab
    k, again = kern(*args, cells, key), kern(*args, cells, key)
    p = ck.cell_pair_force_fused_plain(*args, pair_key=key)
    torch.cuda.synchronize()
    check(all(bool(torch.equal(a, b)) for a, b in zip(k, again)),
          f"{label}: two calls differ")
    errs = []
    for a, b in zip(k, p):
        err, scale = max_err(a, b)
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
        check(err <= tol * max(scale, 1e-300),
              f"{label}: max|d| {err} > {tol}*{scale}")
        errs.append((err, scale))
    del p
    res = dict(replicas=B, n=batch.position.shape[1], rows=plan.Mtot,
               ncells=args[3].ncells, cap=plan.cap,
               max_abs_err=errs[0][0], scale=errs[0][1],
               max_abs_err_other_outputs=[e for e, _ in errs[1:]],
               bit_equal_calls=True)
    pos, q = args[0], args[5]
    box, order, mesh = batch.box_L, ff.pppm_order, tuple(ff.pppm_mesh)
    check(not bool(torch.equal(q[0], q[1])),
          f"{label}: the replicas' charge rows agree")
    grid = sk.spread_grid(pos, q, box, order, mesh)
    ct = torch.sin(torch.arange(grid.numel(), device=grid.device,
                                dtype=grid.dtype)).reshape(grid.shape)
    grad = sk.interpolate_grad(ct, pos, q, box, order, mesh)
    k23 = {}
    for kname, got, want in (
            ("pppm_spread", grid,
             sk.spread_grid_plain(pos, q, box, order, mesh)),
            ("pppm_interpolate", grad,
             sk.interpolate_grad_plain(ct, pos, q, box, order, mesh))):
        err, scale = max_err(got, want)
        check(bool(torch.isfinite(got).all()) and err <= tol * scale,
              f"{label} {kname}: max|d| {err} > {tol}*{scale} vs its twin")
        k23[kname] = dict(max_abs_err=err, scale=scale)
    if timed:
        t0 = time.perf_counter()
        blocks = ck.launch_blocks(cells[1], plan.cap, pos.device, B)
        n_bytes = n_ops = 0
        for r in range(B):
            nb, no, _ = cell_work_counts(
                torch, pos[r], box, replica_list(args[2], r), args[3],
                args[4][r], q[r], ff, args[10][r], blocks, pair_key=key[r])
            n_bytes, n_ops = n_bytes + nb, n_ops + no
        # shared by the replicas: the box, the four type tables and the
        # extended neighbour table
        e, T = pos.element_size(), ff.lj_eps.shape[0]
        n_bytes -= (B - 1) * (e * (3 + 4 * T * T)
                              + 4 * 27 * args[2].neighbor_cells.shape[0])
        t1 = time.perf_counter()
        res["ms"] = device_ms(torch, lambda: kern(*args, cells, key))
        res["host_call_ms"] = host_call_ms(torch,
                                           lambda: kern(*args, cells, key))
        t2 = time.perf_counter()
        # one twin call a trace: the twin issues thousands of operations a
        # replica, and the profiler's records cost host time by the count
        res["plain_ms"] = profiled_device_ms(
            torch, lambda: ck.cell_pair_force_fused_plain(*args,
                                                          pair_key=key),
            reps=1)
        res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, n_ops)
        res.update(bytes=n_bytes, ops=n_ops, seconds=dict(
            held=t0 - t_in, counts=t1 - t0, kernel_times=t2 - t1,
            twin_time=time.perf_counter() - t2))
    res["per_replica_charges"] = k23
    return res, (args, cells, key, k, grid, ct, grad)


def slab_batch_kernel_phase(torch, pt, dtype, timed):
    """Phase 15a: ``hold_slab_batch`` on REPLICA_B replicas at
    N = 2 HELD_N_MOL + 1 on one slab, and each replica against the
    one-replica launch on its own call (its tables equal the batch's
    rows; forces bit-equal, energies within TOL; K2 within TOL, K3
    bit-equal). In float32 also the device time of one replica's launch
    and of REPLICA_B one-replica launches beside the batched launch's,
    and K2's and K3's times with per-replica charges beside the same
    launches with one shared charge row (the twin's time and the bound
    are phase 15c's, at the main path's shapes)."""
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.parallel import domain as dm
    from cavmd_tpu_torch.parallel.replicas import replica_rows

    B = REPLICA_B
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    ff, plan, batch = slab_batch_inputs(torch, pt, dtype)
    label = f"phase 15a cell_pair_slab B={B} N={batch.position.shape[1]} " \
        f"{name}"
    res, (args, cells, key, k, grid, ct, grad) = hold_slab_batch(
        torch, ff, plan, batch, label, tol, timed=False)
    kern = ck.cell_pair_force_slab
    ones, worst = [], 0.0
    for r in range(B):
        a1, c1, k1 = dm.tile_pass_inputs(ff, plan, replica_rows(batch, r))
        check(c1 == cells and bool(torch.equal(k1, key[r])) and all(
            bool(torch.equal(args[i][r], a1[i])) for i in (0, 4, 5, 10)),
            f"{label}: replica {r}'s tables differ from its own call's")
        one = kern(*a1, c1, k1)
        check(bool(torch.equal(k[0][r], one[0])),
              f"{label}: replica {r}'s forces differ from its one-replica "
              "launch")
        for a, b in zip(k[1:], one[1:]):
            err, scale = max_err(a[r], b)
            check(err <= tol * scale, f"{label}: replica {r}'s energy off "
                  f"its one-replica launch by {err}")
            worst = max(worst, err)
        ones.append((a1, c1, k1))
    res.update(forces_bit_equal_to_one_replica_launches=True,
               max_abs_err_energy_to_one_replica_launches=worst)
    # K2 and K3 a replica at a time (at one slab every replica's residents
    # hold the molecules in one order; the halo copies differ)
    pos, q = args[0], args[5]
    box, order, mesh = batch.box_L, ff.pppm_order, tuple(ff.pppm_mesh)
    k23 = res["per_replica_charges"]
    for kname, got, one in (
            ("pppm_spread", grid,
             lambda r: sk.spread_grid(pos[r], q[r], box, order, mesh)),
            ("pppm_interpolate", grad,
             lambda r: sk.interpolate_grad(ct[r].contiguous(), pos[r], q[r],
                                           box, order, mesh))):
        one_err = max(max_err(got[r], one(r))[0] for r in range(B))
        if kname == "pppm_interpolate":  # no atomics: the same bits
            check(one_err == 0.0, f"{label} {kname}: a replica differs "
                  f"from its one-replica launch by {one_err}")
        check(one_err <= tol * k23[kname]["scale"], f"{label} {kname}: a "
              f"replica off its one-replica launch by {one_err}")
        k23[kname]["max_abs_err_to_one_replica_launches"] = one_err
    if timed:
        res["ms"] = device_ms(torch, lambda: kern(*args, cells, key))
        res["one_replica_ms"] = device_ms(
            torch, lambda: kern(*ones[0][0], cells, ones[0][2]))
        res[f"{B}_one_replica_launches_ms"] = device_ms(
            torch, lambda: [kern(*a1, c1, k1) for a1, c1, k1 in ones])
        shared_q = q[0].contiguous()
        k23["pppm_spread"].update(
            ms=device_ms(torch, lambda: sk.spread_grid(pos, q, box, order,
                                                       mesh)),
            shared_charge_ms=device_ms(torch, lambda: sk.spread_grid(
                pos, shared_q, box, order, mesh)))
        k23["pppm_interpolate"].update(
            ms=device_ms(torch, lambda: sk.interpolate_grad(
                ct, pos, q, box, order, mesh)),
            shared_charge_ms=device_ms(torch, lambda: sk.interpolate_grad(
                ct, pos, shared_q, box, order, mesh)))
    print(f"{label}: " + ", ".join(f"{a}={v!r}" for a, v in res.items()),
          flush=True)
    return res


def slab_batch_f64_trajectory(torch, pt):
    """Phase 15b: REPLICA_F64_B thermalized float64 replicas of the
    N = 2 HELD_N_MOL + 1 scene through the batched slab runner at one slab
    (rebuilt every DOMAIN_REBUILD_EVERY steps), DOMAIN_F64_STEPS Bussi +
    Langevin steps of LARGE_DT_FS, against ``run_replica_steps`` of the
    batch in cell mode on the card, each drawing the batch's streams from
    generators seeded alike: every replica within TRAJ_TOL_BOHR, image
    flags equal, no overflow, the slab kernel, K2 and K3 launched once a
    step for the whole batch."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import make_step_fn
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        make_domain_runner,
        plan_domain,
        run_replica_steps,
    )
    from cavmd_tpu_torch.simulation import DOMAIN_REBUILD_EVERY

    B, steps = REPLICA_F64_B, DOMAIN_F64_STEPS
    snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                           torch.float64, torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="cell")
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(LARGE_DT_FS),
                                seed=7, kT=kT)
    ref, _ = run_replica_steps(make_step_fn(ff, methods),
                               batch.replace(generators={}), steps)
    run = make_domain_runner(ff, methods, plan_domain(snap, ff, 1),
                             rebuild_every=DOMAIN_REBUILD_EVERY)
    _cuda.reset_launches()
    fin, obs = run(batch.replace(generators={}), steps)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    label = f"phase 15b f64 batch over slabs B={B}"
    errs = (fin.position - ref.position).abs().amax(dim=(1, 2)).tolist()
    img_ok = bool(torch.equal(fin.image, ref.image))
    print(f"{label}: Bussi + Langevin {steps} steps at N={snap.N}, the "
          f"batched slab runner (1 slab, rebuilt every "
          f"{DOMAIN_REBUILD_EVERY}) vs run_replica_steps on the card: "
          f"max|dx| per replica {errs} bohr (bound {TRAJ_TOL_BOHR}), images "
          f"equal: {img_ok}, launches {launches}", flush=True)
    check(not obs["cell_overflow"].any(), f"{label}: overflow")
    check(max(errs) <= TRAJ_TOL_BOHR and img_ok,
          f"{label}: max|dx| {errs} bohr > {TRAJ_TOL_BOHR} or images differ")
    check(not bool(torch.equal(ref.position[0], ref.position[1])),
          f"{label}: the replicas did not decorrelate")
    for kname in ("cell_pair_slab", "pppm_spread", "pppm_interpolate"):
        check(launches.get(kname, 0) == steps,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{steps} steps")
    return dict(max_dx_bohr=max(errs), per_replica=errs, launches=launches)


SLAB_STEP_MARKS = ("cell_pair_kernel", "spread_kernel", "interpolate_kernel")


def slab_step_profile(torch, ff, methods, plan, batch):
    """The device side of the slab step alone, ``profiled_steps`` of
    REPLICA_PROFILED_STEPS steps on one layout (the step of the runner,
    without its rebuilds), and of one rebuild with its scatter in and out
    (``profiled_device_ms``: ms and device operations)."""
    from cavmd_tpu_torch.integrate.integrator import ObsBuffer
    from cavmd_tpu_torch.parallel import domain as dm
    from cavmd_tpu_torch.parallel.comm import Communicator

    comm = Communicator()
    step = dm.make_domain_step(ff, methods, plan, comm)
    tables = dm.plan_tables(plan, batch.device)

    def rebuild():
        data = dm._rebuild(batch.position, plan, batch.box_L, ff.bond_k_per,
                           ff.bond_r0_per, ff.pair_inert, batch.charge,
                           tables)
        loc, dat = dm._scatter_in(batch, data, plan, 0)
        return data, loc, dat, dm._scatter_out(batch, data, loc, batch,
                                               plan, comm)

    data, loc, dat, _ = rebuild()
    state = {"loc": loc, "rep": batch}

    def run(n):
        buf = ObsBuffer(n)
        with torch.no_grad():
            for _ in range(n):
                state["loc"], state["rep"], obs = step(state["loc"],
                                                       state["rep"], dat)
                buf.add(obs)
        return buf.to_numpy()

    run(5)
    prof = profiled_steps(torch, run, REPLICA_PROFILED_STEPS,
                          SLAB_STEP_MARKS)
    with torch.no_grad():
        rb_ms, rb_ops = profiled_device_ms(torch, rebuild, ops=True)
    return prof, rb_ms, rb_ops


def slab_batch_step_path(torch, pt, band_ref, dom, big):
    """Phase 15c: REPLICA_B replicas of ``build_large_n(LARGE_N_MOL)``'s
    start (N = 100,001, f32, Bussi + Langevin, LARGE_DT_FS; replica r
    thermalized at seed 7 + r) through the batched slab runner at one slab
    (rebuilt every DOMAIN_REBUILD_EVERY steps) on phase 6's protocol, with
    the CLI's retry (a chunk whose coverage invariant fired in any replica
    runs again at half the cadence; a capacity overflow grows the plan):
    the slab kernel, K2 and K3 launched once a step for the batch (and a
    retry's start forces once), no overflow left, finite observables,
    each replica's universe band under DOMAIN_BAND_RATIO times phase 6's
    band ``band_ref`` (phase 9's
    bound); wall ms a step and aggregate steps/s beside phase 9's one
    replica on the slab path (``dom``: eight such runs in turn give its
    rate) and phase 12c's unsharded batch (``big``); then the slab step's
    device side at B = 1 and B = REPLICA_B (``slab_step_profile``: device
    operations a step name by name, equal within REPLICA_OPS_SLACK; device
    us; the rebuild's ms and operations counted apart and amortised over
    its cadence), device us a step with the rebuild amortised and the busy
    share; then ``hold_slab_batch`` on the final state (timed: the
    kernel row's numbers at the main path's shapes)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        make_domain_runner,
        plan_domain,
    )
    from cavmd_tpu_torch.parallel.domain import _as_batch
    from cavmd_tpu_torch.simulation import DOMAIN_REBUILD_EVERY, retry_state

    B = REPLICA_B
    sim, snap, ff = build_large_n(LARGE_N_MOL, dt_fs=LARGE_DT_FS)
    methods = sim.methods
    plan = plan_domain(snap, ff, 1)
    label = f"phase 15c batch over slabs B={B} N={snap.N}"
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=float(sim.state.dt), seed=7,
                                kT=PC.kT_from_kelvin(100.0)).replace(
                                    cell_list=None, cell_anchor=None)
    state = dict(b=batch, plan=plan, cadence=DOMAIN_REBUILD_EVERY,
                 steps_run=0, retries=[])
    state["run"] = make_domain_runner(ff, methods, plan,
                                      rebuild_every=state["cadence"])

    def run(n):
        """``n`` steps with the retry of the CLI's batch over slabs (and
        of ``Simulation`` on the slab path): a chunk that flags an
        overflow runs again from its start, the plan grown after a
        capacity overflow, the cadence halved after the coverage
        invariant fired."""
        start = state["b"]
        rng = {k: g.get_state() for k, g in start.generators.items()}
        while True:
            state["b"], obs = state["run"](start, n)
            state["steps_run"] += n
            if not obs["cell_overflow"].any():
                return obs
            grow = bool(obs["domain_capacity_overflow"].any())
            state["retries"].append("plan" if grow else "cadence")
            check(len(state["retries"]) <= 4,
                  f"{label}: overflow persists after {state['retries']}")
            if grow:
                state["plan"] = state["plan"].grow_cap()
            else:
                state["cadence"] = max(1, state["cadence"] // 2)
            state["run"] = make_domain_runner(
                ff, methods, state["plan"], rebuild_every=state["cadence"])
            start = retry_state(ff, start, rng)

    _cuda.reset_launches()
    t0 = time.perf_counter()
    run(LARGE_CHUNK)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    outs, chunk_s = [], []
    for _ in range(LARGE_CHUNKS):
        t0 = time.perf_counter()
        outs.append(run(LARGE_CHUNK))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    launches = dict(_cuda.launches)
    total, retries = state["steps_run"], len(state["retries"])
    # once a step for the batch; a retry's start forces (the unsharded
    # force field, ``retry_state``) add one launch of the cell kernel, K2
    # and K3
    for kname, n in (("cell_pair_slab", total), ("pppm_spread",
                                                 total + retries),
                     ("pppm_interpolate", total + retries),
                     ("cell_pair", retries)):
        check(launches.get(kname, 0) == n,
              f"{label}: {kname} launched {launches.get(kname, 0)} times in "
              f"{total} steps and {retries} retries")
    check(not any(k.startswith("fused") for k in launches),
          f"{label}: the fused tail ran: {launches}")
    obs = {k: np.concatenate([c[k] for c in outs])
           for k in OBS_KEYS + ("cell_overflow",)}
    check(not obs["cell_overflow"].any(), f"{label}: overflow")
    for k in OBS_KEYS:
        check(obs[k].shape == (LARGE_CHUNKS * LARGE_CHUNK, B)
              and bool(np.all(np.isfinite(obs[k]))),
              f"{label}: bad observable {k} {obs[k].shape}")
    check(bool(torch.isfinite(state["b"].position).all()),
          f"{label}: non-finite positions")
    U = universe_energy(obs)
    bands = (U.max(axis=0) - U.min(axis=0)).tolist()
    bound = DOMAIN_BAND_RATIO * band_ref
    check(max(bands) < bound,
          f"{label}: universe bands {bands} >= {bound} Ha")
    wall_ms = statistics.median(s / LARGE_CHUNK * 1e3 for s in chunk_s)
    final = state["b"]
    plan, cadence = state["plan"], state["cadence"]
    kern, _ = hold_slab_batch(torch, ff, plan, final, f"{label} kernels",
                              TOL["float32"], timed=True)
    print(f"{label} kernels at the final state: " + ", ".join(
        f"{k}={v!r}" for k, v in kern.items()), flush=True)
    torch.cuda.empty_cache()
    prof8, rb8_ms, rb8_ops = slab_step_profile(torch, ff, methods, plan,
                                               final)
    one = _as_batch(sim.state)
    prof1, rb1_ms, rb1_ops = slab_step_profile(torch, ff, methods, plan, one)
    check(abs(prof8["ops"] - prof1["ops"]) <= REPLICA_OPS_SLACK,
          f"{label}: the slab step's {prof8['ops']} device operations at "
          f"B={B} vs {prof1['ops']} at B=1")
    dev_us = prof8["us"] + rb8_ms * 1e3 / cadence
    res = dict(replicas=B, n=snap.N, steps=LARGE_CHUNKS * LARGE_CHUNK,
               steps_run=total, retries=state["retries"],
               rebuild_every=cadence, cap=plan.cap, wall_ms_per_step=wall_ms,
               chunk_ms_per_step=[s / LARGE_CHUNK * 1e3 for s in chunk_s],
               warmup_chunk_s=warm_s, aggregate_steps_per_s=B * 1e3 / wall_ms,
               one_replica_slab_ms_per_step=dom["ms_per_step"],
               one_replica_slab_runs_in_turn_aggregate_steps_per_s=(
                   1e3 / dom["ms_per_step"]),
               unsharded_batch_wall_ms_per_step=big["wall_ms_per_step"],
               unsharded_batch_aggregate_steps_per_s=big[
                   "aggregate_steps_per_s"],
               unsharded_batch_device_us_per_step=big["device_us_per_step"],
               unsharded_batch_busy_share=big["busy_share"],
               step_device_ops=prof8["ops"],
               step_device_ops_one_replica=prof1["ops"],
               step_device_records=prof8["records"],
               step_device_us=prof8["us"],
               step_device_us_one_replica=prof1["us"],
               rebuild_ms=rb8_ms, rebuild_device_ops=rb8_ops,
               rebuild_ms_one_replica=rb1_ms,
               rebuild_device_ops_one_replica=rb1_ops,
               device_us_per_step=dev_us,
               busy_share=dev_us / (wall_ms * 1e3),
               profile_records_dropped=prof8["dropped"],
               top_device_us_per_step=prof8["top_us"],
               one_replica_top_device_us_per_step=prof1["top_us"],
               universe_band_ha=bands, band_bound_ha=bound,
               launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    res["kernel"] = kern
    return res


# --------------------------------------------------------------- phase 16
def load_example(stem):
    """``examples/<stem>.py`` of this checkout as a module (the names
    start with a digit, so it is loaded by path)."""
    import importlib.util

    path = Path(__file__).resolve().parent / "examples" / f"{stem}.py"
    check(path.is_file(), f"phase 16: {path} missing")
    spec = importlib.util.spec_from_file_location(f"example_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traced_launches(torch, fn, agree=None):
    """``fn()`` under ``torch.profiler``, taken again (``traces``) until
    the trace is complete: the device records of each kernel of
    TRACE_SYMBOLS equal the launches its wrappers counted in the same run.
    ``agree(complete)`` makes the decision one for every rank of a group
    (each rank retries, or returns, with the others). Returns (fn's
    result, the launches counted by name)."""
    from cavmd_tpu_torch.ops import _cuda

    def counted():
        _cuda.reset_launches()
        return fn(), dict(_cuda.launches)

    seen = []
    for (out, launches), dev in traces(torch, counted):
        traced = {sym: named(dev, sym) for sym in TRACE_SYMBOLS}
        want = {sym: sum(launches.get(w, 0) for w in ws)
                for sym, ws in TRACE_SYMBOLS.items()}
        seen.append(traced)
        complete = traced == want
        if (agree(complete) if agree is not None else complete):
            return out, launches
    fail(f"phase 16: no complete trace in {PROFILE_TRIES} (device records "
         f"{seen} against the wrappers' counts {want})")


def every_rank(complete: bool) -> bool:
    """Whether ``complete`` holds on every rank of the default group."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(complete)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def example_job(stem, kwargs):
    """A ``run_ranks`` job of one rank: an example's ``main(**kwargs)`` on
    the card, its launches counted by the wrappers. Returns the figures
    with ``seconds`` (of the job) and ``launches``."""
    import torch

    from cavmd_tpu_torch.ops import _cuda

    ex = load_example(stem)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    out = ex.main(**kwargs)
    torch.cuda.synchronize()
    return dict(out, seconds=time.perf_counter() - t0,
                launches=dict(_cuda.launches))


def example_rank_job(stem, kwargs):
    """A ``run_ranks`` job: an example's ``main(**kwargs)`` on this rank,
    on the card, its launches counted from a complete trace; the ranks
    retry together (``every_rank``), so no rank reruns ``main``, and its
    collectives, alone. Returns (the figures, the launches, the CUDA
    device, the seconds)."""
    import torch

    ex = load_example(stem)
    t0 = time.perf_counter()
    out, launches = traced_launches(torch, lambda: ex.main(**kwargs),
                                    agree=every_rank)
    return (out, launches, torch.cuda.current_device(),
            time.perf_counter() - t0)


def pppm_energy_phase(torch, pt, dtype):
    """``pppm_reciprocal_energy`` on the card (its spread kernel 2, once a
    call) against its plain twin's grid through the same mesh energy, on
    the N = 501 scene and on REPLICA_B jittered copies of it."""
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops.pppm import (
        PPPMParams,
        mesh_energy,
        pppm_reciprocal_energy,
    )
    from cavmd_tpu_torch.ops.pppm_kernels import spread_grid_plain

    dev = torch.device("cuda")
    snap = reference_scene(pt, 250, 46.0, dtype, dev)
    params, order = PPPMParams.create(snap.box_L.cpu().numpy(),
                                      mesh=(32, 32, 32), order=6, kappa=0.27,
                                      dtype=dtype, device=dev)
    batch = jitter_rows(torch, snap.position, REPLICA_B, 0.05, 3)
    errs = {}
    for label, pos in (("one", snap.position), (f"b{REPLICA_B}", batch)):
        _cuda.reset_launches()
        e = pppm_reciprocal_energy(pos, snap.charge, snap.box_L, params,
                                   order, (32, 32, 32))
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        check(launches == {"pppm_spread": 1},
              f"phase 16 pppm_reciprocal_energy {label}: launches "
              f"{launches}, not kernel 2 once")
        plain = mesh_energy(spread_grid_plain(pos, snap.charge, snap.box_L,
                                              order, (32, 32, 32)), params)
        err, scale = max_err(e, plain)
        tol = TOL[str(dtype).split(".")[-1]]
        check(err <= tol * scale,
              f"phase 16 pppm_reciprocal_energy {label} {dtype}: "
              f"|dE| {err:.3e} > {tol} x {scale:.3e}")
        errs[label] = err / scale
    return errs


def examples_phase(torch):
    """Phase 16: examples 01-08 through their ``main`` on the card at
    EXAMPLE_DEPTHS, launches counted (03 and 06 also from complete
    traces of their EXAMPLE_TRACED runs, 04 from a complete trace of its
    run on each rank), figures printed and held:
    every figure finite; K4/K5 never in the float64 examples (01, 02,
    07, 08) and no pair kernel in 07; K1-K5 once a step for 03's batch
    and 06; the slab kernel, K2 and K3 once a step on each of 04's two
    ranks (2 replicas x 1 slab sharing the card); 06's drift and mean T
    and 07's peaks against the JAX readings."""
    import numpy as np

    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel.launch import run_ranks

    fig = {}

    def run(stem, **kwargs):
        ex = load_example(stem)
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out = ex.main(**kwargs)
        torch.cuda.synchronize()
        out["seconds"] = time.perf_counter() - t0
        out["launches"] = dict(_cuda.launches)
        return out

    def figures(name, out):
        shown = {k: v for k, v in out.items() if k not in (
            "energy", "qx", "qx_g0", "workdir")}
        print(f"phase 16 example {name}: {shown}", flush=True)
        fig[name] = shown

    def launched(out, kernel):
        return out["launches"].get(kernel, 0)

    def once_a_step(name, launches, steps, setup, kernels):
        for k in kernels:
            n = launches.get(k, 0)
            want = steps + (0 if k.startswith("fused") else setup)
            check(n == want, f"phase 16 example {name}: {k} launched {n} "
                  f"times, not {want} ({steps} steps + {setup} set-up "
                  f"force calls)")

    unfused = ("fused_pre_force", "fused_post_force")
    # 04's two ranks and 07's one (16,000 launch-bound steps of three
    # particles) start first and run while this process runs 01, 02, 03,
    # 05 and 08 (their spawn and imports are most of 04's time); 06, whose
    # steps/s is reported, runs after them, alone
    pool = concurrent.futures.ThreadPoolExecutor(2)
    ranks04 = pool.submit(run_ranks, [(example_rank_job, (
        "04_slab_replicas_torch", EXAMPLE_DEPTHS["04"]))], 2, timeout=600)
    rank07 = pool.submit(run_ranks, [(example_job, (
        "07_polariton_rabi_splitting_torch", EXAMPLE_DEPTHS["07"]))], 1,
        timeout=600)
    t04 = time.perf_counter()
    pool.shutdown(wait=False)

    # 01 and 02: float64, dense, the unfused tail
    for name, stem in (("01", "01_basic_nve_torch"),
                       ("02", "02_two_bath_universe_energy_torch")):
        out = run(stem, **EXAMPLE_DEPTHS[name])
        check(all(launched(out, k) == 0 for k in unfused)
              and launched(out, "dense_pair") > EXAMPLE_DEPTHS[
                  name]["n_steps"],
              f"phase 16 example {name}: launches {out['launches']}")
        check(np.isfinite(out["drift_ha"]),
              f"phase 16 example {name}: drift {out['drift_ha']}")
        figures(name, out)

    # 03: the replica batch, K1-K5 once a step for all replicas
    ex03 = load_example("03_replicas_torch")
    kw = EXAMPLE_TRACED["03"]
    _, traced = traced_launches(torch, lambda: ex03.main(**kw))
    n_rep = 8
    once_a_step("03 (traced)", traced, kw["n_steps"],
                kw["fire_steps"] + n_rep, BATCHED_KERNELS)
    kw = EXAMPLE_DEPTHS["03"]
    out = run("03_replicas_torch", **kw)
    once_a_step("03", out["launches"], kw["n_steps"],
                kw["fire_steps"] + n_rep, BATCHED_KERNELS)
    check(all(np.isfinite(out["drift_ha"] + out["mean_T_K"])),
          f"phase 16 example 03: {out}")
    figures("03", out)

    # 05: the driver
    work = tempfile.mkdtemp(prefix="cavmd_ex05_")
    cwd = os.getcwd()
    try:
        os.chdir(work)
        out = run("05_advanced_run_torch", argv=EXAMPLE_05_ARGS)
        check(out["rc"] == 0 and os.path.isfile(os.path.join(
            work, "cavity_coupling_1eneg03", "prod-1_energy_tracker.txt")),
              f"phase 16 example 05: {out}")
        check(all(launched(out, k) > 0 for k in BATCHED_KERNELS),
              f"phase 16 example 05: launches {out['launches']}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    figures("05", out)

    # 08: the IR spectrum, float64, files in a temporary directory
    work = tempfile.mkdtemp(prefix="cavmd_ex08_")
    try:
        out = run("08_ir_spectrum_torch", workdir=work,
                  **EXAMPLE_DEPTHS["08"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    check(all(launched(out, k) == 0 for k in unfused)
          and launched(out, "dense_pair") > 0
          and out["n_segments"] >= 2,
          f"phase 16 example 08: {out}")
    figures("08", out)
    # 07: the polariton spectrum, float64 NVE, no pair kernel, in its own
    # process (its seconds include the spawn)
    (out,), = rank07.result()
    check(not any(out["launches"].get(k, 0) for k in BATCHED_KERNELS),
          f"phase 16 example 07: launches {out['launches']}")
    for key, want in EX07_JAX_PEAKS_CM1.items():
        got = out[key]
        check(len(got) == len(want) and all(
            abs(g - w) <= out["bin_cm1"] for g, w in zip(got, want)),
              f"phase 16 example 07: {key} {got} against JAX's {want} "
              f"(bin {out['bin_cm1']:.2f})")
    figures("07", out)
    print(f"phase 16 example 07: splitting {out['splitting_cm1']:.2f} "
          f"cm^-1 (analytic g q_c / (sqrt(mu) omega) "
          f"{out['analytic_cm1']:.1f})", flush=True)

    # 04: 2 replicas x 1 slab on two gloo ranks sharing the card, each
    # rank's run traced whole: the slab kernel, K2 and K3 once a step
    ((a, la, _, sa), (b, lb, _, sb)), = ranks04.result()
    steps = EXAMPLE_DEPTHS["04"]["n_steps"]
    check(a == b and (a["replicas"], a["slabs"]) == (2, 1),
          f"phase 16 example 04: ranks differ or grid {a}")
    for k, lk in enumerate((la, lb)):
        check(lk.get("cell_pair_slab", 0) == steps,
              f"phase 16 example 04: rank {k} cell_pair_slab "
              f"{lk.get('cell_pair_slab', 0)} in {steps} steps")
        once_a_step(f"04 rank {k}", lk, steps, 2,
                    ("pppm_spread", "pppm_interpolate"))
    out = dict(a, seconds=time.perf_counter() - t04, rank_seconds=[sa, sb],
               launches=la)
    check(all(np.isfinite(out["drift_ha"] + out["mean_T_K"])),
          f"phase 16 example 04: {out}")
    figures("04", out)

    # 06: the reference anchor, cut; K1-K5 once a step
    ex06 = load_example("06_reference_anchor_validation_torch")
    kw = EXAMPLE_TRACED["06"]
    traced_out, traced = traced_launches(torch, lambda: ex06.main(**kw))
    once_a_step("06 (traced)", traced, traced_out["steps"],
                kw["fire_steps"] + 1, BATCHED_KERNELS)
    kw = EXAMPLE_DEPTHS["06"]
    out = run("06_reference_anchor_validation_torch", **kw)
    once_a_step("06", out["launches"], out["steps"], kw["fire_steps"] + 1,
                BATCHED_KERNELS)
    check(out["drift_ha"] < EX06_DRIFT_BOUND_HA,
          f"phase 16 example 06: drift {out['drift_ha']} >= "
          f"{EX06_DRIFT_BOUND_HA} Ha")
    check(abs(out["mean_T_K"] - 100.0) <= EX06_T_BOUND_K,
          f"phase 16 example 06: mean T {out['mean_T_K']} K")
    figures("06", out)

    return fig


def trap_force(torch, l_typeid):
    """Phase 17's custom force: (position, image, box_L, charge, typeid)
    -> (forces, energy), a harmonic trap of stiffness TRAP_K on the
    unwrapped positions of every particle but the photon (type
    ``l_typeid``)."""

    def trap(position, image, box_L, charge, typeid):
        w = torch.where(typeid != l_typeid, TRAP_K, 0.0).to(
            position.dtype)[:, None]
        r = position + image * box_L
        return -w * r, 0.5 * torch.sum(w * r * r)

    return trap


def custom_force_path(torch, pt, fused_step):
    """Phase 17a: phase 3's scene (f32, dense, the fused tail) with the
    trap through ``Simulation.run`` on SHORT_RUN: ``custom_0`` among the
    observables, K1-K3 once a step and for the initial forces, K4/K5 once
    a step, finite observables, the universe drift (the trap's energy
    included) held to CUSTOM_DRIFT_BOUND_HA, steps/s; then
    REPLICA_PROFILED_STEPS profiled steps through ``traces`` (each of
    K1-K5 once a step in the trace): device operations and us a step
    beside phase 11's profile of the same step without the trap
    (``fused_step``)."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda

    warm, chunks, chunk = SHORT_RUN
    snap = reference_scene(pt, 250, 46.0, torch.float32,
                           torch.device("cuda"))
    l_typeid = snap.type_index("L")
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              custom_forces=(trap_force(torch, l_typeid),))
    kT = PC.kT_from_kelvin(100.0)
    label = f"phase 17 (custom force, N={snap.N})"
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, main_methods(pt, kT),
                        dt=PC.fs_to_atomic_units(0.25), seed=7,
                        chunk_size=chunk)
    sim.run(n_steps=warm)
    outs, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(n_steps=chunk)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outs.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = warm + chunks * chunk
    keys = OBS_KEYS + ("custom_0",)
    check(all("custom_0" in o for o in outs),
          f"{label}: no custom_0 observable")
    obs = {k: np.concatenate([o[k] for o in outs]) for k in keys}
    for k in keys:
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    check(bool(np.all(obs["custom_0"] > 0)), f"{label}: custom_0 <= 0")
    check(int(obs["timestep"][-1]) == total,
          f"{label}: timestep {obs['timestep'][-1]}")
    for kname, want in (("dense_pair", total + 1), ("pppm_spread", total + 1),
                        ("pppm_interpolate", total + 1),
                        ("fused_pre_force", total),
                        ("fused_post_force", total)):
        check(launches.get(kname, 0) == want,
              f"{label}: {kname} launched {launches.get(kname, 0)} times "
              f"(want {want})")
    U = universe_energy(obs)
    drift = float(np.abs(U - U[0]).max())
    check(drift < CUSTOM_DRIFT_BOUND_HA,
          f"{label}: universe drift {drift} >= {CUSTOM_DRIFT_BOUND_HA} Ha")
    rate = statistics.median(chunk / s for s in chunk_s)
    prof = profiled_steps(torch, lambda n: sim.run(n_steps=n),
                          REPLICA_PROFILED_STEPS)
    res = dict(n=snap.N, steps=chunks * chunk, steps_per_s=rate,
               chunk_steps_per_s=[chunk / s for s in chunk_s],
               universe_drift_ha=drift, drift_bound_ha=CUSTOM_DRIFT_BOUND_HA,
               custom_0_first_ha=float(obs["custom_0"][0]),
               custom_0_range_ha=float(np.ptp(obs["custom_0"])),
               device_ops_per_step=prof["ops"],
               device_us_per_step=prof["us"],
               busy_share=prof["us"] / (1e6 / rate),
               profile_records_dropped=prof["dropped"],
               top_device_us_per_step=prof["top_us"],
               no_trap_device_ops_per_step=fused_step["device_ops_per_step"],
               no_trap_device_us_per_step=fused_step["device_us_per_step"],
               launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def custom_batch_trajectory(torch, pt):
    """Phase 17b: REPLICA_F64_B thermalized float64 replicas of the
    N = 501 scene with the trap, REPLICA_F64_STEPS Bussi + Langevin steps
    on the card in one batch (the trap called once a step through
    ``torch.func.vmap``), against one-replica card runs with the same
    draws: positions within TRAJ_TOL_BOHR, images and each replica's
    ``custom_0`` equal to 1e-12 relative, K1-K3 once a step."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import make_step_fn, run_steps
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        run_replica_steps,
    )
    from cavmd_tpu_torch.parallel.replicas import PER_REPLICA

    B, steps = REPLICA_F64_B, REPLICA_F64_STEPS
    snap = reference_scene(pt, 250, 46.0, torch.float64,
                           torch.device("cuda"))
    ff = pt.ForceField.create(
        snap, coupling=1e-3, freq_cm1=2000.0,
        custom_forces=(trap_force(torch, snap.type_index("L")),))
    kT = PC.kT_from_kelvin(100.0)
    methods = pt.resolve_methods(snap, main_methods(pt, kT), ff.l_typeid)
    batch = init_replica_states(snap, ff, n_replicas=B,
                                dt=PC.fs_to_atomic_units(0.25), seed=7,
                                kT=kT)
    draws = CardDraws(torch, B, torch.float64)
    _cuda.reset_launches()
    final, obs = run_replica_steps(make_step_fn(ff, methods, noise=draws),
                                   batch, steps)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    err, img_ok, e_rel = 0.0, True, 0.0
    for r in range(B):
        one = batch.replace(**{k: getattr(batch, k)[r] for k in PER_REPLICA})
        fr, obs_r = run_steps(make_step_fn(ff, methods,
                                           noise=draws.replica(r)),
                              one, steps)
        err = max(err, float((final.position[r] - fr.position).abs().max()))
        img_ok &= bool(torch.equal(final.image[r], fr.image))
        e_rel = max(e_rel, float(np.abs(obs["custom_0"][:, r]
                                        - obs_r["custom_0"]).max()
                                 / np.abs(obs_r["custom_0"]).max()))
    print(f"phase 17: f64 Bussi + Langevin with the trap, {steps} steps of "
          f"{B} replicas at N={snap.N} in one batch vs one-replica runs, "
          f"same draws, on the card: max|dx| = {err!r} bohr (bound "
          f"{TRAJ_TOL_BOHR}), custom_0 max relative {e_rel!r}, images "
          f"equal: {img_ok}, batch launches {launches}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok and e_rel <= 1e-12,
          f"phase 17 f64 batch: max|dx| {err} bohr > {TRAJ_TOL_BOHR}, "
          f"custom_0 relative {e_rel} > 1e-12 or images differ")
    for kname in BATCHED_KERNELS[:3]:
        check(launches.get(kname, 0) == steps,
              f"phase 17 f64 batch: {kname} launched "
              f"{launches.get(kname, 0)} times in {steps} steps")
    return err


def custom_large_path(torch, pt):
    """Phase 17c: ``build_large_n(HELD_N_MOL)``'s scene (N = 20,001, cell
    mode, f32, the fused tail) with the trap, one chunk of LARGE_CHUNK
    steps through ``Simulation.run``: no overflow, the cell kernel once a
    step and for the initial forces, K4/K5 once a step, finite
    energies."""
    import numpy as np

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda
    from cavmd_tpu_torch.ops.cell_kernels import kernel_name

    base, snap, _ = build_large_n(HELD_N_MOL, dt_fs=LARGE_DT_FS)
    ff = pt.ForceField.create(
        snap, coupling=1e-3, freq_cm1=2000.0, dtype=torch.float32,
        pair_mode="cell",
        custom_forces=(trap_force(torch, snap.type_index("L")),))
    cap = ff.cell_cfg.cap
    label = f"phase 17 (custom force, N={snap.N} cell mode)"
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, base.methods,
                        dt=PC.fs_to_atomic_units(LARGE_DT_FS), seed=7)
    t0 = time.perf_counter()
    sim.run(n_steps=LARGE_CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    obs = sim.last_obs
    check(not obs["cell_overflow"].any() and sim.ff.cell_cfg.cap == cap,
          f"{label}: the cell list overflowed")
    for k in OBS_KEYS + ("custom_0",):
        check(bool(np.all(np.isfinite(obs[k]))), f"{label}: non-finite {k}")
    kname = kernel_name(ff.cell_cfg)
    for name, want in ((kname, LARGE_CHUNK + 1),
                       ("fused_pre_force", LARGE_CHUNK),
                       ("fused_post_force", LARGE_CHUNK)):
        check(launches.get(name, 0) == want,
              f"{label}: {name} launched {launches.get(name, 0)} times "
              f"(want {want})")
    res = dict(n=snap.N, ncells=ff.cell_cfg.ncells, cap=cap,
               steps=LARGE_CHUNK, ms_per_step=seconds / LARGE_CHUNK * 1e3,
               custom_0_first_ha=float(obs["custom_0"][0]),
               custom_0_last_ha=float(obs["custom_0"][-1]),
               launches=launches)
    print(f"{label}: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def profile_dir_path(torch, pt):
    """Phase 17d: ``Simulation.run(profile_dir=)`` on phase 3's scene for
    PROFILE_DIR_STEPS steps writes one ``torch.profiler`` trace file into
    the directory, and the trace names K1 (``dense_pair_kernel``); the
    profiler on the card's machine may drop device records, so up to
    PROFILE_TRIES runs."""
    from cavmd_tpu_torch.core import PhysicalConstants as PC

    snap = reference_scene(pt, 250, 46.0, torch.float32,
                           torch.device("cuda"))
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    kT = PC.kT_from_kelvin(100.0)
    seen = []
    for _ in range(PROFILE_TRIES):
        with tempfile.TemporaryDirectory() as tmp:
            sim = pt.Simulation(snap, ff, main_methods(pt, kT),
                                dt=PC.fs_to_atomic_units(0.25), seed=7)
            t0 = time.perf_counter()
            sim.run(n_steps=PROFILE_DIR_STEPS, profile_dir=tmp)
            seconds = time.perf_counter() - t0
            files = list(Path(tmp).glob("*.pt.trace.json"))
            check(len(files) == 1, f"phase 17 profile_dir: trace files "
                  f"{[f.name for f in files]}")
            text = files[0].read_text()
            k1 = text.count("dense_pair_kernel")
            seen.append(k1)
            if k1:
                res = dict(steps=PROFILE_DIR_STEPS, seconds=seconds,
                           trace_bytes=len(text), dense_pair_mentions=k1,
                           tries=len(seen))
                print("phase 17 (profile_dir): " + ", ".join(
                    f"{k}={v!r}" for k, v in res.items()), flush=True)
                return res
    fail(f"phase 17 profile_dir: no trace named dense_pair_kernel in "
         f"{PROFILE_TRIES} runs (mentions {seen})")


# phase 18: atom sharding by rows (parallel/shard.py). The kernels' row
# ranges cut the rows into ROWS_S blocks; 18c runs ROWS_S ranks sharing the
# card over gloo (host-staged collectives): ROWS_F64_STEPS float64 steps
# held to TRAJ_TOL_BOHR against the one-rank run, SHORT_RUN in float32 held
# to phase 3's DRIFT_BOUND_HA; 18d ROWS_CELL_STEPS steps in cell mode; 18e
# ROWS_CELL_STEPS float32 steps in zcol mode and ROWS_ZCOL_F64_STEPS
# float64 steps held to TRAJ_TOL_BOHR against the one-rank zcol run
ROWS_S = 2
ROWS_F64_STEPS = 100
ROWS_CELL_STEPS = 20
ROWS_ZCOL_F64_STEPS = 20  # 18e: the float64 zcol run on the row path
# the kernels line's row-range rows -> the kernel each one is a range of
ROWS_KERNELS = {"dense_pair_rows": "dense_pair",
                "cell_pair_rows": "cell_pair",
                "zcol_pair_rows": "zcol_pair"}


def row_ranges(n, S):
    """The S contiguous row blocks of n rows, [s n / S, (s + 1) n / S), as
    (row0, n_rows)."""
    return [(s * n // S, (s + 1) * n // S - s * n // S) for s in range(S)]


def dense_rows_work(torch, snap, ff, rows, blocks):
    """(bytes, operations) of one K1 launch over the i rows ``rows`` =
    (row0, n_rows) against all N j rows, counted as ``work_counts`` counts
    the full launch: the positions, box, types, charges and tables in, the
    range's two mask rows (n_rows x N bytes each) in; the range's forces
    and ``blocks`` energy partials out; the operations of the range's
    masked pairs and of those inside a cutoff."""
    from cavmd_tpu_torch.core.box import minimum_image

    row0, n_rows = rows
    own = slice(row0, row0 + n_rows)
    n, e = snap.N, snap.position.element_size()
    T = ff.lj_eps.shape[0]
    pos = snap.position.double()
    dr = minimum_image(pos[own, None, :] - pos[None, :, :],
                       snap.box_L.double())
    r2 = (dr * dr).sum(-1)
    lj, cw = ff.lj_active[own].bool(), ff.coulomb_active[own].bool()
    tid = snap.typeid.long()
    rc2 = ff.lj_rcut2.double()[tid[own, None], tid[None, :]]
    in_lj = lj & (r2 < rc2)
    in_cw = cw & (r2 < ff.coulomb_rcut ** 2)
    n_masked = int((lj | cw).sum())
    n_in = int((in_lj | in_cw).sum())
    return (e * (3 * n + 3 + 4 * T * T + n) + 4 * n + 2 * n_rows * n
            + e * (3 * n_rows + 2 * blocks),
            18 * n_masked + 6 * n_in + 15 * int(in_lj.sum())
            + 18 * int(in_cw.sum()))


def rows_kernel_phase(torch, pt, dtype, timed):
    """Phase 18a and 18b: the kernels with a row range, on ROWS_S row
    blocks, against their plain twins (the same rows) and against the full
    launch. (a) K1 on the N = 501 scene and on REPLICA_B replicas of it
    (phase 11's jitter) in one launch: each block's forces within TOL of
    the twin's and of the full launch's rows (and whether they are its
    bits), its energy shares within TOL of the twin's, the shares summed
    within TOL of the full launch's energies. (b) the cell kernel at
    N = 2 HELD_N_MOL + 1 (10^3 cells) and on the N = 501 scene in cell
    mode (the small grid, 2^3 cells): each block against its twin, and the
    blocks' forces summed equal to the full launch's bit for bit (a row is
    computed once, by the same warp, in the same order), their energy
    shares summed within TOL. In float32 the first block's launch is
    timed (``ms``), with its twin (``plain_ms``) and its bound from its
    own rows' work."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import pair_kernels as pk

    dev = torch.device("cuda")
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    out = {}

    def close(label, a, b, scale=None):
        err, ref = max_err(a, b)
        ref = ref if scale is None else scale
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite")
        check(err <= tol * max(ref, 1e-300),
              f"{label}: max|diff| {err} > {tol}*{ref}")
        return err

    # 18a: K1
    snap = reference_scene(pt, 250, 46.0, dtype, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    args = (snap.position, snap.box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
            ff.lj_rcut2, ff.lj_vshift, snap.charge, ff.lj_active,
            ff.coulomb_active, ff.kappa_value, ff.coulomb_rcut ** 2)
    bargs = (jitter_rows(torch, snap.position, REPLICA_B, 0.3, 1),) + args[1:]
    k1 = {}
    for label, a in (("one replica", args), (f"B={REPLICA_B}", bargs)):
        full = pk.dense_pair_force(*a)
        shares = [0.0, 0.0]
        errs, same_bits = [], True
        for r0, m in row_ranges(snap.N, ROWS_S):
            tag = f"phase 18a dense_pair rows [{r0}, {r0 + m}) {label} {name}"
            k = pk.dense_pair_force(*a, rows=(r0, m))
            p = pk.dense_pair_force_plain(*a, rows=(r0, m))
            torch.cuda.synchronize()
            check(tuple(k[0].shape) == tuple(p[0].shape)
                  and k[0].shape[-2] == m, f"{tag}: forces {k[0].shape}")
            errs.append(max(close(f"{tag} vs twin F", k[0], p[0]),
                            close(f"{tag} vs twin E_lj", k[1], p[1]),
                            close(f"{tag} vs twin E_ew", k[2], p[2])))
            rows_full = full[0][..., r0:r0 + m, :]
            close(f"{tag} vs the full launch's rows", k[0], rows_full,
                  scale=float(full[0].double().abs().max()))
            same_bits &= torch.equal(k[0], rows_full)
            shares = [shares[0] + k[1], shares[1] + k[2]]
        for i, what in ((0, "E_lj"), (1, "E_ew")):
            close(f"phase 18a dense_pair {label} {name}: the row blocks' "
                  f"{what} summed vs the full launch", shares[i],
                  full[i + 1], scale=float(full[i + 1].double().abs().max()))
        k1[label] = dict(max_abs_err=max(errs), rows_bit_equal=same_bits)
    out["dense_pair_rows"] = dict(max_abs_err=k1["one replica"][
        "max_abs_err"], batched=k1[f"B={REPLICA_B}"], n=snap.N,
        rows=row_ranges(snap.N, ROWS_S),
        rows_bit_equal=k1["one replica"]["rows_bit_equal"])
    first = row_ranges(snap.N, ROWS_S)[0]
    calls = {"dense_pair_rows": (
        lambda: pk.dense_pair_force(*args, rows=first),
        lambda: pk.dense_pair_force_plain(*args, rows=first))}
    counts = {"dense_pair_rows": dense_rows_work(
        torch, snap, ff, first, pk.launch_blocks(first[1]))}

    # 18b: the cell kernel (K6's counterpart) and the small grid (K8's)
    for key, n_mol, box in (
            ("cell_pair_rows", HELD_N_MOL, reference_box_for(HELD_N_MOL)),
            ("cell_pair_small_grid_rows", 250, 46.0)):
        csnap = reference_scene(pt, n_mol, box, dtype, dev)
        cff = pt.ForceField.create(csnap, coupling=1e-3, freq_cm1=2000.0,
                                   pair_mode="cell")
        clist = cff.build_cells(csnap.position, csnap.box_L)
        check(not bool(clist.overflow), f"phase 18b {key}: overflow")
        cargs = (csnap.position, csnap.box_L, clist, cff.cell_cfg,
                 csnap.typeid, csnap.charge, cff.lj_eps, cff.lj_sig2,
                 cff.lj_rcut2, cff.lj_vshift, cff.cell_exclusions,
                 cff.kappa_value)
        check(f"{ck.kernel_name(cff.cell_cfg)}_rows" == key,
              f"phase 18b {key}: grid {cff.cell_cfg.ncells}")
        full = ck.cell_pair_force_fused(*cargs)
        summed, shares, errs = torch.zeros_like(full[0]), [0.0, 0.0], []
        for r0, m in row_ranges(csnap.N, ROWS_S):
            tag = f"phase 18b {key} rows [{r0}, {r0 + m}) {name}"
            k = ck.cell_pair_force_fused(*cargs, rows=(r0, m))
            p = ck.cell_pair_force_fused_plain(*cargs, row_range=(r0, m))
            torch.cuda.synchronize()
            errs.append(max(close(f"{tag} vs twin F", k[0], p[0]),
                            close(f"{tag} vs twin E_lj", k[1], p[1]),
                            close(f"{tag} vs twin E_ew", k[2], p[2])))
            outside = torch.ones(csnap.N, dtype=torch.bool, device=dev)
            outside[r0:r0 + m] = False
            check(bool((k[0][outside] == 0).all()),
                  f"{tag}: forces outside the range")
            summed = summed + k[0]
            shares = [shares[0] + k[1], shares[1] + k[2]]
            del p
        check(torch.equal(summed, full[0]),
              f"phase 18b {key} {name}: the row blocks' forces summed "
              "differ from the full launch's")
        for i, what in ((0, "E_lj"), (1, "E_ew")):
            close(f"phase 18b {key} {name}: the row blocks' {what} summed "
                  "vs the full launch", shares[i], full[i + 1],
                  scale=float(full[i + 1].double().abs().max()))
        out[key] = dict(max_abs_err=max(errs), n=csnap.N,
                        ncells=cff.cell_cfg.ncells, blocks_sum_bit_equal=True,
                        rows=row_ranges(csnap.N, ROWS_S))
        cfirst = row_ranges(csnap.N, ROWS_S)[0]
        calls[key] = (
            lambda a=cargs, r=cfirst: ck.cell_pair_force_fused(*a, rows=r),
            lambda a=cargs, r=cfirst: ck.cell_pair_force_fused_plain(
                *a, row_range=r))
        if timed:
            counts[key] = cell_work_counts(
                torch, *cargs[:4], csnap.typeid, csnap.charge, cff,
                cff.cell_exclusions, ck.launch_blocks(
                    cff.cell_cfg.total_cells, cff.cell_cfg.cap, dev),
                rows=cfirst)
        torch.cuda.empty_cache()
    if timed:
        for key, (kern, plain) in calls.items():
            out[key]["ms"] = device_ms(torch, kern)
            out[key]["plain_ms"] = profiled_device_ms(torch, plain)
            n_bytes, n_ops, *extra = counts[key]
            out[key]["bound_ms"], out[key]["bound_by"] = bound_ms(n_bytes,
                                                                  n_ops)
            out[key]["bytes"], out[key]["ops"] = n_bytes, n_ops
            if extra:
                out[key]["pairs"] = extra[0]
    for key, r in out.items():
        print(f"phase 18: {key} {name}: " + ", ".join(
            f"{k}={v!r}" for k, v in r.items()), flush=True)
    return out


def zcol_rows_kernel_phase(torch, pt, dtype, timed):
    """Phase 18e (a), (b): K9 with a row range (``zcol_pair_rows``) on
    ROWS_S row blocks, at N = 2 LARGE_N_MOL + 1 in zcol mode (17 x 17
    columns, W = 8, phase 10's scene) and on REPLICA_B replicas of
    N = 2 HELD_N_MOL + 1 in one launch (phase 12a's batch): each block's
    forces and energy shares within TOL of its twin with the same range,
    zero outside its rows, the window flag the full launch's; the blocks'
    forces summed equal the full launch's bit for bit (an owned row is
    summed as in the full launch), their energy shares summed within TOL
    of its energies. In float32 the wrapper with the first block's range
    is timed beside the full wrapper (``ms``, ``full_ms``), each pair
    kernel's own time in its trace beside them, with the range's twin
    (``plain_ms``) and the bound from the range's own work."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    dev = torch.device("cuda")
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    snap = reference_scene(pt, LARGE_N_MOL, reference_box_for(LARGE_N_MOL),
                           dtype, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                              pair_mode="zcol")
    clist = ff.build_cells(snap.position, snap.box_L)
    check(not bool(clist.overflow), f"phase 18e: zcol list N={snap.N} "
          "overflowed")
    args = (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
            snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
            ff.cell_exclusions, ff.kappa_value, ff.zcol_W)
    _, bff, bargs = cell_replica_inputs(torch, pt, "zcol_pair", REPLICA_B,
                                        dtype)
    out = {}
    for label, a in ((f"N={snap.N}", args),
                     (f"B={REPLICA_B} x N={bargs[0].shape[-2]}", bargs)):
        n = a[0].shape[-2]
        full = zk.zcol_pair_force(*a)
        summed, shares, errs = torch.zeros_like(full[0]), [0.0, 0.0], []
        for r0, m in row_ranges(n, ROWS_S):
            tag = f"phase 18e zcol_pair_rows {label} [{r0}, {r0 + m}) {name}"
            k = zk.zcol_pair_force(*a, rows=(r0, m))
            p = zk.zcol_pair_force_plain(*a, rows=(r0, m))
            torch.cuda.synchronize()
            for what, x, y in zip(("F", "E_lj", "E_ew"), k[:3], p[:3]):
                err, ref = max_err(x, y)
                check(bool(torch.isfinite(x).all()), f"{tag}: non-finite")
                check(err <= tol * max(ref, 1e-300),
                      f"{tag} vs twin {what}: max|diff| {err} > {tol}*{ref}")
                errs.append(err)
            check(bool(torch.equal(k[3], full[3])),
                  f"{tag}: window flag {k[3]} against the full launch's "
                  f"{full[3]}")
            outside = torch.ones(n, dtype=torch.bool, device=dev)
            outside[r0:r0 + m] = False
            check(bool((k[0][..., outside, :] == 0).all()),
                  f"{tag}: forces outside the range")
            summed = summed + k[0]
            shares = [shares[0] + k[1], shares[1] + k[2]]
            del p
        check(bool(torch.equal(summed, full[0])),
              f"phase 18e zcol_pair_rows {label} {name}: the row blocks' "
              "forces summed differ from the full launch's")
        for i, what in ((0, "E_lj"), (1, "E_ew")):
            err, ref = max_err(shares[i], full[i + 1])
            check(err <= tol * max(ref, 1e-300),
                  f"phase 18e zcol_pair_rows {label} {name}: the row "
                  f"blocks' {what} summed vs the full launch: {err} > "
                  f"{tol}*{ref}")
        out[label] = dict(max_abs_err=max(errs), blocks_sum_bit_equal=True,
                          rows=row_ranges(n, ROWS_S))
        torch.cuda.empty_cache()
    res = dict(out[f"N={snap.N}"], n=snap.N, batched=out[
        f"B={REPLICA_B} x N={bargs[0].shape[-2]}"], W=ff.zcol_W,
        columns=ff.cell_cfg.ncells[:2])
    if timed:
        first = row_ranges(snap.N, ROWS_S)[0]
        res["ms"] = device_ms(torch, lambda: zk.zcol_pair_force(
            *args, rows=first))
        res["full_ms"] = device_ms(torch, lambda: zk.zcol_pair_force(*args))
        res["kernel_only_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force(*args, rows=first),
            match="zcol_pair_kernel")
        res["full_kernel_only_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force(*args),
            match="zcol_pair_kernel")
        res["plain_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force_plain(*args, rows=first))
        pos_loc = zk.zcol_local_positions(snap.position, snap.box_L, clist)
        hull, _, W = zk.zcol_hull(pos_loc, snap.box_L, clist, ff.cell_cfg,
                                  ff.zcol_W)
        n_bytes, n_ops, pairs = zcol_work_counts(
            torch, pos_loc, snap.box_L, clist, ff.cell_cfg, hull, W,
            snap.typeid, snap.charge, ff, rows=first)
        res["bound_ms"], res["bound_by"] = bound_ms(n_bytes, n_ops)
        res.update(bytes=n_bytes, ops=n_ops, pairs=pairs)
    print(f"phase 18: zcol_pair_rows {name}: " + ", ".join(
        f"{k}={v!r}" for k, v in res.items()), flush=True)
    return res


def rows_scene(torch, pt, dtype, mode):
    """18c's scene (the reference scene, dense) or 18d's (2 HELD_N_MOL + 1
    particles, in cell mode, or in zcol mode for 18e), on the card,
    ghost-padded to a multiple of ROWS_S: (snapshot, force field)."""
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.parallel import pad_snapshot_to

    dev = torch.device("cuda")
    if mode == "dense":
        snap = reference_scene(pt, 250, 46.0, dtype, dev)
    else:
        snap = reference_scene(pt, HELD_N_MOL, reference_box_for(HELD_N_MOL),
                               dtype, dev)
    snap, _ = pad_snapshot_to(snap, ROWS_S)
    return snap, pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                      pair_mode=mode)


def rows_run_job(dtype_name, mode, warm, chunks, chunk):
    """A ``run_ranks`` job (18c, 18d), or without a process group its
    one-rank reference: ``rows_scene(mode)`` through
    ``Simulation(shard_atoms=S)``, S the world size (0 without a group),
    Bussi + Langevin at dt 0.25 fs, seed 7, thermalized, ``warm`` steps
    then ``chunks`` chunks of ``chunk``. In cell mode ``extra_obs`` is an
    opaque callable, which the slab path refuses, so the run takes the row
    path. Returns NumPy: the final positions, every observable of the
    chunks, this rank's launches, the chunks' seconds, the route."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.ops import _cuda

    S = dist.get_world_size() if dist.is_initialized() else 0
    dtype = getattr(torch, dtype_name)
    snap, ff = rows_scene(torch, pt, dtype, mode)
    kT = PC.kT_from_kelvin(100.0)
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, main_methods(pt, kT),
                        dt=PC.fs_to_atomic_units(LARGE_DT_FS), seed=7,
                        chunk_size=chunk, shard_atoms=S,
                        extra_obs=(lambda state: {}) if mode == "cell"
                        else None)
    sim.thermalize(kT)
    if warm:
        sim.run(n_steps=warm)
    outs, chunk_s = [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        sim.run(n_steps=chunk)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        outs.append(sim.last_obs)
    return dict(position=sim.state.position.cpu().numpy(),
                obs={k: np.concatenate([o[k] for o in outs])
                     for k in outs[0]},
                launches=dict(_cuda.launches), chunk_s=chunk_s, n=snap.N,
                rows=sim.ff.row_comm is not None
                and sim._domain_plan is None,
                on_card=sim.state.position.is_cuda)


def rows_path_phase(torch, pt):
    """Phase 18c, 18d and 18e (c): one ``run_ranks`` spawn of ROWS_S gloo
    ranks sharing the card (host-staged collectives) runs (c) the padded
    reference scene (N = 502, dense) through ``Simulation(shard_atoms=2)``
    in float64 for ROWS_F64_STEPS steps, held to TRAJ_TOL_BOHR against
    the one-rank run in this process, and in float32 on SHORT_RUN, its
    universe drift held to DRIFT_BOUND_HA: on each rank K1 (its row
    range, ``dense_pair_rows``), K2 and K3 once a step and for the
    initial forces, the full K1 never, K4/K5 once a step in float32 and
    never in float64; (d) 2 HELD_N_MOL + 1 particles (padded to 20,002)
    in cell mode with an opaque ``extra_obs``, ROWS_CELL_STEPS float32
    steps: the cell kernel's row range once a step on each rank and no
    overflow; (e) the same scene in zcol mode (the row path: the slab
    plan takes cell mode only), ROWS_CELL_STEPS float32 steps (K9's row
    range ``zcol_pair_rows``, its hull ``zcol_hull``, K2 and K3 once a
    step and for the initial forces on each rank, the full K9 never, no
    overflow and no window flag) and ROWS_ZCOL_F64_STEPS float64 steps
    held to TRAJ_TOL_BOHR against the one-rank zcol run in this process.
    The ranks' states agree bit for bit."""
    import numpy as np

    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.parallel.launch import run_ranks

    warm, chunks, chunk = SHORT_RUN
    t0 = time.perf_counter()
    f64, f32, cell, zcol, zcol_f64 = run_ranks([
        (rows_run_job, ("float64", "dense", 0, 1, ROWS_F64_STEPS)),
        (rows_run_job, ("float32", "dense", warm, chunks, chunk)),
        (rows_run_job, ("float32", "cell", 0, 1, ROWS_CELL_STEPS)),
        (rows_run_job, ("float32", "zcol", 0, 1, ROWS_CELL_STEPS)),
        (rows_run_job, ("float64", "zcol", 0, 1, ROWS_ZCOL_F64_STEPS))],
        ROWS_S, timeout=600)
    spawn_s = time.perf_counter() - t0
    ref = rows_run_job("float64", "dense", 0, 1, ROWS_F64_STEPS)
    zref = rows_run_job("float64", "zcol", 0, 1, ROWS_ZCOL_F64_STEPS)
    res = dict(spawn_s=spawn_s)
    for label, runs, steps, pair, fused in (
            ("18c f64", f64, ROWS_F64_STEPS, "dense_pair", False),
            ("18c f32", f32, warm + chunks * chunk, "dense_pair", True),
            ("18d cell f32", cell, ROWS_CELL_STEPS, "cell_pair", True),
            ("18e zcol f32", zcol, ROWS_CELL_STEPS, "zcol_pair", True),
            ("18e zcol f64", zcol_f64, ROWS_ZCOL_F64_STEPS, "zcol_pair",
             False)):
        for k, r in enumerate(runs):
            tag = f"phase {label} rank {k} N={r['n']}"
            check(r["rows"] and r["on_card"], f"{tag}: not on the row path "
                  "on the card")
            want = {f"{pair}_rows": steps + 1, pair: 0,
                    "pppm_spread": steps + 1, "pppm_interpolate": steps + 1,
                    "fused_pre_force": steps if fused else 0,
                    "fused_post_force": steps if fused else 0}
            if pair == "zcol_pair":
                want["zcol_hull"] = steps + 1
            for kname, n in want.items():
                got = r["launches"].get(kname, 0)
                check(got == n, f"{tag}: {kname} launched {got} times "
                      f"(want {n})")
            for key, v in r["obs"].items():
                check(bool(np.all(np.isfinite(v))), f"{tag}: non-finite "
                      f"{key}")
            check(np.array_equal(r["position"], runs[0]["position"]),
                  f"{tag}: the ranks' states differ")
        res[label] = dict(launches=runs[0]["launches"], n=runs[0]["n"],
                          steps=steps)
    dx = float(np.abs(f64[0]["position"] - ref["position"]).max())
    check(not ref["rows"] and dx <= TRAJ_TOL_BOHR,
          f"phase 18c f64: max|dx| {dx} vs the one-rank run > "
          f"{TRAJ_TOL_BOHR}")
    U = universe_energy(f32[0]["obs"])
    drift = float(np.abs(U - U[0]).max())
    check(drift < DRIFT_BOUND_HA,
          f"phase 18c f32: universe drift {drift} >= {DRIFT_BOUND_HA} Ha")
    check(not cell[0]["obs"]["cell_overflow"].any(), "phase 18d: overflow")
    # the zcol window flag rides cell_overflow
    for r in zcol + zcol_f64:
        check(not r["obs"]["cell_overflow"].any(),
              "phase 18e: overflow or window flag")
    zdx = float(np.abs(zcol_f64[0]["position"] - zref["position"]).max())
    check(not zref["rows"] and zdx <= TRAJ_TOL_BOHR,
          f"phase 18e zcol f64: max|dx| {zdx} vs the one-rank run > "
          f"{TRAJ_TOL_BOHR}")
    res.update(f64_max_dx_bohr=dx, f32_universe_drift_ha=drift,
               f32_steps_per_s=statistics.median(
                   chunk / s for s in f32[0]["chunk_s"]),
               cell_ms_per_step=1e3 * cell[0]["chunk_s"][0]
               / ROWS_CELL_STEPS,
               zcol_ms_per_step=1e3 * zcol[0]["chunk_s"][0]
               / ROWS_CELL_STEPS, zcol_f64_max_dx_bohr=zdx)
    print("phase 18: rows path " + ", ".join(
        f"{k}={v!r}" for k, v in res.items()), flush=True)
    return res


def main() -> None:
    clock = PhaseClock()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    try:
        import cavmd_tpu_torch as pt
        from cavmd_tpu_torch.core.system import reference_box_for
        from cavmd_tpu_torch.ops import _cuda
    except ImportError as e:
        fail(f"cavmd_tpu_torch is not importable (run from the repo root): "
             f"{e}")
    check("jax" not in sys.modules, "the port imported jax")

    # phase 1's builds start here, one nvcc per source, all at once, and
    # run while phase 0 reads the card
    t0 = time.perf_counter()
    build_pool = concurrent.futures.ThreadPoolExecutor(len(SOURCES))
    builds = [build_pool.submit(_cuda.build, src) for src in SOURCES]

    # phase 0: device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: device {kind}; nvidia-smi name, power.limit: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    clock.lap(0)

    # phase 1: the builds' end; meanwhile the profiler's one-time start
    # (~8 s on the card's machine) is paid by an empty trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    for b in builds:
        b.result()
    build_pool.shutdown()
    build_s = time.perf_counter() - t0
    fresh = sorted(_cuda.build_log)
    print(f"phase 1: kernels ready in {build_s:.2f} s (compiled now: "
          f"{fresh or 'none, found built in this checkout'})", flush=True)
    for src, log in sorted(_cuda.build_log.items()):
        entries = ptxas_report(log)
        for label, regs, stack, st, ld in entries:
            print(f"phase 1: ptxas {src}: {label}: {regs} registers, "
                  f"stack frame {stack} B, spill stores {st} B, spill loads "
                  f"{ld} B", flush=True)
        missing = [f"{k}<{t}>" for k in PTXAS_NAMED.get(src, ())
                   for t in ("float", "double")
                   if not any(label.startswith(f"{k}<{t}")
                              for label, *_ in entries)]
        check(not missing, f"phase 1: no ptxas report for {missing}")
        for label, _, stack, st, ld in entries:
            check(label not in PTXAS_NO_STACK or stack + st + ld == 0,
                  f"phase 1: {label} has a {stack}-byte stack frame and "
                  f"{st + ld} bytes of spills")
            check(label not in PTXAS_NO_SPILL or st + ld == 0,
                  f"phase 1: {label} spills {st + ld} bytes")
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(1)

    # phase 2: kernels against plain twins: N = 501 and 4001 (dense, K1-K5),
    # N = 100,001 (cell mode: the cell kernel on 17^3 cells, K2-K5), and the
    # N = 501 scene in cell mode (the cell kernel on 2^3 cells)
    shapes = {}
    for n_mol, box, mode, pair_only in (
            (250, 46.0, None, False),
            (2000, reference_box_for(2000), None, False),
            (LARGE_N_MOL, reference_box_for(LARGE_N_MOL), None, False),
            (250, 46.0, "cell", True)):
        for dtype in (torch.float32, torch.float64):
            r = kernel_phase(torch, pt, n_mol, box, dtype,
                             timed=dtype == torch.float32, pair_mode=mode,
                             pair_only=pair_only)
            if dtype == torch.float32:
                shapes[(n_mol, mode)] = r
        torch.cuda.empty_cache()
    # K1 and K3 on the dense scenes side by side, K3 also at N = 100,001
    for k in ("dense_pair", "pppm_interpolate"):
        rows = [(shapes[(m, None)][k], n) for m, n in
                ((250, 501), (2000, 4001), (LARGE_N_MOL, 2 * LARGE_N_MOL + 1))
                if k in shapes[(m, None)]]
        print(f"phase 2: {k} f32: " + "; ".join(
            f"N={n} ms={r['ms']!r} host_call_ms={r['host_call_ms']!r} "
            f"bound_ms={r['bound_ms']!r} ({r['bound_by']})"
            for r, n in rows), flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(2)

    # phase 3: Simulation.run at N = 501, fused (default) and unfused
    fused = main_path(torch, pt, None)
    unfused = main_path(torch, pt, False, *SHORT_RUN,
                        bound=SHORT_DRIFT_BOUND_HA)
    clock.lap(3)

    # phase 4: a float64 trajectory against the CPU, dense mode
    f64_trajectory(torch, pt, 4, 250, 46.0)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(4)

    # phase 5: the N = 501 CLI
    cli = cli_phase(torch, pt, 5, CLI_ARGS, 501, 1000,
                    ["dense_pair", "pppm_spread", "pppm_interpolate",
                     "fused_pre_force", "fused_post_force"],
                    CLI_DRIFT_BOUND_HA)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(5)

    # phase 6: the large-N main path, held at N = 20,001 and run at
    # N = 100,001, there also at half the time step (the band must shrink
    # as dt^2); then the small-grid cell path at N = 501
    held = large_n_path(torch, pt, HELD_N_MOL, LARGE_BAND_BOUND_HA)
    torch.cuda.empty_cache()
    large = large_n_path(torch, pt, LARGE_N_MOL, None)
    torch.cuda.empty_cache()
    half = large_n_path(torch, pt, LARGE_N_MOL, None, LARGE_DT_FS / 2)
    torch.cuda.empty_cache()
    ratio = large["universe_band_ha"] / half["universe_band_ha"]
    print(f"phase 6: N={large['n']} universe band "
          f"{large['universe_band_ha']!r} Ha at dt {LARGE_DT_FS} fs, "
          f"{half['universe_band_ha']!r} Ha at "
          f"{LARGE_DT_FS / 2} fs: ratio {ratio!r} (bound >= "
          f"{LARGE_DT2_RATIO})", flush=True)
    check(ratio >= LARGE_DT2_RATIO,
          f"large-N N={large['n']}: the universe band shrank {ratio}x at "
          f"half the time step, < {LARGE_DT2_RATIO}x: not dt^2 error")
    small = small_grid_path(torch, pt)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(6)

    # phase 7: a float64 cell-mode trajectory against the CPU (5^3 cells)
    f64_trajectory(torch, pt, 7, 2000, reference_box_for(2000),
                   pair_mode="cell")
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(7)

    # phase 8: the CLI at 10,000 molecules (held) and 50,000 (float32
    # reported, float64 held)
    cell_kernels = ["cell_pair", "pppm_spread", "pppm_interpolate",
                    "fused_pre_force", "fused_post_force"]
    cli_held = cli_phase(torch, pt, 8, large_cli_args(HELD_N_MOL),
                         2 * HELD_N_MOL + 1, LARGE_CLI_ENERGY_PERIOD_STEPS,
                         cell_kernels, LARGE_CLI_DRIFT_BOUND_HA)
    torch.cuda.empty_cache()
    cli_large = cli_phase(torch, pt, 8, large_cli_args(LARGE_N_MOL),
                          2 * LARGE_N_MOL + 1, LARGE_CLI_ENERGY_PERIOD_STEPS,
                          cell_kernels, None)
    torch.cuda.empty_cache()
    # float64 runs the unfused tail: K4/K5 take float32 only
    cli_f64 = cli_phase(torch, pt, 8, large_cli_args(LARGE_N_MOL)
                        + ["--precision", "f64"], 2 * LARGE_N_MOL + 1,
                        LARGE_CLI_ENERGY_PERIOD_STEPS, cell_kernels[:3],
                        LARGE_CLI_DRIFT_BOUND_HA)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(8)

    # phase 9: the slab domain pipeline at one slab
    slab = {}
    for dtype in (torch.float32, torch.float64):
        r = slab_kernel_phase(torch, pt, dtype, timed=dtype == torch.float32)
        if dtype == torch.float32:
            slab = r
        torch.cuda.empty_cache()
    dom_f64 = domain_f64_trajectory(torch, pt)
    torch.cuda.empty_cache()
    dom = domain_large_path(torch, pt, large)
    torch.cuda.empty_cache()
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(9)

    # phase 10: the z-sorted column mode
    zres = {}
    for dtype in (torch.float32, torch.float64):
        r = zcol_kernel_phase(torch, pt, dtype, timed=dtype == torch.float32)
        if dtype == torch.float32:
            zres = r
        torch.cuda.empty_cache()
    zcol = large_n_path(torch, pt, LARGE_N_MOL,
                        DOMAIN_BAND_RATIO * large["universe_band_ha"],
                        pair_mode="zcol", phase=10)
    torch.cuda.empty_cache()
    zcol_f64 = zcol_f64_trajectory(torch, pt)
    torch.cuda.empty_cache()
    cell100k = shapes[(LARGE_N_MOL, None)]["cell_pair"]
    print(f"phase 10: zcol_pair wrapper {zres['ms']:.4f} ms (its pair "
          f"kernel {zres['kernel_only_ms']:.4f}, its hull kernel "
          f"{zres['hull_kernel_ms']:.4f}; the hull launch alone "
          f"{zres['hull_ms']:.4f}) vs cell_pair "
          f"{cell100k['ms']:.4f} ms at N={large['n']}; candidates "
          f"{zres['pairs']['candidates']}, about "
          f"{zres['pairs']['candidates_after_pruning_est']} after the "
          f"z-chunk pruning (the kernel's rule, estimated in PyTorch; cell "
          f"kernel {cell100k['pairs']['candidates']}); "
          f"zcol step {zcol['ms_per_step']:.3f} ms vs cell "
          f"{large['ms_per_step']:.3f} ms", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(10)

    # phase 11: replica batches of the N = 501 scene, K1-K5 once a step for
    # the whole batch
    rk = {}
    for dtype in (torch.float32, torch.float64):
        r = replica_kernel_phase(torch, pt, dtype,
                                 timed=dtype == torch.float32)
        if dtype == torch.float32:
            rk = r
    rep_f64 = replica_f64_trajectory(torch, pt)
    one_step = replica_step_path(torch, pt, None)
    rsteps = {B: replica_step_path(torch, pt, B, *SHORT_RUN,
                                   bound=REPLICA_SHORT_DRIFT_BOUND_HA)
              for B in REPLICA_STEP_BATCHES}
    ops = {B: r["device_ops_per_step"] for B, r in rsteps.items()}
    check(len(set(ops.values())) == 1,
          f"phase 11: device operations a step differ with B: {ops} "
          f"(records a step: "
          f"{ {B: r['device_records_per_step'] for B, r in rsteps.items()} })")
    check(abs(ops[1] - one_step["device_ops_per_step"]) <= REPLICA_OPS_SLACK,
          f"phase 11: the batched step's {ops[1]} device operations vs the "
          f"one-replica step's {one_step['device_ops_per_step']}")
    vcli = vmap_cli_phase(torch, pt, 11, CLI_ARGS, 1000, BATCHED_KERNELS,
                          VMAP_CLI_DRIFT_BOUND_HA)
    print("phase 11: aggregate steps/s " + ", ".join(
        f"B={B} {r['aggregate_steps_per_s']:.1f} "
        f"({r['aggregate_steps_per_s'] / fused['steps_per_s']:.2f}x phase 3's "
        f"fused {fused['steps_per_s']:.1f}), device "
        f"{r['device_us_per_step']:.1f} us/step, busy "
        f"{r['busy_share']:.3f}" for B, r in rsteps.items())
        + f"; device ops/step {ops} vs one replica "
        f"{one_step['device_ops_per_step']}; CLI B={REPLICA_B} "
        f"{vcli['aggregate_steps_per_s']} aggregate steps/s", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(11)

    # phase 12: replica batches in cell and zcol mode, the cell kernel and
    # K9 with its hull once a step for the whole batch
    ck12 = {}
    for dtype in (torch.float32, torch.float64):
        r = cell_replica_kernel_phase(torch, pt, dtype,
                                      timed=dtype == torch.float32)
        if dtype == torch.float32:
            ck12 = r
    traj12 = {mode: cell_replica_f64_trajectory(torch, pt, mode)
              for mode in ("cell", "zcol")}
    torch.cuda.empty_cache()
    big = cell_replica_step_path(torch, pt, large["universe_band_ha"],
                                 large["ms_per_step"])
    torch.cuda.empty_cache()
    small12 = replica_batch_path(torch, pt, "cell_pair_small_grid")
    zcol12 = replica_batch_path(torch, pt, "zcol_pair")
    vcli12 = vmap_cli_phase(
        torch, pt, 12, large_cli_args(HELD_N_MOL, VMAP_LARGE_CLI_RUNTIME_PS),
        LARGE_CLI_ENERGY_PERIOD_STEPS, cell_kernels, LARGE_CLI_DRIFT_BOUND_HA)
    # a _b8 row's launches come from a run at the shape its time was taken
    check(vcli12["n"] == ck12["cell_pair"]["n"]
          and small12["n"] == ck12["cell_pair_small_grid"]["n"]
          and zcol12["n"] == ck12["zcol_pair"]["n"]
          and small12["ncells"] == ck12["cell_pair_small_grid"]["ncells"]
          and zcol12["ncells"] == ck12["zcol_pair"]["ncells"]
          and vcli12["launches"].get("cell_pair_small_grid", 0) == 0,
          "phase 12: a batched kernel's run and its timed shape differ")
    print(f"phase 12: B={REPLICA_B} x N={big['n']}: "
          f"{big['wall_ms_per_step']:.3f} ms/step wall, "
          f"{big['aggregate_steps_per_s']:.1f} aggregate steps/s vs one "
          f"replica's {big['one_replica_steps_per_s']:.1f} (phase 6), "
          f"device {big['device_us_per_step']:.1f} us/step, busy "
          f"{big['busy_share']:.3f}, device ops/step "
          f"{big['device_ops_per_step']} vs one replica "
          f"{big['one_replica_device_ops_per_step']}, list build "
          f"{big['list_build_ms']:.4f} ms (one replica "
          f"{big['one_replica_list_build_ms']:.4f}), K2 batched global "
          f"{big['k2_batch_global_ms']:.4f} ms (one replica "
          f"{big['k2_one_replica_ms']:.4f}); zcol B={REPLICA_B} x N="
          f"{zcol12['n']} {zcol12['aggregate_steps_per_s']:.1f} aggregate "
          f"steps/s; CLI B={REPLICA_B} N="
          f"{vcli12['n']} {vcli12['aggregate_steps_per_s']} aggregate "
          f"steps/s", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(12)

    # phase 13: the MTTK and Berendsen baths (unfused, K4/K5 never), exact
    # resume through a checkpoint, the triatomic scene, an MTTK batch
    mttk = bath_path(torch, pt, "mttk", 0, BATH_CHUNKS, one_step)
    beren = bath_path(torch, pt, "berendsen", 0, BERENDSEN_CHUNKS, one_step)
    torch.cuda.empty_cache()
    mttk_big = bath_large_path(
        torch, pt, large["ms_per_step"],
        (big["one_replica_device_ops_per_step"],
         big["one_replica_device_us_per_step"]))
    torch.cuda.empty_cache()
    resumed = {mode: resume_path(torch, pt, mode)
               for mode in ("dense", "cell")}
    tri = triatomic_phase(torch, pt)
    torch.cuda.empty_cache()
    bath_f64 = bath_replica_trajectory(torch, pt)
    print(f"phase 13: MTTK N=501 {mttk['steps_per_s']:.1f} steps/s "
          f"(phase 3 fused Bussi {fused['steps_per_s']:.1f}, unfused "
          f"{unfused['steps_per_s']:.1f}), device ops/step "
          f"{mttk['device_ops_per_step']} vs fused "
          f"{mttk['fused_device_ops_per_step']}, device "
          f"{mttk['device_us_per_step']:.1f} us/step vs fused "
          f"{mttk['fused_device_us_per_step']:.1f}, extended drift "
          f"{mttk['extended_drift_ha']:.3e} Ha (bound "
          f"{MTTK_DRIFT_BOUND_HA}); Berendsen last-chunk T "
          f"{beren['mean_T_last_chunk_K']:.1f} K (bound |T - 100| < "
          f"{BERENDSEN_T_BOUND_K} K; the JAX reading {BERENDSEN_JAX_T_K} "
          f"K); MTTK N={mttk_big['n']} "
          f"{mttk_big['ms_per_step']:.3f} ms/step vs default "
          f"{mttk_big['default_ms_per_step']:.3f}, device ops/step "
          f"{mttk_big['device_ops_per_step']} vs "
          f"{mttk_big['default_device_ops_per_step']}, band "
          f"{mttk_big['extended_band_ha']:.3e} Ha, checkpoint save "
          f"{mttk_big['checkpoint_save_ms']:.1f} ms load "
          f"{mttk_big['checkpoint_load_ms']:.1f} ms; resume max|dx| "
          f"{resumed['dense']['max_dx_bohr']:.2e} / "
          f"{resumed['cell']['max_dx_bohr']:.2e} bohr; MTTK batch "
          f"{bath_f64:.2e} bohr", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(13)

    # phase 14: replicas over ranks (--shard-replicas, the replicas x
    # slabs runner) on ranks that share the card, and the native host I/O
    torch.cuda.empty_cache()
    shard = shard_replicas_phase(torch, pt, vcli)
    nat = native_io_phase(torch, pt)
    print(f"phase 14: --shard-replicas {SHARD_R} B={REPLICA_B} "
          f"{shard['aggregate_steps_per_s']} aggregate steps/s vs one rank's "
          f"{vcli['aggregate_steps_per_s']} (phase 11d), f64 max relative "
          f"{shard['f64_rel']:.2e}; replicas x slabs max|dx| "
          f"{shard['domain_dx']:.2e} bohr; EnergyTracker.consume per "
          f"500-step chunk in the CLI (a row a step) "
          f"{nat['cli_consume_ms']['native']:.3f} ms native vs "
          f"{nat['cli_consume_ms']['python']:.3f} ms Python; GSD frame at "
          f"N=100,001 {nat['gsd_frame_n100001_ms']['native']:.2f} ms vs "
          f"{nat['gsd_frame_n100001_ms']['python']:.2f} ms", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(14)

    # phase 15: a replica batch over slabs, the slab kernel, K2 and K3 once
    # a step for the whole batch with each replica's own tables
    sk15 = {}
    for dtype in (torch.float32, torch.float64):
        r = slab_batch_kernel_phase(torch, pt, dtype,
                                    timed=dtype == torch.float32)
        if dtype == torch.float32:
            sk15 = r
        torch.cuda.empty_cache()
    traj15 = slab_batch_f64_trajectory(torch, pt)
    torch.cuda.empty_cache()
    slabs15 = slab_batch_step_path(torch, pt, large["universe_band_ha"], dom,
                                   big)
    torch.cuda.empty_cache()
    k23 = sk15["per_replica_charges"]
    k15 = slabs15["kernel"]
    print(f"phase 15: B={REPLICA_B} x N={slabs15['n']} on one slab "
          f"(rebuilt every {slabs15['rebuild_every']} steps after the "
          f"retries {slabs15['retries']}): "
          f"{slabs15['wall_ms_per_step']:.3f} ms/step wall, "
          f"{slabs15['aggregate_steps_per_s']:.1f} aggregate steps/s (one "
          f"replica's slab runs in turn {1e3 / dom['ms_per_step']:.1f}; "
          f"the unsharded batch {big['aggregate_steps_per_s']:.1f}), "
          f"device {slabs15['device_us_per_step']:.1f} us/step with the "
          f"rebuild amortised, busy {slabs15['busy_share']:.3f} (unsharded "
          f"batch {big['busy_share']:.3f}), step device ops "
          f"{slabs15['step_device_ops']} vs B=1 "
          f"{slabs15['step_device_ops_one_replica']}; cell_pair_slab on "
          f"the final state {k15['ms']:.4f} ms (twin {k15['plain_ms']:.2f} "
          f"ms, bound {k15['bound_ms']:.5f} ms, max|dF| "
          f"{k15['max_abs_err']:.2e}); cell_pair_slab B="
          f"{REPLICA_B} x N={sk15['n']} {sk15['ms']:.4f} ms vs "
          f"{REPLICA_B} one-replica launches "
          f"{sk15[f'{REPLICA_B}_one_replica_launches_ms']:.4f} ms; K2 / K3 "
          f"per-replica charges {k23['pppm_spread']['ms']:.4f} / "
          f"{k23['pppm_interpolate']['ms']:.4f} ms vs shared "
          f"{k23['pppm_spread']['shared_charge_ms']:.4f} / "
          f"{k23['pppm_interpolate']['shared_charge_ms']:.4f} ms; f64 "
          f"batch max|dx| {traj15['max_dx_bohr']:.2e} bohr", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(15)

    # phase 16: the examples on the card, and pppm_reciprocal_energy
    # (kernel 2) against its plain twin
    e16 = {str(dtype).split(".")[-1]: pppm_energy_phase(torch, pt, dtype)
           for dtype in (torch.float32, torch.float64)}
    print(f"phase 16: pppm_reciprocal_energy on the card vs its plain twin, "
          f"|dE|/|E| {e16}", flush=True)
    ex16 = examples_phase(torch)
    print("phase 16: examples " + ", ".join(
        f"{k} {v['seconds']:.1f} s" for k, v in ex16.items()), flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(16)

    # phase 17: user custom forces on the fused step, in a batch and in
    # cell mode; Simulation.run(profile_dir=)
    cf = custom_force_path(torch, pt, one_step)
    cf_f64 = custom_batch_trajectory(torch, pt)
    torch.cuda.empty_cache()
    cf_large = custom_large_path(torch, pt)
    torch.cuda.empty_cache()
    cf_prof = profile_dir_path(torch, pt)
    print(f"phase 17: trap N=501 {cf['steps_per_s']:.1f} steps/s (phase 3 "
          f"fused {fused['steps_per_s']:.1f}), drift "
          f"{cf['universe_drift_ha']:.3e} Ha (bound "
          f"{CUSTOM_DRIFT_BOUND_HA:.3e}), device ops/step "
          f"{cf['device_ops_per_step']} vs {cf['no_trap_device_ops_per_step']}"
          f" without the trap, device {cf['device_us_per_step']:.1f} us/step "
          f"vs {cf['no_trap_device_us_per_step']:.1f}; f64 batch "
          f"{cf_f64:.2e} bohr; N={cf_large['n']} cell mode "
          f"{cf_large['ms_per_step']:.3f} ms/step; profile_dir trace "
          f"{cf_prof['trace_bytes']} bytes", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(17)

    # phase 18: atom sharding by rows: K1, the cell kernel and K9 with a
    # row range, and Simulation(shard_atoms=2) on two ranks sharing the
    # card, in dense, cell and zcol mode
    rk18 = {}
    for dtype in (torch.float32, torch.float64):
        r = rows_kernel_phase(torch, pt, dtype, timed=dtype == torch.float32)
        z = zcol_rows_kernel_phase(torch, pt, dtype,
                                   timed=dtype == torch.float32)
        if dtype == torch.float32:
            rk18 = dict(r, zcol_pair_rows=z)
        torch.cuda.empty_cache()
    rows18 = rows_path_phase(torch, pt)
    print(f"phase 18: dense_pair_rows N={rk18['dense_pair_rows']['n']} "
          f"{rk18['dense_pair_rows']['ms']:.4f} ms (full launch "
          f"{shapes[(250, None)]['dense_pair']['ms']:.4f} ms), "
          f"cell_pair_rows N={rk18['cell_pair_rows']['n']} "
          f"{rk18['cell_pair_rows']['ms']:.4f} ms; 2 ranks on one card: "
          f"f64 max|dx| {rows18['f64_max_dx_bohr']:.2e} bohr, f32 "
          f"{rows18['f32_steps_per_s']:.1f} steps/s (phase 3 fused "
          f"{fused['steps_per_s']:.1f}), drift "
          f"{rows18['f32_universe_drift_ha']:.3e} Ha, cell N="
          f"{rows18['18d cell f32']['n']} "
          f"{rows18['cell_ms_per_step']:.3f} ms/step; zcol_pair_rows "
          f"N={rk18['zcol_pair_rows']['n']} "
          f"{rk18['zcol_pair_rows']['ms']:.4f} ms (full wrapper "
          f"{rk18['zcol_pair_rows']['full_ms']:.4f} ms; pair kernel "
          f"{rk18['zcol_pair_rows']['kernel_only_ms']:.4f} vs "
          f"{rk18['zcol_pair_rows']['full_kernel_only_ms']:.4f} ms), zcol "
          f"N={rows18['18e zcol f32']['n']} "
          f"{rows18['zcol_ms_per_step']:.3f} ms/step, f64 max|dx| "
          f"{rows18['zcol_f64_max_dx_bohr']:.2e} bohr", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(18)

    print(f"summary: {kind} | {card} | N=501 f32 Bussi+Langevin "
          f"Simulation.run {fused['steps_per_s']:.1f} steps/s fused, "
          f"{unfused['steps_per_s']:.1f} unfused (medians of {N_CHUNKS} "
          f"{CHUNK}-step chunks, and {SHORT_RUN[1]} of {SHORT_RUN[2]}), "
          f"drift {fused['universe_drift_ha']:.3e} / "
          f"{unfused['universe_drift_ha']:.3e} Ha; CLI {cli['steps']} steps "
          f"{cli['steps_per_s']:.1f} steps/s {cli['ns_per_day']:.4f} ns/day, "
          f"drift {cli['universe_drift_ha']:.3e} Ha | large N: "
          f"N={held['n']} {held['ms_per_step']:.3f} ms/step band "
          f"{held['universe_band_ha']:.3e} Ha, N={large['n']} "
          f"{large['ms_per_step']:.3f} ms/step band "
          f"{large['universe_band_ha']:.3e} Ha ({ratio:.2f}x that at half "
          f"dt); N=501 cell mode "
          f"{small['steps_per_s']:.1f} steps/s; CLI N={2 * HELD_N_MOL + 1} "
          f"{cli_held['steps']} steps drift "
          f"{cli_held['universe_drift_ha']:.3e} Ha, N={2 * LARGE_N_MOL + 1} "
          f"{cli_large['steps']} steps {cli_large['steps_per_s']:.1f} "
          f"steps/s drift {cli_large['universe_drift_ha']:.3e} Ha (f64: "
          f"{cli_f64['universe_drift_ha']:.3e} Ha) | domain, 1 slab: "
          f"cell_pair_slab {slab['ms']:.4f} ms (twin {slab['plain_ms']:.2f} "
          f"ms, bound {slab['bound_ms']:.5f} ms), f64 40 steps max|dx| "
          f"{dom_f64:.2e} bohr, N={dom['n']} {dom['ms_per_step']:.3f} "
          f"ms/step (unsharded {large['ms_per_step']:.3f}) band "
          f"{dom['universe_band_ha']:.3e} Ha | zcol: zcol_pair "
          f"{zres['ms']:.4f} ms (twin {zres['plain_ms']:.2f} ms, bound "
          f"{zres['bound_ms']:.5f} ms, hull {zres['hull_ms']:.4f} ms "
          f"(twins {zres['hull_plain_ms']:.4f} ms), list "
          f"build {zres['list_build_ms']:.4f} ms), N={zcol['n']} "
          f"{zcol['ms_per_step']:.3f} ms/step band "
          f"{zcol['universe_band_ha']:.3e} Ha, f64 40 steps max|dx| "
          f"{zcol_f64:.2e} bohr | replicas at N=501: K1-K5 batched B="
          f"{REPLICA_B} " + " ".join(
              f"{k} {rk[k]['ms']:.4f}" for k in BATCHED_KERNELS) + " ms, "
          f"f64 batch {rep_f64:.2e} bohr, " + ", ".join(
              f"B={B} {r['aggregate_steps_per_s']:.0f}"
              for B, r in rsteps.items())
          + f" aggregate steps/s, CLI B={REPLICA_B} "
          f"{vcli['aggregate_steps_per_s']} aggregate steps/s drift "
          f"{max(vcli['universe_drift_ha']):.3e} Ha | replicas in cell "
          f"and zcol mode: B={REPLICA_B} " + " ".join(
              f"{k} {ck12[k]['ms']:.4f}" for k in BATCHED_CELL_KERNELS)
          + f" ms, f64 batches {traj12['cell']['max_dx_bohr']:.2e} / "
          f"{traj12['zcol']['max_dx_bohr']:.2e} bohr, N={big['n']} "
          f"{big['aggregate_steps_per_s']:.0f} aggregate steps/s (busy "
          f"{big['busy_share']:.3f}), CLI N={vcli12['n']} "
          f"{vcli12['aggregate_steps_per_s']} aggregate steps/s drift "
          f"{max(vcli12['universe_drift_ha']):.3e} Ha | baths: MTTK "
          f"N=501 {mttk['steps_per_s']:.1f} steps/s extended drift "
          f"{mttk['extended_drift_ha']:.3e} Ha, Berendsen T "
          f"{beren['mean_T_last_chunk_K']:.1f} K, MTTK N={mttk_big['n']} "
          f"{mttk_big['ms_per_step']:.3f} ms/step, resume "
          f"{resumed['dense']['max_dx_bohr']:.2e} / "
          f"{resumed['cell']['max_dx_bohr']:.2e} bohr, triatomic K1 / cell "
          f"f32 max|dF| {tri[('dense', 'float32')]:.2e} / "
          f"{tri[('cell', 'float32')]:.2e} | replicas over ranks: "
          f"--shard-replicas {SHARD_R} {shard['aggregate_steps_per_s']} "
          f"aggregate steps/s drift {max(shard['drifts']):.3e} Ha, f64 "
          f"{shard['f64_rel']:.2e} relative, {SHARD_R} x 1 runner "
          f"{shard['domain_dx']:.2e} bohr; native I/O consume "
          f"{nat['cli_consume_ms']['native']:.3f} / "
          f"{nat['cli_consume_ms']['python']:.3f} ms | batch over slabs: "
          f"cell_pair_slab B={REPLICA_B} x N={k15['n']} "
          f"{k15['ms']:.4f} ms, f64 "
          f"{traj15['max_dx_bohr']:.2e} bohr, N={slabs15['n']} "
          f"{slabs15['aggregate_steps_per_s']:.0f} aggregate steps/s (busy "
          f"{slabs15['busy_share']:.3f}) | examples: 06 "
          f"{ex16['06']['steps']} steps drift {ex16['06']['drift_ha']:.3e} "
          f"Ha, mean T {ex16['06']['mean_T_K']:.1f} K, "
          f"{ex16['06']['steps_per_s']:.1f} steps/s; 07 splitting "
          f"{ex16['07']['splitting_cm1']:.2f} cm^-1 | custom force: N=501 "
          f"{cf['steps_per_s']:.1f} steps/s drift "
          f"{cf['universe_drift_ha']:.3e} Ha, f64 batch {cf_f64:.2e} bohr, "
          f"N={cf_large['n']} {cf_large['ms_per_step']:.3f} ms/step | rows: "
          f"dense_pair_rows {rk18['dense_pair_rows']['ms']:.4f} ms, "
          f"cell_pair_rows {rk18['cell_pair_rows']['ms']:.4f} ms, 2 ranks "
          f"f64 {rows18['f64_max_dx_bohr']:.2e} bohr, f32 "
          f"{rows18['f32_steps_per_s']:.1f} steps/s drift "
          f"{rows18['f32_universe_drift_ha']:.3e} Ha, zcol_pair_rows "
          f"{rk18['zcol_pair_rows']['ms']:.4f} ms, zcol 2 ranks f64 "
          f"{rows18['zcol_f64_max_dx_bohr']:.2e} bohr | script "
          f"{clock.total():.1f} s, "
          + ", ".join(f"phase {p} {t:.1f} s"
                      for p, t in sorted(clock.seconds.items())),
          flush=True)
    # each kernel's numbers at the shapes of the path it serves: K1 at
    # N = 501 (phase 5's launches), the cell kernel and K2-K5 at
    # N = 100,001 (phase 6's launches), the small-grid entry at N = 501 in
    # cell mode (phase 6's small-grid launches)
    where = {k: ((250, None), cli["launches"]) for k in KERNELS}
    for k in ("cell_pair", "pppm_spread", "pppm_interpolate",
              "fused_pre_force", "fused_post_force"):
        where[k] = ((LARGE_N_MOL, None), large["launches"])
    where["cell_pair_small_grid"] = ((250, "cell"), small["launches"])
    # the slab kernel at N = 100,001 (phase 9's domain run's launches)
    shapes["slab"] = {"cell_pair_slab": slab}
    where["cell_pair_slab"] = ("slab", dom["launches"])
    # at N = 100,001 (phase 10's zcol run's launches): the zcol_pair row
    # is the whole wrapper, zcol_pair_force (its hull and pair kernels and
    # three PyTorch operations, against the whole twin and the whole
    # pass's bound); the zcol_hull row is the wrapper's hull launch alone,
    # so the two rows overlap by the hull kernel. The hull is an integer
    # result, held bit-equal to the twins'
    shapes["zcol"] = {"zcol_pair": zres, "zcol_hull": dict(
        max_abs_err=float(zres["hull_max_abs_err"]), ms=zres["hull_ms"],
        plain_ms=zres["hull_plain_ms"], bound_ms=zres["hull_bound_ms"],
        bound_by=zres["hull_bound_by"])}
    where["zcol_pair"] = where["zcol_hull"] = ("zcol", zcol["launches"])
    # the batched kernels: REPLICA_B replicas of N = 501 in one launch
    # (phase 11d's CLI launches)
    shapes["replicas"] = {f"{k}_b{REPLICA_B}": rk[k]
                          for k in BATCHED_KERNELS}
    batched = {f"{k}_b{REPLICA_B}": k for k in BATCHED_KERNELS}
    for k in batched:
        where[k] = ("replicas", vcli["launches"])
    # the batched cell and zcol kernels: REPLICA_B replicas at N = 20,001
    # (the small grid at N = 501) in one launch, f32; the launches of
    # phase 12's runs at those shapes: the CLI at 10,000 molecules (the
    # cell kernel on phase 12a's 10^3 grid), the small-grid batch, the
    # zcol batch (K9 and its hull)
    shapes["replicas_cell"] = {f"{k}_b{REPLICA_B}": ck12[k]
                               for k in BATCHED_CELL_KERNELS}
    runs = {"cell_pair": vcli12["launches"],
            "cell_pair_small_grid": small12["launches"],
            "zcol_pair": zcol12["launches"],
            "zcol_hull": zcol12["launches"]}
    for k in BATCHED_CELL_KERNELS:
        batched[f"{k}_b{REPLICA_B}"] = k
        where[f"{k}_b{REPLICA_B}"] = ("replicas_cell", runs[k])
    # the batch over slabs: REPLICA_B replicas at N = 100,001 on one slab
    # in one launch, held and timed on 15c's final state, launched by 15c's
    # run
    shapes["slabs"] = {f"cell_pair_slab_b{REPLICA_B}": slabs15["kernel"]}
    batched[f"cell_pair_slab_b{REPLICA_B}"] = "cell_pair_slab"
    where[f"cell_pair_slab_b{REPLICA_B}"] = ("slabs", slabs15["launches"])
    # the row-range rows: timed on phase 18a/18b/18e's first block in
    # float32, launched by 18c's float32 run (K1), 18d's (the cell kernel)
    # and 18e's (K9)
    shapes["rows"] = rk18
    row_runs = {"dense_pair": "18c f32", "cell_pair": "18d cell f32",
                "zcol_pair": "18e zcol f32"}
    for k, base in ROWS_KERNELS.items():
        batched[k] = base
        where[k] = ("rows", {base: rows18[row_runs[base]]["launches"].get(
            k, 0)})
    kernels = []
    for k in list(KERNELS) + list(batched):
        src, rep = KERNELS[batched.get(k, k)]
        shape, launches = where[k]
        r = shapes[shape][k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=launches.get(batched.get(k, k), 0),
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
