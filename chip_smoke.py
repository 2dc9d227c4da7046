#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cavmd_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it builds the port's CUDA kernels
from ``cavmd_tpu_torch/csrc`` itself, and exits non-zero on any failure —
including when no CUDA device is present or the package is not next to it.

Phases:
  0. device: the card's name and power limit (nvidia-smi);
  1. build: compile every kernel source with nvcc (sm_90a), one nvcc per
     source, all started together; print the seconds and, from ptxas, each
     kernel's registers and spill bytes by name (the cell kernel and K4
     must be found in float and double);
  2. kernels against their plain PyTorch twins on the card, float32 and
     float64: at the N = 501 reference scene and at N = 4001 (reference
     density) in dense mode, the pair pass (K1), the 32^3 order-6 PPPM
     spread (K2) and interpolation (K3), and the fused integrator tail (K4
     pre-force, K5 post-force, with particles pushed across the box
     faces); at N = 100,001 in cell mode (17^3 cells) the cell kernel
     (K6's counterpart) and K2-K5; on the N = 501 scene in cell mode (2^3
     cells, K8's counterpart) the cell kernel — max |diff|, and for the
     cell kernel and K4 two calls on the same inputs bit-equal; in float32
     also the median device time of one call (``ms``, CUDA events with the
     host out of the way), the median host-bound time of one call
     (``host_call_ms``), the twin's times, and the bound from the call's
     bytes and operations (the cell kernel's counted cell by cell); the
     cell-list build's times beside them;
  3. ``Simulation.run`` on the reference scene (250 O2/N2 + photon, f32,
     dense ForceField, Bussi 100 K tau 5 ps on the molecules, Langevin
     tau 5 ps on the photon, dt 0.25 fs), twice: with the fused tail (the
     default on the card) and without it (``fuse_integrator=False``);
     each one warm-up chunk, then 5 x 1000 steps: launch counts,
     finiteness, universe-energy drift, steps/s (median of the chunks);
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
     cell mode (the small grid) through ``Simulation.run``;
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
 10. the z-sorted column mode (``pair_mode='zcol'``): its kernel
     (``zcol_pair``, K9's counterpart) against its plain twin on the first
     chunk's column list of ``build_large_n(50_000, pair_mode='zcol')``
     (N = 100,001, 17 x 17 columns of cap 512), float32 and float64, with
     its times and bound as in phase 2, the list build's and the hull's
     device times, the candidate count and the hull statistics;
     ``build_large_n(50_000, pair_mode='zcol')`` through ``Simulation.run``
     on phase 6's protocol (the kernel launched once a step and the cell
     kernel never, no overflow, ms per step beside phase 6's, the universe
     band held to DOMAIN_BAND_RATIO times phase 6's); and a float64
     trajectory of 40 steps at N = 20,001 in zcol mode against the cell
     mode on the card, same draws, across a rebuild of the column list.

Each path's launch counts are set to 0 just before it and read just after.
Each phase ends with a line of the seconds it took. The last four lines are
the summary (with the script's seconds and phase 10's), a JSON object of
per-kernel results, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
# phase 5: the CLI's default adaptive dt covers CLI_RUNTIME_PS in ~4900
# steps at N = 501 (energy rows every 1000 steps). The drift bound is 3x
# the JAX CLI's own reading on the same arguments with --device CPU
# --precision f32: max |U - U[0]| of the universe_total_energy column is
# 4.0e-6 Ha at seed 0 and 2.0e-6, 1.2e-5, 3.0e-6, 7.0e-6 Ha at seeds 1-4
# (the printed energies are rounded to 1e-6 Ha); the bound is 3x the
# largest. The port's CLI on the CPU gives 3.0e-6 Ha at seed 0; a copy of
# the port whose Bussi step drops its reservoir tally gives 4.3e-3 Ha.
CLI_RUNTIME_PS = 0.08
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
SMALL_GRID_CHUNKS = 2  # phase 6, N = 501 in cell mode, after N_WARM
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


def large_cli_args(n_molecules):
    return ["--device", "GPU", "--n-molecules", str(n_molecules),
            "--enable-energy-tracker", "--enable-fkt", "--seed", "0",
            "--runtime", str(LARGE_CLI_RUNTIME_PS),
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
}
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


# kernels whose registers and spills phase 1 must find by name in a fresh
# build's ptxas report, in float and double
PTXAS_NAMED = {"cell_pair": ("cell_pair_kernel",),
               "fused_integrator": ("pre_force_kernel",)}


def ptxas_report(log):
    """[(kernel, registers, spill store bytes, spill load bytes)] for each
    entry function of an ``nvcc -Xptxas -v`` log; a kernel template reads
    as ``name<float>`` or ``name<double>``."""
    out, entry, props, spill = [], None, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([\w$]+)'", line)
        if m:
            entry, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"Function properties for ([\w$]+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None and props == entry:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            k = re.search(r"([a-z][a-z_]*_kernel)I([fd])E", entry)
            label = entry
            if k:
                t = "float" if k.group(2) == "f" else "double"
                label = f"{k.group(1)}<{t}>"
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
    # ~2e9 spin cycles a second at H100 clocks, with a 3x margin
    spin_cycles = max(50_000_000, int(6e9 * inner * issue_s))
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


def profiled_device_ms(torch, fn, reps=5, match=None):
    """Device time of one call as the sum of its device operations'
    durations in a ``torch.profiler`` trace of ``reps`` calls (one stream,
    so the sum is the busy time); with ``match``, only of the operations
    whose name contains it. For the plain twins, which issue hundreds to
    thousands of launches a call: queued behind a spin kernel they fill
    the launch queue, the host then waits on the device, and
    ``device_ms`` cannot keep the host out of the way. One call runs
    first under sync debug mode "error", so a call that synchronises with
    the host raises here too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and (match is None or match in e.name)]
    check(len(dev) >= reps, "profiled_device_ms: the trace has no device "
          f"operations{'' if match is None else ' named ' + match}")
    return sum(e.time_range.elapsed_us() for e in dev) / reps / 1e3


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
        torch.cuda.synchronize()
        hold("dense_pair", [(f_k, f_p), (elj_k, elj_p), (eew_k, eew_p)],
             "F,E")
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

    pre = None
    if not pair_only:
        g_k = sk.spread_grid(pos, q, box, order, mesh)
        g_p = sk.spread_grid_plain(pos, q, box, order, mesh)
        torch.cuda.synchronize()
        hold("pppm_spread", [(g_k, g_p)], "grid")

        grid = g_p.detach().requires_grad_(True)
        (ct,) = torch.autograd.grad(mesh_energy(grid, ff.pppm), grid)
        ct = ct.contiguous()
        d_k = sk.interpolate_grad(ct, pos, q, box, order, mesh)
        d_p = sk.interpolate_grad_plain(ct, pos, q, box, order, mesh)
        torch.cuda.synchronize()
        hold("pppm_interpolate", [(d_k, d_p)], "dE/dr")

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
        p5 = fi.post_force_apply_plain(*post)
        torch.cuda.synchronize()
        ke_photon = float(p5[2].abs() + p5[3].abs())
        hold("fused_post_force", list(zip(k5, p5)), "v,KE,dE_res",
             scales=(None, None, None, ke_photon))
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
                pair_key=None):
    """Pair counts over a pair pass's candidate tiles ``(rows, idx_i,
    id_j, dxs, r2)``: (inside the cutoff with both slots real, counted
    (not self, not excluded), in the LJ range, charged). ``pair_key``
    (N,), when given, is the id the self and exclusion tests compare."""
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
        near = ((idx_i < n)[:, :, None] & (id_j < n)[:, None, :]
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
                     exclusions, n_blocks, pair_key=None):
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
    erfc and exp each counted as one) for a charged pair."""
    from cavmd_tpu_torch.ops.neighbor import cell_block_for, cell_tiles

    n, e = position.shape[0], position.element_size()
    C, cap = clist.bucket_idx.shape
    T = ff.lj_eps.shape[0]
    E = exclusions.shape[1]
    occ = (clist.bucket_idx < n).sum(dim=1)
    occ_x = torch.cat([occ, occ.new_zeros(1)])
    window = occ_x[clist.neighbor_cells.long()].sum(dim=1)
    n_cand = int((occ * window).sum())
    n_staged = int(window[occ > 0].sum())
    small_axes = sum(1 for k in cfg.ncells if k < 3)
    n_near, n_in, n_lj, n_ew = pair_counts(
        torch, cell_tiles(position, box_L, clist, cell_block_for(cfg, e)),
        n, exclusions, typeid, charge, ff, cfg.r_cut * cfg.r_cut, pair_key)
    n_bytes = (e * (3 * n + 3 + n + 4 * T * T) + 4 * n
               + 4 * (C * cap + 27 * C + (n + 1) * E)
               + (4 * n if pair_key is not None else 0)
               + e * (3 * n + 2 * n_blocks))
    n_ops = (3 * n_staged + (9 + 4 * small_axes) * n_cand
             + (1 + E) * n_near + 6 * n_in + 17 * n_lj + 20 * n_ew)
    return n_bytes, n_ops, dict(candidates=n_cand, staged_rows=n_staged,
                                inside_cutoff=n_near, counted=n_in,
                                lj=n_lj, ewald=n_ew)


def work_counts(torch, snap, ff, pre):
    """(bytes moved, operations) of one call of each kernel on this run's
    inputs: each input read once, each output written once; operations as
    the kernel sources do them (sqrt, erfc, exp, floor counted as one), and
    only for the pairs / particles these inputs make it do. The dense pair
    kernel only in dense mode (its count builds (N, N) tensors)."""
    from cavmd_tpu_torch.core.box import minimum_image

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
        n_masked = int((lj | cw).sum())
        n_lj = int((lj & (r2 < rc2)).sum())
        n_cw = int((cw & (r2 < ff.coulomb_rcut ** 2)).sum())
        blocks = (n + 3) // 4
        # pos, box, typeid, 4 (T, T) tables, charge, two (N, N) uint8
        # masks in; forces and the per-block energy partials out. Per
        # masked pair 26 ops (min image, r^2, force accumulation), +15
        # inside the LJ cutoff, +18 inside the Coulomb cutoff
        counts["dense_pair"] = (
            e * (3 * n + 3 + 4 * T * T + n) + 4 * n + 2 * n * n
            + e * (3 * n + 2 * blocks),
            26 * n_masked + 15 * n_lj + 18 * n_cw)
    n_q = int((snap.charge != 0).sum())
    n_mesh = ff.pppm_mesh[0] * ff.pppm_mesh[1] * ff.pppm_mesh[2]
    p = ff.pppm_order
    stencil = 3 * (5 + 5 * (p * (p + 1) // 2 - 1))  # u, floor, Cox-de Boor
    n_mol = int(pre[6].sum())
    return {
        **counts,
        # pos, charge, box in; the mesh out. Per charged particle: three
        # stencils and p^3 (product, atomic add) pairs
        "pppm_spread": (e * (3 * n + n + 3 + n_mesh),
                        n_q * (stencil + 2 * p ** 3 + p * p)),
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


def main_path(torch, pt, fuse):
    """Simulation.run on the reference scene; ``fuse`` is passed as
    ``fuse_integrator`` (None = the default: fused on the card)."""
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
                        chunk_size=CHUNK, fuse_integrator=fuse)
    t0 = time.perf_counter()
    sim.run(n_steps=N_WARM)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    chunks, chunk_s = [], []
    for _ in range(N_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        chunks.append(sim.last_obs)
    launches = dict(_cuda.launches)
    n_steps = N_CHUNKS * CHUNK
    total = N_WARM + n_steps

    obs = {k: np.concatenate([c[k] for c in chunks]) for k in OBS_KEYS}
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
    check(drift < DRIFT_BOUND_HA,
          f"{label} path: universe drift {drift} >= {DRIFT_BOUND_HA} Ha")
    T_mol = 2.0 * obs["kinetic_molecular"] / (3.0 * (snap.N - 1) * kT) * 100.0
    chunk_rates = [CHUNK / s for s in chunk_s]
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
    (in zcol mode its pair kernel exactly once a step, the initial forces
    included, and the cell kernel never); the universe-energy band
    max(U) - min(U) over the window is held to ``drift_bound`` when one is
    given, else reported."""
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
              and launches.get("cell_pair", 0) == 0,
              f"{label}: zcol_pair launched {launches.get('zcol_pair', 0)} "
              f"times (want {total + 1}), cell_pair "
              f"{launches.get('cell_pair', 0)}")
    kernels = [pair_kernel, "pppm_spread", "pppm_interpolate",
               "fused_pre_force", "fused_post_force"]
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
    deduplicated neighbour table) through Simulation.run, phase 3's
    protocol with fewer chunks. Its universe drift is held to phase 3's
    bound: the window is a prefix of phase 3's, from the same first step."""
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
    sim.run(n_steps=N_WARM)
    chunks, chunk_s = [], []
    for _ in range(SMALL_GRID_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=CHUNK)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        chunks.append(sim.last_obs)
    launches = dict(_cuda.launches)
    total = N_WARM + SMALL_GRID_CHUNKS * CHUNK
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
    check(drift < DRIFT_BOUND_HA,
          f"small-grid path: universe drift {drift} >= {DRIFT_BOUND_HA} Ha")
    res = dict(n=snap.N, ncells=ff.cell_cfg.ncells, cap=ff.cell_cfg.cap,
               steps=SMALL_GRID_CHUNKS * CHUNK,
               steps_per_s=statistics.median(CHUNK / t for t in chunk_s),
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
                     charge, ff):
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
    twin's tiles)."""
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
    rows = torch.clamp(real - jb * zk.J_BLOCK, 0, zk.J_BLOCK)
    staged = torch.where(t < cnt, rows, 0).sum(dim=-1)
    real_i = (clist.bucket_idx < n).view(XY, NIB, zk.I_BLOCK).sum(dim=-1)
    n_staged = int(staged.sum())
    n_cand = int((real_i * staged).sum())
    n_near, n_in, n_lj, n_ew = pair_counts(
        torch, zk.zcol_tiles(pos_loc, box_L, clist, hull, W,
                             zk.rows_per_block(W, e)),
        n, ff.cell_exclusions, typeid, charge, ff, cfg.r_cut * cfg.r_cut)
    n_bytes = (e * (9 * n + 3 + n + 4 * T * T) + 4 * n
               + 4 * (XY * Kc + 9 * XY * Kc + (n + 1) * E)
               + e * (3 * n + 2 * XY * NIB))
    n_ops = (12 * n + 2 * 10 * XY * Kc + 12 * XY * NIB * NB
             + 3 * n_staged + 9 * n_cand + (1 + E) * n_near + 6 * n_in
             + 17 * n_lj + 20 * n_ew)
    return n_bytes, n_ops, dict(candidates=n_cand, staged_rows=n_staged,
                                inside_cutoff=n_near, counted=n_in,
                                lj=n_lj, ewald=n_ew)


def zcol_kernel_phase(torch, pt, dtype, timed):
    """Phase 10: the zcol kernel against its plain twin on the column list
    of build_large_n(50_000, pair_mode='zcol')'s scene at its start (the
    first chunk's list), N = 100,001; in float32 also its device time,
    host-bound time, the twin's device time, the bound, the device times
    of the list build and of the hull alone, the candidate count and the
    hull statistics."""
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
    args = (pos, box, clist, cfg, snap.typeid, snap.charge, ff.lj_eps,
            ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift, ff.cell_exclusions,
            ff.kappa_value, ff.zcol_W)
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    k = zk.zcol_pair_force(*args)
    p = zk.zcol_pair_force_plain(*args)
    torch.cuda.synchronize()
    check(not bool(k[3]) and not bool(p[3]),
          f"zcol_pair N={snap.N} {name}: the window overflowed")
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
        # the wrapper, the hull and the build each issue 40-70 launches a
        # call: one call per sample keeps them inside the launch queue
        # behind the spin (ten would fill it, and the host would wait)
        one = dict(inner=1)
        out["ms"] = device_ms(torch, lambda: zk.zcol_pair_force(*args),
                              **one)
        out["kernel_only_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force(*args),
            match="zcol_pair_kernel")
        out["host_call_ms"] = host_call_ms(
            torch, lambda: zk.zcol_pair_force(*args))
        out["plain_ms"] = profiled_device_ms(
            torch, lambda: zk.zcol_pair_force_plain(*args))
        out["hull_ms"] = device_ms(torch, lambda: zk.zcol_hull(
            zk.zcol_local_positions(pos, box, clist), box, clist, cfg,
            ff.zcol_W), **one)
        out["list_build_ms"] = device_ms(
            torch, lambda: ff.build_cells(pos, box), **one)
        n_bytes, n_ops, pairs = zcol_work_counts(
            torch, pos_loc, box, clist, cfg, hull, W, snap.typeid,
            snap.charge, ff)
        out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, n_ops)
        out.update(bytes=n_bytes, ops=n_ops, pairs=pairs)
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

    # phase 0: device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 0: device {kind}; nvidia-smi name, power.limit: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    clock.lap(0)

    # phase 1: build, one nvcc per source, all at once
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_cuda.build, SOURCES))
    build_s = time.perf_counter() - t0
    fresh = sorted(_cuda.build_log)
    print(f"phase 1: kernels ready in {build_s:.2f} s (compiled now: "
          f"{fresh or 'none, found built in this checkout'})", flush=True)
    for src, log in sorted(_cuda.build_log.items()):
        entries = ptxas_report(log)
        for label, regs, st, ld in entries:
            print(f"phase 1: ptxas {src}: {label}: {regs} registers, "
                  f"spill stores {st} B, spill loads {ld} B", flush=True)
        want = {f"{k}<{t}>" for k in PTXAS_NAMED.get(src, ())
                for t in ("float", "double")}
        missing = want - {label for label, *_ in entries}
        check(not missing, f"phase 1: no ptxas report for {sorted(missing)}")
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
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(2)

    # phase 3: Simulation.run at N = 501, fused (default) and unfused
    fused = main_path(torch, pt, None)
    unfused = main_path(torch, pt, False)
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
    print(f"phase 10: zcol_pair {zres['ms']:.4f} ms vs cell_pair "
          f"{cell100k['ms']:.4f} ms at N={large['n']}; candidates "
          f"{zres['pairs']['candidates']} (cell kernel "
          f"{cell100k['pairs']['candidates']}); "
          f"zcol step {zcol['ms_per_step']:.3f} ms vs cell "
          f"{large['ms_per_step']:.3f} ms", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    clock.lap(10)

    print(f"summary: {kind} | {card} | N=501 f32 Bussi+Langevin "
          f"Simulation.run {fused['steps_per_s']:.1f} steps/s fused, "
          f"{unfused['steps_per_s']:.1f} unfused (medians of {N_CHUNKS} "
          f"{CHUNK}-step chunks), drift {fused['universe_drift_ha']:.3e} / "
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
          f"{zres['bound_ms']:.5f} ms, hull {zres['hull_ms']:.4f} ms, list "
          f"build {zres['list_build_ms']:.4f} ms), N={zcol['n']} "
          f"{zcol['ms_per_step']:.3f} ms/step band "
          f"{zcol['universe_band_ha']:.3e} Ha, f64 40 steps max|dx| "
          f"{zcol_f64:.2e} bohr | script {clock.total():.1f} s, phase 10 "
          f"{clock.seconds[10]:.1f} s",
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
    # the zcol kernel at N = 100,001 (phase 10's zcol run's launches)
    shapes["zcol"] = {"zcol_pair": zres}
    where["zcol_pair"] = ("zcol", zcol["launches"])
    kernels = []
    for k, (src, rep) in KERNELS.items():
        shape, launches = where[k]
        r = shapes[shape][k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=rep,
            launches=launches.get(k, 0), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
