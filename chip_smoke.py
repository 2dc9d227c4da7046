#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cavmd_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it builds the port's CUDA kernels
from ``cavmd_tpu_torch/csrc`` itself, and exits non-zero on any failure —
including when no CUDA device is present or the package is not next to it.

Phases:
  0. device: the card's name and power limit (nvidia-smi);
  1. build: compile the kernels with nvcc (sm_90a), print the seconds;
  2. kernels against their plain PyTorch twins on the card, at the N = 501
     reference scene and at N = 4001 (reference density), float32 and
     float64, 32^3 order-6 mesh: max |diff|; in float32 also the median
     device time of one call (``ms``, CUDA events with the host out of the
     way) and the median host-bound time of one call (``host_call_ms``);
  3. main path: the reference scene (250 O2/N2 + photon, f32, dense
     ForceField, Bussi 100 K tau 5 ps on the molecules, Langevin tau 5 ps on
     the photon, dt 0.25 fs) through ``Simulation.run``: one warm-up chunk,
     then 5 x 1000 steps; launch counts, finiteness, universe-energy drift,
     steps/s (median of the five chunks);
  4. a float64 NVE trajectory of 20 steps on the card (kernels) against the
     same steps on the CPU (plain twins).

The line before the last is a JSON object of per-kernel results; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# stated tolerances (see PERF.md):
# f32: reordered f32 sums over ~N pair terms / p^3 stencil terms and
# nondeterministic f32 atomicAdd order in the spread -> 2e-5 of the scale.
# f64: same math in double -> 1e-11 of the scale.
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def host_call_ms(torch, fn, reps=15, inner=10):
    """Median over ``reps`` samples of the mean time of ``inner``
    back-to-back calls, from CUDA events (warmed up first). At these sizes
    the device waits on the host, so this is the cost of a call as the
    caller sees it: argument checks, allocation, launches and all."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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
    so the device runs them without waiting on the host. A sample counts
    only if the spin was still running when the end event was queued (the
    start event not yet reached); otherwise the spin is doubled. A call
    that synchronises with the host raises (sync debug mode "error")."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    spin_cycles = 50_000_000  # ~25-30 ms at H100 clocks
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
            check(spin_cycles < 2_000_000_000,
                  "device_ms: the host never got ahead of the device")
    return statistics.median(samples)


def reference_scene(pt, n_molecules, box_L, dtype, device):
    snap = pt.make_diatomic_system(n_molecules, box_L=box_L,
                                   temperature_K=100.0, seed=0)
    snap = pt.add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                                  temperature_K=100.0, seed=1)
    return snap.astype(dtype).to(device)


def kernel_phase(torch, pt, n_molecules, box_L, dtype, timed):
    """Each kernel against its plain twin on the same CUDA tensors."""
    from cavmd_tpu_torch.ops import pair_kernels as pk
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.ops.pppm import mesh_energy

    dev = torch.device("cuda")
    snap = reference_scene(pt, n_molecules, box_L, dtype, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    pos, box, q, tid = snap.position, snap.box_L, snap.charge, snap.typeid
    order, mesh = ff.pppm_order, ff.pppm_mesh
    name = str(dtype).replace("torch.", "")
    tol = TOL[name]
    out = {}

    pair_args = (pos, box, tid, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                 ff.lj_vshift, q, ff.lj_active, ff.coulomb_active,
                 ff.kappa_value, ff.coulomb_rcut ** 2)
    f_k, elj_k, eew_k = pk.dense_pair_force(*pair_args)
    f_p, elj_p, eew_p = pk.dense_pair_force_plain(*pair_args)
    torch.cuda.synchronize()
    f_err = float((f_k - f_p).abs().max())
    f_scale = float(f_p.abs().max())
    e_err = max(abs(float(elj_k - elj_p)), abs(float(eew_k - eew_p)))
    e_scale = max(abs(float(elj_p)), abs(float(eew_p)))
    check(torch.isfinite(f_k).all().item(), "pair kernel: non-finite force")
    check(f_err <= tol * f_scale,
          f"pair kernel N={snap.N} {name}: max|dF| {f_err} > {tol}*{f_scale}")
    check(e_err <= tol * e_scale,
          f"pair kernel N={snap.N} {name}: max|dE| {e_err} > {tol}*{e_scale}")
    out["dense_pair"] = dict(max_abs_err=f_err, scale=f_scale,
                             max_abs_energy_err=e_err)

    g_k = sk.spread_grid(pos, q, box, order, mesh)
    g_p = sk.spread_grid_plain(pos, q, box, order, mesh)
    torch.cuda.synchronize()
    g_err = float((g_k - g_p).abs().max())
    g_scale = float(g_p.abs().max())
    check(g_err <= tol * g_scale,
          f"spread kernel N={snap.N} {name}: max|dgrid| {g_err} > "
          f"{tol}*{g_scale}")
    out["pppm_spread"] = dict(max_abs_err=g_err, scale=g_scale)

    grid = g_p.detach().requires_grad_(True)
    (ct,) = torch.autograd.grad(mesh_energy(grid, ff.pppm), grid)
    ct = ct.contiguous()
    d_k = sk.interpolate_grad(ct, pos, q, box, order, mesh)
    d_p = sk.interpolate_grad_plain(ct, pos, q, box, order, mesh)
    torch.cuda.synchronize()
    d_err = float((d_k - d_p).abs().max())
    d_scale = float(d_p.abs().max())
    check(d_err <= tol * d_scale,
          f"interpolation kernel N={snap.N} {name}: max|dgrad| {d_err} > "
          f"{tol}*{d_scale}")
    out["pppm_interpolate"] = dict(max_abs_err=d_err, scale=d_scale)

    if timed:
        for key, kern, plain in (
                ("dense_pair", lambda: pk.dense_pair_force(*pair_args),
                 lambda: pk.dense_pair_force_plain(*pair_args)),
                ("pppm_spread",
                 lambda: sk.spread_grid(pos, q, box, order, mesh),
                 lambda: sk.spread_grid_plain(pos, q, box, order, mesh)),
                ("pppm_interpolate",
                 lambda: sk.interpolate_grad(ct, pos, q, box, order, mesh),
                 lambda: sk.interpolate_grad_plain(ct, pos, q, box, order,
                                                   mesh))):
            out[key]["ms"] = device_ms(torch, kern)
            out[key]["plain_ms"] = device_ms(torch, plain)
            out[key]["host_call_ms"] = host_call_ms(torch, kern)
            out[key]["plain_host_call_ms"] = host_call_ms(torch, plain)
    for key, r in out.items():
        print(f"phase 2: N={snap.N} {name} {key}: " + ", ".join(
            f"{k}={v!r}" for k, v in r.items()), flush=True)
    return out


def main_path(torch, pt):
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import universe_energy
    from cavmd_tpu_torch.integrate.integrator import OBS_KEYS
    from cavmd_tpu_torch.ops import _cuda

    dev = torch.device("cuda")
    snap = reference_scene(pt, 250, 46.0, torch.float32, dev)
    ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    kT = PC.kT_from_kelvin(100.0)
    methods = (
        pt.MethodSpec(kind="bussi", group="molecular", kT=kT,
                      tau=PC.ps_to_atomic_units(5.0)),
        pt.MethodSpec(kind="langevin", group="cavity", kT=kT,
                      gamma=PC.gamma_from_tau_ps(5.0)),
    )
    # every count from here on is the main path's own: the Simulation's
    # initial force evaluation, the warm-up chunk and the measured window
    _cuda.reset_launches()
    sim = pt.Simulation(snap, ff, methods, dt=PC.fs_to_atomic_units(0.25),
                        seed=7, chunk_size=CHUNK)
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
    run_s = sum(chunk_s)
    launches = dict(_cuda.launches)
    n_steps = N_CHUNKS * CHUNK

    obs = {k: [v for c in chunks for v in c[k]] for k in OBS_KEYS}
    import numpy as np

    obs = {k: np.asarray(v) for k, v in obs.items()}
    for k in OBS_KEYS:
        check(np.all(np.isfinite(obs[k])), f"main path: non-finite {k}")
    for name in ("position", "velocity", "forces"):
        t = getattr(sim.state, name)
        check(tuple(t.shape) == (snap.N, 3) and bool(torch.isfinite(t).all()),
              f"main path: bad final {name}")
    check(int(obs["timestep"][-1]) == N_WARM + n_steps,
          f"main path: timestep {obs['timestep'][-1]}")
    for kname in ("dense_pair", "pppm_spread", "pppm_interpolate"):
        check(launches.get(kname, 0) >= N_WARM + n_steps,
              f"main path: kernel {kname} launched "
              f"{launches.get(kname, 0)} < {N_WARM + n_steps} times")
    U = universe_energy(obs)
    drift = float(np.abs(U - U[0]).max())
    check(drift < DRIFT_BOUND_HA,
          f"main path: universe drift {drift} >= {DRIFT_BOUND_HA} Ha")
    T_mol = 2.0 * obs["kinetic_molecular"] / (3.0 * (snap.N - 1) * kT) * 100.0
    chunk_rates = [CHUNK / s for s in chunk_s]
    res = dict(steps=n_steps, seconds=run_s,
               steps_per_s=statistics.median(chunk_rates),
               chunk_steps_per_s=chunk_rates, warmup_chunk_s=warm_s, universe_drift_ha=drift,
               universe_first_ha=float(U[0]),
               mean_T_molecular_K=float(T_mol.mean()), launches=launches)
    print("phase 3: " + ", ".join(f"{k}={v!r}" for k, v in res.items()),
          flush=True)
    return res


def f64_trajectory(torch, pt):
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.integrate import init_state, make_step_fn, run_steps

    out = {}
    for dev in ("cuda", "cpu"):
        snap = reference_scene(pt, 250, 46.0, torch.float64,
                               torch.device(dev))
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
        methods = pt.resolve_methods(
            snap, (pt.MethodSpec(kind="nve", group="all"),), ff.l_typeid)
        state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=0)
        final, _ = run_steps(make_step_fn(ff, methods), state, 20)
        out[dev] = final
    err = float((out["cuda"].position.cpu() - out["cpu"].position).abs().max())
    img_ok = bool(torch.equal(out["cuda"].image.cpu(), out["cpu"].image))
    print(f"phase 4: f64 NVE 20 steps, CUDA kernels vs CPU plain: "
          f"max|dx| = {err!r} bohr (bound {TRAJ_TOL_BOHR}), images equal: "
          f"{img_ok}", flush=True)
    check(err <= TRAJ_TOL_BOHR and img_ok,
          f"f64 trajectory: max|dx| {err} bohr > {TRAJ_TOL_BOHR}")
    return err


def main() -> None:
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

    # phase 1: build
    t0 = time.perf_counter()
    for src in ("pair", "pppm_spread"):
        _cuda.build(src)
    build_s = time.perf_counter() - t0
    fresh = sorted(_cuda.build_log)
    print(f"phase 1: kernels ready in {build_s:.2f} s (compiled now: "
          f"{fresh or 'none, found built in this checkout'})", flush=True)
    for src, log in _cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: ptxas {src}: {line.strip()}", flush=True)

    # phase 2: kernels against plain twins
    main_shape = None
    for n_mol, box in ((250, 46.0), (2000, reference_box_for(2000))):
        for dtype in (torch.float32, torch.float64):
            r = kernel_phase(torch, pt, n_mol, box, dtype,
                             timed=dtype == torch.float32)
            if n_mol == 250 and dtype == torch.float32:
                main_shape = r
        torch.cuda.empty_cache()

    # phase 3: main path
    main = main_path(torch, pt)

    # phase 4: f64 trajectory against the CPU
    f64_trajectory(torch, pt)

    print(f"summary: {kind} | {card} | N=501 f32 Bussi+Langevin "
          f"{main['steps_per_s']:.1f} steps/s (median of {N_CHUNKS} "
          f"{CHUNK}-step chunks), universe drift "
          f"{main['universe_drift_ha']:.3e} Ha over {main['steps']} steps",
          flush=True)
    sources = {
        "dense_pair": ("cavmd_tpu_torch/csrc/pair.cu",
                       "cavmd_tpu/ops/pallas_kernels.py:114"),
        "pppm_spread": ("cavmd_tpu_torch/csrc/pppm_spread.cu",
                        "cavmd_tpu/ops/pppm_pallas.py:272"),
        "pppm_interpolate": ("cavmd_tpu_torch/csrc/pppm_spread.cu",
                             "cavmd_tpu/ops/pppm_pallas.py:307"),
    }
    kernels = [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=main["launches"].get(k, 0),
             max_abs_err=main_shape[k]["max_abs_err"],
             ms=main_shape[k]["ms"], plain_ms=main_shape[k]["plain_ms"])
        for k, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
