#!/usr/bin/env python3
"""The JAX package's readings on the port examples' protocols, on the CPU:
what ``tests/test_torch_examples.py`` and ``chip_smoke.py`` phase 16
hold the port's examples (``examples/0*_torch.py``) to.

Run from the repository root: ``python scripts/jax_examples_reference.py
[--protocol tests|chip|all]`` (all by default). It calls the JAX library
the way the JAX examples do, at the sizes below; it does not import the
examples, which configure JAX when they are imported.

- ``ex01``, ``ex02``, ``ex03``, ``ex04``, ``ex06`` and ``ex07_runs`` are
  the examples' JAX runs, which the test calls itself: it holds 01 and 07
  (deterministic NVE) to them step for step, and 02, 03, 04 (float32,
  2 replicas in cell mode at r_cut 8 and PPPM 16^3 through
  ``run_replica_steps``, the unsharded reference of the port's 2 x 1 slab
  runner) and 06 step for step too, the port's run given JAX's thermal
  velocities and per-step draws. Each ``exNN(k, ...)`` returns the port
  example's figures (universe drift, mean and final molecular T, the
  reservoirs, kinetic energies), variant k with every seed of the example
  (its thermalization keys and its state seed) moved by 10 k;
- ``tests``: 08 (float64; the strongest wavenumber of the dipole
  absorption in each band window, and the bin) over VARIANTS variants;
  the test holds the port's 08 to the first, its own seeds;
- ``chip``: the cut protocols of phase 16, where the port draws its own
  noise: 06 at 0.5 ps on the reference scene (N = 501, float32; drift
  and mean T over three variants; a bound is 3x the largest reading) and
  07 at 100 periods (float64, deterministic; the photon spectrum's peaks
  at g = 0 and g = 1e-3, the bin, the splitting; at 50 periods the bin
  is 31.1 cm^-1 and the g = 1e-3 spectrum shows one peak, not two);
- ``anchor`` (not in ``all``; ~15-30 min): 06 at its full 50 ps at the
  example's seeds (``--variant k``: moved by 10 k), float32: drift,
  final and mean T, the mean T of each 10,000-step chunk and the two
  reservoirs.

Prints one JSON line per protocol.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from cavmd_tpu.core import PhysicalConstants as PC  # noqa: E402
from cavmd_tpu.core import (  # noqa: E402
    add_cavity_particle,
    make_diatomic_system,
)
from cavmd_tpu.core.snapshot import Snapshot  # noqa: E402
from cavmd_tpu.integrate import (  # noqa: E402
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    master_key,
    potential_energy,
    resolve_methods,
    run_steps,
    thermalize_velocities,
    universe_energy,
)
from cavmd_tpu.observe import (  # noqa: E402
    DipoleAutocorrelation,
    ir_absorption,
    make_extra_obs,
    read_autocorr_segments,
    spectrum_from_signal,
)
from cavmd_tpu.parallel import (  # noqa: E402
    init_replica_states,
    run_replica_steps,
)
from cavmd_tpu.utils import fire_minimize  # noqa: E402

VARIANTS = 5
# 08's protocol in tests/test_torch_examples.py (keyword arguments of the
# port example's main; the test passes the others' protocols itself)
TESTS = {"08": dict(n_chunks=4, chunk=250, reference_every=250)}
# phase 16's cut protocols
CHIP = {"06": dict(runtime_ps=0.5), "07": dict(n_periods=100)}
BAND_WINDOWS_CM1 = {"O-O": (1200.0, 1900.0), "N-N": (1900.0, 2700.0)}


def baths(snap, ff, tau_ps=5.0):
    kT = PC.kT_from_kelvin(100.0)
    return resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(tau_ps)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(tau_ps)),
    ), ff.l_typeid)


def thermalized(snap, ff, k1, k2):
    kT = PC.kT_from_kelvin(100.0)
    mol = snap.typeid != ff.l_typeid
    v = thermalize_velocities(master_key(k1), snap.mass, mol, kT)
    v = v + thermalize_velocities(master_key(k2), snap.mass, ~mol, kT,
                                  remove_drift=False)
    return snap.replace(velocity=v), int(mol.sum())


def readings(obs, n_mol_atoms, t_window=None):
    """(universe drift, mean molecular T over the last t_window steps, or
    all of them), a value per replica for (steps, B) observables."""
    U = np.asarray(universe_energy(obs), np.float64)
    ke = np.asarray(obs["kinetic_molecular"], np.float64)
    ke = ke[-t_window:] if t_window else ke
    T = 2 * ke.mean(axis=0) / (3 * n_mol_atoms * PC.KB_HARTREE_PER_K)
    return np.abs(U - U[0]).max(axis=0).tolist(), np.asarray(T).tolist()


def reservoirs(state):
    """The Bussi (molecules) and Langevin (photon) reservoirs of the final
    state (Ha), a value per replica for a batch."""
    return dict(
        bussi_reservoir_ha=np.asarray(state.bussi_reservoir[..., 0],
                                      np.float64).tolist(),
        langevin_reservoir_ha=np.asarray(state.langevin_reservoir[..., 1],
                                         np.float64).tolist())


def ex02(k, n_molecules, box_L, n_steps, fire_steps, t_window):
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)
    snap, n_mol = thermalized(snap, ff, 2 + 10 * k, 3 + 10 * k)
    step = jax.jit(make_step_fn(ff, baths(snap, ff)))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25),
                       seed=4 + 10 * k)
    final, obs = run_steps(step, state, n_steps)
    drift, mean_T = readings(obs, n_mol, t_window)
    return dict(time_ps=float(final.time_au) * PC.TIME_PS_CONVERSION,
                drift_ha=drift, mean_T_K=mean_T, **reservoirs(final))


def ex03(k, n_replicas, n_molecules, box_L, n_steps, fire_steps, t_window):
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    snap = snap.astype(jnp.float32)
    ff = ForceField.create(snap, coupling=1e-3, dtype=jnp.float32)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)
    step = make_step_fn(ff, baths(snap, ff))
    batched = init_replica_states(
        snap, ff, n_replicas=n_replicas, dt=PC.fs_to_atomic_units(0.25),
        seed=100 + 10 * k, kT=PC.kT_from_kelvin(100.0))
    final, obs = jax.jit(
        lambda s: run_replica_steps(step, s, n_steps))(batched)
    drift, mean_T = readings(obs, snap.N - 1, t_window)
    return dict(mean_T_K=mean_T, drift_ha=drift,
                cavity_ke_ha=np.asarray(obs["kinetic_cavity"][-1],
                                        np.float64).tolist(),
                **reservoirs(final))


def ex04(k, n_molecules, box_L, r_cut, n_steps):
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    snap = snap.astype(jnp.float32)
    ff = ForceField.create(snap, coupling=1e-3, r_cut=r_cut,
                           pair_mode="cell", pppm_mesh=(16, 16, 16),
                           dtype=jnp.float32)
    step = make_step_fn(ff, baths(snap, ff))
    batched = init_replica_states(
        snap, ff, n_replicas=2, dt=PC.fs_to_atomic_units(0.25),
        seed=10 * k, kT=PC.kT_from_kelvin(100.0))
    final, obs = jax.jit(
        lambda s: run_replica_steps(step, s, n_steps))(batched)
    if np.asarray(obs["cell_overflow"]).any():
        raise RuntimeError("04: a cell list overflowed")
    drift, mean_T = readings(obs, snap.N - 1)
    return dict(final_ke_ha=np.asarray(obs["kinetic_molecular"][-1],
                                       np.float64).tolist(),
                mean_T_K=mean_T, drift_ha=drift, **reservoirs(final))


def ex06(k, runtime_ps, n_molecules=250, box_L=46.0, fire_steps=300,
         chunk=10_000):
    snap = make_diatomic_system(n_molecules, box_L=box_L, seed=0,
                                dtype=np.float64)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    snap = snap.astype(jnp.float32)
    ff = ForceField.create(snap, coupling=1e-3, dtype=jnp.float32)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)
    snap, n_mol = thermalized(snap, ff, 5 + 10 * k, 6 + 10 * k)
    step = make_step_fn(ff, baths(snap, ff))
    runner = jax.jit(lambda s, n: run_steps(step, s, n),
                     static_argnums=(1,))
    dt = PC.fs_to_atomic_units(0.25)
    n_steps = int(PC.ps_to_atomic_units(runtime_ps) / dt)
    state = init_state(snap, ff, dt=dt, seed=11 + 10 * k)
    outs, done = [], 0
    while done < n_steps:
        n = min(chunk, n_steps - done)
        state, obs = runner(state, n)
        outs.append(obs)
        done += n
    obs = {key: np.concatenate([np.asarray(o[key]) for o in outs])
           for key in outs[0]}
    T = (2 * np.asarray(obs["kinetic_molecular"], np.float64)
         / (3 * n_mol * PC.KB_HARTREE_PER_K))
    drift, mean_T = readings(obs, n_mol)
    bounds = np.cumsum([len(o["kinetic_molecular"]) for o in outs])[:-1]
    return dict(steps=n_steps, drift_ha=drift, mean_T_K=mean_T,
                final_T_K=float(T[-1]),
                chunk_mean_T_K=[float(c.mean())
                                for c in np.split(T, bounds)],
                **reservoirs(state))


def ex01(n_molecules, box_L, n_steps, fire_steps):
    """Example 01's total energy a step (deterministic NVE, float64):
    tests/test_torch_examples.py holds the port's to it."""
    snap = make_diatomic_system(n_molecules, box_L=box_L,
                                temperature_K=100.0, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    snap = fire_minimize(snap, ff, n_steps=fire_steps)
    step = jax.jit(make_step_fn(ff, resolve_methods(
        snap, (MethodSpec(kind="nve", group="all"),), ff.l_typeid)))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=2)
    _, obs = run_steps(step, state, n_steps)
    return np.asarray(potential_energy(obs) + obs["kinetic_molecular"]
                      + obs["kinetic_cavity"])


def ex07_runs(n_periods):
    """Example 07's two runs (deterministic NVE, float64): for g = 0 and
    g = 1e-3, the photon's x a step (``qx``), the spectrum's ``peaks`` and
    its ``bin_cm1``; and the bare frequency (cm^-1)."""
    m_o = 15.999 * 1822.888486
    k_bond, r0, q_c = 2 * 0.36602, 2.281655158, 0.35
    mu = m_o / 2
    omega = np.sqrt(k_bond / mu)
    freq_cm1 = omega * PC.HARTREE_TO_CM_MINUS1
    runs = {}
    for g in (0.0, 1e-3):
        snap = Snapshot.create(
            position=np.array([[-r0 / 2, 0, 0], [r0 / 2, 0, 0]]),
            box_L=[60.0, 60.0, 60.0], mass=[m_o, m_o],
            charge=[q_c, -q_c], typeid=[0, 0], types=("O", "N"),
            bond_group=[[0, 1]], bond_typeid=[0], bond_types=("O-O",))
        snap = add_cavity_particle(snap, coupling=0.0, freq_cm1=freq_cm1,
                                   temperature_K=10.0, seed=1)
        p = np.array(snap.position)
        d_static = q_c * p[0, 0] - q_c * p[1, 0]
        p[-1] = [-g * d_static / omega**2 + 0.02, 0.0, 0.0]
        p[1, 0] += 0.005
        snap = snap.replace(position=jnp.asarray(p))
        ff = ForceField.create(snap, coupling=g, freq_cm1=freq_cm1,
                               enable_coulomb=False, enable_lj=False)
        step = jax.jit(make_step_fn(ff, resolve_methods(
            snap, (MethodSpec(kind="nve", group="all"),), ff.l_typeid)))
        dt = (2 * np.pi / omega) / 80

        def step_q(st):
            ns, obs = step(st)
            obs["qx"] = ns.position[-1, 0]
            return ns, obs

        _, obs = run_steps(step_q, init_state(snap, ff, dt=dt, seed=0),
                           80 * n_periods)
        freqs, spec = spectrum_from_signal(
            np.asarray(obs["qx"]), float(dt) * PC.TIME_PS_CONVERSION)
        mask = spec > 0.1 * spec.max()
        peaks, i = [], 0
        while i < len(mask):
            if mask[i]:
                j = i
                while j < len(mask) and mask[j]:
                    j += 1
                peaks.append(float(freqs[i:j][np.argmax(spec[i:j])]))
                i = j
            else:
                i += 1
        runs[g] = dict(qx=np.asarray(obs["qx"]), peaks=peaks,
                       bin_cm1=float(freqs[1] - freqs[0]))
    return runs, float(freq_cm1)


def ex07(n_periods):
    """Example 07's figures: the peaks at g = 0 and g = 1e-3, the bin,
    the splitting and the bare frequency."""
    runs, bare = ex07_runs(n_periods)
    p = runs[1e-3]["peaks"]
    return dict(peaks_g0=runs[0.0]["peaks"], peaks=p,
                bin_cm1=runs[1e-3]["bin_cm1"],
                splitting_cm1=p[1] - p[0] if len(p) == 2 else None,
                bare_cm1=bare)


def ex08(k, n_chunks, chunk, reference_every):
    snap = make_diatomic_system(40, box_L=30.0, temperature_K=100.0, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    step = jax.jit(make_step_fn(ff, baths(snap, ff, tau_ps=1.0),
                                extra_obs=make_extra_obs(dipole=True)))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.5),
                       seed=2 + 10 * k)
    with tempfile.TemporaryDirectory(prefix="ir_spectrum_") as workdir:
        tracker = DipoleAutocorrelation(
            output_prefix=os.path.join(workdir, "dipole_autocorr"),
            output_period_steps=10)
        tracker.new_reference_every = reference_every
        for _ in range(n_chunks):
            state, obs = run_steps(step, state, chunk)
            tracker.consume({key: np.asarray(v) for key, v in obs.items()})
        lag, c_mean, _ = read_autocorr_segments("dipole_autocorr",
                                                directory=workdir)
    freq, absorb = ir_absorption(lag, c_mean)
    bands = {}
    for name, (lo, hi) in BAND_WINDOWS_CM1.items():
        inside = (freq >= lo) & (freq < hi)
        bands[name] = float(freq[inside][np.argmax(absorb[inside])])
    return bands, float(freq[1] - freq[0])


def over_variants(name, fn, kwargs, variants=VARIANTS):
    t0 = time.perf_counter()
    runs = [fn(k, **kwargs) for k in range(variants)]
    drift = [d for run in runs for d in np.atleast_1d(run["drift_ha"])]
    temps = [t for run in runs for t in np.atleast_1d(run["mean_T_K"])]
    return dict(example=name, protocol=kwargs, variants=variants,
                max_drift_ha=max(drift),
                max_T_deviation_K=max(abs(t - 100.0) for t in temps),
                drift_ha=drift, mean_T_K=temps,
                seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--protocol", choices=("tests", "chip", "anchor",
                                           "all"), default="all")
    ap.add_argument("--variant", type=int, default=0,
                    help="the anchor's seed variant (0: the example's)")
    args = ap.parse_args()
    if args.protocol in ("tests", "all"):
        t0 = time.perf_counter()
        runs = [ex08(k, **TESTS["08"]) for k in range(VARIANTS)]
        print(json.dumps(dict(
            example="08", protocol=TESTS["08"], variants=VARIANTS,
            bands=[b for b, _ in runs], bin_cm1=runs[0][1],
            seconds=time.perf_counter() - t0)), flush=True)
    if args.protocol in ("chip", "all"):
        print(json.dumps(over_variants("06 chip", ex06, CHIP["06"],
                                       variants=3)), flush=True)
        t0 = time.perf_counter()
        print(json.dumps(dict(example="07 chip", protocol=CHIP["07"],
                              **ex07(**CHIP["07"]),
                              seconds=time.perf_counter() - t0)),
              flush=True)
    if args.protocol == "anchor":
        t0 = time.perf_counter()
        print(json.dumps(dict(example="06 anchor", runtime_ps=50.0,
                              variant=args.variant,
                              **ex06(args.variant, 50.0),
                              seconds=time.perf_counter() - t0)),
              flush=True)


if __name__ == "__main__":
    main()
