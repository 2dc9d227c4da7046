#!/usr/bin/env python3
"""The JAX package's readings on the bath protocols of ``chip_smoke.py``
phase 13, and on the prefix of phase 3's protocol that phases 3 and 11
run (``SHORT_RUN``), on the CPU: the bounds those phases hold the port to.

Run from the repository root: ``python scripts/jax_bath_reference.py``
(``--precision f32`` or ``f64``, both by default; ``--protocol baths``,
``short`` or ``all``, the default). The scene is phase 3's
N = 501 reference scene (250 O2/N2 + photon, 46-bohr box, seed 0, photon
seed 1, no thermalisation, the default ForceField), dt 0.25 fs, state seed
7, Langevin (tau 5 ps, 100 K) on the photon:

- MTTK (100 K, tau 0.5 ps, the tau of tests/test_integrate.py's MTTK
  test) on the molecules: ``MTTK_WARM`` warm-up chunks of 1000 steps,
  then ``MTTK_CHUNKS`` x 1000 steps; the reading is max |E - E[0]| of the
  extended energy E (the universe energy plus the molecular MTTK energy)
  over the measured steps, and over the first 1000 of them (phase 13a's
  window: the first chunk, with no warm-up);
- Berendsen (100 K, tau 0.5 ps): ``BERENDSEN_CHUNKS`` x 1000 steps; the
  reading is the mean molecular temperature of the last chunk and its
  distance from 100 K (phase 13b's window: one chunk);
- the short run: Bussi (100 K, tau 5 ps) on the molecules, 250 warm-up
  steps, then 2 x 500 steps; the reading is max |U - U[0]| of the
  universe energy U over the 1000 steps, for the scene's state (phase 3's
  unfused run) and for each replica of a batch of 32
  (``init_replica_states``, seed 7, thermalized at 100 K; phase 11's
  batches of 1, 8 and 32 are its first rows) through
  ``run_replica_steps``.

Prints one JSON line per precision.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
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
from cavmd_tpu.integrate import (  # noqa: E402
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    mttk_energy,
    resolve_methods,
    run_steps,
    universe_energy,
)
from cavmd_tpu.integrate.thermostats import MTTKState  # noqa: E402
from cavmd_tpu.parallel import (  # noqa: E402
    init_replica_states,
    run_replica_steps,
)

CHUNK = 1000
TAU_BATH_PS = 0.5
# phase 13a's and 13b's windows (a warm-up chunk and three chunks of MTTK,
# two of Berendsen, before they were cut)
MTTK_WARM, MTTK_CHUNKS, BERENDSEN_CHUNKS = 0, 1, 1
SHORT_WARM, SHORT_CHUNKS, SHORT_CHUNK = 250, 2, 500
SHORT_REPLICAS = 32


def scene(dtype):
    snap = make_diatomic_system(250, box_L=46.0, temperature_K=100.0, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    snap = snap.astype(dtype)
    return snap, ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)


def run(bath, dtype, warm, chunks):
    snap, ff = scene(dtype)
    kT = PC.kT_from_kelvin(100.0)
    tau = PC.ps_to_atomic_units(TAU_BATH_PS)
    methods = resolve_methods(snap, (
        MethodSpec(kind=bath, group="molecular", kT=kT, tau=tau),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    step = make_step_fn(ff, methods, extra_obs=lambda s: {
        "mttk_xi": s.mttk.xi[0], "mttk_eta": s.mttk.eta[0]})
    chunk = jax.jit(lambda s: run_steps(step, s, CHUNK))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=7)
    t0 = time.perf_counter()
    for _ in range(warm):
        state, _ = chunk(state)
    outs = []
    for _ in range(chunks):
        state, obs = chunk(state)
        outs.append({k: np.asarray(v, np.float64) for k, v in obs.items()})
    obs = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    dof = methods[0].dof
    res = dict(bath=bath, steps=chunks * CHUNK, warmup_steps=warm * CHUNK,
               seconds=time.perf_counter() - t0)
    if bath == "mttk":
        ext = np.asarray(universe_energy(obs)) + np.asarray(mttk_energy(
            MTTKState(jnp.asarray(obs["mttk_xi"]),
                      jnp.asarray(obs["mttk_eta"])), dof, kT, tau))
        res["extended_drift_ha"] = float(np.abs(ext - ext[0]).max())
        res["extended_drift_ha_first_chunk"] = float(
            np.abs(ext[:CHUNK] - ext[0]).max())
        res["final_xi"] = float(obs["mttk_xi"][-1])
    T = 2.0 * obs["kinetic_molecular"] / (dof * PC.KB_HARTREE_PER_K)
    last = T[-CHUNK:].mean()
    res["mean_T_last_chunk_K"] = float(last)
    res["T_deviation_K"] = float(abs(last - 100.0))
    return res


def short_run(dtype, replicas):
    """The short run's universe drift: of the scene's state when
    ``replicas`` is None, else of each replica of the thermalized batch."""
    snap, ff = scene(dtype)
    kT = PC.kT_from_kelvin(100.0)
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    step = make_step_fn(ff, methods)
    dt = PC.fs_to_atomic_units(0.25)
    if replicas is None:
        state = init_state(snap, ff, dt=dt, seed=7)
        steps = run_steps
    else:
        state = init_replica_states(snap, ff, n_replicas=replicas, dt=dt,
                                    seed=7, kT=kT)
        steps = run_replica_steps
    warm = jax.jit(lambda s: steps(step, s, SHORT_WARM))
    chunk = jax.jit(lambda s: steps(step, s, SHORT_CHUNK))
    t0 = time.perf_counter()
    state, _ = warm(state)
    outs = []
    for _ in range(SHORT_CHUNKS):
        state, obs = chunk(state)
        outs.append({k: np.asarray(v, np.float64) for k, v in obs.items()})
    obs = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    U = np.asarray(universe_energy(obs))
    drift = np.abs(U - U[0]).max(axis=0)
    return dict(replicas=replicas, warmup_steps=SHORT_WARM,
                steps=SHORT_CHUNKS * SHORT_CHUNK,
                seconds=time.perf_counter() - t0,
                universe_drift_ha=drift.tolist())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--precision", choices=("f32", "f64", "both"),
                    default="both")
    ap.add_argument("--protocol", choices=("baths", "short", "all"),
                    default="all")
    args = ap.parse_args()
    precs = ("f32", "f64") if args.precision == "both" else (args.precision,)
    for p in precs:
        dtype = jnp.float32 if p == "f32" else jnp.float64
        out = dict(precision=p)
        if args.protocol in ("baths", "all"):
            out.update(mttk=run("mttk", dtype, MTTK_WARM, MTTK_CHUNKS),
                       berendsen=run("berendsen", dtype, 0,
                                     BERENDSEN_CHUNKS))
        if args.protocol in ("short", "all"):
            out.update(short_run=short_run(dtype, None),
                       short_run_batch=short_run(dtype, SHORT_REPLICAS))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
