#!/usr/bin/env python3
"""The JAX package's reading on the custom-force protocol of
``chip_smoke.py`` phase 17a, on the CPU: the bound that phase holds the
port to.

Run from the repository root: ``python scripts/jax_custom_force_reference.py``
(``--precision f32`` or ``f64``, both by default). The scene is phase 3's
N = 501 reference scene (250 O2/N2 + photon, 46-bohr box, seed 0, photon
seed 1, no thermalisation, the default ForceField) with one custom force:
a harmonic trap of stiffness TRAP_K on the unwrapped positions of the
molecules (the photon left out), ``U = 1/2 k sum |r + image L|^2``. Bussi
(100 K, tau 5 ps) on the molecules, Langevin (tau 5 ps, 100 K) on the
photon, dt 0.25 fs, state seed 7; 250 warm-up steps, then 2 x 500 steps
(phase 3's SHORT_RUN prefix). The reading is max |U - U[0]| of the
universe energy U over the 1000 steps; JAX's ``universe_energy`` counts
the trap's energy (``custom_0``). Prints one JSON line per precision.
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
    resolve_methods,
    run_steps,
    universe_energy,
)

TRAP_K = 1e-5  # Ha / bohr^2, chip_smoke.py's TRAP_K
WARM, CHUNKS, CHUNK = 250, 2, 500


def make_trap(l_typeid):
    def trap(position, image, box_L, charge, typeid):
        w = jnp.where(typeid != l_typeid, TRAP_K, 0.0).astype(
            position.dtype)[:, None]
        r = position + image * box_L
        return -w * r, 0.5 * jnp.sum(w * r * r)

    return trap


def run(dtype):
    snap = make_diatomic_system(250, box_L=46.0, temperature_K=100.0, seed=0)
    snap = add_cavity_particle(snap, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=1)
    snap = snap.astype(dtype)
    l_typeid = snap.types.index("L")
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                           custom_forces=(make_trap(l_typeid),))
    kT = PC.kT_from_kelvin(100.0)
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    step = make_step_fn(ff, methods)
    warm = jax.jit(lambda s: run_steps(step, s, WARM))
    chunk = jax.jit(lambda s: run_steps(step, s, CHUNK))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.25), seed=7)
    t0 = time.perf_counter()
    state, _ = warm(state)
    outs = []
    for _ in range(CHUNKS):
        state, obs = chunk(state)
        outs.append({k: np.asarray(v, np.float64) for k, v in obs.items()})
    obs = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    U = np.asarray(universe_energy(obs))
    return dict(precision="f32" if dtype == jnp.float32 else "f64",
                steps=CHUNKS * CHUNK, warmup_steps=WARM, trap_k=TRAP_K,
                universe_drift_ha=float(np.abs(U - U[0]).max()),
                custom_0_first_ha=float(obs["custom_0"][0]),
                custom_0_range_ha=float(np.ptp(obs["custom_0"])),
                seconds=time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", choices=("f32", "f64", "both"),
                    default="both")
    args = ap.parse_args(argv)
    kinds = {"f32": (jnp.float32,), "f64": (jnp.float64,),
             "both": (jnp.float32, jnp.float64)}[args.precision]
    for dtype in kinds:
        print(json.dumps(run(dtype)), flush=True)


if __name__ == "__main__":
    main()
