#!/usr/bin/env python3
"""IR spectrum end to end on the PyTorch/CUDA port: trajectory -> dipole
ACF tracker files -> absorption lineshape.

The production analysis loop for vibrational strong coupling studies:
run a thermostatted diatomic gas (float64; on the GPU the pair pass and
the PPPM mesh in the port's CUDA kernels), stream the total dipole with
the on-device observable hook, let DipoleAutocorrelation write its
segment files (reference format, analysis.py:152-253) into ``workdir``,
then post-process them with observe.spectra into an IR absorption
spectrum whose bands sit at the bonds' harmonic frequencies.

    python examples/08_ir_spectrum_torch.py [--device CPU] [--workdir DIR]
"""

import argparse
import os
import tempfile

import numpy as np

from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.core.device import resolve_device
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.observe import (
    DipoleAutocorrelation,
    ir_absorption,
    make_extra_obs,
    peak_frequencies,
    read_autocorr_segments,
)

# the two band regions of the O-O / N-N mixture (core/system.py
# BOND_PARAMS): harmonic wavenumbers sqrt(k/mu) ~1555 cm^-1 (O-O,
# k = 0.73204, mu = 14583 m_e) and ~2325 cm^-1 (N-N, k = 1.4325,
# mu = 12766 m_e); the thermal and LJ environment shifts the centres
# slightly, and a few-ps window leaves finite-sampling ripple in each
BAND_WINDOWS_CM1 = {"O-O": (1200.0, 1900.0), "N-N": (1900.0, 2700.0)}


def main(n_molecules=40, box_L=30.0, n_chunks=4, chunk=2000,
         reference_every=2000, workdir=None, device=None):
    """Run the example; the tracker's files go to ``workdir`` (a fresh
    temporary directory when None). Returns its figures: ``peaks`` (the
    absorption maxima above 20% of the largest, cm^-1), ``bands`` (the
    strongest wavenumber in each of ``BAND_WINDOWS_CM1``), ``bin_cm1``
    (the spectrum's resolution), ``n_segments``, ``n_lags``,
    ``lag_dt_ps`` and ``workdir``."""
    dev = resolve_device(device)
    kT = PC.kT_from_kelvin(100.0)
    snap = make_diatomic_system(n_molecules, box_L=box_L,
                                temperature_K=100.0, seed=0, device=dev)
    snap = add_cavity_particle(
        snap, coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1
    )
    ff = ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
    methods = resolve_methods(snap, (
        MethodSpec(kind="bussi", group="molecular", kT=kT,
                   tau=PC.ps_to_atomic_units(1.0)),
        MethodSpec(kind="langevin", group="cavity", kT=kT,
                   gamma=PC.gamma_from_tau_ps(1.0)),
    ), ff.l_typeid)
    step = make_step_fn(ff, methods, extra_obs=make_extra_obs(dipole=True))
    state = init_state(snap, ff, dt=PC.fs_to_atomic_units(0.5), seed=2)

    workdir = workdir or tempfile.mkdtemp(prefix="ir_spectrum_")
    os.makedirs(workdir, exist_ok=True)
    tracker = DipoleAutocorrelation(
        output_prefix=os.path.join(workdir, "dipole_autocorr"),
        output_period_steps=10)
    tracker.new_reference_every = reference_every
    for _ in range(n_chunks):
        state, obs = run_steps(step, state, chunk)
        tracker.consume(obs)
    lag, c_mean, n_seg = read_autocorr_segments("dipole_autocorr",
                                                directory=workdir)

    freq, absorb = ir_absorption(lag, c_mean)
    peaks = peak_frequencies(freq, absorb, threshold=0.2)
    bands = {}
    for name, (lo, hi) in BAND_WINDOWS_CM1.items():
        inside = (freq >= lo) & (freq < hi)
        bands[name] = float(freq[inside][np.argmax(absorb[inside])])
    out = dict(peaks=[float(p) for p in peaks], bands=bands,
               bin_cm1=float(freq[1] - freq[0]), n_segments=n_seg,
               n_lags=len(lag), lag_dt_ps=float(lag[1] - lag[0]),
               workdir=workdir)
    print(f"{n_seg} ACF segments, {len(lag)} lags "
          f"(dt {out['lag_dt_ps']:.4f} ps) on {dev}; files in {workdir}")
    print(f"IR band(s) above 20% of max: "
          f"{[round(p, 1) for p in out['peaks']]} cm^-1; strongest in each "
          f"region {bands} (bin {out['bin_cm1']:.1f} cm^-1)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("GPU", "CPU"), default="GPU")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()
    main(workdir=args.workdir,
         device="cpu" if args.device == "CPU" else None)
