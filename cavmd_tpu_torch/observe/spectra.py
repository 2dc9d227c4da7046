"""Post-processing: autocorrelation functions -> vibrational spectra.

Port of ``cavmd_tpu/observe/spectra.py`` (the port's own copy; NumPy
only).

Completes the tracker workflow: ``DipoleAutocorrelation`` /
``AutocorrelationTracker`` write C(t) segment files during the run
(``observe/trackers.py``, format parity with the reference's
analysis.py:152-253); this module reads them back and turns them into
lineshapes — the IR-absorption / polariton-spectrum analysis the
cavity-MD literature applies to exactly these files. NumPy host-side
code by design: spectra are computed once per trajectory, not per step.

Conventions: within linear response the IR absorption lineshape is
``alpha(w) n(w) ~ w^2 * Re FT[<mu(0) mu(t)>_cl](w)`` with the harmonic
quantum correction folded into the w^2 prefactor (the convention used in
the CavMD polariton papers); all proportionality constants independent
of w are dropped, so outputs are relative intensities. Frequencies are
wavenumbers (cm^-1): ``nu = f / c`` with c = 0.0299792458 cm/ps.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

# speed of light in cm/ps: converts a frequency in 1/ps to a wavenumber
_C_CM_PER_PS = 0.0299792458

_WINDOWS = {
    "hann": np.hanning,
    "hamming": np.hamming,
    "blackman": np.blackman,
    "none": lambda n: np.ones(n),
}


def read_autocorr_file(path):
    """Parse one tracker segment file -> (timesteps, t_ps, C).

    Accepts the ``# timestep t(ps) C(t)`` format written by
    AutocorrelationTracker (and the reference's analysis.py trackers).
    """
    ts, tp, c = [], [], []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            a, b, cc = line.split()[:3]
            ts.append(int(a))
            tp.append(float(b))
            c.append(float(cc))
    return np.asarray(ts), np.asarray(tp), np.asarray(c)


def read_autocorr_segments(prefix, directory="."):
    """All ``{prefix}_{n}.txt`` reference segments, averaged onto a
    common UNIFORM lag grid -> (lag_ps, C_mean, n_segments).

    Each segment starts at its own reference time; lags are taken
    relative to each segment's first row and C(t) is averaged across
    segments — the standard multi-reference ACF estimator the tracker's
    file rotation exists to feed. Segments are linearly interpolated
    onto a shared uniform grid (spacing = the median row spacing,
    extent = the shortest segment) because the raw files are *not*
    quite uniform: the reference row is written at the reference
    timestep itself while later rows land on output-period boundaries
    (trackers.py:_write_header vs consume), and adaptive-dt runs drift
    further. The trailing (usually still-growing) segment is included
    only if it has at least two rows.
    """
    # numeric suffixes only: a {prefix}_spectrum.txt written by the
    # spectrum CLI into the same directory must not be read as a segment
    hits = [
        (p, re.search(r"_(\d+)\.txt$", p))
        for p in glob.glob(os.path.join(directory, f"{prefix}_*.txt"))
    ]
    paths = sorted((p for p, m in hits if m),
                   key=lambda p: int(re.search(r"_(\d+)\.txt$", p).group(1)))
    if not paths:
        raise FileNotFoundError(
            f"no autocorrelation segments match {prefix}_<n>.txt in "
            f"{directory!r}"
        )
    segs = []
    for p in paths:
        _, t_ps, c = read_autocorr_file(p)
        if len(t_ps) >= 2:
            segs.append((t_ps - t_ps[0], c))
    if not segs:
        raise ValueError(f"all segments under {prefix}_*.txt have <2 rows")
    dt = float(np.median(np.concatenate([np.diff(t) for t, _ in segs])))
    t_max = min(float(t[-1]) for t, _ in segs)
    lag = np.arange(int(np.floor(t_max / dt)) + 1) * dt
    c_mean = np.mean(
        [np.interp(lag, t, c) for t, c in segs], axis=0
    )
    return lag, c_mean, len(segs)


def read_fkt_references(prefix, directory="."):
    """All ``{prefix}_ref{n}.txt`` F(k,t) reference files, averaged onto
    a common uniform lag grid -> (lag_ps, F_mean, n_references).

    FieldAutocorrelationTracker rows already carry the lag relative to
    each file's own reference time (``timestep lag(ps) F``); references
    start mid-trajectory, so the common grid spans the overlapping lag
    range [max(first lags), min(last lags)] of all references with at
    least two rows.
    """
    hits = [
        (p, re.search(r"_ref(\d+)\.txt$", p))
        for p in glob.glob(os.path.join(directory, f"{prefix}_ref*.txt"))
    ]
    paths = sorted(
        (p for p, m in hits if m),
        key=lambda p: int(re.search(r"_ref(\d+)\.txt$", p).group(1)),
    )
    refs = []
    for p in paths:
        _, lag, f = read_autocorr_file(p)  # same 3-column row format
        if len(lag) >= 2:
            refs.append((lag, f))
    if not refs:
        raise FileNotFoundError(
            f"no F(k,t) reference files with >=2 rows match "
            f"{prefix}_ref*.txt in {directory!r}"
        )
    dt = float(np.median(np.concatenate([np.diff(t) for t, _ in refs])))
    lo = max(float(t[0]) for t, _ in refs)
    hi = min(float(t[-1]) for t, _ in refs)
    if hi <= lo:
        # no overlapping window (very short run): fall back to ref 0
        lag, f = refs[0]
        return lag, f, 1
    grid = lo + np.arange(int(np.floor((hi - lo) / dt)) + 1) * dt
    f_mean = np.mean([np.interp(grid, t, f) for t, f in refs], axis=0)
    return grid, f_mean, len(refs)


def spectrum_from_acf(lag_ps, c, window="hann", zero_pad=4):
    """One-sided cosine transform of an ACF -> (freq_cm1, intensity).

    ``I(w) = Re sum_t W(t) C(t) e^{-iwt} dt`` on the uniform lag grid;
    the window tapers the truncated tail (C(t) never fully decays in a
    finite run) and ``zero_pad`` interpolates the lineshape by padding
    to ``zero_pad * len(c)`` samples. Relative intensities only.
    """
    lag_ps = np.asarray(lag_ps, float)
    c = np.asarray(c, float)
    if len(lag_ps) != len(c):
        raise ValueError("lag and C length mismatch")
    if len(c) < 2:
        raise ValueError("need at least 2 ACF samples")
    dt = np.diff(lag_ps)
    if not np.allclose(dt, dt[0], rtol=1e-3):
        raise ValueError("ACF lag grid must be uniform (adaptive-dt runs "
                         "need resampling first)")
    dt = float(dt[0])
    try:
        w = _WINDOWS[window](len(c))
    except KeyError:
        raise ValueError(f"unknown window {window!r}; "
                         f"one of {sorted(_WINDOWS)}") from None
    n_pad = int(zero_pad) * len(c)
    spec = np.fft.rfft(c * w, n=n_pad).real * dt
    freq_cm1 = np.fft.rfftfreq(n_pad, d=dt) / _C_CM_PER_PS
    return freq_cm1, spec


def ir_absorption(lag_ps, c, window="hann", zero_pad=4):
    """IR absorption lineshape from a classical dipole ACF.

    ``A(w) ~ w^2 * I(w)`` (harmonic quantum correction folded in — the
    CavMD-literature convention); the w^2 prefactor also kills the w=0
    static-dipole artifact. Returns (freq_cm1, A) with A >= 0 clipped
    (window leakage can push the far wings slightly negative).
    """
    freq_cm1, spec = spectrum_from_acf(lag_ps, c, window, zero_pad)
    return freq_cm1, np.clip(freq_cm1**2 * spec, 0.0, None)


def spectrum_from_signal(x, dt_ps, window="hann"):
    """Amplitude spectrum |FT[x - <x>]| -> (freq_cm1, amplitude).

    The direct-signal route (e.g. the photon coordinate q(t) in
    examples/07_polariton_rabi_splitting.py): peaks mark the system's
    eigenfrequencies without forming an ACF first.
    """
    x = np.asarray(x, float)
    try:
        w = _WINDOWS[window](len(x))
    except KeyError:
        raise ValueError(f"unknown window {window!r}; "
                         f"one of {sorted(_WINDOWS)}") from None
    spec = np.abs(np.fft.rfft((x - x.mean()) * w))
    freq_cm1 = np.fft.rfftfreq(len(x), d=float(dt_ps)) / _C_CM_PER_PS
    return freq_cm1, spec


def peak_frequencies(freq_cm1, intensity, threshold=0.1, min_freq_cm1=0.0):
    """Local maxima above ``threshold * max`` -> ascending wavenumbers.

    ``min_freq_cm1`` cuts the Rayleigh wing (diffusive/rotational weight
    below the vibrational bands) from both the peak list and the max
    used for the threshold.
    """
    f = np.asarray(freq_cm1, float)
    s = np.asarray(intensity, float)
    band = s[1:-1].copy()
    band[f[1:-1] < min_freq_cm1] = 0.0
    if band.max() <= 0.0:
        return np.empty(0)
    keep = (band >= s[:-2]) & (band >= s[2:]) & (
        band >= threshold * band.max()
    )
    return f[1:-1][keep]
