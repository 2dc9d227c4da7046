"""Spectrum CLI: tracker autocorrelation files -> lineshape file.

Port of ``cavmd_tpu/drivers/spectrum.py`` (host-side NumPy).

``python -m cavmd_tpu_torch.drivers.spectrum dipole_autocorr --kind ir`` reads
the ``{prefix}_{n}.txt`` C(t) segments written by a run (or, with
``--fkt``, the ``{prefix}_ref{n}.txt`` F(k,t) references), averages
them, and writes ``{prefix}_spectrum.txt`` with ``freq(cm^-1)
intensity`` rows — the post-processing the cavity-MD literature applies
to these files, as a shell step instead of a notebook.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from cavmd_tpu_torch.observe.spectra import (
    ir_absorption,
    peak_frequencies,
    read_autocorr_segments,
    read_fkt_references,
    spectrum_from_acf,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="autocorrelation tracker files -> spectrum file")
    ap.add_argument("prefix",
                    help="tracker file prefix (e.g. dipole_autocorr or "
                         "prod-1_dipole_autocorr)")
    ap.add_argument("--dir", default=".", help="directory of the files")
    ap.add_argument("--out", default=None,
                    help="output path (default {prefix}_spectrum.txt)")
    ap.add_argument("--kind", choices=("acf", "ir"), default="ir",
                    help="plain cosine transform or w^2-weighted IR "
                         "absorption (default)")
    ap.add_argument("--fkt", action="store_true",
                    help="read F(k,t) _ref{n}.txt files instead of C(t) "
                         "segments")
    ap.add_argument("--window", default="hann",
                    choices=("hann", "hamming", "blackman", "none"))
    ap.add_argument("--zero-pad", type=int, default=4)
    ap.add_argument("--peak-threshold", type=float, default=0.2,
                    help="report peaks above this fraction of the max")
    ap.add_argument("--min-freq", type=float, default=200.0,
                    help="ignore peaks below this wavenumber (cm^-1): "
                         "cuts the diffusive Rayleigh wing (0 = keep all)")
    args = ap.parse_args(argv)

    if args.fkt:
        lag, c, n_seg = read_fkt_references(args.prefix, args.dir)
    else:
        lag, c, n_seg = read_autocorr_segments(args.prefix, args.dir)
    transform = ir_absorption if args.kind == "ir" else spectrum_from_acf
    freq, inten = transform(lag, c, window=args.window,
                            zero_pad=args.zero_pad)

    out = args.out or os.path.join(args.dir, f"{args.prefix}_spectrum.txt")
    with open(out, "w") as f:
        f.write(f"# {'IR absorption' if args.kind == 'ir' else 'ACF'} "
                f"spectrum of {args.prefix} ({n_seg} segments, "
                f"{len(lag)} lags, window={args.window})\n")
        f.write("# freq(cm^-1) intensity\n")
        np.savetxt(f, np.column_stack([freq, inten]), fmt="%.6f %.8e")

    peaks = peak_frequencies(freq, inten, threshold=args.peak_threshold,
                             min_freq_cm1=args.min_freq)
    print(f"{out}: {len(freq)} bins from {n_seg} segment(s); peaks "
          f">{args.peak_threshold:.0%} of max: "
          f"{[round(float(p), 1) for p in peaks]} cm^-1")
    return out


if __name__ == "__main__":
    main()
