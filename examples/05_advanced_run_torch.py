#!/usr/bin/env python3
"""The canonical experiment driver on the PyTorch/CUDA port: the CLI of
the reference's ``examples/05_advanced_run.py``, a thin wrapper over
``cavmd_tpu_torch.drivers.advanced_run`` (see that module for the
workflow and its flags). It runs on the GPU unless given
``--device CPU``.

    python examples/05_advanced_run_torch.py --runtime 0.08 \\
        --enable-energy-tracker --enable-fkt
"""

import sys

from cavmd_tpu_torch.drivers.advanced_run import main as advanced_run


def main(argv=None, device=None):
    """Run the driver on ``argv`` (the command line when None), with
    ``--device CPU`` added for ``device="cpu"``; returns its figures: the
    exit code ``rc`` (0 when every replica succeeded)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if device is not None and str(device) == "cpu":
        argv += ["--device", "CPU"]
    return dict(rc=advanced_run(argv))


if __name__ == "__main__":
    sys.exit(main()["rc"])
