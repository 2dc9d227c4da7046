#!/usr/bin/env python3
"""Device times of the cell kernel (K6/K8's counterpart) and the zcol
wrapper (K9 with its hull) of cavmd_tpu_torch on one GPU: the one-replica
launches, and where the checkout has them the launches over a replica
batch.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_replicas_cell.py [--root DIR] [--label
NAME] [--batches 8,32]``. ``--root`` imports ``cavmd_tpu_torch`` from
another checkout (for example an unpacked parent commit), so two versions
can be timed in turns in one run on one card; the timer is
``chip_smoke.py``'s ``device_ms`` of this checkout (calls queued behind a
spin kernel, CUDA events, median of 15).

One replica, f32, the reference-density O2/N2 lattice + photon of
``chip_smoke.py``, each list built once at the scene's positions: the cell
kernel at N = 100,001 (17^3 cells) and 20,001 (10^3), the small grid on
the N = 501 scene in cell mode (2^3 cells), the zcol wrapper at
N = 100,001 and 20,001. With a batch (``--batches``, where the checkout's
``ops/neighbor.py`` has ``replica_list``): each kernel at N = 20,001
(the small grid at N = 501) over B replicas jittered 0.3 bohr apart, one
launch, beside B times the one-replica time. One JSON line per
measurement; the last line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose cavmd_tpu_torch is imported")
    ap.add_argument("--label", default="change")
    ap.add_argument("--batches", default="8,32")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_replicas_cell.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import neighbor as tn
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    dev = torch.device("cuda")
    batches = [int(b) for b in args.batches.split(",") if b]
    batched = hasattr(tn, "replica_list")
    cases = [("cell_pair", 50_000, "cell"), ("cell_pair", 10_000, "cell"),
             ("cell_pair_small_grid", 250, "cell"),
             ("zcol_pair", 50_000, "zcol"), ("zcol_pair", 10_000, "zcol")]
    for kind, n_mol, mode in cases:
        box = 46.0 if n_mol == 250 else reference_box_for(n_mol)
        snap = cs.reference_scene(pt, n_mol, box, torch.float32, dev)
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode=mode)
        kern = zk.zcol_pair_force if mode == "zcol" \
            else ck.cell_pair_force_fused

        def call_args(pos):
            clist = ff.build_cells(pos, snap.box_L)
            out = (pos, snap.box_L, clist, ff.cell_cfg, snap.typeid,
                   snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                   ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
            return out + ((ff.zcol_W,) if mode == "zcol" else ())

        one = call_args(snap.position)
        one_ms = cs.device_ms(torch, lambda: kern(*one))
        print(json.dumps(dict(label=args.label, kernel=kind, n=snap.N,
                              replicas=1, ms=one_ms)), flush=True)
        if batched and n_mol != 50_000:
            for B in batches:
                P = cs.wrap_rows(torch, cs.jitter_rows(
                    torch, snap.position, B, 0.3, 5), snap.box_L)
                many = call_args(P)
                print(json.dumps(dict(
                    label=args.label, kernel=kind, n=snap.N, replicas=B,
                    ms=cs.device_ms(torch, lambda: kern(*many)),
                    one_replica_ms_times_b=B * one_ms)), flush=True)
                del many, P
        del ff, snap, one
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


if __name__ == "__main__":
    main()
