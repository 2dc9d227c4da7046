#!/usr/bin/env python3
"""Device times of the z-sorted column pair pass (kernel 9 with its hull)
of cavmd_tpu_torch on one GPU, per scene.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_zcol.py [--root DIR] [--label NAME]
[--rows S]``.
``--root`` imports ``cavmd_tpu_torch`` from another checkout (for example
an unpacked parent commit), so two versions can be timed in turns in one
run on one card; the timers are ``chip_smoke.py``'s of this checkout
(``device_ms``: calls queued behind a spin kernel, CUDA events, median of
15; ``profiled_device_ms``: the summed device time of the named kernels in
a ``torch.profiler`` trace).

Scenes: the reference-density O2/N2 lattice + photon of ``chip_smoke.py``
at N = 20,001 and 100,001 (``build_large_n(50_000, pair_mode='zcol')``'s
scene), f32, in zcol mode with the ForceField's planned window; each at the
positions the column list was built from and after a drift of up to 0.49
skin (seeded, re-wrapped) with the list kept. Each line: the wrapper's
device ms a call (``zcol_pair_force``, one call a sample: a wrapper that
issues tens of launches fills the launch queue at ten), its device
operations a call, the pair kernel's and the hull kernel's own device
ms in the wrapper's trace, the hull launch alone (the wrapper's hull
kernel where the checkout has it, else the plain ``zcol_local_positions``
+ ``zcol_hull`` the older wrapper ran), the largest error against the
plain twin and the twin's
scale, and whether two calls gave the same bits. With ``--rows S``
(S > 1, a checkout whose wrapper takes a row range: atom sharding by
rows) each line also gives the wrapper's device ms with the first of S
row blocks (``rows_ms``) and its pair kernel's own time in its trace
(``rows_kernel_ms``). One JSON line per measurement; the last line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import inspect
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
    ap.add_argument("--rows", type=int, default=1,
                    help="also time the first of this many row blocks")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_zcol.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import zcol_kernels as zk

    dev = torch.device("cuda")
    for n_mol in (10_000, 50_000):
        snap = cs.reference_scene(pt, n_mol, reference_box_for(n_mol),
                                  torch.float32, dev)
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode="zcol")
        cfg, box = ff.cell_cfg, snap.box_L
        clist = ff.build_cells(snap.position, box)
        g = torch.Generator(device="cpu")
        g.manual_seed(11)
        step = torch.rand((snap.N, 3), generator=g,
                          dtype=torch.float64) * 2 - 1
        step = (0.49 * cfg.skin / step.abs().max() * step).to(snap.position)
        drifted = snap.position + step
        drifted = drifted - box * torch.round(drifted / box)
        for where, pos in (("build", snap.position), ("drift", drifted)):
            call_args = (pos, box, clist, cfg, snap.typeid, snap.charge,
                         ff.lj_eps, ff.lj_sig2, ff.lj_rcut2, ff.lj_vshift,
                         ff.cell_exclusions, ff.kappa_value, ff.zcol_W)

            def call():
                return zk.zcol_pair_force(*call_args)

            has_hull_kernel = hasattr(zk, "_launch_hull")
            if has_hull_kernel:
                def hull():
                    return zk._launch_hull(pos, box, clist, cfg, snap.charge,
                                           ff.zcol_W)
            else:
                def hull():
                    return zk.zcol_hull(zk.zcol_local_positions(
                        pos, box, clist), box, clist, cfg, ff.zcol_W)
            first, again = call(), call()
            ref = zk.zcol_pair_force_plain(*call_args)
            err = max(float((a.double() - b.double()).abs().max())
                      for a, b in zip(first[:3], ref[:3]))
            rows = {}
            if args.rows > 1 and "rows" in inspect.signature(
                    zk.zcol_pair_force).parameters:
                block = (0, snap.N // args.rows)

                def call_rows():
                    return zk.zcol_pair_force(*call_args, rows=block)

                rows = dict(rows=block,
                            rows_ms=cs.device_ms(torch, call_rows, inner=1),
                            rows_kernel_ms=cs.profiled_device_ms(
                                torch, call_rows, match="zcol_pair_kernel"))
            print(json.dumps(dict(
                label=args.label, n=snap.N, positions=where,
                columns=cfg.ncells[:2], cap=cfg.cap, W=ff.zcol_W,
                ms=cs.device_ms(torch, call, inner=1),
                device_ops_per_call=cs.profiled_device_ms(
                    torch, call, ops=True, once=(
                        "zcol_pair_kernel", "zcol_hull_kernel")[
                            :1 + has_hull_kernel])[1],
                kernel_ms=cs.profiled_device_ms(torch, call,
                                                match="zcol_pair_kernel"),
                hull_kernel_ms=(cs.profiled_device_ms(
                    torch, call, match="zcol_hull_kernel")
                    if has_hull_kernel else None),
                hull_ms=cs.device_ms(torch, hull, inner=1),
                max_abs_err=err,
                scale=float(ref[0].double().abs().max()),
                window_flag=bool(first[3]),
                bit_equal_calls=all(bool(torch.equal(a, b))
                                    for a, b in zip(first, again)), **rows)),
                flush=True)
        del ff, snap, clist
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


if __name__ == "__main__":
    main()
