#!/usr/bin/env python3
"""The slab path's skin against its rebuild cadence on one GPU: the
reading of ROADMAP.md Queue 1 item 3b.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_slab_skin.py [--skins 0.5,0.75,1.0] [--cadences
10,20,40]``.

The protocol is ``chip_smoke.py`` phase 15c's: 8 replicas of
``build_large_n(50_000)``'s start (N = 100,001, f32, Bussi + Langevin,
dt 0.25 fs; replica r thermalized at seed 7 + r) through the batched slab
runner at one slab (``make_domain_runner``), one warm-up chunk of 100
steps, then 5 chunks of 100. For each skin the plan is
``plan_domain(snap, ff, 1, skin=skin)``; for each cadence the batch starts
afresh. A chunk whose coverage invariant fires in any replica runs again
from its start at half the cadence, and a capacity overflow grows the plan
(the retry of the CLI and of ``Simulation``). Reported for each (skin,
cadence): the chunks whose invariant fired, the cadence the run settled
at, the wall ms a step (median of the 5 chunks). For each skin, on the
final state of its last run: the slab kernel's device ms over the 8
replicas' tables (``chip_smoke.py``'s ``device_ms``), the slab step's
device us a step and one rebuild's device ms (``slab_step_profile``), and
the rebuild amortised over the cadence each run settled at.

One JSON line per (skin, cadence) and per skin; the last line names the
card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N_MOL, CHUNK, CHUNKS = 8, 50_000, 100, 5


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skins", default="0.5,0.75,1.0")
    ap.add_argument("--cadences", default="10,20,40")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_slab_skin.py needs a CUDA device")
    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.parallel import (
        init_replica_states,
        make_domain_runner,
        plan_domain,
    )
    from cavmd_tpu_torch.parallel import domain as dm
    from cavmd_tpu_torch.simulation import retry_state

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    sim, snap, ff = build_large_n(N_MOL, dt_fs=0.25)
    methods = sim.methods
    start = init_replica_states(snap, ff, n_replicas=B,
                                dt=float(sim.state.dt), seed=7,
                                kT=PC.kT_from_kelvin(100.0)).replace(
                                    cell_list=None, cell_anchor=None)
    rng0 = {k: g.get_state() for k, g in start.generators.items()}
    for skin in (float(x) for x in args.skins.split(",")):
        plan0 = plan_domain(snap, ff, 1, skin=skin)
        settled = {}
        for cadence0 in (int(x) for x in args.cadences.split(",")):
            st = dict(b=retry_state(ff, start, rng0), plan=plan0,
                      cadence=cadence0, fired=[], grown=0)

            def run(n):
                begin = st["b"]
                rng = {k: g.get_state() for k, g in begin.generators.items()}
                while True:
                    runner = make_domain_runner(ff, methods, st["plan"],
                                                rebuild_every=st["cadence"])
                    st["b"], obs = runner(begin, n)
                    if not obs["cell_overflow"].any():
                        return
                    if obs["domain_capacity_overflow"].any():
                        st["plan"] = st["plan"].grow_cap()
                        st["grown"] += 1
                    else:
                        st["fired"].append(st["cadence"])
                        st["cadence"] = max(1, st["cadence"] // 2)
                    if len(st["fired"]) + st["grown"] > 6:
                        sys.exit(f"skin {skin} cadence {cadence0}: "
                                 "overflow persists")
                    begin = retry_state(ff, begin, rng)

            run(CHUNK)
            torch.cuda.synchronize()
            chunk_s = []
            for _ in range(CHUNKS):
                t0 = time.perf_counter()
                run(CHUNK)
                torch.cuda.synchronize()
                chunk_s.append(time.perf_counter() - t0)
            settled[cadence0] = st["cadence"]
            emit(skin=skin, cadence=cadence0, settled_cadence=st["cadence"],
                 invariant_fired_at_cadences=st["fired"],
                 plan_grown=st["grown"], ncells=st["plan"].ncells,
                 widths=st["plan"].widths, cap=st["plan"].cap,
                 margin_bohr=min(st["plan"].widths) / 2
                 - st["plan"].r_cut / 2,
                 wall_ms_per_step=statistics.median(
                     s / CHUNK * 1e3 for s in chunk_s),
                 chunk_ms_per_step=[s / CHUNK * 1e3 for s in chunk_s])
            final, plan = st["b"], st["plan"]
            torch.cuda.empty_cache()
        targs, cells, key = dm.tile_pass_inputs(ff, plan, final)
        kern_ms = cs.device_ms(
            torch, lambda: ck.cell_pair_force_slab(*targs, cells, key))
        prof, rb_ms, rb_ops = cs.slab_step_profile(torch, ff, methods, plan,
                                                   final)
        emit(skin=skin, ncells=plan.ncells, cap=plan.cap,
             slab_kernel_ms=kern_ms, step_device_us=prof["us"],
             step_device_ops=prof["ops"], rebuild_ms=rb_ms,
             rebuild_device_ops=rb_ops,
             rebuild_ms_per_step={c: rb_ms / s for c, s in settled.items()},
             device_us_per_step={c: prof["us"] + rb_ms * 1e3 / s
                                 for c, s in settled.items()})
        del targs, cells, key, final
        torch.cuda.empty_cache()
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
