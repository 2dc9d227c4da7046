#!/usr/bin/env python3
"""Device times of the slab kernel (K7's counterpart, ``cell_pair_slab``)
and of the unsharded batched cell kernel of cavmd_tpu_torch on one GPU,
and, where the checkout has them, the slab kernel over a replica batch
with each replica's own tables and K2/K3 with a charge row a replica.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_batched_slabs.py [--root DIR] [--label
NAME]``. ``--root`` imports ``cavmd_tpu_torch`` from another checkout (for
example an unpacked parent commit), so two versions can be timed in turns
in one run on one card; the timer is ``chip_smoke.py``'s ``device_ms`` of
this checkout (calls queued behind a spin kernel, CUDA events, median of
15).

f32, the reference-density O2/N2 lattice + photon of ``chip_smoke.py``:
- ``cell_pair_slab`` on one slab's extended grid of one replica at
  N = 100,001 and 20,001 (``parallel/domain.py:tile_pass_inputs``);
- ``cell_pair`` (unsharded) over 8 replicas jittered 0.3 bohr apart at
  N = 20,001, one launch with shared tables, and one replica at
  N = 100,001;
- with a batch over slabs (``parallel/domain.py`` has ``_rebuild``):
  ``cell_pair_slab`` over the 8 jittered replicas' slabs at N = 20,001,
  each replica's own tables, and K2 / K3 over those slabs' position
  tables with a charge row a replica and with one shared row.
- phase 9's path (``chip_smoke.py``): ``build_large_n(50_000)``'s scene
  through ``Simulation(shard_atoms=1)`` (one slab, rebuilt every 20
  steps), Bussi + Langevin, dt 0.25 fs: the wall ms a step (one warm-up
  chunk, then the median of 5 chunks of 100 steps), and from
  ``torch.profiler`` traces of ``run`` over 1 and over 20 steps (each the
  most operations of 3 traces, the median time) the device operations
  and device ms of a step (their difference over 19 steps) and of a
  call's fixed work (the rebuild with its scatter in and out, and the
  call's observables), which every 20 steps pay once.
One JSON line per measurement; the last line names the card and its power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose cavmd_tpu_torch is imported")
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_torch_batched_slabs.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.integrate import init_state
    from cavmd_tpu_torch.ops import cell_kernels as ck
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.parallel import domain as dm

    dev = torch.device("cuda")
    slab_batch = hasattr(dm, "_rebuild")

    def emit(**kw):
        print(json.dumps(dict(label=args.label, **kw)), flush=True)

    for n_mol in (50_000, 10_000):
        snap = cs.reference_scene(pt, n_mol, reference_box_for(n_mol),
                                  torch.float32, dev)
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0,
                                  pair_mode="cell")
        plan = dm.plan_domain(snap, ff, 1)
        st = init_state(snap, ff, dt=1.0).replace(cell_list=None,
                                                  cell_anchor=None)
        one, cells, key = dm.tile_pass_inputs(ff, plan, st)
        emit(kernel="cell_pair_slab", n=snap.N, replicas=1,
             ms=cs.device_ms(torch, lambda: ck.cell_pair_force_slab(
                 *one, cells, key)))
        P = cs.wrap_rows(torch, cs.jitter_rows(torch, snap.position, B, 0.3,
                                               5), snap.box_L)
        if n_mol == 50_000:
            clist = ff.build_cells(snap.position, snap.box_L)
            a1 = (snap.position, snap.box_L, clist, ff.cell_cfg, snap.typeid,
                  snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                  ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
            emit(kernel="cell_pair", n=snap.N, replicas=1,
                 ms=cs.device_ms(torch, lambda: ck.cell_pair_force_fused(
                     *a1)))
        else:
            clist = ff.build_cells(P, snap.box_L)
            a8 = (P, snap.box_L, clist, ff.cell_cfg, snap.typeid,
                  snap.charge, ff.lj_eps, ff.lj_sig2, ff.lj_rcut2,
                  ff.lj_vshift, ff.cell_exclusions, ff.kappa_value)
            emit(kernel="cell_pair", n=snap.N, replicas=B,
                 ms=cs.device_ms(torch, lambda: ck.cell_pair_force_fused(
                     *a8)))
            if slab_batch:
                batch = st.replace(**{
                    k: torch.stack([getattr(st, k)] * B)
                    for k in ("position", "image", "velocity", "forces",
                              "dt", "time_au", "time_comp", "timestep",
                              "bussi_reservoir", "bussi_instantaneous",
                              "langevin_reservoir", "mttk_xi", "mttk_eta",
                              "error_tolerance")}).replace(position=P)
                many, cells8, key8 = dm.tile_pass_inputs(ff, plan, batch)
                emit(kernel="cell_pair_slab", n=snap.N, replicas=B,
                     ms=cs.device_ms(torch, lambda: ck.cell_pair_force_slab(
                         *many, cells8, key8)))
                pos, q = many[0], many[5]
                q1 = q[0].contiguous()
                box, order, mesh = snap.box_L, ff.pppm_order, tuple(
                    ff.pppm_mesh)
                ct = torch.rand((B,) + mesh, device=dev)
                for kname, fn, shared in (
                        ("pppm_spread",
                         lambda: sk.spread_grid(pos, q, box, order, mesh),
                         lambda: sk.spread_grid(pos, q1, box, order, mesh)),
                        ("pppm_interpolate",
                         lambda: sk.interpolate_grad(ct, pos, q, box, order,
                                                     mesh),
                         lambda: sk.interpolate_grad(ct, pos, q1, box,
                                                     order, mesh))):
                    emit(kernel=kname, n=pos.shape[1], replicas=B,
                         ms=cs.device_ms(torch, fn),
                         shared_charge_ms=cs.device_ms(torch, shared))
        del ff, snap, one, clist
        torch.cuda.empty_cache()
    emit(path="slab, one replica (phase 9)", **slab_path(cs, torch, pt))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


def slab_path(cs, torch, pt):
    """Phase 9's path: wall ms a step, and the device operations and ms of
    a step and of a call's fixed work (see the module's notes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cavmd_tpu_torch.core import PhysicalConstants as PC
    from cavmd_tpu_torch.drivers.workloads import build_large_n

    _, snap, ff = build_large_n(cs.LARGE_N_MOL)
    sim = pt.Simulation(snap, ff, cs.main_methods(
        pt, PC.kT_from_kelvin(100.0)), dt=PC.fs_to_atomic_units(
            cs.LARGE_DT_FS), seed=7, shard_atoms=1)
    sim.run(n_steps=cs.LARGE_CHUNK)
    torch.cuda.synchronize()
    ms = []
    for _ in range(cs.LARGE_CHUNKS):
        t0 = time.perf_counter()
        sim.run(n_steps=cs.LARGE_CHUNK)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / cs.LARGE_CHUNK * 1e3)

    def traced(n):
        ops, times = 0, []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                sim.run(n_steps=n)
                torch.cuda.synchronize()
            dev = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            ops = max(ops, len(dev))
            times.append(sum(e.time_range.elapsed_us() for e in dev) / 1e3)
        return ops, statistics.median(times)

    (o1, t1), (o20, t20) = traced(1), traced(20)
    step_ops, step_ms = (o20 - o1) / 19, (t20 - t1) / 19
    return dict(n=snap.N, wall_ms_per_step=statistics.median(ms),
                chunk_ms_per_step=ms, step_device_ops=step_ops,
                step_device_ms=step_ms, call_fixed_device_ops=o1 - step_ops,
                call_fixed_device_ms=t1 - step_ms,
                device_ms_per_step_amortised=step_ms + (t1 - step_ms) / 20)


if __name__ == "__main__":
    main()
