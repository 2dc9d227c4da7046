#!/usr/bin/env python3
"""Device times of the dense pair pass (kernel 1) and the PPPM force
interpolation (kernel 3) of cavmd_tpu_torch on one GPU, per shape.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_pair_interp.py [--root DIR] [--label NAME]``.
``--root`` imports ``cavmd_tpu_torch`` from another checkout (for example
an unpacked parent commit), so two versions can be timed in turns in one
run on one card; the timer is ``chip_smoke.py``'s ``device_ms`` of this
checkout (calls queued behind a spin kernel, CUDA events, median of 15).

Scenes: the reference-density O2/N2 lattice + photon of ``chip_smoke.py``
at N = 501 (46-bohr box), 4001 and 100,001 (``build_large_n(50_000)``'s
scene), f32. Kernel 1 at N = 501 and 4001 with the scene's ForceField
(dense, r_cut 15). Kernel 3 at order 6 on the 32^3 mesh at N = 501, 4001
and 100,001, on the 128^3 mesh at N = 100,001, and on the 32^3 mesh with
the N = 100,001 scene's particles permuted (a warp's particles then lie
all over the box); its cotangent is the mesh energy's gradient at the
plain twin's grid. Each line: the device ms of one call, the largest
error against the plain twin and the twin's scale, and whether two calls
gave the same bits. One JSON line per measurement; the last line names
the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report(torch, cs, label, kernel, n, call, plain, **extra):
    """Time ``call`` and print its line, held against ``plain``'s
    outputs."""
    first, again = call(), call()
    ref = plain()
    first, again, ref = ((x,) if torch.is_tensor(x) else x
                         for x in (first, again, ref))
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(first, ref))
    print(json.dumps(dict(
        label=label, kernel=kernel, n=n, **extra,
        ms=cs.device_ms(torch, call), max_abs_err=err,
        scale=float(ref[0].double().abs().max()),
        bit_equal_calls=all(torch.equal(a, b)
                            for a, b in zip(first, again)))), flush=True)


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
        sys.exit("bench_torch_pair_interp.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import pair_kernels as pk
    from cavmd_tpu_torch.ops import pppm_kernels as sk
    from cavmd_tpu_torch.ops.pppm import PPPMParams, mesh_energy

    dev = torch.device("cuda")
    for n_mol in (250, 2000, 50_000):
        box = 46.0 if n_mol == 250 else reference_box_for(n_mol)
        snap = cs.reference_scene(pt, n_mol, box, torch.float32, dev)
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
        pos, q, box_L = snap.position, snap.charge, snap.box_L
        if ff.pair_mode == "dense":
            pair_args = (pos, box_L, snap.typeid, ff.lj_eps, ff.lj_sig2,
                         ff.lj_rcut2, ff.lj_vshift, q, ff.lj_active,
                         ff.coulomb_active, ff.kappa_value,
                         ff.coulomb_rcut ** 2)
            report(torch, cs, args.label, "dense_pair", snap.N,
                   lambda: pk.dense_pair_force(*pair_args),
                   lambda: pk.dense_pair_force_plain(*pair_args))
        cases = [("lattice", ff.pppm_mesh)]
        if n_mol == 50_000:
            cases += [("lattice", (128, 128, 128)),
                      ("scrambled", ff.pppm_mesh)]
        order = ff.pppm_order
        for order_name, mesh in cases:
            p, c = pos, q
            if order_name == "scrambled":
                g = torch.Generator(device="cpu")
                g.manual_seed(5)
                perm = torch.randperm(snap.N, generator=g).to(dev)
                p, c = pos[perm].contiguous(), q[perm].contiguous()
            params = ff.pppm if mesh == ff.pppm_mesh else PPPMParams.create(
                box_L.cpu().numpy(), mesh=mesh, order=order, kappa=0.35,
                dtype=torch.float32, device=dev)[0]
            grid = sk.spread_grid_plain(p, c, box_L, order, mesh)
            grid.requires_grad_(True)
            (ct,) = torch.autograd.grad(mesh_energy(grid, params), grid)
            ct = ct.contiguous()
            report(torch, cs, args.label, "pppm_interpolate", snap.N,
                   lambda: sk.interpolate_grad(ct, p, c, box_L, order, mesh),
                   lambda: sk.interpolate_grad_plain(ct, p, c, box_L, order,
                                                     mesh),
                   mesh=mesh[0], particles=order_name)
        del ff, snap
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


if __name__ == "__main__":
    main()
