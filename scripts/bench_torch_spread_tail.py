#!/usr/bin/env python3
"""Device times of the PPPM spread (kernel 2) and the fused tail (K4, K5)
of cavmd_tpu_torch on one GPU, per path and shape.

Run from the root of a checkout on a machine with a CUDA device:
``python3 scripts/bench_torch_spread_tail.py [--root DIR] [--label NAME]``.
``--root`` imports ``cavmd_tpu_torch`` from another checkout (for example
an unpacked parent commit), so two versions can be timed in turns in one
run on one card; the timer is ``chip_smoke.py``'s ``device_ms`` of this
checkout (calls queued behind a spin kernel, CUDA events, median of 15).

Scenes: the reference-density O2/N2 lattice + photon of ``chip_smoke.py``
at N = 501 (46-bohr box), 4001, 20,001 and 100,001 (``build_large_n(50_000)``'s
scene), and the N = 100,001 scene with its particles permuted (a block's
contiguous chunk then spans the whole box, as after a long run's
diffusion). f32, order 6. For kernel 2: the 32^3 mesh on every scene, and
64^3 and 128^3 at N = 100,001; each path the checkout's wrapper offers
("auto" only in a checkout without ``spread_grid_cuda``), with its
largest error against the plain twin and the blocks that used their
shared-memory tile. K4 and K5 on the three lattice scenes. One JSON line
per measurement; the last line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ((250, False), (2000, False), (10_000, False), (50_000, False),
          (50_000, True))


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
        sys.exit("bench_torch_spread_tail.py needs a CUDA device")
    import cavmd_tpu_torch as pt
    from cavmd_tpu_torch.core.system import reference_box_for
    from cavmd_tpu_torch.ops import fused_integrator as fi
    from cavmd_tpu_torch.ops import pppm_kernels as sk

    paths = (("auto", "global", "tile") if hasattr(sk, "spread_grid_cuda")
             else ("auto",))
    dev = torch.device("cuda")
    for n_mol, scramble in SCENES:
        box = 46.0 if n_mol == 250 else reference_box_for(n_mol)
        snap = cs.reference_scene(pt, n_mol, box, torch.float32, dev)
        pos, q, box_L = snap.position, snap.charge, snap.box_L
        if scramble:
            g = torch.Generator(device="cpu")
            g.manual_seed(5)
            perm = torch.randperm(snap.N, generator=g).to(dev)
            pos, q = pos[perm].contiguous(), q[perm].contiguous()
        meshes = [(32, 32, 32)]
        if n_mol == 50_000 and not scramble:
            meshes += [(64, 64, 64), (128, 128, 128)]
        for mesh in meshes:
            plain = sk.spread_grid_plain(pos, q, box_L, 6, mesh)
            scale = float(plain.abs().max())
            for path in paths:
                tiled = torch.zeros(1, dtype=torch.int32, device=dev)
                if path == "auto" and len(paths) == 1:
                    def call():
                        return sk.spread_grid(pos, q, box_L, 6, mesh)
                    grid = call()
                    n_tiled = None
                else:
                    def call(path=path):
                        return sk.spread_grid_cuda(pos, q, box_L, 6, mesh,
                                                   path=path)
                    grid = sk.spread_grid_cuda(pos, q, box_L, 6, mesh,
                                               path=path, tile_runs=tiled)
                    n_tiled = int(tiled)
                err = float((grid.double() - plain.double()).abs().max())
                again = call()
                print(json.dumps(dict(
                    label=args.label, kernel="pppm_spread", n=snap.N,
                    scrambled=scramble, mesh=mesh[0], path=path,
                    ms=cs.device_ms(torch, call),
                    max_abs_err=err, scale=scale, tile_runs=n_tiled,
                    bit_equal_calls=bool(torch.equal(grid, again)))),
                    flush=True)
        if scramble:
            continue
        ff = pt.ForceField.create(snap, coupling=1e-3, freq_cm1=2000.0)
        pre, post = cs.integrator_inputs(torch, pt, snap, ff)
        for kernel, fn in (("fused_pre_force", fi.pre_force_apply),
                           ("fused_post_force", fi.post_force_apply)):
            args_k = pre if kernel == "fused_pre_force" else post
            first, second = fn(*args_k), fn(*args_k)
            res = dict(label=args.label, kernel=kernel, n=snap.N,
                       ms=cs.device_ms(torch, lambda: fn(*args_k)),
                       bit_equal_calls=all(
                           torch.equal(a, b) for a, b in zip(first, second)))
            if hasattr(fi, "grid_blocks"):
                res["blocks"] = fi.grid_blocks(kernel[6:], snap.N,
                                               torch.float32)
            print(json.dumps(res), flush=True)
        del ff, pre, post
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)


if __name__ == "__main__":
    main()
