"""The roofline yardstick: the physics pair count against a brute-force
count, the same count whatever the pair mode, and the byte counts."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.harness import scene as scene_mod, work  # noqa: E402
from portbench.reference.physics import Topology  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


def tiny(mode):
    return json.loads((DATA / f"tiny-{mode}.json").read_text())


def brute_pairs(scene, r_cut):
    pos = scene["position"]
    box = scene["box"]
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d * d).sum(-1)
    n = len(pos)
    iu = np.triu_indices(n, 1)
    near = r2[iu] < r_cut * r_cut
    bonded = set(map(tuple, np.sort(scene["bond_group"], axis=1)))
    pairs = [(i, j) for i, j, k in zip(*iu, near) if k]
    return sum(1 for p in pairs if p not in bonded)


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_pair_count_matches_brute_force(seed):
    cfg = tiny("cell")
    scene = scene_mod.make_scene(cfg, seed)
    top = Topology(cfg, scene, torch.float64, torch.device("cpu"))
    pos = torch.as_tensor(scene["position"])[None]
    assert work.pairs_inside(top, pos) == brute_pairs(scene, top.r_cut)


def test_pair_count_same_in_every_mode():
    """The bound counts pairs of the positions: cell, zcol and slab
    configurations of one scene give one count and one bound."""
    seen = set()
    for mode in ("cell", "zcol", "slab"):
        cfg = tiny(mode)
        scene = scene_mod.make_scene(cfg, 5)
        top = Topology(cfg, scene, torch.float64, torch.device("cpu"))
        pos = torch.as_tensor(scene["position"])[None].expand(2, -1, -1)
        n = work.pairs_inside(top, pos)
        seen.add((n, work.pair_work(n, 2 * top.N, 4, 56)))
    assert len(seen) == 1


def test_byte_counts():
    n_bytes, n_ops = work.pair_work(10, 100, 4, 56)
    assert n_bytes == 4 * 8 * 100 and n_ops == 560
    b, o = work.spread_work(2, 100, 80, (8, 8, 8), 6, 4)
    assert b == 4 * (2 * (300 + 512) + 100 + 3)
    assert o == 2 * 80 * (work.stencil_ops(6) + 2 * 216 + 36)
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
