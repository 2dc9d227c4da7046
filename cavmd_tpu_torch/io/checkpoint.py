"""Whole-state checkpoints for an exact resume.

Port of ``cavmd_tpu/io/checkpoint.py``. The reference's own restart files
are GSD frames, which hold no thermostat or random state; a checkpoint
here holds the whole ``MDState``: every tensor leaf (positions, images,
velocities, cached forces, dt, clocks, timestep, reservoirs, the MTTK
(xi, eta), the adaptive tolerance), the host ``step`` and ``seed``, the
state of every ``torch.Generator`` by (stream, method index), and in cell
and zcol mode the carried list with its anchor positions. A replica
batch's leaves keep their leading axis. A run resumed from it continues
bit for bit where the saved run stopped (on the same device kind).

The file is one ``.npz`` of named arrays and holds no pickled object:
``state/<leaf>``, ``cell_list/<field>``, ``host/step``, ``host/seed`` and
``generator/<stream>/<instance>`` (the generator's state bytes).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from cavmd_tpu_torch.integrate.integrator import MDState

_HOST = ("step", "seed")


def _leaves(state: MDState) -> dict:
    """Every tensor of ``state`` but the generators, by name."""
    out = {}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, torch.Tensor):
            out[f"state/{f.name}"] = value
    if state.cell_list is not None:
        for k, value in state.cell_list._asdict().items():
            if value is not None:
                out[f"cell_list/{k}"] = value
    return out


def save_checkpoint(path: str, state: MDState) -> None:
    """Write ``state`` to ``path`` (one ``.npz``; written to a temporary
    name and renamed into place, so an interrupted save leaves any earlier
    file whole)."""
    arrays = {k: v.detach().cpu().numpy() for k, v in _leaves(state).items()}
    for k in _HOST:
        arrays[f"host/{k}"] = np.asarray(getattr(state, k), np.int64)
    for (stream, instance), gen in state.generators.items():
        arrays[f"generator/{stream}/{instance}"] = (
            gen.get_state().numpy().copy())
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: MDState) -> MDState:
    """The state saved at ``path``, on ``template``'s device.

    ``template`` (for example a fresh ``init_state`` of the same system
    and force field) gives the structure: the same leaves, in cell and
    zcol mode the same carried-list fields, each of the same shape and
    dtype; ``ValueError`` otherwise. Its generators are replaced by the
    file's."""
    dev = template.device
    want = _leaves(template)
    with np.load(path, allow_pickle=False) as data:
        names = set(data.files)
        got = {k for k in names if k.split("/")[0] in ("state", "cell_list")}
        if got != set(want):
            raise ValueError(
                "checkpoint structure mismatch: the file has "
                f"{sorted(got - set(want))} and lacks "
                f"{sorted(set(want) - got)} against the template")
        loaded = {}
        for k, tmpl in want.items():
            t = torch.from_numpy(data[k])
            if t.shape != tmpl.shape or t.dtype != tmpl.dtype:
                raise ValueError(
                    f"checkpoint structure mismatch: {k} is {t.dtype} "
                    f"{tuple(t.shape)}, the template's {tmpl.dtype} "
                    f"{tuple(tmpl.shape)}")
            loaded[k] = t.to(dev)
        host = {k: int(data[f"host/{k}"]) for k in _HOST}
        gens = {}
        fresh = torch.Generator(device=dev).get_state().numel()
        for k in sorted(names):
            if not k.startswith("generator/"):
                continue
            _, stream, instance = k.split("/")
            raw = data[k]
            if raw.size != fresh:
                raise ValueError(
                    f"checkpoint structure mismatch: generator {k} holds "
                    f"{raw.size} state bytes, a {dev.type} generator "
                    f"{fresh}")
            gen = torch.Generator(device=dev)
            gen.set_state(torch.from_numpy(raw.copy()))
            gens[(int(stream), int(instance))] = gen
    fields = {k.split("/", 1)[1]: v for k, v in loaded.items()
              if k.startswith("state/")}
    clist = template.cell_list
    if clist is not None:
        clist = clist._replace(**{k.split("/", 1)[1]: v
                                  for k, v in loaded.items()
                                  if k.startswith("cell_list/")})
    return template.replace(**fields, **host, generators=gens,
                            cell_list=clist)
