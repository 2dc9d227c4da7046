"""Whole-state checkpoints of cavmd_tpu_torch (``io/checkpoint.py``, the
port of cavmd_tpu/io/checkpoint.py), on the CPU in float64: a run saved
at step k, loaded into a fresh template and run to 2k equals the
uninterrupted 2k-step run bit for bit, for

- Bussi + Langevin in dense mode (the generators' states matter);
- cell mode with the carried list and its anchor;
- MTTK on the molecules, whose (xi, eta) carry the bath;
- a replica batch of B = 2 (its (B, ...) leaves);

and a file that does not fit the template raises ValueError. The file
holds named arrays only (it loads with ``allow_pickle=False``)."""

import dataclasses

import numpy as np
import pytest
import torch

from cavmd_tpu_torch import load_checkpoint, save_checkpoint
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle, make_diatomic_system
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.parallel import init_replica_states, run_replica_steps

KT = PC.kT_from_kelvin(100.0)
DT = PC.fs_to_atomic_units(0.5)
K = 15


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def snap():
    """40 diatomics + photon in a 36-bohr box (3^3 cells at r_cut 11.95,
    a 0.05-bohr skin: the carried list is rebuilt within the run)."""
    s = make_diatomic_system(40, box_L=36.0, temperature_K=100.0, seed=11,
                             device="cpu")
    return add_cavity_particle(s, coupling=1e-3, freq_cm1=2000.0,
                               temperature_K=100.0, seed=12)


def _methods(bath):
    tau = PC.ps_to_atomic_units(0.05 if bath == "mttk" else 5.0)
    return (MethodSpec(kind=bath, group="molecular", kT=KT, tau=tau),
            MethodSpec(kind="langevin", group="cavity", kT=KT,
                       gamma=PC.gamma_from_tau_ps(0.05)))


def _same_state(a, b):
    """Every tensor leaf, the carried list, the host fields and the
    generators' states equal bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
    assert (a.step, a.seed) == (b.step, b.seed)
    if a.cell_list is not None:
        for k, x in a.cell_list._asdict().items():
            if x is not None:
                assert torch.equal(x, getattr(b.cell_list, k)), k
    assert set(a.generators) == set(b.generators)
    for key, gen in a.generators.items():
        assert torch.equal(gen.get_state(), b.generators[key].get_state())


CASES = {
    "bussi_dense": dict(bath="bussi", mode="dense", batch=None),
    "bussi_cell": dict(bath="bussi", mode="cell", batch=None),
    "mttk_dense": dict(bath="mttk", mode="dense", batch=None),
    "batch_b2": dict(bath="bussi", mode="dense", batch=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_equals_uninterrupted_run(snap, tmp_path, case):
    c = CASES[case]
    ff = ForceField.create(snap, coupling=1e-3, r_cut=11.95,
                           pppm_mesh=(8, 8, 8), pair_mode=c["mode"],
                           cell_skin=0.05)
    step = make_step_fn(ff, resolve_methods(snap, _methods(c["bath"]),
                                            ff.l_typeid))
    if c["batch"] is None:
        def fresh():
            return init_state(snap, ff, dt=DT, seed=4)
        run = run_steps
    else:
        def fresh():
            return init_replica_states(snap, ff, n_replicas=c["batch"],
                                       dt=DT, seed=4, kT=KT)
        run = run_replica_steps

    whole, obs_whole = run(step, fresh(), 2 * K)
    half, _ = run(step, fresh(), K)
    path = str(tmp_path / "state.npz")
    save_checkpoint(path, half)
    resumed = load_checkpoint(path, fresh())
    _same_state(resumed, half)
    final, obs_rest = run(step, resumed, K)
    _same_state(final, whole)
    for k, v in obs_rest.items():
        np.testing.assert_array_equal(v, obs_whole[k][K:], err_msg=k)

    assert final.generators, "the run drew no noise"
    if c["bath"] == "mttk":
        assert float(final.mttk_xi[0]) != 0.0
    if c["mode"] == "cell":
        assert final.cell_list is not None
        assert not torch.equal(final.cell_anchor, snap.position), \
            "the carried list was never rebuilt"
    if c["batch"]:
        assert final.position.shape[0] == c["batch"]
    with np.load(path, allow_pickle=False) as data:
        assert "state/mttk_xi" in data.files and "host/step" in data.files


def test_structure_mismatch_raises(snap, tmp_path):
    """A dense state into a cell template (no carried list in the file), a
    batch into a one-replica template (shapes), float32 into float64
    (dtypes): ValueError, as the JAX loader raises on another tree."""
    kw = dict(coupling=1e-3, r_cut=10.0, pppm_mesh=(8, 8, 8))
    dense = ForceField.create(snap, **kw)
    cell = ForceField.create(snap, pair_mode="cell", **kw)
    path = str(tmp_path / "dense.npz")
    save_checkpoint(path, init_state(snap, dense, dt=DT))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, init_state(snap, cell, dt=DT))
    save_checkpoint(path, init_replica_states(snap, dense, n_replicas=2,
                                              dt=DT))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, init_state(snap, dense, dt=DT))
    s32 = snap.astype(torch.float32)
    save_checkpoint(path, init_state(s32, ForceField.create(s32, **kw),
                                     dt=DT))
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, init_state(snap, dense, dt=DT))
