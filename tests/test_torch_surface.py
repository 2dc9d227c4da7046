"""The keywords and methods of the JAX surface that a name check cannot
see, in cavmd_tpu_torch against cavmd_tpu (float64, CPU):

- ``plan_domain(skin=, cap=, nb_margin=)``: every field of the plan equal
  to the JAX plan's over a grid of the three keywords, and a slab run at
  skin 1.0 against the unsharded runner;
- ``bussi_rescale_factor`` / ``bussi_apply(sign_correction=)`` against
  JAX's limit test (tests/test_integrate.py:208) with JAX's draws;
- ``Snapshot.box``, ``type_index`` and ``unwrapped_positions``;
- ``Simulation.run(profile_dir=)``: a trace file of the step's operations
  and the same trajectory as without it.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cavmd_tpu.core import add_cavity_particle as j_add
from cavmd_tpu.core import make_diatomic_system as j_make
from cavmd_tpu.integrate import ForceField as JForceField
from cavmd_tpu.integrate.rng import master_key
from cavmd_tpu.integrate.thermostats import bussi_apply as j_bussi_apply
from cavmd_tpu.integrate.thermostats import bussi_noise as j_bussi_noise
from cavmd_tpu.integrate.thermostats import (
    bussi_rescale_factor as j_bussi_factor,
)
from cavmd_tpu.parallel import domain as jd
from cavmd_tpu_torch import Simulation
from cavmd_tpu_torch.core import PhysicalConstants as PC
from cavmd_tpu_torch.core import add_cavity_particle as t_add
from cavmd_tpu_torch.core import make_diatomic_system as t_make
from cavmd_tpu_torch.integrate import (
    ForceField,
    MethodSpec,
    init_state,
    make_step_fn,
    resolve_methods,
    run_steps,
)
from cavmd_tpu_torch.integrate.thermostats import (
    bussi_apply,
    bussi_rescale_factor,
)
from cavmd_tpu_torch.parallel import domain as td

from test_torch_cell_kernel import port_cell_forcefield
from test_torch_domain import _same_plan
from test_torch_ops import scene

KT = PC.kT_from_kelvin(100.0)
DT = PC.fs_to_atomic_units(0.5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs six workers on the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ plan_domain
@pytest.fixture(scope="module")
def slab_scene():
    """tests/test_domain.py:36's scene in both packages (550 O2/N2 +
    photon, 65-bohr box, r_cut 8, PPPM 16^3, cell mode)."""
    js = j_add(j_make(550, box_L=65.0, temperature_K=100.0, seed=0,
                      dtype=np.float64),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    ts = t_add(t_make(550, box_L=65.0, temperature_K=100.0, seed=0,
                      device="cpu"),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    jff = JForceField.create(js, coupling=1e-3, freq_cm1=2000.0, r_cut=8.0,
                             pair_mode="cell", pppm_mesh=(16, 16, 16))
    return js, ts, jff, port_cell_forcefield(jff, js)


@pytest.mark.parametrize("skin,cap,nb_margin", list(itertools.product(
    (0.5, 0.75, 1.0), (None, 64), (1.1, 1.5))))
def test_plan_domain_keywords_match_jax(slab_scene, skin, cap, nb_margin):
    """Every field of the 2-slab plan, and of the plan grown for a retry,
    equal to JAX's for the same ``skin``, ``cap`` and ``nb_margin``."""
    js, ts, jff, tff = slab_scene
    kw = dict(skin=skin, cap=cap, nb_margin=nb_margin)
    jp, tp = jd.plan_domain(js, jff, 2, **kw), td.plan_domain(ts, tff, 2, **kw)
    _same_plan(tp, jp)
    _same_plan(tp.grow_cap(), jp.grow_cap())
    if cap is not None:
        assert tp.cap == cap
    w = 8.0 + skin
    assert tp.ncells[1] == int(65.0 // w)


def test_slab_run_at_skin_one_matches_unsharded():
    """At skin 1.0 the one-slab runner follows the unsharded runner with
    the same generators: 60 O2/N2 + photon in a 31-bohr box at r_cut 8
    (3^3 cells of 10.33 bohr, a drift margin of (10.33 - 8)/2 = 1.17 bohr
    after the integer snap), 10 Bussi + Langevin steps rebuilt every 5,
    positions to 1e-10 of the box, no coverage or capacity flag."""
    ts = t_add(t_make(60, box_L=31.0, temperature_K=100.0, seed=0,
                      device="cpu"),
               coupling=1e-3, freq_cm1=2000.0, temperature_K=100.0, seed=1)
    tff = ForceField.create(ts, coupling=1e-3, r_cut=8.0, pair_mode="cell",
                            pppm_mesh=(8, 8, 8))
    tm = resolve_methods(ts, (
        MethodSpec(kind="bussi", group="molecular", kT=KT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=KT,
                   gamma=PC.gamma_from_tau_ps(5.0))), tff.l_typeid)
    start = init_state(ts, tff, dt=DT, seed=7)
    ref, robs = run_steps(make_step_fn(tff, tm), start, 10)
    plan = td.plan_domain(ts, tff, 1, skin=1.0)
    assert plan.ncells == (3, 3, 3)
    assert td.plan_domain(ts, tff, 1).ncells == (3, 3, 3)
    run = td.make_domain_runner(tff, tm, plan, rebuild_every=5)
    fin, obs = run(start.replace(generators={}, cell_list=None,
                                 cell_anchor=None), 10)
    assert not obs["cell_overflow"].any()
    assert not obs["domain_capacity_overflow"].any()
    np.testing.assert_allclose(fin.position.numpy(), ref.position.numpy(),
                               rtol=0, atol=1e-10 * 31.0)
    for k in ("lj", "ewald_short", "ewald_long", "kinetic_molecular"):
        np.testing.assert_allclose(obs[k], robs[k], rtol=1e-9, err_msg=k)


# ------------------------------------------------------ sign_correction
def test_bussi_sign_correction_keyword_matches_jax():
    """tests/test_integrate.py:208 with JAX's draws injected: tau = 0 (c =
    0), alpha^2 is a fresh kinetic-energy draw. With the correction about
    half the factors are negative; ``sign_correction=False`` gives
    ``|alpha|`` (plain HOOMD Bussi), all positive. Both equal JAX's to
    1e-12; ``bussi_apply`` follows."""
    dof, kT = 10.0, 1.0
    K = dof * kT / 2.0
    keys = jax.random.split(master_key(1), 2000)
    r1, rg = jax.vmap(lambda k: j_bussi_noise(k, dof, jnp.float64))(keys)
    r1_t = torch.tensor(np.asarray(r1))
    rg_t = torch.tensor(np.asarray(rg))
    K_t = torch.full((2000,), K, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    want = jax.jit(lambda ks: [jax.vmap(lambda k: j_bussi_factor(
        jnp.asarray(K), dof, 1.0, 0.0, kT, k, sign_correction=sign))(ks)
        for sign in (True, False)])(keys)
    for sign, w in zip((True, False), want):
        got = bussi_rescale_factor(K_t, dof, one, 0.0, kT, r1_t, rg_t,
                                   sign_correction=sign).numpy()
        np.testing.assert_allclose(got, np.asarray(w), rtol=1e-12, atol=0)
        if sign:
            assert 0.4 < (got < 0).mean() < 0.6
        else:
            assert (got > 0).all()
            np.testing.assert_array_equal(got, np.abs(
                bussi_rescale_factor(K_t, dof, one, 0.0, kT, r1_t,
                                     rg_t).numpy()))
    # bussi_apply on a velocity set, JAX's key against its draws
    rng = np.random.default_rng(3)
    v = rng.normal(size=(6, 3))
    mass = rng.uniform(1.0, 2.0, 6)
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    for i in range(2):
        want_v, want_d = j_bussi_apply(
            jnp.asarray(v), jnp.asarray(mass), jnp.asarray(mask), 15.0, 1.0,
            0.0, 1.0, keys[i], sign_correction=False)
        r1_i, rg_i = j_bussi_noise(keys[i], 15.0, jnp.float64)
        got_v, got_d = bussi_apply(
            torch.tensor(v), torch.tensor(mass), torch.tensor(mask), 15.0,
            one, 0.0, 1.0, torch.tensor(np.asarray(r1_i)),
            torch.tensor(np.asarray(rg_i)), sign_correction=False)
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   rtol=1e-12, atol=1e-15)
        assert float(got_d) == pytest.approx(float(want_d), rel=1e-11,
                                             abs=1e-14)


# --------------------------------------------------------------- Snapshot
def test_snapshot_helpers_match_jax():
    """``box`` (a Box of the edges), ``type_index`` (a ValueError for an
    unknown name, as ``tuple.index`` raises in both) and
    ``unwrapped_positions`` with image flags set."""
    js, ts = scene(n_mol=20, box_L=24.0, seed=0)
    image = np.random.default_rng(2).integers(-2, 3, (js.N, 3)).astype(
        np.int32)
    js = js.replace(image=jnp.asarray(image))
    ts = ts.replace(image=torch.as_tensor(image))
    np.testing.assert_array_equal(ts.box.L.numpy(), np.asarray(js.box.L))
    assert float(ts.box.volume) == float(js.box.volume)
    for name in js.types:
        assert ts.type_index(name) == js.type_index(name)
    with pytest.raises(ValueError):
        ts.type_index("Xe")
    with pytest.raises(ValueError):
        js.type_index("Xe")
    np.testing.assert_array_equal(ts.unwrapped_positions().numpy(),
                                  np.asarray(js.unwrapped_positions()))


# ----------------------------------------------------------- profile_dir
def test_run_profile_dir_writes_a_trace_and_keeps_the_trajectory(tmp_path):
    """``Simulation.run(profile_dir=)`` writes a ``torch.profiler`` trace
    that names the step's operations (the PPPM FFT, the Ewald erfc), and
    the final positions equal a run without it bit for bit."""
    _, ts = scene(n_mol=20, box_L=24.0, seed=0)
    ff = ForceField.create(ts, coupling=1e-3, r_cut=10.0,
                           pppm_mesh=(8, 8, 8))
    tm = resolve_methods(ts, (
        MethodSpec(kind="bussi", group="molecular", kT=KT,
                   tau=PC.ps_to_atomic_units(5.0)),
        MethodSpec(kind="langevin", group="cavity", kT=KT,
                   gamma=PC.gamma_from_tau_ps(5.0))), ff.l_typeid)
    out = tmp_path / "trace"
    finals = []
    for profile in (str(out), None):
        sim = Simulation(ts, ff, tm, dt=DT, seed=3, chunk_size=3)
        assert sim.run(n_steps=5, profile_dir=profile) == 5
        finals.append(sim.state.position)
    assert torch.equal(*finals)
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    for op in ("aten::fft_rfftn", "aten::erfc"):
        assert op in text, op
